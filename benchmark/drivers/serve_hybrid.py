"""Serving cells of models whose layers attend by kinds of their own
(``HybridModelArgs``: sliding-window and full layers, a head dim of its
own, YaRN on the full layers): the port's ``ServingEngine`` under the
traffic's closed loop, as ``drivers/serve.py`` drives the uniform model.

What differs from ``drivers/serve.py``:
  * the weights and the reference are ``reference/mellum.py``'s (its own
    parameter names and shapes, its own forward);
  * the engine's ``max_prefill_tokens`` bounds a prefill forward, so set-up
    captures only the (bucket, group) keys the budget lets form;
  * the work is counted at the model's head dim, each windowed layer's
    decode reading at most ``left_window`` settled keys (K1's window), and
    a prefill's experts at the routed top-k (what the algorithm needs,
    whatever the lossless buffers compute);
  * every step of the window reads the engine's
    ``kv_window_dead_bytes`` over ``kv_bytes_in_use`` (host counters, no
    sync), for ``kv_window_dead_share``;
  * a traced run probes the engine after the window
    (``spans.probe_serve``: eager steps under their own profiler), for the
    decode forward's device time under ``attn.window`` and ``attn.full``.

The check after the window is ``drivers/serve.py``'s: the mean gap of the
served tokens under the fp32 reference, greedy and sampled, and with
``ctx.control`` the reference held in fp8 in the program's place.
"""

from __future__ import annotations

import gc
import time
from collections import Counter
from typing import List

import numpy as np
import torch

from benchmark import harness, work
from benchmark import traffic as tr
from benchmark.drivers.serve import Drive, buckets_for, pick_checked, serve_e2e
from benchmark.reference import sampling as ref_sampling
from benchmark.reference.mellum import SLIDING, MellumReference, head_dim, make_params
from benchmark.reference.model import no_tf32

# ------------------------------------------------------------------ work


def hybrid_params(m: dict):
    """(params a token multiplies outside the experts, params of one
    expert, params of the readout) of a hybrid config ``m``: attention,
    router and norms of every layer, the final norm; the untied head (the
    embedding is a lookup, no product)."""
    d, h, g, f = m["d_model"], m["num_heads"], m["query_groups"], m["d_ffn"]
    hd, e, layers = head_dim(m), m["num_experts"], m["num_layers"]
    attn = d * (h + 2 * g) * hd + h * hd * d
    dense = layers * (attn + d * e + e + 2 * d) + d
    return dense, 3 * d * f, m["vocab_size"] * d


def flops_per_token(m: dict) -> float:
    """Weight products of one token's forward: the dense part, the top-k
    experts of every layer and the readout."""
    dense, expert, head = hybrid_params(m)
    return 2.0 * (dense + m["num_layers"] * m["top_k"] * expert + head)


def weight_bytes(m: dict, experts_touched: int) -> float:
    """bf16 bytes of the weights a forward reads: the dense part, the
    experts it touches in each layer, the readout."""
    dense, expert, head = hybrid_params(m)
    return work.BF16 * (dense + m["num_layers"] * experts_touched * expert + head)


def layer_windows(m: dict) -> List[int]:
    """Each layer's left window (-1: full)."""
    return [m["left_window"] if k == SLIDING else -1 for k in m["layer_types"]]


def attended(window: int, length: int) -> int:
    """Settled keys a decode token at ``length`` attends in a layer of
    ``window`` (-1: full)."""
    return length if window < 0 else min(length, window)


def prefill_pairs(m: dict, n: int) -> int:
    """Attended (query, key) pairs of a causal prefill of ``n`` tokens from
    an empty cache, summed over the layers."""
    total = 0
    for w in layer_windows(m):
        if w < 0 or w + 1 >= n:
            total += n * (n + 1) // 2
        else:  # the first w + 1 queries see all before them, the rest w + 1 keys
            total += (w + 1) * (w + 2) // 2 + (n - w - 1) * (w + 1)
    return total


def kv_bytes_per_token_layer(m: dict) -> float:
    return 2 * m["query_groups"] * head_dim(m) * work.BF16


class HybridDrive(Drive):
    """``Drive`` with the hybrid model's work counts, and each step's
    reading of the engine's windowed K/V counter."""

    @staticmethod
    def zero() -> dict:
        return dict(Drive.zero(), kv_dead_share_sum=0.0, kv_share_steps=0)

    def step(self):
        t, raw = super().step()
        return t, raw + (self.eng.kv_window_dead_bytes(), self.eng.kv_bytes_in_use())

    def step_work(self, new_tokens, k, n_prefill, decode_rows, prefills, dead, used) -> dict:
        m = self.m
        g, h, hd = m["query_groups"], m["num_heads"], head_dim(m)
        windows = layer_windows(m)
        kvb = kv_bytes_per_token_layer(m)
        fpt = flops_per_token(m)
        d = self.zero()
        d["output_tokens"] = new_tokens
        d["decode_forwards"] = k
        if used > 0:
            d["kv_dead_share_sum"] = dead / used
            d["kv_share_steps"] = 1
        for j in range(k):
            lens = [L + j for L, n in decode_rows if j < n]
            if not lens:
                continue
            d["decode_rows"] += len(lens)
            keys = 0  # settled keys attended, over the rows and layers
            for w, layers in Counter(windows).items():
                read = [attended(w, L) for L in lens]
                nb, nf = work.decode_attn_cost(read, kv_heads=g, q_per_kv=h // g, hd=hd,
                                               pages_per_row=self.eng.pages_per_row)
                d["decode_attn_least_s"] += layers * work.least_s(nb, nf)
                keys += layers * sum(read)
            pairs = keys + len(lens) * len(windows)  # and each token's own
            flops = len(lens) * fpt + 4.0 * h * hd * pairs
            touched = min(m["num_experts"], len(lens) * m["top_k"])
            nbytes = weight_bytes(m, touched) + pairs * kvb
            d["forward_least_s"] += work.least_s(nbytes, flops)
        if n_prefill:
            flops, nbytes, tail_total = 0.0, n_prefill * weight_bytes(m, m["num_experts"]), 0
            for i in prefills:
                plen = len(self.t.requests[i].prompt)
                tail_total += plen
                flops += plen * fpt + 4.0 * h * hd * prefill_pairs(m, plen)
                nbytes += plen * len(windows) * kvb
            d["prefill_tokens"] = tail_total
            d["forward_least_s"] += work.least_s(nbytes, flops)
        return d


# ------------------------------------------------------------------- run


def build_model(m: dict, seed: int, device, rec: harness.Recorder):
    """The port's TextLM over the seed's weights (set-up phases 'weights'
    and 'model')."""
    from vats_tpu_torch.configs.nlp import HybridModelArgs
    from vats_tpu_torch.models.text_lm import TextLM

    with rec.phase("weights"):
        params = make_params(m, seed, getattr(torch, m["param_dtype"]), device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    with rec.phase("model"):
        model = TextLM(HybridModelArgs(**m), device="meta")
        model.load_state_dict(params, assign=True)
    return model.eval()


def warm_keys(eng, buckets: List[int], rng: np.random.Generator, vocab: int) -> None:
    """Capture the prefill key of every (bucket, group) the engine's
    prefill budget lets form, and the decode block, by driving requests of
    one token's answer through the engine."""
    for b in buckets:
        r = 1
        while r <= eng.max_prefill_rows(b):
            for _ in range(r):
                eng.submit(rng.integers(1, vocab, size=b).tolist(), 1)
            eng.run()
            r *= 2


def run(ctx) -> dict:
    """One run of a hybrid serving cell; ``ctx`` as ``benchmark/run.py``
    makes it."""
    # a program without per-layer attention kinds fails here, before set-up
    from vats_tpu_torch.configs.nlp import HybridModelArgs  # noqa: F401
    from vats_tpu_torch.inference.serving import ServingEngine

    cfg, mix, m, dev, rec = ctx.config, ctx.mix, ctx.config["model"], ctx.device, ctx.rec
    seed = ctx.seed
    vocab = m["vocab_size"]
    with rec.phase("build"):
        if dev.type == "cuda":
            from vats_tpu_torch.ops import kernels

            kernels.build_all()
    if dev.type == "cuda":
        with rec.phase("cuda_init"):
            torch.zeros(1, device=dev)
            torch.cuda.synchronize()
    eng_kw = dict(cfg["engine"])
    eng_kw["prompt_buckets"] = tuple(eng_kw["prompt_buckets"])
    engine = ServingEngine(build_model(m, seed, dev, rec), seed=seed % (1 << 32),
                           eos_token_id=None, **eng_kw)
    traffic = tr.serve_traffic(mix, seed, vocab)
    prompt = mix["prompt"]
    with rec.phase("captures"):
        warm_keys(engine, buckets_for(prompt["min"], prompt["max"], engine.prompt_buckets),
                  tr.rng_for(seed, 2), vocab)
    drive = HybridDrive(engine, traffic, m, rec, 0)
    with rec.phase("warmup_drive"):
        drive.start()
        t_end = drive.t0 + float(mix["warmup_s"])
        while time.perf_counter() < t_end:
            drive.step()
    # the window: from the end of a step to the end of the last step that
    # ends inside the run's seconds
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_ws = time.perf_counter()
    setup_s = time.time() - ctx.process_start
    failed0 = drive.failed
    high0 = engine.allocator.high_water
    win, traced_counts = HybridDrive.zero(), HybridDrive.zero()
    trace = harness.DeviceTrace(rec) if ctx.trace else None
    trace_at, trace_len = t_ws + ctx.seconds / 3.0, min(3.0, ctx.seconds / 3.0)
    traced, tracing, t_last = None, False, t_ws
    steps = []
    gc.collect()
    gc.freeze()
    while True:
        if trace is not None and not tracing and traced is None and t_last >= trace_at:
            trace.start()
            tracing, trace_t0 = True, t_last
        t, raw = drive.step()
        if t - t_ws > ctx.seconds:
            break
        t_last = t
        steps.append((raw, tracing))
        if tracing and t - trace_t0 >= trace_len:
            traced, tracing = trace.stop(), False
    if tracing:
        trace.stop()
    gc.unfreeze()
    for raw, in_trace in steps:
        for key, v in drive.step_work(*raw).items():
            win[key] += v
            if in_trace:
                traced_counts[key] += v
    counters = dict(win, window_s=t_last - t_ws, queued_at_end=len(engine.queue),
                    preemptions=engine.preemptions, pool_pages=eng_kw["total_pages"],
                    pool_pages_high_water=engine.allocator.high_water,
                    pool_pages_high_water_before_window=high0)
    # the window's peak, before the probe's eager steps
    device = harness.device_line(ctx.chips) if dev.type == "cuda" else None
    probe = None
    if ctx.trace:
        from benchmark import spans

        probe = spans.probe_serve(engine)
    del engine  # the drive holds the last reference, which finish drops
    out = finish(ctx, drive, t_ws, t_last, setup_s, failed0, counters, traced, traced_counts,
                 device)
    out["record"]["decode_probe"] = probe
    return out


def served_gaps(m: dict, seed: int, device, checked, rule: dict, fp8_control: bool = False):
    """``drivers/serve.served_gaps`` under ``MellumReference``: per served
    position, the gap of the served token under the fp32 reference; with
    ``fp8_control`` also the gaps of the control's tokens."""
    no_tf32()
    params = make_params(m, seed, getattr(torch, m["param_dtype"]), device)
    ref = MellumReference(m, params)
    low = MellumReference(m, params, precision="fp8") if fp8_control else None
    args = (rule["temperature"], int(rule["top_k"]), rule["top_p"], int(rule["kmax"]))
    prog, ctrl = [], []
    for prompt, served, draw_seed in checked:
        ids = torch.tensor(prompt + served[:-1], dtype=torch.long, device=device)
        logits = ref.logits(ids)[len(prompt) - 1:]
        floor = (logits.max(-1).values if draw_seed is None
                 else ref_sampling.set_floor(logits, *args))
        toks = [torch.as_tensor(served, dtype=torch.long, device=device)]
        if low is not None:
            lo = low.logits(ids)[len(prompt) - 1:]
            if draw_seed is None:
                toks.append(lo.argmax(-1))
            else:
                pos = torch.arange(len(prompt), len(prompt) + len(served), device=device)
                toks.append(ref_sampling.draw(lo, *args, draw_seed, pos))
            del lo
        for out, tok in zip((prog, ctrl), toks):
            g = floor - logits.gather(1, tok[:, None])[:, 0]
            out.append(g.clamp(min=0).cpu().numpy())
        del logits
    del params, ref, low
    return prog + ctrl


def finish(ctx, drive: Drive, t_ws, t_we, setup_s, failed0, counters, traced, traced_counts,
           device):
    """Reads the window's numbers, frees the engine, then checks samples of
    the finished greedy and sampled requests against the reference
    (``drivers/serve.finish``'s check); ``device`` is the window's device
    line."""
    m, dev = ctx.config["model"], ctx.device
    e2e = serve_e2e(drive, t_ws, t_we)
    window = counters["window_s"]
    e2e["serve_tokens_per_s"] = counters["output_tokens"] / window if window > 0 else None
    checked = {}
    for name, greedy, stream in (("greedy", True, 3), ("sampled", False, 6)):
        checked[name] = [(drive.t.requests[i].prompt, drive.outputs[i],
                          None if greedy else drive.t.requests[i].draw_seed)
                         for i in pick_checked(drive, tr.rng_for(ctx.seed, stream), greedy)]
    rule = dict(drive.t.sampling, kmax=ctx.config["engine"]["sampling_kmax"])
    attempted, failed = e2e.pop("_attempted"), drive.failed - failed0
    record = {"model": m, "counters": counters, "trace": None}
    if traced is not None:
        record["trace"] = dict(traced, counters=traced_counts)
    # free the program before the reference runs
    drive.eng = None
    del drive
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    seqs = checked["greedy"] + checked["sampled"]
    gaps = served_gaps(m, ctx.seed, dev, seqs, rule, fp8_control=bool(ctx.control))
    ref_s = time.perf_counter() - t_ref
    n, ng = len(seqs), len(checked["greedy"])

    def mean(gs):
        return float(np.mean(np.concatenate(gs))) if gs else None

    checks = {"mean_logit_gap": {"value": mean(gaps[:ng]),
                                 "limit": ctx.limits["mean_logit_gap"]},
              "sampled_set_gap": {"value": mean(gaps[ng:n]),
                                  "limit": ctx.limits["sampled_set_gap"]}}
    info = {"checked_requests": [ng, n - ng],
            "checked_tokens": [int(sum(len(s) for _, s, _ in checked[k])) for k in checked],
            "reference_s": ref_s,
            "widest_logit_gap": max((float(g.max()) for g in gaps[:ng]), default=None),
            "not_ref_argmax": int(sum(int((g > 0).sum()) for g in gaps[:ng])),
            "outside_set": int(sum(int((g > 0).sum()) for g in gaps[ng:n])),
            "pool_pages_high_water": [counters["pool_pages_high_water"], counters["pool_pages"]],
            "preemptions": counters["preemptions"]}
    if ctx.control:
        cg = gaps[n:]
        info["control_mean_logit_gap"] = mean(cg[:ng])
        info["control_sampled_set_gap"] = mean(cg[ng:])
        info["control_widest_logit_gap"] = max((float(g.max()) for g in cg[:ng]), default=None)
        info["control_not_ref_argmax"] = int(sum(int((g > 0).sum()) for g in cg[:ng]))
        info["control_outside_set"] = int(sum(int((g > 0).sum()) for g in cg[ng:]))
    return dict(e2e=e2e, record=record, checks=checks, info=info, attempted=attempted,
                failed=failed, device=device, setup_s=setup_s)

