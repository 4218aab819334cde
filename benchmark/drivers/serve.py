"""Serving cells: the port's ``ServingEngine`` under a closed or an open loop.

Set-up builds the model from the seed's weights, the engine with the
configuration's settings, captures every prefill key and the decode block
that the cell's traffic uses (by driving requests of each bucket and group
size through the engine, so every key is captured before the window), fills
the prefix cache with the mix's shared prompts, and drives the traffic for
``warmup_s`` to a steady state.  The window then drives ``engine.submit`` /
``engine.step`` for the run's seconds; nothing is captured inside it.  The
device's peak memory is the window's: its count restarts at the window.

The host sees a request's tokens when ``step`` returns; times are taken
there.  Output tokens are counted at each step's end, finished or not.  In
an open loop a request's time to first token runs from when it was due, so
a backlog shows; one with no token by the window's end counts with its wait
so far.

After the window two samples of the finished requests, drawn from the seed
and each with its longest request, are run through the plain reference
(``benchmark/reference``): greedy ones and sampled ones.  At each served
position of a greedy request the gap is how far the served token's logit
lies below the reference's best; of a sampled request, how far it lies
below the least logit of the set the request's rule lets it draw from
(``reference/sampling.py``), 0 inside the set.  The mean gap of each
sample is compared with the cell's limit.  (The widest greedy gap, which
one near-tie sets, spreads too far between seeds to separate the program
from the control; it is kept in the record.)  The control puts the
reference held in fp8 in the program's place: its argmax at the greedy
positions, its own draw by the request's rule, seed and positions at the
sampled ones.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import harness, work
from benchmark import traffic as tr
from benchmark.reference import sampling as ref_sampling
from benchmark.reference.model import Reference, no_tf32
from benchmark.weights import make_params

#: served tokens the check compares, at least (in MIN_CHECKED to MAX_CHECKED
#: requests): a random model's greedy answers settle into repeats whose
#: margins no rounding flips, so the check reads many answers' first tokens
CHECK_TOKENS = 2000
MIN_CHECKED, MAX_CHECKED = 16, 24


def build_model(m: dict, seed: int, device, rec: Optional[harness.Recorder] = None):
    """The port's TextLM over the seed's weights (set-up phases 'weights'
    and 'model' in ``rec``)."""
    from vats_tpu_torch.configs.nlp import ModelArgs
    from vats_tpu_torch.models.text_lm import TextLM

    rec = rec or harness.Recorder()
    with rec.phase("weights"):
        params = make_params(m, seed, getattr(torch, m["param_dtype"]), device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    with rec.phase("model"):
        model = TextLM(ModelArgs(**m), device="meta")
        model.load_state_dict(params, assign=True)
    return model.eval()


def buckets_for(lo: int, hi: int, buckets) -> List[int]:
    """The prompt buckets that lengths in [lo, hi] fall into."""
    out, prev = [], 0
    for b in sorted(buckets):
        if lo <= b and hi > prev:
            out.append(b)
        prev = b
    return out


class Drive:
    """The engine, the traffic and every request's times and counts."""

    def __init__(self, engine, traffic: tr.ServeTraffic, m: dict, rec: harness.Recorder,
                 warm_prefix_len: int):
        from vats_tpu_torch.inference.serving import SamplingParams

        self.eng = engine
        self.t = traffic
        self.m = m
        self.rec = rec
        self.params = SamplingParams
        self.greedy = SamplingParams(temperature=0.0, top_k=1, top_p=0.0)
        self.warm_prefix_len = warm_prefix_len
        n = len(traffic.requests)
        self.rid_of: Dict[int, int] = {}  # engine rid -> traffic index
        self.sent = np.full(n, np.nan)  # when submitted (closed) or due (open)
        self.first = np.full(n, np.nan)
        self.last = np.full(n, np.nan)
        self.count = np.zeros(n, np.int64)
        self.done = np.zeros(n, bool)
        self.outputs: Dict[int, List[int]] = {}
        self.next_open = 0
        self.client_pos = [0] * traffic.clients
        self.failed = 0
        self.t0 = 0.0

    @staticmethod
    def zero() -> dict:
        return dict(decode_forwards=0, decode_rows=0, output_tokens=0, decode_attn_least_s=0.0,
                    forward_least_s=0.0, prefill_tokens=0)

    def submit(self, i: int, now: float):
        req = self.t.requests[i]
        sp = self.greedy if req.greedy else self.params(
            temperature=self.t.sampling["temperature"], top_k=int(self.t.sampling["top_k"]),
            top_p=self.t.sampling["top_p"], seed=req.draw_seed)
        try:
            rid = self.eng.submit(req.prompt, req.max_new_tokens, sampling=sp)
        except ValueError:
            self.failed += 1
            return
        self.rid_of[rid] = i
        self.sent[i] = now if req.due is None else self.t0 + req.due

    def start(self):
        self.t0 = time.perf_counter()
        if self.t.kind == "closed_loop":
            for c in range(self.t.clients):
                self._next_of(c, self.t0)

    def _next_of(self, c: int, now: float):
        pos = self.client_pos[c]
        if pos < len(self.t.per_client[c]):
            self.client_pos[c] = pos + 1
            self.submit(self.t.per_client[c][pos], now)

    def step(self):
        eng = self.eng
        now = time.perf_counter()
        if self.t.kind == "open_loop":
            reqs = self.t.requests
            while self.next_open < len(reqs) and self.t0 + reqs[self.next_open].due <= now:
                self.submit(self.next_open, now)
                self.next_open += 1
        before = {r.rid: len(r.carried) + len(r.output_ids)
                  for r in eng.row_request if r is not None}
        lengths = eng.lengths.copy()
        rows = {r.rid: row for row, r in enumerate(eng.row_request) if r is not None}
        k_before = eng.forwards["decode"]
        p_before = eng.forwards["prefill"]
        with self.rec.span("engine.step"):
            retired = eng.step()
        t = time.perf_counter()
        seen = [r for r in eng.row_request if r is not None] + retired
        new_tokens = 0
        decode_rows = []  # (settled length at the block's start, decode tokens) a row
        prefills = []  # prompt lengths of the rows prefilled in this step
        for r in seen:
            i = self.rid_of.get(r.rid)
            if i is None:
                continue
            n = len(r.carried) + len(r.output_ids)
            prev = int(self.count[i])
            if n > prev:
                new_tokens += n - prev
                if prev == 0:
                    self.first[i] = t
                self.last[i] = t
                self.count[i] = n
            was = before.get(r.rid)
            if was is None:  # admitted in this step: its prefill gave one token
                prefills.append(i)
                if n > 1:
                    decode_rows.append((len(self.t.requests[i].prompt), n - 1))
            elif n > was:
                decode_rows.append((int(lengths[rows[r.rid]]), n - was))
        for r in retired:
            i = self.rid_of.get(r.rid)
            if i is not None and not self.done[i]:
                self.done[i] = True
                self.outputs[i] = list(r.carried) + list(r.output_ids)
                if self.t.kind == "closed_loop":
                    self._next_of(self.t.requests[i].client, t)
        # the step's raw record; its work is counted after the window
        return t, (new_tokens, eng.forwards["decode"] - k_before,
                   eng.forwards["prefill"] - p_before, decode_rows, prefills)

    def step_work(self, new_tokens, k, n_prefill, decode_rows, prefills) -> dict:
        """A step's tokens, forwards and least times of its work, from the
        raw record :meth:`step` returns."""
        m = self.m
        layers, g, h = m["num_layers"], m["query_groups"], m["num_heads"]
        hd = m["d_model"] // h
        pages_per_row = self.eng.pages_per_row
        fpt = work.forward_flops_per_token(m)
        kvb = work.kv_bytes_per_token(m)
        d = self.zero()
        d["output_tokens"] = new_tokens
        d["decode_forwards"] = k
        for j in range(k):
            lens = [L + j for L, n in decode_rows if j < n]
            if not lens:
                continue
            d["decode_rows"] += len(lens)
            nb, nf = work.decode_attn_cost(lens, kv_heads=g, q_per_kv=h // g, hd=hd,
                                           pages_per_row=pages_per_row)
            d["decode_attn_least_s"] += layers * work.least_s(nb, nf)
            pairs = sum(L + 1 for L in lens)
            flops = len(lens) * fpt + work.attention_flops(m, pairs)
            touched = min(m["num_experts"], len(lens) * m["top_k"])
            nbytes = work.weight_bytes(m, touched) + (sum(lens) + len(lens)) * kvb
            d["forward_least_s"] += work.least_s(nbytes, flops)
        if n_prefill:
            flops, nbytes, tail_total = 0.0, n_prefill * work.weight_bytes(m, m["num_experts"]), 0
            for i in prefills:
                req = self.t.requests[i]
                plen = len(req.prompt)
                cached = 0
                if req.prefix >= 0:
                    cached = min(self.warm_prefix_len, (plen - 1) // 128 * 128)
                tail = plen - cached
                tail_total += tail
                flops += tail * fpt + work.attention_flops(m, tail * cached + tail * (tail + 1) // 2)
                nbytes += (cached + tail) * kvb
            d["prefill_tokens"] = tail_total
            d["forward_least_s"] += work.least_s(nbytes, flops)
        return d


def warm_keys(eng, buckets: List[int], rng: np.random.Generator, vocab: int, groups) -> None:
    """Capture the prefill key of every (bucket, group) and the decode block,
    by driving requests of one token's answer through the engine."""
    for b in buckets:
        for r in groups:
            for _ in range(r):
                eng.submit(rng.integers(1, vocab, size=b).tolist(), 1)
            eng.run()


def pick_checked(drive: Drive, rng: np.random.Generator, greedy: bool) -> List[int]:
    """Finished greedy (or sampled) requests to compare: the longest, then
    others drawn from the seed, until CHECK_TOKENS served tokens in
    MIN_CHECKED requests, or MAX_CHECKED."""
    cands = [i for i in drive.outputs if drive.t.requests[i].greedy == greedy]
    if not cands:
        return []
    cands.sort()
    longest = max(cands, key=lambda i: (len(drive.outputs[i]), -i))
    rest = [i for i in rng.permutation(cands).tolist() if i != longest]
    out, total = [longest], len(drive.outputs[longest])
    for i in rest:
        if (total >= CHECK_TOKENS and len(out) >= MIN_CHECKED) or len(out) >= MAX_CHECKED:
            break
        out.append(i)
        total += len(drive.outputs[i])
    return out


def served_gaps(m: dict, seed: int, device, checked, rule: dict, fp8_control: bool = False):
    """Per served position of each checked request (prompt, served tokens,
    draw seed or None when greedy), the gap of the served token under the
    fp32 reference: below its best logit (greedy), below the least logit of
    the request's set (sampled; 0 inside).  With ``fp8_control`` also the
    gaps of the control's tokens at the same positions: [program's] +
    [control's]."""
    no_tf32()
    p16 = make_params(m, seed, getattr(torch, m["param_dtype"]), device)
    params = {k: v.float() for k, v in p16.items()}
    del p16
    ref = Reference(m, params)
    low = Reference(m, params, precision="fp8") if fp8_control else None
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
        for out, tok in zip((prog, ctrl), toks):
            g = floor - logits.gather(1, tok[:, None])[:, 0]
            out.append(g.clamp(min=0).cpu().numpy())
    del params, ref, low
    return prog + ctrl


def run(ctx) -> dict:
    """One run of a serving cell; ``ctx`` as ``benchmark/run.py`` makes it."""
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
    model = build_model(m, seed, dev, rec)
    eng_kw = dict(cfg["engine"])
    eng_kw["prompt_buckets"] = tuple(eng_kw["prompt_buckets"])
    engine = ServingEngine(model, seed=seed % (1 << 32), eos_token_id=None, **eng_kw)
    traffic = tr.serve_traffic(mix, seed, vocab, rate=ctx.rate)
    warm_rng = tr.rng_for(seed, 2)
    groups = [1 << i for i in range(5) if 1 << i <= min(engine.MAX_PREFILL_GROUP,
                                                          engine.max_batch)]
    prompt = mix["prompt"]
    warm_prefix_len = 0
    with rec.phase("captures"):
        warm_keys(engine, buckets_for(prompt["min"], prompt["max"], engine.prompt_buckets),
                  warm_rng, vocab, groups)
    if traffic.prefixes:
        with rec.phase("prefix_fill"):
            plen = len(traffic.prefixes[0])
            warm_prefix_len = plen // engine.page_size * engine.page_size
            for i in range(0, len(traffic.prefixes), 4):  # small groups: a 2048 bucket's
                for p in traffic.prefixes[i:i + 4]:       # scores are [rows, H, 2048, 4096]
                    engine.submit(p, 1)
                engine.run()
    drive = Drive(engine, traffic, m, rec, warm_prefix_len)
    with rec.phase("warmup_drive"):
        drive.start()
        t_end = drive.t0 + float(mix["warmup_s"])
        while time.perf_counter() < t_end:
            drive.step()
    # the window: from the end of a step to the end of the last step that
    # ends inside the run's seconds
    hit0 = (engine.prefix_cache.hit_tokens, engine.prefix_cache.query_tokens)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_ws = time.perf_counter()
    setup_s = time.time() - ctx.process_start
    failed0 = drive.failed
    win, traced_counts = Drive.zero(), Drive.zero()
    trace = harness.DeviceTrace(rec) if ctx.trace else None
    trace_at, trace_len = t_ws + ctx.seconds / 3.0, min(3.0, ctx.seconds / 3.0)
    traced, tracing, t_last = None, False, t_ws
    steps = []  # (raw record, traced) of every step that ends inside the window
    # set-up's garbage out of the collector's way: no full collection of it
    # lands inside the window
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
    if tracing:  # the step past the window ran under the profiler: not its span
        trace.stop()
    gc.unfreeze()
    for raw, in_trace in steps:
        for key, v in drive.step_work(*raw).items():
            win[key] += v
            if in_trace:
                traced_counts[key] += v
    hit1 = (engine.prefix_cache.hit_tokens, engine.prefix_cache.query_tokens)
    counters = dict(win, window_s=t_last - t_ws, prefix_hit_tokens=hit1[0] - hit0[0],
                    prefix_query_tokens=hit1[1] - hit0[1], queued_at_end=len(engine.queue),
                    preemptions=engine.preemptions, pool_pages=eng_kw["total_pages"],
                    pool_pages_high_water=engine.allocator.high_water)
    return finish(ctx, drive, t_ws, t_last, setup_s, failed0, counters, traced, traced_counts)


def serve_e2e(drive: Drive, t_ws: float, t_we: float) -> dict:
    """The window's end-to-end numbers: output tokens a second, and in an
    open loop the p95 time to first token from the due time (censored at
    the window's end) and the p95 time per output token."""
    window = t_we - t_ws
    out = {}
    sent = drive.sent
    due_in = [i for i in range(len(sent)) if not math.isnan(sent[i]) and t_ws <= sent[i] <= t_we]
    if drive.t.kind == "open_loop":
        ttft = []
        for i in due_in:
            f = drive.first[i]
            ttft.append((f if not math.isnan(f) and f <= t_we else t_we) - sent[i])
        tpot = [(drive.last[i] - drive.first[i]) / (drive.count[i] - 1)
                for i in range(len(sent))
                if drive.done[i] and drive.count[i] > 1 and t_ws <= drive.first[i]
                and drive.last[i] <= t_we]
        out["ttft_p95_s"] = harness.percentile(ttft, 95)
        out["tpot_p95_ms"] = None if not tpot else harness.percentile(tpot, 95) * 1e3
        out["_ttft_n"], out["_tpot_n"] = len(ttft), len(tpot)
    out["_attempted"] = len(due_in)
    out["_window_s"] = window
    return out


def finish(ctx, drive: Drive, t_ws, t_we, setup_s, failed0, counters, traced, traced_counts):
    """Reads the window's numbers and memory, frees the engine, then checks
    samples of the finished greedy and sampled requests against the
    reference."""
    m, dev = ctx.config["model"], ctx.device
    e2e = serve_e2e(drive, t_ws, t_we)
    window = counters["window_s"]
    e2e["serve_tokens_per_s"] = counters["output_tokens"] / window if window > 0 else None
    device = harness.device_line(ctx.chips) if dev.type == "cuda" else None
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
            "pool_pages_high_water": [counters["pool_pages_high_water"], counters["pool_pages"]]}
    if ctx.control:
        cg = gaps[n:]
        info["control_mean_logit_gap"] = mean(cg[:ng])
        info["control_sampled_set_gap"] = mean(cg[ng:])
        info["control_widest_logit_gap"] = max((float(g.max()) for g in cg[:ng]), default=None)
        info["control_not_ref_argmax"] = int(sum(int((g > 0).sum()) for g in cg[:ng]))
        info["control_outside_set"] = int(sum(int((g > 0).sum()) for g in cg[ng:]))
    return dict(e2e=e2e, record=record, checks=checks, info=info, attempted=attempted,
                failed=failed, device=device, setup_s=setup_s)
