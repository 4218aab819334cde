#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``vats_tpu_torch``) once on one card.

    python3 chip_smoke.py              # every phase, one GPU
    python3 chip_smoke.py --phases build,kernels

Phases:
  build    build every CUDA kernel from ``vats_tpu_torch/csrc`` (one nvcc per
           source, all at once); print the card's name and power limit.
  kernels  hold each kernel against its plain PyTorch version on the card at
           the shapes of the main path, and time kernel, plain version,
           bound and (K2) the library call ``scaled_dot_product_attention``.
  main     the main path at full width (nlp_medium, 8 experts, top-2, bf16,
           random weights from a seed): ``generate_paged`` over ragged
           prompts up to 512 tokens (whole-batch and row-chunked prefill) and
           the dense ``TokenGenerator``.  Launch counters are zeroed just
           before and read just after; each must equal 20 layers x calls.
  parity   full width, 2 layers: ``generate_paged`` and ``generate`` on the
           card (kernels) against the CPU (plain versions), same weights.

The last two lines of standard output are one JSON object listing every
kernel, then ``{"ok": true, "device": {...}}``.  Any failed phase raises and
the script exits non-zero without printing the result.  Without a CUDA
device, or outside a checkout of the repository, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "kernels", "main", "parity")
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Per-call time between CUDA events around ``iters`` calls: what a
    caller waits, host overhead of the wrapper included."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(prof) -> dict:
    """{kernel name: (total device us, count)} from a profiler run."""
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            out[e.key] = (us, e.count)
    return out


def device_ms(fn, iters=20) -> float:
    """Per-call device time: the summed duration of every kernel, copy and
    memset the call puts on the card (torch.profiler), host gaps excluded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(us for us, _ in _device_us(prof).values())
    if total <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total / iters / 1e3


def timed(fn):
    """(device ms, call ms) of one call."""
    return device_ms(fn), cuda_ms(fn)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def expect_close(name, got, want, atol, rtol):
    import torch

    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    if not bool(torch.isfinite(got.float()).all()) or bool((err > lim).any()):
        raise AssertionError(
            f"{name}: max |err| {float(err.max()):.3e} beyond atol {atol} + "
            f"rtol {rtol} * |ref|"
        )
    return float(err.max())


# --- phase: kernels ---------------------------------------------------------

# Kernel and plain version both accumulate in fp32 and round the output to
# bf16 once; their sums run in another order, so they may differ by one bf16
# ulp (2^-8 relative) of the output, plus a small absolute floor near zero.
BF16_ATOL, BF16_RTOL = 2e-3, 1e-2


def check_k1(gen):
    import torch

    from vats_tpu_torch.ops.decode_attention import (
        PagedKVCache,
        paged_decode_attention_commit,
        paged_decode_attention_ref,
    )

    dev = "cuda"
    L, B, G, N, hd, hdp, ps, pps = 20, 32, 8, 3, 60, 64, 128, 5
    layer, scale = 7, 1.0 / hd**0.5
    P = B * pps
    pool = torch.randn((L, P, 2, G, ps, hdp), generator=gen, device=dev).to(torch.bfloat16)
    pool[..., hd:] = 0  # stored pad rows are zero
    # ragged lengths up to 576: empty, page edges, one past an edge, capacity
    lens = torch.randint(1, 577, (B,), generator=gen, device=dev)
    lens[:6] = torch.tensor([0, 1, 127, 128, 576, pps * ps], device=dev)
    lengths = lens.to(torch.int32)
    table = torch.randperm(P, generator=gen, device=dev).to(torch.int32).reshape(B, pps)
    q = torch.randn((B, G * N, hd), generator=gen, device=dev).to(torch.bfloat16)
    k_cur = torch.randn((B, G, hd), generator=gen, device=dev).to(torch.bfloat16)
    v_cur = torch.randn((B, G, hd), generator=gen, device=dev).to(torch.bfloat16)

    pool_k, pool_p = pool.clone(), pool.clone()
    n0 = paged_decode_attention_commit.launches
    out_k = paged_decode_attention_commit(
        q, pool_k, layer, table, lengths, scale=scale, k_cur=k_cur, v_cur=v_cur
    )
    out_p = paged_decode_attention_ref(
        q, pool_p[layer], table, lengths, scale=scale, k_cur=k_cur, v_cur=v_cur
    )
    PagedKVCache(pool_p, table, lengths).append_token(layer, k_cur, v_cur)
    torch.cuda.synchronize()
    require(paged_decode_attention_commit.launches == n0 + 1, "K1 did not launch")
    err = expect_close("K1 out", out_k, out_p, BF16_ATOL, BF16_RTOL)
    if not torch.equal(pool_k, pool_p):
        raise AssertionError("K1 committed pool differs from the plain append")

    def kern():
        paged_decode_attention_commit(
            q, pool_k, layer, table, lengths, scale=scale, k_cur=k_cur, v_cur=v_cur
        )

    def plain():
        paged_decode_attention_ref(
            q, pool_p[layer], table, lengths, scale=scale, k_cur=k_cur, v_cur=v_cur
        )
        PagedKVCache(pool_p, table, lengths).append_token(layer, k_cur, v_cur)

    (ms, call_ms), (plain_ms, plain_call_ms) = timed(kern), timed(plain)
    tokens = int(lengths.sum())
    nbytes = (
        2 * q.numel() * 2  # q in, out
        + 2 * k_cur.numel() * 2 * 2  # current K/V in, committed K/V out
        + tokens * 2 * G * hdp * 2  # settled history, read once
        + table.numel() * 4 + B * 4
    )
    flops = 4 * G * N * hd * (tokens + B)  # q.k and p.v per attended column
    b_ms, by = bound(nbytes, flops)
    log(f"K1 paged decode+commit B={B} Hq={G * N} hd={hd} ps={ps} "
        f"lengths<=576: max_abs_err={err:.3e} pool bit-equal; kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({by}); per call with host "
        f"overhead: kernel {call_ms:.4f} plain {plain_call_ms:.4f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, library_ms=None)


def check_k2(gen):
    import torch
    import torch.nn.functional as F

    from vats_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref

    dev = "cuda"
    B, T, Hq, G, hd = 8, 512, 24, 8, 60
    scale = 1.0 / hd**0.5
    mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)  # noqa: E731
    q, k, v = mk(B, T, Hq, hd), mk(B, T, G, hd), mk(B, T, G, hd)
    kw = dict(scale=scale, causal=True, left_window=-1, right_window=0)
    n0 = flash_attention.launches
    out_k = flash_attention(q, k, v, **kw)
    out_p = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    require(flash_attention.launches == n0 + 1, "K2 did not launch")
    err = expect_close("K2 out", out_k, out_p, BF16_ATOL, BF16_RTOL)
    # a padded, windowed, segmented case at the same width
    valid = torch.rand((B, T), generator=gen, device=dev) > 0.1
    seg = torch.cumsum(torch.rand((B, T), generator=gen, device=dev) > 0.97, 1)
    kw2 = dict(scale=scale, causal=True, left_window=100, kv_valid=valid,
               q_segment_ids=seg, kv_segment_ids=seg)
    err2 = expect_close("K2 masked out", flash_attention(q, k, v, **kw2),
                        flash_attention_ref(q, k, v, **kw2), BF16_ATOL, BF16_RTOL)

    ms, call_ms = timed(lambda: flash_attention(q, k, v, **kw))
    plain_ms, plain_call_ms = timed(lambda: flash_attention_ref(q, k, v, **kw))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    try:
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale,
                                       enable_gqa=True)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True)
    except TypeError:  # a PyTorch without enable_gqa: repeat K/V beforehand
        kr, vr = (x.repeat_interleave(Hq // G, dim=1) for x in (kt, vt))
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kr, vr, is_causal=True, scale=scale)
    library_ms, library_call_ms = timed(lib)
    pairs = B * T * (T + 1) // 2
    nbytes = (q.numel() * 2 + k.numel() + v.numel()) * 2
    flops = 4 * Hq * hd * pairs
    b_ms, by = bound(nbytes, flops)
    log(f"K2 flash forward B={B} T={T} Hq={Hq} G={G} hd={hd} causal: "
        f"max_abs_err={err:.3e} (padded/window/segments {err2:.3e}); "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"bound_ms={b_ms:.5f} ({by}); per call with host overhead: kernel "
        f"{call_ms:.4f} plain {plain_call_ms:.4f} library {library_call_ms:.4f}")
    return dict(max_abs_err=max(err, err2), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=by, library_ms=library_ms)


def check_k3(gen):
    import torch

    from vats_tpu_torch.ops.cache_append import append_token_inplace, append_token_ref

    dev = "cuda"
    L, B, G, hdp, S = 20, 16, 8, 64, 544
    k = torch.randn((L, B, G, hdp, S), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((L, B, G, hdp, S), generator=gen, device=dev).to(torch.bfloat16)
    kn = torch.randn((B, G, hdp), generator=gen, device=dev).to(torch.bfloat16)
    vn = torch.randn((B, G, hdp), generator=gen, device=dev).to(torch.bfloat16)
    n0 = append_token_inplace.launches
    for pos in (0, 127, 300, S - 1, S + 7):  # the last one clamps to S-1
        length = torch.tensor(pos, dtype=torch.int32, device=dev)
        ka, va, kb, vb = k.clone(), v.clone(), k.clone(), v.clone()
        append_token_inplace(ka, va, 5, kn, vn, length)
        append_token_ref(kb, vb, 5, kn, vn, length)
        torch.cuda.synchronize()
        if not (torch.equal(ka, kb) and torch.equal(va, vb)):
            raise AssertionError(f"K3 append differs from the plain version at {pos}")
    require(append_token_inplace.launches == n0 + 5, "K3 did not launch")
    length = torch.tensor(300, dtype=torch.int32, device=dev)
    ms, call_ms = timed(lambda: append_token_inplace(ka, va, 5, kn, vn, length))
    plain_ms, plain_call_ms = timed(lambda: append_token_ref(kb, vb, 5, kn, vn, length))
    nbytes = 2 * kn.numel() * 2 * 2 + 4  # new K/V read, the same written
    b_ms, by = bound(nbytes, 0)
    log(f"K3 dense append cache [{L},{B},{G},{hdp},{S}]: bit-equal at "
        f"positions 0/127/300/S-1/clamped; kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.6f} ({by}); per call with host "
        f"overhead: kernel {call_ms:.4f} plain {plain_call_ms:.4f}")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, library_ms=None)


# --- phase: main ------------------------------------------------------------


class StubTokenizer:
    pad_token_id = 0
    eos_token_id = None

    def encode(self, text):
        return [sum(map(ord, w)) % 60000 + 1 for w in text.split()]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


def medium_cfg(**kw):
    from vats_tpu_torch.configs import nlp_medium

    return nlp_medium(
        dropout=0.0, num_experts=8, top_k=2, param_dtype="bfloat16",
        capacity_factor=1.25, gradient_checkpointing=False, left_window=-1,
        use_mqa=False, **kw,
    )


def ragged_prompts(gen, b, t, t_min, vocab, dev):
    import torch

    lens = torch.randint(t_min, t + 1, (b,), generator=gen, device=dev)
    lens[0] = t
    ids = torch.randint(1, vocab, (b, t), generator=gen, device=dev)
    mask = torch.arange(t, device=dev)[None, :] < lens[:, None]
    return torch.where(mask, ids, 0).to(torch.int32), mask


def run_main(counters):
    import torch

    from vats_tpu_torch.configs import GenerationArgs
    from vats_tpu_torch.inference import TokenGenerator, generate_paged
    from vats_tpu_torch.models import TextLM
    from vats_tpu_torch.ops.decode_attention import PagedKVCache

    cfg = medium_cfg()
    B, T, steps, rc = 16, 512, 32, 8
    t0 = time.perf_counter()
    model = TextLM(cfg, device="cuda", seed=0).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"main: nlp_medium E8/top-2 bf16, {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}: {n_params / 1e9:.3f}B params, "
        f"built in {time.perf_counter() - t0:.1f}s")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    ids, mask = ragged_prompts(gen, B, T, 300, cfg.vocab_size, "cuda")
    kw = dict(max_new_tokens=steps, temperature=0.8, top_k=50, do_sample=True,
              pad_token_id=0, page_size=128)
    ga = GenerationArgs(max_new_tokens=steps, temperature=0.0, do_sample=False,
                        top_k=None, top_p=None, repetition_penalty=None)
    prompt = " ".join(f"word{i}" for i in range(40))

    for c in counters:
        c.launches = 0
    tok_a, len_a = generate_paged(model, ids, mask, gen, **kw)
    tok_b, len_b = generate_paged(model, ids, mask, gen, prefill_row_chunk=rc, **kw)
    tg = TokenGenerator(cfg, params=model.state_dict(), use_paged=False)
    text = tg.generate_tokens(prompt, ga, StubTokenizer())
    torch.cuda.synchronize()
    counts = {c.__name__: c.launches for c in counters}

    L = cfg.num_layers
    want = {
        "flash_attention": L * (1 + B // rc),
        "paged_decode_attention_commit": L * steps * 2,
        "append_token_inplace": L * steps,
    }
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{name} launched {counts[name]} times, expected {n}")
    want_len = mask.sum(1).to(torch.int32) + steps
    for tok, ln in ((tok_a, len_a), (tok_b, len_b)):
        if tok.shape != (B, T + steps) or not torch.equal(ln, want_len):
            raise AssertionError("generate_paged returned wrong shapes or lengths")
        if int(tok.min()) < 0 or int(tok.max()) >= cfg.vocab_size:
            raise AssertionError("generate_paged emitted out-of-vocab ids")
    n_new = len(text.split())
    if n_new != steps:
        raise AssertionError(f"TokenGenerator returned {n_new} tokens, not {steps}")
    log(f"main: launches {json.dumps(counts)} (expected {json.dumps(want)})")

    # timing (after the counted run): prefill alone, then the whole call
    def prefill():
        cache = PagedKVCache.create(L, B, T + steps, cfg.query_groups, cfg.head_dim,
                                    page_size=128, dtype=torch.bfloat16, device="cuda")
        last = torch.clamp(mask.sum(1) - 1, min=0)
        with torch.no_grad():
            model(ids, padding_mask=mask, paged_cache=cache, readout_positions=last)

    prefill()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill()
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    generate_paged(model, ids, mask, gen, **kw)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    decode_tps = B * steps / (total_s - prefill_s)
    t0 = time.perf_counter()
    tg.generate_tokens(prompt, ga, StubTokenizer())
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    log(f"main: generate_paged B={B} prompts {int(mask.sum(1).min())}..{T} tokens, "
        f"{steps} steps: total_s={total_s:.3f} prefill_s={prefill_s:.3f} "
        f"decode_tokens_per_s={decode_tps:.1f} end_to_end_tokens_per_s="
        f"{B * steps / total_s:.1f} peak_mem_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f}; dense TokenGenerator B=1 "
        f"{steps} tokens: {dense_s:.3f}s ({steps / dense_s:.1f} tokens/s)")
    profile_breakdown("generate_paged", lambda: generate_paged(model, ids, mask, gen, **kw))
    profile_breakdown("dense TokenGenerator",
                      lambda: tg.generate_tokens(prompt, ga, StubTokenizer()))
    del model, tg
    torch.cuda.empty_cache()
    return counts


def profile_breakdown(label, fn, top=10):
    """Device busy time, idle share and the heaviest kernels of one call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = _device_us(prof)
    busy = sum(us for us, _ in per.values()) / 1e6
    log(f"main: profiled {label}: wall_s={wall:.3f} (profiler on) "
        f"device_busy_s={busy:.3f} idle_share={1 - busy / wall:.3f}")
    for name, (us, n) in sorted(per.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {us / 1e3:10.3f} ms {n:7d}x  {name[:100]}")


# --- phase: parity ----------------------------------------------------------

# bf16 on both sides; the CPU and the card round matmul sums at other places,
# and two layers at d_model 1440 carry that to the logits.  Logits are
# O(1) here (tied readout of std-0.02 embeddings over a unit-RMS state).
LOGIT_ATOL = 0.08


def _paged_logits(model, ids, mask, gen_tokens, steps):
    import torch

    from vats_tpu_torch.ops.decode_attention import PagedKVCache

    cfg = model.cfg
    b, t = ids.shape
    cache = PagedKVCache.create(cfg.num_layers, b, t + steps, cfg.query_groups,
                                cfg.head_dim, page_size=128, dtype=torch.bfloat16,
                                device=model.device)
    last = torch.clamp(mask.sum(1) - 1, min=0)
    out = []
    with torch.no_grad():
        lg, cache, _ = model(ids, padding_mask=mask, paged_cache=cache,
                             readout_positions=last)
        out.append(lg[:, 0].float().cpu())
        for s in range(steps - 1):
            lg, cache, _ = model(gen_tokens[:, s:s + 1], paged_cache=cache)
            out.append(lg[:, 0].float().cpu())
    return torch.stack(out, 1)  # [B, steps, V]


def _dense_logits(model, ids, mask, gen_tokens, steps):
    import torch

    b, t = ids.shape
    cache = model.init_cache(b, t + steps)
    valid = torch.zeros((b, t + steps), dtype=torch.bool, device=model.device)
    valid[:, :t] = mask
    last = torch.clamp(mask.sum(1) - 1, min=0)
    out = []
    with torch.no_grad():
        lg, cache, _ = model(ids, padding_mask=valid, cache=cache,
                             readout_positions=last)
        out.append(lg[:, 0].float().cpu())
        for s in range(steps - 1):
            valid[:, t + s] = True
            lg, cache, _ = model(gen_tokens[:, s:s + 1], padding_mask=valid,
                                 cache=cache)
            out.append(lg[:, 0].float().cpu())
    return torch.stack(out, 1)


def _compare_greedy(name, tok_gpu, tok_cpu, logit_c, logit_g):
    """Greedy tokens on the card against the CPU's, step by step.

    The CPU's tokens are the argmax of its teacher-forced logits (generate
    and stepping the model agree).  Teacher-forced on those tokens, the
    card's argmax must be the CPU's token or a near tie: a token whose CPU
    logit is within 2 * LOGIT_ATOL of the CPU maximum (random-weight logits
    over 65536 ids have top-2 gaps of that order, which bf16 may flip).  The
    card's own free-running tokens must equal the CPU's up to their first
    difference, and that difference must be such a tie."""
    b, steps, _ = logit_c.shape
    top_c = logit_c.max(dim=-1).values
    amax_g = logit_g.argmax(dim=-1)
    exact = ties = free = 0
    for r in range(b):
        for s in range(steps):
            tc, tg = int(tok_cpu[r, s]), int(amax_g[r, s])
            if int(logit_c[r, s].argmax()) != tc:
                raise AssertionError(f"{name}: CPU generate disagrees with its logits")
            if tg == tc:
                exact += 1
            elif float(logit_c[r, s, tg]) >= float(top_c[r, s]) - 2 * LOGIT_ATOL:
                ties += 1
            else:
                raise AssertionError(f"{name}: row {r} step {s}: card picks {tg}, "
                                     f"CPU {tc}, not a near tie")
        for s in range(steps):
            tg = int(tok_gpu[r, s])
            if tg != int(tok_cpu[r, s]):
                if float(logit_c[r, s, tg]) < float(top_c[r, s]) - 2 * LOGIT_ATOL:
                    raise AssertionError(f"{name}: row {r} free-running token "
                                         f"{s} differs beyond a near tie")
                break
            free += 1
    return exact, ties, free


def run_parity():
    import torch

    from vats_tpu_torch.inference import generate, generate_paged
    from vats_tpu_torch.models import TextLM

    cfg = medium_cfg(num_layers=2)
    steps, T = 8, 300
    gpu = TextLM(cfg, device="cuda", seed=7).eval()
    cpu = TextLM(cfg, device="meta")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, assign=True)
    cpu.eval()
    gen = torch.Generator(device="cpu").manual_seed(99)
    lens = torch.tensor([T, 260])
    ids = torch.randint(1, cfg.vocab_size, (2, T), generator=gen)
    mask = torch.arange(T)[None, :] < lens[:, None]
    ids = torch.where(mask, ids, 0).to(torch.int32)
    kw = dict(max_new_tokens=steps, temperature=0.0, do_sample=False, pad_token_id=0)
    report = []
    for name, fn, logits_fn in (
        ("generate_paged", generate_paged, _paged_logits),
        ("generate", generate, _dense_logits),
    ):
        tc, lc = fn(cpu, ids, mask, None, **kw)
        tg, lg = fn(gpu, ids.cuda(), mask.cuda(), None, **kw)
        lg = lg.cpu()
        if not torch.equal(lc, lg):
            raise AssertionError(f"{name}: lengths differ between CPU and card")
        start = lens if name == "generate_paged" else torch.full((2,), T)
        gen_c = torch.stack([tc[r, int(start[r]):int(start[r]) + steps] for r in range(2)])
        gen_g = torch.stack([tg.cpu()[r, int(start[r]):int(start[r]) + steps]
                             for r in range(2)])
        logit_c = logits_fn(cpu, ids, mask, gen_c, steps)
        logit_g = logits_fn(gpu, ids.cuda(), mask.cuda(), gen_c.cuda(), steps)
        err = float((logit_c - logit_g).abs().max())
        if not err <= LOGIT_ATOL or not bool(torch.isfinite(logit_g).all()):
            raise AssertionError(f"{name}: step logits differ by {err:.3e} > {LOGIT_ATOL}")
        exact, ties, free = _compare_greedy(name, gen_g, gen_c, logit_c, logit_g)
        report.append(
            f"{name}: max |logit err| {err:.3e} over {steps} steps "
            f"(|logits| <= {float(logit_c.abs().max()):.2f}); teacher-forced greedy "
            f"tokens {exact}/{2 * steps} equal, {ties} near ties; free-running "
            f"tokens equal for the first {free}/{2 * steps}")
    log("parity (2 layers, full width, card vs CPU): " + "; ".join(report))


# --- entry point ------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    if not os.path.isdir(os.path.join(HERE, "vats_tpu_torch", "csrc")):
        print("chip_smoke.py: vats_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from vats_tpu_torch.ops import kernels
    from vats_tpu_torch.ops.cache_append import append_token_inplace
    from vats_tpu_torch.ops.decode_attention import paged_decode_attention_commit
    from vats_tpu_torch.ops.flash_attention import flash_attention

    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    card = card_line()
    secs = kernels.build_all()
    log(f"build: {len(kernels.SOURCES)} kernel libraries in {secs:.1f}s")
    for name in kernels.SOURCES:
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernel_rows = [
        dict(name="paged_decode_attention_commit", route="cuda",
             source="vats_tpu_torch/csrc/decode_attention.cu",
             replaces="vats_tpu/ops/decode_attention.py:371", fn=paged_decode_attention_commit,
             check=check_k1),
        dict(name="flash_attention_forward", route="cuda",
             source="vats_tpu_torch/csrc/flash_attention.cu",
             replaces="vats_tpu/ops/flash_attention.py:67", fn=flash_attention,
             check=check_k2),
        dict(name="dense_cache_append", route="cuda",
             source="vats_tpu_torch/csrc/cache_append.cu",
             replaces="vats_tpu/ops/cache_append.py:47", fn=append_token_inplace,
             check=check_k3),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    if "kernels" in phases:
        for row in kernel_rows:
            results[row["name"]] = row["check"](gen)
    counts = {}
    if "main" in phases:
        counts = run_main([row["fn"] for row in kernel_rows])
    if "parity" in phases:
        run_parity()

    line = []
    for row in kernel_rows:
        entry = {k: row[k] for k in ("name", "route", "source", "replaces")}
        entry["launches"] = counts.get(row["fn"].__name__)
        entry.update(results.get(row["name"], {}))
        line.append(entry)
    log(f"total seconds {time.perf_counter() - t_start:.1f}")
    log(card)
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
