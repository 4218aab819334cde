#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``vats_tpu_torch``) once on one card.

    python3 chip_smoke.py              # every phase, one GPU
    python3 chip_smoke.py --phases build,kernels

Phases:
  build    build every CUDA kernel from ``vats_tpu_torch/csrc`` (one nvcc per
           source, all at once); print the card's name and power limit and
           ptxas's registers, shared memory and spills; fail unless every
           bf16 flash forward and backward kernel holds tensor-core
           instructions (HGMMA).
  kernels  hold each kernel against its plain PyTorch version on the card at
           the shapes of the main path, and time kernel, plain version,
           bound and (K2, K2', K5) the library call
           ``scaled_dot_product_attention``; K2, K2' and the whole backward
           (di, K5a, K5b, casts) in turns with it (ratio, TFLOP/s, share of
           the bound), K2 and the backward also at T=S=2048.  K1, K1' and K4
           at the serving shape (B=32, lengths <= 576) and at nlp_medium's
           max_seq_len (B=8, lengths <= 4096), the kernel alone beside the
           call, and K1 with every row at one length (where its time goes).
           K3: its append-only mode bit-equal to ``append_token_ref``; its
           fused decode prologue (dense, ring and paged modes at B 1, 16, 32,
           bf16 and fp32) within PROLOGUE_ULPS of the unfused chain, pad
           lanes and the rest of the cache exact, timed against the chain.
           Each check draws its inputs from its own seed.
  main     the main path at full width (nlp_medium, 8 experts, top-2, bf16,
           random weights from a seed): ``generate_paged`` over ragged
           prompts up to 512 tokens (whole-batch and row-chunked prefill) and
           the dense ``TokenGenerator``, every decode step after the first
           replayed from a CUDA graph.  Launch counters are zeroed just
           before and read just after; each must equal 20 layers x calls
           (K3's fused prologue once a layer a decode forward, its
           append-only mode never).  Then the graph and the eager decode
           loop in turns (graph, eager, eager, graph; equal tokens), each
           profiled; kernels per decode forward by name (``decode_census``);
           K3's dense prologue in replayed dense graphs at B 1, 16, 32 beside
           an empty kernel of its grid and the chain it replaced.
  parity   full width, 2 layers: ``generate_paged`` and ``generate`` on the
           card (kernels, decode replayed from graphs) against the CPU (plain
           versions), same weights; at most one (row, step) whose MoE router
           picks other experts on a near tie is excused from the logit
           bound, and reported.
  serve    the continuous-batching ``ServingEngine`` at full width
           (nlp_medium, 8 experts, top-2, bf16): 64 requests (32 sharing a
           256-token prefix) through 32 rows, a 129-page pool (requests queue
           and rows are preempted), prefix caching, 4-step decode blocks,
           greedy; three configurations: bf16 KV (K1), int8 KV (K4), int8
           weights + int8 KV.  Each is driven with its decode blocks replayed
           from CUDA graphs and eagerly, in turns (equal tokens), each
           drive profiled once more: throughput, request latency, capture
           seconds, peak memory, device-busy time and idle share; pages,
           preemptions, prefix hits; launch counts of K1, K4 and K3's paged
           prologue against the decode forwards a hook counts; kernels per
           decode forward of each configuration.
  serve_parity  2 layers at full width: one int8-KV stream of 8 requests
           (prefix sharing, a preemption) on the card (K4, replayed graphs;
           logits from an eager drive with equal tokens) and on the CPU
           (plain version); per-forward logit error and token agreement.
  train    the training step at the JAX bench's ``medium_dense`` tier (d1440,
           20 layers, vocab 65536, B=16, T=512, remat 'dots', fused CE 128,
           bf16 AdamW mu): one warm-up step, timed steps with launch counts
           of K2', K5a and K5b, a profiled step; then ``medium_moe`` (d768,
           12 layers, 8 experts, top-2) for a few steps.
  train_parity  2 layers at full width, B=2, T=512, dropout 0: three train
           steps on the card (flash kernels) and on the CPU from the same
           weights and batch; loss, grad norm and params after each step.

``run_census`` (kernels per decode forward and the chain K3's prologue
replaced) needs only what every slice has, so it also measures a checkout
of an earlier commit (its docstring says how).

The last two lines of standard output are one JSON object listing every
kernel, then ``{"ok": true, "device": {...}}``.  Any failed phase raises and
the script exits non-zero without printing the result.  Without a CUDA
device, or outside a checkout of the repository, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "kernels", "main", "parity", "serve", "serve_parity", "train",
          "train_parity")
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores


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
    """{kernel name: (total device us, count)} from a profiler run, summed
    over its raw device events (``key_averages()`` first builds an event
    tree in Python: tens of seconds for a serve stream's ~10^5 launches)."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            us, n = out.get(e.name(), (0.0, 0))
            out[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    return out


def profiled(fn, iters=1, tries=3):
    """({kernel name: (device us, count)}, wall s of the last try) over
    ``iters`` calls under torch.profiler.  The profiler now and then records
    no device activity for a window; such a window is profiled again, up to
    ``tries`` times, and {} means it never recorded any."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        per = _device_us(prof)
        if per:
            return per, wall
    return {}, wall


def device_ms(fn, iters=20) -> float:
    """Per-call device time: the summed duration of every kernel, copy and
    memset the call puts on the card (torch.profiler), host gaps excluded.
    Where the profiler records nothing, the CUDA-event time, said so."""
    import torch

    fn()
    torch.cuda.synchronize()
    per, _ = profiled(fn, iters)
    if not per:
        log("  (torch.profiler recorded no device time: CUDA-event time instead)")
        return cuda_ms(fn, iters)
    return sum(us for us, _ in per.values()) / iters / 1e3


def timed(fn):
    """(device ms, call ms) of one call."""
    return device_ms(fn), cuda_ms(fn)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# bf16 wgmma kernel instantiations per library: 3 head dims x (K2, K2') in
# the forward, 3 x (K5a, K5b) in the backward.
WGMMA_KERNELS = {"flash_attention": 6, "flash_backward": 6}


def tensor_core_instructions(kernels, name):
    """({bf16 wgmma kernel instantiation of ``csrc/<name>.cu``: tensor-core
    instructions}, the instruction counted): HGMMA in ``cuobjdump -sass`` of
    the built library where the toolkit has cuobjdump, else wgmma.mma_async
    in the PTX that nvcc emits for the same source."""
    nvcc = kernels.nvcc_path()
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if os.path.exists(tool):
        text = subprocess.run([tool, "-sass", str(kernels.lib_path(name))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        head, marker = r"Function : (\S+)", "HGMMA"
    else:
        ptx = kernels.BUILD_DIR / f"{name}.ptx"
        subprocess.run([nvcc, "-ptx", "-arch=compute_90a", "-std=c++17", "-O3", "-o",
                        str(ptx), str(kernels.CSRC_DIR / f"{name}.cu")],
                       check=True, timeout=300)
        text = ptx.read_text()
        head, marker = r"\.entry (\w+)", "wgmma.mma_async"
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.search(head, line)
        if m:
            k = re.search(r"(flash_\w+?)_wgmma_kernelILi(\d+)E(?:Lb(\d))?", m.group(1))
            fn = (f"{k.group(1)} D={k.group(2)}{' LSE' if k.group(3) == '1' else ''}"
                  if k else None)
            if fn:
                counts[fn] = 0
        elif fn and marker in line:
            counts[fn] += 1
    return counts, marker


def expect_close(name, got, want, atol, rtol, extra=None):
    """Max |got - want|; raises beyond atol + rtol * |want| (+ ``extra``, a
    per-element allowance, where given: then the elements that needed it are
    counted and printed)."""
    import torch

    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    over = 0
    if extra is not None:
        over = int((err > lim).sum())
        lim = lim + extra
    if not bool(torch.isfinite(got.float()).all()) or bool((err > lim).any()):
        raise AssertionError(
            f"{name}: max |err| {float(err.max()):.3e} beyond atol {atol} + "
            f"rtol {rtol} * |ref|" + (" + the allowance" if extra is not None else "")
        )
    if extra is not None:
        log(f"  {name}: {over} elements beyond {atol} + {rtol}*|ref|, all within the "
            f"p flip allowance (largest {float(extra.max()):.3e})")
    return float(err.max())


# --- phase: kernels ---------------------------------------------------------

# Kernel and plain version both accumulate in fp32 and round the output to
# bf16 once; their sums run in another order, so they may differ by one bf16
# ulp (2^-8 relative) of the output, plus a small absolute floor near zero.
BF16_ATOL, BF16_RTOL = 2e-3, 1e-2


def p_flip_allowance(q, k, v, **kw):
    """Per output element of the bf16 flash forward (K2, K2'): how far two
    flipped roundings of p could move it.  Kernel and plain version round
    the same fp32 p to bf16 before P.V, and their fp32 p differ in the last
    bits (exp2 on the special-function unit, sums in another order), so now
    and then a rounding flips: one bf16 ulp, at most 2^-7 p_j, moves the
    output by at most 2^-7 (p_j / l) |v_j|.  The allowance is two such flips
    at the row's largest (p_j / l) |v_j|, dimension by dimension, from the
    plain version's own probabilities: up to 2^-6 |v| in a row over one or
    two keys (a segment's or a window's first queries), where one flip
    exceeds a bf16 ulp of the output, and small in a row over many keys.  A
    key wrongly in or out of the mask moves the output by (p_j / l)
    |v_j - out|: beyond this wherever p_j |v_j - out| exceeds 2^-6 of the
    row's largest p_i |v_i|."""
    import torch

    from vats_tpu_torch.ops.flash_attention import flash_attention_ref

    b, s, g, d = v.shape
    hq = q.shape[2]
    # the plain version's p_j / l, [B, T, Hq, S]: its output over one-hot
    # values, d keys a call
    probs = torch.empty((b, q.shape[1], hq, s), device=q.device)
    for c in range(0, s, d):
        w = torch.arange(min(d, s - c), device=v.device)
        onehot = torch.zeros_like(v)
        onehot[:, c + w, :, w] = 1
        probs[..., c:c + len(w)] = flash_attention_ref(q, k, onehot, **kw)[..., :len(w)].float()
    va = v.float().abs()
    top = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for h in range(hq):  # max_j (p_j / l) |v_j| per (row, query, dim), a head at a time
        top[:, :, h] = (probs[:, :, h, :, None] * va[:, None, :, h // (hq // g)]).amax(2)
    return 2.0**-6 * top


def flip_noise(ref_fn, q, k, v, scale, **kw):
    """The plain version against itself with the scale moved by 1e-6 (the
    size of the fp32 differences between kernel and plain version): max
    |difference| and the elements beyond the bf16 tolerance without the
    flip allowance."""
    want = ref_fn(q, k, v, scale=scale, **kw).float()
    d = (ref_fn(q, k, v, scale=scale * (1 + 1e-6), **kw).float() - want).abs()
    return float(d.max()), int((d > BF16_ATOL + BF16_RTOL * want.abs()).sum())
# K4 with fp32 queries and output: the same dequantized fp32 softmax, sums in
# another order (the bound the JAX tests hold their kernel to)
K4_F32_ATOL, K4_F32_RTOL = 2e-5, 2e-4


def kernel_alone_ms(fn, key, iters=20):
    """Device ms per call of the kernels whose name holds ``key`` alone
    (torch.profiler events), or None where the profiler recorded nothing."""
    fn()
    per, _ = profiled(fn, iters)
    got = sum(us for name, (us, _) in per.items() if key in name)
    return got / iters / 1e3 if got else None


def _fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


# K1/K4 shapes: nlp_medium's decode attention (Hq 24, G 8, hd 60 -> 64) at
# the serving batch (B=32, lengths <= 576) and at nlp_medium's max_seq_len
# 4096 (B=8, up to 32 tiles a row).
DECODE_SHAPES = (("B=32 lengths<=576", 32, 5, (0, 1, 127, 128, 576, 640), 577),
                 ("B=8 lengths<=4096", 8, 32, (0, 129, 2047, 4096), 4097))
DECODE_G, DECODE_N, DECODE_HD, DECODE_HDP, DECODE_PS, DECODE_L = 8, 3, 60, 64, 128, 20


def _decode_inputs(gen, B, pps, fixed, hi, int8):
    """A pool of every slot written (int8 pools with their scales), ragged
    lengths (the fixed ones first), a random page table, bf16 q and current
    token, at nlp_medium's decode shapes."""
    import torch

    from vats_tpu_torch.ops.decode_attention import quantize_kv

    dev = "cuda"
    L, G, N, hd, hdp, ps = (DECODE_L, DECODE_G, DECODE_N, DECODE_HD, DECODE_HDP,
                            DECODE_PS)
    P = B * pps
    sc = None
    if int8:  # every slot holds a quantized token
        pool = torch.zeros((L, P, 2, G, ps, hdp), dtype=torch.int8, device=dev)
        sc = torch.empty((L, P, 2, G, ps), device=dev)
        for layer in range(L):  # a layer at a time: the fp32 history is large
            q8, sc[layer] = quantize_kv(torch.randn((P, 2, G, ps, hd), generator=gen,
                                                    device=dev))
            pool[layer, ..., :hd] = q8
    else:
        pool = torch.randn((L, P, 2, G, ps, hdp), generator=gen, device=dev).to(torch.bfloat16)
        pool[..., hd:] = 0  # stored pad rows are zero
    lens = torch.randint(1, hi, (B,), generator=gen, device=dev)
    lens[:len(fixed)] = torch.tensor(fixed, device=dev)
    table = torch.randperm(P, generator=gen, device=dev).to(torch.int32).reshape(B, pps)
    mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)  # noqa: E731
    return pool, sc, table, lens.to(torch.int32), mk(B, G * N, hd), mk(B, G, hd), mk(B, G, hd)


def _decode_bytes(lengths, B, cap, int8, commit):
    """Bytes a call must move: q in and out, the current K/V in (bf16), the
    settled history read once (int8 with its fp32 scales), the committed
    K/V out, the page table and lengths."""
    G, N, hd, hdp = DECODE_G, DECODE_N, DECODE_HD, DECODE_HDP
    tokens = int(lengths.clamp(max=cap).sum())
    per_tok = 2 * G * (hdp + 4) if int8 else 2 * G * hdp * 2
    return (2 * B * G * N * hd * 2 + 2 * B * G * hd * 2 + tokens * per_tok
            + (B * per_tok if commit else 0) + B * (cap // DECODE_PS) * 4 + B * 4), tokens


def check_k1(gen):
    """K1 (and K1', without the commit) against the plain version at both
    decode shapes: output within the bf16 tolerance, the committed pool
    bit-equal; device time of the call and of the kernel alone, the plain
    version's, and the bound."""
    import torch

    from vats_tpu_torch.ops.decode_attention import (
        PagedKVCache,
        paged_decode_attention,
        paged_decode_attention_commit,
        paged_decode_attention_ref,
    )

    layer, scale = 7, 1.0 / DECODE_HD**0.5
    result = None
    for label, B, pps, fixed, hi in DECODE_SHAPES:
        pool, _, table, lengths, q, k_cur, v_cur = _decode_inputs(gen, B, pps, fixed, hi,
                                                                 int8=False)
        kw = dict(scale=scale, k_cur=k_cur, v_cur=v_cur)
        pool_k, pool_p = pool.clone(), pool.clone()
        del pool
        n0 = paged_decode_attention_commit.launches
        out_k = paged_decode_attention_commit(q, pool_k, layer, table, lengths, **kw)
        out_p = paged_decode_attention_ref(q, pool_p[layer], table, lengths, **kw)
        PagedKVCache(pool_p, table, lengths).append_token(layer, k_cur, v_cur)
        torch.cuda.synchronize()
        require(paged_decode_attention_commit.launches == n0 + 1, "K1 did not launch")
        err = expect_close(f"K1 out {label}", out_k, out_p, BF16_ATOL, BF16_RTOL)
        if not torch.equal(pool_k, pool_p):
            raise AssertionError(f"K1 committed pool differs from the plain append ({label})")

        def kern():
            paged_decode_attention_commit(q, pool_k, layer, table, lengths, **kw)

        def plain():
            paged_decode_attention_ref(q, pool_p[layer], table, lengths, **kw)
            PagedKVCache(pool_p, table, lengths).append_token(layer, k_cur, v_cur)

        (ms, call_ms), (plain_ms, plain_call_ms) = timed(kern), timed(plain)
        alone = kernel_alone_ms(kern, "paged_decode")
        # K1': the same kernel without the commit (paged_decode_attention)
        n0 = paged_decode_attention.launches
        out_n = paged_decode_attention(q, pool_k, layer, table, lengths, **kw)
        torch.cuda.synchronize()
        require(paged_decode_attention.launches == n0 + 1, "K1' did not launch")
        err_n = expect_close(f"K1' out {label}", out_n, paged_decode_attention_ref(
            q, pool_k[layer], table, lengths, **kw), BF16_ATOL, BF16_RTOL)
        nocommit = lambda: paged_decode_attention(q, pool_k, layer, table, lengths, **kw)  # noqa: E731
        ms_n, call_ms_n = timed(nocommit)
        alone_n = kernel_alone_ms(nocommit, "paged_decode")
        plain_ms_n, _ = timed(lambda: paged_decode_attention_ref(
            q, pool_k[layer], table, lengths, **kw))
        cap = pps * DECODE_PS
        nbytes, tokens = _decode_bytes(lengths, B, cap, int8=False, commit=True)
        flops = 4 * DECODE_G * DECODE_N * DECODE_HD * (tokens + B)  # q.k and p.v a column
        b_ms, by = bound(nbytes, flops)
        b_ms_n, by_n = bound(_decode_bytes(lengths, B, cap, int8=False, commit=False)[0],
                             flops)
        log(f"K1' paged decode without commit {label}: max_abs_err={err_n:.3e} "
            f"kernel_ms={ms_n:.4f} (kernel alone {_fmt(alone_n)}) plain_ms={plain_ms_n:.4f} "
            f"bound_ms={b_ms_n:.5f} ({by_n}); per call with host overhead {call_ms_n:.4f}")
        log(f"K1 paged decode+commit {label} Hq={DECODE_G * DECODE_N} hd={DECODE_HD} "
            f"ps={DECODE_PS}, {tokens} tokens: max_abs_err={err:.3e} pool bit-equal; "
            f"kernel_ms={ms:.4f} (kernel alone {_fmt(alone)}; bound share "
            f"{b_ms / ms:.3f}) plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({by}); per call "
            f"with host overhead: kernel {call_ms:.4f} plain {plain_call_ms:.4f}")
        if result is None:  # the kernels line keeps the serving shape
            result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=by, library_ms=None)
            # where the time goes: every row at one length (tiles a row)
            parts = []
            for uni in (0, 1, 128, 129, 256, 576):
                lens_u = torch.full_like(lengths, uni)
                run = lambda: paged_decode_attention_commit(  # noqa: E731
                    q, pool_k, layer, table, lens_u, **kw)
                parts.append(f"{uni}: {_fmt(kernel_alone_ms(run, 'paged_decode'))}")
            log(f"K1 kernel alone {label.split()[0]} with every row at one length: "
                + ", ".join(parts) + " ms")
        result["max_abs_err"] = max(result["max_abs_err"], err, err_n)
        del pool_k, pool_p
        torch.cuda.empty_cache()
    return result


def check_k4(gen):
    """K4 (int8 pool) at both decode shapes: output against the plain
    version (bf16 queries, and fp32 queries at the fp32 tolerance), the
    committed int8 pool byte-equal and the scales equal to the plain
    append's (quantize_kv)."""
    import torch

    from vats_tpu_torch.ops.decode_attention import (
        PagedKVCache,
        paged_decode_attention_commit_int8,
        paged_decode_attention_ref,
    )

    dev = "cuda"
    layer, scale = 7, 1.0 / DECODE_HD**0.5
    result = None
    for label, B, pps, fixed, hi in DECODE_SHAPES:
        pool, sc, table, lengths, q, k_cur, v_cur = _decode_inputs(gen, B, pps, fixed, hi,
                                                                  int8=True)
        kw = dict(scale=scale, k_cur=k_cur, v_cur=v_cur)
        pool_k, pool_p, sc_k, sc_p = pool.clone(), pool.clone(), sc.clone(), sc.clone()
        del pool, sc
        n0 = paged_decode_attention_commit_int8.launches
        out_k = paged_decode_attention_commit_int8(q, pool_k, sc_k, layer, table, lengths,
                                                   **kw)
        out_p = paged_decode_attention_ref(q, pool_p[layer], table, lengths,
                                           kv_scales=sc_p[layer], **kw)
        PagedKVCache(pool_p, table, lengths, sc_p).append_token(layer, k_cur, v_cur)
        torch.cuda.synchronize()
        require(paged_decode_attention_commit_int8.launches == n0 + 1, "K4 did not launch")
        err = expect_close(f"K4 out {label}", out_k, out_p, BF16_ATOL, BF16_RTOL)
        if not torch.equal(pool_k, pool_p):
            raise AssertionError(f"K4 committed int8 pool differs from the plain append "
                                 f"({label})")
        sc_err = float(((sc_k - sc_p).abs() / sc_p.abs().clamp(min=1e-30)).max())
        require(sc_err <= 1e-6, f"K4 committed scales differ: max rel err {sc_err:.3e}")
        # fp32 queries: the output in fp32, no bf16 rounding to hide behind
        q32 = q.float() + 1e-3 * torch.randn(q.shape, generator=gen, device=dev)
        kw32 = dict(scale=scale, k_cur=k_cur.float(), v_cur=v_cur.float())
        err32 = expect_close(
            f"K4 fp32 out {label}",
            paged_decode_attention_commit_int8(q32, pool_k.clone(), sc_k.clone(), layer,
                                               table, lengths, **kw32),
            paged_decode_attention_ref(q32, pool_k[layer], table, lengths,
                                       kv_scales=sc_k[layer], **kw32),
            K4_F32_ATOL, K4_F32_RTOL)

        def kern():
            paged_decode_attention_commit_int8(q, pool_k, sc_k, layer, table, lengths, **kw)

        def plain():
            paged_decode_attention_ref(q, pool_p[layer], table, lengths,
                                       kv_scales=sc_p[layer], **kw)
            PagedKVCache(pool_p, table, lengths, sc_p).append_token(layer, k_cur, v_cur)

        (ms, call_ms), (plain_ms, plain_call_ms) = timed(kern), timed(plain)
        alone = kernel_alone_ms(kern, "paged_decode")
        nbytes, tokens = _decode_bytes(lengths, B, pps * DECODE_PS, int8=True, commit=True)
        b_ms, by = bound(nbytes, 4 * DECODE_G * DECODE_N * DECODE_HD * (tokens + B))
        log(f"K4 int8 paged decode+commit {label} Hq={DECODE_G * DECODE_N} hd={DECODE_HD} "
            f"ps={DECODE_PS}, {tokens} tokens: max_abs_err={err:.3e} (fp32 queries "
            f"{err32:.3e}), int8 pool byte-equal, scales max rel err {sc_err:.1e}; "
            f"kernel_ms={ms:.4f} (kernel alone {_fmt(alone)}; bound share "
            f"{b_ms / ms:.3f}) plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({by}); per "
            f"call with host overhead: kernel {call_ms:.4f} plain {plain_call_ms:.4f}")
        if result is None:  # the kernels line keeps the serving shape
            result = dict(max_abs_err=max(err, err32), ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=by, library_ms=None)
        result["max_abs_err"] = max(result["max_abs_err"], err, err32)
        del pool_k, pool_p, sc_k, sc_p
        torch.cuda.empty_cache()
    return result


def check_k2(gen):
    import torch

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
                        flash_attention_ref(q, k, v, **kw2), BF16_ATOL, BF16_RTOL,
                        p_flip_allowance(q, k, v, **kw2))
    noise = flip_noise(flash_attention_ref, q, k, v, **kw2)
    # the ring's steady state: T = S = 2048, up to 16 key tiles a query tile
    TL, BL = 2048, 2
    ql, kl, vl = mk(BL, TL, Hq, hd), mk(BL, TL, G, hd), mk(BL, TL, G, hd)
    err3 = expect_close("K2 T=S=2048 out", flash_attention(ql, kl, vl, **kw),
                        flash_attention_ref(ql, kl, vl, **kw), BF16_ATOL, BF16_RTOL)

    call_ms = cuda_ms(lambda: flash_attention(q, k, v, **kw))
    plain_ms, plain_call_ms = timed(lambda: flash_attention_ref(q, k, v, **kw))
    nbytes = (q.numel() * 2 + k.numel() + v.numel()) * 2
    b_ms, by = bound(nbytes, flash_flops(B, T, Hq, hd))
    ms, library_ms = flash_vs_sdpa(f"K2 B={B} T={T}", lambda: flash_attention(q, k, v, **kw),
                                   q, k, v, scale, b_ms, flash_flops(B, T, Hq, hd))
    b_l, by_l = bound(nbytes, flash_flops(BL, TL, Hq, hd))  # same element count
    flash_vs_sdpa(f"K2 B={BL} T=S={TL} (bound {b_l:.5f} ms, {by_l})",
                  lambda: flash_attention(ql, kl, vl, **kw), ql, kl, vl, scale, b_l,
                  flash_flops(BL, TL, Hq, hd))
    log(f"K2 flash forward B={B} T={T} Hq={Hq} G={G} hd={hd} causal: "
        f"max_abs_err={err:.3e} (padded/window/segments {err2:.3e}, T=S=2048 "
        f"{err3:.3e}; within {BF16_ATOL} + {BF16_RTOL}*|ref|, the padded case + the p "
        f"flip allowance; the plain version against itself with scale*(1+1e-6) there: "
        f"max {noise[0]:.3e}, {noise[1]} elements beyond {BF16_ATOL} + {BF16_RTOL}*|ref|)"
        f"; kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
        f"{library_ms:.4f} bound_ms={b_ms:.5f} ({by}); per call with host overhead: "
        f"kernel {call_ms:.4f} plain {plain_call_ms:.4f}")
    return dict(max_abs_err=max(err, err2, err3), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=by, library_ms=library_ms)


def flash_flops(b, t, hq, hd):
    """Logical FLOPs of causal attention: q.k and p.v over the attended pairs."""
    return 4 * hq * hd * b * t * (t + 1) // 2


def flash_vs_sdpa(label, kern, q, k, v, scale, b_ms, flops):
    """Device ms of ``kern`` and of SDPA on the same inputs, timed in turns
    (kernel, SDPA, SDPA, kernel; each the whole call, the wrapper's head-dim
    pad included), with the ratio, achieved TFLOP/s and share of the bound
    printed, and the forward kernel's own time beside.  Returns the two
    means."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = lambda: _sdpa(qt, kt, vt, scale)  # noqa: E731
    k1, l1, l2, k2 = device_ms(kern), device_ms(lib), device_ms(lib), device_ms(kern)
    ms, lib_ms = (k1 + k2) / 2, (l1 + l2) / 2
    per, _ = profiled(kern, iters=20)
    alone = sum(us for name, (us, _) in per.items() if "flash_fwd" in name) / 20 / 1e3
    own = (f"the forward kernel alone {alone:.4f} ms ({flops / alone / 1e9:.1f} TFLOP/s, "
           f"{b_ms / alone:.3f} of the bound)" if alone else "kernel alone not measured")
    log(f"  {label}: kernel {k1:.4f} / {k2:.4f} ms, SDPA {l1:.4f} / {l2:.4f} ms in turns: "
        f"{ms / lib_ms:.2f}x SDPA; {flops / ms / 1e9:.1f} TFLOP/s (SDPA "
        f"{flops / lib_ms / 1e9:.1f}), {b_ms / ms:.3f} of the bound; {own}")
    return ms, lib_ms


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
    # library yardstick: Tensor.scatter_ of each row's K and V at its position
    idx = torch.full((B, G, hdp, 1), 300, dtype=torch.int64, device=dev)
    kc, vc = k.clone(), v.clone()

    def scatter():
        kc[5].scatter_(-1, idx, kn[..., None])
        vc[5].scatter_(-1, idx, vn[..., None])

    scatter()
    kd, vd = k.clone(), v.clone()
    append_token_ref(kd, vd, 5, kn, vn, length)
    if not (torch.equal(kc, kd) and torch.equal(vc, vd)):
        raise AssertionError("K3: scatter_ yardstick writes another cache")
    library_ms, library_call_ms = timed(scatter)
    log(f"K3 dense append cache [{L},{B},{G},{hdp},{S}]: bit-equal at "
        f"positions 0/127/300/S-1/clamped; kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} (two scatter_) "
        f"bound_ms={b_ms:.6f} ({by}); per call with host overhead: kernel "
        f"{call_ms:.4f} plain {plain_call_ms:.4f} library {library_call_ms:.4f}")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, library_ms=library_ms)


# K3's fused decode prologue at nlp_medium's heads (Hq 24, G 8, hd 60 stored
# as 64).  Kernel and plain version (the unfused chain) run the same fp32 ops
# in the same order but for the QK-norm's sum of squares.  bf16 rounds n
# before the rotation, so a difference shows only where it flips that
# rounding: one bf16 ulp at the rotated pair's magnitude sqrt(r1^2 + r2^2)
# (the rotation spreads it over the pair).  fp32 keeps it: the norm moves by
# an ulp, n1 and n2 by up to two each, the rotation sums both: 4 fp32 ulps
# at the pair's magnitude.  Without the norm: one ulp.  v, the pad lanes and
# every cache element outside the written column are exact.
PROLOGUE_HQ, PROLOGUE_G, PROLOGUE_HD, PROLOGUE_HDP = 24, 8, 60, 64
PROLOGUE_ULPS = {("bfloat16", True): 1, ("bfloat16", False): 1,
                 ("float32", True): 4, ("float32", False): 1}


def rotated_ulps(got, want):
    """|got - want| in ulps of want's dtype at each element's rotated pair
    magnitude."""
    import torch

    bits = 7 if want.dtype == torch.bfloat16 else 23
    got, want = got.float(), want.float()
    pm = torch.sqrt(want[..., 0::2] ** 2 + want[..., 1::2] ** 2).repeat_interleave(2, -1)
    ulp = torch.exp2(torch.floor(torch.log2(pm.clamp(min=2.0 ** -126))) - bits)
    return (got - want).abs() / ulp


def _prologue_inputs(gen, b, dtype, fused=True):
    """q, k, v [b, 1, H, 60] as one fused QKV product's views, or as three
    tensors."""
    import torch

    hq, g, hd = PROLOGUE_HQ, PROLOGUE_G, PROLOGUE_HD
    row = torch.randn((b, 1, (hq + 2 * g) * hd), generator=gen, device="cuda").to(dtype)
    q, k, v = torch.split(row, [hq * hd, g * hd, g * hd], dim=-1)
    q, k, v = q.reshape(b, 1, hq, hd), k.reshape(b, 1, g, hd), v.reshape(b, 1, g, hd)
    return (q, k, v) if fused else (q.contiguous(), k.contiguous(), v.contiguous())


def _prologue_cost(b, paged, qk_norm=True):
    """(bytes, fp32 operations) of one call: the q, k, v rows read once, the
    RoPE table and positions; q (padded) and the k, v columns (dense), or q
    and k (paged), written once.  Per q/k element a square, an add and a
    division (norm); per pair the angle, cos, sin, 4 products and 2 sums."""
    hq, g, hd, hdp = PROLOGUE_HQ, PROLOGUE_G, PROLOGUE_HD, PROLOGUE_HDP
    es = 2  # bf16
    read = b * (hq + 2 * g) * hd * es + hd // 2 * 4 + (4 * b if paged else 4)
    write = b * (hq + g) * hd * es if paged else b * (hq + 2 * g) * hdp * es
    n = b * (hq + g) * hd
    return read + write, n * (3 if qk_norm else 0) + n // 2 * 9


def check_k3_prologue(gen):
    """Dense, ring and paged modes at B = 1, 16, 32, bf16 and fp32, with and
    without the QK-norm, fused and split projections; then kernel against
    plain version at the main path's B=16 (dense cache [20,16,8,64,544]),
    timed.  Returns the rows of the dense and the paged prologue."""
    import torch

    from vats_tpu_torch.nn.rope import rope_inv_freq
    from vats_tpu_torch.ops import cache_append as ca

    hq, g, hd, hdp = PROLOGUE_HQ, PROLOGUE_G, PROLOGUE_HD, PROLOGUE_HDP
    L, S = 20, 544
    inv = rope_inv_freq(hd, 10000.0, device="cuda")
    worst = {"dense": [0.0, 0.0], "paged": [0.0, 0.0]}  # max |err|, max ulps
    equal = total = 0
    n0 = (ca.dense_decode_prologue.launches, ca.paged_decode_prologue.launches)
    calls = [0, 0]
    for dtype in (torch.bfloat16, torch.float32):
        for b in (1, 16, 32):
            cache = torch.randn((2, 3, b, g, hdp, S), generator=gen, device="cuda").to(dtype)
            cache[..., hd:, :] = 0
            for mode, qk_norm, fused, pos in (
                    ("dense", True, True, 0), ("dense", False, False, S + 7),
                    ("ring", True, False, S + 7), ("ring", False, True, 127),
                    ("paged", True, True, 0), ("paged", False, False, 300)):
                q, k, v = _prologue_inputs(gen, b, dtype, fused)
                kw = dict(theta=10000.0, qk_norm=qk_norm)
                tol = PROLOGUE_ULPS[(str(dtype).split(".")[1], qk_norm)]
                if mode == "paged":
                    lens = torch.randint(0, 4096, (b,), generator=gen, device="cuda")
                    lens[0] = pos
                    lens = lens.to(torch.int32)
                    got = ca.paged_decode_prologue(q, k, v, lens, inv, **kw)
                    want = ca.paged_decode_prologue_ref(q, k, v, lens, **kw)
                    calls[1] += 1
                    pairs = list(zip(got[:2], want[:2]))
                    require(torch.equal(got[2], want[2]), "K3 paged prologue: v differs")
                else:
                    ka, va, kb, vb = (cache[i % 2].clone() for i in range(4))
                    length = torch.tensor(pos, dtype=torch.int32, device="cuda")
                    got = ca.dense_decode_prologue(q, k, v, ka, va, length, 1, inv,
                                                   ring=mode == "ring", **kw)
                    want = ca.dense_decode_prologue_ref(q, k, v, kb, vb, length, 1,
                                                        ring=mode == "ring", **kw)
                    calls[0] += 1
                    col = pos % S if mode == "ring" else min(pos, S - 1)
                    require(not got[..., hd:].any() and not ka[1, :, :, hd:, col].any(),
                            f"K3 {mode} prologue: a pad lane is not zero")
                    rest = torch.ones(S, dtype=torch.bool, device="cuda")
                    rest[col] = False
                    require(torch.equal(va, vb) and torch.equal(ka[..., rest], kb[..., rest])
                            and torch.equal(ka[0], kb[0]) and torch.equal(ka[2], kb[2]),
                            f"K3 {mode} prologue: the cache differs outside the k column")
                    pairs = [(got[..., :hd], want[..., :hd]),
                             (ka[1, ..., :hd, col], kb[1, ..., :hd, col])]
                torch.cuda.synchronize()
                key = "paged" if mode == "paged" else "dense"
                for x, y in pairs:
                    ulps = float(rotated_ulps(x, y).max())
                    require(ulps <= tol and bool(torch.isfinite(x.float()).all()),
                            f"K3 {mode} prologue {dtype} B={b}: {ulps:.2f} ulps beyond {tol}")
                    worst[key][0] = max(worst[key][0], float((x.float() - y.float()).abs().max()))
                    worst[key][1] = max(worst[key][1], ulps)
                    equal += int((x == y).sum())
                    total += x.numel()
    require((ca.dense_decode_prologue.launches - n0[0],
             ca.paged_decode_prologue.launches - n0[1]) == tuple(calls),
            "K3 prologue: a wrapper did not launch its kernel")
    log(f"K3 fused decode prologue (Hq 24, G 8, hd 60->64; B 1/16/32; bf16, fp32; dense, "
        f"ring, paged; QK-norm on and off; fused and split projections): within one ulp "
        f"of the dtype at the rotated pair's magnitude (fp32 with the norm: "
        f"{PROLOGUE_ULPS[('float32', True)]}); largest dense "
        f"{worst['dense'][1]:.2f} ulps ({worst['dense'][0]:.3e}), paged "
        f"{worst['paged'][1]:.2f} ulps ({worst['paged'][0]:.3e}); {equal / total:.6f} of "
        f"q and k bit-equal; v, pad lanes and the rest of the cache exact")

    # timed at the main path's B=16, bf16
    b = 16
    q, k, v = _prologue_inputs(gen, b, torch.bfloat16)
    kc = torch.zeros((L, b, g, hdp, S), dtype=torch.bfloat16, device="cuda")
    vc = torch.zeros_like(kc)
    length = torch.tensor(300, dtype=torch.int32, device="cuda")
    lens = torch.randint(300, 513, (b,), generator=gen, device="cuda").to(torch.int32)
    rows = {}
    for key, kern, plain in (
            ("dense", lambda: ca.dense_decode_prologue(q, k, v, kc, vc, length, 5, inv,
                                                       theta=1e4, qk_norm=True, ring=False),
             lambda: ca.dense_decode_prologue_ref(q, k, v, kc, vc, length, 5, theta=1e4,
                                                  qk_norm=True, ring=False)),
            ("paged", lambda: ca.paged_decode_prologue(q, k, v, lens, inv, theta=1e4,
                                                       qk_norm=True),
             lambda: ca.paged_decode_prologue_ref(q, k, v, lens, theta=1e4, qk_norm=True))):
        ms, call_ms = timed(kern)
        plain_ms, plain_call_ms = timed(plain)
        nbytes, ops = _prologue_cost(b, key == "paged")
        b_ms, by = bound(nbytes, ops, PEAK_FP32_FLOPS)
        log(f"K3 {key} prologue B={b} bf16: kernel_ms={ms:.5f} plain_ms={plain_ms:.4f} "
            f"(the chain) bound_ms={b_ms:.6f} ({by}: {nbytes} bytes, {ops} fp32 ops); per "
            f"call with host overhead: kernel {call_ms:.4f} plain {plain_call_ms:.4f}")
        rows[key] = dict(max_abs_err=worst[key][0], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=by, library_ms=None)
    return rows["dense"], rows["paged"]


# K2' and K5 at the training shapes: medium_dense attention, B=16, T=512.
TRAIN_B, TRAIN_T, TRAIN_HQ, TRAIN_G, TRAIN_HD = 16, 512, 24, 8, 60
# The bf16 backward kernels and their plain version both round p (before dV)
# and ds (before dK, dQ) to bf16, as the JAX kernels do, and sum bf16
# products in fp32.  Their p and ds differ at fp32 rounding (sums in another
# order, exp2 on the special-function unit), which now and then flips one
# rounding: one bf16 ulp (2^-8) of a p or ds times a |q| or |do| of at most
# ~5, on gradients of O(1).  A fault in a mask, a tile bound or a
# descriptor gives errors of O(1).
BWD_ATOL, BWD_RTOL = 4e-3, 1e-2


def _train_attention_inputs(gen, b, t, hq, g, hd):
    import torch

    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
    return mk(b, t, hq, hd), mk(b, t, g, hd), mk(b, t, g, hd), mk(b, t, hq, hd)


def _sdpa(q, k, v, scale):
    """scaled_dot_product_attention on [B, H, T, D] views, causal, GQA."""
    import torch.nn.functional as F

    try:
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale,
                                              enable_gqa=True)
    except TypeError:  # a PyTorch without enable_gqa: repeat K/V
        r = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(r, dim=1), v.repeat_interleave(r, dim=1),
            is_causal=True, scale=scale)


def check_k2_lse(gen):
    import torch

    from vats_tpu_torch.ops.flash_attention import (
        flash_attention_lse,
        flash_attention_lse_ref,
    )

    B, T, Hq, G, hd = TRAIN_B, TRAIN_T, TRAIN_HQ, TRAIN_G, TRAIN_HD
    scale = 1.0 / hd**0.5
    q, k, v, _ = _train_attention_inputs(gen, B, T, Hq, G, hd)
    kw = dict(scale=scale, causal=True)
    n0 = flash_attention_lse.launches
    o_k, lse_k = flash_attention_lse(q, k, v, **kw)
    o_p, lse_p = flash_attention_lse_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    require(flash_attention_lse.launches == n0 + 1, "K2' did not launch")
    err = expect_close("K2' out", o_k, o_p, BF16_ATOL, BF16_RTOL,
                       p_flip_allowance(q, k, v, **kw))
    err_l = expect_close("K2' lse", lse_k, lse_p, 1e-4, 1e-5)
    # small padded case: dead rows (lse 1e30, output 0), segments, a window
    qs, ks, vs, _ = _train_attention_inputs(gen, 2, 200, 6, 2, hd)
    valid = torch.rand((2, 200), generator=gen, device="cuda") > 0.2
    valid[1, :7] = False
    seg = (torch.arange(200, device="cuda") // 45).expand(2, 200).contiguous()
    kw2 = dict(scale=scale, causal=True, left_window=70, kv_valid=valid,
               q_segment_ids=seg, kv_segment_ids=seg)
    o2k, l2k = flash_attention_lse(qs, ks, vs, **kw2)
    o2p, l2p = flash_attention_lse_ref(qs, ks, vs, **kw2)
    err2 = max(expect_close("K2' padded out", o2k, o2p, BF16_ATOL, BF16_RTOL,
                            p_flip_allowance(qs, ks, vs, **kw2)),
               expect_close("K2' padded lse", l2k, l2p, 1e-4, 1e-5))
    require(bool((l2k[1, :, :7] == 1e30).all()) and bool((o2k[1, :7] == 0).all()),
            "K2': a row with no key must give lse 1e30 and output 0")

    call_ms = cuda_ms(lambda: flash_attention_lse(q, k, v, **kw))
    plain_ms, _ = timed(lambda: flash_attention_lse_ref(q, k, v, **kw))
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + B * Hq * T * 4
    b_ms, by = bound(nbytes, flash_flops(B, T, Hq, hd))
    ms, library_ms = flash_vs_sdpa(f"K2' B={B} T={T}",
                                   lambda: flash_attention_lse(q, k, v, **kw), q, k, v,
                                   scale, b_ms, flash_flops(B, T, Hq, hd))
    log(f"K2' flash forward + lse B={B} T={T} Hq={Hq} G={G} hd={hd} causal: "
        f"max_abs_err out {err:.3e} lse {err_l:.3e} (padded/window/segments "
        f"{err2:.3e}); kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} (SDPA forward) bound_ms={b_ms:.5f} ({by}); "
        f"per call with host overhead {call_ms:.4f}")
    return dict(max_abs_err=max(err, err_l, err2), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=by, library_ms=library_ms)


def check_k5(gen):
    """K5a and K5b against the plain backward at the training shapes, plus a
    small padded/segmented/windowed case; each kernel timed alone, and the
    whole backward (di, K5a, K5b and the casts, as FlashAttentionFn.backward
    runs them) in turns with SDPA's backward.  Returns one result per
    kernel."""
    import torch

    from vats_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_ref,
        flash_attention_lse_ref,
        flash_bwd_dkv,
        flash_bwd_dq,
    )

    def case(b, t, hq, g, **kw):
        q, k, v, do = _train_attention_inputs(gen, b, t, hq, g, TRAIN_HD)
        o, lse = flash_attention_lse_ref(q, k, v, kv_valid=kw.get("kv_valid"),
                                         q_segment_ids=kw.get("q_seg"),
                                         kv_segment_ids=kw.get("kv_seg"),
                                         **{x: kw[x] for x in kw if x not in
                                            ("kv_valid", "q_seg", "kv_seg")})
        di = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        return q, k, v, do, lse, di, o

    scale = 1.0 / TRAIN_HD**0.5
    B, T, Hq, G = TRAIN_B, TRAIN_T, TRAIN_HQ, TRAIN_G
    kw = dict(scale=scale, causal=True)
    q, k, v, do, lse, di, o = case(B, T, Hq, G, **kw)
    n0 = (flash_bwd_dkv.launches, flash_bwd_dq.launches)
    got = flash_attention_bwd(q, k, v, do, lse, di, **kw)
    want = flash_attention_bwd_ref(q, k, v, do, lse, di, **kw)
    torch.cuda.synchronize()
    require((flash_bwd_dkv.launches, flash_bwd_dq.launches) == (n0[0] + 1, n0[1] + 1),
            "K5a/K5b did not launch")
    errs = [expect_close(f"K5 {n}", a, b_, BWD_ATOL, BWD_RTOL)
            for n, a, b_ in zip(("dq", "dk", "dv"), got, want)]
    mean_err = max(float((a - b_).abs().mean()) for a, b_ in zip(got, want))
    # small case: dead rows, padding, segments, window, GQA ratio 3
    valid = torch.rand((2, 200), generator=gen, device="cuda") > 0.2
    valid[1, :7] = False
    seg = (torch.arange(200, device="cuda") // 45).expand(2, 200).contiguous()
    kw2 = dict(scale=scale, causal=True, left_window=70)
    masks = dict(kv_valid=valid, q_seg=seg, kv_seg=seg)
    args2 = case(2, 200, 6, 2, **kw2, **masks)[:6]
    got2 = flash_attention_bwd(*args2, valid, seg, seg, **kw2)
    want2 = flash_attention_bwd_ref(*args2, valid, seg, seg, **kw2)
    errs2 = [expect_close(f"K5 padded {n}", a, b_, BWD_ATOL, BWD_RTOL)
             for n, a, b_ in zip(("dq", "dk", "dv"), got2, want2)]
    require(bool((got2[0][1, :7] == 0).all()) and bool((got2[1][~valid] == 0).all())
            and bool((got2[2][~valid] == 0).all()),
            "K5: rows with no key must give dq = 0, invalid keys dk = dv = 0")

    # timing at the kernels' head dim (the wrapper pads 60 -> 64 once)
    pad = lambda x: torch.nn.functional.pad(x, (0, 64 - TRAIN_HD)).contiguous()  # noqa: E731
    qp, kp, vp, dop = map(pad, (q, k, v, do))
    ms_kv, call_kv = timed(lambda: flash_bwd_dkv(qp, kp, vp, dop, lse, di, **kw))
    ms_q, call_q = timed(lambda: flash_bwd_dq(qp, kp, vp, dop, lse, di, **kw))
    plain_ms, _ = timed(lambda: flash_attention_bwd_ref(q, k, v, do, lse, di, **kw))
    pairs = B * T * (T + 1) // 2
    hd = TRAIN_HD
    stats = 2 * B * Hq * T * 4  # lse and di
    in_bytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + stats
    b_kv, by_kv = bound(in_bytes + 2 * k.numel() * 4, 8 * Hq * hd * pairs)
    b_q, by_q = bound(in_bytes + q.numel() * 4, 6 * Hq * hd * pairs)
    library_ms, parts = backward_vs_sdpa(f"backward B={B} T={T}", q, k, v, o, do, lse, kw)
    own = []
    for key, fl, b_own in (("flash_bwd_dkv", 8, b_kv), ("flash_bwd_dq", 6, b_q)):
        ms_own = sum(ms for name, ms in parts.items() if key in name)
        own.append(f"{key} alone {ms_own:.4f} ms ({fl * Hq * hd * pairs / ms_own / 1e9:.1f} "
                   f"TFLOP/s, {b_own / ms_own:.3f} of its bound)" if ms_own else
                   f"{key} alone not measured")
    # the ring's steady state: T = S = 2048, B = 2
    ql, kl, vl, dol, lsel, _, ol = case(2, 2048, Hq, G, **kw)
    backward_vs_sdpa("backward B=2 T=S=2048", ql, kl, vl, ol, dol, lsel, kw)
    err_a = max(errs[1], errs[2], errs2[1], errs2[2])
    err_b = max(errs[0], errs2[0])
    log(f"K5 flash backward B={B} T={T} Hq={Hq} G={G} hd={hd} causal: max_abs_err "
        f"dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}, mean {mean_err:.2e} "
        f"(padded/window/segments {max(errs2):.3e}, dead rows and invalid keys exactly "
        f"0); K5a dK/dV kernel_ms={ms_kv:.4f} bound_ms={b_kv:.5f} ({by_kv}); K5b dQ "
        f"kernel_ms={ms_q:.4f} bound_ms={b_q:.5f} ({by_q}); {'; '.join(own)}; plain "
        f"backward (dq, dk, dv together) {plain_ms:.4f}; SDPA backward (dq, dk, dv "
        f"together) {library_ms:.4f}; per call with host overhead: K5a {call_kv:.4f} "
        f"K5b {call_q:.4f}")
    return (dict(max_abs_err=err_a, ms=ms_kv, plain_ms=plain_ms, bound_ms=b_kv,
                 bound_by=by_kv, library_ms=library_ms),
            dict(max_abs_err=err_b, ms=ms_q, plain_ms=plain_ms, bound_ms=b_q,
                 bound_by=by_q, library_ms=library_ms))


def backward_vs_sdpa(label, q, k, v, o, do, lse, kw):
    """Device ms of the whole flash backward (``FlashAttentionFn.backward``
    on the saved tensors, the head dim padded as the autograd Function holds
    them: di, K5a, K5b, the casts) and of SDPA's backward on the same inputs,
    timed in turns (flash, SDPA, SDPA, flash), with the ratio, TFLOP/s (the
    backward's five products, 10 x Hq x hd per attended pair) and share of
    the bound printed, and each kernel's device time in one call.  Returns
    (SDPA's mean, {kernel name: device ms per call} of the flash backward;
    {} where the profiler recorded nothing)."""
    from types import SimpleNamespace

    import torch

    from vats_tpu_torch.ops.flash_attention import FlashAttentionFn

    b, t, hq, hd = q.shape
    pad = lambda x: torch.nn.functional.pad(x, (0, 64 - hd)).contiguous()  # noqa: E731
    qp, kp, vp, op, dop = map(pad, (q, k, v, o, do))
    ctx = SimpleNamespace(saved_tensors=(qp, kp, vp, op, lse, None, None, None), kw=kw)
    flash = lambda: FlashAttentionFn.backward(ctx, dop)  # noqa: E731
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = _sdpa(qt, kt, vt, kw["scale"])
    dot = do.transpose(1, 2)
    lib = lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)  # noqa: E731
    k1, l1, l2, k2 = device_ms(flash), device_ms(lib), device_ms(lib), device_ms(flash)
    ms, lib_ms = (k1 + k2) / 2, (l1 + l2) / 2
    flops = 10 * hq * hd * b * t * (t + 1) // 2
    # q, o, do in and dq out; k, v in and dk, dv out (bf16, padded); lse in
    nbytes = 4 * (qp.numel() + kp.numel()) * 2 + lse.numel() * 4
    b_ms, by = bound(nbytes, flops)
    log(f"  {label}: flash {k1:.4f} / {k2:.4f} ms, SDPA {l1:.4f} / {l2:.4f} ms in turns: "
        f"{ms / lib_ms:.2f}x SDPA; {flops / ms / 1e9:.1f} TFLOP/s (SDPA "
        f"{flops / lib_ms / 1e9:.1f}); bound {b_ms:.5f} ms ({by}), {b_ms / ms:.3f} of it")
    per, _ = profiled(flash, iters=20)
    parts = {name: us / 20 / 1e3 for name, (us, _) in per.items()}
    log("    per call: " + ", ".join(f"{ms_:.4f} ms {name[:60]}" for name, ms_ in
                                     sorted(parts.items(), key=lambda kv: -kv[1])))
    return lib_ms, parts


# --- phase: train -----------------------------------------------------------


def train_cfg(tier, **kw):
    """The JAX bench's training tiers (tools/bench_train.py)."""
    from vats_tpu_torch.configs import nlp_medium

    base = dict(dropout=0.1, left_window=-1, use_mqa=False, gradient_checkpointing=True,
                capacity_factor=1.25, max_seq_len=TRAIN_T, remat_policy="dots")
    if tier == "medium_dense":
        base.update(num_experts=1, top_k=1)
    else:  # medium_moe
        base.update(d_model=768, num_heads=12, query_groups=4, d_ffn=3072,
                    num_layers=12, num_experts=8, top_k=2)
    base.update(kw)
    return nlp_medium(**base)


def train_args(**kw):
    from vats_tpu_torch.configs import TrainingArgs

    base = dict(grad_accum_steps=1, fused_ce_chunk=128, adam_mu_dtype="bfloat16")
    base.update(kw)
    return TrainingArgs(**base)


def run_train(counters):
    import torch

    from vats_tpu_torch.data import synthetic_lm_batches
    from vats_tpu_torch.models import TextLM
    from vats_tpu_torch.train import create_optimizer, create_train_state, make_train_step

    B, T, timed_steps = TRAIN_B, TRAIN_T, 5
    cfg = train_cfg("medium_dense")
    targs = train_args()
    t0 = time.perf_counter()
    model = TextLM(cfg, device="cuda", seed=0)
    state = create_train_state(model, create_optimizer(targs, 1000))
    step = make_train_step(model, targs)
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(1)
    batches = list(synthetic_lm_batches(gen, vocab_size=cfg.vocab_size, batch_size=B,
                                        seq_len=T, num_batches=timed_steps + 2))
    torch.cuda.synchronize()
    log(f"train: medium_dense d{cfg.d_model}/{cfg.num_layers}L vocab {cfg.vocab_size} "
        f"{n_params / 1e9:.3f}B params, B={B} T={T}, remat {cfg.remat_policy}, fused "
        f"CE {targs.fused_ce_chunk}, mu {targs.adam_mu_dtype}; built in "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    state, m = step(state, batches[0], 100)  # warm-up
    torch.cuda.synchronize()
    log(f"train: warm-up step {time.perf_counter() - t0:.2f}s loss "
        f"{float(m['loss']):.4f}")

    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    metrics = []
    t0 = time.perf_counter()
    for i in range(timed_steps):
        state, m = step(state, batches[1 + i], 101 + i)
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {c.__name__: c.launches for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    L = cfg.num_layers
    want = {"flash_attention_lse": 2 * L * timed_steps, "flash_bwd_dkv": L * timed_steps,
            "flash_bwd_dq": L * timed_steps, "flash_attention": 0}
    for name, n in want.items():
        if counts.get(name) != n:
            raise AssertionError(f"train: {name} launched {counts.get(name)} times, "
                                 f"expected {n}")
    import math
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"train: non-finite loss or grad norm {losses} {norms}")
    require(int(state.step) == timed_steps + 1 and int(state.skipped_steps) == 0,
            "train: step or skip counters wrong")
    ms_step = wall / timed_steps * 1e3
    log(f"train: launches over {timed_steps} steps {json.dumps(counts)} = per step "
        f"K2' {counts['flash_attention_lse'] // timed_steps} (20 forward + 20 "
        f"recomputed under remat), K5a {counts['flash_bwd_dkv'] // timed_steps}, "
        f"K5b {counts['flash_bwd_dq'] // timed_steps}")
    log(f"train: losses {[round(x, 4) for x in losses]} grad norms "
        f"{[round(x, 4) for x in norms]}")
    log(f"train: ms_per_step={ms_step:.1f} tokens_per_s={B * T / (ms_step / 1e3):.1f} "
        f"peak_mem_gb={peak_gb:.2f}")
    profile_breakdown("train step", lambda: step(state, batches[-1], 200), top=12,
                      also=("flash_fwd", "flash_bwd"))
    del model, state, step, batches
    torch.cuda.empty_cache()

    cfg = train_cfg("medium_moe")
    model = TextLM(cfg, device="cuda", seed=0)
    state = create_train_state(model, create_optimizer(targs, 1000))
    step = make_train_step(model, targs)
    n_params = sum(p.numel() for p in model.parameters())
    report = []
    t0 = time.perf_counter()
    for i, batch in enumerate(synthetic_lm_batches(gen, vocab_size=cfg.vocab_size,
                                                   batch_size=B, seq_len=T,
                                                   num_batches=3)):
        state, m = step(state, batch, 300 + i)
        report.append((float(m["loss"]), float(m["aux_loss"])))
    torch.cuda.synchronize()
    if not all(math.isfinite(a) and math.isfinite(b) and b > 0 for a, b in report):
        raise AssertionError(f"train: medium_moe loss/aux not finite: {report}")
    log(f"train: medium_moe d{cfg.d_model}/{cfg.num_layers}L E{cfg.num_experts} "
        f"top-{cfg.top_k} ({n_params / 1e9:.3f}B params) B={B} T={T}, 3 steps in "
        f"{time.perf_counter() - t0:.2f}s: (loss, aux) "
        f"{[(round(a, 4), round(b, 4)) for a, b in report]}")
    del model, state, step
    torch.cuda.empty_cache()
    return counts


# --- phase: train_parity ----------------------------------------------------

# bf16 compute on both sides; the card and the CPU round their matmul sums at
# other places.  The loss is a mean over 1022 tokens of ~ln(65536) = 11.1:
# 0.02 is 0.2%.  The global norm sums those rounding differences over every
# gradient: 5% relative.  Adam normalises each step to at most ~lr per
# element whatever the gradient's size, so two runs whose small gradients
# differ in sign can part by at most 2 lr per applied step: params are held
# to 2 x (sum of the lr applied so far) + 1e-6.
PARITY_LOSS_ATOL, PARITY_NORM_RTOL = 0.02, 0.05


def run_train_parity():
    import torch

    from vats_tpu_torch.models import TextLM
    from vats_tpu_torch.train import create_optimizer, create_train_state, make_train_step

    B, T = 2, TRAIN_T
    cfg = train_cfg("medium_dense", num_layers=2, dropout=0.0)
    targs = train_args()
    gpu = TextLM(cfg, device="cuda", seed=5)
    cpu = TextLM(cfg, device="meta")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, assign=True)
    # warmup int(0.05 * 20) = 1: step 0 runs at lr 0, steps 1-2 at ~6e-4
    opt = lambda: create_optimizer(targs, 20)  # noqa: E731
    sched = opt().schedule
    runs = {}
    for name, model in (("cuda", gpu), ("cpu", cpu)):
        runs[name] = (model, create_train_state(model, opt()), make_train_step(model, targs))
    g = torch.Generator().manual_seed(11)
    ids = torch.randint(1, cfg.vocab_size, (B, T), generator=g, dtype=torch.int32)
    lens = torch.tensor([T, T - 40])
    mask = torch.arange(T)[None, :] < lens[:, None]
    ids = torch.where(mask, ids, 0)
    labels = torch.cat([ids[:, 1:], torch.full((B, 1), -100, dtype=torch.int32)], 1)
    labels = torch.where(torch.arange(T)[None, :] < (lens - 1)[:, None], labels, -100)
    batch = {"input_ids": ids, "labels": labels, "padding_mask": mask}
    lr_sum = 0.0
    report = []
    for i in range(3):
        out = {}
        for name, (model, state, step) in runs.items():
            dev_batch = {k: v.to(model.device) for k, v in batch.items()}
            state, m = step(state, dev_batch, 0)
            out[name] = (float(m["loss"]), float(m["grad_norm"]))
        lr_sum += float(sched(i))
        diffs = [(a.detach().cpu().float() - b.detach().float()).abs()
                 for a, b in zip(gpu.parameters(), cpu.parameters())]
        dp = max(float(d.max()) for d in diffs)
        mean_dp = sum(float(d.sum()) for d in diffs) / sum(d.numel() for d in diffs)
        (lg, ng), (lc, nc) = out["cuda"], out["cpu"]
        tol_p = 2 * lr_sum + 1e-6
        report.append(f"step {i}: loss card {lg:.5f} cpu {lc:.5f}; grad norm card "
                      f"{ng:.5f} cpu {nc:.5f}; max |param diff| {dp:.3e} (limit "
                      f"{tol_p:.3e}), mean {mean_dp:.3e}")
        if not (abs(lg - lc) <= PARITY_LOSS_ATOL and abs(ng - nc) <= PARITY_NORM_RTOL * nc
                and dp <= tol_p):
            raise AssertionError("train_parity: " + report[-1])
    log("train_parity (2 layers, full width, B=2, T=512, card vs CPU): "
        + "; ".join(report))
    del gpu, cpu, runs
    torch.cuda.empty_cache()


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


class ReplayCount:
    """Counts every ``StepGraph.replay`` while it is installed."""

    def __init__(self):
        from vats_tpu_torch.inference.graphs import StepGraph

        self.n, self._cls, self._real = 0, StepGraph, StepGraph.replay

        def replay(graph):
            self.n += 1
            self._real(graph)

        StepGraph.replay = replay

    def remove(self):
        self._cls.replay = self._real


def in_turns(label, runs, order=(0, 1, 1, 0)):
    """Run ``runs`` ([(name, fn)]; fn returns a dict of numbers and a result)
    in the order given, each time after a synchronize, with the peak memory
    reset; returns {name: [(numbers, result), ...]} and logs each run."""
    import torch

    got = {name: [] for name, _ in runs}
    for i in order:
        name, fn = runs[i]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        nums, res = fn()
        torch.cuda.synchronize()
        nums["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        nums["reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
        got[name].append((nums, res))
        log(f"{label} [{name}]: " + " ".join(
            f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}" for k, v in nums.items()))
    return got


def run_main(counters):
    import torch

    from vats_tpu_torch.configs import GenerationArgs
    from vats_tpu_torch.inference import TokenGenerator, generate_paged
    from vats_tpu_torch.inference.generate import _generate, _generate_paged
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

    # the counted drive: the entry points a user calls, every decode step
    # after the first replayed from a CUDA graph
    replays = ReplayCount()
    for c in counters:
        c.launches = 0
    tok_a, len_a = generate_paged(model, ids, mask, gen, **kw)
    tok_b, len_b = generate_paged(model, ids, mask, gen, prefill_row_chunk=rc, **kw)
    tg = TokenGenerator(cfg, params=model.state_dict(), use_paged=False)
    text = tg.generate_tokens(prompt, ga, StubTokenizer())
    torch.cuda.synchronize()
    counts = {c.__name__: c.launches for c in counters}
    replays.remove()

    L = cfg.num_layers
    # every decode forward: one fused prologue a layer (K3's paged mode before
    # K1, its dense mode on the dense cache), and no append-only K3
    want = {
        "flash_attention": L * (1 + B // rc),
        "paged_decode_attention_commit": L * steps * 2,
        "paged_decode_prologue": L * steps * 2,
        "dense_decode_prologue": L * steps,
        "append_token_inplace": 0,
    }
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{name} launched {counts[name]} times, expected {n}")
    require(replays.n == 3 * (steps - 1), f"main: {replays.n} graph replays, not "
            f"{3 * (steps - 1)} (three calls, each step after the first)")
    want_len = mask.sum(1).to(torch.int32) + steps
    for tok, ln in ((tok_a, len_a), (tok_b, len_b)):
        if tok.shape != (B, T + steps) or not torch.equal(ln, want_len):
            raise AssertionError("generate_paged returned wrong shapes or lengths")
        if int(tok.min()) < 0 or int(tok.max()) >= cfg.vocab_size:
            raise AssertionError("generate_paged emitted out-of-vocab ids")
    n_new = len(text.split())
    if n_new != steps:
        raise AssertionError(f"TokenGenerator returned {n_new} tokens, not {steps}")
    log(f"main: launches {json.dumps(counts)} (expected {json.dumps(want)}); "
        f"{replays.n} graph replays")

    # prefill alone, then the whole call: graph and eager in turns, each
    # drawing from the same generator state (their tokens must be equal)
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
    sample = dict(temperature=0.8, top_k=50, top_p=None, do_sample=True,
                  repetition_penalty=None, approx_top_k=False)
    paged_kw = dict(max_new_tokens=steps, pad_token_id=0, eos_token_id=None,
                    total_len=None, page_size=128, kv_quant=None, prefill_row_chunk=None)

    def paged(use_graph):
        def call():
            g = torch.Generator(device="cuda").manual_seed(77)
            return _generate_paged(model, ids, mask, g, sample, use_graph=use_graph,
                                   **paged_kw)

        def run():
            t0 = time.perf_counter()
            tokens, lengths, graph = call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            return dict(wall_s=wall, decode_tokens_per_s=B * steps / (wall - prefill_s),
                        capture_s=graph.capture_s if graph else 0.0), (tokens, lengths)
        return call, run

    calls = {"graph": paged(True), "eager": paged(False)}
    got = in_turns(f"main: generate_paged B={B} prompts {int(mask.sum(1).min())}..{T}, "
                   f"{steps} sampled steps, prefill_s={prefill_s:.3f}",
                   [(k, v[1]) for k, v in calls.items()])
    results = [r for runs in got.values() for _, r in runs]
    require(all(torch.equal(r[0], results[0][0]) and torch.equal(r[1], results[0][1])
                for r in results), "main: generate_paged tokens differ between graph "
            "and eager")
    for name, (call, _) in calls.items():
        profile_breakdown(f"generate_paged [{name}]", call,
                          also=("flash_fwd", "prologue_kernel"))

    # the dense TokenGenerator's call (B=1, a 40-token prompt in a 64 bucket)
    ids1 = torch.zeros((1, 64), dtype=torch.int32, device="cuda")
    ids1[0, :40] = torch.tensor(StubTokenizer().encode(prompt), dtype=torch.int32)
    mask1 = torch.arange(64, device="cuda")[None, :] < 40
    greedy = dict(temperature=0.0, top_k=None, top_p=None, do_sample=False,
                  repetition_penalty=None, approx_top_k=False)
    dense_kw = dict(max_new_tokens=steps, pad_token_id=0, eos_token_id=None,
                    total_len=64 + steps)

    def dense(use_graph):
        def call():
            return _generate(tg.model, ids1, mask1, None, greedy, use_graph=use_graph,
                             **dense_kw)

        def run():
            t0 = time.perf_counter()
            tokens, lengths, graph = call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            return dict(wall_s=wall, tokens_per_s=steps / wall,
                        capture_s=graph.capture_s if graph else 0.0), (tokens, lengths)
        return call, run

    calls = {"graph": dense(True), "eager": dense(False)}
    got = in_turns(f"main: dense generate B=1 (the TokenGenerator's call), {steps} "
                   f"greedy steps", [(k, v[1]) for k, v in calls.items()])
    results = [r for runs in got.values() for _, r in runs]
    require(all(torch.equal(r[0], results[0][0]) for r in results),
            "main: dense tokens differ between graph and eager")
    for name, (call, _) in calls.items():
        profile_breakdown(f"dense generate B=1 [{name}]", call, also=("prologue_kernel",))
    decode_census(model, "main: dense generate", 1, paged=False)
    decode_census(model, "main: generate_paged", B, paged=True)
    prologue_in_graph(model, L, gen, steps)
    del model, tg
    torch.cuda.empty_cache()
    return counts


def prologue_in_graph(model, L, gen, steps):
    """K3's dense prologue: device time per launch inside replayed dense
    ``generate`` graphs (B=1 over 64-token prompts, B=16 and 32 over 512),
    beside an empty kernel launched with its grid and the chain it replaced
    (:func:`chain_in_graph`), each L launches a replay."""
    import ctypes

    import torch

    from vats_tpu_torch.inference.generate import _generate
    from vats_tpu_torch.ops import kernels

    cfg = model.cfg
    hq, g = cfg.num_heads, cfg.query_groups
    lib = kernels.load("cache_append")
    empty = lib.vats_decode_prologue_empty
    empty.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    empty.restype = ctypes.c_int
    greedy = dict(temperature=0.0, top_k=None, top_p=None, do_sample=False,
                  repetition_penalty=None, approx_top_k=False)
    for B, T in ((1, 64), (16, 512), (32, 512)):
        ids, mask = ragged_prompts(gen, B, T, T // 2, cfg.vocab_size, "cuda")
        per, _ = profiled(lambda: _generate(model, ids, mask, None, greedy, use_graph=True,
                                            max_new_tokens=steps, pad_token_id=0,
                                            eos_token_id=None, total_len=T + steps))
        fused = [v for name, v in per.items() if "prologue_kernel" in name]
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(L):
                kernels.check(lib, empty(1, B, hq, g, kernels.stream_ptr(ids)), "empty")
        graph.replay()
        per_e, _ = profiled(lambda: [graph.replay() for _ in range(steps)])
        em = [v for name, v in per_e.items() if "empty_kernel" in name]
        chain = chain_in_graph(B, L, steps)
        if not fused or not em:
            log(f"K3 prologue in a replayed graph, B={B}: not measured (the profiler "
                f"recorded no prologue or empty kernel)")
            continue
        (k_us, k_n), (em_us, em_n) = fused[0], em[0]
        log(f"K3 dense prologue in a replayed dense generate graph, B={B} (cache [{L},{B},"
            f"{g},64,{T + steps}], {k_n} launches): {k_us / k_n / 1e3:.5f} ms a launch; an "
            f"empty kernel of its grid ({-(-(hq + 2 * g) // 4)}x{B} blocks of 128) in a "
            f"replayed graph ({em_n} launches): {em_us / em_n / 1e3:.5f} ms; {chain}")


def chain_in_graph(b, L=20, steps=8):
    """The chain K3's prologue replaced, per layer, at nlp_medium's heads
    (bf16), L copies captured in one CUDA graph and replayed: dense (QK-norm
    and RoPE of q and k, the pads, ``KVCache.update_layer`` at T == 1, whose
    append is K3's append-only mode) and paged (the positions, QK-norm and
    RoPE).  Only functions every slice of the port has, so a checkout of an
    earlier commit measures its own chain (:func:`run_census`).  Returns a
    line: device ms and kernels a layer, each."""
    import torch
    import torch.nn.functional as F

    from vats_tpu_torch.nn.kv_cache import KVCache
    from vats_tpu_torch.nn.norms import l2_normalize
    from vats_tpu_torch.nn.rope import apply_rope_1d
    from vats_tpu_torch.ops import kernels

    hq, g, hd, hdp = PROLOGUE_HQ, PROLOGUE_G, PROLOGUE_HD, PROLOGUE_HDP
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = _prologue_inputs(gen, b, torch.bfloat16)
    cache = KVCache.create(L, b, 544, g, hd, dtype=torch.bfloat16, device="cuda")
    cache.length.fill_(300)
    positions = cache.length + torch.arange(1, device="cuda")  # kept for the mask
    lengths = torch.randint(300, 513, (b,), generator=gen, device="cuda").to(torch.int32)

    def dense():
        for layer in range(L):
            qr = apply_rope_1d(l2_normalize(q), positions, 1e4)
            kr = apply_rope_1d(l2_normalize(k), positions, 1e4)
            cache.update_layer(layer, kr, v)
            F.pad(qr, (0, hdp - hd))

    def paged():
        for _ in range(L):
            pos = lengths[:, None] + torch.arange(1, device="cuda")[None, :]
            apply_rope_1d(l2_normalize(q), pos, 1e4)
            apply_rope_1d(l2_normalize(k), pos, 1e4)

    out = []
    for name, body in (("dense", dense), ("paged", paged)):
        body()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with kernels.launch_tally():
            with torch.cuda.graph(graph):
                body()
        graph.replay()
        per, _ = profiled(lambda: [graph.replay() for _ in range(steps)])
        if not per:
            out.append(f"{name} chain not measured")
            continue
        us = sum(u for u, _ in per.values()) / (steps * L)
        n = sum(c for _, c in per.values()) / (steps * L)
        out.append(f"the {name} chain it replaced, in a replayed graph: {us / 1e3:.5f} ms "
                   f"in {n:.1f} kernels a layer")
    return "; ".join(out)


def decode_census(model, label, b, paged, kv_quant=None, n=4, top=12):
    """Kernels per decode forward, by name: ``n`` eager T == 1 forwards of
    ``model`` over a fresh dense or paged cache at batch ``b``, under
    torch.profiler.  Prints the count and device time a forward and the
    kernels launched most often; returns the count."""
    import torch

    from vats_tpu_torch.ops.decode_attention import PagedKVCache

    cfg = model.cfg
    if paged:
        cache = PagedKVCache.create(cfg.num_layers, b, 256, cfg.query_groups, cfg.head_dim,
                                    page_size=128, device="cuda",
                                    dtype=torch.int8 if kv_quant else torch.bfloat16)
        kw = dict(paged_cache=cache)
    else:
        kw = dict(cache=model.init_cache(b, 256))
    ids = torch.ones((b, 1), dtype=torch.int32, device="cuda")

    def forwards():
        with torch.no_grad():
            for _ in range(n):
                model(ids, **kw)

    forwards()
    torch.cuda.synchronize()
    per, _ = profiled(forwards)
    if not per:
        log(f"census {label}: not measured (the profiler recorded no device time)")
        return None
    count = sum(c for _, c in per.values()) / n
    busy = sum(us for us, _ in per.values()) / n / 1e3
    log(f"census {label} B={b}: {count:.1f} kernels per decode forward "
        f"({count / cfg.num_layers:.2f} a layer), {busy:.3f} device ms a forward; most "
        f"launched:")
    for name, (us, c) in sorted(per.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"  {c / n:8.1f}x {us / c:9.2f} us  {name[:100]}")
    return count


def run_census():
    """Kernels per decode forward on every decode path (dense B=1,
    ``generate_paged``'s B=16, the engine's B=32 with bf16 KV, int8 KV and
    int8 weights + int8 KV) and the replaced chain's device time at B=1, 16
    and 32, at full nlp_medium width.  Needs nothing a slice added after
    PR 7, so it measures an earlier checkout too:

        cd <checkout>; python3 -c "import importlib.util as u, sys; \
            sys.path.insert(0, '.'); s = u.spec_from_file_location('smoke', \
            '<this file>'); m = u.module_from_spec(s); s.loader.exec_module(m); \
            m.run_census()"
    """
    import torch

    from vats_tpu_torch.inference import QuantizedModel
    from vats_tpu_torch.models import TextLM

    log(card_line())
    model = TextLM(medium_cfg(), device="cuda", seed=0).eval()
    decode_census(model, "dense generate", 1, paged=False)
    decode_census(model, "generate_paged", 16, paged=True)
    decode_census(model, "serve bf16 KV", SERVE_ROWS, paged=True)
    decode_census(model, "serve int8 KV", SERVE_ROWS, paged=True, kv_quant="int8")
    for b in (1, 16, 32):
        log(f"B={b}: {chain_in_graph(b)}")
    decode_census(QuantizedModel(model), "serve int8 weights + int8 KV", SERVE_ROWS,
                  paged=True, kv_quant="int8")
    del model
    torch.cuda.empty_cache()


def profile_breakdown(label, fn, top=10, also=()):
    """Device busy time, idle share and the heaviest kernels of one call, and
    any other kernel whose name holds one of ``also``; returns the busy
    seconds (None where the profiler recorded nothing)."""
    per, wall = profiled(fn)
    if not per:
        log(f"profiled {label}: wall_s={wall:.3f}; idle share not measured "
            f"(torch.profiler recorded no device time in 3 tries)")
        return None
    busy = sum(us for us, _ in per.values()) / 1e6
    log(f"profiled {label}: wall_s={wall:.3f} (profiler on) "
        f"device_busy_s={busy:.3f} idle_share={1 - busy / wall:.3f}")
    ranked = sorted(per.items(), key=lambda kv: -kv[1][0])
    for i, (name, (us, n)) in enumerate(ranked):
        if i < top or any(a in name for a in also):
            log(f"  {us / 1e3:10.3f} ms {n:7d}x  {name[:100]}")
    return busy


# --- phase: parity ----------------------------------------------------------

# bf16 on both sides; the CPU and the card round matmul sums at other places,
# and two layers at d_model 1440 carry that to the logits.  Logits are
# O(1) here (tied readout of std-0.02 embeddings over a unit-RMS state).
LOGIT_ATOL = 0.08
# An MoE router picks its top-2 experts from fp32 probabilities that the
# card and the CPU compute slightly apart (bf16 upstream).  Where the k-th
# and the next expert are closer than that, the two sides pick different
# experts for the token, and its FFN output, so its logits, move by far more
# than LOGIT_ATOL.  Such a flip is excused only as a near tie on both sides:
# every flipped expert's probability within twice the token's own card-CPU
# probability gap of the k-th (a rounding flip always is).  It excuses the
# logit bound at its row's step and, when it was below the last layer (whose
# K/V carry it), at that row's later steps; at most ROUTER_EXCUSED (row,
# step) pairs may be excused, and the greedy tokens are held at every step.
ROUTER_EXCUSED = 1


def router_log(model):
    """Forward hooks on the model's routers: returns (calls, handles); every
    router call appends (experts [tokens, k], probabilities [tokens, E]) on
    the CPU to ``calls``.  The hook recomputes the router's probabilities
    with the router's own expression and checks that they give its experts
    and weights bit for bit."""
    import torch
    import torch.nn.functional as F

    from vats_tpu_torch.nn.moe import TopKRouter

    calls = []

    def hook(mod, args, out):
        probs = torch.softmax(F.linear(args[0].float(), mod.router.weight.float(),
                                       mod.router.bias.float()), dim=-1)
        vals, idx = torch.topk(probs, mod.top_k, dim=-1)
        weights = (vals / vals.sum(dim=-1, keepdim=True)).to(mod.dtype)
        if not (torch.equal(idx, out[1]) and torch.equal(weights, out[0])):
            raise AssertionError("router hook: probabilities other than the router's")
        calls.append((out[1].cpu(), probs.cpu()))

    return calls, [m.register_forward_hook(hook) for m in model.modules()
                   if isinstance(m, TopKRouter)]


def router_flips(name, calls_g, calls_c, layers, t, last, steps):
    """The (row, step) pairs a router flip excuses, a report of every flip,
    and the largest card-CPU probability gap at each layer's router.
    Router call j is layer j % layers of forward j // layers (0: the prefill
    of t tokens a row, read out at ``last``; then one decode step a
    forward).  Raises on a flip that is not a near tie on both sides, and on
    more than ROUTER_EXCUSED excused pairs."""
    excused, seen, gap_max = set(), [], [0.0] * layers
    for j, ((eg, pg), (ec, pc)) in enumerate(zip(calls_g, calls_c)):
        step, layer = divmod(j, layers)
        k = eg.shape[1]
        gaps = (pg - pc).abs().amax(dim=-1)  # [tokens]
        gap_max[layer] = max(gap_max[layer], float(gaps.max()))
        for tok in range(eg.shape[0]):
            diff = set(eg[tok].tolist()) ^ set(ec[tok].tolist())
            if not diff:
                continue
            gap = float(gaps[tok])
            for probs in (pg[tok], pc[tok]):
                kth = float(probs.topk(k).values[-1])
                if any(abs(float(probs[e]) - kth) > 2 * gap for e in diff):
                    raise AssertionError(f"{name}: router call {j} token {tok} picks other "
                                         f"experts on the card and the CPU, not a near tie")
            row, pos = divmod(tok, t) if step == 0 else (tok, None)
            seen.append(f"forward {step} layer {layer} row {row}"
                        + (f" position {pos}" if pos is not None else "")
                        + f" (gap {gap:.1e})")
            if step == 0 and pos != int(last[row]):
                continue  # a prefill position the readout does not read
            excused.update((row, s) for s in range(step, steps if layer < layers - 1
                                                    else step + 1))
    if len(excused) > ROUTER_EXCUSED:
        raise AssertionError(f"{name}: router flips excuse (row, step) {sorted(excused)}, "
                             f"more than {ROUTER_EXCUSED}")
    return excused, seen, gap_max


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
        runs = {}
        for side, model, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
            calls, handles = router_log(model)
            logits = logits_fn(model, ids.to(dev), mask.to(dev), gen_c.to(dev), steps)
            for h in handles:
                h.remove()
            runs[side] = (logits, calls)
        (logit_c, calls_c), (logit_g, calls_g) = runs["cpu"], runs["cuda"]
        excused, flips, gap_max = router_flips(name, calls_g, calls_c, cfg.num_layers, T,
                                               mask.sum(1) - 1, steps)
        errs = (logit_c - logit_g).abs().amax(dim=-1)  # [B, steps]
        held = torch.ones_like(errs, dtype=torch.bool)
        for r, s_ in excused:
            held[r, s_] = False
        err = float(errs[held].max())
        if not err <= LOGIT_ATOL or not bool(torch.isfinite(logit_g).all()):
            raise AssertionError(f"{name}: step logits differ by {err:.3e} > {LOGIT_ATOL}")
        exact, ties, free = _compare_greedy(name, gen_g, gen_c, logit_c, logit_g)
        report.append(
            f"{name}: max |logit err| {err:.3e} over {steps} steps "
            f"(|logits| <= {float(logit_c.abs().max()):.2f}); router card-CPU "
            f"probability gap at most {', '.join(f'{x:.2e}' for x in gap_max)} by layer; "
            f"near-tie expert flips "
            f"{len(flips)} ({', '.join(flips) or 'none'}), excusing (row, step) "
            f"{sorted(excused)} (max |logit err| there "
            f"{float(errs[~held].max()) if excused else 0.0:.3e}); teacher-forced greedy "
            f"tokens {exact}/{2 * steps} equal, {ties} near ties; free-running "
            f"tokens equal for the first {free}/{2 * steps}")
    log("parity (2 layers, full width, card vs CPU): " + "; ".join(report))


# --- phase: serve -----------------------------------------------------------

SERVE_ROWS, SERVE_CONTEXT, SERVE_PAGES, SERVE_BLOCK = 32, 1024, 129, 4


def serve_stream(seed, vocab, n_shared, n_alone, prefix_len, shared_own, alone_own,
                 new_tokens):
    """[(prompt ids, max_new_tokens)], shared-prefix and unshared requests
    interleaved, every length and token drawn from ``seed`` (numpy, so the
    stream is the same on any device)."""
    rs = np.random.RandomState(seed)
    prefix = rs.randint(1, vocab, prefix_len).tolist()
    kinds = [True] * n_shared + [False] * n_alone
    rs.shuffle(kinds)
    out = []
    for shared in kinds:
        lo, hi = shared_own if shared else alone_own
        own = rs.randint(1, vocab, rs.randint(lo, hi + 1)).tolist()
        out.append(((prefix if shared else []) + own,
                    int(rs.randint(new_tokens[0], new_tokens[1] + 1))))
    return out


def common_prefix(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class ForwardCount:
    """A counter of the model's decode forwards (one token per row), kept by
    a pre-hook on the first block: independent of the engine's bookkeeping.
    The hook counts through ``kernels.count_launch``, as a kernel wrapper
    does: a forward recorded into a CUDA graph counts once per replay."""

    def __init__(self, model):
        from vats_tpu_torch.inference import QuantizedModel
        from vats_tpu_torch.ops import kernels

        self.launches = 0
        blocks = (model.model if isinstance(model, QuantizedModel) else model).layers

        def hook(mod, args):
            if args[0].shape[1] == 1:
                kernels.count_launch(self)

        self._handle = blocks[0].register_forward_pre_hook(hook)

    def remove(self):
        self._handle.remove()


def drive(engine, stream):
    """Submit the stream, step the engine to the end; returns ({rid: tokens},
    {rid: seconds from submission to retirement}, wall seconds)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for prompt, n in stream:
        engine.submit(prompt, max_new_tokens=n)
    outs, done_s = {}, {}
    while engine.queue or any(r is not None for r in engine.row_request):
        for req in engine.step():
            outs[req.rid] = req.output_ids
            done_s[req.rid] = time.perf_counter() - t0
    torch.cuda.synchronize()
    return outs, done_s, time.perf_counter() - t0


def run_serve(kernel_fns):
    import torch

    from vats_tpu_torch.inference import QuantizedModel, ServingEngine, quantized_bytes
    from vats_tpu_torch.models import TextLM

    cfg = medium_cfg()
    L = cfg.num_layers
    t0 = time.perf_counter()
    model = TextLM(cfg, device="cuda", seed=0).eval()
    torch.cuda.synchronize()
    log(f"serve: nlp_medium E8/top-2 bf16 {L} layers, built in "
        f"{time.perf_counter() - t0:.1f}s; engine max_batch={SERVE_ROWS} max_context="
        f"{SERVE_CONTEXT} page_size=128 total_pages={SERVE_PAGES} prefix_caching "
        f"decode_block_steps={SERVE_BLOCK} greedy")
    stream = serve_stream(2024, cfg.vocab_size, 32, 32, 256, (44, 256), (300, 512),
                          (32, 64))
    n_new = sum(n for _, n in stream)
    log(f"serve: 64 requests, prompts {min(len(p) for p, _ in stream)}.."
        f"{max(len(p) for p, _ in stream)} tokens (32 share a 256-token prefix), "
        f"{n_new} new tokens in all")
    k1, k4 = kernel_fns["paged_decode_attention_commit"], kernel_fns[
        "paged_decode_attention_commit_int8"]
    engine_kw = dict(max_batch=SERVE_ROWS, max_context=SERVE_CONTEXT, page_size=128,
                     total_pages=SERVE_PAGES, prefix_caching=True,
                     decode_block_steps=SERVE_BLOCK)
    runs, counts = {}, {}
    for name, kv_quant in (("bf16 KV", None), ("int8 KV", "int8"),
                           ("int8 weights + int8 KV", "int8")):
        if name.startswith("int8 weights"):
            model = QuantizedModel(model)
            log(f"serve: int8 weights resident {quantized_bytes(model.qparams) / 1e9:.3f} "
                f"GB (bf16 {sum(p.numel() for p in model.qparams.values()) * 2 / 1e9:.3f}"
                f" GB)")

        def engine(use_graphs):
            eng = ServingEngine(model, kv_quant=kv_quant, **engine_kw)
            eng._use_graphs = use_graphs
            return eng

        # an untimed drive of the whole stream warms this configuration up
        # (allocator, cuBLAS choices for every prefill group and decode shape)
        drive(engine(True), stream)
        first = {}

        def timed(use_graphs):
            def run():
                fwd = ForwardCount(model)
                eng = engine(use_graphs)
                torch.cuda.empty_cache()
                for fn in kernel_fns.values():
                    fn.launches = 0
                outs, done_s, wall = drive(eng, stream)
                got = {f.__name__: f.launches for f in kernel_fns.values()}
                fwd.remove()
                check_serve(name, eng, outs, stream, cfg, got, fwd.launches, kv_quant, L,
                            k1, k4)
                # what the report needs, not the engine: its pool would stay
                # allocated through the next drives and raise their peaks
                first.setdefault(use_graphs, (
                    f"page_high_water={eng.allocator.high_water}/"
                    f"{eng.allocator.capacity} preemptions={eng.preemptions} "
                    f"prefix_hit_tokens={eng.prefix_cache.hit_tokens}/"
                    f"{eng.prefix_cache.query_tokens}; forwards "
                    f"{json.dumps(eng.forwards)}", got))
                lat = np.asarray(list(done_s.values()))
                nums = dict(
                    tokens_per_s=n_new / wall, wall_s=wall,
                    latency_p50_s=float(np.percentile(lat, 50)),
                    latency_p99_s=float(np.percentile(lat, 99)),
                    capture_s=sum(g.capture_s for g in eng.graphs.values()),
                    replays=sum(g.replays for g in eng.graphs.values()),
                    decode_forwards=eng.forwards["decode"])
                del eng
                return nums, outs
            return run

        got_runs = in_turns(f"serve [{name}]", [("graph", timed(True)),
                                                ("eager", timed(False))])
        tagged = [(f"{path} {i}", o) for path, rs in got_runs.items()
                  for i, (_, o) in enumerate(rs)]
        for tag, o in tagged[1:]:
            diff = [r for r in o if o[r] != tagged[0][1][r]]
            require(not diff, f"serve {name}: {tagged[0][0]} and {tag} drives give other "
                    f"tokens for requests {diff[:8]} (first difference at "
                    f"{[common_prefix(o[r], tagged[0][1][r]) for r in diff[:8]]})")
        summary, got = first[True]
        outs = got_runs["graph"][0][1]
        log(f"serve [{name}]: {summary}; launches (graph) {json.dumps(got)}; the timed "
            f"graph wall includes the capture")
        # each path's own load, warm, once more under the profiler; its device
        # time over the mean unprofiled wall of that path is its idle share
        for path, use_graphs in (("graph", True), ("eager", False)):
            busy = profile_breakdown(f"serve [{name}] [{path}], the whole stream again",
                                     lambda: drive(engine(use_graphs), stream))
            walls = [n["wall_s"] for n, _ in got_runs[path]]
            if busy is not None:
                log(f"serve [{name}] [{path}]: device_busy_s={busy:.3f} over the mean "
                    f"timed wall_s={np.mean(walls):.3f}: idle_share="
                    f"{1 - busy / np.mean(walls):.3f}")
        decode_census(model, f"serve [{name}]", SERVE_ROWS, paged=True, kv_quant=kv_quant)
        runs[name], counts[name] = outs, got
    pairs = [(runs["bf16 KV"][r], runs["int8 KV"][r]) for r in runs["bf16 KV"]]
    same = sum(int(x == y) for a, b in pairs for x, y in zip(a, b))
    first_diff = sum(common_prefix(a, b) for a, b in pairs)
    log(f"serve: greedy tokens of int8 KV equal to bf16 KV at {same}/{n_new} positions "
        f"({same / n_new:.3f}); equal up to the first difference: {first_diff}/{n_new}")
    del model
    torch.cuda.empty_cache()
    # the kernels line reports the int8 KV run's launches for K4
    return {**counts["bf16 KV"], k4.__name__: counts["int8 KV"][k4.__name__]}


def check_serve(name, engine, outs, stream, cfg, got, decode_fw, kv_quant, L, k1, k4):
    """Gates of one drive: every request whole, every page back, ids in the
    vocabulary, the decode kernel of this pool and K3's paged prologue each
    launched once per layer per decode forward counted by the hook, which
    the engine's own count equals."""
    require(len(outs) == len(stream), f"serve {name}: {len(outs)} of 64 finished")
    for rid, (prompt, n) in enumerate(stream):
        require(len(outs[rid]) == n, f"serve {name}: request {rid} has "
                f"{len(outs[rid])} tokens, not {n}")
    toks = np.concatenate([np.asarray(outs[r]) for r in range(len(stream))])
    require(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
            f"serve {name}: out-of-vocabulary ids")
    engine.allocator.free(engine.prefix_cache.reclaim(engine.allocator.capacity))
    require(engine.allocator.num_used == 0, f"serve {name}: pages leaked")
    want_k1, want_k4 = (L * decode_fw, 0) if kv_quant is None else (0, L * decode_fw)
    require(decode_fw == engine.forwards["decode"] and decode_fw > 0,
            f"serve {name}: {decode_fw} decode forwards counted, engine says "
            f"{engine.forwards['decode']}")
    require(got[k1.__name__] == want_k1 and got[k4.__name__] == want_k4,
            f"serve {name}: K1 {got[k1.__name__]} (want {want_k1}), K4 "
            f"{got[k4.__name__]} (want {want_k4}) launches")
    fused = (got["paged_decode_prologue"], got["dense_decode_prologue"],
             got["append_token_inplace"])
    require(fused == (L * decode_fw, 0, 0), f"serve {name}: K3's paged, dense and "
            f"append-only modes launched {fused} times, want {(L * decode_fw, 0, 0)}")
    require(engine.preemptions >= 1, f"serve {name}: no preemption")


# --- phase: serve_parity ----------------------------------------------------


def run_serve_parity():
    import torch

    from vats_tpu_torch.inference import ServingEngine
    from vats_tpu_torch.models import TextLM

    cfg = medium_cfg(num_layers=2)
    gpu = TextLM(cfg, device="cuda", seed=11).eval()
    cpu = TextLM(cfg, device="meta")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, assign=True)
    cpu.eval()
    # the unshared prompts end just below a page boundary, so their rows
    # grow into a second page and the 7-page pool runs dry
    stream = serve_stream(77, cfg.vocab_size, 4, 4, 128, (8, 40), (118, 127), (10, 16))
    engine_kw = dict(max_batch=4, max_context=512, page_size=128, total_pages=1 + 7,
                     prefix_caching=True, kv_quant="int8", decode_block_steps=2,
                     prompt_buckets=(64, 128, 256))
    # the card's tokens come from its graph path; a hook cannot read logits
    # inside a replay, so they come from an eager drive on the card, whose
    # tokens must equal the graph drive's bit for bit
    res = {}
    for name, model, use_graphs in (("cuda", gpu, True), ("cuda eager", gpu, False),
                                    ("cpu", cpu, False)):
        logits = []
        handle = None if use_graphs else model.register_forward_hook(
            lambda m, a, out: logits.append(out[0][:, -1].float().cpu()))
        engine = ServingEngine(model, **engine_kw)
        engine._use_graphs = use_graphs
        rids = [engine.submit(p, max_new_tokens=n) for p, n in stream]
        out = engine.run()
        if handle is not None:
            handle.remove()
        res[name] = ([out[r] for r in rids], logits, engine)
    (tok_g, _, eng_g), (tok_e, lg_g, _), (tok_c, lg_c, eng_c) = (
        res["cuda"], res["cuda eager"], res["cpu"])
    require(len(eng_g.graphs) > 0 and tok_g == tok_e,
            "serve_parity: the card's graph and eager drives give other tokens")
    require(eng_g.preemptions >= 1 and eng_g.prefix_cache.hit_tokens > 0,
            "serve_parity: the stream made no preemption or no prefix hit")
    require(len(lg_g) == len(lg_c), "serve_parity: the two engines ran other schedules")
    errs = []
    for a, b in zip(lg_g, lg_c):  # forwards up to the first differing argmax
        require(bool(torch.isfinite(a).all()), "serve_parity: non-finite card logits")
        errs.append(float((a - b).abs().max()))
        if not torch.equal(a.argmax(-1), b.argmax(-1)):
            break
    n_tok = sum(len(t) for t in tok_c)
    agree = sum(int(x == y) for tg, tc in zip(tok_g, tok_c) for x, y in zip(tg, tc))
    log(f"serve_parity (2 layers, full width, int8 KV, card K4 in replayed graphs, "
        f"equal to the card's eager drive, vs CPU plain): 8 "
        f"requests, preemptions {eng_g.preemptions}/{eng_c.preemptions}, prefix hits "
        f"{eng_g.prefix_cache.hit_tokens}; per-forward max |logit err| over the "
        f"{len(errs)} of {len(lg_g)} forwards before the first differing argmax: "
        f"{[round(e, 4) for e in errs]}; greedy tokens equal {agree}/{n_tok} "
        f"({agree / n_tok:.3f})")
    require(agree / n_tok >= 0.9, f"serve_parity: token agreement {agree / n_tok:.3f}")
    del gpu, cpu, res
    torch.cuda.empty_cache()


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
    from vats_tpu_torch.ops import flash_attention as fa
    from vats_tpu_torch.ops.cache_append import (
        append_token_inplace,
        dense_decode_prologue,
        paged_decode_prologue,
    )
    from vats_tpu_torch.ops.decode_attention import (
        paged_decode_attention_commit,
        paged_decode_attention_commit_int8,
    )

    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    card = card_line()
    secs = kernels.build_all()
    log(f"build: {len(kernels.SOURCES)} kernel libraries in {secs:.1f}s")
    for name in kernels.SOURCES:
        entry = ""
        for line in kernels.build_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                # the kernel's name and its (mangled) template arguments
                tag = re.sub(r"^.*?\d+(?=[a-z_]+kernel)", "", entry)[:40]
                log(f"  {name} {tag}: {line.strip()}")
    for name, n_kernels in WGMMA_KERNELS.items():
        counts, marker = tensor_core_instructions(kernels, name)
        require(len(counts) == n_kernels and all(n > 0 for n in counts.values()),
                f"build: a bf16 kernel of csrc/{name}.cu has no tensor-core instruction "
                f"({marker}), or not all {n_kernels} were found: {counts}")
        log(f"build: {marker} instructions in csrc/{name}.cu: " + ", ".join(
            f"{n} in {fn}" for fn, n in counts.items()))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # path: which phase's run counts the row's launches
    kernel_rows = [
        dict(name="paged_decode_attention_commit", route="cuda",
             source="vats_tpu_torch/csrc/decode_attention.cu",
             replaces="vats_tpu/ops/decode_attention.py:371", fn=paged_decode_attention_commit,
             path="main"),
        dict(name="paged_decode_attention_commit_int8", route="cuda",
             source="vats_tpu_torch/csrc/decode_attention.cu",
             replaces="vats_tpu/ops/decode_attention.py:371",
             fn=paged_decode_attention_commit_int8, path="serve"),
        dict(name="flash_attention_forward", route="cuda",
             source="vats_tpu_torch/csrc/flash_attention.cu",
             replaces="vats_tpu/ops/flash_attention.py:67", fn=fa.flash_attention,
             path="main"),
        # K3's append-only mode: off the main path since K3 became the fused
        # prologue (the main phase gates it at 0 launches)
        dict(name="dense_cache_append", route="cuda",
             source="vats_tpu_torch/csrc/cache_append.cu",
             replaces="vats_tpu/ops/cache_append.py:47", fn=append_token_inplace,
             path="main"),
        dict(name="dense_decode_prologue", route="cuda",
             source="vats_tpu_torch/csrc/cache_append.cu",
             replaces="vats_tpu/ops/cache_append.py:47", fn=dense_decode_prologue,
             path="main"),
        dict(name="paged_decode_prologue", route="cuda",
             source="vats_tpu_torch/csrc/cache_append.cu",
             replaces="vats_tpu/ops/cache_append.py:47", fn=paged_decode_prologue,
             path="main"),
        dict(name="flash_attention_forward_lse", route="cuda",
             source="vats_tpu_torch/csrc/flash_attention.cu",
             replaces="vats_tpu/ops/flash_attention.py:207", fn=fa.flash_attention_lse,
             path="train"),
        dict(name="flash_attention_backward_dkv", route="cuda",
             source="vats_tpu_torch/csrc/flash_backward.cu",
             replaces="vats_tpu/ops/flash_attention.py:230", fn=fa.flash_bwd_dkv,
             path="train"),
        dict(name="flash_attention_backward_dq", route="cuda",
             source="vats_tpu_torch/csrc/flash_backward.cu",
             replaces="vats_tpu/ops/flash_attention.py:344", fn=fa.flash_bwd_dq,
             path="train"),
    ]
    results = {}
    if "kernels" in phases:
        # each check draws its inputs from its own seed, so a change to one
        # check leaves the others' inputs as they were
        gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)  # noqa: E731
        results["paged_decode_attention_commit"] = check_k1(gen(0))
        results["paged_decode_attention_commit_int8"] = check_k4(gen(1))
        results["flash_attention_forward"] = check_k2(gen(2))
        results["dense_cache_append"] = check_k3(gen(3))
        (results["dense_decode_prologue"],
         results["paged_decode_prologue"]) = check_k3_prologue(gen(6))
        results["flash_attention_forward_lse"] = check_k2_lse(gen(4))
        (results["flash_attention_backward_dkv"],
         results["flash_attention_backward_dq"]) = check_k5(gen(5))
        log(f"phase kernels ended at {time.perf_counter() - t_start:.1f}s")
    counts = {"main": {}, "serve": {}, "train": {}}
    runners = {
        "main": lambda: run_main([r["fn"] for r in kernel_rows if r["path"] == "main"]),
        "parity": run_parity,
        "serve": lambda: run_serve({r["name"]: r["fn"] for r in kernel_rows}),
        "serve_parity": run_serve_parity,
        "train": lambda: run_train([r["fn"] for r in kernel_rows] + [fa.flash_attention]),
        "train_parity": run_train_parity,
    }
    for phase, run in runners.items():
        if phase in phases:
            got = run()
            if phase in counts:
                counts[phase] = got
            log(f"phase {phase} ended at {time.perf_counter() - t_start:.1f}s")

    line = []
    for row in kernel_rows:
        entry = {k: row[k] for k in ("name", "route", "source", "replaces")}
        entry["launches"] = counts[row["path"]].get(row["fn"].__name__)
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
