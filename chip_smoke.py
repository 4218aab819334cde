#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``vats_tpu_torch``) once on one card.

    python3 chip_smoke.py              # every phase, one GPU
    python3 chip_smoke.py --phases build,kernels

The card's checks live in three places, each with its own job:
``tests/test_torch_cuda_kernels.py`` and ``tests/test_torch_cuda_graphs.py``
(``python3 -m pytest --noconftest -m cuda``) hold every kernel against its
plain version, at the main path's shapes and off them, and the card against
the CPU; ``benchmark/`` measures speed; this script holds what needs the
models at full width on the card: the build, each kernel against its plain
version at the main path's shapes with the kernel table's timings (at the
card tests' limits, from ``tests/torch_card_parity.py``), the exact launch
gates of every path, and graph against eager bit for bit.

Phases:
  build    build every CUDA kernel from ``vats_tpu_torch/csrc`` (one nvcc per
           source, all at once); print the card's name and power limit and
           ptxas's registers, shared memory and spills; fail unless every
           bf16 flash forward and backward kernel, K6 at both widths and K7
           at each tile shape holds tensor-core instructions (HGMMA).
  kernels  each kernel at the main path's shapes: one call against its plain
           version at the card tests' limits (``torch_card_parity``: bf16
           outputs within TOL, the flash forwards plus the p flip allowance
           where the smoke held it before, K5a and K5b within BWD_BF16_TOL,
           K3's q and k within PROLOGUE_ULPS, committed pools, caches and
           K7's plan, gather and combine bit for bit, K6 within TOL + 2^-9
           max|v| and a relaunch bit-equal), then timed (the kernel table of
           PERF.md): the wrapper's call and the kernel alone (device time,
           torch.profiler), its plain version, the library call where one
           exists (SDPA for the flash kernels, two ``scatter_`` for K3's
           append, the padded bmm path and ``torch._grouped_mm`` for K7) and
           its least time: bytes over 3.35 TB/s or operations over the bf16
           peak, from ``benchmark/work.py``'s counts (K1 at the head dim the
           attention needs, the flash kernels over the attended pairs; the
           flash backward as a whole), or from the local counts for what
           work.py lacks (K4's int8 pool, K5a and K5b alone, K3 at the fp32
           peak, K6, K7).  Shapes: K1, K1' and K4 at the serving batch (B=32,
           lengths <= 576; K1 also with every row at one length) and at 4096
           tokens, K1 at code_chat_8k's decode (Mellum2's
           heads, 64 rows of 1k-8k tokens) with its window and without, at
           the image decode (hd 24) and the multimodal one (hd 96); K2 at a
           prefill batch, K2 and the backward at T=S=2048 (B=2), K2' and the
           backward at medium_dense's train batch,
           K2, K2' and the backward at ViT-2D medium's and the image
           transformer's shapes, K2' and the backward at a ring hop, K2 at
           the multimodal prefill; K3's dense and paged prologue at B=16, its
           table mode at the image and multimodal decodes and with
           Mellum2's YaRN table, its append mode at video_gen_large's
           temporal cache; K6 at decode_heavy's and code_chat_8k's prefills;
           K7 at both cells' decode and prefill; K9 at v2lite.reasoning_256's
           decode (256 rows, lengths about its mean, within TOL plus
           ``mla_p_allowance``) and one row at 12,288; K8 at vats_medium_moe's 122
           leaves (the update, the accumulation step and the boundary's
           update with the reset, each bit for bit against the plain
           per-leaf version; bound: 24, 12 and 28 bytes a parameter).
  main     the main path at full width (nlp_medium, 8 experts, top-2, bf16,
           random weights from a seed): ``generate_paged`` over ragged
           prompts up to 512 tokens (whole-batch and row-chunked prefill) and
           the dense ``TokenGenerator``, every decode step after the first
           replayed from a CUDA graph.  Launch counters are zeroed just
           before and read just after; each must equal 20 layers x calls
           (K3's fused prologue once a layer a decode forward, its
           append-only mode never; K6 never, every prefill here being
           fresh).  Sampled ``generate_paged`` with ``approx_top_k`` on and
           off from one seed: equal tokens, equal launches.  The graph and
           the eager decode loop of both entry points: equal tokens.  K3's
           dense prologue in replayed dense graphs at B 1, 16, 32 beside an
           empty kernel of its grid and the chain it replaced.
  serve    the continuous-batching ``ServingEngine`` at full width
           (nlp_medium, 8 experts, top-2, bf16; SERVE_LAYERS = 2 of 20): 64
           requests (32 sharing a 256-token prefix) through 32 rows, a
           129-page pool (requests queue and rows are preempted), prefix
           caching, 4-step decode blocks, greedy; three configurations: bf16
           KV (K1), int8 KV (K4), int8 weights + int8 KV.  Each is driven
           from graphs on a fresh engine (it captures every key), from
           graphs on one primed by an earlier drive (it only replays) and
           eagerly: equal tokens; every request whole and every page back;
           K1 or K4 and K3's paged prologue once a layer a decode forward
           (the forwards a hook counts), K6 once a layer a prefill forward
           with bf16 KV and never with int8; one prefill graph a (bucket,
           padded group size) the engine met.  The bf16-KV stream with
           speculative decoding (spec_k = SPEC_K = 4): the verify forward
           from one graph, the same three drives, equal tokens, forwards and
           drafts, exact gates.  The stream with every MoE layer lossless:
           K7 twice a layer a forward, graph and eager tokens equal.
  mla      DeepSeek-V2-Lite whole (27 layers, 15.7B params, bf16, the
           benchmark's seeded weights) through ``ServingEngine``: 8 ragged
           prompts prefilled into the latent pool, 24 tokens each from
           4-step decode blocks, from graphs and eagerly (equal tokens).
           Exact gates: K9 27 launches a decode forward and none in a
           prefill, its plain version none, K7 52 a forward.
  train    the training step at the JAX bench's ``medium_dense`` tier (d1440,
           20 layers, vocab 65536, B=16, T=512, dropout 0.1, remat 'dots',
           fused CE 128, bf16 AdamW mu) and ``medium_moe`` (d768, 12 layers,
           8 experts, top-2) through ``make_train_step``: the first call
           (eager warm-up and capture), then TRAIN_TURN_STEPS steps from the
           CUDA graph and eagerly from one snapshot of the state restored in
           place (``train_turns``): params, moments, counters and metrics
           bit-equal; K2' 2 x layers, K5a and K5b once a layer, K8's update
           once and K2 never, a replay's tally and both turns' counts;
           ``state.step`` one a call; K8's tally every leaf fused, none
           plain.  medium_dense at grad_accum_steps=4 likewise, one graph a
           window position, K8's accumulation once a micro-step and its
           update once a window.
  context_parallel  CP_RANKS = 2 ranks spawned on cuda:0 (the card's
           compute mode printed first: an exclusive mode stops the second
           rank, and the phase fails), over gloo with CUDA tensors staged
           through host buffers (NCCL needs one GPU a rank).  Ring attention
           at nlp_medium's attention shape over T = 4096 (tl 2048, B = 2,
           bf16), causal without and with left_window 384, forward and
           backward against single-process flash on the card (CP_REL_L2);
           one sequence-parallel medium_dense step at full width, CP_LAYERS =
           5 of its 20 layers (T = 4096, dropout 0) with 'ring' and with
           'ulysses' against the single-process step (the card tests' train
           limits, leaf by leaf).  Exact launch gates a rank: K2', K5a, K5b =
           live hops of ``_ring_steps`` (x layers, K2' x 2 under remat in the
           step), none under Ulysses.  Step walls, bytes sent, the seconds in
           collectives and peak memory per rank.  The blockwise ring
           (``impl="xla"``, 512 x 512 tiles, no kernel) at the ring's shape
           and windows: out, dq, dk, dv within CP_REL_L2 of the flash ring
           and of single-process flash, no K2' / K5a / K5b launch.
  sharded  SH_RANKS = 4 ranks spawned on cuda:0 over gloo, host-staged (the
           compute mode printed first; an exclusive mode fails the phase):
           one medium_moe step at full width, SH_LAYERS = 2 of its 12 layers
           (d768, vocab 65536, E8 top-2, sort dispatch, capacity 1.25, remat
           'dots', dropout 0, bf16 AdamW mu, B=4, T=512) on fsdp=2 x
           expert=2 and on fsdp=2 x tensor=2, in fp32 and in the config's
           bf16, each against the single-process step from the same weights
           and batch (the card tests' train limits on the loss and grad norm;
           the dropped assignments a layer equal, or apart by at most the
           assignments that near-tie router flips move; in fp32 also the
           per-leaf gradients and change, gathered to rank 0: ``SH_DTYPES``
           says why bf16 is not held leaf by leaf); exact per-rank gates K2'
           2 x layers, K5a and K5b once a layer a step; resident bytes a rank
           asserted equal to the specs' sum.
  pipeline  PP_RANKS = 4 ranks spawned on cuda:0 over gloo, host-staged (the
           compute mode printed first; an exclusive mode fails the phase), one
           GPipe stage a rank on a ``stage`` axis: medium_dense at full width,
           PP_LAYERS = 8 of its 20 layers (2 blocks a rank, ``stage_model``),
           B=8, T=512, through ``pipeline_text_lm_apply``, a masked CE and one
           AdamW update a step.  fp32 at M=4 against the single-process step
           from the same weights and batch (run first on rank 0): logits,
           loss, every rank's own layers and the replicated leaves leaf by
           leaf (``PP_*`` limits), the replicated leaves equal on every rank.
           bf16, three steps at M=4 and at M=8: bytes sent a rank against the
           count the packed shapes predict (exact), resident bytes against
           the stage's shapes (exact).  Exact gates a rank a step: K2 0, K2',
           K5a, K5b 2 x M (a stage computes on its M active ticks only); the
           single process 8 each.
  scripts  the LM's own entry points in-process through their ``main(argv)``,
           in a temporary directory under ``checkpoints/`` that it deletes
           (it first checks for twice a checkpoint's bytes free): the train
           script at full nlp_medium width and depth (B=8, T=512, one round
           of 8 micro-steps, one evaluation, a best and a regular
           checkpoint; exact K2', K5a, K5b and K2 launch counts); the
           regular checkpoint loaded into a fresh state bit-equal to the
           saved one; ``--resume`` for one more round (tokens_seen goes on);
           the serve script on the trained ``best_model`` with bf16 and int8
           KV (K1 or K4 and K3's paged prologue once a layer a decode
           forward, K6 once a layer a prefill forward with bf16 KV); the
           interactive script on ``best_model`` at temperature 0, dense and
           ``--paged`` (K3's dense prologue, or K1 and the paged prologue,
           once a layer a decode forward); a TokenShard packed into 8 rows
           of 512 with segment ids, one medium_dense forward and backward,
           again with each row's first segment re-drawn: the later
           segments' logits stay.
  vision   the vision encoders at full depth: ViT-2D medium forward (384 px /
           p16, d1152, 16 layers, bf16 params, B=16) on 384x384 and on
           448x531 (resize and crop on the card), K2 exactly 16 launches a
           forward; at 384x384 also from a CUDA graph (a ``GraphSet``, as the
           eval step's), K2 16 a replay and the features bit-equal to
           eager's.  ViT-2D medium training through ``make_vision_train_step``
           (1000 classes, dropout 0.2, remat, 4 micro-steps of B=32 with
           mixup / cutmix and the pixel battery on raw images on the card),
           one CUDA graph a micro-step position, graph and eager from one
           snapshot (``train_turns``, bit-equal): K2' 32, K5a 16 and K5b 16 a
           micro-step (each graph's tally and both turns), K2 16 in the eval
           step, exactly; an eval loss that the update moves (the eval step
           replayed from its graph, equal to eager bit for bit).  ViT-3D
           xsmall (B=4, 32 frames at 128^2) and large (B=4, 8 frames at
           224^2) forwards with no flash launch (the JAX model attends with
           XLA there), eagerly and from graphs, bit-equal.
  image_gen  text->image generation at image_gen_xsmall's full width (d768,
           32/4 heads of 24; the generation runs at IMG_GEN_LAYERS = 3 of 12
           layers, the trainer and the script at 12): ``generate_image_tokens``
           and ``generate_image_tokens_paged`` at tools/bench_gen.py's shape
           (B=4, 16x16, temperature 0.9, top-k 64), from graphs and eagerly
           (equal tokens); the ``ImageGenerationPipeline`` on the 64x64 grid
           (4096 graph steps); ``ImageGenTrainer`` steps at 256 px, B=2, from
           their graph and eagerly (bit-equal, cuDNN's deterministic
           algorithms), and an ``evaluate`` from its graph (equal to eager);
           the image-gen script for 3 steps.  Exact gates: K3's table mode
           (and K1 on the paged path) once a layer a decode forward, K2' 24,
           K5a 12, K5b 12 a train step, K2 12 an evaluation.
  video_gen  text->video generation at video_gen_large's full width (d1728,
           12/4 heads of 144, 16x16 latent grid; the generation and the
           pipeline at VID_GEN_LAYERS = 3 of its 20 layers, the trainer at
           all 20): the inner raster step of ``generate_video_tokens`` (a
           read-mode forward of the whole frame) replayed from a CUDA graph
           over 2 latent frames, and the eager loop over the first (equal
           tokens), B=1, temperature 0.9, top-k 64; the same at the JAX
           bench's shape (video_gen_xsmall, B=2, 5 frames of 8x8); the
           ``VideoGenerationPipeline`` over 2 latent frames;
           ``VideoTokenTrainer`` steps at B=1 over 15 latent frames (remat,
           dropout 0.2) and ``VQVAE3DTrainer`` steps on a 30-frame 128x128
           clip, each from its graph and eagerly (bit-equal).  Exact gates:
           K3's append mode once a layer a cached forward (read steps too),
           nothing else.
  multimodal  the fused text+image+video stream at multimodal_small's full
           width (d768, 8/4 heads of 96; MM_GEN_LAYERS = 2 of its 12 layers):
           ``generate_multimodal`` at the JAX bench's shape (B=4, t_text 64,
           2304 tokens a row, 2303 decode forwards), from graphs and eagerly
           (equal codes); ragged prompts at t_text 256 (the prefill through
           K2); 64 decode steps through the dense and the paged cache fed
           the same tokens (logits within LOGIT_ATOL).  Exact gates: K1 and
           K3's paged table mode once a layer a decode forward, K2 once a
           layer a prefill at t_text 256 and never at 64, K3's dense table
           mode once a layer a dense decode forward.

The last two lines of standard output are one JSON object listing every
kernel, then ``{"ok": true, "device": {...}}``.  Any failed phase raises and
the script exits non-zero without printing the result.  Without a CUDA
device, or outside a checkout of the repository, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

from benchmark import work

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "kernels", "main", "serve", "mla", "train", "context_parallel", "sharded",
          "pipeline", "scripts", "vision", "image_gen", "video_gen", "multimodal")
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (work.py has bf16 only)


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


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def bound(nbytes: float, flops: float, fp32: bool = False):
    """(least ms, "bytes" or "operations"): ``benchmark/work.py``'s least
    time (bytes over the HBM peak, operations over the bf16 peak), or over
    the fp32 peak for work outside the tensor cores (K3).  An edit of
    ``work.py``'s ``least_s``, ``decode_attn_cost`` or ``flash_*_cost``
    moves these bounds and the kernel table that reads them."""
    t_bytes = nbytes / work.PEAK_BYTES_PER_S
    t = max(t_bytes, flops / PEAK_FP32_FLOPS) if fp32 else work.least_s(nbytes, flops)
    return t * 1e3, "bytes" if t == t_bytes else "operations"


# bf16 wgmma kernel instantiations per library: 3 head dims x (K2, K2') in
# the forward, 3 x (K5a, K5b) in the backward, K6 at widths 64 and 128, K7
# at its small and large tiles with and without the SwiGLU epilogue.
WGMMA_KERNELS = {"flash_attention": 6, "flash_backward": 6, "paged_prefill_attention": 2,
                 "moe_grouped_gemm": 4}


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
            k = re.search(r"(flash_\w+?|paged_prefill)_wgmma_kernelILi(\d+)E(?:Lb(\d))?",
                          m.group(1))
            fn = (f"{k.group(1)} D={k.group(2)}{' LSE' if k.group(3) == '1' else ''}"
                  if k else None)
            # K7: one instantiation a (warpgroups, chunks, swiglu) tile shape
            g = re.search(r"moe_grouped_wgmma_kernelILi(\d+)ELi(\d+)ELb(\d)", m.group(1))
            if g:
                fn = f"moe_grouped WG={g.group(1)} NCH={g.group(2)} swiglu={g.group(3)}"
            if fn:
                counts[fn] = 0
        elif fn and marker in line:
            counts[fn] += 1
    return counts, marker


def kernel_alone_ms(fn, key, iters=20):
    """Device ms per call of the kernels whose name holds ``key`` alone
    (torch.profiler events), or None where the profiler recorded nothing."""
    fn()
    per, _ = profiled(fn, iters)
    got = sum(us for name, (us, _) in per.items() if key in name)
    return got / iters / 1e3 if got else None


def _fmt(ms, digits=4):
    return "not measured" if ms is None else f"{ms:.{digits}f}"


# --- phase: kernels ---------------------------------------------------------
# Each row holds a kernel against its plain version at the main path's
# shapes, at the card tests' limits (tests/torch_card_parity.py), and
# times it; the card tests (tests/test_torch_cuda_kernels.py) hold the
# kernels at these shapes and off them.


def timing_row(label, kern, cost, plain=None, lib=None, alone=None, fp32=False, iters=20,
               close=None, **extra):
    """One call of ``kern`` (the wrapper's whole call) against one of
    ``plain`` within ``close`` (a limit of ``torch_card_parity.check_close``
    for every output, or a tuple of one an output; each returns its output,
    or a tuple of outputs with the state it wrote), then the device ms of
    ``kern`` and of its kernels whose name holds ``alone``, of the plain
    version and of the library call (``iters`` calls each), beside the
    least time of ``cost`` = (bytes, operations); logs one line and returns
    the row.  ``extra``: more numbers for the row."""
    from torch_card_parity import check_close

    err = None
    if close is not None:
        got, want = (x if isinstance(x, tuple) else (x,) for x in (kern(), plain()))
        limits = close if isinstance(close, tuple) else (close,) * len(got)
        require(len(got) == len(want) == len(limits),
                f"{label}: {len(got)} outputs, {len(want)} plain, {len(limits)} limits")
        err = max(check_close(f"{label} output {i}", a, b, lim)
                  for i, (a, b, lim) in enumerate(zip(got, want, limits)))
        del got, want
    b_ms, by = bound(*cost, fp32=fp32)
    row = dict(max_abs_err=err, ms=device_ms(kern),
               kernel_alone_ms=kernel_alone_ms(kern, alone) if alone else None,
               plain_ms=device_ms(plain, iters) if plain else None,
               library_ms=device_ms(lib, iters) if lib else None, bound_ms=b_ms, bound_by=by,
               **extra)
    log(f"{label}: " + " ".join(f"{k}={_show(k, v)}" for k, v in row.items()))
    return row


def _show(key, v):
    if isinstance(v, str):
        return v
    return f"{v:.3e}" if key == "max_abs_err" and v is not None else _fmt(v, 5)


def headline(rows):
    """The first row's numbers, and every row under its label."""
    return {**next(iter(rows.values())), **rows}


# K1/K4 shapes: (label, B, pages a row, lengths set first, the others drawn
# below this, heads (G, N, hd, hd stored), the least drawn length, windows):
# nlp_medium's decode attention (Hq 24, G 8, hd 60 -> 64) at the serving
# batch and at its max_seq_len 4096 (up to 32 tiles a row); code_chat_8k's
# (Mellum2: Hq 32, G 4, hd 128) over its 64 rows of 1k-8k tokens with the
# window of its 21 sliding layers (left_window 1023) and without (its 7 full
# layers), the rows at the window's and the tiles' edges first; the image
# decode (image_gen_xsmall: Hq 32, G 4, hd 24, the generic N=8 body) on the
# 16 x 16 grid and at 4096 (the 64 x 64 grid); the multimodal decode
# (multimodal_small: Hq 8, G 4, hd 96) at t_text 64 + 2303 steps.
LM_HEADS, MELLUM_HEADS = (8, 3, 60, 64), (4, 8, 128, 128)
CODE_CHAT_LENGTHS = ((1023, 1024, 1025, 1151, 1152, 1153, 2047, 4096, 8191)
                     + tuple(range(1100, 8192, 129)))
DECODE_SHAPES = (
    ("B=32 lengths<=576", 32, 5, (0, 1, 127, 128, 576, 640), 577, LM_HEADS, 1, (-1,)),
    ("B=8 lengths<=4096", 8, 32, (0, 129, 2047, 4096), 4097, LM_HEADS, 1, (-1,)),
    ("code_chat_8k", 64, 64, CODE_CHAT_LENGTHS, 1, MELLUM_HEADS, 1, (1023, -1)),
    ("image decode B=4", 4, 3, (0, 1, 128, 256), 1, (4, 8, 24, 24), 1, (-1,)),
    ("image decode B=1 at 4095", 1, 32, (4095,), 1, (4, 8, 24, 24), 1, (-1,)),
    ("multimodal decode", 4, 19, (2367, 2303, 1200, 65), 1, (4, 2, 96, 96), 1, (-1,)))
DECODE_PS = 128


def _decode_inputs(gen, b, pps, fixed, hi, heads, lo, int8=False):
    """A 2-layer pool of every slot written (int8 pools with their scales),
    ragged lengths in [lo, hi) (the fixed ones first), a random page table,
    bf16 q and current token."""
    import torch

    from vats_tpu_torch.ops.decode_attention import quantize_kv

    g, n, hd, hdp = heads
    P = b * pps
    sc = None
    if int8:  # every slot holds a quantized token
        pool = torch.zeros((2, P, 2, g, DECODE_PS, hdp), dtype=torch.int8, device="cuda")
        sc = torch.empty((2, P, 2, g, DECODE_PS), device="cuda")
        for layer in range(2):  # a layer at a time: the fp32 history is large
            q8, sc[layer] = quantize_kv(torch.randn((P, 2, g, DECODE_PS, hd), generator=gen,
                                                    device="cuda"))
            pool[layer, ..., :hd] = q8
    else:
        pool = torch.randn((2, P, 2, g, DECODE_PS, hdp), generator=gen,
                           device="cuda").to(torch.bfloat16)
        pool[..., hd:] = 0  # stored pad rows are zero
    lens = torch.randint(lo, max(hi, lo + 1), (b,), generator=gen, device="cuda")
    lens[:len(fixed)] = torch.tensor(fixed, device="cuda")
    table = torch.randperm(P, generator=gen, device="cuda").to(torch.int32).reshape(b, pps)
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
    return pool, sc, table, lens.to(torch.int32), mk(b, g * n, hd), mk(b, g, hd), mk(b, g, hd)


UNIFORM_LENGTHS = (0, 1, 128, 129, 256, 576)  # K1 at the serving batch, every row at one


def time_k1(gen):
    """K1 (the commit) at every decode shape and window, K1' (no commit) at
    the LM's two, each against the plain version with the plain append:
    the output within TOL, the committed pool bit-equal; K1 at the serving
    batch with every row at one length (tiles a row).  Bytes and
    operations: ``work.decode_attn_cost`` (a windowed row reads at most its
    window's keys).  Returns the serving shape's K1 row, every row under
    its label."""
    import torch

    from torch_card_parity import TOL
    from vats_tpu_torch.ops import decode_attention as da

    tol = TOL[torch.bfloat16]
    rows = {}
    for label, b, pps, fixed, hi, heads, lo, windows in DECODE_SHAPES:
        pool_k, _, table, ragged, q, k_cur, v_cur = _decode_inputs(gen, b, pps, fixed, hi, heads,
                                                                   lo)
        pool_p = pool_k.clone()  # the plain version's, so the commits can be compared
        g, n, hd, _ = heads
        runs = [(lw, ragged, "") for lw in windows]
        if label == DECODE_SHAPES[0][0]:
            runs += [(-1, torch.full_like(ragged, x), f" every row at {x}")
                     for x in UNIFORM_LENGTHS]
        for lw, lengths, at in runs:
            kw = dict(scale=hd**-0.5, k_cur=k_cur, v_cur=v_cur, left_window=lw)
            seen = [x if lw < 0 else min(x, lw) for x in lengths.tolist()]
            calls = [("K1", da.paged_decode_attention_commit, True)]
            if heads == LM_HEADS and not at:
                calls.append(("K1'", da.paged_decode_attention, False))

            def kern(fn, commit):
                out = fn(q, pool_k, 1, table, lengths, **kw)
                return (out, pool_k[1]) if commit else out

            def plain(commit):
                out = da.paged_decode_attention_ref(q, pool_p[1], table, lengths, **kw)
                if not commit:
                    return out
                da.PagedKVCache(pool_p, table, lengths).append_token(1, k_cur, v_cur)
                return out, pool_p[1]

            for name, fn, commit in calls:
                tag = (f"{name} {label}" + (f" left_window {lw}" if len(windows) > 1 else "")
                       + at)
                rows[tag] = timing_row(
                    f"{tag} (Hq {g * n}, G {g}, hd {hd}; lengths {min(seen)}-{max(seen)})",
                    lambda: kern(fn, commit),
                    work.decode_attn_cost(seen, kv_heads=g, q_per_kv=n, hd=hd,
                                          pages_per_row=pps, commit=commit),
                    plain=lambda: plain(commit), alone="paged_decode",
                    close=(tol, "equal") if commit else tol)
        del pool_k, pool_p
    return headline(rows)


def time_k4(gen):
    """K4 (the int8 pool's commit) at the LM's two decode shapes against the
    plain version with the plain append (``quantize_kv``): the output
    within TOL, the committed int8 pool byte-equal, its scales to 1e-6
    relative.  Bytes: q in and out and the current K/V in (bf16), each
    row's settled history read once as int8 at the stored head dim with
    its fp32 scales, the committed K/V out, the page table and lengths."""
    import torch

    from torch_card_parity import TOL
    from vats_tpu_torch.ops import decode_attention as da

    rows = {}
    for label, b, pps, fixed, hi, heads, lo, _ in DECODE_SHAPES[:2]:
        pool_k, sc_k, table, lengths, q, k_cur, v_cur = _decode_inputs(gen, b, pps, fixed, hi,
                                                                       heads, lo, int8=True)
        pool_p, sc_p = pool_k.clone(), sc_k.clone()
        g, n, hd, hdp = heads
        kw = dict(scale=hd**-0.5, k_cur=k_cur, v_cur=v_cur)
        tokens = sum(min(x, pps * DECODE_PS) for x in lengths.tolist())
        per_tok = 2 * g * (hdp + 4)
        nbytes = (2 * b * g * n * hd * 2 + 2 * b * g * hd * 2 + (tokens + b) * per_tok
                  + b * pps * 4 + b * 4)

        def kern():
            out = da.paged_decode_attention_commit_int8(q, pool_k, sc_k, 1, table, lengths, **kw)
            return out, pool_k[1], sc_k[1]

        def plain():
            out = da.paged_decode_attention_ref(q, pool_p[1], table, lengths, kv_scales=sc_p[1],
                                                **kw)
            da.PagedKVCache(pool_p, table, lengths, sc_p).append_token(1, k_cur, v_cur)
            return out, pool_p[1], sc_p[1]

        rows[f"K4 {label}"] = timing_row(
            f"K4 {label} ({tokens} tokens)", kern, (nbytes, 4 * g * n * hd * (tokens + b)),
            plain=plain, alone="paged_decode",
            close=(TOL[torch.bfloat16], "equal", dict(atol=0.0, rtol=1e-6)))
        del pool_k, pool_p, sc_k, sc_p
    return headline(rows)


# K2' and K5 at the training shapes: medium_dense attention, B=16, T=512.
TRAIN_B, TRAIN_T, TRAIN_HQ, TRAIN_G, TRAIN_HD = 16, 512, 24, 8, 60


def _train_attention_inputs(gen, b, t, hq, g, hd):
    import torch

    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
    return mk(b, t, hq, hd), mk(b, t, g, hd), mk(b, t, g, hd), mk(b, t, hq, hd)


def _sdpa(q, k, v, scale, causal=True):
    """scaled_dot_product_attention on [B, H, T, D] views, GQA."""
    import torch.nn.functional as F

    try:
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal, scale=scale,
                                              enable_gqa=True)
    except TypeError:  # a PyTorch without enable_gqa: repeat K/V
        r = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(r, dim=1), v.repeat_interleave(r, dim=1),
            is_causal=causal, scale=scale)


def _bwd_kernel_cost(b, t, hq, g, hd, pairs, kernel):
    """(bytes, operations) of K5a ("dkv") or K5b ("dq") alone: q, k, v, do
    (bf16) and lse, di (fp32) in; dk and dv, or dq, out in fp32 (the
    kernels' outputs), at the logical head dim; K5a recomputes q.k and
    forms dv, dp and dk (8 Hq hd a pair), K5b q.k, dp and dq (6)."""
    nbytes = b * t * hd * 2 * (2 * hq + 2 * g) + 2 * b * hq * t * 4
    if kernel == "dkv":
        return nbytes + 2 * b * t * g * hd * 4, 8 * hq * hd * pairs
    return nbytes + b * t * hq * hd * 4, 6 * hq * hd * pairs


def time_flash(gen, tag, b, t, hq, g, hd, kinds=("K2", "K2'", "K5"), causal=True, pairs=None,
               sdpa_causal=None, flips=True, **kw):
    """K2, K2' and the backward at one shape, each against its plain
    version: K2's and K2''s output within TOL (plus the p flip allowance
    unless ``flips`` is off), the lse to 1e-4; K5a and K5b, fed the plain
    forward's statistics, within BWD_BF16_TOL.  Each beside SDPA at the
    logical head dim (causal as ``causal`` unless ``sdpa_causal`` says) and
    the least time of the logical work: ``work.flash_fwd_cost`` /
    ``flash_bwd_cost`` over ``pairs`` attended pairs (every causal pair by
    default), or K5a's and K5b's own (``_bwd_kernel_cost``).  The whole
    backward as a model's backward runs it (the head-dim pads, di, K5a,
    K5b, the casts) has a row of its own.  ``kw``: more arguments of the
    flash calls (a key mask, an offset)."""
    import torch

    from torch_card_parity import BWD_BF16_TOL, TOL, p_flip_allowance
    from vats_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _train_attention_inputs(gen, b, t, hq, g, hd)
    kw = dict(scale=hd**-0.5, causal=causal, **kw)
    pairs = pairs or work.causal_pairs([t] * b)
    sdpa_causal = causal if sdpa_causal is None else sdpa_causal
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out_limit = dict(TOL[torch.bfloat16], extra=p_flip_allowance(q, k, v, **kw) if flips else None)
    rows = {}
    for name, fn, ref, lse in (("K2", fa.flash_attention, fa.flash_attention_ref, False),
                               ("K2'", fa.flash_attention_lse, fa.flash_attention_lse_ref, True)):
        if name in kinds:
            rows[name] = timing_row(
                f"{tag} {name}", lambda: fn(q, k, v, **kw),
                work.flash_fwd_cost(b, t, hq, g, hd, pairs, lse=lse),
                plain=lambda: ref(q, k, v, **kw),
                lib=lambda: _sdpa(qt, kt, vt, kw["scale"], sdpa_causal), alone="flash_fwd",
                close=(out_limit, dict(atol=1e-4, rtol=1e-5)) if lse else out_limit)
    if "K5" in kinds:
        o, lse = fa.flash_attention_lse_ref(q, k, v, **kw)
        di = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        pad = lambda x: torch.nn.functional.pad(  # noqa: E731
            x, (0, fa._kernel_head_dim(hd) - hd)).contiguous()
        qp, kp, vp, dop = map(pad, (q, k, v, do))
        # the gradients at the logical head dim (views: no launch)
        logical = lambda x: (tuple(y[..., :hd] for y in x)  # noqa: E731
                             if isinstance(x, tuple) else x[..., :hd])
        for name, fn, key, part in (("K5a", fa.flash_bwd_dkv, "dkv", slice(1, 3)),
                                    ("K5b", fa.flash_bwd_dq, "dq", slice(0, 1))):
            rows[name] = timing_row(
                f"{tag} {name}", lambda: logical(fn(qp, kp, vp, dop, lse, di, **kw)),
                _bwd_kernel_cost(b, t, hq, g, hd, pairs, key),
                plain=lambda: fa.flash_attention_bwd_ref(q, k, v, do, lse, di, **kw)[part],
                alone=f"flash_bwd_{key}", close=BWD_BF16_TOL)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = fa.flash_attention(*leaves, **kw)
        lib_leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
        lib_out = _sdpa(*lib_leaves, kw["scale"], sdpa_causal)
        rows["backward"] = timing_row(
            f"{tag} backward (pads, di, K5a, K5b, casts; its kernels compared above)",
            lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
            work.flash_bwd_cost(b, t, hq, g, hd, pairs),
            plain=lambda: fa.flash_attention_bwd_ref(q, k, v, do, lse, di, **kw),
            lib=lambda: torch.autograd.grad(lib_out, lib_leaves, do.transpose(1, 2),
                                            retain_graph=True))
    return rows


# K3's fused decode prologue at nlp_medium's heads (Hq 24, G 8, hd 60 stored
# as 64) at the main path's B=16 (dense cache [20,16,8,64,544]).
PROLOGUE_HQ, PROLOGUE_G, PROLOGUE_HD, PROLOGUE_HDP = 24, 8, 60, 64


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


def _table_cost(b, hq, g, hd, paged, table_rows=None):
    """(bytes, fp32 operations) of one table-mode call: the q, k, v rows and
    the (cos, sin) rows (``table_rows``; by default one shared row dense,
    one a row paged) read once; q and the k, v columns (dense) or q and k
    (paged) written once.  Per q/k element a square, an add and a division
    (the norm); per pair 4 products and 2 sums."""
    es = 2  # bf16
    rows = table_rows or (b if paged else 1)
    read = b * (hq + 2 * g) * hd * es + 2 * rows * hd // 2 * 4 + (4 * b if paged else 4)
    write = b * (hq + g) * hd * es if paged else b * (hq + 2 * g) * hd * es
    n = b * (hq + g) * hd
    return read + write, n * 3 + n // 2 * 6


def _table_inputs(gen, b, hq, g, hd):
    import torch

    row = torch.randn((b, 1, (hq + 2 * g) * hd), generator=gen, device="cuda").to(torch.bfloat16)
    return (x.reshape(b, 1, -1, hd) for x in torch.split(row, [hq * hd, g * hd, g * hd], -1))


def time_k3(gen):
    """K3's fused prologue, dense and paged, at the LM's B=16 beside the
    chain it replaced (the plain version); its table mode at the image
    decode (B=4, '2d_ntk'), the multimodal decode (B=4, a row of text,
    image, video, video) and code_chat_8k's full layers (B=64, Mellum2's
    YaRN table, no QK-norm) beside the chain given the table; its append
    mode at video_gen_large's temporal cache beside the plain version and
    two ``scatter_``.  Each against its plain version: q and the written k
    within PROLOGUE_ULPS, v (and the dense cache's v) bit-equal; the
    append's cache bit-equal.  Bounds at the fp32 peak (the prologue's
    arithmetic is fp32 outside the tensor cores).  Returns {row name:
    row}."""
    import torch

    from torch_card_parity import PROLOGUE_ULPS

    from vats_tpu_torch.configs import mellum2_12b, multimodal_small
    from vats_tpu_torch.nn.rope import (
        rope_2d_ntk_cos_sin,
        rope_inv_freq,
        rope_table_cos_sin,
        yarn_inv_freq,
    )
    from vats_tpu_torch.ops import cache_append as ca

    def ulps(qk_norm):
        return dict(ulps=PROLOGUE_ULPS[(torch.bfloat16, qk_norm)], bits=7)

    def dense_row(fn, q, k, v, caches, length, col, hd, **kw):
        """The dense call into ``caches`` (layer 5; no ring, so it writes
        column ``col`` = the length): q and the written k column at the
        logical head dim, and the v cache."""
        kc, vc = caches
        return fn(q, k, v, kc, vc, length, 5, **kw)[..., :hd], kc[5, ..., :hd, col], vc[5]

    out = {}
    g, hdp, b = PROLOGUE_G, PROLOGUE_HDP, 16
    inv = rope_inv_freq(PROLOGUE_HD, 10000.0, device="cuda")
    q, k, v = _prologue_inputs(gen, b, torch.bfloat16)
    cache_k = [torch.zeros((20, b, g, hdp, 544), dtype=torch.bfloat16, device="cuda")
               for _ in range(2)]
    cache_p = [torch.zeros_like(c) for c in cache_k]
    length = torch.tensor(300, dtype=torch.int32, device="cuda")
    lens = torch.randint(300, 513, (b,), generator=gen, device="cuda").to(torch.int32)
    kw = dict(theta=1e4, qk_norm=True)
    out["dense_decode_prologue"] = timing_row(
        f"K3 dense prologue B={b}",
        lambda: dense_row(ca.dense_decode_prologue, q, k, v, cache_k, length, 300, PROLOGUE_HD,
                          inv_freq=inv, ring=False, **kw),
        _prologue_cost(b, False),
        plain=lambda: dense_row(ca.dense_decode_prologue_ref, q, k, v, cache_p, length, 300,
                                PROLOGUE_HD, ring=False, **kw),
        fp32=True, close=(ulps(True), ulps(True), "equal"))
    out["paged_decode_prologue"] = timing_row(
        f"K3 paged prologue B={b}", lambda: ca.paged_decode_prologue(q, k, v, lens, inv, **kw),
        _prologue_cost(b, True), plain=lambda: ca.paged_decode_prologue_ref(q, k, v, lens, **kw),
        fp32=True, close=(ulps(True), ulps(True), "equal"))

    # table mode: (label, heads, b, dense cache slots, table rows, the dense
    # call's and the paged call's (cos, sin) tables, lengths, QK-norm)
    img_len = torch.tensor(100, dtype=torch.int32, device="cuda")
    img_lens = torch.randint(0, 257, (4,), generator=gen, device="cuda").to(torch.int32)
    img_table = lambda pos: rope_2d_ntk_cos_sin(pos, 24, 16, 10000.0, 0.7)  # noqa: E731
    mm = multimodal_small()
    mm_cs = multimodal_rope_table(mm, 4)
    mm_lens = torch.randint(64, 2368, (4,), generator=gen, device="cuda").to(torch.int32)
    mel = mellum2_12b()
    mel_lens = torch.tensor(CODE_CHAT_LENGTHS, dtype=torch.int32, device="cuda")
    mel_cs = rope_table_cos_sin(mel_lens[:, None], yarn_inv_freq(
        mel.head_dim, mel.rope_base, mel.yarn_factor, mel.yarn_original_max_position,
        mel.yarn_beta_fast, mel.yarn_beta_slow, device="cuda"), mel.yarn_attention_factor)
    tables = (
        ("image", (32, 4, 24), 4, 256, None, img_table(img_len + torch.arange(1, device="cuda")),
         img_table(img_lens[:, None]), img_lens, True),
        ("multimodal", (8, 4, 96), 4, 2368, 4, mm_cs, mm_cs, mm_lens, True),
        ("code_chat_8k YaRN", (mel.num_heads, mel.query_groups, mel.head_dim),
         len(CODE_CHAT_LENGTHS), None, None, None, mel_cs, mel_lens, False))
    for label, (hq, g, hd), b, slots, rows, cs_d, cs_p, lens, qk_norm in tables:
        q, k, v = _table_inputs(gen, b, hq, g, hd)
        kw = dict(theta=1e4, qk_norm=qk_norm)
        lim = (ulps(qk_norm), ulps(qk_norm), "equal")
        if slots:
            cache_k = [torch.zeros((12, b, g, hd, slots), dtype=torch.bfloat16, device="cuda")
                       for _ in range(2)]
            cache_p = [torch.zeros_like(c) for c in cache_k]
            out[f"dense table {label}"] = timing_row(
                f"K3 table dense, {label} decode B={b}",
                lambda: dense_row(ca.dense_decode_prologue, q, k, v, cache_k, img_len, 100, hd,
                                  inv_freq=None, ring=False, cos_sin=cs_d, **kw),
                _table_cost(b, hq, g, hd, False, rows),
                plain=lambda: dense_row(ca.dense_decode_prologue_ref, q, k, v, cache_p, img_len,
                                        100, hd, ring=False, cos_sin=cs_d, **kw),
                fp32=True, close=lim)
        out[f"paged table {label}"] = timing_row(
            f"K3 table paged, {label} decode B={b}",
            lambda: ca.paged_decode_prologue(q, k, v, lens, None, cos_sin=cs_p, **kw),
            _table_cost(b, hq, g, hd, True, rows),
            plain=lambda: ca.paged_decode_prologue_ref(q, k, v, lens, cos_sin=cs_p, **kw),
            fp32=True, close=lim)

    # the append mode at video_gen_large's temporal cache (B=1 over a 16 x 16
    # latent grid: 256 rows; 4 KV groups of head dim 144; 15 slots; 20 layers)
    shape = (20, 256, 4, 144, 15)
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
    k, v, kn, vn = mk(*shape), mk(*shape), mk(*shape[1:4]), mk(*shape[1:4])
    kp, vp = k.clone(), v.clone()  # the plain version's
    length = torch.tensor(7, dtype=torch.int32, device="cuda")
    idx = torch.full((*shape[1:4], 1), 7, dtype=torch.int64, device="cuda")

    def scatter():
        k[5].scatter_(-1, idx, kn[..., None])
        v[5].scatter_(-1, idx, vn[..., None])

    def append(fn, k, v):
        fn(k, v, 5, kn, vn, length)
        return k, v

    out["dense_cache_append"] = timing_row(
        f"K3 append at the video cache {list(shape)}",
        lambda: append(ca.append_token_inplace, k, v),
        (2 * kn.numel() * 2 * 2 + 4, 0),  # the new K/V read, the same written
        plain=lambda: append(ca.append_token_ref, kp, vp), lib=scatter, close="equal")
    return out


def multimodal_rope_table(cfg, b):
    """A (cos, sin) table [b, 1, hd/2] whose rows are text, image, video,
    video tokens (``multimodal_rope_angles`` on the card)."""
    import torch

    from vats_tpu_torch.models.multimodal import multimodal_rope_angles

    mod = torch.tensor([0, 1, 2, 2] * (b // 4 + 1), dtype=torch.int32, device="cuda")[:b, None]
    loc = torch.tensor([63, 200, 1500, 2047] * (b // 4 + 1), dtype=torch.int32,
                       device="cuda")[:b, None]
    return multimodal_rope_angles(cfg, mod, loc)


# K6 shapes: (label, bucket, starts, valid tail lengths).  decode_heavy's
# grouped prefills (nlp_medium's attention; 32 pages of 128 a row; its
# prompts are distinct, so every tail starts at 0), and one row behind a
# 1024-token prefix hit.
K6_SHAPES = (("B=1 bucket 512", 512, (0,), (300,)),
             ("B=2 bucket 512", 512, (0, 0), (300, 480)),
             ("B=1 bucket 128", 128, (0,), (100,)),
             ("B=1 bucket 512 after a 1024-token prefix hit", 512, (1024,), (300,)))
# code_chat_8k's prefills (Mellum2's heads, hd 128; 64 pages a row): the
# 8,192-token budget as 4 prompts at the 2,048 bucket and one at 6,144, each
# with the window of its 21 sliding layers (1023) and without (the full
# layers)
K6_HYBRID_SHAPES = (("Mellum2 B=4 bucket 2048", 2048, (0, 0, 0, 0), (2048, 1700, 1100, 1025)),
                    ("Mellum2 B=1 bucket 6144", 6144, (0,), (5000,)))


def _k6_work(starts, tails, t, left_window):
    """(keys, pairs) of a K6 call: the keys each row must read (from its
    first query's first key, to its last valid one) and the (query, key)
    pairs its queries attend, causal and within ``left_window`` when >= 0."""
    keys = pairs = 0
    for s_, n_ in zip(starts, tails):
        first = s_ if left_window < 0 else min(s_, left_window)
        keys += first + n_
        for i in range(t):
            lo = 0 if left_window < 0 else max(0, s_ + i - left_window)
            pairs += max(0, min(s_ + i, s_ + n_ - 1) - lo + 1)
    return keys, pairs


def time_k6(gen):
    """K6 at decode_heavy's prefills and at code_chat_8k's (each with its
    window and without), against its plain version (every page gathered,
    fp32 scores and softmax; ``torch_card_parity.check_paged_prefill``) and
    a second launch bit for bit, beside SDPA over the window's keys gathered dense
    (causal, no page table, no key mask) where the tail starts at 0 and
    nothing is windowed, and its bound (bytes: q, out and the K/V of each
    row's keys from its first query's first key to its last valid one, at
    hd; operations: the pairs its queries attend).  Returns the first
    shape's row, every row under its label."""
    import torch

    from torch_card_parity import check_paged_prefill
    from vats_tpu_torch.ops.decode_attention import PagedKVCache
    from vats_tpu_torch.ops.paged_prefill_attention import (
        paged_prefill_attention,
        paged_prefill_attention_ref,
    )

    rows = {}
    for shapes, (g, n, hd, hdp), pps, windows in (
            (K6_SHAPES, LM_HEADS, 32, (-1,)),
            (K6_HYBRID_SHAPES, MELLUM_HEADS, 64, (1023, -1))):
        hq, scale = g * n, hd**-0.5
        for label, t, starts, tails in shapes:
            b = len(starts)
            pool = torch.randn((2, 1 + b * pps, 2, g, DECODE_PS, hdp), generator=gen,
                               device="cuda").to(torch.bfloat16)
            pool[..., hd:] = 0
            table = (1 + torch.randperm(b * pps, generator=gen, device="cuda")).to(
                torch.int32).reshape(b, pps)
            lengths = torch.tensor(starts, dtype=torch.int32, device="cuda")
            mask = (torch.arange(t, device="cuda")[None, :]
                    < torch.tensor(tails, device="cuda")[:, None])
            q = torch.randn((b, t, hq, hdp), generator=gen, device="cuda").to(torch.bfloat16)
            q[..., hd:] = 0
            vmax = float(pool[1, :, 1].float().abs().max())
            i = torch.arange(t, device="cuda")[None, :]
            last = lengths[:, None] + torch.tensor(tails, device="cuda")[:, None] - 1
            for lw in windows:
                kw = dict(scale=scale, window_mask=mask, left_window=lw)
                kern = lambda: paged_prefill_attention(  # noqa: E731
                    q, pool, 1, table, lengths, **kw)
                # a query attends a key unless its window holds none (a
                # padding query further than left_window past the tail)
                first = (lengths[:, None] + i - lw).clamp(min=0) if lw >= 0 else 0
                attends = (torch.minimum(lengths[:, None] + i, last) >= first)[..., None, None]

                def close(label, got, want):
                    require(torch.equal(got, kern()), f"{label}: two launches differ")
                    return check_paged_prefill(label, got, want, attends, vmax)

                lib = None
                if not any(starts) and lw < 0:
                    k_t, v_t = PagedKVCache(pool, table, lengths).gather_dense_t(1)
                    kt, vt = (x[..., :hd, :t].transpose(2, 3).contiguous() for x in (k_t, v_t))
                    qt = q[..., :hd].transpose(1, 2).contiguous()
                    lib = lambda: _sdpa(qt, kt, vt, scale)  # noqa: E731
                keys, pairs = _k6_work(starts, tails, t, lw)
                tag = f"K6 {label} tails {tails} left_window {lw}"
                rows[tag] = timing_row(
                    f"{tag} ({pairs} pairs, {keys} keys)", kern,
                    (2 * b * t * hq * hd * 2 + keys * 2 * g * hd * 2, 4 * hq * hd * pairs),
                    plain=lambda: paged_prefill_attention_ref(q, pool, 1, table, lengths, **kw),
                    lib=lib, alone="paged_prefill", close=close)
                del lib
            del pool
            torch.cuda.empty_cache()
    return headline(rows)


# K7's shapes: (label, n tokens, d, f, E, k), the main path's: decode_heavy
# (vats_medium_e8) and code_chat_8k (Mellum2), a decode step's 64 rows and a
# prefill (1,024 tokens; Mellum2's budget of 8,192)
K7_SHAPES = (("decode_heavy decode", 64, 1440, 5760, 8, 2),
             ("decode_heavy prefill", 1024, 1440, 5760, 8, 2),
             ("code_chat_8k decode", 64, 2304, 896, 64, 8),
             ("code_chat_8k prefill", 8192, 2304, 896, 64, 8))


def time_k7(gen):
    """K7's routed path (plan, gather, K7a, K7b, combine) at the main path's
    shapes: the whole path, K7 alone, the plain version (fp32 products an
    expert), the bound (the routed experts' weights once, and 6 n k d f
    operations) and the library yardsticks: the padded path (the lossless
    sort dispatch, every token in each expert's buffer, cuBLAS bmm) and
    ``torch._grouped_mm`` over the routed rows where the card's torch has
    it.  First the path stage by stage against its plain versions
    (``torch_card_parity.check_routed_experts``: plan, gather and combine
    bit for bit, K7a and K7b within TOL), and a second call of the whole
    path bit for bit.  Returns the first shape's row, every row under its
    label."""
    import torch

    from torch_card_parity import check_routed_experts
    from vats_tpu_torch.nn.moe import ExpertSwiGLU, MoELayer
    from vats_tpu_torch.ops import moe_grouped as mg

    rows = {}
    for label, n, d, f, e, k in K7_SHAPES:
        x = torch.randn((n, d), generator=gen, device="cuda").to(torch.bfloat16)
        ws = [(torch.randn(shape, generator=gen, device="cuda") * shape[1] ** -0.5).to(
            torch.bfloat16) for shape in ((e, d, f), (e, d, f), (e, f, d))]
        logits = torch.randn((n, e), generator=gen, device="cuda")
        probs, idx = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True, stable=True)
        w = (probs[:, :k] / probs[:, :k].sum(-1, keepdim=True)).to(torch.bfloat16)
        idx = idx[:, :k]
        plan = mg.route_plan(idx, w, e)
        rows_in = x[plan.row_tok.long()]
        experts = ExpertSwiGLU(d, f, e, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                               device="cuda")
        with torch.no_grad():
            for p, src in zip((experts.w_gate, experts.w_up, experts.w_down), ws):
                p.copy_(src)
        layer = MoELayer(d, f, e, k, dispatch="sort", dtype=torch.bfloat16,
                         param_dtype=torch.bfloat16, device="meta")
        grouped_ms, why = None, "torch._grouped_mm absent"
        if hasattr(torch, "_grouped_mm"):
            offs = torch.cumsum(plan.counts, 0).to(torch.int32)
            try:
                def grouped():
                    gate = torch._grouped_mm(rows_in, ws[0], offs=offs)
                    up = torch._grouped_mm(rows_in, ws[1], offs=offs)
                    return torch._grouped_mm(torch.nn.functional.silu(gate) * up, ws[2],
                                             offs=offs)
                grouped_ms, why = device_ms(grouped, iters=5), "torch._grouped_mm"
            except (RuntimeError, TypeError, ValueError) as exc:
                why = f"torch._grouped_mm refused: {str(exc).splitlines()[0][:120]}"
        live = int((plan.counts > 0).sum())

        def close(tag, got, _):
            require(torch.equal(got, mg.routed_experts(x, w, idx, *ws)),
                    f"{tag}: two calls differ")
            return check_routed_experts(tag, x, w, idx, *ws, e)

        with torch.no_grad():
            rows[label] = timing_row(
                f"K7 routed experts {label} (n={n}, d={d}, f={f}, E={e}, top-{k}; {live} "
                f"experts routed; library: the padded sort dispatch; {why})",
                lambda: mg.routed_experts(x, w, idx, *ws),
                (live * 3 * d * f * 2 + 2 * n * d * 2, 6.0 * n * k * d * f),
                plain=lambda: mg.combine_rows_ref(mg.moe_grouped_gemm_ref(
                    mg.moe_grouped_gemm_ref(rows_in, plan.counts, ws[0], w_up=ws[1]),
                    plan.counts, ws[2], row_w=plan.row_w), plan.inv, n, k),
                lib=lambda: layer._sort_dispatch(x, w, idx, n, experts), alone="moe_grouped_wgmma",
                iters=3, close=close, grouped_mm_ms=grouped_ms)
        del x, ws, rows_in, experts
        torch.cuda.empty_cache()
    return headline(rows)


# K9 at v2lite.reasoning_256's decode: 256 rows, 16 heads over the 576-wide
# latent (values 512), lengths drawn log-normal about the cell's mean
# settled length (prompts median 1536 + half an answer of median 2048) in
# [1, 12288], the tiles' edges first; and one row alone at full context.
K9_SHAPES = (("v2lite decode B=256", 256, (1, 64, 65, 128, 129, 512, 513, 12288), 2600),
             ("B=1 at 12288", 1, (12288,), None))


def time_k9(gen):
    """K9 (``ops/mla_decode.py``) at the cell's decode shapes against its
    plain version (within TOL plus ``torch_card_parity.mla_p_allowance``),
    a second call bit for bit, then timed: the call, K9 alone, the plain
    version and the bound (each row's latent vectors once, q in and the
    latent output out; ``benchmark/work_mla.py``).  No library call pages
    through a table."""
    import torch

    from benchmark import work_mla
    from torch_card_parity import TOL, check_close, mla_p_allowance
    from vats_tpu_torch.configs import deepseek_v2_lite
    from vats_tpu_torch.ops import mla_decode as md

    cfg = deepseek_v2_lite()
    m = dict(num_heads=cfg.num_heads, kv_lora_rank=cfg.kv_lora_rank,
             qk_rope_head_dim=cfg.qk_rope_head_dim)
    w, r, ps, pps = cfg.latent_dim, cfg.kv_lora_rank, 128, 96
    rows = {}
    for label, b, fixed, median in K9_SHAPES:
        lens = list(fixed)
        if median is not None:
            draw = torch.exp(torch.log(torch.tensor(float(median))) + 0.6 * torch.randn(
                (b - len(fixed),), generator=gen, device="cuda"))
            lens += draw.round().clamp(1, ps * pps).long().tolist()
        lengths = torch.tensor(lens[:b], dtype=torch.int32, device="cuda")
        pages = torch.randn((2, b * pps + 1, ps, w), generator=gen, device="cuda").to(
            torch.bfloat16)
        table = (1 + torch.randperm(b * pps, generator=gen, device="cuda")).to(
            torch.int32).reshape(b, pps)
        q = torch.randn((b, cfg.num_heads, w), generator=gen, device="cuda").to(torch.bfloat16)
        scale = cfg.softmax_scale
        call = lambda: md.mla_decode_attention(q, pages, 1, table, lengths,  # noqa: E731
                                               scale=scale, v_dim=r)
        plain = lambda: md.mla_decode_attention_ref(q, pages[1], table, lengths,  # noqa: E731
                                                    scale=scale, v_dim=r)
        limit = dict(TOL[torch.bfloat16],
                     extra=mla_p_allowance(q, pages[1], table, lengths, scale, r))

        def close(tag, got, want):
            require(torch.equal(got, call()), f"{tag}: two calls differ")
            return check_close(tag, got, want, limit)

        with torch.no_grad():
            rows[label] = timing_row(
                f"K9 {label} (16 heads, latent {w}, values {r}; {int(lengths.sum())} keys)",
                call, work_mla.mla_decode_cost(m, lens[:b]), plain=plain,
                alone="mla_decode_kernel", iters=5, close=close)
        del pages, q
        torch.cuda.empty_cache()
    return headline(rows)


def time_k8(gen):
    """K8 at vats_medium_moe's 122 leaves (0.749B fp32 params, bf16 mu, the
    training cells' AdamW): the update of train_short_512's step, the
    accumulation step of train_packed_2k's micro-steps and its boundary's
    update, which resets the accumulator in the same pass.  Each first
    against its plain per-leaf version bit for bit
    (``torch_card_parity.check_adamw`` / ``check_accumulate``), then timed:
    the wrapper's call, K8 alone, the plain chain and the bound, the bytes
    the step needs over 3.35 TB/s (counted here: 24 a parameter for an
    update, p, g, mu and nu read and p, mu and nu written; 28 with the
    reset; 12 for an accumulation step, g and acc read and acc written).
    One launch each.  Returns the update's row, every row under its label."""
    import torch

    from torch_card_parity import check_accumulate, check_adamw
    from vats_tpu_torch.models import TextLM
    from vats_tpu_torch.ops import adamw as aw
    from vats_tpu_torch.train.optimizer import (
        AdamW,
        clip_scale,
        cosine_with_warmup_schedule,
        global_norm,
    )

    params = [p.detach() for p in TextLM(train_cfg("medium_moe"), device="cuda",
                                         seed=0).parameters()]
    n = sum(p.numel() for p in params)
    opt = AdamW(cosine_with_warmup_schedule(6e-4, 1000, 20000), b1=0.9, b2=0.95, eps=1e-6,
                weight_decay=5e-4, mu_dtype=torch.bfloat16)
    st = opt.init(dict(enumerate(params)))
    st.count.fill_(100)
    mus, nus = list(st.mu.values()), list(st.nu.values())
    for p, mu, nu in zip(params, mus, nus):
        mu.copy_(torch.randn(p.shape, generator=gen, device="cuda") * 1e-3)
        nu.copy_(torch.randn(p.shape, generator=gen, device="cuda").square() * 1e-6)
    grads = [torch.randn(p.shape, generator=gen, device="cuda") * 1e-3 for p in params]
    accs = [g.clone() for g in grads]
    finite, scale = clip_scale(global_norm(dict(enumerate(grads))), 1.0)
    k = opt.coefficients(st.count, finite)
    tables, reset_tables, acc_tables = aw.LeafTables(), aw.LeafTables(), aw.LeafTables()
    check_adamw("K8 update", opt, st.count, (params, grads, mus, nus), scale, finite,
                tables=tables)
    check_accumulate("K8 accumulation", accs, grads, 3, acc_tables)
    check_adamw("K8 boundary update", opt, st.count, (params, accs, mus, nus), scale, finite,
                reset_grads=True, tables=reset_tables)

    def update(ref=False, reset=False):
        g = accs if reset else grads
        if ref:
            return lambda: aw.adamw_update_ref(params, g, mus, nus, k, opt.eps,
                                               opt.weight_decay, scale, finite, reset)
        return lambda: aw.adamw_update_(params, g, mus, nus, k, opt.eps, opt.weight_decay,
                                        tables=reset_tables if reset else tables, scale=scale,
                                        finite=finite, reset_grads=reset)

    ops = 17.0 * n  # fp32 operations an element of the update (3 of accumulation)
    rows = {}
    with torch.no_grad():
        for label, kern, plain, cost, alone in (
                ("update", update(), update(ref=True), (24.0 * n, ops), "adamw_update_kernel"),
                ("accumulation", lambda: aw.accumulate_(accs, grads, 3, tables=acc_tables),
                 lambda: aw.accumulate_ref(accs, grads, 3), (12.0 * n, 3.0 * n),
                 "accumulate_kernel"),
                ("boundary update (+ reset)", update(reset=True), update(ref=True, reset=True),
                 (28.0 * n, ops), "adamw_update_kernel")):
            rows[label] = timing_row(
                f"K8 {label} at vats_medium_moe's {len(params)} leaves ({n} params)", kern, cost,
                plain=plain, alone=alone, fp32=True, iters=5, launches_per_update=1,
                bit_equal_to_plain=True)
    del params, grads, accs, st, mus, nus, tables, reset_tables, acc_tables
    torch.cuda.empty_cache()
    return headline(rows)


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


TRAIN_TURN_STEPS = 3  # steps a turn of train_turns (graph, then eager)


def k8_tally_gate(label, txs, leaves):
    """Every leaf of the last update or accumulation step of each of
    ``txs`` (an AdamW or a MultiSteps) went through K8, none through the
    plain per-leaf code."""
    got = [(type(tx).__name__, tx.leaves_fused, tx.leaves_plain) for tx in txs]
    require(all(f == leaves and p == 0 for _, f, p in got),
            f"{label}: K8's tally (leaves fused, plain) {got}, want ({leaves}, 0)")


def tally_names(step_graph) -> dict:
    """{kernel wrapper's name: launches} a replay of ``step_graph`` adds."""
    return {fn.__name__: n for fn, n in step_graph.tally.items()}


def tally_gate(label, step_graph, want, phase):
    """Hold the launches a replay of ``step_graph`` adds to ``want``."""
    got = tally_names(step_graph)
    _gate(f"{label} (a replay's tally)", {k: got.get(k, 0) for k in want}, want, phase=phase)


def train_turns(label, graph_sets, tensors, run, fns, want, n, host=None, exact=None):
    """A train program from its graphs, then eagerly, each turn ``n`` steps
    from one snapshot of the state, restored in place: ``tensors`` (the
    state's and the model's buffers) and ``host`` (get, set) of host state
    (the accumulation position, a trainer's seed generator).  ``run(n)``
    runs n steps and returns their metrics as a list of numbers or 0-d
    tensors; ``graph_sets`` are the step's ``TrainGraphs`` (``use_graph``
    off for the eager turn).  Gates: each turn's launches of ``fns`` are n x
    ``want``; the eager turn's state and metrics are bit-equal to the graph
    turn's.  ``exact``: a context (``cudnn_deterministic``) without which
    the two paths are not bit-equal; both turns then run in it, from graphs
    captured again in it.  Returns the graph turn's launches."""
    import torch

    snap = [t.detach().clone() for t in tensors]
    saved = host[0]() if host else None

    def restore(use_graph):
        with torch.no_grad():
            for t, x in zip(tensors, snap):
                t.copy_(x)
        if host:
            host[1](saved)
        for g in graph_sets:
            g.use_graph = use_graph

    def turn(use_graph):
        path = "graph" if use_graph else "eager"
        restore(use_graph)
        _zero(fns)
        metrics = [float(x) for x in run(n)]
        torch.cuda.synchronize()
        got = _counts(fns)
        _gate(f"{label} [{path}] {n} steps", got, {k: v * n for k, v in want.items()},
              phase="train")
        require(all(np.isfinite(metrics)), f"{label} [{path}]: metrics {metrics}")
        return got, metrics, [t.detach().clone() for t in tensors]

    with exact() if exact else contextlib.nullcontext():
        if exact:  # drop the graphs captured outside the context; capture them in it
            for g in graph_sets:
                g.clear()
            gc.collect()
            torch.cuda.synchronize()
            restore(True)
            run(1)
        (got, m_graph, s_graph), (_, m_eager, s_eager) = turn(True), turn(False)
    for g in graph_sets:
        g.use_graph = True
    diff = [i for i, (a, b) in enumerate(zip(s_graph, s_eager)) if not torch.equal(a, b)]
    require(m_graph == m_eager and not diff,
            f"{label}: eager not bit-equal to the graph turn: metrics {m_eager} against "
            f"{m_graph}; {len(diff)} of {len(tensors)} state tensors differ, the first at "
            f"{diff[:4]} of shapes {[tuple(tensors[i].shape) for i in diff[:4]]}")
    return got


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms: its default convolution backward
    may add with atomics, which no two runs share, so graph and eager are
    compared bit for bit in this context."""
    import torch

    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


def run_train(counters):
    """medium_dense and medium_moe through ``make_train_step``: the first
    call (the warm-up, a real step, and the capture), then graph and eager
    from one snapshot (``train_turns``).  Returns the launches of a graph
    turn (TRAIN_TURN_STEPS steps)."""
    import math

    import torch

    from vats_tpu_torch.data import synthetic_lm_batches
    from vats_tpu_torch.models import TextLM
    from vats_tpu_torch.train import create_optimizer, create_train_state, make_train_step
    from vats_tpu_torch.train.step_graphs import state_tensors

    B, T, n = TRAIN_B, TRAIN_T, TRAIN_TURN_STEPS
    targs = train_args()
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = None
    for tier in ("medium_dense", "medium_moe"):
        cfg = train_cfg(tier)
        L = cfg.num_layers
        model = TextLM(cfg, device="cuda", seed=0)
        state = create_train_state(model, create_optimizer(targs, 1000))
        step = make_train_step(model, targs)
        batches = list(synthetic_lm_batches(gen, vocab_size=cfg.vocab_size, batch_size=B,
                                            seq_len=T, num_batches=n + 2))
        state, m = step(state, batches[0], 100)  # the warm-up step and the capture
        torch.cuda.synchronize()
        require(int(state.step) == 1 and len(step.graphs) == 1,
                f"train: {tier}: after the first call step {int(state.step)}, "
                f"{len(step.graphs)} graphs")
        graph = step.graphs[next(iter(step.graphs))]
        want = {"flash_attention_lse": 2 * L, "flash_bwd_dkv": L, "flash_bwd_dq": L,
                "flash_attention": 0, "adamw_update_": 1, "accumulate_": 0}
        tally_gate(f"{tier} graph", graph, want, "train")

        def run(k):
            ms = [step(state, batches[1 + i], 101 + i)[1] for i in range(k)]
            return [x[key] for x in ms for key in sorted(x)]

        got = train_turns(f"train: {tier}", [step.graphs],
                          state_tensors(state, list(model.buffers())), run, counters, want, n)
        require(int(state.step) == 1 + n and int(state.skipped_steps) == 0,
                f"train: {tier}: step {int(state.step)} after 1 + {n} calls, skipped "
                f"{int(state.skipped_steps)}")
        k8_tally_gate(f"train: {tier}", [state.tx], len(state.params))
        metrics = step(state, batches[-1], 200)[1]
        aux = float(metrics["aux_loss"])
        require(math.isfinite(aux) and (aux > 0) == (cfg.num_experts > 1),
                f"train: {tier}: aux loss {aux}")
        log(f"train: {tier} d{cfg.d_model}/{L}L E{cfg.num_experts} top-{cfg.top_k}, B={B} "
            f"T={T}: launches over a graph turn of {n} steps {json.dumps(got)}, a replay's "
            f"tally {json.dumps(tally_names(graph))}; graph and eager bit-equal; loss "
            f"{float(metrics['loss']):.4f} aux {aux:.4f}")
        out = out or got
        del model, state, step, batches, graph
        torch.cuda.empty_cache()
    run_train_accum(counters, gen)
    return out


TRAIN_ACCUM = 4  # TrainingArgs' default grad_accum_steps


def run_train_accum(counters, gen):
    """medium_dense at grad_accum_steps=4, the default: one graph a window
    position, against eager over one window (``train_turns``' gates)."""
    import torch

    from vats_tpu_torch.data import synthetic_lm_batches
    from vats_tpu_torch.models import TextLM
    from vats_tpu_torch.train import create_optimizer, create_train_state, make_train_step
    from vats_tpu_torch.train.step_graphs import (
        accumulation_position,
        set_accumulation_position,
        state_tensors,
    )

    B, T, k = TRAIN_B, TRAIN_T, TRAIN_ACCUM
    targs = train_args(grad_accum_steps=k)
    cfg = train_cfg("medium_dense")
    L = cfg.num_layers
    model = TextLM(cfg, device="cuda", seed=0)
    state = create_train_state(model, create_optimizer(targs, 1000))
    step = make_train_step(model, targs)
    batches = list(synthetic_lm_batches(gen, vocab_size=cfg.vocab_size, batch_size=B,
                                        seq_len=T, num_batches=k))
    for i, batch in enumerate(batches):
        step(state, batch, 300 + i)  # each position's warm-up step and capture
    torch.cuda.synchronize()
    require(len(step.graphs) == k and int(state.step) == k
            and accumulation_position(state) == 0,
            f"train: medium_dense accumulation: {len(step.graphs)} graphs, step "
            f"{int(state.step)}, position {accumulation_position(state)} after {k} calls")
    want = {"flash_attention_lse": 2 * L, "flash_bwd_dkv": L, "flash_bwd_dq": L,
            "flash_attention": 0, "accumulate_": 1}

    def run(n):
        ms = [step(state, batches[i % k], 310 + i)[1] for i in range(n)]
        return [x[key] for x in ms for key in sorted(x)]

    label = f"train: medium_dense grad_accum_steps={k}"
    got = train_turns(label, [step.graphs], state_tensors(state, list(model.buffers())), run,
                      counters, want, k, host=(lambda: accumulation_position(state),
                                               lambda pos: set_accumulation_position(state, pos)))
    _gate(f"{label}: K8's update a window", got, {"adamw_update_": 1}, phase="train")
    k8_tally_gate(label, [state.tx, state.tx.inner.inner], len(state.params))
    log(f"train: medium_dense grad_accum_steps={k}: {k} graphs, one a window position; "
        f"launches over a window {json.dumps(got)}; graph and eager bit-equal")
    del model, state, step, batches
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


def run_main(counters):
    import torch

    from vats_tpu_torch.configs import GenerationArgs
    from vats_tpu_torch.inference import TokenGenerator, generate_paged
    from vats_tpu_torch.inference.generate import _generate, _generate_paged
    from vats_tpu_torch.models import TextLM

    cfg = medium_cfg()
    B, T, steps, rc = 16, 512, 32, 8
    model = TextLM(cfg, device="cuda", seed=0).eval()
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
    # K1, its dense mode on the dense cache), and no append-only K3; every
    # prefill here writes a fresh cache (the row chunks too: each starts
    # fresh), so K2 attends it and K6 never runs
    want = {
        "flash_attention": L * (1 + B // rc),
        "paged_prefill_attention": 0,
        "paged_decode_attention_commit": L * steps * 2,
        "paged_decode_prologue": L * steps * 2,
        "dense_decode_prologue": L * steps,
        "append_token_inplace": 0,
    }
    _gate("main drive", counts, want, phase="main")
    require(replays.n == 3 * (steps - 1), f"main: {replays.n} graph replays, not "
            f"{3 * (steps - 1)} (three calls, each step after the first)")
    want_len = mask.sum(1).to(torch.int32) + steps
    for tok, ln in ((tok_a, len_a), (tok_b, len_b)):
        require(tok.shape == (B, T + steps) and torch.equal(ln, want_len),
                "generate_paged returned wrong shapes or lengths")
        require(int(tok.min()) >= 0 and int(tok.max()) < cfg.vocab_size,
                "generate_paged emitted out-of-vocab ids")
    n_new = len(text.split())
    require(n_new == steps, f"TokenGenerator returned {n_new} tokens, not {steps}")
    log(f"main: launches {json.dumps(counts)} (expected {json.dumps(want)}); "
        f"{replays.n} graph replays")
    approx_sampling(model, ids, mask, counters, steps)

    # the decode loops from their graphs and eagerly: equal tokens (the
    # paged one sampled, each drawing from a generator of one seed; the
    # dense one greedy at B=1, a 40-token prompt in a 64 bucket, as the
    # TokenGenerator calls it)
    sample = dict(temperature=0.8, top_k=50, top_p=None, do_sample=True,
                  repetition_penalty=None, approx_top_k=False)
    greedy = dict(sample, temperature=0.0, top_k=None, do_sample=False)
    ids1 = torch.zeros((1, 64), dtype=torch.int32, device="cuda")
    ids1[0, :40] = torch.tensor(StubTokenizer().encode(prompt), dtype=torch.int32)
    mask1 = torch.arange(64, device="cuda")[None, :] < 40
    for name, call in (
            ("generate_paged", lambda use_graph: _generate_paged(
                model, ids, mask, torch.Generator(device="cuda").manual_seed(77), sample,
                use_graph=use_graph, max_new_tokens=steps, pad_token_id=0, eos_token_id=None,
                total_len=None, page_size=128, kv_quant=None, prefill_row_chunk=None)),
            ("dense generate", lambda use_graph: _generate(
                tg.model, ids1, mask1, None, greedy, use_graph=use_graph, max_new_tokens=steps,
                pad_token_id=0, eos_token_id=None, total_len=64 + steps))):
        (tok_g, len_g, graph), (tok_e, len_e, _) = call(True), call(False)
        require(graph is not None and torch.equal(tok_g, tok_e) and torch.equal(len_g, len_e),
                f"main: {name} tokens differ between graph and eager")
        log(f"main: {name}: graph and eager tokens equal")
    prologue_in_graph(model, L, gen, steps)
    del model, tg
    torch.cuda.empty_cache()
    return counts


def approx_sampling(model, ids, mask, counters, steps):
    """``generate_paged`` at the main path's shape, sampled (temperature 0.8,
    top-k 50, top-p 0.9) with ``approx_top_k`` on and then off, each from a
    generator of one seed with the counters zeroed just before and read
    just after: equal tokens and lengths, and K1 and K3 (every counter)
    launched as often by both.  ``approx_top_k`` is JAX's
    ``lax.approx_max_k``, exact off the TPU, and selects the exact top-k."""
    import torch

    from vats_tpu_torch.inference import generate_paged

    kw = dict(max_new_tokens=steps, temperature=0.8, top_k=50, top_p=0.9, do_sample=True,
              pad_token_id=0, page_size=128)
    runs = {}
    for approx in (True, False):
        g = torch.Generator(device="cuda").manual_seed(4321)
        for c in counters:
            c.launches = 0
        tok, ln = generate_paged(model, ids, mask, g, approx_top_k=approx, **kw)
        torch.cuda.synchronize()
        runs[approx] = (tok, ln, {c.__name__: c.launches for c in counters})
    (tok_a, len_a, cnt_a), (tok_e, len_e, cnt_e) = runs[True], runs[False]
    require(torch.equal(tok_a, tok_e) and torch.equal(len_a, len_e),
            "main: approx_top_k sampled other tokens than the exact top-k")
    L = model.cfg.num_layers
    for name in ("paged_decode_attention_commit", "paged_decode_prologue"):
        require(cnt_a[name] == cnt_e[name] == L * steps,
                f"main: {name} launched {cnt_a[name]} (approx_top_k) / {cnt_e[name]} "
                f"(exact), expected {L * steps} each")
    require(cnt_a == cnt_e, f"main: launches differ with approx_top_k: {cnt_a} / {cnt_e}")
    log(f"main: sampled generate_paged with approx_top_k on / off from one seed: equal "
        f"tokens, launches {json.dumps(cnt_a)} both")


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
    RoPE).  Returns a line: device ms and kernels a layer, each."""
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


# --- phase: serve -----------------------------------------------------------

SERVE_ROWS, SERVE_CONTEXT, SERVE_PAGES, SERVE_BLOCK = 32, 1024, 129, 4


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
    """Submit the stream, step the engine to the end; returns {rid: tokens}."""
    import torch

    for prompt, n in stream:
        engine.submit(prompt, max_new_tokens=n)
    outs = {}
    while engine.queue or any(r is not None for r in engine.row_request):
        for req in engine.step():
            outs[req.rid] = req.output_ids
    torch.cuda.synchronize()
    return outs


# The serve phase's depth: nlp_medium's 20 layers cut to 2 (10 until the
# video and multimodal phases came, 5 until K6) so the whole script stays
# under 900 s; its eager drives are host-bound, and their time goes with
# the launches, with the depth.
SERVE_LAYERS = 2


def same_tokens(label, drives):
    """Every drive's tokens ({path: {rid: tokens}}) equal the first's."""
    (first, want), *rest = drives.items()
    for path, outs in rest:
        diff = [r for r in outs if outs[r] != want[r]]
        require(not diff, f"{label}: the {first} and {path} drives give other tokens for "
                f"requests {diff[:8]} (first difference at "
                f"{[common_prefix(outs[r], want[r]) for r in diff[:8]]})")


def run_serve(kernel_fns):
    import torch

    from torch_card_parity import serve_stream
    from vats_tpu_torch.inference import QuantizedModel, ServingEngine
    from vats_tpu_torch.models import TextLM

    cfg = medium_cfg(num_layers=SERVE_LAYERS)
    L = cfg.num_layers
    model = TextLM(cfg, device="cuda", seed=0).eval()
    stream = serve_stream(2024, cfg.vocab_size, 32, 32, 256, (44, 256), (300, 512), (32, 64))
    k1, k4 = kernel_fns["paged_decode_attention_commit"], kernel_fns[
        "paged_decode_attention_commit_int8"]
    engine_kw = dict(max_batch=SERVE_ROWS, max_context=SERVE_CONTEXT, page_size=128,
                     total_pages=SERVE_PAGES, prefix_caching=True,
                     decode_block_steps=SERVE_BLOCK)
    counts = {}
    for name, kv_quant in (("bf16 KV", None), ("int8 KV", "int8"),
                           ("int8 weights + int8 KV", "int8")):
        if name.startswith("int8 weights"):
            model = QuantizedModel(model)
        drives = {}
        for path, use_graphs, primed in (("graph", True, False), ("eager", False, False),
                                         ("graph primed", True, True)):
            # the hook counts in the captures (a primed engine's too), so it
            # is installed first and zeroed after the priming drive
            fwd = ForwardCount(model)
            eng = ServingEngine(model, kv_quant=kv_quant, **engine_kw)
            eng.graphs.use_graph = use_graphs
            before = prime(eng, stream) if primed else {}
            fwd.launches = 0
            _zero(kernel_fns.values())
            drives[path] = drive(eng, stream)
            got = _counts(kernel_fns.values())
            fwd.remove()
            check_serve(name, eng, drives[path], stream, cfg, got, fwd.launches, kv_quant, L,
                        k1, k4)
            if use_graphs:
                check_graph_runs(f"serve {name} [{path}]", eng, before)
            if path == "graph":
                counts[name] = got
                log(f"serve [{name}]: pages {eng.allocator.high_water}/"
                    f"{eng.allocator.capacity}, preemptions {eng.preemptions}, prefix hits "
                    f"{eng.prefix_cache.hit_tokens}/{eng.prefix_cache.query_tokens} tokens; "
                    f"forwards {json.dumps(eng.forwards)}; launches {json.dumps(got)}")
            del eng
        same_tokens(f"serve {name}", drives)
        log(f"serve [{name}]: graph, eager and primed graph drives give equal tokens")
        if name == "bf16 KV":
            serve_spec(model, stream, engine_kw, kernel_fns, L)
            k7_launches = serve_lossless(model, stream, engine_kw, kernel_fns, L)
    del model
    torch.cuda.empty_cache()
    # the kernels line reports the int8 KV run's launches for K4, the
    # lossless drive's for K7
    return {**counts["bf16 KV"], k4.__name__: counts["int8 KV"][k4.__name__],
            "moe_grouped_gemm": k7_launches}


# The mla phase: DeepSeek-V2-Lite whole (27 layers: its launch gates count
# every layer), a few rows of short prompts and answers.
MLA_ROWS, MLA_NEW = 8, 24


def run_mla(kernel_fns):
    """DeepSeek-V2-Lite at its published widths and depth (15.7B params,
    bf16, the benchmark's seeded weights) through ``ServingEngine``: ragged
    prompts (30-900 tokens) prefilled into the latent pool, answers from
    4-step decode blocks, from graphs and eagerly.  Exact gates: K9 27
    launches a decode forward (one a layer) and never in a prefill, its
    plain version never on the card, K7 52 a forward (two a layer of the
    26 expert layers), decode and prefill alike; the two drives' tokens
    equal."""
    import dataclasses as dc

    import torch

    from benchmark.reference.deepseek_v2 import make_params
    from vats_tpu_torch.configs import deepseek_v2_lite
    from vats_tpu_torch.inference import ServingEngine
    from vats_tpu_torch.models import TextLM

    cfg = deepseek_v2_lite()
    k9, k7 = kernel_fns["mla_decode_attention"], kernel_fns["moe_grouped_gemm"]
    model = TextLM(cfg, device="meta")
    model.load_state_dict(make_params(dc.asdict(cfg), 7, torch.bfloat16, "cuda"), assign=True)
    model.eval()
    gen = torch.Generator().manual_seed(2027)
    lens = torch.randint(30, 900, (MLA_ROWS,), generator=gen).tolist()
    stream = [(torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist(), MLA_NEW)
              for n in lens]
    drives, got = {}, {}
    for path, use_graph in (("graph", True), ("eager", False)):
        eng = ServingEngine(model, max_batch=MLA_ROWS, max_context=1024, page_size=128,
                            decode_block_steps=4, prompt_buckets=(256, 1024),
                            max_prefill_tokens=4096, per_request_sampling=True)
        eng.graphs.use_graph = use_graph
        for fn in (k9, k9.plain, k7):
            fn.launches = 0
        drives[path] = drive(eng, stream)
        dec, pre = eng.forwards["decode"], eng.forwards["prefill"]
        got[path] = {"mla_decode_attention": k9.launches, "moe_grouped_gemm": k7.launches}
        want = (cfg.num_layers * dec, 0, 2 * 26 * (dec + pre))
        require((k9.launches, k9.plain.launches, k7.launches) == want,
                f"mla [{path}]: K9, its plain version and K7 launched "
                f"{(k9.launches, k9.plain.launches, k7.launches)} times over {dec} decode and "
                f"{pre} prefill forwards, want {want}")
        require(all(len(drives[path][r]) == MLA_NEW for r in drives[path]),
                f"mla [{path}]: an answer is short")
        log(f"mla [{path}]: {dec} decode and {pre} prefill forwards; launches "
            f"{json.dumps(got[path])}; K9's plain version 0")
        del eng
    same_tokens("mla", drives)
    log("mla: graph and eager drives give equal tokens")
    del model
    torch.cuda.empty_cache()
    return got["graph"]


def serve_lossless(model, stream, engine_kw, kernel_fns, L):
    """The bf16-KV stream with every MoE layer lossless (capacity_factor -1,
    as the benchmark's serving cells route), from graphs and eagerly: the
    routed path runs every forward.  Gates: the two drives' tokens equal,
    every request whole, K7 twice a layer a prefill or decode forward (the
    engine's count), each layer's forwards resolved to 'routed'.  Returns
    the graph drive's K7 launches."""
    from vats_tpu_torch.inference import ServingEngine
    from vats_tpu_torch.nn.moe import MoELayer

    k7 = kernel_fns["moe_grouped_gemm"]
    layers = [m for m in model.modules() if isinstance(m, MoELayer)]
    old = [m.capacity_factor for m in layers]
    outs, launches = {}, {}
    try:
        for m in layers:
            m.capacity_factor = -1.0
            m.mode_calls = {}
        for path, use_graphs in (("graph", True), ("eager", False)):
            eng = ServingEngine(model, **engine_kw)
            eng.graphs.use_graph = use_graphs
            _zero([k7])
            outs[path] = drive(eng, stream)
            fw = eng.forwards["prefill"] + eng.forwards["decode"]
            require(len(outs[path]) == len(stream) and all(
                len(outs[path][r]) == n for r, (_, n) in enumerate(stream)),
                f"serve lossless [{path}]: requests unfinished or cut")
            require(k7.launches == 2 * L * fw > 0, f"serve lossless [{path}]: K7 "
                    f"{k7.launches} launches, want {2 * L * fw} for {fw} forwards")
            launches[path] = k7.launches
            del eng
        same_tokens("serve lossless", outs)
        modes = [m.mode_calls for m in layers]
        require(all(set(c) == {"routed"} for c in modes),
                f"serve lossless: the layers resolved to {modes}")
    finally:
        for m, cf in zip(layers, old):
            m.capacity_factor = cf
    log(f"serve lossless: K7 {launches['graph']} launches a drive (twice a layer a forward), "
        f"every layer routed; graph and eager tokens equal")
    return launches["graph"]


def prime(engine, stream):
    """Drive ``stream`` through ``engine`` once, then rewind the engine to
    take it again as a fresh one would (prefix cache emptied, its pages
    back, counters and request ids at 0) with its graphs kept: the next
    drive replays every graph and captures none, as a server does once its
    shapes have come.  Returns {graph key: replays so far}."""
    from vats_tpu_torch.inference.serving import PrefixCache

    drive(engine, stream)
    engine.allocator.free(engine.prefix_cache.reclaim(engine.allocator.capacity))
    engine.prefix_cache = PrefixCache()
    engine.preemptions = engine._next_rid = engine.spec_proposed = engine.spec_accepted = 0
    engine.prefill_shapes = set()
    engine.forwards = dict.fromkeys(engine.forwards, 0)
    return {key: g.replays for key, g in engine.graphs.items()}


def graph_runs(engine, kind, before):
    """{key[1:]: runs in the last drive} of an engine's graphs of ``kind``
    ('prefill', 'decode', 'verify'): a graph captured in it ran once as its
    warm-up, then replayed; ``before`` holds the replays of graphs an
    earlier drive captured (``prime``)."""
    return {key[1:]: g.replays - before.get(key, -1) for key, g in engine.graphs.items()
            if key[0] == kind}


def check_graph_runs(label, engine, before):
    """A graph drive's prefills and verify forwards: one graph per (bucket,
    rpad) the engine met, every prefill forward (and every verify forward)
    one run of its graph; a primed engine captures nothing."""
    runs = graph_runs(engine, "prefill", before)
    met = {k for k, n in runs.items() if n > 0}
    require(met == engine.prefill_shapes, f"{label}: prefill graphs run {sorted(met)}, "
            f"the prefill shapes {sorted(engine.prefill_shapes)}")
    require(sum(runs.values()) == engine.forwards["prefill"], f"{label}: "
            f"{sum(runs.values())} prefill graph runs for {engine.forwards['prefill']} "
            f"prefill forwards")
    verify = sum(graph_runs(engine, "verify", before).values())
    require(verify == engine.forwards["verify"], f"{label}: {verify} verify graph runs for "
            f"{engine.forwards['verify']} verify forwards")
    require(not before or len(engine.graphs) == len(before),
            f"{label}: the primed engine captured {len(engine.graphs) - len(before)} graphs")


# The spec drive: prompt-lookup drafts of SPEC_K tokens, verified by one
# forward over [rows, SPEC_K + 1] (greedy; the engine runs no decode blocks
# with spec_k)
SPEC_K = 4


def serve_spec(model, stream, engine_kw, kernel_fns, L):
    """The bf16-KV stream with speculative decoding (spec_k = SPEC_K, greedy,
    one-token decode steps only near the context cap), from graphs (the
    verify forward from one) on a fresh and on a primed engine (``prime``)
    and eagerly.  Gates: every drive's tokens equal, the forwards of each
    kind, the drafts and the preemptions equal on every path, the verify
    graph run once a verify forward, one prefill graph a key, K1 and K3's
    paged prologue once a layer a decode forward, K6 once a layer a prefill
    or verify forward, every request whole and every page back."""
    from vats_tpu_torch.inference import ServingEngine

    k1, k3 = kernel_fns["paged_decode_attention_commit"], kernel_fns["paged_decode_prologue"]
    k6 = kernel_fns["paged_prefill_attention"]
    seen, drives = {}, {}
    for path, use_graphs, primed in (("graph", True, False), ("eager", False, False),
                                     ("graph primed", True, True)):
        label = f"serve spec [{path}]"
        eng = ServingEngine(model, **dict(engine_kw, decode_block_steps=1, spec_k=SPEC_K))
        eng.graphs.use_graph = use_graphs
        before = prime(eng, stream) if primed else {}
        _zero(kernel_fns.values())
        outs = drives[path] = drive(eng, stream)
        require(len(outs) == len(stream) and all(
            len(outs[r]) == n for r, (_, n) in enumerate(stream)),
            f"{label}: requests unfinished or cut")
        eng.allocator.free(eng.prefix_cache.reclaim(eng.allocator.capacity))
        require(eng.allocator.num_used == 0, f"{label}: pages leaked")
        dec = eng.forwards["decode"]
        require(k1.launches == k3.launches == L * dec, f"{label}: K1 {k1.launches}, "
                f"K3 paged {k3.launches} launches for {dec} decode forwards of {L} layers")
        windows = eng.forwards["prefill"] + eng.forwards["verify"]
        require(k6.launches == L * windows, f"{label}: K6 {k6.launches} launches for "
                f"{windows} prefill and verify forwards of {L} layers")
        if use_graphs:
            check_graph_runs(label, eng, before)
        state = (dict(eng.forwards), eng.spec_proposed, eng.spec_accepted, eng.preemptions)
        require(seen.setdefault("first", state) == state,
                f"{label}: forwards, drafts or preemptions {state}, first drive "
                f"{seen['first']}")
        del eng
    same_tokens("serve spec", drives)
    fw, proposed, accepted, preempt = seen["first"]
    log(f"serve spec_k={SPEC_K} [bf16 KV]: forwards {json.dumps(fw)}, drafts accepted "
        f"{accepted}/{proposed}, preemptions {preempt}, equal on every path; tokens equal")


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
    # every engine prefill has a cache with history (a bf16 pool: K6)
    want_k6 = L * engine.forwards["prefill"] if kv_quant is None else 0
    require(engine.forwards["prefill"] > 0 and got["paged_prefill_attention"] == want_k6,
            f"serve {name}: K6 {got['paged_prefill_attention']} launches (want {want_k6} "
            f"for {engine.forwards['prefill']} prefill forwards)")
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


# --- phase: scripts ---------------------------------------------------------

# The train script at full nlp_medium width and depth (d1440, 20 layers, one
# expert, left_window 384, dropout 0.2, remat 'full', grad_accum_steps 4):
# B=8 rows of T=512, an eval every 8 micro-steps (2 optimizer updates).
SCRIPT_B, SCRIPT_T, SCRIPT_EVERY = 8, 512, 8
# The loop reads tokens_seen every max(1, 8 // 4) = 2 micro-steps and stops at
# max_train_tokens.  A micro-step counts its labelled tokens: len - 1 a row,
# and synthetic rows have len in [int(0.9 T), T] = [460, 512], so a step
# counts 8 * [459, 511] = [3672, 4088].  With M = 28672 the read after 6
# steps (<= 24528) continues and the round ends at its 8th step (>= 29376):
# exactly one round, one evaluation, two saves.
SCRIPT_TOKENS = 7 * SCRIPT_B * SCRIPT_T
VAL_BATCHES = 20  # validate(max_batches=20) in the script


def _zero(fns):
    for fn in fns:
        fn.launches = 0


def _counts(fns):
    return {fn.__name__: fn.launches for fn in fns}


def _gate(label, got, want, phase="scripts"):
    bad = {k: (got.get(k), n) for k, n in want.items() if got.get(k) != n}
    require(not bad, f"{phase}: {label} launches (got, want) {bad}")


def _state_bit_equal(a, b, where="state"):
    """Paths where two saved-form trees differ (tensors bit for bit)."""
    import torch

    if isinstance(a, torch.Tensor):
        return [] if (a.dtype == b.dtype and torch.equal(a, b.to(a.device))) else [where]
    if isinstance(a, dict):
        if a.keys() != b.keys():
            return [where]
        return [p for k in a for p in _state_bit_equal(a[k], b[k], f"{where}.{k}")]
    return [] if a == b else [where]


def run_scripts(kernel_fns):
    """The LM's own entry points at full nlp_medium width, in-process through
    their ``main(argv)``: train and checkpoint, load bit-equal, resume, serve
    the trained checkpoint (bf16 and int8 KV), generate from it through the
    interactive script (dense and paged), and a packed-shard training
    forward and backward whose later segments ignore the first one."""
    import shutil
    import tempfile

    import torch

    from vats_tpu_torch.checkpoint import load_checkpoint
    from vats_tpu_torch.checkpoint.manager import state_tree
    from vats_tpu_torch.configs import ModelArgs, TrainingArgs, nlp_medium
    from vats_tpu_torch.models import TextLM
    from vats_tpu_torch.scripts.nlp import interactive_generation as interactive_script
    from vats_tpu_torch.scripts.nlp import serve as serve_script
    from vats_tpu_torch.scripts.nlp import train as train_script
    from vats_tpu_torch.train import create_optimizer, create_train_state

    fns = list(kernel_fns.values())
    L = nlp_medium().num_layers
    root = os.path.join(HERE, "checkpoints")
    made_root = not os.path.exists(root)
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_scripts_", dir=root)
    try:
        # what a checkpoint holds: fp32 params, fp32 mu and nu, the fp32
        # accumulator (grad_accum_steps 4), a few counters
        n_params = sum(p.numel() for p in TextLM(nlp_medium(), device="meta").parameters())
        ckpt_bytes = 4 * 4 * n_params

        def room(what):
            free_now = shutil.disk_usage(tmp).free
            require(free_now >= 2 * ckpt_bytes,
                    f"scripts: {free_now / 1e9:.1f} GB free in {tmp} before {what}; "
                    f"need twice a checkpoint, {2 * ckpt_bytes / 1e9:.1f} GB")

        args = ["--size", "medium", "--batch-size", str(SCRIPT_B), "--seq-len",
                str(SCRIPT_T), "--eval-every-steps", str(SCRIPT_EVERY), "--fused-ce-chunk",
                "128", "--ckpt-dir", tmp, "--device", "cuda"]
        train_want = {"flash_attention_lse": 2 * L * SCRIPT_EVERY,  # forward + remat
                      "flash_bwd_dkv": L * SCRIPT_EVERY, "flash_bwd_dq": L * SCRIPT_EVERY,
                      "flash_attention": L * VAL_BATCHES,  # validate: uncached, T=512
                      "paged_decode_attention_commit": 0,
                      "paged_decode_attention_commit_int8": 0,
                      "paged_decode_prologue": 0, "dense_decode_prologue": 0,
                      "append_token_inplace": 0}

        def train_run(label, extra):
            room(label)
            _zero(fns)
            out = train_script.main(args + extra)
            torch.cuda.synchronize()
            got = _counts(fns)
            rounds = out["rounds"]
            require(len(rounds) == 1 and rounds[0]["steps"] == SCRIPT_EVERY,
                    f"scripts: {label} ran {[r['steps'] for r in rounds]} micro-steps a "
                    f"round, want one round of {SCRIPT_EVERY}")
            _gate(label, got, train_want)
            r = rounds[0]
            losses = out["history"]["train_loss"] + out["history"]["val_loss"]
            require(all(np.isfinite(losses)), f"scripts: {label} losses {losses}")
            st = out["state"]
            require(int(st.opt_state.gradient_step) == int(st.step) // 4
                    and int(st.skipped_steps) == 0,
                    f"scripts: {label}: {int(st.opt_state.gradient_step)} updates in "
                    f"{int(st.step)} micro-steps")
            best, regular = r["saved"]["best"], r["saved"]["regular"]
            # a round that saves both writes one file and links the other name
            require(best is None or os.path.samefile(best, regular),
                    f"scripts: {label}: best and regular are two files, not one")
            log(f"scripts: {label}: tokens_seen {r['tokens_seen']}; "
                f"{os.path.basename(regular)} {os.path.getsize(regular) / 1e9:.3f} GB"
                + (", best_model a link to it" if best else "")
                + f"; launches {json.dumps(got)}")
            return out, r

        # 1. train: one round, a best and a regular checkpoint
        out, r = train_run("train", ["--max-train-tokens", str(SCRIPT_TOKENS)])
        n_seen = r["tokens_seen"]
        regular = os.path.join(tmp, f"checkpoint_tokens_seen_{n_seen}")
        require(r["saved"]["regular"] == regular and r["saved"]["best"]
                == os.path.join(tmp, "best_model"), f"scripts: saved {r['saved']}")
        require(os.path.getsize(regular) >= ckpt_bytes, "scripts: checkpoint too small")

        # 2. resume: the regular checkpoint into a fresh state, bit for bit
        saved = state_tree(out["state"])
        with open(regular + ".meta.json") as f:
            meta = json.load(f)
        targs = TrainingArgs(grad_accum_steps=meta["training_args"]["grad_accum_steps"],
                             adam_mu_dtype=meta["training_args"]["adam_mu_dtype"])
        model = TextLM(ModelArgs.from_dict(meta["model_args"]), device="cuda", seed=99)
        fresh = create_train_state(model, create_optimizer(targs, 1))
        del out
        fresh, _ = load_checkpoint(regular, target=fresh)
        diff = _state_bit_equal(saved, state_tree(fresh))
        require(not diff, f"scripts: the loaded state differs from the saved one at "
                f"{diff[:6]}")
        log(f"scripts: {os.path.basename(regular)} loaded into a fresh state on the card: "
            f"{sum(1 for _ in _tensors(saved))} tensors (params, mu, nu, acc_grads, counters) "
            f"bit-equal to the saved state")
        del saved, fresh, model
        torch.cuda.empty_cache()
        res, r2 = train_run("resume", ["--max-train-tokens", str(n_seen + SCRIPT_TOKENS),
                                       "--resume", regular])
        require(n_seen < r2["tokens_seen"] and int(res["state"].step) == 2 * SCRIPT_EVERY,
                f"scripts: resumed tokens_seen {r2['tokens_seen']} after {n_seen}, step "
                f"{int(res['state'].step)}")
        del res
        torch.cuda.empty_cache()

        # 3. serve the trained checkpoint: bf16 KV (K1), int8 KV (K4)
        k1 = kernel_fns["paged_decode_attention_commit"]
        k4 = kernel_fns["paged_decode_attention_commit_int8"]
        for name, extra in (("bf16 KV", []), ("int8 KV", ["--kv-quant", "int8"])):
            argv = ["--ckpt", os.path.join(tmp, "best_model"), "--requests", "8",
                    "--max-batch", "4", "--max-context", "512", "--decode-block-steps",
                    "4"] + extra
            _zero(fns)
            got = serve_script.main(argv)
            counts = _counts(fns)
            fw = got["forwards"]["decode"]
            n_new = serve_script.parse_args(argv).max_new_tokens
            require(got["requests"] == 8 and all(len(v) == n_new
                                                  for v in got["outputs"].values()),
                    f"scripts: serve [{name}] returned "
                    f"{[len(v) for v in got['outputs'].values()]} tokens")
            want = {k1.__name__: L * fw if not extra else 0,
                    k4.__name__: L * fw if extra else 0,
                    "paged_prefill_attention": L * got["forwards"]["prefill"] if not extra else 0,
                    "paged_decode_prologue": L * fw, "dense_decode_prologue": 0,
                    "append_token_inplace": 0, "flash_attention_lse": 0,
                    "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
            require(fw > 0, f"scripts: serve [{name}] ran no decode forward")
            _gate(f"serve [{name}]", counts, want)
            log(f"scripts: serve [{name}] best_model, 8 requests x {n_new} tokens: forwards "
                f"{json.dumps(got['forwards'])}; launches {json.dumps(counts)}")

        # 4. the interactive script on the trained checkpoint at temperature 0:
        # one decode forward a new token (as the main phase's TokenGenerator
        # gate), each a fused prologue a layer, dense or paged before K1
        prompts = ["Once upon a time,", "hello world"]
        n_new = 32
        fw = n_new * len(prompts)
        for name, extra in (("dense", []), ("paged", ["--paged"])):
            argv = ["--ckpt", os.path.join(tmp, "best_model"), "--device", "cuda",
                    "--temperature", "0", "--max-new-tokens", str(n_new)] + extra
            _zero(fns)
            outs = interactive_script.main(argv, tokenizer=StubTokenizer(),
                                           stdin=io.StringIO("\n".join(prompts) + "\nquit\n"))
            torch.cuda.synchronize()
            print()  # ends the script's last '> ' prompt line
            counts = _counts(fns)
            paged = bool(extra)
            want = {"dense_decode_prologue": 0 if paged else L * fw,
                    "paged_decode_prologue": L * fw if paged else 0,
                    k1.__name__: L * fw if paged else 0, k4.__name__: 0,
                    "append_token_inplace": 0, "flash_attention": 0,
                    "flash_attention_lse": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
            require(len(outs) == len(prompts)
                    and all(len(o.split()) == n_new for o in outs),
                    f"scripts: interactive [{name}] returned {outs}")
            _gate(f"interactive [{name}]", counts, want)
            log(f"scripts: interactive [{name}] best_model, {len(prompts)} prompts x "
                f"{n_new} tokens at temperature 0: launches {json.dumps(counts)}")

        # 5. packed shards at full width
        packed_segments(fns, L)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if made_root:
            shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def _tensors(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def _relabel(ids, segs):
    """Labels of packed rows: the next token of the same segment, else -100."""
    import torch

    nxt = torch.cat([ids[:, 1:], torch.zeros_like(ids[:, :1])], 1)
    same = torch.cat([(segs[:, 1:] == segs[:, :-1]) & (segs[:, 1:] > 0),
                      torch.zeros_like(segs[:, :1], dtype=torch.bool)], 1)
    return torch.where(same, nxt, -100).to(torch.int32)


def packed_segments(fns, L):
    """A TokenShard of seeded documents (32-600 tokens) packed into 8 rows of
    512 with segment ids; one training forward and backward of medium_dense
    (dropout 0) on it, then again with each row's first segment re-drawn:
    the logits of every later segment must not move.  The later segments
    come after the first, so causal attention alone would let them see it;
    only the segment mask in K2' keeps them from it (positions, norms and
    the MLP are per token).  Tolerance: one bf16 ulp of the logit (2e-3 +
    1e-2 |logit|); masked scores add exact zeros and the two runs are the
    same kernels on the same shapes, so bit-equal is expected and the count
    is printed."""
    import torch

    from vats_tpu_torch.data import device_batches
    from vats_tpu_torch.data.shard_dataset import ShardDataset, TokenShard
    from vats_tpu_torch.models import TextLM
    from vats_tpu_torch.train.metrics import compute_loss

    cfg = train_cfg("medium_dense", dropout=0.0)
    rs = np.random.RandomState(9)
    # lengths log-uniform in [32, 600] (short documents are the common ones),
    # so most rows pack several
    lens = np.exp(rs.uniform(np.log(32), np.log(601), 64)).astype(int)
    docs = [rs.randint(1, cfg.vocab_size, n).tolist() for n in lens]
    ds = ShardDataset(TokenShard.from_documents(docs), seq_len=TRAIN_T)
    np_batch, consumed = ds.pack_sequences(0, SCRIPT_B)
    batch = next(device_batches(iter([np_batch]), "cuda"))
    segs = batch["segment_ids"]
    first, later = segs == 1, segs > 1
    rows = int(later.any(1).sum())
    require(rows >= SCRIPT_B // 2, f"scripts: only {rows} packed rows hold two segments")
    model = TextLM(cfg, device="cuda", seed=3)
    gen = torch.Generator(device="cuda").manual_seed(4)

    def fwd_bwd(ids):
        for p in model.parameters():
            p.grad = None
        logits, _, aux = model(ids, padding_mask=batch["padding_mask"],
                               segment_ids=segs, deterministic=False, dropout_seed=0)
        loss = compute_loss(logits, _relabel(ids, segs), aux)[0]
        loss.backward()
        return logits.detach().float()

    _zero(fns)
    out1 = fwd_bwd(batch["input_ids"])
    redraw = torch.randint(1, cfg.vocab_size, segs.shape, generator=gen, device="cuda",
                           dtype=torch.int32)
    ids2 = torch.where(first, redraw, batch["input_ids"])
    out2 = fwd_bwd(ids2)
    torch.cuda.synchronize()
    _gate("packed shards", _counts(fns), {"flash_attention_lse": 2 * 2 * L,
                                          "flash_bwd_dkv": 2 * L, "flash_bwd_dq": 2 * L,
                                          "flash_attention": 0})
    require(bool((ids2 != batch["input_ids"]).any()), "scripts: nothing was re-drawn")
    a, b = out1[later], out2[later]
    torch.testing.assert_close(b, a, atol=2e-3, rtol=1e-2)
    changed = float((out1[first] - out2[first]).abs().max())
    require(changed > 0, "scripts: the re-drawn segments' logits did not change")
    log(f"scripts: packed shards: {consumed} documents (32-600 tokens) in {SCRIPT_B} rows "
        f"of {TRAIN_T}, {rows} rows with 2+ segments; later segments' logits bit-equal "
        f"{int((a == b).sum())}/{a.numel()}; first segments' logits moved by up to "
        f"{changed:.3f}")
    del model


# --- phase: vision ----------------------------------------------------------

VIT2D_FWD_B, VIT2D_TRAIN_B, VIT2D_ACCUM, VIT3D_B = 16, 32, 4, 4


def _vision_gate(label, fns, want):
    got = _counts(fns)
    _gate(label, got, want, phase="vision")
    return got


def graph_forward(model, x, like):
    """``model``'s no-grad forward on ``x`` replayed from a CUDA graph: a
    ``GraphSet`` (the eval step's helper) keyed on x's shape, x copied into
    the key's static buffer at every call and the features written into a
    static output shaped as ``like``.  Returns (call, the GraphSet)."""
    import torch

    from vats_tpu_torch.inference.graphs import GraphSet

    graphs = GraphSet("cuda")

    def build():
        bufs = {"x": torch.empty_like(x)}
        out = torch.empty_like(like)

        def body():
            with torch.no_grad():
                out.copy_(model(bufs["x"]))

        return bufs, body, out

    return (lambda: graphs(tuple(x.shape), build, {"x": x})), graphs


def vision_forward(label, model, x, fns, want):
    """One eager forward with the flash counters zeroed just before and read
    just after (held to ``want``); then the forward from a graph
    (``graph_forward``): its first call the warm-up and the capture, one
    replay gated as the eager forward and bit-equal to it.  Returns (eager
    output, a replay's launches)."""
    import torch

    with torch.no_grad():
        _zero(fns)
        out = model(x)
        torch.cuda.synchronize()
        _vision_gate(label, fns, want)
    require(bool(torch.isfinite(out.float()).all()), f"vision: {label} not finite")
    call, graphs = graph_forward(model, x, out)
    call()
    torch.cuda.synchronize()
    _zero(fns)
    replayed = call()
    torch.cuda.synchronize()
    got = _vision_gate(f"{label} graph replay", fns, want)
    require(torch.equal(replayed, out), f"vision: {label}: the graph's features are not "
            f"eager's bit for bit (max |diff| {float((replayed - out).abs().max())})")
    log(f"vision: {label}: launches a forward {json.dumps(got)}, eager and a graph replay; "
        f"features bit-equal")
    del call, graphs
    return out, got


def run_vision(fns):
    """ViT-2D medium forward (K2 only, 16 launches a forward) at B=16 on
    384x384, eagerly and from a CUDA graph, and on a non-square size (resize
    and crop on the card), ViT-2D medium training through
    ``make_vision_train_step`` (one round of 4 micro-steps of B=32 with
    mixup / cutmix and the pixel battery on the card; K2', K5a and K5b per
    micro-step as derived below) and its eval step from its graph, then
    ViT-3D xsmall and large forwards, eagerly and from graphs (no flash
    kernel: the JAX model attends with XLA there).  Depth uncut everywhere.
    Returns the flash launches of one ViT-2D graph replay."""
    import math

    import torch

    from vats_tpu_torch.configs import vit2d_medium, vit3d_large, vit3d_xsmall
    from vats_tpu_torch.models import ImageEncoder, VideoTransformer
    from vats_tpu_torch.train import (
        VisionTrainingArgs,
        create_train_state,
        create_vision_optimizer,
        make_vision_eval_step,
        make_vision_train_step,
    )
    from vats_tpu_torch.train.step_graphs import (
        accumulation_position,
        set_accumulation_position,
        state_tensors,
    )
    from vats_tpu_torch.train.vision import eval_metrics

    k2, k2l, k5a, k5b = (fn.__name__ for fn in fns)
    gen = torch.Generator(device="cuda").manual_seed(21)

    # ViT-2D medium forward, as bench.py's vit2d stage: dropout 0, no remat,
    # params in bf16, B=16
    cfg = vit2d_medium(dropout=0.0, use_checkpointing=False)
    L = cfg.num_layers
    model = ImageEncoder(cfg, device="cuda", seed=0).to(torch.bfloat16)
    want = {k2: L, k2l: 0, k5a: 0, k5b: 0}
    x = torch.randn((VIT2D_FWD_B, 3, 384, 384), generator=gen, device="cuda").to(torch.bfloat16)
    feats, replay_launches = vision_forward("vit2d_medium 384x384", model, x, fns, want)
    require(tuple(feats.shape) == (VIT2D_FWD_B, cfg.num_patches, cfg.d_model),
            f"vision: vit2d features {tuple(feats.shape)}")
    xr = torch.randn((VIT2D_FWD_B, 3, 448, 531), generator=gen, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        _zero(fns)
        out = model(xr)
        torch.cuda.synchronize()
        _vision_gate("vit2d_medium 448x531", fns, want)
    require(tuple(out.shape) == tuple(feats.shape) and bool(torch.isfinite(out.float()).all()),
            "vision: vit2d forward at 448x531 (resize 384x455, crop)")
    log(f"vision: vit2d_medium 448x531 (resized to 384x455 and cropped on the card): "
        f"{L} K2 launches, features {tuple(out.shape)} finite")
    del model, feats, out, x, xr
    torch.cuda.empty_cache()

    # ViT-2D medium training: num_classes 1000, dropout 0.2, remat on,
    # grad_accum 4, micro-batch 32, mixup / cutmix and the on-card battery on
    # raw [0, 1] images.  A micro-step runs each block's forward twice (the
    # forward, then its recompute in the backward: K2' 2L) and its backward
    # once (K5a L, K5b L); the eval step K2 L.
    cfg = vit2d_medium(num_classes=1000, dropout=0.2, use_checkpointing=True)
    model = ImageEncoder(cfg, device="cuda", seed=1)
    args = VisionTrainingArgs(grad_accum_steps=VIT2D_ACCUM, pixel_augs_on_device=True,
                              warmup_epochs=1, epochs=10)
    state = create_train_state(model, create_vision_optimizer(args, steps_per_epoch=100))
    step = make_vision_train_step(model, args, 1000)
    eval_step = make_vision_eval_step(model, 1000)
    B = VIT2D_TRAIN_B

    def micro_batch():
        return {"images": torch.rand((B, 3, 384, 384), generator=gen, device="cuda"),
                "labels": torch.randint(0, 1000, (B,), generator=gen, device="cuda")}

    batches = [micro_batch() for _ in range(2 * VIT2D_ACCUM)]
    ev_batch = {"images": torch.randn((B, 3, 384, 384), generator=gen, device="cuda"),
                "labels": batches[0]["labels"]}
    for i in range(VIT2D_ACCUM):  # first round: each position's warm-up and capture
        state, m = step(state, batches[i], i)
    torch.cuda.synchronize()
    train_want = {k2l: 2 * L, k5a: L, k5b: L, k2: 0}
    require(sorted(key[-1] for key in step.graphs) == list(range(VIT2D_ACCUM)),
            f"vision: train graphs {list(step.graphs)}, want one a micro-step position")
    for key, graph in step.graphs.items():
        tally_gate(f"vit2d train graph at position {key[-1]}", graph, train_want, "vision")
    ev0 = float(eval_step(state.params, ev_batch)["loss"])  # warm-up and capture
    torch.cuda.synchronize()
    last = {}

    def run(k):
        ms = last["metrics"] = [step(state, batches[VIT2D_ACCUM + i], 100 + i)[1]
                                for i in range(k)]
        return [x[key] for x in ms for key in sorted(x)]

    got = train_turns(
        "vision: vit2d training round", [step.graphs],
        state_tensors(state, list(model.buffers())), run, fns, train_want, VIT2D_ACCUM,
        host=(lambda: accumulation_position(state),
              lambda pos: set_accumulation_position(state, pos)))
    metrics = last["metrics"]
    _zero(fns)
    ev1 = eval_step(state.params, ev_batch)  # a replay, on the updated params
    ev1_loss = float(ev1["loss"])
    _vision_gate("vit2d eval step (a graph replay)", fns, {k2: L, k2l: 0, k5a: 0, k5b: 0})
    ev_eager = eval_metrics(model, state.params, ev_batch["images"], ev_batch["labels"], 1000)
    require(torch.equal(torch.stack([ev1["loss"], ev1["acc"]]), ev_eager),
            f"vision: the eval step's graph gives {ev1}, eager {ev_eager.tolist()}")
    require(len(eval_step.graphs) == 1 and eval_step.graphs.replays == 1,
            "vision: the eval step did not replay its one graph")
    losses = [float(m["loss"]) for m in metrics]
    norm = float(metrics[-1]["grad_norm"])
    require(all(math.isfinite(v) for v in losses + [norm, ev0, ev1_loss]),
            f"vision: non-finite training numbers {losses} {norm} {ev0} {ev1_loss}")
    require(ev1_loss != ev0, "vision: the update left the eval loss unchanged")
    require(int(state.step) == 2 * VIT2D_ACCUM
            and int(state.opt_state.gradient_step) == 2, "vision: step counters wrong")
    log(f"vision: vit2d training round launches {json.dumps(got)} = per micro-step K2' "
        f"{got[k2l] // VIT2D_ACCUM} ({L} forward + {L} recomputed), K5a "
        f"{got[k5a] // VIT2D_ACCUM}, K5b {got[k5b] // VIT2D_ACCUM}, graph and eager bit-equal; "
        f"eval step K2 {L} a graph replay (equal to eager bit for bit); eval loss before the "
        f"round's update {ev0:.5f} after {ev1_loss:.5f}")
    del model, state, step, eval_step, batches, ev_batch, metrics
    torch.cuda.empty_cache()

    # ViT-3D xsmall (bench.py's vit3d stage: B=4, 32 frames at 128^2) and
    # large (tools/bench_vit3d.py: 8 frames at 224^2, B=4), dropout 0, no
    # remat, params in bf16
    zero_flash = {k2: 0, k2l: 0, k5a: 0, k5b: 0}
    for name, cfg in (("vit3d_xsmall", vit3d_xsmall(dropout=0.0, use_checkpointing=False)),
                      ("vit3d_large", vit3d_large(dropout=0.0, use_checkpointing=False))):
        model = VideoTransformer(cfg, device="cuda", seed=0).to(torch.bfloat16)
        th, tw = cfg.target_size
        gt, gh, gw = cfg.grid_size
        x = torch.randn((VIT3D_B, 3, cfg.max_frames, th, tw), generator=gen,
                        device="cuda").to(torch.bfloat16)
        out, _ = vision_forward(name, model, x, fns, zero_flash)
        require(tuple(out.shape) == (VIT3D_B, gt * gh * gw, cfg.d_model),
                f"vision: {name} features {tuple(out.shape)}")
        del model, out, x
        torch.cuda.empty_cache()
    return replay_launches


# --- phase: image_gen -------------------------------------------------------

# tools/bench_gen.py's image stage: image_gen_xsmall (d768, 12 layers, 32/4
# heads of 24), dropout 0, B=4, 16 text tokens, a 16 x 16 grid, sampled at
# temperature 0.9 and top-k 64.
IMG_GEN_B, IMG_GEN_GRID, IMG_TEXT_T = 4, 16, 16
# the generation runs' depth: image_gen_xsmall's 12 layers cut to 6 when the
# video and multimodal phases came, to 3 with K6, to keep the whole script
# under 900 s (the eager loops are host-bound: their time goes with the
# depth); the trainer and the script keep all 12
IMG_GEN_LAYERS = 3
IMG_PIPE_GRID = 64  # the config's own 256 px target: a 64 x 64 latent grid
IMG_TRAIN_B, IMG_TRAIN_STEPS = 2, 3


def _image_gate(label, fns, want):
    got = _counts(fns)
    _gate(label, got, want, phase="image_gen")
    return got


def run_image_gen(fns):
    """Image generation at image_gen_xsmall's full width (the generation
    runs at IMG_GEN_LAYERS = 3 of its 12 layers, the trainer at all 12):
    ``generate_image_tokens`` (dense cache) and ``generate_image_tokens_paged``
    at the JAX bench's shape, each with its decode replayed from a CUDA graph
    and eagerly (equal tokens); the ``ImageGenerationPipeline`` on the 64 x
    64 grid (4096 steps, graphs); ``ImageGenTrainer`` steps at 256 px, B=2
    (remat, dropout 0.2) from their graph and eagerly, and an ``evaluate``;
    the image-gen script for a few steps.  Exact launch gates: K3's table
    mode (dense or paged) and K1 once a layer a decode forward, K2' 2L, K5a
    L and K5b L a train step (each block's forward and its recompute), K2 L
    an evaluation, nothing else."""
    import torch

    from vats_tpu_torch.configs import image_gen_xsmall
    from vats_tpu_torch.inference import ImageGenerationPipeline, ImageGenerationSampler
    from vats_tpu_torch.inference.image_generation import _generate_image_tokens
    from vats_tpu_torch.models import AutoregressiveImageTransformer
    from vats_tpu_torch.scripts.image_gen import train as image_gen_script
    from vats_tpu_torch.train import ImageGenTrainer, ImageGenTrainingArgs
    from vats_tpu_torch.train.step_graphs import state_tensors

    (dense_t, paged_t, k1, k2, k2l, k5a, k5b, dense_p, paged_p, append) = (
        fn.__name__ for fn in fns)
    none = {name: 0 for name in _counts(fns)}
    gen = torch.Generator(device="cuda").manual_seed(31)
    cfg = image_gen_xsmall(dropout=0.0, use_checkpointing=False, num_layers=IMG_GEN_LAYERS)
    L = cfg.num_layers
    model = AutoregressiveImageTransformer(cfg, device="cuda", seed=0).eval()
    b, gh = IMG_GEN_B, IMG_GEN_GRID
    n = gh * gh
    text = torch.randn((b, IMG_TEXT_T, cfg.d_model), generator=gen, device="cuda").to(
        torch.bfloat16)
    sampler = ImageGenerationSampler(temperature=0.9, top_k=64)
    main_counts = {}
    for paged in (False, True):
        tag = "generate_image_tokens_paged" if paged else "generate_image_tokens"
        want = dict(none)
        if paged:
            want.update({paged_t: L * n, paged_p: L * n, k1: L * n})
        else:
            want.update({dense_t: L * n, dense_p: L * n})
        toks = {}
        for use_graph in (True, False):
            path = "graph" if use_graph else "eager"
            _zero(fns)
            toks[path], _ = _generate_image_tokens(
                model, text, None, torch.Generator(device="cuda").manual_seed(5),
                grid_h=gh, grid_w=gh, sampler=sampler, start_token_id=0, paged=paged,
                page_size=128, use_graph=use_graph)
            torch.cuda.synchronize()
            got = _image_gate(f"{tag} {path}", fns, want)
            if use_graph:  # the kernels line's launches: the graph run of each path
                main_counts.update({k_: v for k_, v in got.items() if v})
        require(torch.equal(toks["graph"], toks["eager"]),
                f"image_gen: {tag}: graph and eager runs drew different tokens")
        require(tuple(toks["graph"].shape) == (b, gh, gh) and 0 <= int(toks["graph"].min())
                and int(toks["graph"].max()) < cfg.num_embeddings, f"image_gen: {tag} tokens")
        log(f"image_gen: {tag} B={b} {gh}x{gh}: launches {json.dumps(got)} both paths; "
            f"graph and eager tokens equal")
    del model
    torch.cuda.empty_cache()

    # the pipeline on the 64 x 64 grid, B=1: text encoder, 4096 decode steps
    # replayed from a graph, codebook lookup, decoder
    pipe = ImageGenerationPipeline(cfg, seed=1, device="cuda")
    ids = torch.randint(1, cfg.vocab_size, (1, IMG_TEXT_T), generator=gen, device="cuda")
    g64 = IMG_PIPE_GRID
    want = dict(none)
    want.update({dense_t: L * g64 * g64, dense_p: L * g64 * g64})
    _zero(fns)
    images, tokens = pipe.generate_images(ids, torch.Generator(device="cuda").manual_seed(6),
                                          grid_h=g64, grid_w=g64, sampler=sampler)
    torch.cuda.synchronize()
    got = _image_gate("pipeline 64x64", fns, want)
    require(tuple(images.shape) == (1, 3, 4 * g64, 4 * g64) and bool(torch.isfinite(images).all())
            and 0 <= float(images.min()) and float(images.max()) <= 1,
            "image_gen: pipeline images")
    require(tuple(tokens.shape) == (1, g64, g64), "image_gen: pipeline tokens")
    log(f"image_gen: pipeline 64x64 (B=1, 4096 steps, graphs): launches {json.dumps(got)}; "
        f"images {tuple(images.shape)} in [0, 1]")
    del pipe, images
    torch.cuda.empty_cache()

    # training: image_gen_xsmall as configured (dropout 0.2, remat), 256 px,
    # B=2, the loss VQ + recon + token CE; an evaluation
    tcfg = image_gen_xsmall()
    L = tcfg.num_layers
    trainer = ImageGenTrainer(tcfg, ImageGenTrainingArgs(), num_training_steps=100,
                              device="cuda")
    px = tcfg.target_size

    def batch():
        return {"images": torch.rand((IMG_TRAIN_B, 3, px, px), generator=gen, device="cuda"),
                "text_embeddings": torch.randn((IMG_TRAIN_B, IMG_TEXT_T, tcfg.d_model),
                                               generator=gen, device="cuda").to(torch.bfloat16)}

    step_want = dict(none)
    step_want.update({k2l: 2 * L, k5a: L, k5b: L})
    _zero(fns)
    trainer.train_step(batch())  # the warm-up step and the capture
    _image_gate("first train step", fns, step_want)
    graph = trainer.graphs[next(iter(trainer.graphs))]
    tally_gate("image_gen train graph", graph, step_want, "image_gen")
    del graph  # train_turns captures again
    batches = [batch() for _ in range(IMG_TRAIN_STEPS)]

    def run(k):
        ms = [trainer.train_step(bt) for bt in batches[:k]]
        return [m[key] for m in ms for key in sorted(m)]

    got = train_turns(
        "image_gen: trainer", [trainer.graphs],
        state_tensors(trainer.state, list(trainer.model.buffers())), run, fns, step_want,
        IMG_TRAIN_STEPS, host=(trainer._seeds.get_state, trainer._seeds.set_state),
        exact=cudnn_deterministic)
    ev_want = dict(none)
    ev_want[k2] = L
    with cudnn_deterministic():  # graph and eager bit for bit
        _zero(fns)
        ev = trainer.evaluate(iter([batches[0]]), max_batches=1)  # warm-up and capture
        torch.cuda.synchronize()
        _image_gate("evaluate", fns, ev_want)
        _zero(fns)
        ev_graph = trainer.evaluate(iter([batches[0]]), max_batches=1)  # a replay
        _image_gate("evaluate (a graph replay)", fns, ev_want)
        trainer.eval_graphs.use_graph = False
        ev_eager = trainer.evaluate(iter([batches[0]]), max_batches=1)
        trainer.eval_graphs.use_graph = True
    require(ev_graph == ev_eager == ev and trainer.eval_graphs.replays == 1,
            f"image_gen: evaluate from its graph {ev_graph}, eagerly {ev_eager}, first {ev}")
    require(np.isfinite(ev["loss"]), f"image_gen: eval loss {ev}")
    log(f"image_gen: trainer image_gen_xsmall 256px B={IMG_TRAIN_B}: launches over a graph "
        f"turn {json.dumps(got)}, graph and eager bit-equal; evaluate {json.dumps(ev)} (from "
        f"its graph, equal to eager; K2 {L} a replay)")
    del trainer, batches
    torch.cuda.empty_cache()

    # the script, in-process, for a few steps (the text encoder's 8 tokens
    # take the plain attention)
    steps = 3
    _zero(fns)
    out = image_gen_script.main(["--size", "xsmall", "--steps", str(steps), "--batch-size",
                                 str(IMG_TRAIN_B), "--log-every", "1", "--device", "cuda"])
    got = _image_gate("the image-gen script", fns,
                      {k: v * steps for k, v in step_want.items()})
    require(all(np.isfinite(m["loss"]) for m in out["history"]), "image_gen: script loss")
    log(f"image_gen: script --size xsmall --steps {steps} --batch-size {IMG_TRAIN_B}: "
        f"launches {json.dumps(got)}")
    del out
    torch.cuda.empty_cache()
    return main_counts


# --- phase: video_gen ---------------------------------------------------------

VID_TEXT_T, VID_FRAMES = 8, 2  # tools/bench_gen.py's 8 text tokens; 2 latent frames
# the generation runs' depth: video_gen_large's 20 layers cut to 3 with K6,
# to keep the whole script under 900 s (the eager loop is host-bound: its
# time goes with the depth); the trainer keeps all 20
VID_GEN_LAYERS = 3
VID_BENCH_B, VID_BENCH_FRAMES = 2, 5  # tools/bench_gen.py:84-116 (video_gen_xsmall)
VID_TRAIN_STEPS, VQ_TRAIN_STEPS = 3, 2


def _video_gate(label, fns, want):
    got = _counts(fns)
    _gate(label, got, want, phase="video_gen")
    return got


def run_video_gen(fns):
    """Text->video generation at video_gen_large's full width (the
    generation and the pipeline at VID_GEN_LAYERS of its 20 layers, the
    trainer at all 20): ``generate_video_tokens`` at B=1 over 2 latent
    frames (512 raster steps, each a 256-token full-frame forward) with the
    inner step replayed from a CUDA graph, and the eager loop over the first
    frame (equal tokens); the JAX bench's shape (video_gen_xsmall, B=2, 5
    frames of 8 x 8) likewise; the ``VideoGenerationPipeline`` over 2 latent
    frames; ``VideoTokenTrainer`` steps at B=1 over 15 latent frames (remat,
    dropout 0.2) and ``VQVAE3DTrainer`` steps on a 30-frame 128 x 128 clip,
    each from its graph and eagerly (bit-equal).  Exact gates: K3's append
    mode once a layer a cached forward (read steps and frame appends
    alike), nothing else."""
    import torch

    from vats_tpu_torch.configs import video_gen_large, video_gen_xsmall
    from vats_tpu_torch.inference import VideoGenerationPipeline, VideoGenerationSampler
    from vats_tpu_torch.inference.video_generation import _generate_video_tokens
    from vats_tpu_torch.models import AutoregressiveVideoTransformer
    from vats_tpu_torch.ops.cache_append import append_token_inplace
    from vats_tpu_torch.train import VideoGenTrainingArgs, VideoTokenTrainer, VQVAE3DTrainer
    from vats_tpu_torch.train.step_graphs import state_tensors

    none = {name: 0 for name in _counts(fns)}
    append = append_token_inplace.__name__
    gen = torch.Generator(device="cuda").manual_seed(51)
    sampler = VideoGenerationSampler(temperature=0.9, top_k=64)
    main_counts = {}

    def generation(tag, cfg, b, frames, eager_frames):
        model = AutoregressiveVideoTransformer(cfg, device="cuda", seed=0).eval()
        L, hw = cfg.num_layers, cfg.latent_height * cfg.latent_width
        text = torch.randn((b, VID_TEXT_T, cfg.d_model), generator=gen, device="cuda").to(
            torch.bfloat16)
        toks = {}
        for use_graph in (True, False):
            path = "graph" if use_graph else "eager"
            n_fr = frames if use_graph else eager_frames
            want = dict(none)
            want[append] = L * n_fr * (hw + 1)  # hw read steps and one append a frame
            _zero(fns)
            toks[path], _ = _generate_video_tokens(
                model, text, None, torch.Generator(device="cuda").manual_seed(5),
                num_frames=n_fr, sampler=sampler, start_token_id=0, use_graph=use_graph)
            torch.cuda.synchronize()
            got = _video_gate(f"{tag} {path}", fns, want)
            if use_graph and not main_counts:  # the kernels line reads video_gen_large's
                main_counts.update(got)
        require(torch.equal(toks["graph"][:, :eager_frames], toks["eager"]),
                f"video_gen: {tag}: graph and eager runs drew different tokens")
        require(tuple(toks["graph"].shape) == (b, frames, cfg.latent_height, cfg.latent_width)
                and 0 <= int(toks["graph"].min())
                and int(toks["graph"].max()) < cfg.num_embeddings, f"video_gen: {tag} tokens")
        log(f"video_gen: {tag} B={b}, {frames} latent frames: K3 append {L} a cached forward; "
            f"graph and eager tokens equal over {eager_frames} frame(s)")
        del model
        torch.cuda.empty_cache()

    generation("video_gen_large", video_gen_large(dropout=0.0, num_layers=VID_GEN_LAYERS), 1,
               VID_FRAMES, 1)
    generation("video_gen_xsmall (the JAX bench's shape)",
               video_gen_xsmall(dropout=0.0, use_checkpointing=False), VID_BENCH_B,
               VID_BENCH_FRAMES, VID_BENCH_FRAMES)

    # the pipeline at large: the text encoder, 2 latent frames replayed from
    # a graph, the codebook, the 3-D decoder -> 4 frames of 128 x 128
    cfg = video_gen_large(dropout=0.0, num_layers=VID_GEN_LAYERS)
    L, hw = cfg.num_layers, cfg.latent_height * cfg.latent_width
    pipe = VideoGenerationPipeline(cfg, seed=1, device="cuda")
    ids = torch.randint(1, cfg.vocab_size, (1, VID_TEXT_T), generator=gen, device="cuda")
    want = dict(none)
    want[append] = L * VID_FRAMES * (hw + 1)
    _zero(fns)
    videos, tokens = pipe.generate_videos(ids, torch.Generator(device="cuda").manual_seed(6),
                                          num_frames=VID_FRAMES, sampler=sampler)
    torch.cuda.synchronize()
    got = _video_gate("pipeline", fns, want)
    pt, ph, pw = cfg.patch_size
    require(tuple(videos.shape) == (1, 3, VID_FRAMES * pt, cfg.latent_height * ph,
                                    cfg.latent_width * pw)
            and bool(torch.isfinite(videos).all()) and 0 <= float(videos.min())
            and float(videos.max()) <= 1, f"video_gen: pipeline videos {tuple(videos.shape)}")
    log(f"video_gen: pipeline video_gen_large (B=1, {VID_FRAMES} latent frames, graphs): "
        f"launches {json.dumps(got)}; videos {tuple(videos.shape)} in [0, 1]")
    del pipe, videos
    torch.cuda.empty_cache()

    # the token trainer at large as configured (dropout 0.2, remat), B=1,
    # 15 latent frames (3840 tokens), 8 text tokens
    tcfg = video_gen_large()
    lat_t = tcfg.max_frames // tcfg.patch_size[0]
    trainer = VideoTokenTrainer(tcfg, VideoGenTrainingArgs(), num_training_steps=100,
                                device="cuda")

    def batch():
        return {"indices": torch.randint(0, tcfg.num_embeddings,
                                         (1, lat_t, tcfg.latent_height, tcfg.latent_width),
                                         generator=gen, device="cuda"),
                "text_embeddings": torch.randn((1, VID_TEXT_T, tcfg.d_model), generator=gen,
                                               device="cuda").to(torch.bfloat16)}

    _zero(fns)
    trainer.train_step(batch())  # the warm-up step and the capture
    batches = [batch() for _ in range(VID_TRAIN_STEPS)]
    graph = trainer.graphs[next(iter(trainer.graphs))]
    tally_gate("token trainer graph", graph, none, "video_gen")
    del graph  # train_turns captures again
    train_turns("video_gen: VideoTokenTrainer", [trainer.graphs],
                state_tensors(trainer.state, list(trainer.model.buffers())),
                lambda k: [trainer.train_step(bt) for bt in batches[:k]], fns, none,
                VID_TRAIN_STEPS, host=(trainer._seeds.get_state, trainer._seeds.set_state),
                exact=cudnn_deterministic)
    log(f"video_gen: VideoTokenTrainer video_gen_large B=1, {lat_t} latent frames: no kernel "
        f"launch; graph and eager bit-equal")
    del trainer, batches
    torch.cuda.empty_cache()

    # the 3-D VQ-VAE trainer at large: a 30-frame 128 x 128 clip, B=1
    vq = VQVAE3DTrainer(tcfg, VideoGenTrainingArgs(), num_training_steps=100, device="cuda")
    px = tcfg.latent_height * ph
    clips = [torch.rand((1, 3, tcfg.max_frames, px, px), generator=gen, device="cuda")
             for _ in range(VQ_TRAIN_STEPS + 1)]
    _zero(fns)
    vq.train_step(clips[0])  # the warm-up step and the capture
    train_turns("video_gen: VQVAE3DTrainer", [vq.graphs],
                state_tensors(vq.state, list(vq.model.buffers())),
                lambda k: [vq.train_step(c) for c in clips[1:1 + k]], fns, none, VQ_TRAIN_STEPS,
                host=(vq._seeds.get_state, vq._seeds.set_state), exact=cudnn_deterministic)
    log(f"video_gen: VQVAE3DTrainer video_gen_large (clip 1x3x{tcfg.max_frames}x{px}x{px}): "
        f"no kernel launch; graph and eager bit-equal")
    del vq, clips
    torch.cuda.empty_cache()
    return main_counts


# --- phase: multimodal --------------------------------------------------------

# multimodal_small (8 query heads over 4 groups of head dim 96, 12 layers) at
# the JAX bench's B=4, t_text=64: 64 + 256 + 2048 = 2368 slots; the ragged
# prompts of the K2 prefill at t_text 256; the phase's depth: multimodal_small's
# 12 layers cut to 2 with K6, to keep the whole script under 900 s (its eager
# loop of 2303 decode forwards is host-bound: its time goes with the depth)
MM_B, MM_T_TEXT = 4, 64
MM_SLOTS = MM_T_TEXT + 256 + 2048
MM_RAGGED = (256, 200, 131, 17)
MM_GEN_LAYERS = 2


def _mm_gate(label, fns, want):
    got = _counts(fns)
    _gate(label, got, want, phase="multimodal")
    return got


def run_multimodal(fns):
    """The fused stream at multimodal_small's full width (d768, 8/4 heads of
    96, vocabulary 4864) at MM_GEN_LAYERS of its 12 layers:
    ``generate_multimodal`` at the JAX bench's shape (B=4, t_text=64, 256
    image + 2048 video tokens a row: 2303 decode forwards; temperature 0.9,
    top-k 64), every step after the first replayed from a CUDA graph, and
    the eager loop (equal codes); a ragged call at t_text=256 (prompts
    256/200/131/17) whose prefill takes K2; 64 decode steps through the
    dense cache and the paged cache fed the same tokens (K3's dense and
    paged table modes; logits within LOGIT_ATOL).  Exact gates: K1 and K3's
    paged table mode once a layer a decode forward, K2 once a layer a
    prefill at t_text >= 256 and never at 64."""
    import torch

    from torch_card_parity import LOGIT_ATOL
    from vats_tpu_torch.configs import multimodal_small
    from vats_tpu_torch.inference import ImageGenerationSampler
    from vats_tpu_torch.inference.multimodal import _generate_multimodal
    from vats_tpu_torch.models import MultimodalLM
    from vats_tpu_torch.ops import cache_append as ca
    from vats_tpu_torch.ops import flash_attention as fa
    from vats_tpu_torch.ops.decode_attention import paged_decode_attention_commit

    none = {name: 0 for name in _counts(fns)}
    k1, k2 = paged_decode_attention_commit.__name__, fa.flash_attention.__name__
    ptab, dtab = ca.paged_decode_prologue.table.__name__, ca.dense_decode_prologue.table.__name__
    pp, dp = ca.paged_decode_prologue.__name__, ca.dense_decode_prologue.__name__
    cfg = multimodal_small(num_layers=MM_GEN_LAYERS)
    L = cfg.num_layers
    n_total = cfg.image_tokens + cfg.video_tokens
    model = MultimodalLM(cfg, device="cuda", seed=0).eval()
    gen = torch.Generator(device="cuda").manual_seed(61)
    sampler = ImageGenerationSampler(temperature=0.9, top_k=64)
    b = MM_B
    ids = torch.randint(1, cfg.text_vocab_size, (b, MM_T_TEXT), generator=gen, device="cuda")
    decode_want = dict(none)
    decode_want.update({k1: L * (n_total - 1), ptab: L * (n_total - 1), pp: L * (n_total - 1)})

    def drive(use_graph, text_ids=ids, mask=None, want=decode_want):
        _zero(fns)
        img, vid, _ = _generate_multimodal(
            model, text_ids, mask, torch.Generator(device="cuda").manual_seed(5),
            sampler=sampler, page_size=128, use_graph=use_graph)
        torch.cuda.synchronize()
        got = _mm_gate(f"generate_multimodal {'graph' if use_graph else 'eager'} t_text "
                       f"{text_ids.shape[1]}", fns, want)
        return img, vid, got

    (img, vid, got), (img_e, vid_e, _) = drive(True), drive(False)
    require(torch.equal(img, img_e) and torch.equal(vid, vid_e),
            "multimodal: graph and eager runs drew different codes")
    require(tuple(img.shape) == (b, cfg.image_grid_h, cfg.image_grid_w)
            and tuple(vid.shape) == (b, cfg.video_grid_t, cfg.video_grid_h, cfg.video_grid_w)
            and 0 <= int(img.min()) and int(img.max()) < cfg.image_vocab_size
            and 0 <= int(vid.min()) and int(vid.max()) < cfg.video_vocab_size,
            "multimodal: codes out of range")
    log(f"multimodal: generate_multimodal B={b} t_text {MM_T_TEXT} ({n_total} tokens a row, "
        f"{n_total - 1} decode forwards): launches {json.dumps(got)} both paths; graph and "
        f"eager codes equal")
    main_counts = {k_: v for k_, v in got.items() if v}

    # ragged prompts at t_text 256: the prefill takes K2 (L launches)
    t_long = MM_RAGGED[0]
    ids_long = torch.randint(1, cfg.text_vocab_size, (b, t_long), generator=gen, device="cuda")
    mask = torch.arange(t_long, device="cuda")[None, :] < torch.tensor(MM_RAGGED,
                                                                          device="cuda")[:, None]
    ids_long = torch.where(mask, ids_long, 0)
    want = dict(decode_want)
    want[k2] = L
    img_r, vid_r, got = drive(True, ids_long, mask, want=want)
    require(0 <= int(img_r.min()) and int(vid_r.max()) < cfg.video_vocab_size,
            "multimodal: ragged codes out of range")
    log(f"multimodal: ragged prompts {MM_RAGGED} at t_text {t_long} (graph): launches "
        f"{json.dumps(got)}")

    # the dense cache against the paged one: 64 decode steps fed the same
    # tokens after the same prefill (K3's dense table mode, the plain cached
    # attention; the paged table mode and K1)
    steps = min(64, cfg.image_tokens)
    feed = (img.reshape(b, -1)[:, :steps] + cfg.text_vocab_size).to(torch.int32)
    pre_mod = torch.zeros_like(ids)
    pre_loc = torch.arange(MM_T_TEXT, device="cuda")[None, :].expand(b, -1)

    def forced(paged):
        cache = (model.init_paged_cache(b, MM_SLOTS) if paged
                 else model.init_cache(b, MM_SLOTS))
        key = "paged_cache" if paged else "cache"
        out = []
        with torch.no_grad():
            lg, _ = model(ids, pre_mod, pre_loc, **{key: cache})
            for i in range(steps):
                one_mod = torch.full((b, 1), 1, dtype=torch.int32, device="cuda")
                one_loc = torch.full((b, 1), i, dtype=torch.int32, device="cuda")
                lg, _ = model(feed[:, i:i + 1], one_mod, one_loc, **{key: cache})
                out.append(lg[:, 0].float())
        return torch.stack(out, 1)

    _zero(fns)
    dense_lg = forced(False)
    got_d = _mm_gate("dense-cache decode", fns, {**none, dtab: L * steps, dp: L * steps})
    _zero(fns)
    paged_lg = forced(True)
    got_p = _mm_gate("paged-cache decode", fns, {**none, ptab: L * steps, pp: L * steps,
                                                  k1: L * steps})
    torch.testing.assert_close(dense_lg, paged_lg, atol=LOGIT_ATOL, rtol=0)
    log(f"multimodal: {steps} decode steps through the dense and the paged cache: logits "
        f"within {LOGIT_ATOL}; launches dense {json.dumps(got_d)} paged {json.dumps(got_p)}")
    del model
    torch.cuda.empty_cache()
    return main_counts


# --- phase: context_parallel ------------------------------------------------

CP_RANKS, CP_B, CP_T = 2, 2, 4096  # nlp_medium's max_seq_len: tl = 2048 a rank
CP_LAYERS = 5  # of medium_dense's 20 (10 until K6): depth cut to keep the whole run in its time
CP_WINDOWS = (-1, 384)  # no window; nlp_medium's own left_window
# Ring against single-process flash over the whole sequence, both bf16 on the
# card: the ring rounds each hop's output to bf16 before the fp32 merge and
# feeds K5a/K5b the merged lse and di of its own output, so the two part by
# a few bf16 roundings (2^-8 relative): each of out, dq, dk and dv is held to
# a relative L2 error ||ring - flash|| / ||flash|| of at most 1e-2.
CP_REL_L2 = 1e-2


def _rel_l2(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _cp_times(traffic):
    """A rank's seconds in its collectives, split as ``collectives.traffic``
    splits them."""
    return (f"in them waiting for queued device work {traffic['wait_s'] * 1e3:.1f} ms, "
            f"host staging copies {traffic['staging_s'] * 1e3:.1f} ms, exchange "
            f"{traffic['exchange_s'] * 1e3:.1f} ms")


def _cp_live_hops(rank, left_window):
    """The hops of ``_ring_steps`` that launch kernels on ``rank``."""
    from vats_tpu_torch.ops.ring_attention import _hop_offset, _ring_steps, _RingCfg

    cfg = _RingCfg(axis_name="seq", n_seq=CP_RANKS, t_local=CP_T // CP_RANKS, scale=1.0,
                   causal=True, left_window=left_window, right_window=0, use_segids=False)
    return sum(_hop_offset(cfg, rank, i, *alive) is not None
               for i, alive in enumerate(_ring_steps(cfg)))


def _cp_batch(vocab):
    import torch

    g = torch.Generator().manual_seed(12)
    ids = torch.randint(1, vocab, (CP_B, CP_T), generator=g, dtype=torch.int32)
    lens = torch.tensor([CP_T, CP_T - 40])
    mask = torch.arange(CP_T)[None, :] < lens[:, None]
    ids = torch.where(mask, ids, 0)
    labels = torch.cat([ids[:, 1:], torch.full((CP_B, 1), -100, dtype=torch.int32)], 1)
    labels = torch.where(torch.arange(CP_T)[None, :] < (lens - 1)[:, None], labels, -100)
    return {"input_ids": ids, "labels": labels, "padding_mask": mask}


def _cp_step(step, state, batch, fns, label):
    """One train step with the launch counters zeroed just before and read
    just after: (state, metrics as floats, counts, wall s)."""
    import torch

    for fn in fns:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch, 0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    metrics = {k: float(v) for k, v in m.items()}
    require(all(np.isfinite(list(metrics.values()))), f"{label}: non-finite {metrics}")
    return state, metrics, {fn.__name__: fn.launches for fn in fns}, wall


def cp_rank(rank, init_file, queue, t_spawn):
    """One rank of the context_parallel phase (a spawned process on cuda:0;
    gloo, CUDA tensors staged through host buffers).  ``t_spawn``: the
    parent's clock when it started the ranks."""
    import traceback

    try:
        queue.put((rank, _cp_rank(rank, init_file, t_spawn)))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def _cp_rank(rank, init_file, t_spawn):
    import torch

    sys.path.insert(0, HERE)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    from vats_tpu_torch.models import TextLM
    from vats_tpu_torch.ops import flash_attention as fa
    from vats_tpu_torch.ops.ring_attention import ring_attention
    from vats_tpu_torch.parallel import collectives, create_mesh
    from vats_tpu_torch.parallel.multihost import initialize_multihost
    from vats_tpu_torch.parallel.sharded import make_sharded_train
    from vats_tpu_torch.train import create_optimizer, create_train_state, make_train_step

    initialize_multihost(f"file://{init_file}", CP_RANKS, rank, backend="gloo")
    mesh = create_mesh(data=1, fsdp=1, expert=1, tensor=1, seq=CP_RANKS)
    torch.zeros(1, device="cuda")  # the CUDA context
    fns = (fa.flash_attention, fa.flash_attention_lse, fa.flash_bwd_dkv, fa.flash_bwd_dq)
    out = {"start_s": time.perf_counter() - t_spawn, "ring": {}, "train": {}}
    tl = CP_T // CP_RANKS
    sl = slice(rank * tl, (rank + 1) * tl)

    # ring attention at nlp_medium's attention shape against single-process
    # flash: the flash ring (K2' / K5a / K5b a live hop), then the blockwise
    # ring (impl="xla", no kernel) against both
    gen = torch.Generator(device="cuda").manual_seed(21)
    q, k, v, do = _train_attention_inputs(gen, CP_B, CP_T, TRAIN_HQ, TRAIN_G, TRAIN_HD)
    scale = 1.0 / TRAIN_HD**0.5
    out["ring_xla"] = {}
    for impl in ("flash", "xla"):  # a warm-up of each, so the first window's times are warm
        shards = [x[:, sl].clone().requires_grad_() for x in (q, k, v)]
        ring_attention(*shards, mesh=mesh, impl=impl, scale=scale).backward(do[:, sl])
    del shards
    for lw in CP_WINDOWS:
        kw = dict(scale=scale, causal=True, left_window=lw)
        full = [x.clone().requires_grad_() for x in (q, k, v)]
        ref = fa.flash_attention(*full, **kw)
        ref.backward(do)
        flash = [ref[:, sl]] + [x.grad[:, sl] for x in full]
        del full, ref
        got = {}
        for impl in ("flash", "xla"):
            shards = [x[:, sl].clone().requires_grad_() for x in (q, k, v)]
            for fn in fns:
                fn.launches = 0
            collectives.reset_traffic()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            o = ring_attention(*shards, mesh=mesh, impl=impl, **kw)
            torch.cuda.synchronize()
            fwd = time.perf_counter() - t0
            o.backward(do[:, sl])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            res = [o.detach()] + [x.grad for x in shards]
            names = ("out", "dq", "dk", "dv")
            errs = {n: _rel_l2(a, b) for n, a, b in zip(names, res, flash)}
            entry = dict(errs=errs, counts={fn.__name__: fn.launches for fn in fns},
                         fwd=fwd, wall=wall, traffic=dict(collectives.traffic),
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                         hops=_cp_live_hops(rank, lw))
            if impl == "xla":  # against the flash ring too
                entry["errs_ring"] = {n: _rel_l2(a, b) for n, a, b in zip(names, res, got)}
            got = res
            out["ring" if impl == "flash" else "ring_xla"][lw] = entry
            del shards, o
        del flash, got, res
    del q, k, v, do

    # the sequence-parallel train step at medium_dense's full width, CP_LAYERS deep
    targs = train_args()
    batch = _cp_batch(train_cfg("medium_dense").vocab_size)
    keep = {}
    for mode in ("ring", "ulysses"):
        cfg = train_cfg("medium_dense", max_seq_len=CP_T, dropout=0.0, context_parallel=mode,
                        num_layers=CP_LAYERS)
        model = TextLM(cfg, device="cuda", seed=0)
        init, step, _ = make_sharded_train(model, targs, mesh, batch, num_training_steps=20)
        state = init()
        torch.cuda.reset_peak_memory_stats()
        # step 0 runs at lr 0: the second step sees the same weights
        state, _, _, warm = _cp_step(step, state, batch, fns, f"{mode} warm-up")
        collectives.reset_traffic()
        state, m, counts, wall = _cp_step(step, state, batch, fns, mode)
        out["train"][mode] = dict(metrics=m, counts=counts, wall=wall, warm=warm,
                                  traffic=dict(collectives.traffic),
                                  peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                                  layers=cfg.num_layers,
                                  grad_bytes=sum(p.numel() * 4 for p in model.parameters()))
        if rank == 0:
            keep[mode] = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        del model, state, init, step
        torch.cuda.empty_cache()

    if rank == 0:  # the single-process step on the whole batch, same weights
        cfg = train_cfg("medium_dense", max_seq_len=CP_T, dropout=0.0, num_layers=CP_LAYERS)
        model = TextLM(cfg, device="cuda", seed=0)
        state = create_train_state(model, create_optimizer(targs, 20))
        step = make_train_step(model, targs)
        dev_batch = {k_: v_.cuda() for k_, v_ in batch.items()}
        torch.cuda.reset_peak_memory_stats()
        state, _, _, warm = _cp_step(step, state, dev_batch, fns, "single warm-up")
        state, m, counts, wall = _cp_step(step, state, dev_batch, fns, "single")
        single = {n: p.grad.detach() for n, p in model.named_parameters()}
        out["single"] = dict(metrics=m, counts=counts, wall=wall, warm=warm,
                             peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        for mode, grads in keep.items():
            errs = {}
            for n, g in grads.items():
                d, nb = float((g - single[n]).float().norm()), float(single[n].float().norm())
                errs[n] = d / nb if nb > 0 else (0.0 if d == 0 else float("inf"))
            out["train"][mode]["leaf_errs"] = errs
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    out["total_s"] = time.perf_counter() - t_spawn
    return out


def run_context_parallel():
    """CP_RANKS ranks spawned on cuda:0 over gloo (host-staged): ring
    attention at nlp_medium's attention shape over T = CP_T against
    single-process flash, and one sequence-parallel medium_dense step at T =
    CP_T with ring and with Ulysses against the single-process step; exact
    per-rank K2', K5a, K5b launch gates."""
    import multiprocessing as mp
    import queue as queue_mod
    import tempfile

    import torch
    import torch_card_parity as parity

    t0 = time.perf_counter()
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = card_line()
    log(f"context_parallel: compute mode {mode}; {CP_RANKS} ranks on cuda:0, gloo with "
        f"CUDA tensors staged through host buffers; {card}")
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        t_spawn = time.perf_counter()  # CLOCK_MONOTONIC: the ranks read the same clock
        procs = [ctx.Process(target=cp_rank,
                             args=(r, os.path.join(tmp, "init"), queue, t_spawn))
                 for r in range(CP_RANKS)]
        for p in procs:
            p.start()
        results = {}
        deadline = time.perf_counter() + 600
        try:
            while len(results) < CP_RANKS and time.perf_counter() < deadline:
                try:
                    r, res = queue.get(timeout=5)
                except queue_mod.Empty:
                    if any(p.exitcode not in (None, 0) for p in procs):
                        break  # a rank died without a word
                    continue
                results[r] = res
                if "error" in res:
                    break
        finally:
            whole = len(results) == CP_RANKS and not any("error" in v for v in results.values())
            for p in procs:
                p.join(60 if whole else 0)
                if p.is_alive():
                    p.kill()
                    p.join()
    errors = {r: res.get("error") for r, res in results.items() if "error" in res}
    require(len(results) == CP_RANKS and not errors
            and all(p.exitcode == 0 for p in procs),
            f"context_parallel: ranks failed or did not report (exit codes "
            f"{[p.exitcode for p in procs]}, reports from {sorted(results)}): "
            + "\n".join(f"rank {r}:\n{e}" for r, e in errors.items()))

    for r in range(CP_RANKS):
        res = results[r]
        for lw, ring in res["ring"].items():
            h = ring["hops"]
            want = {"flash_attention": 0, "flash_attention_lse": h, "flash_bwd_dkv": h,
                    "flash_bwd_dq": h}
            require(ring["counts"] == want, f"context_parallel: ring (left_window {lw}) "
                    f"rank {r} launched {ring['counts']}, expected {want}")
            bad = {k: e for k, e in ring["errs"].items() if not e <= CP_REL_L2}
            require(not bad, f"context_parallel: ring (left_window {lw}) rank {r} beyond "
                    f"{CP_REL_L2} relative L2 of single-process flash: {bad}")
            log(f"context_parallel: ring attention B={CP_B} T={CP_T} (tl {CP_T // CP_RANKS}) "
                f"Hq={TRAIN_HQ} G={TRAIN_G} hd={TRAIN_HD} bf16 causal left_window {lw}, rank "
                f"{r}: {h} live hops, launches {ring['counts']}; relative L2 against "
                f"single-process flash " + ", ".join(f"{k} {e:.2e}" for k, e in
                                                     ring["errs"].items())
                + f" (limit {CP_REL_L2}); forward + backward {ring['wall'] * 1e3:.1f} ms, "
                f"{ring['traffic']['bytes'] / 1e6:.1f} MB sent in {ring['traffic']['calls']} "
                f"collectives, {_cp_times(ring['traffic'])}; {card}")
            bw = res["ring_xla"][lw]
            require(all(n == 0 for n in bw["counts"].values()), f"context_parallel: the "
                    f"blockwise ring (left_window {lw}) rank {r} launched {bw['counts']}")
            bad = {f"{k} against {against}": e
                   for against, errs in (("flash", bw["errs"]), ("the flash ring",
                                                                 bw["errs_ring"]))
                   for k, e in errs.items() if not e <= CP_REL_L2}
            require(not bad, f"context_parallel: blockwise ring (left_window {lw}) rank {r} "
                    f"beyond {CP_REL_L2} relative L2: {bad}")
            log(f"context_parallel: blockwise ring (impl='xla', tiles 512 x 512, no kernel) "
                f"at the same shape, left_window {lw}, rank {r}: launches {bw['counts']}; "
                f"relative L2 against single-process flash "
                + ", ".join(f"{k} {e:.2e}" for k, e in bw["errs"].items())
                + ", against the flash ring " + ", ".join(
                    f"{k} {e:.2e}" for k, e in bw["errs_ring"].items())
                + f" (limit {CP_REL_L2}); forward {bw['fwd'] * 1e3:.1f} ms, forward + "
                f"backward {bw['wall'] * 1e3:.1f} ms, {bw['traffic']['bytes'] / 1e6:.1f} MB "
                f"sent in {bw['traffic']['calls']} collectives, {_cp_times(bw['traffic'])}; "
                f"peak memory {bw['peak_gb']:.2f} GB; the flash ring: forward "
                f"{ring['fwd'] * 1e3:.1f} ms, forward + backward {ring['wall'] * 1e3:.1f} ms, "
                f"peak memory {ring['peak_gb']:.2f} GB; {card}")
        for mode, tr in res["train"].items():
            h = _cp_live_hops(r, -1) if mode == "ring" else 0
            L = tr["layers"]
            want = {"flash_attention": 0, "flash_attention_lse": 2 * L * h,
                    "flash_bwd_dkv": L * h, "flash_bwd_dq": L * h}
            require(tr["counts"] == want, f"context_parallel: {mode} step rank {r} "
                    f"launched {tr['counts']}, expected {want}")
            ring_mb = (tr["traffic"]["bytes"] - tr["grad_bytes"]) / 1e6
            log(f"context_parallel: {mode} step rank {r} (medium_dense d1440/{L}L, B={CP_B} "
                f"T={CP_T}, seq={CP_RANKS}): loss {tr['metrics']['loss']:.5f} grad norm "
                f"{tr['metrics']['grad_norm']:.5f} tokens {tr['metrics']['tokens']:.0f}; "
                f"launches {tr['counts']}; step wall {tr['wall'] * 1e3:.1f} ms (warm-up "
                f"{tr['warm'] * 1e3:.1f}); {tr['traffic']['bytes'] / 1e6:.1f} MB sent in "
                f"{tr['traffic']['calls']} collectives ({tr['grad_bytes'] / 1e6:.1f} MB the "
                f"gradient all-reduce, {ring_mb:.1f} MB attention and metrics), "
                f"{_cp_times(tr['traffic'])}; peak memory {tr['peak_gb']:.2f} GB; {card}")
        log(f"context_parallel: rank {r} joined the world with a CUDA context "
            f"{res['start_s']:.1f} s after the spawn, ended at {res['total_s']:.1f} s")
    single = results[0]["single"]
    log(f"context_parallel: single-process step (whole batch, one process): loss "
        f"{single['metrics']['loss']:.5f} grad norm {single['metrics']['grad_norm']:.5f}; "
        f"launches {single['counts']}; step wall {single['wall'] * 1e3:.1f} ms (warm-up "
        f"{single['warm'] * 1e3:.1f}); peak memory {single['peak_gb']:.2f} GB; {card}")
    for mode in ("ring", "ulysses"):
        tr = results[0]["train"][mode]
        dl = abs(tr["metrics"]["loss"] - single["metrics"]["loss"])
        dn = abs(tr["metrics"]["grad_norm"] - single["metrics"]["grad_norm"])
        require(dl <= parity.PARITY_LOSS_ATOL
                and dn <= parity.PARITY_NORM_RTOL * single["metrics"]["grad_norm"],
                f"context_parallel: {mode} step loss {tr['metrics']['loss']} / grad norm "
                f"{tr['metrics']['grad_norm']} against single {single['metrics']}")
        log(f"context_parallel: {mode} against the single-process step: |loss diff| "
            f"{dl:.2e} (limit {parity.PARITY_LOSS_ATOL}), |grad norm diff| {dn:.2e} (limit "
            f"{parity.PARITY_NORM_RTOL} relative); "
            + parity.leaf_report(f"{mode} gradients", tr["leaf_errs"],
                                 parity.PARITY_LEAF_GRAD_RTOL))
    log(f"context_parallel: phase {time.perf_counter() - t0:.1f} s (its budget: 90 s)")


# --- phase: sharded ---------------------------------------------------------

SH_RANKS, SH_B, SH_T = 4, 4, 512
SH_STEPS = 10  # the schedule's length: no warmup step, so step 0 moves the weights
SH_LAYERS = 2  # of medium_moe's 12 (4 until K6): depth cut to keep the whole run in its time
# The step in fp32 first, then in bf16 (the config's own compute dtype).  Each
# is held to its single-process step's loss and grad norm and dropped
# assignments; the fp32 step also leaf by leaf (the card tests' train limits): in
# bf16 the sharded and single steps round differently, a router near a tie
# picks another expert, and at capacity the slot-major order then keeps
# other tokens, so a few of 2048 tokens take another path through the layer
# and every weight's gradient moves by a few percent (read on an H100: worst
# leaf 8.9e-2, median 5.0e-2), as the image-gen trainer's quantizer argmin
# flips in bf16 (its card test against the CPU steps it in fp32).
SH_DTYPES = ("float32", "bfloat16")
SH_LEAF_DTYPE = "float32"
SH_MESHES = (("fsdp=2 x expert=2", dict(data=1, fsdp=2, expert=2, tensor=1, seq=1)),
             ("fsdp=2 x tensor=2", dict(data=1, fsdp=2, expert=1, tensor=2, seq=1)))


def _sh_batch(vocab):
    import torch

    g = torch.Generator().manual_seed(13)
    ids = torch.randint(1, vocab, (SH_B, SH_T), generator=g, dtype=torch.int32)
    lens = torch.tensor([SH_T, SH_T - 40, SH_T, SH_T - 7])
    mask = torch.arange(SH_T)[None, :] < lens[:, None]
    ids = torch.where(mask, ids, 0)
    labels = torch.cat([ids[:, 1:], torch.full((SH_B, 1), -100, dtype=torch.int32)], 1)
    labels = torch.where(torch.arange(SH_T)[None, :] < (lens - 1)[:, None], labels, -100)
    return {"input_ids": ids, "labels": labels, "padding_mask": mask}


def _to_root(t, info):
    """The whole leaf on rank 0 (fp32, host), None on the other ranks: one
    gather of every rank's block to rank 0, each placed by its rank's
    coordinates (a replicated leaf is rank 0's own)."""
    import torch
    import torch.distributed as dist

    rank = dist.get_rank()
    host = t.detach().float().cpu().clone()
    if info is None:
        return host if rank == 0 else None
    parts = [torch.empty_like(host) for _ in range(dist.get_world_size())] if rank == 0 \
        else None
    dist.gather(host, parts, dst=0)
    if rank != 0:
        return None
    whole = torch.empty(info.shape, dtype=torch.float32)
    for r, part in enumerate(parts):
        coords = dict(zip(info.mesh.axis_names, np.argwhere(info.mesh.devices == r)[0]))
        whole[tuple(slice(None) if a is None else slice(int(coords[a]) * n, int(coords[a] + 1) * n)
                    for a, n in zip(info.spec, part.shape))] = part
    return whole


def _sh_routing(layers):
    return [tuple(x.detach().cpu() for x in (m.routing["experts"], m.routing["keep"],
                                             m.routing["probs"])) for m in layers]


def _sh_flips(single, sharded):
    """Per MoE layer: (dropped assignments single, sharded, tokens whose
    experts differ, the allowance), as ``router_flips`` reads a flip: every
    flipped expert's probability within twice the token's own
    single-vs-sharded probability gap of the k-th on both sides, else it
    raises.  The allowance is the assignments the flips move: a moved
    assignment changes the dropped count by at most one."""
    out = []
    for layer, ((es, ks, ps), (eh, kh, ph)) in enumerate(zip(single, sharded)):
        k = es.shape[1]
        flipped = (es.sort(dim=1).values != eh.sort(dim=1).values).any(dim=1).nonzero()[:, 0]
        allowance = 0
        for tok in flipped.tolist():
            diff = set(es[tok].tolist()) ^ set(eh[tok].tolist())
            gap = float((ps[tok] - ph[tok]).abs().max())
            for probs in (ps[tok], ph[tok]):
                kth = float(probs.topk(k).values[-1])
                require(all(abs(float(probs[e]) - kth) <= 2 * gap for e in diff),
                        f"sharded: layer {layer} token {tok} routes to other experts than the "
                        f"single-process step, not a near tie (gap {gap:.2e})")
            allowance += len(diff) // 2
        out.append((int((~ks).sum()), int((~kh).sum()), len(flipped), allowance))
    return out


def sh_rank(rank, init_file, queue, t_spawn):
    """One rank of the sharded phase (a spawned process on cuda:0; gloo,
    CUDA tensors staged through host buffers)."""
    import traceback

    try:
        queue.put((rank, _sh_rank(rank, init_file, t_spawn)))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def _sh_rank(rank, init_file, t_spawn):
    import torch
    import torch_card_parity as parity
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    from vats_tpu_torch.models import TextLM
    from vats_tpu_torch.nn.moe import MoELayer
    from vats_tpu_torch.ops import flash_attention as fa
    from vats_tpu_torch.parallel import collectives, create_mesh
    from vats_tpu_torch.parallel.layout import spec_bytes, tensor_bytes
    from vats_tpu_torch.parallel.multihost import initialize_multihost
    from vats_tpu_torch.parallel.sharded import make_sharded_train
    from vats_tpu_torch.train import create_optimizer, create_train_state, make_train_step

    initialize_multihost(f"file://{init_file}", SH_RANKS, rank, backend="gloo")
    torch.zeros(1, device="cuda")  # the CUDA context
    fns = (fa.flash_attention, fa.flash_attention_lse, fa.flash_bwd_dkv, fa.flash_bwd_dq)
    out = {"start_s": time.perf_counter() - t_spawn, "single": {}, "meshes": {}}
    targs = train_args()
    cfgs = {dt: train_cfg("medium_moe", dropout=0.0, dtype=dt, num_layers=SH_LAYERS)
            for dt in SH_DTYPES}
    batch = _sh_batch(cfgs["bfloat16"].vocab_size)

    def routed(model):
        layers = [m for m in model.modules() if isinstance(m, MoELayer)]
        for m in layers:
            m.record_routing = True
        return layers

    ref = {}
    if rank == 0:  # the single-process steps first: same weights, same batch
        for dt, cfg in cfgs.items():
            model = TextLM(cfg, device="cuda", seed=0)
            layers = routed(model)
            state = create_train_state(model, create_optimizer(targs, SH_STEPS))
            start = {n: p.detach().float().cpu().clone() for n, p in model.named_parameters()}
            torch.cuda.reset_peak_memory_stats()
            step = make_train_step(model, targs)
            # eagerly: the routers keep their routing as Python attributes,
            # which a replay cannot update, so the graph refuses them
            step.graphs.use_graph = False
            state, m, counts, wall = _cp_step(step, state,
                                              {k: v.cuda() for k, v in batch.items()}, fns,
                                              f"sharded: single-process step {dt}")
            if dt == SH_LEAF_DTYPE:
                ref["leaves"] = {n: (parity.leaf_grad(n, p).detach().float().cpu().clone(),
                                     p.detach().float().cpu().clone())
                                 for n, p in model.named_parameters()}
                ref["moved"] = {n: float((a - start[n]).norm())
                                for n, (_, a) in ref["leaves"].items()}
            del start
            ref[dt] = _sh_routing(layers)
            out["single"][dt] = dict(
                metrics=m, counts=counts, wall=wall,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                resident=tensor_bytes(state.params) + tensor_bytes(state.opt_state),
                params=sum(p.numel() for p in model.parameters()))
            del model, state, layers, step
            torch.cuda.empty_cache()
    dist.barrier()

    for label, sizes in SH_MESHES:
        mesh = create_mesh(**sizes)
        for dt, cfg in cfgs.items():
            model = TextLM(cfg, device="cuda", seed=0)
            layers = routed(model)
            init, step, _ = make_sharded_train(model, targs, mesh, batch,
                                               num_training_steps=SH_STEPS)
            state = init()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            collectives.reset_traffic()
            state, m, counts, wall = _cp_step(step, state, batch, fns, f"sharded {label} {dt}")
            res = dict(metrics=m, counts=counts, wall=wall, traffic=dict(collectives.traffic),
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                       resident=tensor_bytes(state.params) + tensor_bytes(state.opt_state),
                       spec_resident=spec_bytes(state.params) + spec_bytes(state.opt_state),
                       params=sum(p.numel() for p in model.parameters()))
            if rank == 0:
                res["flips"] = _sh_flips(ref[dt], _sh_routing(layers))
            if dt == SH_LEAF_DTYPE:
                errs_g, errs_c = {}, {}
                for n, p in model.named_parameters():  # every rank: the gathers pair
                    g = _to_root(parity.leaf_grad(n, p), getattr(p, "shard_info", None))
                    a = _to_root(p, getattr(p, "shard_info", None))
                    if rank == 0:
                        rg, ra = (x.cuda() for x in ref["leaves"][n])
                        nb = float(rg.norm())
                        d = float((g.cuda() - rg).norm())
                        errs_g[n] = d / nb if nb > 0 else (0.0 if d == 0 else float("inf"))
                        d, moved = float((a.cuda() - ra).norm()), ref["moved"][n]
                        errs_c[n] = d / moved if moved > 0 else (0.0 if d == 0 else
                                                                 float("inf"))
                res.update(errs_grad=errs_g, errs_change=errs_c)
            out["meshes"][(label, dt)] = res
            del model, state, init, step, layers
            torch.cuda.empty_cache()
            dist.barrier()
    dist.destroy_process_group()
    out["total_s"] = time.perf_counter() - t_spawn
    return out


def run_sharded():
    """SH_RANKS ranks spawned on cuda:0 over gloo (host-staged): one
    medium_moe step at full width, SH_LAYERS of its 12 layers, on each mesh of SH_MESHES
    against the single-process step from the same weights and batch;
    exact per-rank K2', K5a, K5b gates; resident bytes a rank against the
    specs."""
    import multiprocessing as mp
    import queue as queue_mod
    import tempfile

    import torch
    import torch_card_parity as parity

    t0 = time.perf_counter()
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = card_line()
    log(f"sharded: compute mode {mode}; {SH_RANKS} ranks on cuda:0, gloo with CUDA tensors "
        f"staged through host buffers; {card}")
    require("exclusive" not in mode.lower(),
            f"sharded: compute mode {mode} admits one process: the ranks cannot share the card")
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        t_spawn = time.perf_counter()
        procs = [ctx.Process(target=sh_rank,
                             args=(r, os.path.join(tmp, "init"), queue, t_spawn))
                 for r in range(SH_RANKS)]
        for p in procs:
            p.start()
        results = {}
        deadline = time.perf_counter() + 600
        try:
            while len(results) < SH_RANKS and time.perf_counter() < deadline:
                try:
                    r, res = queue.get(timeout=5)
                except queue_mod.Empty:
                    if any(p.exitcode not in (None, 0) for p in procs):
                        break
                    continue
                results[r] = res
                if "error" in res:
                    break
        finally:
            whole = len(results) == SH_RANKS and not any("error" in v for v in results.values())
            for p in procs:
                p.join(60 if whole else 0)
                if p.is_alive():
                    p.kill()
                    p.join()
    errors = {r: res.get("error") for r, res in results.items() if "error" in res}
    require(len(results) == SH_RANKS and not errors and all(p.exitcode == 0 for p in procs),
            f"sharded: ranks failed or did not report (exit codes "
            f"{[p.exitcode for p in procs]}, reports from {sorted(results)}): "
            + "\n".join(f"rank {r}:\n{e}" for r, e in errors.items()))

    cfg = train_cfg("medium_moe", num_layers=SH_LAYERS)
    L = cfg.num_layers
    want = {"flash_attention": 0, "flash_attention_lse": 2 * L, "flash_bwd_dkv": L,
            "flash_bwd_dq": L}
    for dt in SH_DTYPES:
        single = results[0]["single"][dt]
        require(single["counts"] == want, f"sharded: single-process step ({dt}) launched "
                f"{single['counts']}, expected {want}")
        sm = single["metrics"]
        log(f"sharded: single-process step {dt} (medium_moe d{cfg.d_model}/{L}L, "
            f"E{cfg.num_experts} top-{cfg.top_k}, capacity {cfg.capacity_factor}, B={SH_B} "
            f"T={SH_T}, one process): loss {sm['loss']:.5f} grad norm {sm['grad_norm']:.5f}; "
            f"launches {single['counts']}; step wall {single['wall'] * 1e3:.1f} ms; "
            f"{single['params'] / 1e9:.4f} B parameters, resident params + optimizer state "
            f"{single['resident'] / 1e9:.4f} GB; peak memory {single['peak_gb']:.2f} GB; {card}")
    for label, _ in SH_MESHES:
        for dt in SH_DTYPES:
            single = results[0]["single"][dt]
            for r in range(SH_RANKS):
                res = results[r]["meshes"][(label, dt)]
                require(res["resident"] == res["spec_resident"],
                        f"sharded {label} {dt} rank {r}: resident {res['resident']} bytes, the "
                        f"specs give {res['spec_resident']}")
                require(res["counts"] == want, f"sharded {label} {dt} rank {r} launched "
                        f"{res['counts']}, expected {want}")
                by_axis = ", ".join(f"{k} {v / 1e6:.1f} MB" for k, v in
                                    sorted(res["traffic"]["by_axis"].items()))
                log(f"sharded {label} {dt} rank {r}: loss {res['metrics']['loss']:.5f} grad "
                    f"norm {res['metrics']['grad_norm']:.5f}; launches {res['counts']}; step "
                    f"wall {res['wall'] * 1e3:.1f} ms; {res['traffic']['bytes'] / 1e6:.1f} MB "
                    f"sent in {res['traffic']['calls']} collectives ({by_axis}), "
                    f"{_cp_times(res['traffic'])}; resident params + optimizer state "
                    f"{res['resident'] / 1e9:.4f} GB = the specs' sum (one process "
                    f"{single['resident'] / 1e9:.4f} GB, ratio "
                    f"{res['resident'] / single['resident']:.4f}), "
                    f"{res['params'] / 1e9:.4f} B parameters a rank; peak memory "
                    f"{res['peak_gb']:.2f} GB (one process {single['peak_gb']:.2f} GB); {card}")
            res, sm = results[0]["meshes"][(label, dt)], single["metrics"]
            st = res["metrics"]
            dl = abs(st["loss"] - sm["loss"])
            dn = abs(st["grad_norm"] - sm["grad_norm"])
            drops = [f"{ds}/{dh}" + (f" ({fl} tokens routed elsewhere, allowance {al})"
                                     if fl else "") for ds, dh, fl, al in res["flips"]]
            log(f"sharded {label} {dt} against the single-process step: |loss diff| {dl:.2e} "
                f"(limit {parity.PARITY_LOSS_ATOL}), |grad norm diff| {dn:.2e} (limit "
                f"{parity.PARITY_NORM_RTOL} relative); dropped assignments a layer single/sharded: "
                f"{', '.join(drops)}")
            require(dl <= parity.PARITY_LOSS_ATOL
                    and dn <= parity.PARITY_NORM_RTOL * sm["grad_norm"],
                    f"sharded {label} {dt}: loss {st['loss']} / grad norm {st['grad_norm']} "
                    f"against single {sm}")
            for layer, (ds, dh, flips, allowance) in enumerate(res["flips"]):
                require(abs(ds - dh) <= allowance, f"sharded {label} {dt} layer {layer}: "
                        f"dropped {dh} assignments, the single-process step {ds}, {flips} "
                        f"tokens routed elsewhere (allowance {allowance})")
            if dt == SH_LEAF_DTYPE:
                log(f"sharded {label} {dt}: "
                    + parity.leaf_report(f"{label} gradients", res["errs_grad"],
                                         parity.PARITY_LEAF_GRAD_RTOL)
                    + "; " + parity.leaf_report(f"{label} change in the step", res["errs_change"],
                                                parity.PARITY_LEAF_CHANGE_RTOL))
    for r in range(SH_RANKS):
        log(f"sharded: rank {r} joined the world with a CUDA context "
            f"{results[r]['start_s']:.1f} s after the spawn, ended at "
            f"{results[r]['total_s']:.1f} s")
    log(f"sharded: phase {time.perf_counter() - t0:.1f} s (its budget: 180 s)")


# --- phase: pipeline --------------------------------------------------------

PP_RANKS, PP_B, PP_T = 4, 8, 512
PP_LAYERS = 8  # of medium_dense's 20, two blocks a stage: depth cut to keep the run in its time
PP_MICRO = (4, 8)  # M: microbatches of 2 and of 1 row
PP_PARITY_M = 4
PP_TIMED_STEPS = 3
# The pipelined step against the single-process step, both fp32 on the card
# through the same kernels: the two differ only in the order of fp32 sums
# (each weight's gradient summed over 4 microbatches, not in one product,
# and other GEMM shapes), ~1e-6 relative a sum, so every limit below is
# >= 100x that, and far under the card tests' 0.04 / 0.2 (PARITY_LEAF_*), which
# hold the card against the CPU: logits relative L2, |loss - single|, each rank's
# own layers and the replicated leaves leaf by leaf (gradient relative L2;
# the change in one AdamW update against the single step's change).  The
# replicated leaves' gradients are the same computation on the same inputs
# on every rank: held equal to rank 0's within PP_REPLICA_RTOL.
PP_LOGIT_RTOL = 1e-4
PP_LOSS_ATOL = 1e-4
PP_LEAF_GRAD_RTOL = 1e-3
PP_LEAF_CHANGE_RTOL = 1e-2
PP_REPLICA_RTOL = 1e-6


def _pp_batch(vocab):
    import torch

    g = torch.Generator().manual_seed(14)
    ids = torch.randint(1, vocab, (PP_B, PP_T), generator=g, dtype=torch.int32)
    lens = torch.tensor([PP_T, PP_T - 40, PP_T, PP_T - 7, PP_T, PP_T - 100, PP_T, PP_T - 1])
    mask = torch.arange(PP_T)[None, :] < lens[:, None]
    ids = torch.where(mask, ids, 0)
    labels = torch.cat([ids[:, 1:], torch.full((PP_B, 1), -100, dtype=torch.int32)], 1)
    labels = torch.where(torch.arange(PP_T)[None, :] < (lens - 1)[:, None], labels, -100)
    return {"input_ids": ids, "labels": labels, "padding_mask": mask}


def _pp_loss(logits, labels):
    import torch.nn.functional as F

    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long(),
                           ignore_index=-100)


def _pp_predicted_bytes(cfg, m):
    """Bytes a rank sends in one pipelined step over the stage axis: M + S - 1
    shifts of the packed state (x in the compute dtype, fp32 aux, int8 mask)
    and as many of its gradient (x, aux), the output collect's all-reduces
    (x, aux, mask over the whole batch) and the input gradient's
    all-reduce (x)."""
    from vats_tpu_torch.parallel.collectives import _ALIGN  # a shift's packing

    def packed(*nbytes):
        return sum(-(-n // _ALIGN) * _ALIGN for n in nbytes)

    mb, ticks = PP_B // m, m + PP_RANKS - 1
    x_el = 2 if cfg.dtype == "bfloat16" else 4
    x_mb, x_all = mb * PP_T * cfg.d_model * x_el, PP_B * PP_T * cfg.d_model * x_el
    return (ticks * packed(x_mb, 4 * mb, mb * PP_T) + ticks * packed(x_mb, 4 * mb)
            + (x_all + 4 * PP_B + PP_B * PP_T) + x_all)


def _pp_stage_bytes(cfg, mu_el):
    """Params + AdamW state a rank keeps, from the config's shapes alone:
    the embedding, final norm (and head) whole, L/S blocks; mu at ``mu_el``
    bytes an element, nu as the param, the count."""
    from vats_tpu_torch.models import TextLM

    whole = TextLM(cfg, device="meta")
    per = cfg.num_layers // PP_RANKS
    total = 0
    for name, p in whole.named_parameters():
        if name.startswith("layers.") and int(name.split(".")[1]) >= per:
            continue  # every stage holds per blocks of the same shapes
        total += p.numel() * (2 * p.element_size() + mu_el)
    return total + 4


def pp_rank(rank, init_file, queue, t_spawn):
    """One rank of the pipeline phase (a spawned process on cuda:0; gloo, CUDA
    tensors staged through host buffers)."""
    import traceback

    try:
        queue.put((rank, _pp_rank(rank, init_file, t_spawn)))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def _pp_rank(rank, init_file, t_spawn):
    import torch
    import torch_card_parity as parity
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    from vats_tpu_torch.models import TextLM
    from vats_tpu_torch.ops import flash_attention as fa
    from vats_tpu_torch.parallel import Mesh, collectives
    from vats_tpu_torch.parallel.layout import tensor_bytes
    from vats_tpu_torch.parallel.multihost import initialize_multihost
    from vats_tpu_torch.parallel.pipeline import pipeline_text_lm_apply, stage_model
    from vats_tpu_torch.train import create_optimizer

    initialize_multihost(f"file://{init_file}", PP_RANKS, rank, backend="gloo")
    torch.zeros(1, device="cuda")  # the CUDA context
    mesh = Mesh(np.arange(PP_RANKS), ("stage",))
    fns = (fa.flash_attention, fa.flash_attention_lse, fa.flash_bwd_dkv, fa.flash_bwd_dq)
    out = {"start_s": time.perf_counter() - t_spawn, "timed": {}, "single": {}}
    targs = train_args()
    cfgs = {dt: train_cfg("medium_dense", dropout=0.0, gradient_checkpointing=False, dtype=dt,
                          num_layers=PP_LAYERS)
            for dt in ("float32", "bfloat16")}
    batch = {k: v.cuda() for k, v in _pp_batch(cfgs["float32"].vocab_size).items()}
    ids, mask, labels = batch["input_ids"], batch["padding_mask"], batch["labels"]
    shift_s = [0.0]
    plain_shift = collectives.shift

    def timed_shift(*a, **kw):  # the pipeline's shifts alone, forward and backward
        t0 = time.perf_counter()
        try:
            return plain_shift(*a, **kw)
        finally:
            shift_s[0] += time.perf_counter() - t0

    collectives.shift = timed_shift

    def step(model, state, forward):
        """zero grads, forward, loss, backward, AdamW; (loss, logits, wall s,
        launches, traffic, shift s)."""
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        for fn in fns:
            fn.launches = 0
        collectives.reset_traffic()
        shift_s[0] = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = forward(model)
        loss = _pp_loss(logits, labels)
        loss.backward()
        with torch.no_grad():
            state.tx.update_(params, {n: p.grad for n, p in params.items()}, state.opt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        value = float(loss.detach())
        require(np.isfinite(value), f"pipeline: non-finite loss {value}")
        return (value, logits.detach(), wall, {fn.__name__: fn.launches for fn in fns},
                dict(collectives.traffic), shift_s[0])

    class _Opt:
        def __init__(self, model):
            self.tx = create_optimizer(targs, SH_STEPS)
            self.opt = self.tx.init(dict(model.named_parameters()))

    def single_forward(model):
        return model(ids, padding_mask=mask, deterministic=True)[0]

    def piped(m):
        return lambda model: pipeline_text_lm_apply(model, ids, mask, mesh=mesh,
                                                    axis_name="stage", num_microbatches=m)[0]

    ref = {}
    if rank == 0:  # the single-process steps first: same weights, same batch
        model = TextLM(cfgs["float32"], device="cuda", seed=0)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        torch.cuda.reset_peak_memory_stats()
        loss, logits, wall, counts, _, _ = step(model, _Opt(model), single_forward)
        ref = dict(loss=loss, logits=logits.cpu(), leaves={
            n: (parity.leaf_grad(n, p).detach().float().cpu(), p.detach().float().cpu(),
                float((p.detach() - start[n]).norm())) for n, p in model.named_parameters()})
        out["single"]["float32"] = dict(loss=loss, wall=wall, counts=counts,
                                        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del model, start, logits
        torch.cuda.empty_cache()
        model = TextLM(cfgs["bfloat16"], device="cuda", seed=0)
        state = _Opt(model)
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(PP_TIMED_STEPS):
            loss, _, wall, counts, _, _ = step(model, state, single_forward)
            walls.append(wall)
        out["single"]["bfloat16"] = dict(loss=loss, walls=walls, counts=counts,
                                         peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del model, state
        torch.cuda.empty_cache()
    dist.barrier()

    # parity: one fp32 pipelined step at M = PP_PARITY_M on this rank's stage
    model = stage_model(TextLM(cfgs["float32"], device="cuda", seed=0), mesh, "stage")
    torch.cuda.empty_cache()
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss, logits, wall, counts, traffic, sh = step(model, _Opt(model), piped(PP_PARITY_M))
    par = dict(loss=loss, wall=wall, counts=counts, traffic=traffic, shift_s=sh,
               layers=(model.stage_layers.start, model.stage_layers.stop))
    if rank == 0:
        par["logit_err"] = float((logits.cpu() - ref["logits"]).norm() / ref["logits"].norm())
    del logits
    errs_g, errs_c, replica = {}, {}, {}
    for name, p in model.named_parameters():  # every rank, in one order: the gathers pair
        layered = name.startswith("layers.")
        for kind, t in (("grad", parity.leaf_grad(name, p)), ("param", p)):
            host = t.detach().float().cpu().contiguous()
            parts = [torch.empty_like(host) for _ in range(PP_RANKS)] if rank == 0 else None
            dist.gather(host, parts, dst=0)
            if rank != 0:
                continue
            for r, part in enumerate(parts):
                if layered:
                    i, rest = name[len("layers."):].split(".", 1)
                    whole = f"layers.{int(i) + r * len(model.layers)}.{rest}"
                elif r > 0:  # a replicated leaf: held to rank 0's
                    d = float((part - parts[0]).norm())
                    replica[(name, kind, r)] = (d / max(float(parts[0].norm()), 1e-30),
                                                float((part - parts[0]).abs().max()))
                    continue
                else:
                    whole = name
                g_ref, p_ref, moved = ref["leaves"][whole]
                if kind == "grad":
                    nb, d = float(g_ref.norm()), float((part - g_ref).norm())
                    errs_g[whole] = d / nb if nb > 0 else (0.0 if d == 0 else float("inf"))
                else:
                    d = float((part - p_ref).norm())
                    errs_c[whole] = d / moved if moved > 0 else (0.0 if d == 0 else float("inf"))
    par.update(errs_grad=errs_g, errs_change=errs_c, replica=replica)
    out["parity"] = par
    del model, start
    ref.clear()
    torch.cuda.empty_cache()
    dist.barrier()

    # timed: bf16, PP_TIMED_STEPS steps at each M
    model = stage_model(TextLM(cfgs["bfloat16"], device="cuda", seed=0), mesh, "stage")
    torch.cuda.empty_cache()
    state = _Opt(model)
    for m in PP_MICRO:
        torch.cuda.reset_peak_memory_stats()
        steps = [step(model, state, piped(m)) for _ in range(PP_TIMED_STEPS)]
        out["timed"][m] = dict(
            losses=[s[0] for s in steps], walls=[s[2] for s in steps],
            counts=[s[3] for s in steps], traffic=[s[4] for s in steps],
            shift_s=[s[5] for s in steps], peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            resident=tensor_bytes(dict(model.named_parameters())) + tensor_bytes(state.opt))
    out["mu_el"] = next(iter(state.opt.mu.values())).element_size()
    del model, state
    torch.cuda.empty_cache()
    collectives.shift = plain_shift
    dist.barrier()
    dist.destroy_process_group()
    out["total_s"] = time.perf_counter() - t_spawn
    return out


def run_pipeline():
    """PP_RANKS ranks spawned on cuda:0 over gloo (host-staged), one stage a
    rank: medium_dense at full width and depth through GPipe over a stage
    axis; fp32 parity with the single-process step, bf16 timed steps at
    each M of PP_MICRO with exact per-rank gates.  Returns the launches a
    rank a step at each M."""
    import multiprocessing as mp
    import queue as queue_mod
    import statistics
    import tempfile

    import torch
    import torch_card_parity as parity

    t0 = time.perf_counter()
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = card_line()
    log(f"pipeline: compute mode {mode}; {PP_RANKS} ranks (one stage each) on cuda:0, gloo "
        f"with CUDA tensors staged through host buffers; {card}")
    require("exclusive" not in mode.lower(),
            f"pipeline: compute mode {mode} admits one process: the ranks cannot share the card")
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        t_spawn = time.perf_counter()
        procs = [ctx.Process(target=pp_rank, args=(r, os.path.join(tmp, "init"), queue, t_spawn))
                 for r in range(PP_RANKS)]
        for p in procs:
            p.start()
        results = {}
        deadline = time.perf_counter() + 600
        try:
            while len(results) < PP_RANKS and time.perf_counter() < deadline:
                try:
                    r, res = queue.get(timeout=5)
                except queue_mod.Empty:
                    if any(p.exitcode not in (None, 0) for p in procs):
                        break
                    continue
                results[r] = res
                if "error" in res:
                    break
        finally:
            whole = len(results) == PP_RANKS and not any("error" in v for v in results.values())
            for p in procs:
                p.join(60 if whole else 0)
                if p.is_alive():
                    p.kill()
                    p.join()
    errors = {r: res.get("error") for r, res in results.items() if "error" in res}
    require(len(results) == PP_RANKS and not errors and all(p.exitcode == 0 for p in procs),
            f"pipeline: ranks failed or did not report (exit codes "
            f"{[p.exitcode for p in procs]}, reports from {sorted(results)}): "
            + "\n".join(f"rank {r}:\n{e}" for r, e in errors.items()))

    from vats_tpu_torch.models import TextLM

    cfg = train_cfg("medium_dense", dropout=0.0, gradient_checkpointing=False,
                    num_layers=PP_LAYERS)
    L, per = cfg.num_layers, cfg.num_layers // PP_RANKS

    def want(blocks):
        return {"flash_attention": 0, "flash_attention_lse": blocks, "flash_bwd_dkv": blocks,
                "flash_bwd_dq": blocks}

    single = results[0]["single"]
    for dt, s in single.items():
        require(s["counts"] == want(L), f"pipeline: single-process step ({dt}) launched "
                f"{s['counts']}, expected {want(L)}")
    sb = single["bfloat16"]
    single_ms = statistics.median(sb["walls"][1:]) * 1e3
    log(f"pipeline: single-process step (medium_dense d{cfg.d_model}/{L}L, B={PP_B} T={PP_T}, "
        f"no remat, one process): fp32 loss {single['float32']['loss']:.5f}, wall "
        f"{single['float32']['wall'] * 1e3:.1f} ms (the process's first step), peak "
        f"{single['float32']['peak_gb']:.2f} GB; "
        f"bf16 walls {', '.join(f'{w * 1e3:.1f}' for w in sb['walls'])} ms (median of steps "
        f"2-{PP_TIMED_STEPS} {single_ms:.1f}), peak {sb['peak_gb']:.2f} GB; launches "
        f"{sb['counts']} a step; {card}")

    # parity (fp32, M = PP_PARITY_M)
    par0 = results[0]["parity"]
    for r in range(PP_RANKS):
        par = results[r]["parity"]
        require(par["counts"] == want(per * PP_PARITY_M), f"pipeline: parity step rank {r} "
                f"launched {par['counts']}, expected {want(per * PP_PARITY_M)}")
        require(par["loss"] == par0["loss"], f"pipeline: rank {r} loss {par['loss']} differs "
                f"from rank 0's {par0['loss']}")
    dl = abs(par0["loss"] - single["float32"]["loss"])
    bad_replica = {k: v for k, v in par0["replica"].items() if not v[0] <= PP_REPLICA_RTOL}
    worst_replica = max(v[1] for v in par0["replica"].values())
    log(f"pipeline: fp32 step at M={PP_PARITY_M} against the single-process step: logits "
        f"relative L2 {par0['logit_err']:.3e} (limit {PP_LOGIT_RTOL}), |loss diff| {dl:.3e} "
        f"(limit {PP_LOSS_ATOL}); the replicated leaves' gradients and updated values on "
        f"ranks 1-{PP_RANKS - 1} against rank 0's: largest |difference| {worst_replica:.3e} "
        f"(relative L2 limit {PP_REPLICA_RTOL}); "
        + parity.leaf_report("gradients", par0["errs_grad"], PP_LEAF_GRAD_RTOL) + "; "
        + parity.leaf_report("change in one AdamW update", par0["errs_change"], PP_LEAF_CHANGE_RTOL)
        + f"; {card}")
    require(par0["logit_err"] <= PP_LOGIT_RTOL and dl <= PP_LOSS_ATOL and not bad_replica,
            f"pipeline: fp32 parity failed (logits {par0['logit_err']}, loss diff {dl}, "
            f"replicated leaves beyond {PP_REPLICA_RTOL}: {bad_replica})")
    n_leaves = len(list(TextLM(cfg, device="meta").parameters()))
    require(len(par0["errs_grad"]) == len(par0["errs_change"]) == n_leaves,
            f"pipeline: {len(par0['errs_grad'])} of the model's {n_leaves} leaves compared")

    # timed (bf16)
    counts = {}
    for m in PP_MICRO:
        bubble = (PP_RANKS - 1) / (m + PP_RANKS - 1)
        predicted = _pp_predicted_bytes(cfg, m)
        stage_bytes = _pp_stage_bytes(cfg, results[0]["mu_el"])
        for r in range(PP_RANKS):
            tm = results[r]["timed"][m]
            for i, c in enumerate(tm["counts"]):
                require(c == want(per * m), f"pipeline: M={m} step {i + 1} rank {r} launched "
                        f"{c}, expected {want(per * m)}")
            for i, tr in enumerate(tm["traffic"]):
                require(tr["by_axis"] == {"stage": predicted}, f"pipeline: M={m} step {i + 1} "
                        f"rank {r} sent {tr['by_axis']}, predicted {{'stage': {predicted}}}")
            require(tm["resident"] == stage_bytes, f"pipeline: M={m} rank {r} holds "
                    f"{tm['resident']} bytes, its stage's shapes give {stage_bytes}")
            wall = statistics.median(tm["walls"][1:])
            tr, sh = tm["traffic"][-1], tm["shift_s"][-1]  # the last step's split
            log(f"pipeline: bf16 M={m} (mb {PP_B // m}) rank {r} (blocks {r * per}-"
                f"{(r + 1) * per - 1}): losses {', '.join(f'{x:.5f}' for x in tm['losses'])}; "
                f"step walls {', '.join(f'{w * 1e3:.1f}' for w in tm['walls'])} ms (median of "
                f"steps 2-{PP_TIMED_STEPS} {wall * 1e3:.1f}; one process {single_ms:.1f}); "
                f"launches {tm['counts'][-1]} a step; {predicted / 1e6:.3f} MB sent a step = "
                f"the prediction from the packed shapes, in {tr['calls']} collectives; in the "
                f"shifts {sh * 1e3:.1f} ms = {sh / tm['walls'][-1]:.3f} of the step (GPipe's "
                f"bubble {bubble:.3f}), {_cp_times(tr)}; resident params + optimizer state "
                f"{tm['resident'] / 1e9:.4f} GB = the stage's shapes; peak memory "
                f"{tm['peak_gb']:.2f} GB (one process {sb['peak_gb']:.2f} GB); {card}")
        counts[m] = results[0]["timed"][m]["counts"][-1]
    log("pipeline: the ranks' compute serialises on one card, so the bubble shows as time "
        "waiting in the shifts and their exchange, not as idle card time")
    for r in range(PP_RANKS):
        log(f"pipeline: rank {r} joined the world with a CUDA context "
            f"{results[r]['start_s']:.1f} s after the spawn, ended at "
            f"{results[r]['total_s']:.1f} s")
    log(f"pipeline: phase {time.perf_counter() - t0:.1f} s (its budget: 120 s)")
    return counts


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
    # the package, and the card tests' checks that the multi-rank phases
    # share (their spawned ranks inherit the path)
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
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
    from vats_tpu_torch.ops import adamw as aw
    from vats_tpu_torch.ops.mla_decode import mla_decode_attention
    from vats_tpu_torch.ops.moe_grouped import moe_grouped_gemm
    from vats_tpu_torch.ops.paged_prefill_attention import paged_prefill_attention

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
        # K6: the JAX package attends a prefill into a cache with history
        # with XLA over the gathered pages; no TPU kernel to port.  Every
        # serving prefill runs it; the main phase's prefills are all fresh
        dict(name="paged_prefill_attention", route="cuda",
             source="vats_tpu_torch/csrc/paged_prefill_attention.cu",
             replaces="none (vats_tpu/nn/attention.py, paged prefill with history, XLA)",
             fn=paged_prefill_attention, path="serve"),
        # K7: the JAX package runs lossless experts as XLA batched matmuls
        # over [E, n, d] buffers; no TPU kernel to port.  The serve phase's
        # lossless drive runs it (its other drives hold capacity 1.25)
        dict(name="moe_grouped_gemm", route="cuda",
             source="vats_tpu_torch/csrc/moe_grouped_gemm.cu",
             replaces="none (vats_tpu/nn/moe.py, lossless dispatch, XLA bmm)",
             fn=moe_grouped_gemm, path="serve"),
        # K9: the JAX package has no latent attention; no TPU kernel to
        # port.  Every decode forward of an MLA model runs it, one a layer
        dict(name="mla_decode_attention", route="cuda",
             source="vats_tpu_torch/csrc/mla_decode.cu",
             replaces="none (vats_tpu has no latent attention)", fn=mla_decode_attention,
             path="mla"),
        # K3's append mode: off the LM's decode since K3 became the fused
        # prologue (the main phase gates it at 0 launches); video generation's
        # temporal cache writes every cached forward through it
        dict(name="dense_cache_append", route="cuda",
             source="vats_tpu_torch/csrc/cache_append.cu",
             replaces="vats_tpu/ops/cache_append.py:47", fn=append_token_inplace,
             path="video_gen"),
        dict(name="dense_decode_prologue", route="cuda",
             source="vats_tpu_torch/csrc/cache_append.cu",
             replaces="vats_tpu/ops/cache_append.py:47", fn=dense_decode_prologue,
             path="main"),
        dict(name="paged_decode_prologue", route="cuda",
             source="vats_tpu_torch/csrc/cache_append.cu",
             replaces="vats_tpu/ops/cache_append.py:47", fn=paged_decode_prologue,
             path="main"),
        # K3's table mode (the '2d_ntk' RoPE of image generation), counted
        # apart from the 1-D prologue
        dict(name="dense_decode_prologue_table", route="cuda",
             source="vats_tpu_torch/csrc/cache_append.cu",
             replaces="vats_tpu/ops/cache_append.py:47", fn=dense_decode_prologue.table,
             path="image_gen"),
        dict(name="paged_decode_prologue_table", route="cuda",
             source="vats_tpu_torch/csrc/cache_append.cu",
             replaces="vats_tpu/ops/cache_append.py:47", fn=paged_decode_prologue.table,
             path="image_gen"),
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
        # K8: the JAX package leaves optax's adamw and MultiSteps to XLA; no
        # TPU kernel to port.  Every AdamW update on the card runs it, and
        # every accumulation step of MultiSteps
        dict(name="adamw_update", route="cuda", source="vats_tpu_torch/csrc/adamw.cu",
             replaces="none (vats_tpu/train/optimizer.py, optax.adamw, XLA)",
             fn=aw.adamw_update_, path="train"),
        dict(name="accumulate_grads", route="cuda", source="vats_tpu_torch/csrc/adamw.cu",
             replaces="none (vats_tpu/train/optimizer.py, optax.MultiSteps, XLA)",
             fn=aw.accumulate_, path="train"),
    ]
    results = {}
    if "kernels" in phases:
        # each timing draws its inputs from its own seed, so a change to one
        # leaves the others' inputs as they were
        gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)  # noqa: E731
        results["paged_decode_attention_commit"] = time_k1(gen(0))
        results["paged_decode_attention_commit_int8"] = time_k4(gen(1))
        results["flash_attention_forward"] = time_flash(
            gen(2), "K2 prefill B=8 T=512", 8, 512, TRAIN_HQ, TRAIN_G, TRAIN_HD,
            kinds=("K2",), flips=False)["K2"]
        lm = time_flash(gen(4), f"medium_dense B={TRAIN_B} T={TRAIN_T}", TRAIN_B, TRAIN_T,
                        TRAIN_HQ, TRAIN_G, TRAIN_HD, kinds=("K2'", "K5"))
        results["flash_attention_forward_lse"] = lm["K2'"]
        # K5a and K5b alone beside the whole backward's time and SDPA's
        # backward (dq, dk, dv together)
        whole = dict(whole_backward_ms=lm["backward"]["ms"],
                     library_ms=lm["backward"]["library_ms"])
        results["flash_attention_backward_dkv"] = dict(lm["K5a"], **whole)
        results["flash_attention_backward_dq"] = dict(lm["K5b"], **whole)
        # the ring's steady state without the offset: T = S = 2048, B = 2
        time_flash(gen(3), "B=2 T=S=2048", 2, 2048, TRAIN_HQ, TRAIN_G, TRAIN_HD,
                   kinds=("K2", "K5"), flips=False)
        # ViT-2D medium's attention (B=16, T=S=576 patches, 16 / 8 heads of
        # 72 -> 128, non-causal); the image transformer's full forward (B=1,
        # T=S=4096, 32 / 4 heads of 24 -> 32, causal); a ring hop of the
        # context_parallel phase (nlp_medium's heads, T=S=2048, B=2, the past
        # shard at offset +tl: every pair attended); the multimodal prefill
        # (B=4, T=256, 8 / 4 heads of 96 -> 128, causal, ragged prompts)
        time_flash(gen(7), "ViT-2D", 16, 576, 16, 8, 72, causal=False, pairs=16 * 576 * 576)
        time_flash(gen(10), "image gen", 1, 4096, 32, 4, 24)
        hop = 2048
        time_flash(gen(15), "ring hop +tl", 2, hop, TRAIN_HQ, TRAIN_G, TRAIN_HD,
                   kinds=("K2'", "K5"), q_pos_offset=hop, pairs=2 * hop * hop,
                   sdpa_causal=False)
        valid = (torch.arange(256, device="cuda")[None, :]
                 < torch.tensor(MM_RAGGED, device="cuda")[:, None])
        time_flash(gen(14), "multimodal prefill", MM_B, 256, 8, 4, 96, kinds=("K2",),
                   kv_valid=valid, pairs=sum(work.causal_pairs([n]) + n * (256 - n)
                                             for n in MM_RAGGED))
        k3 = time_k3(gen(6))
        results["dense_decode_prologue"] = k3.pop("dense_decode_prologue")
        results["paged_decode_prologue"] = k3.pop("paged_decode_prologue")
        results["dense_cache_append"] = k3.pop("dense_cache_append")
        results["dense_decode_prologue_table"] = headline(
            {k: v for k, v in k3.items() if k.startswith("dense")})
        results["paged_decode_prologue_table"] = headline(
            {k: v for k, v in k3.items() if k.startswith("paged")})
        results["paged_prefill_attention"] = time_k6(gen(16))
        results["moe_grouped_gemm"] = time_k7(gen(20))
        results["mla_decode_attention"] = time_k9(gen(22))
        k8 = time_k8(gen(21))
        results["adamw_update"] = k8
        results["accumulate_grads"] = k8["accumulation"]
        log(f"phase kernels ended at {time.perf_counter() - t_start:.1f}s")
    counts = {"main": {}, "serve": {}, "mla": {}, "train": {}, "image_gen": {}, "video_gen": {},
              "multimodal": {}, "pipeline": {}, "vision": {}}
    every_kernel = [append_token_inplace, dense_decode_prologue, paged_decode_prologue,
                    dense_decode_prologue.table, paged_decode_prologue.table,
                    paged_decode_attention_commit, paged_decode_attention_commit_int8,
                    paged_prefill_attention,
                    fa.flash_attention, fa.flash_attention_lse, fa.flash_bwd_dkv,
                    fa.flash_bwd_dq]
    runners = {
        # the main phase gates K3's append mode at 0 besides the main path's rows
        "main": lambda: run_main([r["fn"] for r in kernel_rows if r["path"] == "main"]
                                 + [append_token_inplace, paged_prefill_attention]),
        "serve": lambda: run_serve({r["name"]: r["fn"] for r in kernel_rows}),
        "mla": lambda: run_mla({r["name"]: r["fn"] for r in kernel_rows}),
        "train": lambda: run_train([r["fn"] for r in kernel_rows] + [fa.flash_attention]),
        "context_parallel": run_context_parallel,
        "sharded": run_sharded,
        "pipeline": run_pipeline,
        "scripts": lambda: run_scripts({r["name"]: r["fn"] for r in kernel_rows}),
        "vision": lambda: run_vision([fa.flash_attention, fa.flash_attention_lse,
                                      fa.flash_bwd_dkv, fa.flash_bwd_dq]),
        "image_gen": lambda: run_image_gen([
            dense_decode_prologue.table, paged_decode_prologue.table,
            paged_decode_attention_commit, fa.flash_attention, fa.flash_attention_lse,
            fa.flash_bwd_dkv, fa.flash_bwd_dq, dense_decode_prologue, paged_decode_prologue,
            append_token_inplace]),
        "video_gen": lambda: run_video_gen(every_kernel),
        "multimodal": lambda: run_multimodal(every_kernel),
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
        # launches a rank a pipelined step, at each M (the pipeline phase)
        by_m = {f"M={m}": c[row["fn"].__name__] for m, c in counts["pipeline"].items()
                if row["fn"].__name__ in c}
        if by_m:
            entry["pipeline_launches"] = by_m
        # launches a replay of ViT-2D medium's forward graph (the vision phase)
        if row["fn"].__name__ in counts["vision"]:
            entry["vision_graph_launches"] = counts["vision"][row["fn"].__name__]
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
