#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``vats_tpu_torch``) once on one card.

    python3 chip_smoke.py              # every phase, one GPU
    python3 chip_smoke.py --phases build,kernels

Phases:
  build    build every CUDA kernel from ``vats_tpu_torch/csrc`` (one nvcc per
           source, all at once); print the card's name and power limit and
           ptxas's registers, shared memory and spills; fail unless every
           bf16 flash forward and backward kernel, and K6 at both widths,
           holds tensor-core instructions (HGMMA).
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
           Each check draws its inputs from its own seed.  K2, K2' and the
           whole backward also at ViT-2D medium's shape (B=16, T=S=576, 16/8
           heads, head dim 72 padded to 128 in the wrappers, non-causal): held
           against the plain versions, timed in turns with SDPA at head dim 72,
           with the bound on the logical work and the share of the call
           outside the kernel (the pads).  The same at the image
           transformer's shape (B=1, T=S=4096, 32/4 heads, head dim 24
           padded to 32, causal).  K3's table mode (image generation's
           '2d_ntk' RoPE from a (cos, sin) table) in the dense, ring and
           paged modes against its plain version given the table, timed
           beside the chain; K1 at head dim 24 with 8 heads a group.  The
           video and multimodal shapes: K3's append mode at video_gen_large's
           temporal cache (256 rows, 4 groups of head dim 144, 15 slots; the
           ``dense_cache_append`` row), K3's table mode dense and paged at
           8 / 4 heads of 96 with a table of text, image and video rows, K1
           at head dim 96 with 2 heads a group over ragged lengths up to 2367,
           K2 at T=256, head dim 96 -> 128, causal with a ragged key mask,
           timed beside SDPA.  K2', K5a and K5b at a ring hop of the
           context_parallel phase (``check_ring_hop``: nlp_medium's heads,
           T = S = 2048, B = 2): the past shard at offset +tl (causal), a
           wrapped future shard at offset -tl (non-causal, right window),
           the backward fed a merged lse and di from outside with rows at
           1e30 (dq exactly 0 there); timed at the past hop beside SDPA.
           K6 (paged tail-prefill attention) at decode_heavy's grouped
           prefills (B=1 and 2 at bucket 512, B=1 at 128, tails starting at
           0; B=1 at 512 after a 1024-token prefix hit) against the plain
           gather path, a second launch bit-equal, timed beside its bound,
           the plain version and SDPA over the window's keys.
  main     the main path at full width (nlp_medium, 8 experts, top-2, bf16,
           random weights from a seed): ``generate_paged`` over ragged
           prompts up to 512 tokens (whole-batch and row-chunked prefill) and
           the dense ``TokenGenerator``, every decode step after the first
           replayed from a CUDA graph.  Launch counters are zeroed just
           before and read just after; each must equal 20 layers x calls
           (K3's fused prologue once a layer a decode forward, its
           append-only mode never; K6 never, every prefill here being
           fresh).  Then the graph and the eager decode
           loop in turns (graph, eager, eager, graph; equal tokens), each
           profiled; kernels per decode forward by name (``decode_census``);
           K3's dense prologue in replayed dense graphs at B 1, 16, 32 beside
           an empty kernel of its grid and the chain it replaced.  Sampled
           ``generate_paged`` (temperature 0.8, top-k 50, top-p 0.9) with
           ``approx_top_k`` on and off from one seed, each with the counters
           zeroed before and read after: equal tokens, equal launches (K1
           and K3's paged prologue 20 a step); ``exact_top_k`` on bf16
           logits at the vocabulary, card against CPU (values and indices
           equal, ties in index order), timed beside ``torch.topk``.
  parity   full width, 2 layers: ``generate_paged`` and ``generate`` on the
           card (kernels, decode replayed from graphs) against the CPU (plain
           versions), same weights; at most one (row, step) whose MoE router
           picks other experts on a near tie is excused from the logit
           bound, and reported.
  serve    the continuous-batching ``ServingEngine`` at full width
           (nlp_medium, 8 experts, top-2, bf16; depth cut to SERVE_LAYERS =
           2 of 20 to keep the whole run under 900 s): 64 requests (32 sharing a
           256-token prefix) through 32 rows, a 129-page pool (requests queue
           and rows are preempted), prefix caching, 4-step decode blocks,
           greedy; three configurations: bf16 KV (K1), int8 KV (K4), int8
           weights + int8 KV.  Each is driven with its tail prefills (one
           graph per (bucket, padded group size), their keys gated equal to
           the engine's prefill shapes) and decode blocks replayed from CUDA
           graphs on a fresh engine (it captures every key) and on one
           primed by an earlier drive of the stream (it only replays), and
           eagerly, in turns (equal tokens), each drive profiled once more:
           throughput with and without the captures, request
           latency, capture seconds and replays (prefill graphs apart), peak
           memory, device-busy time and idle share; pages, preemptions,
           prefix hits; launch counts of K1, K4 and K3's paged prologue
           against the decode forwards a hook counts, and of K6 against the
           prefill forwards (once a layer each with bf16 KV, never with
           int8); kernels per decode
           forward of each configuration.  The bf16-KV stream once more with
           speculative decoding (spec_k = SPEC_K = 4, greedy): the verify
           forward from one graph, the same three paths in turns; equal
           tokens and forwards on every path, exact launch gates (K6 once
           a layer a prefill or verify forward); the
           drafts' acceptance and the share of tokens equal to the plain
           drive's.
  serve_parity  2 layers at full width: one int8-KV stream of 8 requests
           (prefix sharing, a preemption) on the card (K4, replayed graphs;
           logits from an eager drive with equal tokens) and on the CPU
           (plain version); per-forward logit error and token agreement.
  train    the training step at the JAX bench's ``medium_dense`` tier (d1440,
           20 layers, vocab 65536, B=16, T=512, dropout 0.1, remat 'dots',
           fused CE 128, bf16 AdamW mu) and ``medium_moe`` (d768, 12 layers,
           8 experts, top-2) through ``make_train_step``: the first call
           (eager warm-up and capture), then the step from its CUDA graph
           and eagerly in turns from one snapshot of the state restored in
           place (``train_turns``): params, moments, counters and metrics
           bit-equal; K2' 2 x layers, K5a and K5b once a layer and K2 never,
           a replay's tally and every turn's counts; ``state.step`` one a
           call; ms a step, tokens/s, idle share, capture seconds, peak and
           reserved memory; a profiled step of each path.
  train_parity  2 layers at full width, B=2, T=512, dropout 0: three train
           steps on the card (flash kernels) and on the CPU from the same
           weights and batch; loss, grad norm and params after each step.
  context_parallel  CP_RANKS = 2 ranks spawned on cuda:0 (the card's
           compute mode printed first: an exclusive mode stops the second
           rank, and the phase fails), over gloo with CUDA tensors staged
           through host buffers (NCCL needs one GPU a rank).  Ring attention
           at nlp_medium's attention shape over T = 4096 (tl 2048, B = 2,
           bf16), causal without and with left_window 384, forward and
           backward against single-process flash on the card (CP_REL_L2);
           one sequence-parallel medium_dense step at full width, CP_LAYERS =
           5 of its 20 layers (T = 4096, dropout 0) with 'ring' and with 'ulysses' against the
           single-process step (train_parity's limits, leaf by leaf).  Exact
           launch gates a rank: K2', K5a, K5b = live hops of ``_ring_steps``
           (x layers, K2' x 2 under remat in the step), none under
           Ulysses.  Step walls, bytes sent, the seconds in collectives
           (waiting for queued device work, host copies, exchange) and
           peak memory per rank, beside the card's name and power limit.
           The blockwise ring (``impl="xla"``, 512 x 512 tiles, no kernel)
           at the ring's shape and windows: out, dq, dk, dv within
           CP_REL_L2 of the flash ring and of single-process flash, no
           K2' / K5a / K5b launch; a rank's forward and forward + backward
           ms, collectives' split and peak memory beside the flash ring's.
  sharded  SH_RANKS = 4 ranks spawned on cuda:0 over gloo, host-staged (the
           compute mode printed first; an exclusive mode fails the phase):
           one medium_moe step at full width, SH_LAYERS = 2 of its 12
           layers (d768, vocab 65536, E8 top-2, sort dispatch, capacity
           1.25, remat 'dots', dropout 0, bf16 AdamW mu, B=4, T=512) on
           fsdp=2 x expert=2 and on
           fsdp=2 x tensor=2, in fp32 and in the config's bf16, each against
           the single-process step from the same weights and batch
           (train_parity's limits on the loss and grad norm; the dropped
           assignments a layer equal, or apart by at most the assignments
           that near-tie router flips move; in fp32 also the per-leaf
           gradients and change, gathered to rank 0: ``SH_DTYPES`` says why
           bf16 is not held leaf by leaf); exact per-rank gates K2' 2 x
           layers, K5a and K5b once a layer a step; resident bytes a rank asserted equal to the
           specs' sum, beside peak memory a rank and one process's; step
           walls, bytes sent per mesh axis and the collectives' seconds a
           rank.
  pipeline  PP_RANKS = 4 ranks spawned on cuda:0 over gloo, host-staged (the
           compute mode printed first; an exclusive mode fails the phase), one
           GPipe stage a rank on a ``stage`` axis: medium_dense at full width,
           PP_LAYERS = 8 of its 20 layers (d1440, 24/8 heads of 60, vocab
           65536, dropout 0, no remat; 2 blocks a rank, ``stage_model``),
           B=8, T=512, through ``pipeline_text_lm_apply``, a masked CE and one AdamW update a
           step.  fp32 at M=4 against the single-process step from the same
           weights and batch (run first on rank 0): logits, loss, every
           rank's own layers and the replicated leaves leaf by leaf
           (gradient, change in the update; ``PP_*`` limits), the replicated
           leaves equal on every rank.  bf16, three steps at M=4 and at M=8:
           step walls, bytes sent a rank against the count the packed shapes
           predict (exact), the seconds in the shifts against GPipe's bubble,
           the collectives' waiting / copy / exchange split, resident bytes
           against the stage's shapes (exact), peak memory, beside the
           single-process step.  Exact gates a rank a step: K2 0, K2', K5a,
           K5b 5 x M (a stage computes on its M active ticks only); the
           single process 20 each.
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
           interactive script on ``best_model`` at temperature
           0, dense and ``--paged`` (K3's dense prologue, or K1 and the
           paged prologue, once a layer a decode forward); a TokenShard
           packed into 8 rows of 512 with segment ids, one medium_dense
           forward and backward, again with each row's first segment
           re-drawn: the later segments' logits stay.
  vision   the vision encoders at full depth: ViT-2D medium forward (384 px /
           p16, d1152, 16 layers, bf16 params, B=16) on 384x384 and on 448x531
           (resize and crop on the card), K2 exactly 16 launches a forward;
           the 448x531 resize (``jax.image.resize``'s computation, bf16)
           card against CPU within one bf16 ulp, and ViT-3D large's per-frame
           resize of 240x320 frames the same way;
           at 384x384 also from a CUDA graph (a ``GraphSet``, as the eval
           step's), K2 16 a replay and the features bit-equal to eager's,
           graph and eager in turns: images/s, device-busy time, idle
           share, peak and reserved memory, capture seconds.  ViT-2D
           medium training through ``make_vision_train_step`` (1000 classes,
           dropout 0.2, remat, 4 micro-steps of B=32 with mixup / cutmix and
           the pixel battery on raw images on the card), one CUDA graph a
           micro-step position, graph and eager in turns from one snapshot
           (``train_turns``, bit-equal): K2' 32, K5a 16 and K5b 16 a
           micro-step (each graph's tally and every turn), K2 16 in the
           eval step, exactly; images/s, ms a micro-step, peak and reserved
           memory, idle share, capture seconds, an eval loss that the
           update moves (the eval step replayed from its graph, equal to
           eager bit for bit).  ViT-3D xsmall (B=4, 32 frames at 128^2) and
           large (B=4, 8 frames at 224^2) forwards with no flash launch (the
           JAX model attends with XLA there), eagerly and from graphs in
           turns as ViT-2D's: frames/s, busy, idle, memory, capture seconds.
  vision_parity  ViT-2D at medium width, 2 layers, B=2: features, logits,
           and one train step (loss, grad norm, params) on the card against
           the CPU; ViT-3D xsmall at its full config, B=1, the last 6 frames
           padded: features card against CPU.
  image_gen  text->image generation at image_gen_xsmall's full width (d768,
           32/4 heads of 24; the generation runs at IMG_GEN_LAYERS = 3 of 12
           layers, the trainer and the script at 12): ``generate_image_tokens``
           and ``generate_image_tokens_paged`` at tools/bench_gen.py's shape
           (B=4, 16x16, temperature 0.9, top-k 64), graph and eager in turns
           (equal tokens), each profiled; the ``ImageGenerationPipeline`` on
           the 64x64 grid (4096 graph steps); ``ImageGenTrainer`` steps at
           256 px, B=2, from their graph and eagerly in turns (bit-equal,
           cuDNN's deterministic algorithms), and an ``evaluate`` from its
           graph (equal to eager); the image-gen script for 3 steps.
           Exact gates: K3's table mode (and K1 on the paged path) once a
           layer a decode forward, K2' 24, K5a 12, K5b 12 a train step, K2
           12 an evaluation; tokens/s, idle share, peak memory.  Graph and
           eager run in turns (graph, eager, graph).
  image_gen_parity  2 layers at full width, card against CPU: greedy tokens
           of both generation paths (a near tie excused, as in ``parity``) and
           32 teacher-forced cached decode steps' logits; one fp32 trainer
           step at 64 px: loss, quantizer indices, per-leaf gradients and
           change, BatchNorm statistics.
  video_gen  text->video generation at video_gen_large's full width (d1728,
           12/4 heads of 144, 16x16 latent grid; the generation and the
           pipeline at VID_GEN_LAYERS = 3 of its 20 layers, the trainer at
           all 20): the
           inner raster step of ``generate_video_tokens`` (a read-mode
           forward of the whole frame) replayed from a CUDA graph over 2
           latent frames, in turns with the eager loop over the first
           (graph, eager, graph; equal tokens), B=1, temperature 0.9, top-k
           64; the same at the JAX bench's shape (video_gen_xsmall, B=2, 5
           frames of 8x8); the ``VideoGenerationPipeline`` over 2 latent
           frames; ``VideoTokenTrainer`` steps at B=1 over 15 latent frames
           (remat, dropout 0.2) and ``VQVAE3DTrainer`` steps on a 30-frame
           128x128 clip, each from its graph and eagerly in turns
           (bit-equal).  Exact gates: K3's append mode once a layer a
           cached forward (read steps too), nothing else; tokens/s, kernels
           and device ms a step, idle share, peak memory.
  video_gen_parity  video_gen_large's width at 2 layers on a 4x4 grid, card
           against CPU: greedy tokens over 2 frames (a near tie excused), the
           logits of three cached forwards (append, read, append), and one
           fp32 ``VideoTokenTrainer`` step: loss, per-leaf gradients and
           change.
  multimodal  the fused text+image+video stream at multimodal_small's full
           width (d768, 8/4 heads of 96; MM_GEN_LAYERS = 2 of its 12 layers):
           ``generate_multimodal`` at the JAX bench's shape (B=4, t_text 64,
           2304 tokens a row, 2303 decode forwards), graph and eager in
           turns (equal codes); ragged prompts at t_text 256 (the prefill
           through K2); 64 decode steps through the dense and the paged
           cache fed the same tokens.  Exact gates: K1 and K3's paged table
           mode once a layer a decode forward, K2 once a layer a prefill at
           t_text 256 and never at 64, K3's dense table mode once a layer a
           dense decode forward; tokens/s,
           kernels and device ms a step, idle share, peak memory.
  multimodal_parity  multimodal_small's width at 2 layers and 2 video
           frames, ragged prompts at t_text 256, card against CPU: greedy
           codes (a near tie excused) and the logits of the prefill and of
           32 forced decode steps.

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

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "kernels", "main", "parity", "serve", "serve_parity", "train",
          "train_parity", "context_parallel", "sharded", "pipeline", "scripts", "vision",
          "vision_parity", "image_gen", "image_gen_parity", "video_gen", "video_gen_parity",
          "multimodal", "multimodal_parity")
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
# the forward, 3 x (K5a, K5b) in the backward, K6 at widths 64 and 128.
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


def _fmt(ms, digits=4):
    return "not measured" if ms is None else f"{ms:.{digits}f}"


# K1/K4 shapes: nlp_medium's decode attention (Hq 24, G 8, hd 60 -> 64) at
# the serving batch (B=32, lengths <= 576) and at nlp_medium's max_seq_len
# 4096 (B=8, up to 32 tiles a row).
DECODE_SHAPES = (("B=32 lengths<=576", 32, 5, (0, 1, 127, 128, 576, 640), 577),
                 ("B=8 lengths<=4096", 8, 32, (0, 129, 2047, 4096), 4097))
DECODE_G, DECODE_N, DECODE_HD, DECODE_HDP, DECODE_PS, DECODE_L = 8, 3, 60, 64, 128, 20


def _decode_inputs(gen, B, pps, fixed, hi, int8, heads=None, lo=1):
    """A pool of every slot written (int8 pools with their scales), ragged
    lengths in [lo, hi) (the fixed ones first), a random page table, bf16 q
    and current token, at nlp_medium's decode shapes or at ``heads`` (L, G,
    N, hd, hd_pad)."""
    import torch

    from vats_tpu_torch.ops.decode_attention import quantize_kv

    dev = "cuda"
    L, G, N, hd, hdp = heads or (DECODE_L, DECODE_G, DECODE_N, DECODE_HD, DECODE_HDP)
    ps = DECODE_PS
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
    lens = torch.randint(lo, hi, (B,), generator=gen, device=dev)
    lens[:len(fixed)] = torch.tensor(fixed, device=dev)
    table = torch.randperm(P, generator=gen, device=dev).to(torch.int32).reshape(B, pps)
    mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)  # noqa: E731
    return pool, sc, table, lens.to(torch.int32), mk(B, G * N, hd), mk(B, G, hd), mk(B, G, hd)


def _decode_bytes(lengths, B, cap, int8, commit, heads=None, left_window=-1):
    """Bytes a call must move: q in and out, the current K/V in (bf16), the
    settled history read once (int8 with its fp32 scales; within
    ``left_window`` of the row's length when >= 0), the committed K/V out,
    the page table and lengths.  ``heads``: (G, N, hd, hd_pad)."""
    G, N, hd, hdp = heads or (DECODE_G, DECODE_N, DECODE_HD, DECODE_HDP)
    lengths = lengths.clamp(max=cap)
    tokens = int((lengths if left_window < 0 else lengths.clamp(max=left_window)).sum())
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


# code_chat_8k's decode attention (Mellum2: Hq 32, G 4, hd 128) at its
# batch: 64 rows of 1k-8k tokens in pages of 128, a window of 1,024 tokens
# (left_window 1023) on 21 of its 28 layers; the rows at the window's and
# the tiles' edges first, then one at capacity
WINDOW_HEADS, WINDOW_B, WINDOW_PPS, WINDOW_LW = (2, 4, 8, 128, 128), 64, 64, 1023
WINDOW_FIXED = (1023, 1024, 1025, 1151, 1152, 1153, 2047, 4096, 8191)


def check_k1_window(gen):
    """K1 with code_chat_8k's window at its decode shape against the plain
    version with the same window: output within the bf16 tolerance, the
    committed pool bit-equal, one launch a call.  Timed (the call and the
    kernel alone) beside the plain version and the bound (<= 1,023 settled
    keys a row), and beside K1 without the window at the same rows (a full
    layer's call: its bound reads every settled key)."""
    import torch

    from vats_tpu_torch.ops.decode_attention import (
        PagedKVCache,
        paged_decode_attention_commit,
        paged_decode_attention_ref,
    )

    L, g, n, hd, hdp = WINDOW_HEADS
    b, pps, lw, layer, scale = WINDOW_B, WINDOW_PPS, WINDOW_LW, 1, 1.0 / hd**0.5
    cap = pps * DECODE_PS
    pool, _, table, lengths, q, k_cur, v_cur = _decode_inputs(
        gen, b, pps, WINDOW_FIXED, cap, int8=False, heads=WINDOW_HEADS, lo=1024)
    pool_k, pool_p = pool, pool.clone()
    rows = {}
    for name, window in (("window", lw), ("full", -1)):
        kw = dict(scale=scale, k_cur=k_cur, v_cur=v_cur, left_window=window)
        n0 = paged_decode_attention_commit.launches
        out = paged_decode_attention_commit(q, pool_k, layer, table, lengths, **kw)
        want = paged_decode_attention_ref(q, pool_p[layer], table, lengths, **kw)
        PagedKVCache(pool_p, table, lengths).append_token(layer, k_cur, v_cur)
        torch.cuda.synchronize()
        require(paged_decode_attention_commit.launches == n0 + 1,
                f"K1 {name}: not one launch")
        err = expect_close(f"K1 {name} hd {hd}", out, want, BF16_ATOL, BF16_RTOL)
        require(torch.equal(pool_k, pool_p),
                f"K1 {name}: committed pool differs from the plain append")
        kern = lambda: paged_decode_attention_commit(  # noqa: E731
            q, pool_k, layer, table, lengths, **kw)
        plain = lambda: paged_decode_attention_ref(  # noqa: E731
            q, pool_p[layer], table, lengths, **kw)
        (ms, call_ms), (plain_ms, plain_call_ms) = timed(kern), timed(plain)
        alone = kernel_alone_ms(kern, "paged_decode")
        nbytes, tokens = _decode_bytes(lengths, b, cap, int8=False, commit=True,
                                       heads=WINDOW_HEADS[1:], left_window=window)
        b_ms, by = bound(nbytes, 4 * g * n * hd * (tokens + b))
        log(f"K1 paged decode+commit, {name} (left_window {window}) B={b} Hq={g * n} G={g} "
            f"hd={hd} ps={DECODE_PS}, lengths {int(lengths.min())}-{int(lengths.max())}, "
            f"{tokens} settled keys attended: max_abs_err={err:.3e} pool bit-equal; "
            f"kernel_ms={ms:.4f} (kernel alone {_fmt(alone)}; bound share "
            f"{b_ms / (alone or ms):.3f}) plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({by}); "
            f"per call with host overhead: kernel {call_ms:.4f} plain {plain_call_ms:.4f}")
        rows[name] = dict(max_abs_err=err, ms=ms, kernel_alone_ms=alone, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=by)
    del pool_k, pool_p, pool
    torch.cuda.empty_cache()
    return rows


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
    ms, library_ms, _ = flash_vs_sdpa(f"K2 B={B} T={T}", lambda: flash_attention(q, k, v, **kw),
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


def flash_vs_sdpa(label, kern, q, k, v, scale, b_ms, flops, causal=True):
    """Device ms of ``kern`` and of SDPA on the same inputs, timed in turns
    (kernel, SDPA, SDPA, kernel; each the whole call, the wrapper's head-dim
    pad included), with the ratio, achieved TFLOP/s and share of the bound
    printed, and the forward kernel's own time beside.  Returns the two
    means and the forward kernel's own ms (None where the profiler
    recorded nothing)."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = lambda: _sdpa(qt, kt, vt, scale, causal)  # noqa: E731
    k1, l1, l2, k2 = device_ms(kern), device_ms(lib), device_ms(lib), device_ms(kern)
    ms, lib_ms = (k1 + k2) / 2, (l1 + l2) / 2
    per, _ = profiled(kern, iters=20)
    alone = sum(us for name, (us, _) in per.items() if "flash_fwd" in name) / 20 / 1e3
    own = (f"the forward kernel alone {alone:.4f} ms ({flops / alone / 1e9:.1f} TFLOP/s, "
           f"{b_ms / alone:.3f} of the bound)" if alone else "kernel alone not measured")
    log(f"  {label}: kernel {k1:.4f} / {k2:.4f} ms, SDPA {l1:.4f} / {l2:.4f} ms in turns: "
        f"{ms / lib_ms:.2f}x SDPA; {flops / ms / 1e9:.1f} TFLOP/s (SDPA "
        f"{flops / lib_ms / 1e9:.1f}), {b_ms / ms:.3f} of the bound; {own}")
    return ms, lib_ms, (alone or None)


# K6 shapes: decode_heavy's grouped prefills (nlp_medium's attention: Hq 24,
# G 8, hd 60 -> 64; 32 pages of 128 a row; its prompts are distinct, so
# every tail starts at 0), and one row behind a 1024-token prefix hit:
# (label, bucket, starts, valid tail lengths)
K6_SHAPES = (("B=1 bucket 512", 512, (0,), (300,)),
             ("B=2 bucket 512", 512, (0, 0), (300, 480)),
             ("B=1 bucket 128", 128, (0,), (100,)),
             ("B=1 bucket 512 after a 1024-token prefix hit", 512, (1024,), (300,)))


# code_chat_8k's prefills (Mellum2's heads, hd 128; rows of 8,192 tokens):
# the 8,192-token budget as 4 prompts at the 2,048 bucket and one at 6,144,
# each with the window of its 21 sliding layers (1023) and without (the
# full layers)
K6_HYBRID_SHAPES = (("B=4 bucket 2048", 2048, (0, 0, 0, 0), (2048, 1700, 1100, 1025)),
                    ("B=1 bucket 6144", 6144, (0,), (5000,)))


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


def check_k6(gen, shapes=K6_SHAPES, heads=None, pps=32, left_windows=(-1,)):
    """K6 at decode_heavy's prefill shapes (or ``shapes`` at ``heads`` (G, N,
    hd, hd_pad), each at every one of ``left_windows``) against the plain
    version (the path it replaced: every page gathered, fp32 scores and
    softmax) at every query that attends a key (those that attend none
    are 0), within the bf16 tolerance plus 2^-9 max|v| (K6
    rounds each p to bf16 before P V, which moves the output by at most
    2^-9 max|v|); a second launch bit-equal.  Timed beside its bound (bytes:
    q, out and the K/V of each row's keys from its first query's first key
    to its last valid one, at hd; operations: the pairs its queries
    attend), the plain version and, where the tail starts at 0 and nothing
    is windowed, SDPA over the window's keys gathered dense (causal, no
    page table, no key mask: a library's cost of the same attention).
    Returns the first shape's row."""
    import torch

    from vats_tpu_torch.ops.decode_attention import PagedKVCache
    from vats_tpu_torch.ops.paged_prefill_attention import (
        paged_prefill_attention,
        paged_prefill_attention_ref,
    )

    g, n, hd, hdp = heads or (DECODE_G, DECODE_N, DECODE_HD, DECODE_HDP)
    ps, hq, layer, scale = DECODE_PS, g * n, 1, 1.0 / hd**0.5
    result = None
    for label, t, starts, tails in shapes:
        b = len(starts)
        pool = torch.randn((2, 1 + b * pps, 2, g, ps, hdp), generator=gen,
                           device="cuda").to(torch.bfloat16)
        pool[..., hd:] = 0
        table = (1 + torch.randperm(b * pps, generator=gen, device="cuda")).to(
            torch.int32).reshape(b, pps)
        lengths = torch.tensor(starts, dtype=torch.int32, device="cuda")
        mask = torch.arange(t, device="cuda")[None, :] < torch.tensor(tails, device="cuda")[:, None]
        q = torch.randn((b, t, hq, hdp), generator=gen, device="cuda").to(torch.bfloat16)
        q[..., hd:] = 0
        vmax = float(pool[layer, :, 1].float().abs().max())
        for lw in left_windows:
            kw = dict(scale=scale, window_mask=mask, left_window=lw)
            kern = lambda: paged_prefill_attention(  # noqa: E731
                q, pool, layer, table, lengths, **kw)
            plain = lambda: paged_prefill_attention_ref(  # noqa: E731
                q, pool, layer, table, lengths, **kw)
            n0 = paged_prefill_attention.launches
            out, again, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            require(paged_prefill_attention.launches == n0 + 2, "K6 did not launch")
            require(torch.equal(out, again), f"K6 {label}: two launches differ")
            # a query whose window holds no valid key (a padding query past
            # the tail, further than left_window beyond the last valid key):
            # K6 writes 0, the plain version the mean of every slot's v (its
            # finite mask value); the engine reads neither
            i = torch.arange(t, device="cuda")[None, :]
            last = lengths[:, None] + torch.tensor(tails, device="cuda")[:, None] - 1
            first = (lengths[:, None] + i - lw).clamp(min=0) if lw >= 0 else 0
            attends = torch.minimum(lengths[:, None] + i, last) >= first
            require(not bool(out[~attends].any()), f"K6 {label}: a query with no key is not 0")
            err = expect_close(f"K6 {label} left_window {lw}", out[attends], want[attends],
                               BF16_ATOL + 2.0**-9 * vmax, BF16_RTOL)
            del out, again, want
            keys, pairs = _k6_work(starts, tails, t, lw)
            nbytes = 2 * b * t * hq * hd * 2 + keys * 2 * g * hd * 2
            b_ms, by = bound(nbytes, 4 * hq * hd * pairs)
            (ms, call_ms), (plain_ms, plain_call_ms) = timed(kern), timed(plain)
            alone = kernel_alone_ms(kern, "paged_prefill")
            lib_ms = None
            if not any(starts) and lw < 0:
                k_t, v_t = PagedKVCache(pool, table, lengths).gather_dense_t(layer)
                kt, vt = (x[..., :hd, :t].transpose(2, 3).contiguous() for x in (k_t, v_t))
                qt = q[..., :hd].transpose(1, 2).contiguous()
                lib_ms = device_ms(lambda: _sdpa(qt, kt, vt, scale))
                del k_t, v_t, kt, vt, qt
            log(f"K6 paged tail prefill {label} (tails {tails}; Hq={hq} G={g} hd={hd}->{hdp}, "
                f"{pps} pages of {ps} a row, left_window {lw}): max_abs_err={err:.3e} (within "
                f"{BF16_ATOL} + 2^-9*{vmax:.2f} + {BF16_RTOL}*|ref|), repeat bit-equal; "
                f"kernel_ms={ms:.4f} (kernel alone {_fmt(alone)}; bound share "
                f"{b_ms / (alone or ms):.3f}) plain_ms={plain_ms:.4f} ({plain_ms / ms:.1f}x) "
                f"library_ms={_fmt(lib_ms)} (SDPA causal over the window, dense) "
                f"bound_ms={b_ms:.5f} ({by}; {pairs} pairs, {keys} keys); per call with host "
                f"overhead: kernel {call_ms:.4f} plain {plain_call_ms:.4f}")
            if result is None:
                result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=by, library_ms=lib_ms)
            result["max_abs_err"] = max(result["max_abs_err"], err)
        del pool
        torch.cuda.empty_cache()
    return result


# K7's shapes: (label, n tokens, d, f, E, k), the main path's: decode_heavy
# (vats_medium_e8) and code_chat_8k (Mellum2), a decode step's 64 rows and a
# prefill (1,024 tokens; Mellum2's budget of 8,192)
K7_SHAPES = (("decode_heavy decode", 64, 1440, 5760, 8, 2),
             ("decode_heavy prefill", 1024, 1440, 5760, 8, 2),
             ("code_chat_8k decode", 64, 2304, 896, 64, 8),
             ("code_chat_8k prefill", 8192, 2304, 896, 64, 8))


def check_k7(gen):
    """K7's routed path (plan, gather, K7a, K7b, combine) at the main path's
    shapes against the plain version: the plan, gather and combine bit for
    bit, K7a and K7b from the same bf16 operands within the bf16 tolerance
    (exact products, fp32 sums in another order, one rounding).  Timed: the
    whole path, K7 alone, the plain version (fp32 products an expert), the
    bound (decode: the routed experts' weights once over 3.35 TB/s; prefill:
    6 n k d f over 989 TFLOP/s) and the library yardsticks: today's padded
    path (the lossless sort dispatch, every token in each expert's buffer,
    cuBLAS bmm) and ``torch._grouped_mm`` over the routed rows where the
    card's torch has it.  Returns the first shape's row, each shape's under
    its label."""
    import torch

    from vats_tpu_torch.nn.moe import ExpertSwiGLU, MoELayer
    from vats_tpu_torch.ops import moe_grouped as mg

    result = None
    for label, n, d, f, e, k in K7_SHAPES:
        x = torch.randn((n, d), generator=gen, device="cuda").to(torch.bfloat16)
        ws = [(torch.randn(shape, generator=gen, device="cuda") * shape[1] ** -0.5).to(
            torch.bfloat16) for shape in ((e, d, f), (e, d, f), (e, f, d))]
        logits = torch.randn((n, e), generator=gen, device="cuda")
        probs, idx = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True, stable=True)
        w = (probs[:, :k] / probs[:, :k].sum(-1, keepdim=True)).to(torch.bfloat16)
        idx = idx[:, :k]
        plan = mg.route_plan(idx, w, e)
        for got, want in zip(plan, mg.route_plan_ref(idx, w, e)):
            require(torch.equal(got, want), f"K7 {label}: the plan differs from its plain version")
        rows = mg.gather_rows(x, plan.row_tok)
        require(torch.equal(rows, x[plan.row_tok.long()]), f"K7 {label}: gather differs")
        n0 = mg.moe_grouped_gemm.launches
        h = mg.moe_grouped_gemm(rows, plan.counts, ws[0], w_up=ws[1])
        y = mg.moe_grouped_gemm(h, plan.counts, ws[2], row_w=plan.row_w)
        again = mg.moe_grouped_gemm(h, plan.counts, ws[2], row_w=plan.row_w)
        torch.cuda.synchronize()
        require(mg.moe_grouped_gemm.launches == n0 + 3, "K7 did not launch")
        require(torch.equal(y, again), f"K7 {label}: two launches differ")
        err_a = expect_close(f"K7a {label}", h, mg.moe_grouped_gemm_ref(
            rows, plan.counts, ws[0], w_up=ws[1]), BF16_ATOL, BF16_RTOL)
        err_b = expect_close(f"K7b {label}", y, mg.moe_grouped_gemm_ref(
            h, plan.counts, ws[2], row_w=plan.row_w), BF16_ATOL, BF16_RTOL)
        out = mg.combine_rows(y, plan.inv, n, k)
        require(torch.equal(out, mg.combine_rows_ref(y, plan.inv, n, k)),
                f"K7 {label}: combine differs")
        del h, y, again, out
        kern = lambda: mg.routed_experts(x, w, idx, *ws)  # noqa: E731
        plain = lambda: mg.combine_rows_ref(mg.moe_grouped_gemm_ref(  # noqa: E731
            mg.moe_grouped_gemm_ref(x[plan.row_tok.long()], plan.counts, ws[0], w_up=ws[1]),
            plan.counts, ws[2], row_w=plan.row_w), plan.inv, n, k)
        live = int((plan.counts > 0).sum())
        nbytes = live * 3 * d * f * 2 + 2 * n * d * 2
        b_ms, by = bound(nbytes, 6.0 * n * k * d * f)
        ms, call_ms = timed(kern)
        alone = kernel_alone_ms(kern, "moe_grouped_wgmma")
        plain_ms = device_ms(plain, iters=2)
        experts = ExpertSwiGLU(d, f, e, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                               device="cuda")
        with torch.no_grad():
            for p, src in zip((experts.w_gate, experts.w_up, experts.w_down), ws):
                p.copy_(src)
        layer = MoELayer(d, f, e, k, dispatch="sort", dtype=torch.bfloat16,
                         param_dtype=torch.bfloat16, device="meta")
        with torch.no_grad():
            padded_ms = device_ms(lambda: layer._sort_dispatch(x, w, idx, n, experts), iters=5)
        grouped_ms, why = None, "torch._grouped_mm absent"
        if hasattr(torch, "_grouped_mm"):
            offs = torch.cumsum(plan.counts, 0).to(torch.int32)
            try:
                def lib():
                    gate = torch._grouped_mm(rows, ws[0], offs=offs)
                    up = torch._grouped_mm(rows, ws[1], offs=offs)
                    return torch._grouped_mm(torch.nn.functional.silu(gate) * up, ws[2],
                                             offs=offs)
                grouped_ms, why = device_ms(lib, iters=5), "torch._grouped_mm"
            except (RuntimeError, TypeError, ValueError) as exc:
                why = f"torch._grouped_mm refused: {str(exc).splitlines()[0][:120]}"
        log(f"K7 routed experts {label} (n={n}, d={d}, f={f}, E={e}, top-{k}; {live} experts "
            f"routed, rows an expert {n * k / e:.0f}): K7a max_abs_err={err_a:.3e} K7b "
            f"max_abs_err={err_b:.3e} (within {BF16_ATOL} + {BF16_RTOL}*|ref|), plan, gather "
            f"and combine bit-equal; kernel_ms={ms:.4f} (K7 alone {_fmt(alone)}; bound share "
            f"{b_ms / (alone or ms):.3f}, of the whole path {b_ms / ms:.3f}) plain_ms="
            f"{plain_ms:.4f} library_ms: padded sort dispatch (bmm over E x n rows) "
            f"{padded_ms:.4f}, {why} {_fmt(grouped_ms)} bound_ms={b_ms:.5f} ({by}); per call "
            f"with host overhead {call_ms:.4f}")
        row = dict(max_abs_err=max(err_a, err_b), ms=ms, kernel_alone_ms=alone,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=padded_ms,
                   grouped_mm_ms=grouped_ms)
        if result is None:
            result = dict(row)
        result[label] = row
        del x, ws, rows, experts
        torch.cuda.empty_cache()
    return result


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


# K3's table mode and K1 at the image transformer's decode: image_gen_xsmall
# has 32 query heads of 24 over 4 groups; generate_image_tokens runs B=4 on a
# 16 x 16 grid (dense cache [12, 4, 4, 24, 256]; paged: 257 slots, pages of
# 128), the pipeline B=1 on 64 x 64 (4096 slots).
IMG_DEC_B, IMG_DEC_S, IMG_GRID_W = 4, 256, 16


def _table_cost(b, hq, g, hd, paged, table_rows=None):
    """(bytes, fp32 operations) of one table-mode call: the q, k, v rows and
    the (cos, sin) rows (``table_rows``; by default one shared row dense,
    one a row paged) read once;
    q and the k, v columns (dense) or q and k (paged) written once.  Per
    q/k element a square, an add and a division (the norm); per pair 4
    products and 2 sums."""
    es = 2  # bf16
    rows = table_rows or (b if paged else 1)
    read = b * (hq + 2 * g) * hd * es + 2 * rows * hd // 2 * 4 + (4 * b if paged else 4)
    write = b * (hq + g) * hd * es if paged else b * (hq + 2 * g) * hd * es
    n = b * (hq + g) * hd
    return read + write, n * 3 + n // 2 * 6


def check_k3_table(gen):
    """K3's table mode (the '2d_ntk' RoPE of image generation) in the dense,
    ring and paged modes at the image decode's heads, bf16 and fp32, B 1 and
    4, with and without the QK-norm, against its plain version given the
    same (cos, sin) table (``rope_2d_ntk_cos_sin`` on the card): within
    PROLOGUE_ULPS, v and the rest of the cache exact; then timed at B=4 in
    bf16 beside the chain (the plain version) and the bound.  Returns the
    rows of the dense and the paged table mode."""
    import torch

    from vats_tpu_torch.nn.rope import rope_2d_ntk_cos_sin
    from vats_tpu_torch.ops import cache_append as ca

    hq, g, hd, L, S = 32, 4, 24, 12, IMG_DEC_S
    table = lambda pos: rope_2d_ntk_cos_sin(pos, hd, IMG_GRID_W, 10000.0, 0.7)  # noqa: E731
    worst = {"dense": [0.0, 0.0], "paged": [0.0, 0.0]}
    equal = total = 0
    n0 = (ca.dense_decode_prologue.table.launches, ca.paged_decode_prologue.table.launches)
    calls = [0, 0]

    def inputs(b, dtype):
        row = torch.randn((b, 1, (hq + 2 * g) * hd), generator=gen, device="cuda").to(dtype)
        q, k, v = torch.split(row, [hq * hd, g * hd, g * hd], dim=-1)
        return q.reshape(b, 1, hq, hd), k.reshape(b, 1, g, hd), v.reshape(b, 1, g, hd)

    for dtype in (torch.bfloat16, torch.float32):
        for b in (1, IMG_DEC_B):
            cache = torch.randn((2, 3, b, g, hd, S), generator=gen, device="cuda").to(dtype)
            for mode, qk_norm, pos in (("dense", True, 0), ("dense", False, 200),
                                       ("dense", True, S + 4), ("ring", True, S + 9),
                                       ("paged", True, 17), ("paged", False, 4095)):
                q, k, v = inputs(b, dtype)
                kw = dict(theta=10000.0, qk_norm=qk_norm)
                tol = PROLOGUE_ULPS[(str(dtype).split(".")[1], qk_norm)]
                if mode == "paged":
                    lens = torch.randint(0, 4096, (b,), generator=gen, device="cuda")
                    lens[0] = pos
                    lens = lens.to(torch.int32)
                    cs = table(lens[:, None])
                    got = ca.paged_decode_prologue(q, k, v, lens, None, cos_sin=cs, **kw)
                    want = ca.paged_decode_prologue_ref(q, k, v, lens, cos_sin=cs, **kw)
                    calls[1] += 1
                    pairs = list(zip(got[:2], want[:2]))
                    require(torch.equal(got[2], want[2]), "K3 table paged: v differs")
                else:
                    ka, va, kb, vb = (cache[i % 2].clone() for i in range(4))
                    length = torch.tensor(pos, dtype=torch.int32, device="cuda")
                    cs = table(length + torch.arange(1, device="cuda"))
                    ring = mode == "ring"
                    got = ca.dense_decode_prologue(q, k, v, ka, va, length, 1, None,
                                                   ring=ring, cos_sin=cs, **kw)
                    want = ca.dense_decode_prologue_ref(q, k, v, kb, vb, length, 1,
                                                        ring=ring, cos_sin=cs, **kw)
                    calls[0] += 1
                    col = pos % S if ring else min(pos, S - 1)
                    rest = torch.ones(S, dtype=torch.bool, device="cuda")
                    rest[col] = False
                    require(torch.equal(va, vb) and torch.equal(ka[..., rest], kb[..., rest])
                            and torch.equal(ka[0], kb[0]) and torch.equal(ka[2], kb[2]),
                            f"K3 table {mode}: the cache differs outside the k column")
                    pairs = [(got, want), (ka[1, ..., col], kb[1, ..., col])]
                torch.cuda.synchronize()
                key = "paged" if mode == "paged" else "dense"
                for x, y in pairs:
                    ulps = float(rotated_ulps(x, y).max())
                    require(ulps <= tol and bool(torch.isfinite(x.float()).all()),
                            f"K3 table {mode} {dtype} B={b}: {ulps:.2f} ulps beyond {tol}")
                    worst[key][0] = max(worst[key][0], float((x.float() - y.float()).abs().max()))
                    worst[key][1] = max(worst[key][1], ulps)
                    equal += int((x == y).sum())
                    total += x.numel()
    require((ca.dense_decode_prologue.table.launches - n0[0],
             ca.paged_decode_prologue.table.launches - n0[1]) == tuple(calls),
            "K3 table mode: a wrapper did not launch its kernel in table mode")
    log(f"K3 table mode ('2d_ntk', Hq 32, G 4, hd 24; B 1/{IMG_DEC_B}; bf16, fp32; dense, "
        f"ring, paged; QK-norm on and off): within PROLOGUE_ULPS of the chain given the "
        f"table; largest dense {worst['dense'][1]:.2f} ulps ({worst['dense'][0]:.3e}), paged "
        f"{worst['paged'][1]:.2f} ulps ({worst['paged'][0]:.3e}); {equal / total:.6f} of q "
        f"and k bit-equal; v and the rest of the cache exact")

    b = IMG_DEC_B
    q, k, v = inputs(b, torch.bfloat16)
    kc = torch.zeros((L, b, g, hd, S), dtype=torch.bfloat16, device="cuda")
    vc = torch.zeros_like(kc)
    length = torch.tensor(100, dtype=torch.int32, device="cuda")
    lens = torch.randint(0, 257, (b,), generator=gen, device="cuda").to(torch.int32)
    cs_d, cs_p = table(length + torch.arange(1, device="cuda")), table(lens[:, None])
    kw = dict(theta=1e4, qk_norm=True)
    rows = {}
    for key, kern, plain in (
            ("dense", lambda: ca.dense_decode_prologue(q, k, v, kc, vc, length, 5, None,
                                                       ring=False, cos_sin=cs_d, **kw),
             lambda: ca.dense_decode_prologue_ref(q, k, v, kc, vc, length, 5, ring=False,
                                                  cos_sin=cs_d, **kw)),
            ("paged", lambda: ca.paged_decode_prologue(q, k, v, lens, None, cos_sin=cs_p, **kw),
             lambda: ca.paged_decode_prologue_ref(q, k, v, lens, cos_sin=cs_p, **kw))):
        ms, call_ms = timed(kern)
        plain_ms, plain_call_ms = timed(plain)
        nbytes, ops = _table_cost(b, hq, g, hd, key == "paged")
        b_ms, by = bound(nbytes, ops, PEAK_FP32_FLOPS)
        log(f"K3 table {key} B={b} bf16 (cache [{L},{b},{g},{hd},{S}]): kernel_ms={ms:.5f} "
            f"plain_ms={plain_ms:.4f} (the chain given the table) bound_ms={b_ms:.7f} "
            f"({by}: {nbytes} bytes, {ops} fp32 ops); per call with host overhead: kernel "
            f"{call_ms:.4f} plain {plain_call_ms:.4f}")
        rows[key] = dict(max_abs_err=worst[key][0], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=by, library_ms=None)
    return rows["dense"], rows["paged"]


def check_k3_yarn(gen):
    """K3's paged table mode as code_chat_8k's 7 full layers run it: the
    YaRN table of Mellum2 (``mellum2_12b``'s published values, the attention
    factor in cos and sin) at its heads (Hq 32, G 4, hd 128), 64 rows of
    1k-8k tokens, bf16, no QK-norm, against the plain version given the same
    table: q and k within PROLOGUE_ULPS, v exact, one launch a call; timed
    beside the chain (the plain version) and the bound."""
    import torch

    from vats_tpu_torch.configs import mellum2_12b
    from vats_tpu_torch.nn.rope import rope_table_cos_sin, yarn_inv_freq
    from vats_tpu_torch.ops import cache_append as ca

    cfg = mellum2_12b()
    hq, g, hd, b = cfg.num_heads, cfg.query_groups, cfg.head_dim, WINDOW_B
    inv_freq = yarn_inv_freq(hd, cfg.rope_base, cfg.yarn_factor, cfg.yarn_original_max_position,
                             cfg.yarn_beta_fast, cfg.yarn_beta_slow, device="cuda")
    lens = torch.randint(1024, WINDOW_PPS * DECODE_PS, (b,), generator=gen, device="cuda")
    lens[:len(WINDOW_FIXED)] = torch.tensor(WINDOW_FIXED, device="cuda")
    lens = lens.to(torch.int32)
    cs = rope_table_cos_sin(lens[:, None], inv_freq, cfg.yarn_attention_factor)
    row = torch.randn((b, 1, (hq + 2 * g) * hd), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (x.reshape(b, 1, -1, hd) for x in torch.split(row, [hq * hd, g * hd, g * hd], -1))
    kw = dict(theta=cfg.rope_base, qk_norm=False, cos_sin=cs)
    kern = lambda: ca.paged_decode_prologue(q, k, v, lens, None, **kw)  # noqa: E731
    plain = lambda: ca.paged_decode_prologue_ref(q, k, v, lens, **kw)  # noqa: E731
    n0 = ca.paged_decode_prologue.table.launches
    got, want = kern(), plain()
    torch.cuda.synchronize()
    require(ca.paged_decode_prologue.table.launches == n0 + 1,
            "K3 YaRN: the wrapper did not launch its kernel in table mode")
    require(torch.equal(got[2], want[2]), "K3 YaRN: v differs")
    tol, worst = PROLOGUE_ULPS[("bfloat16", False)], [0.0, 0.0]
    for x, y in zip(got[:2], want[:2]):
        ulps = float(rotated_ulps(x, y).max())
        require(ulps <= tol and bool(torch.isfinite(x.float()).all()),
                f"K3 YaRN: {ulps:.2f} ulps beyond {tol}")
        worst = [max(worst[0], float((x.float() - y.float()).abs().max())), max(worst[1], ulps)]
    ms, call_ms = timed(kern)
    plain_ms, plain_call_ms = timed(plain)
    nbytes, ops = _table_cost(b, hq, g, hd, True)
    b_ms, by = bound(nbytes, ops, PEAK_FP32_FLOPS)
    log(f"K3 table paged, YaRN (factor {cfg.yarn_factor} over "
        f"{cfg.yarn_original_max_position}, attention factor {cfg.yarn_attention_factor}) "
        f"B={b} Hq={hq} G={g} hd={hd} bf16, lengths {int(lens.min())}-{int(lens.max())}: "
        f"{worst[1]:.2f} ulps ({worst[0]:.3e}) of the chain given the table, v exact; "
        f"kernel_ms={ms:.5f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.7f} ({by}: {nbytes} "
        f"bytes, {ops} fp32 ops); per call with host overhead: kernel {call_ms:.4f} plain "
        f"{plain_call_ms:.4f}")
    return dict(max_abs_err=worst[0], ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by)


def check_k1_image_gen(gen):
    """K1 at the image decode: head dim 24, 8 query heads a group (the
    generic NH=8 body), 4 groups, bf16 pool of 128-token pages, B=4 with
    lengths <= 257 (``generate_image_tokens_paged`` on 16 x 16) and B=1 at
    4096 (the 64 x 64 grid): output within the bf16 tolerance, the
    committed pool bit-equal; timed beside the plain version and the bound.
    The numbers go to the log; the ``kernels`` line keeps the LM's row."""
    import torch

    from vats_tpu_torch.ops.decode_attention import (
        PagedKVCache,
        paged_decode_attention_commit,
        paged_decode_attention_ref,
    )

    g, n, hd, ps, L = 4, 8, 24, 128, 12
    scale = hd**-0.5
    for label, b, fixed, cap in (("B=4 lengths<=257", 4, (0, 1, 128, 256), 384),
                                 ("B=1 at 4095", 1, (4095,), 4096)):
        pps = cap // ps
        pool = torch.randn((L, b * pps, 2, g, ps, hd), generator=gen,
                           device="cuda").to(torch.bfloat16)
        table = torch.randperm(b * pps, generator=gen, device="cuda").to(torch.int32)
        table = table.reshape(b, pps)
        lens = torch.tensor(fixed, dtype=torch.int32, device="cuda")
        mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
        q, kc, vc = mk(b, g * n, hd), mk(b, g, hd), mk(b, g, hd)
        kw = dict(scale=scale, k_cur=kc, v_cur=vc)
        pk, pp = pool.clone(), pool.clone()
        del pool
        n0 = paged_decode_attention_commit.launches
        out = paged_decode_attention_commit(q, pk, 3, table, lens, **kw)
        ref = paged_decode_attention_ref(q, pp[3], table, lens, **kw)
        PagedKVCache(pp, table, lens).append_token(3, kc, vc)
        torch.cuda.synchronize()
        require(paged_decode_attention_commit.launches == n0 + 1, "K1 (hd 24) did not launch")
        err = expect_close(f"K1 hd 24 N=8 {label}", out, ref, BF16_ATOL, BF16_RTOL)
        require(torch.equal(pk, pp), f"K1 hd 24 N=8 {label}: committed pool differs")
        kern = lambda: paged_decode_attention_commit(q, pk, 3, table, lens, **kw)  # noqa: E731
        (ms, call_ms) = timed(kern)
        plain_ms, _ = timed(lambda: paged_decode_attention_ref(q, pp[3], table, lens, **kw))
        alone = kernel_alone_ms(kern, "paged_decode")
        tokens = int(lens.sum())
        nbytes = (2 * b * g * n * hd * 2 + 2 * b * g * hd * 2 + tokens * 2 * g * hd * 2
                  + b * 2 * g * hd * 2 + b * pps * 4 + b * 4)
        b_ms, by = bound(nbytes, 4 * g * n * hd * (tokens + b))
        log(f"K1 paged decode+commit at the image decode {label} (Hq 32, G 4, hd 24, N=8 "
            f"body): max_abs_err={err:.3e} pool bit-equal; kernel_ms={ms:.4f} (kernel alone "
            f"{_fmt(alone)}) plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({by}); per call "
            f"with host overhead {call_ms:.4f}")
        del pk, pp
        torch.cuda.empty_cache()


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
    ms, library_ms, _ = flash_vs_sdpa(f"K2' B={B} T={T}",
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
    library_ms, parts, _ = backward_vs_sdpa(f"backward B={B} T={T}", q, k, v, o, do, lse, kw)
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


def backward_vs_sdpa(label, q, k, v, o, do, lse, kw, pad_do=False):
    """Device ms of the whole flash backward (``FlashAttentionFn.backward``
    on the saved tensors, the head dim padded as the autograd Function holds
    them: di, K5a, K5b, the casts; with ``pad_do`` the pad of the incoming
    gradient too, as a model's backward runs it) and of SDPA's backward on
    the same inputs, timed in turns (flash, SDPA, SDPA, flash), with the
    ratio, TFLOP/s (the backward's five products, 10 x Hq x hd per attended
    pair) and share of the bound printed, and each kernel's device time in
    one call.  Returns (SDPA's mean, {kernel name: device ms per call} of the
    flash backward; {} where the profiler recorded nothing, the flash
    backward's mean)."""
    from types import SimpleNamespace

    import torch

    from vats_tpu_torch.ops.flash_attention import FlashAttentionFn, _kernel_head_dim

    b, t, hq, hd = q.shape
    causal = kw.get("causal", False)
    dpad = _kernel_head_dim(hd)
    pad = lambda x: torch.nn.functional.pad(x, (0, dpad - hd)).contiguous()  # noqa: E731
    qp, kp, vp, op, dop = map(pad, (q, k, v, o, do))
    ctx = SimpleNamespace(saved_tensors=(qp, kp, vp, op, lse, None, None, None), kw=kw)
    if pad_do:
        flash = lambda: FlashAttentionFn.backward(ctx, pad(do))  # noqa: E731
    else:
        flash = lambda: FlashAttentionFn.backward(ctx, dop)  # noqa: E731
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = _sdpa(qt, kt, vt, kw["scale"], causal)
    dot = do.transpose(1, 2)
    lib = lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)  # noqa: E731
    k1, l1, l2, k2 = device_ms(flash), device_ms(lib), device_ms(lib), device_ms(flash)
    ms, lib_ms = (k1 + k2) / 2, (l1 + l2) / 2
    pairs = b * t * (t + 1) // 2 if causal else b * t * k.shape[1]
    flops = 10 * hq * hd * pairs
    # q, o, do in and dq out; k, v in and dk, dv out (bf16, logical head
    # dim); lse in
    nbytes = 4 * (q.numel() + k.numel()) * 2 + lse.numel() * 4
    b_ms, by = bound(nbytes, flops)
    log(f"  {label}: flash {k1:.4f} / {k2:.4f} ms, SDPA {l1:.4f} / {l2:.4f} ms in turns: "
        f"{ms / lib_ms:.2f}x SDPA; {flops / ms / 1e9:.1f} TFLOP/s (SDPA "
        f"{flops / lib_ms / 1e9:.1f}); bound {b_ms:.5f} ms ({by}), {b_ms / ms:.3f} of it")
    per, _ = profiled(flash, iters=20)
    parts = {name: us / 20 / 1e3 for name, (us, _) in per.items()}
    log("    per call: " + ", ".join(f"{ms_:.4f} ms {name[:60]}" for name, ms_ in
                                     sorted(parts.items(), key=lambda kv: -kv[1])))
    return lib_ms, parts, ms


# ViT-2D medium's attention (vit2d_medium: d1152 / 16 heads = head dim 72, 8
# KV groups, 384 px / p16 = 576 patches: T = S = 576, a ragged last 128-row
# tile; non-causal, no window, no mask) at the vision phase's forward batch.
VIT_B, VIT_T, VIT_HQ, VIT_G, VIT_HD = 16, 576, 16, 8, 72


def check_vit_flash(gen):
    """K2, K2' and the whole backward at ViT-2D medium's shape
    (``check_flash_at``; head dim 72 padded to 128, non-causal)."""
    return check_flash_at(gen, "ViT", VIT_B, VIT_T, VIT_HQ, VIT_G, VIT_HD, causal=False)


# The image transformer's full forward (image_gen_xsmall: d768 / 32 heads =
# head dim 24 over 4 KV groups; a 64 x 64 latent grid: T = S = 4096,
# causal), at B=1 (the trainer's B=2 halves it a row).
IMG_B, IMG_T, IMG_HQ, IMG_G, IMG_HD = 1, 4096, 32, 4, 24


def check_image_gen_flash(gen):
    """K2, K2' and the whole backward at the image transformer's shape
    (``check_flash_at``; head dim 24 padded to 32, causal)."""
    return check_flash_at(gen, "image gen", IMG_B, IMG_T, IMG_HQ, IMG_G, IMG_HD,
                          causal=True)


def check_flash_at(gen, tag, B, T, Hq, G, hd, causal):
    """K2, K2' and the whole backward (di, K5a, K5b, casts) at one shape
    against the plain versions.  The wrappers pad the head dim to 32, 64 or
    128 (exact); each is timed in turns with SDPA at the unpadded head dim,
    with its bound reckoned on the logical work, so the pad shows as lost
    time, and the share of the call outside the kernel (the pads; for the
    backward also di and the casts) printed.  Returns {K2, K2', K5a, K5b:
    numbers}; the ``kernels`` line keeps the LM's shapes."""
    import torch

    from vats_tpu_torch.ops.flash_attention import (
        _kernel_head_dim,
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_ref,
        flash_attention_lse,
        flash_attention_lse_ref,
        flash_attention_ref,
        flash_bwd_dkv,
        flash_bwd_dq,
    )

    dp = _kernel_head_dim(hd)
    scale = 1.0 / hd**0.5
    q, k, v, do = _train_attention_inputs(gen, B, T, Hq, G, hd)
    kw = dict(scale=scale, causal=causal)
    shape = (f"B={B} T=S={T} hd={hd}->{dp} " + ("causal" if causal else "non-causal"))
    fns = (flash_attention, flash_attention_lse, flash_bwd_dkv, flash_bwd_dq)
    n0 = [fn.launches for fn in fns]
    out_k = flash_attention(q, k, v, **kw)
    o_l, lse_k = flash_attention_lse(q, k, v, **kw)
    o_p, lse_p = flash_attention_lse_ref(q, k, v, **kw)
    di = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()
    got = flash_attention_bwd(q, k, v, do, lse_p, di, **kw)
    want = flash_attention_bwd_ref(q, k, v, do, lse_p, di, **kw)
    torch.cuda.synchronize()
    require([fn.launches - n for fn, n in zip(fns, n0)] == [1, 1, 1, 1],
            f"{tag} flash check: K2, K2', K5a and K5b must launch once each")
    allow = p_flip_allowance(q, k, v, **kw)
    err_k2 = expect_close(f"{tag} K2 out", out_k, o_p, BF16_ATOL, BF16_RTOL, allow)
    err_k2l = max(expect_close(f"{tag} K2' out", o_l, o_p, BF16_ATOL, BF16_RTOL, allow),
                  expect_close(f"{tag} K2' lse", lse_k, lse_p, 1e-4, 1e-5))
    require(torch.equal(out_k, o_l), f"{tag} flash check: K2 and K2' outputs differ")
    errs = [expect_close(f"{tag} K5 {n}", a, b_, BWD_ATOL, BWD_RTOL)
            for n, a, b_ in zip(("dq", "dk", "dv"), got, want)]
    del allow

    pairs = B * T * (T + 1) // 2 if causal else B * T * T
    flops = 4 * Hq * hd * pairs  # logical: q.k and p.v at the unpadded head dim
    in_bytes = (q.numel() + k.numel() + v.numel()) * 2
    rows = {}
    for name, fn, plain, extra in (
            ("K2", flash_attention, flash_attention_ref, 0),
            ("K2'", flash_attention_lse, flash_attention_lse_ref, B * Hq * T * 4)):
        b_ms, by = bound(in_bytes + q.numel() * 2 + extra, flops)
        plain_ms, _ = timed(lambda: plain(q, k, v, **kw))
        ms, lib_ms, alone = flash_vs_sdpa(
            f"{tag} {name} {shape}",
            lambda: fn(q, k, v, **kw), q, k, v, scale, b_ms, flops, causal=causal)
        pad = None if alone is None else 1 - alone / ms
        rows[name] = dict(ms=ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=by,
                          plain_ms=plain_ms, kernel_alone_ms=alone, outside_share=pad)
    pad = lambda x: torch.nn.functional.pad(x, (0, dp - hd)).contiguous()  # noqa: E731
    qp, kp, vp, dop = map(pad, (q, k, v, do))
    stats = 2 * B * Hq * T * 4  # lse and di
    kv_bytes = in_bytes + q.numel() * 2 + stats
    for name, fn, out_bytes, fl in (
            ("K5a", lambda: flash_bwd_dkv(qp, kp, vp, dop, lse_p, di, **kw), 2 * k.numel() * 4, 8),
            ("K5b", lambda: flash_bwd_dq(qp, kp, vp, dop, lse_p, di, **kw), q.numel() * 4, 6)):
        b_ms, by = bound(kv_bytes + out_bytes, fl * Hq * hd * pairs)
        ms = device_ms(fn)
        rows[name] = dict(ms=ms, bound_ms=b_ms, bound_by=by)
        log(f"  {tag} {name} alone at the kernel's head dim {dp}: {ms:.4f} ms "
            f"({fl * Hq * hd * pairs / ms / 1e9:.1f} logical TFLOP/s), bound {b_ms:.5f} ms "
            f"({by}) on the logical work, {b_ms / ms:.3f} of it")
    plain_bwd, _ = timed(lambda: flash_attention_bwd_ref(q, k, v, do, lse_p, di, **kw))
    lib_bwd, parts, whole = backward_vs_sdpa(
        f"{tag} backward {shape} (the do pad included)",
        q, k, v, o_p, do, lse_p, kw, pad_do=True)
    kern = sum(ms_ for name, ms_ in parts.items() if "flash_bwd" in name)
    for name in ("K5a", "K5b"):
        rows[name].update(library_ms=lib_bwd, plain_ms=plain_bwd, whole_ms=whole,
                          outside_share=(1 - kern / whole) if kern else None)
    log(f"{tag} flash at {shape} Hq={Hq} G={G}: "
        f"max_abs_err K2 {err_k2:.3e} K2' {err_k2l:.3e} (out within {BF16_ATOL} + "
        f"{BF16_RTOL}*|ref| + the p flip allowance, lse 1e-4) K5 dq {errs[0]:.3e} dk "
        f"{errs[1]:.3e} dv {errs[2]:.3e} (within {BWD_ATOL} + {BWD_RTOL}*|ref|); "
        + "; ".join(f"{n} " + " ".join(f"{k_}={v_ if k_ == 'bound_by' else _fmt(v_, 5)}"
                                        for k_, v_ in r.items()) for n, r in rows.items()))
    return rows


# One ring hop at nlp_medium's attention (24 / 8 heads of 60, padded to 64 in
# the ring, bf16) on a 2-rank ring over max_seq_len 4096: T = S = tl = 2048,
# B = 2 (the context_parallel phase's shape).
HOP_B, HOP_TL, HOP_RW = 2, 2048, 2300


def check_ring_hop(gen):
    """K2', K5a and K5b at a ring hop: the past shard (offset +tl, causal:
    every key of it visible), a wrapped future shard (offset -tl,
    non-causal, right window HOP_RW: a band of it visible, block skipping
    on both sides), each against its plain version; the backward fed a
    merged lse and di from outside, with rows at the 1e30 of a row that
    attends nothing anywhere (their dq must be exactly 0).  Each kernel
    timed at the past hop beside its bound, its plain version and SDPA
    over the same (fully visible) block.  Returns {K2', K5a, K5b: numbers}."""
    import torch

    from vats_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_ref,
        flash_attention_lse,
        flash_attention_lse_ref,
        flash_bwd_dkv,
        flash_bwd_dq,
    )

    B, T, Hq, G, hd = HOP_B, HOP_TL, TRAIN_HQ, TRAIN_G, TRAIN_HD
    scale = 1.0 / hd**0.5
    q, k, v, do = _train_attention_inputs(gen, B, T, Hq, G, hd)
    hops = {"past +tl causal": dict(scale=scale, causal=True, q_pos_offset=T),
            f"future -tl right_window {HOP_RW}": dict(scale=scale, causal=False,
                                                     right_window=HOP_RW, q_pos_offset=-T)}
    fns = (flash_attention_lse, flash_bwd_dkv, flash_bwd_dq)
    errs, outs = {}, {}
    for name, kw in hops.items():
        n0 = [fn.launches for fn in fns]
        o_k, lse_k = flash_attention_lse(q, k, v, **kw)
        o_p, lse_p = flash_attention_lse_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        require(flash_attention_lse.launches == n0[0] + 1, f"ring hop {name}: K2' did not launch")
        errs[f"K2' {name}"] = max(
            expect_close(f"ring hop {name} K2' out", o_k, o_p, BF16_ATOL, BF16_RTOL,
                         p_flip_allowance(q, k, v, **kw)),
            expect_close(f"ring hop {name} K2' lse", lse_k, lse_p, 1e-4, 1e-5))
        outs[name] = (o_p, lse_p)
    # the global statistics of the two hops merged, as the ring passes them
    (o_a, l_a), (o_b, l_b) = outs.values()
    la, lb = (torch.where(x > 1e29, -torch.inf, x) for x in (l_a, l_b))
    lse = torch.logaddexp(la, lb)
    wa = torch.exp(la - lse).nan_to_num().transpose(1, 2)[..., None]
    wb = torch.exp(lb - lse).nan_to_num().transpose(1, 2)[..., None]
    o = (o_a.float() * wa + o_b.float() * wb).to(q.dtype)
    lse[0, :, :5] = 1e30  # rows with no key anywhere
    lse = torch.where(torch.isfinite(lse), lse, 1e30).contiguous()
    di = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    for name, kw in hops.items():
        n0 = [fn.launches for fn in fns[1:]]
        got = flash_attention_bwd(q, k, v, do, lse, di, **kw)
        want = flash_attention_bwd_ref(q, k, v, do, lse, di, **kw)
        torch.cuda.synchronize()
        require([fn.launches - n for fn, n in zip(fns[1:], n0)] == [1, 1],
                f"ring hop {name}: K5a/K5b did not launch")
        for part, a, b_ in zip(("dq", "dk", "dv"), got, want):
            errs[f"K5 {part} {name}"] = expect_close(f"ring hop {name} K5 {part}", a, b_,
                                                    BWD_ATOL, BWD_RTOL)
        require(bool((got[0][0, :5] == 0).all()),
                f"ring hop {name}: rows whose lse is 1e30 must get dq = 0")

    kw = hops["past +tl causal"]
    pairs = B * T * T  # the past shard: every (query, key) pair attended
    flops = 4 * Hq * hd * pairs
    in_bytes = (q.numel() + k.numel() + v.numel()) * 2
    stats = 2 * B * Hq * T * 4
    rows = {}
    b_ms, by = bound(in_bytes + q.numel() * 2 + B * Hq * T * 4, flops)
    plain_ms, _ = timed(lambda: flash_attention_lse_ref(q, k, v, **kw))
    ms, lib_ms, alone = flash_vs_sdpa(f"ring hop K2' B={B} T=S={T} offset +tl",
                                      lambda: flash_attention_lse(q, k, v, **kw), q, k, v,
                                      scale, b_ms, flops, causal=False)
    rows["K2'"] = dict(ms=ms, bound_ms=b_ms, bound_by=by, plain_ms=plain_ms,
                       library_ms=lib_ms, kernel_alone_ms=alone)
    pad = lambda x: torch.nn.functional.pad(x, (0, 64 - hd)).contiguous()  # noqa: E731
    qp, kp, vp, dop = map(pad, (q, k, v, do))
    plain_bwd, _ = timed(lambda: flash_attention_bwd_ref(q, k, v, do, lse, di, **kw))
    lib_bwd, _, _ = backward_vs_sdpa(f"ring hop backward B={B} T=S={T} (SDPA non-causal)",
                                     q, k, v, o_a, do, l_a, dict(scale=scale, causal=False))
    for name, fn, out_bytes, fl in (
            ("K5a", lambda: flash_bwd_dkv(qp, kp, vp, dop, lse, di, **kw), 2 * k.numel() * 4, 8),
            ("K5b", lambda: flash_bwd_dq(qp, kp, vp, dop, lse, di, **kw), q.numel() * 4, 6)):
        b_ms, by = bound(in_bytes + q.numel() * 2 + stats + out_bytes, fl * Hq * hd * pairs)
        ms = device_ms(fn)
        rows[name] = dict(ms=ms, bound_ms=b_ms, bound_by=by, plain_ms=plain_bwd,
                          library_ms=lib_bwd)
    log(f"ring hop (B={B}, T=S={T}, Hq={Hq}, G={G}, hd={hd}->64, bf16): max_abs_err "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f" (out within {BF16_ATOL} + {BF16_RTOL}*|ref| + the p flip allowance, lse 1e-4, "
        f"K5 within {BWD_ATOL} + {BWD_RTOL}*|ref|; lse-1e30 rows dq exactly 0); "
        + "; ".join(f"{n} " + " ".join(f"{k_}={v_ if k_ == 'bound_by' else _fmt(v_, 5)}"
                                        for k_, v_ in r.items()) for n, r in rows.items()))
    return rows


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


TRAIN_TURN_STEPS = 3  # steps a turn of train_turns (graph, eager, eager, graph)


def tally_names(step_graph) -> dict:
    """{kernel wrapper's name: launches} a replay of ``step_graph`` adds."""
    return {fn.__name__: n for fn, n in step_graph.tally.items()}


def tally_gate(label, step_graph, want, phase):
    """Hold the launches a replay of ``step_graph`` adds to ``want``."""
    got = tally_names(step_graph)
    _gate(f"{label} (a replay's tally)", {k: got.get(k, 0) for k in want}, want, phase=phase)


def train_turns(label, graph_sets, tensors, run, fns, want, n, per_step, host=None,
                exact=None):
    """A train program from its graphs and eagerly in turns (graph, eager,
    eager, graph), each turn ``n`` steps from one snapshot of the state,
    restored in place: ``tensors`` (the state's and the model's buffers)
    and ``host`` (get, set) of host state (the accumulation position, a
    trainer's seed generator).  ``run(n)`` runs n steps and returns their
    metrics as a list of numbers or 0-d tensors (read after the timed
    wall); ``graph_sets`` are the step's
    ``TrainGraphs`` (``use_graph`` off for an eager turn).  Gates: each
    turn's launches of ``fns`` are n x ``want``; each turn's state and
    metrics are bit-equal to the first graph turn's.

    ``exact``: a context (``cudnn_deterministic``) without which the two
    paths are not bit-equal.  The gated turns then run in it, from graphs
    captured in it, and the timed turns run after them under the default
    setting, from graphs captured again (launch gates only).  Returns
    {path: {ms a step, rate (per_step units a second), peak and reserved
    GB}} of the timed turns and the launches of a graph turn."""
    import contextlib

    import torch

    snap = [t.detach().clone() for t in tensors]
    saved = host[0]() if host else None
    ref, launches = {}, {}

    def restore(use_graph):
        with torch.no_grad():
            for t, x in zip(tensors, snap):
                t.copy_(x)
        if host:
            host[1](saved)
        for g in graph_sets:
            g.use_graph = use_graph

    def recapture():
        """Drop the graphs and capture them again (a step from the
        snapshot), so that what follows replays graphs captured under the
        current setting."""
        for g in graph_sets:
            g.clear()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        restore(True)
        run(1)
        torch.cuda.synchronize()

    def turn(use_graph, check):
        path = "graph" if use_graph else "eager"

        def go():
            restore(use_graph)
            torch.cuda.synchronize()
            _zero(fns)
            t0 = time.perf_counter()
            metrics = run(n)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            metrics = [float(x) for x in metrics]
            got = launches[path] = _counts(fns)
            _gate(f"{label} [{path}] {n} steps", got, {k: v * n for k, v in want.items()},
                  phase="train")
            require(all(np.isfinite(metrics)), f"{label} [{path}]: metrics {metrics}")
            if not check:
                pass
            elif not ref:
                ref["metrics"], ref["state"] = metrics, [t.detach().clone() for t in tensors]
            else:
                diff = [i for i, (t, r) in enumerate(zip(tensors, ref["state"]))
                        if not torch.equal(t, r)]
                require(metrics == ref["metrics"] and not diff,
                        f"{label} [{path}]: not bit-equal to the first graph turn: metrics "
                        f"{metrics} against {ref['metrics']}; {len(diff)} of {len(tensors)} "
                        f"state tensors differ, the first at {diff[:4]} of shapes "
                        f"{[tuple(tensors[i].shape) for i in diff[:4]]}")
            return dict(ms=wall / n * 1e3, rate=per_step * n / wall), None

        return go

    with exact() if exact else contextlib.nullcontext():
        if exact:
            recapture()
        turns = in_turns(label + (" (bit-equality)" if exact else ""),
                         [("graph", turn(True, True)), ("eager", turn(False, True))])
    if exact:
        recapture()
        turns = in_turns(label, [("graph", turn(True, False)), ("eager", turn(False, False))])
    for g in graph_sets:
        g.use_graph = True
    nums = {}
    for path in ("graph", "eager"):
        rows = [x for x, _ in turns[path]]
        ms = float(np.mean([x["ms"] for x in rows]))
        nums[path] = dict(ms=ms, rate=per_step / (ms / 1e3),
                          peak_gb=max(x["peak_mem_gb"] for x in rows),
                          reserved_gb=max(x["reserved_gb"] for x in rows))
    del snap, ref
    return nums, launches["graph"]


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms: its default convolution backward
    may add with atomics, which no two runs share, so graph and eager are
    compared bit for bit in this context (and timed outside it)."""
    import torch

    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


def report_turns(label, nums, busy, unit, capture_s):
    """One line a path: ms a step, the rate, idle share (one profiled step's
    busy time over the timed mean), peak and reserved memory; then the
    capture seconds and graph/eager."""
    for path in ("graph", "eager"):
        x = nums[path]
        idle = None if busy.get(path) is None else 1 - busy[path] / (x["ms"] / 1e3)
        x["idle"] = idle
        log(f"{label} [{path}]: ms_per_step={x['ms']:.1f} {unit}={x['rate']:.1f} "
            f"device_busy_s={_fmt(busy.get(path), 4)} idle_share="
            f"{'not measured' if idle is None else f'{idle:.3f}'} (one profiled step) "
            f"peak_mem_gb={x['peak_gb']:.2f} reserved_gb={x['reserved_gb']:.2f}")
    log(f"{label}: capture_s={capture_s:.3f}; {unit} graph/eager "
        f"{nums['graph']['rate'] / nums['eager']['rate']:.3f}; state, moments, counters "
        f"and metrics bit-equal between graph and eager after every turn")


def dropout_census(label, step, state, batch):
    """The dropout masks of one eager step (forward and remat recompute), by
    shape, and the device time of ``keep_mask`` alone at each shape: what
    the device-seeded masks cost a step (the select and scale pass apart)."""
    import torch

    from vats_tpu_torch.nn import dropout as D

    shapes = []
    real = D.keep_mask

    def counted(seed, shape, rate, **kw):
        shapes.append((tuple(shape), rate))
        return real(seed, shape, rate, **kw)

    D.keep_mask = counted
    step.graphs.use_graph = False
    try:
        step(state, batch, 202)
    finally:
        D.keep_mask = real
        step.graphs.use_graph = True
    seed = torch.tensor(5, dtype=torch.int64, device="cuda")
    per = {}
    for shape, rate in sorted(set(shapes)):
        per[(shape, rate)] = device_ms(lambda: real(seed, shape, rate, layer=0, site=1,
                                                    device="cuda"), iters=10)
    total = sum(per[key] for key in shapes)
    log(f"train: {label}: dropout masks {len(shapes)} a step (forward and remat "
        f"recompute); keep_mask device ms each "
        + ", ".join(f"{list(sh)} rate {r}: {ms:.4f}" for (sh, r), ms in per.items())
        + f"; {total:.2f} device ms a step")


def run_train(counters):
    """medium_dense and medium_moe through ``make_train_step``: the first
    call (the warm-up, a real step, and the capture), then graph and eager
    in turns from one snapshot (``train_turns``), each path profiled once.
    Returns the launches of a graph turn (TRAIN_TURN_STEPS steps)."""
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
        t0 = time.perf_counter()
        model = TextLM(cfg, device="cuda", seed=0)
        state = create_train_state(model, create_optimizer(targs, 1000))
        step = make_train_step(model, targs)
        n_params = sum(p.numel() for p in model.parameters())
        batches = list(synthetic_lm_batches(gen, vocab_size=cfg.vocab_size, batch_size=B,
                                            seq_len=T, num_batches=n + 2))
        torch.cuda.synchronize()
        log(f"train: {tier} d{cfg.d_model}/{L}L E{cfg.num_experts} top-{cfg.top_k} vocab "
            f"{cfg.vocab_size} {n_params / 1e9:.3f}B params, B={B} T={T}, dropout "
            f"{cfg.dropout}, remat {cfg.remat_policy}, fused CE {targs.fused_ce_chunk}, mu "
            f"{targs.adam_mu_dtype}; built in {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        state, m = step(state, batches[0], 100)  # the warm-up step and the capture
        torch.cuda.synchronize()
        require(int(state.step) == 1 and len(step.graphs) == 1,
                f"train: {tier}: after the first call step {int(state.step)}, "
                f"{len(step.graphs)} graphs")
        graph = step.graphs[next(iter(step.graphs))]
        want = {"flash_attention_lse": 2 * L, "flash_bwd_dkv": L, "flash_bwd_dq": L,
                "flash_attention": 0}
        tally_gate(f"{tier} graph", graph, want, "train")
        log(f"train: {tier}: first call (eager warm-up + capture) "
            f"{time.perf_counter() - t0:.2f}s, capture_s={graph.capture_s:.3f}, loss "
            f"{float(m['loss']):.4f}; a replay's tally {json.dumps(tally_names(graph))}")

        def run(k):
            ms = [step(state, batches[1 + i], 101 + i)[1] for i in range(k)]
            return [x[key] for x in ms for key in sorted(x)]

        nums, got = train_turns(f"train: {tier}", [step.graphs],
                                state_tensors(state, list(model.buffers())), run, counters,
                                want, n, B * T)
        require(int(state.step) == 1 + n and int(state.skipped_steps) == 0,
                f"train: {tier}: step {int(state.step)} after 1 + {n} calls, skipped "
                f"{int(state.skipped_steps)}")
        metrics = [step(state, batches[-1], 200)[1]]
        aux = float(metrics[0]["aux_loss"])
        require(math.isfinite(aux) and (aux > 0) == (cfg.num_experts > 1),
                f"train: {tier}: aux loss {aux}")
        busy = {}
        for path, use_graph in (("graph", True), ("eager", False)):
            step.graphs.use_graph = use_graph
            busy[path] = profile_breakdown(f"train {tier} step [{path}]",
                                           lambda: step(state, batches[-1], 201), top=12,
                                           also=("flash_fwd", "flash_bwd"))
        step.graphs.use_graph = True
        report_turns(f"train: {tier}", nums, busy, "tokens_per_s", graph.capture_s)
        dropout_census(tier, step, state, batches[-1])
        log(f"train: {tier}: launches over a graph turn of {n} steps {json.dumps(got)} = per "
            f"step K2' {got['flash_attention_lse'] // n} ({L} forward + {L} recomputed under "
            f"remat), K5a {got['flash_bwd_dkv'] // n}, K5b {got['flash_bwd_dq'] // n}; "
            f"state.step {int(state.step)}; loss {float(metrics[0]['loss']):.4f} aux "
            f"{aux:.4f} grad norm {float(metrics[0]['grad_norm']):.4f}")
        out = out or got
        del model, state, step, batches, graph
        torch.cuda.empty_cache()
    run_train_accum(counters, gen)
    return out


TRAIN_ACCUM = 4  # TrainingArgs' default grad_accum_steps


def run_train_accum(counters, gen):
    """medium_dense at grad_accum_steps=4, the default: one graph a window
    position, against eager in turns of one window (``train_turns``' gates);
    the peak and reserved memory of both paths, which says what four
    captures cost beside eager (they share one gradient buffer a parameter
    and one pool)."""
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
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        step(state, batch, 300 + i)  # each position's warm-up step and capture
    torch.cuda.synchronize()
    require(len(step.graphs) == k and int(state.step) == k
            and accumulation_position(state) == 0,
            f"train: medium_dense accumulation: {len(step.graphs)} graphs, step "
            f"{int(state.step)}, position {accumulation_position(state)} after {k} calls")
    log(f"train: medium_dense grad_accum_steps={k}: first window (four warm-ups and "
        f"captures) {time.perf_counter() - t0:.2f}s")
    want = {"flash_attention_lse": 2 * L, "flash_bwd_dkv": L, "flash_bwd_dq": L,
            "flash_attention": 0}

    def run(n):
        ms = [step(state, batches[i % k], 310 + i)[1] for i in range(n)]
        return [x[key] for x in ms for key in sorted(x)]

    nums, _ = train_turns(f"train: medium_dense grad_accum_steps={k}", [step.graphs],
                          state_tensors(state, list(model.buffers())), run, counters, want,
                          k, B * T, host=(lambda: accumulation_position(state),
                                          lambda pos: set_accumulation_position(state, pos)))
    report_turns(f"train: medium_dense grad_accum_steps={k}", nums, {}, "tokens_per_s",
                 step.graphs.capture_s)
    del model, state, step, batches
    torch.cuda.empty_cache()


# --- phase: train_parity ----------------------------------------------------

# bf16 compute on both sides; the card and the CPU round their matmul sums at
# other places.  The loss is a mean over 1022 tokens of ~ln(65536) = 11.1:
# 0.02 is 0.2%.  The global norm sums those rounding differences over every
# gradient: 5% relative.  Adam normalises each step to at most ~lr per
# element whatever the gradient's size, so two runs whose small gradients
# differ in sign can part by at most 2 lr per applied step: params are held
# to 2 x (sum of the lr applied so far) + 1e-6.  That bound holds for any
# two updates of one sign pattern or another, so it cannot see a wrong
# gradient; the test is per leaf, before the update: each parameter's
# gradient card against CPU, ||g_card - g_cpu|| / ||g_cpu||, and each
# parameter's change since the start, ||d_card - d_cpu|| / ||d_cpu||.
# The change is ~lr x sign(g) per element after Adam's first step, so it
# moves by 2 lr on each element whose small gradient flips sign; a wrong
# gradient gives ~1.4 (unrelated) to 2 (negated).  Read on an H100 (worst
# leaf): gradients 9.8e-3 (steps 0-1) and 1.6e-2 (step 2, params already
# apart) here, 6.5e-3 in vision_parity; the change 7.2e-2 here, 6.0e-2
# there.  The limits are ~2.5x the worst of them.
PARITY_LOSS_ATOL, PARITY_NORM_RTOL = 0.02, 0.05
PARITY_LEAF_GRAD_RTOL, PARITY_LEAF_CHANGE_RTOL = 0.04, 0.2


def leaf_grad(name, p):
    return p.grad if p.grad is not None else p.new_zeros(p.shape)


def leaf_errors(card, cpu, of):
    """{name: ||of(name, a) - of(name, b)|| / ||of(name, b)||} over the two
    models' matching parameters (``of`` picks the gradient or the change),
    in fp32 on the CPU; 0 where both are zero, inf where only the card's is
    not."""
    out = {}
    for (name, a), (_, b) in zip(card.named_parameters(), cpu.named_parameters()):
        a, b = of(name, a).detach().cpu().float(), of(name, b).detach().float()
        d, n = float((a - b).norm()), float(b.norm())
        out[name] = d / n if n > 0 else (0.0 if d == 0 else float("inf"))
    return out


def leaf_report(label, errs, limit):
    """The worst leaf and the median of ``errs``; raises where any leaf is
    beyond ``limit`` (or not a number)."""
    name, worst = max(errs.items(), key=lambda kv: kv[1])
    median = sorted(errs.values())[len(errs) // 2]
    bad = sorted(n for n, e in errs.items() if not e <= limit)
    msg = (f"{label}: worst leaf {name} {worst:.3e}, median {median:.3e} over "
           f"{len(errs)} (limit {limit})")
    require(not bad, f"{msg}; beyond it: {bad}")
    return msg


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
    start = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    change = lambda n, p: p.detach().cpu() - start[n]  # noqa: E731
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
        report[-1] += "; " + leaf_report(
            f"train_parity step {i} gradients", leaf_errors(gpu, cpu, leaf_grad),
            PARITY_LEAF_GRAD_RTOL)
        report[-1] += "; " + leaf_report(
            f"train_parity step {i} change since the start", leaf_errors(gpu, cpu, change),
            PARITY_LEAF_CHANGE_RTOL)
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
    approx_sampling(model, ids, mask, counters, steps)
    top_k_on_card(cfg.vocab_size)

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


def bf16_ulps(a, b):
    """|a - b| in bf16 ulps: the distance between the two values along the
    ordered bf16 numbers (both bf16 tensors)."""
    import torch

    def ordered(x):
        i = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(a) - ordered(b)).abs()


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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, ln = generate_paged(model, ids, mask, g, approx_top_k=approx, **kw)
        torch.cuda.synchronize()
        runs[approx] = (tok, ln, {c.__name__: c.launches for c in counters},
                        time.perf_counter() - t0)
    (tok_a, len_a, cnt_a, wall_a), (tok_e, len_e, cnt_e, wall_e) = runs[True], runs[False]
    require(torch.equal(tok_a, tok_e) and torch.equal(len_a, len_e),
            "main: approx_top_k sampled other tokens than the exact top-k")
    L, B = model.cfg.num_layers, ids.shape[0]
    for name in ("paged_decode_attention_commit", "paged_decode_prologue"):
        require(cnt_a[name] == cnt_e[name] == L * steps,
                f"main: {name} launched {cnt_a[name]} (approx_top_k) / {cnt_e[name]} "
                f"(exact), expected {L * steps} each")
    require(cnt_a == cnt_e, f"main: launches differ with approx_top_k: {cnt_a} / {cnt_e}")
    new = tok_a[:, -steps:]
    log(f"main: generate_paged B={B} sampled (temperature 0.8, top-k 50, top-p 0.9) with "
        f"approx_top_k on / off from one seed: equal tokens ({new.numel()} new, "
        f"{int(new.unique().numel())} distinct), launches {json.dumps(cnt_a)} both; wall "
        f"{wall_a:.3f} / {wall_e:.3f} s (each call captures its decode graph)")


def top_k_on_card(vocab):
    """``exact_top_k`` (a stable sort: ties in index order, ``lax.top_k``'s
    order) on the card against the CPU on bf16 logits upcast to fp32 at
    the LM's vocabulary, values and indices equal; timed beside
    ``torch.topk``, whose order among ties is unspecified."""
    import torch

    from vats_tpu_torch.inference.sampling import exact_top_k

    g = torch.Generator(device="cuda").manual_seed(77)
    logits = (torch.randn((16, vocab), generator=g, device="cuda") * 3).bfloat16().float()
    for k in (50, 64):
        vals, idx = exact_top_k(logits, k)
        cv, ci = exact_top_k(logits.cpu(), k)
        tied = int((vals[:, 1:] == vals[:, :-1]).sum())
        require(torch.equal(vals.cpu(), cv) and torch.equal(idx.cpu(), ci),
                f"main: exact_top_k (k={k}) differs between the card and the CPU")
        tv, ti = torch.topk(logits, k, dim=-1)
        same = torch.equal(ti, idx)
        ms = cuda_ms(lambda: exact_top_k(logits, k))
        topk_ms = cuda_ms(lambda: torch.topk(logits, k, dim=-1))
        log(f"main: exact_top_k [16, {vocab}] k={k} on bf16 logits: card equal to the CPU "
            f"(values and indices; {tied} adjacent equal values among the top k); "
            f"{ms:.4f} ms (stable sort) beside torch.topk {topk_ms:.4f} ms, whose indices "
            f"{'equal' if same else 'differ from'} the stable order on the card")


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


# The serve phase's depth: nlp_medium's 20 layers cut to 2 (10 until the
# video and multimodal phases came, 5 until K6) so the whole script stays
# under 900 s; its eager drives are host-bound, and their time goes with
# the launches, with the depth.
SERVE_LAYERS = 2


def run_serve(kernel_fns):
    import torch

    from vats_tpu_torch.inference import QuantizedModel, ServingEngine, quantized_bytes
    from vats_tpu_torch.models import TextLM

    cfg = medium_cfg(num_layers=SERVE_LAYERS)
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
            eng.graphs.use_graph = use_graphs
            return eng

        # an untimed drive of the whole stream warms this configuration up
        # (allocator, cuBLAS choices for every prefill group and decode shape)
        drive(engine(True), stream)
        first = {}

        def timed(use_graphs, primed=False):
            def run():
                # the hook counts in the captures (a primed engine's too), so
                # it is installed first and zeroed after the priming drive
                fwd = ForwardCount(model)
                eng = engine(use_graphs)
                before = prime(eng, stream) if primed else {}
                fwd.launches = 0
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
                if use_graphs:
                    check_graph_runs(f"serve {name}", eng, before)
                lat = np.asarray(list(done_s.values()))
                nums = dict(
                    tokens_per_s=n_new / wall, wall_s=wall,
                    latency_p50_s=float(np.percentile(lat, 50)),
                    latency_p99_s=float(np.percentile(lat, 99)),
                    decode_forwards=eng.forwards["decode"], **graph_numbers(eng, before, wall,
                                                                            n_new))
                del eng
                return nums, outs
            return run

        got_runs = in_turns(f"serve [{name}]", [
            ("graph", timed(True)), ("eager", timed(False)),
            ("graph primed", timed(True, primed=True))], order=(0, 1, 2, 2, 1, 0))
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
            f"graph wall includes the captures (a fresh engine captures every prefill key "
            f"and block length again): tokens_per_s_without_capture leaves them out")
        # each path's own load, warm, once more under the profiler; its device
        # time over the mean unprofiled wall of that path is its idle share
        for path, use_graphs in (("graph", True), ("eager", False), ("graph primed", True)):
            eng = engine(use_graphs)
            if path == "graph primed":
                prime(eng, stream)
            busy = profile_breakdown(f"serve [{name}] [{path}], the whole stream again",
                                     lambda: drive(eng, stream))
            del eng
            walls = [n["wall_s"] for n, _ in got_runs[path]]
            if busy is not None:
                log(f"serve [{name}] [{path}]: device_busy_s={busy:.3f} over the mean "
                    f"timed wall_s={np.mean(walls):.3f}: idle_share="
                    f"{1 - busy / np.mean(walls):.3f}")
        decode_census(model, f"serve [{name}]", SERVE_ROWS, paged=True, kv_quant=kv_quant)
        runs[name], counts[name] = outs, got
        if name == "bf16 KV":
            serve_spec(model, stream, outs, engine_kw, kernel_fns, L)
            k7_launches = serve_lossless(model, stream, engine_kw, kernel_fns, L)
    pairs = [(runs["bf16 KV"][r], runs["int8 KV"][r]) for r in runs["bf16 KV"]]
    same = sum(int(x == y) for a, b in pairs for x, y in zip(a, b))
    first_diff = sum(common_prefix(a, b) for a, b in pairs)
    log(f"serve: greedy tokens of int8 KV equal to bf16 KV at {same}/{n_new} positions "
        f"({same / n_new:.3f}); equal up to the first difference: {first_diff}/{n_new}")
    del model
    torch.cuda.empty_cache()
    # the kernels line reports the int8 KV run's launches for K4, the
    # lossless drive's for K7
    return {**counts["bf16 KV"], k4.__name__: counts["int8 KV"][k4.__name__],
            "moe_grouped_gemm": k7_launches}


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
            outs[path], _, wall = drive(eng, stream)
            fw = eng.forwards["prefill"] + eng.forwards["decode"]
            require(len(outs[path]) == len(stream) and all(
                len(outs[path][r]) == n for r, (_, n) in enumerate(stream)),
                f"serve lossless [{path}]: requests unfinished or cut")
            require(k7.launches == 2 * L * fw > 0, f"serve lossless [{path}]: K7 "
                    f"{k7.launches} launches, want {2 * L * fw} for {fw} forwards")
            launches[path] = k7.launches
            log(f"serve lossless [{path}]: {sum(n for _, n in stream) / wall:.1f} tokens/s "
                f"over {wall:.2f} s, K7 {k7.launches} launches ({fw} forwards); "
                f"forwards {json.dumps(eng.forwards)}")
            del eng
        require(outs["graph"] == outs["eager"],
                "serve lossless: the graph and eager drives give other tokens")
        modes = [m.mode_calls for m in layers]
        require(all(set(c) == {"routed"} for c in modes),
                f"serve lossless: the layers resolved to {modes}")
    finally:
        for m, cf in zip(layers, old):
            m.capacity_factor = cf
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


def graph_numbers(engine, before, wall, n_new):
    """A drive's graph numbers: captures (count, seconds), replays, and the
    prefill graphs' share of them."""
    fresh = [g for key, g in engine.graphs.items() if key not in before]
    prefill = [g for key, g in engine.graphs.items() if key[0] == "prefill"]
    capture_s = sum(g.capture_s for g in fresh)
    return dict(tokens_per_s_without_capture=n_new / (wall - capture_s),
                captures=len(fresh), capture_s=capture_s,
                replays=engine.graphs.replays - sum(before.values()),
                prefill_graphs=len(prefill),
                prefill_capture_s=sum(g.capture_s for g in prefill if g in fresh),
                prefill_replays=sum(g.replays for g in prefill)
                - sum(n for key, n in before.items() if key[0] == "prefill"))


# The spec drive: prompt-lookup drafts of SPEC_K tokens, verified by one
# forward over [rows, SPEC_K + 1] (greedy; the engine runs no decode blocks
# with spec_k)
SPEC_K = 4


def serve_spec(model, stream, plain_outs, engine_kw, kernel_fns, L):
    """The bf16-KV stream with speculative decoding (spec_k = SPEC_K, greedy,
    one-token decode steps only near the context cap), from graphs (the
    verify forward from one) on a fresh and on a primed engine (``prime``)
    and eagerly, in turns.  Gates: every drive's tokens equal, the forwards
    of each kind, the drafts and the preemptions equal on every path, the
    verify graph run once a verify forward, one prefill graph a key, K1 and
    K3's paged prologue once a layer a decode forward, K6 once a layer a
    prefill or verify forward, every request whole
    and every page back.  Reports tokens/s,
    the drafts' acceptance and the share of positions whose token equals
    the plain greedy drive's (``plain_outs``; the verify forward's plain
    attention rounds bf16 otherwise than K1, so not gated)."""
    import torch

    from vats_tpu_torch.inference import ServingEngine

    k1, k3 = kernel_fns["paged_decode_attention_commit"], kernel_fns["paged_decode_prologue"]
    k6 = kernel_fns["paged_prefill_attention"]
    kw = dict(engine_kw, decode_block_steps=1, spec_k=SPEC_K)
    n_new = sum(n for _, n in stream)
    seen = {}

    def engine(use_graphs):
        eng = ServingEngine(model, **kw)
        eng.graphs.use_graph = use_graphs
        return eng

    def timed(use_graphs, primed=False):
        def run():
            eng = engine(use_graphs)
            before = prime(eng, stream) if primed else {}
            torch.cuda.empty_cache()
            _zero(kernel_fns.values())
            outs, done_s, wall = drive(eng, stream)
            label = f"serve spec [{'graph' if use_graphs else 'eager'}]"
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
            state = (dict(eng.forwards), eng.spec_proposed, eng.spec_accepted,
                     eng.preemptions)
            require(seen.setdefault("first", state) == state,
                    f"{label}: forwards, drafts or preemptions {state}, first drive "
                    f"{seen['first']}")
            nums = dict(tokens_per_s=n_new / wall, wall_s=wall,
                        verify_forwards=eng.forwards["verify"], decode_forwards=dec,
                        **graph_numbers(eng, before, wall, n_new))
            del eng
            return nums, outs
        return run

    got = in_turns(f"serve spec_k={SPEC_K} [bf16 KV]", [
        ("graph", timed(True)), ("eager", timed(False)),
        ("graph primed", timed(True, primed=True))], order=(0, 1, 2, 2, 1, 0))
    tagged = [(f"{path} {i}", o) for path, rs in got.items() for i, (_, o) in enumerate(rs)]
    for tag, o in tagged[1:]:
        diff = [r for r in o if o[r] != tagged[0][1][r]]
        require(not diff, f"serve spec: {tagged[0][0]} and {tag} drives give other tokens "
                f"for requests {diff[:8]}")
    fw, proposed, accepted, preempt = seen["first"]
    outs = got["graph"][0][1]
    same = sum(int(x == y) for r in outs for x, y in zip(outs[r], plain_outs[r]))
    log(f"serve spec_k={SPEC_K} [bf16 KV]: forwards {json.dumps(fw)} (equal on every path); "
        f"drafts accepted {accepted}/{proposed} ({accepted / max(proposed, 1):.3f}); "
        f"preemptions {preempt}; tokens equal to the plain greedy drive's at {same}/{n_new} "
        f"positions ({same / n_new:.3f})")
    for path, use_graphs in (("graph", True), ("eager", False), ("graph primed", True)):
        eng = engine(use_graphs)
        if path == "graph primed":
            prime(eng, stream)
        busy = profile_breakdown(
            f"serve spec_k={SPEC_K} [bf16 KV] [{path}], the whole stream again",
            lambda: drive(eng, stream))
        del eng
        walls = [n["wall_s"] for n, _ in got[path]]
        if busy is not None:
            log(f"serve spec [{path}]: device_busy_s={busy:.3f} over the mean timed wall_s="
                f"{np.mean(walls):.3f}: idle_share={1 - busy / np.mean(walls):.3f}")


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
        engine.graphs.use_graph = use_graphs
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
        free = shutil.disk_usage(tmp).free

        def room(what):
            free_now = shutil.disk_usage(tmp).free
            require(free_now >= 2 * ckpt_bytes,
                    f"scripts: {free_now / 1e9:.1f} GB free in {tmp} before {what}; "
                    f"need twice a checkpoint, {2 * ckpt_bytes / 1e9:.1f} GB")

        log(f"scripts: nlp_medium {n_params / 1e9:.3f}B params, a checkpoint of about "
            f"{ckpt_bytes / 1e9:.2f} GB; {free / 1e9:.1f} GB free in {tmp}")
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

        def train_run(label, extra, tokens_before=0):
            room(label)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero(fns)
            t0 = time.perf_counter()
            out = train_script.main(args + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
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
            new_tokens = r["tokens_seen"] - tokens_before
            best, regular = r["saved"]["best"], r["saved"]["regular"]
            # a round that saves both writes one file and links the other name
            require(best is None or os.path.samefile(best, regular),
                    f"scripts: {label}: best and regular are two files, not one")
            log(f"scripts: {label}: {wall:.2f}s in main; {SCRIPT_EVERY} micro-steps "
                f"{r['train_s']:.2f}s, tokens_seen {r['tokens_seen']}, tokens_per_s "
                f"{new_tokens / r['train_s']:.1f}; validate {VAL_BATCHES} batches "
                f"{r['validate_s']:.2f}s; save {r['save_s']:.2f}s: "
                f"{os.path.basename(regular)} {os.path.getsize(regular) / 1e9:.3f} GB"
                + (", best_model a link to it" if best else "")
                + f"; peak_mem_gb {torch.cuda.max_memory_allocated() / 1e9:.2f}; train "
                f"loss {out['history']['train_loss'][0]:.4f} val loss "
                f"{out['history']['val_loss'][0]:.4f}; launches {json.dumps(got)}")
            return out, r

        # 1. train: one round, a best and a regular checkpoint
        out, r = train_run("train", ["--max-train-tokens", str(SCRIPT_TOKENS)])
        n_seen = r["tokens_seen"]
        regular = os.path.join(tmp, f"checkpoint_tokens_seen_{n_seen}")
        require(r["saved"]["regular"] == regular and r["saved"]["best"]
                == os.path.join(tmp, "best_model"), f"scripts: saved {r['saved']}")
        require(os.path.getsize(regular) >= ckpt_bytes, "scripts: checkpoint too small")
        # where a save's time goes: the copy off the card, then the file write
        room("the save split")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = state_tree(out["state"], lambda t: t.to("cpu"))
        copy_s = time.perf_counter() - t0
        probe = os.path.join(tmp, "save_split_probe")
        t0 = time.perf_counter()
        torch.save(host, probe)
        write_s = time.perf_counter() - t0
        n_bytes = os.path.getsize(probe)
        os.remove(probe)
        del host
        log(f"scripts: a save of the same state in two parts: copy off the card "
            f"{copy_s:.2f}s ({n_bytes / copy_s / 1e9:.2f} GB/s), torch.save of the host "
            f"copy {write_s:.2f}s ({n_bytes / write_s / 1e9:.2f} GB/s), {n_bytes / 1e9:.3f} "
            f"GB; the script's save {r['save_s']:.2f}s")

        # 2. resume: the regular checkpoint into a fresh state, bit for bit
        saved = state_tree(out["state"])
        with open(regular + ".meta.json") as f:
            meta = json.load(f)
        targs = TrainingArgs(grad_accum_steps=meta["training_args"]["grad_accum_steps"],
                             adam_mu_dtype=meta["training_args"]["adam_mu_dtype"])
        model = TextLM(ModelArgs.from_dict(meta["model_args"]), device="cuda", seed=99)
        fresh = create_train_state(model, create_optimizer(targs, 1))
        del out
        t0 = time.perf_counter()
        fresh, _ = load_checkpoint(regular, target=fresh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        diff = _state_bit_equal(saved, state_tree(fresh))
        require(not diff, f"scripts: the loaded state differs from the saved one at "
                f"{diff[:6]}")
        n_tensors = sum(1 for _ in _tensors(saved))
        log(f"scripts: load of {os.path.basename(regular)} into a fresh state on the "
            f"card {load_s:.2f}s: {n_tensors} tensors (params, mu, nu, acc_grads, "
            f"counters) bit-equal to the saved state; mini_step "
            f"{fresh.opt_state.mini_step}, gradient_step "
            f"{int(fresh.opt_state.gradient_step)}")
        del saved, fresh, model
        torch.cuda.empty_cache()
        res, r2 = train_run("resume", ["--max-train-tokens", str(n_seen + SCRIPT_TOKENS),
                                       "--resume", regular], tokens_before=n_seen)
        require(n_seen < r2["tokens_seen"] and int(res["state"].step) == 2 * SCRIPT_EVERY,
                f"scripts: resumed tokens_seen {r2['tokens_seen']} after {n_seen}, step "
                f"{int(res['state'].step)}")
        log(f"scripts: resume continued tokens_seen {n_seen} -> {r2['tokens_seen']}, "
            f"step {SCRIPT_EVERY} -> {int(res['state'].step)}")
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
            log(f"scripts: serve [{name}] best_model, 8 requests x {n_new} tokens: "
                f"tokens_per_s {got['tokens_per_s']:.1f} wall_s {got['wall_s']:.3f} "
                f"latency p50 {got['latency_p50_s']:.3f}s p99 {got['latency_p99_s']:.3f}s; "
                f"forwards {json.dumps(got['forwards'])}; launches {json.dumps(counts)}")

        # 4. the interactive script on the trained checkpoint at temperature 0:
        # one decode forward a new token (as the main phase's TokenGenerator
        # gate), each a fused prologue a layer, dense or paged before K1
        prompts = ["Once upon a time,", "hello world"]
        n_new = 32
        fw = n_new * len(prompts)
        texts = {}
        for name, extra in (("dense", []), ("paged", ["--paged"])):
            argv = ["--ckpt", os.path.join(tmp, "best_model"), "--device", "cuda",
                    "--temperature", "0", "--max-new-tokens", str(n_new)] + extra
            _zero(fns)
            t0 = time.perf_counter()
            outs = interactive_script.main(argv, tokenizer=StubTokenizer(),
                                           stdin=io.StringIO("\n".join(prompts) + "\nquit\n"))
            torch.cuda.synchronize()
            print()  # ends the script's last '> ' prompt line
            wall = time.perf_counter() - t0
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
            texts[name] = outs
            log(f"scripts: interactive [{name}] best_model, {len(prompts)} prompts x "
                f"{n_new} tokens at temperature 0: {wall:.2f}s in main (checkpoint load "
                f"and the generator's build included); launches {json.dumps(counts)}")
        log(f"scripts: interactive dense and paged texts equal: "
            f"{texts['dense'] == texts['paged']}")

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
    the MLP are per token).  Tolerance: one bf16 ulp of the logit
    (BF16_ATOL + BF16_RTOL |logit|, the bound the kernels phase holds K2'
    to before its flip allowance); masked scores add exact zeros and the
    two runs are the same kernels on the same shapes, so bit-equal is
    expected and the count is printed."""
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
        return logits.detach().float(), float(loss.detach())

    _zero(fns)
    t0 = time.perf_counter()
    out1, loss1 = fwd_bwd(batch["input_ids"])
    redraw = torch.randint(1, cfg.vocab_size, segs.shape, generator=gen, device="cuda",
                           dtype=torch.int32)
    ids2 = torch.where(first, redraw, batch["input_ids"])
    out2, loss2 = fwd_bwd(ids2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _gate("packed shards", _counts(fns), {"flash_attention_lse": 2 * 2 * L,
                                          "flash_bwd_dkv": 2 * L, "flash_bwd_dq": 2 * L,
                                          "flash_attention": 0})
    require(bool((ids2 != batch["input_ids"]).any()), "scripts: nothing was re-drawn")
    a, b = out1[later], out2[later]
    err = expect_close("packed shards: later segments' logits", b, a, BF16_ATOL,
                       BF16_RTOL)
    changed = float((out1[first] - out2[first]).abs().max())
    require(changed > 0, "scripts: the re-drawn segments' logits did not change")
    log(f"scripts: packed shards: {consumed} documents (32-600 tokens) in {SCRIPT_B} rows "
        f"of {TRAIN_T}, {rows} rows with 2+ segments, {int(later.sum())} later-segment "
        f"positions; medium_dense d{cfg.d_model}/{cfg.num_layers}L forward + backward "
        f"twice {wall:.2f}s (losses {loss1:.4f}, {loss2:.4f}); later segments' logits "
        f"max |diff| {err:.3e}, bit-equal {int((a == b).sum())}/{a.numel()}; first "
        f"segments' logits moved by up to {changed:.3f}")
    del model


# --- entry point ------------------------------------------------------------


# --- phases: vision, vision_parity ------------------------------------------

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


def vision_forward(label, model, x, fns, want, per_call, unit, iters):
    """One eager forward with the flash counters zeroed just before and read
    just after (held to ``want``); then the forward from a graph
    (``graph_forward``): its first call the warm-up and the capture, one
    replay gated as the eager forward (counters zeroed just before, read
    just after) and bit-equal to it.  Then graph and eager in turns (graph,
    eager, eager, graph; ``iters`` forwards each, CUDA events, after a
    warm-up), each with its peak and reserved memory, and one profiled
    forward of each (device-busy time, idle share over the timed mean).
    Returns (eager output, {path: numbers, 'replay_launches': counts})."""
    import torch

    with torch.no_grad():
        _zero(fns)
        out = model(x)
        torch.cuda.synchronize()
        got = _vision_gate(label, fns, want)
    require(bool(torch.isfinite(out.float()).all()), f"vision: {label} not finite")
    call, graphs = graph_forward(model, x, out)
    call()
    torch.cuda.synchronize()
    _zero(fns)
    replayed = call()
    torch.cuda.synchronize()
    nums = {"replay_launches": _vision_gate(f"{label} graph replay", fns, want)}
    require(torch.equal(replayed, out), f"vision: {label}: the graph's features are not "
            f"eager's bit for bit (max |diff| {float((replayed - out).abs().max())})")

    def eager():
        with torch.no_grad():
            return model(x)

    def timed_path(fn):
        def run():
            ms = cuda_ms(fn, iters=iters, warmup=1)
            return dict(ms=ms, rate=per_call / (ms / 1e3)), None
        return run

    turns = in_turns(f"vision: {label}", [("graph", timed_path(call)),
                                          ("eager", timed_path(eager))])
    for path, fn in (("graph", call), ("eager", eager)):
        ms = float(np.mean([n["ms"] for n, _ in turns[path]]))
        busy = profile_breakdown(f"{label} [{path}] forward", fn, top=8, also=("flash",))
        idle = None if busy is None else 1 - busy / (ms / 1e3)
        nums[path] = dict(ms=ms, rate=per_call / (ms / 1e3), busy_s=busy, idle=idle,
                          peak_gb=max(n["peak_mem_gb"] for n, _ in turns[path]),
                          reserved_gb=max(n["reserved_gb"] for n, _ in turns[path]))
        log(f"vision: {label} [{path}]: launches a forward {json.dumps(got)}; "
            f"ms_per_forward={ms:.3f} {unit}={per_call / (ms / 1e3):.1f} (mean of two "
            f"turns) peak_mem_gb={nums[path]['peak_gb']:.2f} reserved_gb="
            f"{nums[path]['reserved_gb']:.2f} device_busy_s={_fmt(busy, 5)} idle_share="
            f"{'not measured' if idle is None else f'{idle:.3f}'} (one profiled forward)")
    log(f"vision: {label}: graph capture_s={graphs.capture_s:.3f}, replays "
        f"{graphs.replays}; features bit-equal to eager; {unit} graph/eager "
        f"{nums['graph']['rate'] / nums['eager']['rate']:.3f}")
    del call, graphs
    return out, nums


def resize_on_card(x, size, label):
    """``resize_bilinear`` (``jax.image.resize``'s weights and contractions,
    each rounded to bf16) on the card against the CPU on the same bf16
    input: at most one bf16 ulp apart (fp32 sums in another order move a
    rounding now and then); timed on the card."""
    import torch

    from vats_tpu_torch.models.vit2d import resize_bilinear

    got = resize_bilinear(x, size)
    want = resize_bilinear(x.cpu(), size)
    require(got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape,
            f"vision: {label}: {got.dtype} {tuple(got.shape)} / {want.dtype} "
            f"{tuple(want.shape)}")
    ulps = bf16_ulps(got.cpu(), want)
    worst = int(ulps.max())
    require(worst <= 1, f"vision: {label} on the card {worst} bf16 ulps from the CPU")
    ms = cuda_ms(lambda: resize_bilinear(x, size), iters=10)
    log(f"vision: {label} -> {tuple(size)} bf16, card against CPU: "
        f"{int((ulps > 0).sum())} of {ulps.numel()} elements differ, at most {worst} bf16 "
        f"ulp (limit 1); {ms:.4f} ms on the card")


def run_vision(fns):
    """ViT-2D medium forward (K2 only, 16 launches a forward) at B=16 on
    384x384, eagerly and from a CUDA graph in turns, and on a non-square
    size (resize and crop on the card), ViT-2D medium training through
    ``make_vision_train_step`` (one round of 4 micro-steps of B=32 with
    mixup / cutmix and the pixel battery on the card; K2', K5a and K5b per
    micro-step as derived below) and its eval step from its graph, then
    ViT-3D xsmall and large forwards, eagerly and from graphs in turns (no
    flash kernel: the JAX model attends with XLA there).  Depth uncut
    everywhere.  Returns the flash launches of one ViT-2D graph replay."""
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
    n_params = sum(p.numel() for p in model.parameters())
    log(f"vision: vit2d_medium {cfg.target_size}px/p{cfg.patch_size} d{cfg.d_model}/"
        f"{L}L {cfg.num_heads}H/{cfg.query_groups}G hd {cfg.head_dim}, "
        f"{cfg.num_patches} patches, {n_params / 1e6:.1f}M params (bf16), "
        f"B={VIT2D_FWD_B}")
    want = {k2: L, k2l: 0, k5a: 0, k5b: 0}
    x = torch.randn((VIT2D_FWD_B, 3, 384, 384), generator=gen, device="cuda").to(torch.bfloat16)
    feats, fwd = vision_forward("vit2d_medium 384x384", model, x, fns, want, VIT2D_FWD_B,
                                "images_per_s", iters=10)
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
    resize_on_card(xr, (384, 455), f"vit2d_medium's resize [{VIT2D_FWD_B}, 3, 448, 531]")
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
    t0 = time.perf_counter()
    for i in range(VIT2D_ACCUM):  # first round: each position's warm-up and capture
        state, m = step(state, batches[i], i)
    torch.cuda.synchronize()
    log(f"vision: vit2d_medium training, {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M "
        f"params (fp32, bf16 compute), dropout {cfg.dropout}, remat, accum {VIT2D_ACCUM} x "
        f"B={B}; first round (each micro-step's warm-up and capture) "
        f"{time.perf_counter() - t0:.2f}s, capture_s={step.graphs.capture_s:.3f}")
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

    nums, got = train_turns(
        "vision: vit2d training round", [step.graphs],
        state_tensors(state, list(model.buffers())), run, fns, train_want, VIT2D_ACCUM, B,
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
    lams = [round(float(m["lam"]), 4) for m in metrics]
    norm = float(metrics[-1]["grad_norm"])
    require(all(math.isfinite(v) for v in losses + [norm, ev0, ev1_loss]),
            f"vision: non-finite training numbers {losses} {norm} {ev0} {ev1_loss}")
    require(ev1_loss != ev0, "vision: the update left the eval loss unchanged")
    require(int(state.step) == 2 * VIT2D_ACCUM
            and int(state.opt_state.gradient_step) == 2, "vision: step counters wrong")
    log(f"vision: vit2d training round launches {json.dumps(got)} = per micro-step K2' "
        f"{got[k2l] // VIT2D_ACCUM} ({L} forward + {L} recomputed), K5a "
        f"{got[k5a] // VIT2D_ACCUM}, K5b {got[k5b] // VIT2D_ACCUM}; eval step K2 {L} a graph replay "
        f"(equal to eager bit for bit; capture_s={eval_step.graphs.capture_s:.3f})")
    busy = {}
    for path, use_graph in (("graph", True), ("eager", False)):
        step.graphs.use_graph = use_graph
        busy[path] = profile_breakdown(f"vit2d training micro-step [{path}]",
                                       lambda: step(state, batches[0], 200), top=10,
                                       also=("flash",))
    step.graphs.use_graph = True
    report_turns("vision: vit2d training (a micro-step)", nums, busy, "images_per_s",
                 step.graphs.capture_s)
    log(f"vision: vit2d training: losses {[round(v, 4) for v in losses]} lam {lams} grad "
        f"norm (boundary) {norm:.4f}; eval loss before the round's update {ev0:.5f} after "
        f"{ev1_loss:.5f} acc {float(ev1['acc']):.4f}")
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
        log(f"vision: {name} p{cfg.patch_size} {cfg.max_frames} frames at {th}x{tw}, "
            f"d{cfg.d_model}/{cfg.num_layers}L {cfg.num_heads}H/{cfg.query_groups}G, grid "
            f"{gt}x{gh}x{gw}, {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M "
            f"params (bf16), B={VIT3D_B}")
        x = torch.randn((VIT3D_B, 3, cfg.max_frames, th, tw), generator=gen,
                        device="cuda").to(torch.bfloat16)
        out, _ = vision_forward(name, model, x, fns, zero_flash, VIT3D_B * cfg.max_frames,
                                "frames_per_s", iters=5)
        if name == "vit3d_large":  # its frames at the target already: 4:3 frames too
            clip = torch.randn((VIT3D_B, 3, cfg.max_frames, 240, 320), generator=gen,
                               device="cuda").to(torch.bfloat16)
            resize_on_card(clip, (th, tw), f"vit3d_large's per-frame resize "
                           f"[{VIT3D_B}, 3, {cfg.max_frames}, 240, 320]")
        require(tuple(out.shape) == (VIT3D_B, gt * gh * gw, cfg.d_model),
                f"vision: {name} features {tuple(out.shape)}")
        del model, out, x
        torch.cuda.empty_cache()
    return fwd["replay_launches"]


# Card (kernels, bf16 compute) against the CPU (plain versions), same
# weights.  The two round bf16 at other places (each product's sum, the
# resize), a few bf16 ulps (2^-8 relative) of activations up to ~5 after
# two (ViT-2D) or four (ViT-3D) layers: features atol 0.1 + rtol 0.02;
# logits (a mean over 576 patches through a 1/sqrt(d) head) atol 0.05 +
# rtol 0.02.  Loss and grad norm as the LM's train_parity (0.02 on a loss
# of ~ln(1000) = 6.9; 5% of the norm); each parameter's gradient and its
# change in the step per leaf, as there (PARITY_LEAF_*).
VISION_FEAT_TOL = dict(atol=0.1, rtol=0.02)
VISION_LOGIT_TOL = dict(atol=0.05, rtol=0.02)


def run_vision_parity():
    """ViT-2D at medium width (2 layers, B=2, 1000 classes, remat on): the
    eval forward (features, logits) and one train step at dropout 0 without
    augmentation on the card (K2; K2', K5a, K5b) against the CPU; ViT-3D
    xsmall at its full config, B=1, the last 6 of 32 frames padded: features
    card against CPU."""
    import torch

    from vats_tpu_torch.configs import vit2d_medium, vit3d_xsmall
    from vats_tpu_torch.models import ImageEncoder, VideoTransformer
    from vats_tpu_torch.train import (
        VisionTrainingArgs,
        create_train_state,
        create_vision_optimizer,
        make_vision_train_step,
    )

    def pair(cls, cfg, seed):
        gpu = cls(cfg, device="cuda", seed=seed)
        cpu = cls(cfg, device="meta")
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, assign=True)
        return gpu, cpu

    def with_features(model, *args, **kw):
        got = {}
        h = model.norm.register_forward_hook(lambda m, i, o: got.setdefault("f", o))
        try:
            with torch.no_grad():
                out = model(*args, **kw)
        finally:
            h.remove()
        return got["f"].float().cpu(), out.float().cpu()

    cfg = vit2d_medium(num_layers=2, dropout=0.0, num_classes=1000, use_checkpointing=True)
    gpu, cpu = pair(ImageEncoder, cfg, 7)
    g = torch.Generator().manual_seed(23)
    x = torch.randn((2, 3, 384, 384), generator=g)
    labels = torch.tensor([3, 997])
    from vats_tpu_torch.ops import flash_attention as fa

    n0 = fa.flash_attention.launches
    fg, lg = with_features(gpu, x.cuda())
    require(fa.flash_attention.launches == n0 + cfg.num_layers, "vision_parity: K2 launches")
    fc, lc = with_features(cpu, x)
    err_f = expect_close("vision_parity vit2d features", fg, fc, **VISION_FEAT_TOL)
    err_l = expect_close("vision_parity vit2d logits", lg, lc, **VISION_LOGIT_TOL)

    args = VisionTrainingArgs(grad_accum_steps=1, use_augmentation=False, warmup_epochs=1,
                              epochs=10)
    start = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    out = {}
    for name, model in (("cuda", gpu), ("cpu", cpu)):
        state = create_train_state(model, create_vision_optimizer(args, 1))
        n1 = (fa.flash_attention_lse.launches, fa.flash_bwd_dkv.launches,
              fa.flash_bwd_dq.launches)
        dev = model.device
        _, m = make_vision_train_step(model, args, 1000)(
            state, {"images": x.to(dev), "labels": labels.to(dev)}, 0)
        out[name] = (float(m["loss"]), float(m["grad_norm"]))
        if name == "cuda":
            L = cfg.num_layers
            require((fa.flash_attention_lse.launches - n1[0], fa.flash_bwd_dkv.launches - n1[1],
                     fa.flash_bwd_dq.launches - n1[2]) == (2 * L, L, L),
                    "vision_parity: K2'/K5a/K5b launches of the train step")
    (lgpu, ngpu), (lcpu, ncpu) = out["cuda"], out["cpu"]
    report = (f"loss card {lgpu:.5f} cpu {lcpu:.5f}; grad norm card {ngpu:.5f} cpu "
              f"{ncpu:.5f}")
    require(abs(lgpu - lcpu) <= PARITY_LOSS_ATOL and abs(ngpu - ncpu) <= PARITY_NORM_RTOL * ncpu,
            "vision_parity vit2d train step: " + report)
    report += "; " + leaf_report("gradients", leaf_errors(gpu, cpu, leaf_grad),
                                 PARITY_LEAF_GRAD_RTOL)
    report += "; " + leaf_report(
        "change in the step", leaf_errors(gpu, cpu, lambda n, p: p.detach().cpu() - start[n]),
        PARITY_LEAF_CHANGE_RTOL)
    log(f"vision_parity vit2d (medium width, 2 layers, B=2, card vs CPU): features max |err| "
        f"{err_f:.3e} (atol {VISION_FEAT_TOL['atol']} + rtol {VISION_FEAT_TOL['rtol']}), "
        f"logits {err_l:.3e} (atol {VISION_LOGIT_TOL['atol']} + rtol "
        f"{VISION_LOGIT_TOL['rtol']}); one train step: {report}")
    del gpu, cpu
    torch.cuda.empty_cache()

    cfg = vit3d_xsmall(dropout=0.0)
    gpu, cpu = pair(VideoTransformer, cfg, 9)
    th, tw = cfg.target_size
    x = torch.randn((1, 3, cfg.max_frames, th, tw), generator=g)
    fm = torch.ones((1, cfg.max_frames), dtype=torch.bool)
    fm[:, -6:] = False
    n0 = [fn.launches for fn in (fa.flash_attention, fa.flash_attention_lse)]
    with torch.no_grad():
        fgpu = gpu(x.cuda(), frame_mask=fm.cuda()).float().cpu()
        fcpu = cpu(x, frame_mask=fm).float()
    require([fa.flash_attention.launches, fa.flash_attention_lse.launches] == n0,
            "vision_parity: a flash kernel ran in the ViT-3D forward")
    err3 = expect_close("vision_parity vit3d features", fgpu, fcpu, **VISION_FEAT_TOL)
    log(f"vision_parity vit3d_xsmall (full config, B=1, frames 26-31 padded, card vs CPU): "
        f"features max |err| {err3:.3e} (atol {VISION_FEAT_TOL['atol']} + rtol "
        f"{VISION_FEAT_TOL['rtol']}); mean |err| {float((fgpu - fcpu).abs().mean()):.3e}")
    del gpu, cpu
    torch.cuda.empty_cache()


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
    and eagerly, in turns (graph, eager, graph; equal tokens), each profiled
    once; the
    ``ImageGenerationPipeline`` on the 64 x 64 grid (4096 steps, graphs);
    ``ImageGenTrainer`` steps at 256 px, B=2 (remat, dropout 0.2) and an
    ``evaluate``; the image-gen script for a few steps.  Exact launch gates:
    K3's table mode (dense or paged) and K1 once a layer a decode forward,
    K2' 2L, K5a L and K5b L a train step (each block's forward and its
    recompute), K2 L an evaluation, nothing else."""
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
    n_params = sum(p.numel() for p in model.parameters())
    b, gh = IMG_GEN_B, IMG_GEN_GRID
    n = gh * gh
    text = torch.randn((b, IMG_TEXT_T, cfg.d_model), generator=gen, device="cuda").to(
        torch.bfloat16)
    sampler = ImageGenerationSampler(temperature=0.9, top_k=64)
    log(f"image_gen: image_gen_xsmall d{cfg.d_model}/{L}L {cfg.num_heads}H/"
        f"{cfg.query_groups}G hd {cfg.head_dim}, {n_params / 1e6:.1f}M params (fp32, "
        f"bf16 compute), B={b}, {gh}x{gh} grid, {IMG_TEXT_T} text tokens")
    result, main_counts = {}, {}
    for paged in (False, True):
        tag = "generate_image_tokens_paged" if paged else "generate_image_tokens"
        want = dict(none)
        if paged:
            want.update({paged_t: L * n, paged_p: L * n, k1: L * n})
        else:
            want.update({dense_t: L * n, dense_p: L * n})

        def drive(use_graph):
            _zero(fns)
            t0 = time.perf_counter()
            tokens, graph = _generate_image_tokens(
                model, text, None, torch.Generator(device="cuda").manual_seed(5),
                grid_h=gh, grid_w=gh, sampler=sampler, start_token_id=0, paged=paged,
                page_size=128, use_graph=use_graph)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = _image_gate(f"{tag} {'graph' if use_graph else 'eager'}", fns, want)
            nums = dict(wall_s=wall, tokens_per_s=b * n / wall,
                        capture_s=graph.capture_s if graph else 0.0)
            return nums, (tokens, got)

        runs = in_turns(f"image_gen: {tag}", [("graph", lambda: drive(True)),
                                              ("eager", lambda: drive(False))],
                        order=(0, 1, 0))
        toks = [res[0] for name in runs for _, res in runs[name]]
        require(all(torch.equal(t_, toks[0]) for t_ in toks),
                f"image_gen: {tag}: graph and eager runs drew different tokens")
        require(tuple(toks[0].shape) == (b, gh, gh) and 0 <= int(toks[0].min())
                and int(toks[0].max()) < cfg.num_embeddings, f"image_gen: {tag} tokens")
        busy = {m: profile_breakdown(f"image_gen {tag} ({m})", lambda: drive(m == "graph"),
                                     top=6, also=("prologue", "paged_decode"))
                for m in ("graph", "eager")}
        rates = {m: [nums["tokens_per_s"] for nums, _ in runs[m]] for m in runs}
        walls = {m: [nums["wall_s"] for nums, _ in runs[m]] for m in runs}
        peak = max(nums["peak_mem_gb"] for m in runs for nums, _ in runs[m])
        log(f"image_gen: {tag} B={b} {gh}x{gh}: tokens/s graph {rates['graph']} eager "
            f"{rates['eager']}; launches {json.dumps(runs['graph'][0][1][1])}; device_busy_s "
            f"graph {_fmt(busy['graph'], 4)} eager {_fmt(busy['eager'], 4)}; idle share "
            + " ".join(f"{m} {1 - busy[m] / min(walls[m]):.3f}" if busy[m] else
                       f"{m} not measured" for m in ("graph", "eager"))
            + f" (busy over the fastest unprofiled run's wall); peak_mem_gb={peak:.3f}")
        result[tag] = rates
        # the kernels line's launches: the first graph run of each path
        main_counts.update({k_: v for k_, v in runs["graph"][0][1][1].items() if v})
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    images, tokens = pipe.generate_images(ids, torch.Generator(device="cuda").manual_seed(6),
                                          grid_h=g64, grid_w=g64, sampler=sampler)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    got = _image_gate("pipeline 64x64", fns, want)
    require(tuple(images.shape) == (1, 3, 4 * g64, 4 * g64) and bool(torch.isfinite(images).all())
            and 0 <= float(images.min()) and float(images.max()) <= 1,
            "image_gen: pipeline images")
    require(tuple(tokens.shape) == (1, g64, g64), "image_gen: pipeline tokens")
    # the idle share from a profiled run of the same pipeline on 8 rows of
    # the 64-wide grid (512 steps: a full 4096-step profile is millions of
    # events)
    busy8 = profile_breakdown(
        "image_gen pipeline on an 8x64 grid (graphs)",
        lambda: pipe.generate_images(ids, torch.Generator(device="cuda").manual_seed(6),
                                     grid_h=8, grid_w=g64, sampler=sampler), top=6,
        also=("prologue",))
    wall8 = cuda_ms(lambda: pipe.generate_images(
        ids, torch.Generator(device="cuda").manual_seed(6), grid_h=8, grid_w=g64,
        sampler=sampler), iters=1, warmup=0) / 1e3
    log(f"image_gen: pipeline 64x64 (B=1, 4096 steps, graphs): wall_s={wall:.3f} "
        f"tokens_per_s={g64 * g64 / wall:.1f} capture_s={pipe.last_graph.capture_s:.3f} "
        f"peak_mem_gb={peak:.3f} launches {json.dumps(got)}; images {tuple(images.shape)} in "
        f"[0, 1]; 8x64 grid: wall_s={wall8:.3f} device_busy_s={_fmt(busy8, 4)} idle share "
        + (f"{1 - busy8 / wall8:.3f}" if busy8 else "not measured"))
    result["pipeline_tokens_per_s"] = g64 * g64 / wall
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
    first = trainer.train_step(batch())  # the warm-up step and the capture
    _image_gate("first train step", fns, step_want)
    graph = trainer.graphs[next(iter(trainer.graphs))]
    tally_gate("image_gen train graph", graph, step_want, "image_gen")
    del graph  # train_turns captures again
    batches = [batch() for _ in range(IMG_TRAIN_STEPS)]
    last = {}

    def run(k):
        ms = last["metrics"] = [trainer.train_step(bt) for bt in batches[:k]]
        return [m[key] for m in ms for key in sorted(m)]

    nums, got = train_turns(
        "image_gen: trainer", [trainer.graphs],
        state_tensors(trainer.state, list(trainer.model.buffers())), run, fns, step_want,
        IMG_TRAIN_STEPS, IMG_TRAIN_B,
        host=(trainer._seeds.get_state, trainer._seeds.set_state), exact=cudnn_deterministic)
    metrics = last["metrics"]
    busy = {}
    for path, use_graph in (("graph", True), ("eager", False)):
        trainer.graphs.use_graph = use_graph
        busy[path] = profile_breakdown(f"image_gen train step [{path}]",
                                       lambda: trainer.train_step(batches[0]), top=8,
                                       also=("flash",))
    trainer.graphs.use_graph = True
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
    report_turns(f"image_gen: trainer image_gen_xsmall 256px B={IMG_TRAIN_B} (remat, "
                 f"dropout 0.2)", nums, busy, "images_per_s", trainer.graphs.capture_s)
    log(f"image_gen: trainer launches over a graph turn {json.dumps(got)}; loss first "
        f"{first['loss']:.4f} then " + ", ".join(f"{m['loss']:.4f}" for m in metrics)
        + f"; evaluate {json.dumps(ev)} (from its graph, equal to eager; K2 {L} a replay)")
    result["train_ms_per_step"] = nums["graph"]["ms"]
    result["train_ms_per_step_eager"] = nums["eager"]["ms"]
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
    log(f"image_gen: script --size xsmall --steps {steps} --batch-size {IMG_TRAIN_B}: step "
        f"walls " + ", ".join(f"{s:.3f}" for s in out["step_s"]) + f" s; launches "
        f"{json.dumps(got)}")
    del out
    torch.cuda.empty_cache()
    log("image_gen: " + json.dumps(result))
    return main_counts


# Card against CPU at image_gen_xsmall's width, 2 layers.  bf16 on both
# sides, as in the LM's parity (LOGIT_ATOL, the near-tie rule of
# _compare_greedy).  The trainer step runs at 64 px (a 16 x 16 latent grid:
# T = 256, still the card's flash path) to keep the CPU's side short.
IMG_PARITY_GRID, IMG_PARITY_FORCED = 16, 32
IMG_PARITY_BN = dict(atol=1e-4, rtol=0.02)
IMG_QUANT_TIE = 1e-5  # an argmin flip's distance gap, relative to |z|^2
# biases of the convolutions in front of a BatchNorm: zero gradient in exact
# arithmetic (the BatchNorm takes the mean out)
IMG_NOISE_LEAVES = tuple(f"encoder.convs.{i}.bias" for i in range(3)) + tuple(
    f"decoder.deconvs.{i}.bias" for i in range(2))


def _forced_logits(model, text, tokens, paged, steps):
    """Logits of ``steps`` cached decode forwards fed the start token, then
    ``tokens`` (raster order), one a step: [B, steps, V] fp32 on the CPU."""
    import torch

    b = text.shape[0]
    n = tokens.shape[1] * tokens.shape[2]
    cache = (model.init_paged_cache(b, n + 1) if paged else model.init_cache(b, n))
    kw = {"paged_cache" if paged else "cache": cache}
    seq = torch.cat([torch.zeros((b, 1), dtype=torch.int32), tokens.reshape(b, -1).cpu()], 1)
    seq = seq.to(model.device)
    out = []
    with torch.no_grad():
        for i in range(steps):
            lg, _ = model(seq[:, i:i + 1], text, grid_w=tokens.shape[2], return_logits=True,
                          **kw)
            out.append(lg[:, 0].float().cpu())
    return torch.stack(out, 1)


def run_image_gen_parity():
    """image_gen_xsmall at 2 layers, card against CPU from the same weights:
    greedy ``generate_image_tokens`` and ``_paged`` tokens (16 x 16, B=2)
    and the logits of 32 teacher-forced cached decode steps on both paths;
    one ``ImageGenTrainer`` step at 64 px, B=2, fp32: loss, the quantizer's
    indices (a flip only at a near tie), per-leaf gradients and change in the
    step (``leaf_errors``), and the BatchNorm statistics."""
    import torch

    from vats_tpu_torch.configs import image_gen_xsmall
    from vats_tpu_torch.inference import generate_image_tokens, generate_image_tokens_paged
    from vats_tpu_torch.models import AutoregressiveImageTransformer
    from vats_tpu_torch.ops import cache_append as ca
    from vats_tpu_torch.train import ImageGenTrainer, ImageGenTrainingArgs

    cfg = image_gen_xsmall(num_layers=2, dropout=0.0)
    gpu = AutoregressiveImageTransformer(cfg, device="cuda", seed=7).eval()
    cpu = AutoregressiveImageTransformer(cfg, device="meta")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, assign=True)
    g = torch.Generator().manual_seed(41)
    text = torch.randn((2, IMG_TEXT_T, cfg.d_model), generator=g).to(torch.bfloat16)
    gh = IMG_PARITY_GRID
    kw = dict(grid_h=gh, grid_w=gh, temperature=0.0, do_sample=False)
    report = []
    for paged, fn in ((False, generate_image_tokens), (True, generate_image_tokens_paged)):
        tag = "paged" if paged else "dense"
        counted = ca.paged_decode_prologue.table if paged else ca.dense_decode_prologue.table
        n0 = counted.launches
        tok_g = fn(gpu, text.cuda(), None, None, **kw).cpu()
        require(counted.launches - n0 == cfg.num_layers * gh * gh,
                f"image_gen_parity: {tag} table-mode launches")
        tok_c = fn(cpu, text, None, None, **kw)
        steps = IMG_PARITY_FORCED
        lg_g = _forced_logits(gpu, text.cuda(), tok_c, paged, steps)
        lg_c = _forced_logits(cpu, text, tok_c, paged, steps)
        err = expect_close(f"image_gen_parity {tag} logits", lg_g, lg_c, LOGIT_ATOL, 0.0)
        # tokens: equal up to the first step where the CPU's top two logits
        # (teacher-forced over the whole grid) lie within 2 * LOGIT_ATOL
        with torch.no_grad():
            seq = torch.cat([torch.zeros((2, 1), dtype=torch.int32),
                             tok_c.reshape(2, -1)[:, :-1]], 1)
            full, _ = cpu(seq, text, grid_w=gh, return_logits=True)
        top2 = full.topk(2, dim=-1).values
        gaps = top2[..., 0] - top2[..., 1]
        flat_g, flat_c = tok_g.reshape(2, -1), tok_c.reshape(2, -1)
        same = (flat_g == flat_c).all(0)
        first = int((~same).nonzero()[0]) if not bool(same.all()) else None
        if first is not None:
            require(bool((gaps[:, first] <= 2 * LOGIT_ATOL).any()),
                    f"image_gen_parity {tag}: tokens differ at step {first} beyond a near tie")
        report.append(f"{tag}: logits of {steps} forced steps max |err| {err:.3e} (atol "
                      f"{LOGIT_ATOL}); greedy tokens equal "
                      + ("over all 256 steps" if first is None else
                         f"up to step {first}, a near tie (CPU top-2 gap "
                         f"{float(gaps[:, first].min()):.3e})"))
    log("image_gen_parity (image_gen_xsmall width, 2 layers, B=2, 16x16, card vs CPU): "
        + "; ".join(report))
    del gpu, cpu
    torch.cuda.empty_cache()

    # fp32 compute: at initialisation the codebook rows (uniform in +-1/256)
    # lie within bf16 noise of one another seen from a latent of norm ~25,
    # so a bf16 step's argmin would flip at hundreds of positions between
    # two devices and take the gradients with it
    tcfg = image_gen_xsmall(num_layers=2, dropout=0.0, target_size=64, dtype="float32")
    targs = ImageGenTrainingArgs(seed=3)
    tg = ImageGenTrainer(tcfg, targs, num_training_steps=10, device="cuda")
    # eager on the card: the quantizer hooks below read the step's tensors on
    # the host, which no capture allows (the image_gen phase holds the
    # trainer's graph to its eager step bit for bit)
    tg.graphs.use_graph = False
    tc = ImageGenTrainer(tcfg, targs, num_training_steps=10,
                         variables={k: v.cpu() for k, v in tg.model.state_dict().items()},
                         device="cpu")
    start = {n: p.detach().clone() for n, p in tc.model.named_parameters()}
    batch = {"images": torch.rand((2, 3, 64, 64), generator=g),
             "text_embeddings": torch.randn((2, IMG_TEXT_T, tcfg.d_model),
                                            generator=g).to(torch.bfloat16)}
    from vats_tpu_torch.ops import flash_attention as fa

    seen = {}  # the quantizer's input and indices on each side

    def keep_quantizer(side):
        def hook(mod, args, out):
            seen[side] = (args[0].detach().float().cpu(), out[2].cpu())
        return hook

    hooks = [tg.model.quantizer.register_forward_hook(keep_quantizer("cuda")),
             tc.model.quantizer.register_forward_hook(keep_quantizer("cpu"))]
    n1 = (fa.flash_attention_lse.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
    mg = tg.train_step({k: v.cuda() for k, v in batch.items()})
    L = tcfg.num_layers
    require((fa.flash_attention_lse.launches - n1[0], fa.flash_bwd_dkv.launches - n1[1],
             fa.flash_bwd_dq.launches - n1[2]) == (2 * L, L, L),
            "image_gen_parity: K2'/K5a/K5b launches of the train step")
    mc = tc.train_step(batch)
    for h in hooks:
        h.remove()
    # argmin flips between the devices: each must be a near tie of the CPU's
    # distances (within IMG_QUANT_TIE of |z|^2); any flip moves that
    # position's code and the gradients with it, so the leaf checks below
    # then stand excused, and the report says so
    (zg, ig), (zc, ic) = seen["cuda"], seen["cpu"]
    flips = (ig != ic).reshape(-1).nonzero()[:, 0]
    cb = tc.model.quantizer.embedding.detach().float()
    zf = zc.reshape(-1, zc.shape[-1])
    for pos in flips.tolist():
        d2 = ((zf[pos][None, :] - cb[[int(ig.reshape(-1)[pos]), int(ic.reshape(-1)[pos])]])
              ** 2).sum(-1)
        require(float(d2[0] - d2[1]) <= IMG_QUANT_TIE * float((zf[pos] ** 2).sum()),
                f"image_gen_parity: quantizer index {pos} flips beyond a near tie")
    losses = f"loss card {mg['loss']:.5f} cpu {mc['loss']:.5f} (" + ", ".join(
        f"{k} {mg[k]:.5f}/{mc[k]:.5f}" for k in ("vq_loss", "recon_loss", "token_ce")) + ")"
    require(abs(mg["loss"] - mc["loss"]) <= PARITY_LOSS_ATOL, "image_gen_parity: " + losses)
    keep = lambda errs: {n: e for n, e in errs.items() if n not in IMG_NOISE_LEAVES}  # noqa: E731
    grads = leaf_errors(tg.model, tc.model, leaf_grad)
    change = leaf_errors(tg.model, tc.model, lambda n, p: p.detach().cpu() - start[n])
    if len(flips):
        rep = (f"{len(flips)} quantizer indices flipped at near ties (excused; gradients "
               f"worst {max(keep(grads).values()):.3e}, change worst "
               f"{max(keep(change).values()):.3e}, not held)")
    else:
        rep = "no quantizer index flipped; " + leaf_report(
            "gradients", keep(grads), PARITY_LEAF_GRAD_RTOL)
        rep += "; " + leaf_report("change in the step", keep(change), PARITY_LEAF_CHANGE_RTOL)
    # the zero-gradient biases: tiny on both sides against their convolution's weights
    params = dict(tc.model.named_parameters())
    pg = dict(tg.model.named_parameters())
    for name in IMG_NOISE_LEAVES:
        w = name.replace(".bias", ".weight")
        for side in (params, pg):
            gb, gw = side[name].grad, side[w].grad
            require(float(gb.norm()) <= 1e-2 * float(gw.norm()),
                    f"image_gen_parity: {name}'s gradient is not noise")
    bn = [n for n in tc.model.state_dict() if "running_" in n]
    sg, sc = tg.model.state_dict(), tc.model.state_dict()
    err_bn = max(expect_close(f"image_gen_parity {n}", sg[n].cpu(), sc[n], **IMG_PARITY_BN)
                 for n in bn)
    log(f"image_gen_parity trainer (xsmall width, 2 layers, 64 px, B=2, fp32, one step, card "
        f"vs CPU): {losses}; {rep}; the {len(IMG_NOISE_LEAVES)} conv biases in front of a "
        f"BatchNorm (zero gradient in exact arithmetic) left out of those and held to 1e-2 of "
        f"their weights' gradient norm on both sides; {len(bn)} BatchNorm statistics max |err| "
        f"{err_bn:.3e} (atol {IMG_PARITY_BN['atol']} + rtol {IMG_PARITY_BN['rtol']})")
    del tg, tc
    torch.cuda.empty_cache()


# --- video generation and the fused multimodal stream: kernel checks ----------

# video_gen_large's temporal cache (B=1 over a 16 x 16 latent grid: B*HW =
# 256 rows; 4 KV groups of head dim 144, which K3 covers with three pairs a
# lane; 30 frames / pt 2 = 15 slots; 20 layers).
VID_L, VID_ROWS, VID_G, VID_HD, VID_S = 20, 256, 4, 144, 15
# multimodal_small's attention (8 query heads over 4 groups of head dim 96,
# 12 layers) at the JAX bench's B=4, t_text=64: 64 + 256 + 2048 = 2368 slots.
MM_HQ, MM_G, MM_HD, MM_L, MM_B, MM_T_TEXT = 8, 4, 96, 12, 4, 64
MM_SLOTS = MM_T_TEXT + 256 + 2048
MM_RAGGED = (256, 200, 131, 17)  # prompt lengths of the K2 prefill (t_text 256)
# the multimodal phase's depth: multimodal_small's 12 layers cut to 2 with K6,
# to keep the whole script under 900 s (its eager loop of 2303 decode
# forwards is host-bound: its time goes with the depth)
MM_GEN_LAYERS = 2


def check_k3_video(gen):
    """K3's append mode at both video caches the video phase writes:
    video_gen_large's (head dim 144) and video_gen_xsmall's at the JAX
    bench's B=2 (head dim 18, stored as 24), each bit-equal to
    ``append_token_ref`` at the first, a middle and the last slot and
    clamped; timed at the large shape beside the plain version, two
    ``scatter_`` and the bound."""
    import torch

    from vats_tpu_torch.configs import video_gen_xsmall
    from vats_tpu_torch.ops.cache_append import append_token_inplace, append_token_ref

    xs = video_gen_xsmall()
    xs_shape = (xs.num_layers, VID_BENCH_B * xs.latent_height * xs.latent_width,
                xs.query_groups, -(-xs.head_dim // 8) * 8, xs.max_frames // xs.patch_size[0])
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
    n0 = append_token_inplace.launches
    for shape in (xs_shape, (VID_L, VID_ROWS, VID_G, VID_HD, VID_S)):
        n_l, rows, g, d, n_s = shape
        layer = min(5, n_l - 1)
        k, v = mk(*shape), mk(*shape)
        kn, vn = mk(rows, g, d), mk(rows, g, d)
        for pos in (0, n_s // 2, n_s - 1, n_s + 3):
            length = torch.tensor(pos, dtype=torch.int32, device="cuda")
            ka, va, kb, vb = k.clone(), v.clone(), k.clone(), v.clone()
            append_token_inplace(ka, va, layer, kn, vn, length)
            append_token_ref(kb, vb, layer, kn, vn, length)
            torch.cuda.synchronize()
            require(torch.equal(ka, kb) and torch.equal(va, vb),
                    f"K3 append at the video cache {shape} differs from the plain version "
                    f"at {pos}")
    require(append_token_inplace.launches == n0 + 8, "K3 append (video shapes) did not launch")
    length = torch.tensor(7, dtype=torch.int32, device="cuda")
    ms, call_ms = timed(lambda: append_token_inplace(ka, va, 5, kn, vn, length))
    plain_ms, _ = timed(lambda: append_token_ref(kb, vb, 5, kn, vn, length))
    b_ms, by = bound(2 * kn.numel() * 2 * 2 + 4, 0)  # new K/V read, the same written
    idx = torch.full((VID_ROWS, VID_G, VID_HD, 1), 7, dtype=torch.int64, device="cuda")
    kc, vc = k.clone(), v.clone()

    def scatter():
        kc[5].scatter_(-1, idx, kn[..., None])
        vc[5].scatter_(-1, idx, vn[..., None])

    library_ms, _ = timed(scatter)
    log(f"K3 append at the video caches {list(xs_shape)} (xsmall, B=2) and [{VID_L},"
        f"{VID_ROWS},{VID_G},{VID_HD},{VID_S}] (large): bit-equal at the first, middle and last "
        f"slot and clamped; at the large shape kernel_ms={ms:.5f} plain_ms="
        f"{plain_ms:.4f} library_ms={library_ms:.4f} (two scatter_) bound_ms={b_ms:.6f} "
        f"({by}); per call with host overhead {call_ms:.4f}")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                library_ms=library_ms)


def _mm_table(cfg, b, dev="cuda"):
    """A (cos, sin) table [b, 1, hd/2] whose rows are text, image, video,
    video tokens (``multimodal_rope_angles`` on the card)."""
    import torch

    from vats_tpu_torch.models.multimodal import multimodal_rope_angles

    mod = torch.tensor([0, 1, 2, 2] * (b // 4 + 1), dtype=torch.int32, device=dev)[:b, None]
    loc = torch.tensor([63, 200, 1500, 2047] * (b // 4 + 1), dtype=torch.int32,
                       device=dev)[:b, None]
    return multimodal_rope_angles(cfg, mod, loc)


def check_k3_multimodal_table(gen):
    """K3's table mode at multimodal_small's heads (8 / 4 of 96), dense and
    paged, bf16 and fp32, with and without the QK-norm, B=4, each row its
    own modality's rotation from ``multimodal_rope_angles``: within
    PROLOGUE_ULPS of the plain chain given the same table, v and the cache
    outside the written column exact; timed at B=4 in bf16 beside the chain
    and the bound (the table one row a batch row in both modes)."""
    import torch

    from vats_tpu_torch.configs import multimodal_small
    from vats_tpu_torch.ops import cache_append as ca

    cfg = multimodal_small()
    hq, g, hd, b, S = MM_HQ, MM_G, MM_HD, MM_B, MM_SLOTS
    cs = _mm_table(cfg, b)
    worst = 0.0
    n0 = (ca.dense_decode_prologue.table.launches, ca.paged_decode_prologue.table.launches)
    calls = [0, 0]

    def inputs(dtype):
        row = torch.randn((b, 1, (hq + 2 * g) * hd), generator=gen, device="cuda").to(dtype)
        q, k, v = torch.split(row, [hq * hd, g * hd, g * hd], dim=-1)
        return q.reshape(b, 1, hq, hd), k.reshape(b, 1, g, hd), v.reshape(b, 1, g, hd)

    for dtype in (torch.bfloat16, torch.float32):
        cache = torch.randn((2, 2, b, g, hd, S), generator=gen, device="cuda").to(dtype)
        for mode, qk_norm, pos in (("dense", True, 64), ("dense", False, S + 3),
                                   ("paged", True, 0), ("paged", False, 2367)):
            q, k, v = inputs(dtype)
            kw = dict(theta=10000.0, qk_norm=qk_norm, cos_sin=cs)
            tol = PROLOGUE_ULPS[(str(dtype).split(".")[1], qk_norm)]
            if mode == "paged":
                lens = torch.randint(0, S, (b,), generator=gen, device="cuda")
                lens[0] = pos
                lens = lens.to(torch.int32)
                got = ca.paged_decode_prologue(q, k, v, lens, None, **kw)
                want = ca.paged_decode_prologue_ref(q, k, v, lens, **kw)
                calls[1] += 1
                pairs = list(zip(got[:2], want[:2]))
                require(torch.equal(got[2], want[2]), "K3 multimodal table paged: v differs")
            else:
                ka, va, kb, vb = (cache[i % 2].clone() for i in range(4))
                length = torch.tensor(pos, dtype=torch.int32, device="cuda")
                got = ca.dense_decode_prologue(q, k, v, ka, va, length, 1, None, ring=False,
                                               **kw)
                want = ca.dense_decode_prologue_ref(q, k, v, kb, vb, length, 1, ring=False,
                                                    **kw)
                calls[0] += 1
                col = min(pos, S - 1)
                rest = torch.ones(S, dtype=torch.bool, device="cuda")
                rest[col] = False
                require(torch.equal(va, vb) and torch.equal(ka[..., rest], kb[..., rest])
                        and torch.equal(ka[0], kb[0]),
                        "K3 multimodal table dense: the cache differs outside the k column")
                pairs = [(got, want), (ka[1, ..., col], kb[1, ..., col])]
            torch.cuda.synchronize()
            for x, y in pairs:
                ulps = float(rotated_ulps(x, y).max())
                require(ulps <= tol and bool(torch.isfinite(x.float()).all()),
                        f"K3 multimodal table {mode} {dtype}: {ulps:.2f} ulps beyond {tol}")
                worst = max(worst, float((x.float() - y.float()).abs().max()))
    require((ca.dense_decode_prologue.table.launches - n0[0],
             ca.paged_decode_prologue.table.launches - n0[1]) == tuple(calls),
            "K3 multimodal table: a wrapper did not launch its kernel in table mode")
    q, k, v = inputs(torch.bfloat16)
    kc = torch.zeros((MM_L, b, g, hd, S), dtype=torch.bfloat16, device="cuda")
    vc = torch.zeros_like(kc)
    length = torch.tensor(1000, dtype=torch.int32, device="cuda")
    lens = torch.randint(MM_T_TEXT, S, (b,), generator=gen, device="cuda").to(torch.int32)
    kw = dict(theta=1e4, qk_norm=True, cos_sin=cs)
    for key, kern, plain in (
            ("dense", lambda: ca.dense_decode_prologue(q, k, v, kc, vc, length, 5, None,
                                                       ring=False, **kw),
             lambda: ca.dense_decode_prologue_ref(q, k, v, kc, vc, length, 5, ring=False, **kw)),
            ("paged", lambda: ca.paged_decode_prologue(q, k, v, lens, None, **kw),
             lambda: ca.paged_decode_prologue_ref(q, k, v, lens, **kw))):
        ms, call_ms = timed(kern)
        plain_ms, _ = timed(plain)
        nbytes, ops = _table_cost(b, hq, g, hd, key == "paged", table_rows=b)
        b_ms, by = bound(nbytes, ops, PEAK_FP32_FLOPS)
        log(f"K3 table {key} at the multimodal decode (Hq 8, G 4, hd 96, B={b}, rows text/"
            f"image/video/video) bf16: kernel_ms={ms:.5f} plain_ms={plain_ms:.4f} (the chain "
            f"given the table) bound_ms={b_ms:.7f} ({by}: {nbytes} bytes, {ops} fp32 ops); "
            f"per call with host overhead {call_ms:.4f}")
    log(f"K3 multimodal table (bf16, fp32; dense, paged; QK-norm on and off): within "
        f"PROLOGUE_ULPS of the chain given the table, largest |err| {worst:.3e}; v and the "
        f"rest of the cache exact")


def check_k1_multimodal(gen):
    """K1 at the multimodal decode: head dim 96, 2 query heads a group, 4
    groups, bf16 pool of 128-token pages, B=4 at ragged lengths up to 2367
    (t_text 64 + 2303 decode steps; 19 pages a row): output within the bf16
    tolerance, the committed pool bit-equal; timed beside the plain version
    and the bound.  The kernels line keeps the LM's row."""
    import torch

    from vats_tpu_torch.ops.decode_attention import (
        PagedKVCache,
        paged_decode_attention_commit,
        paged_decode_attention_ref,
    )

    g, n, hd, ps, b = MM_G, MM_HQ // MM_G, MM_HD, 128, MM_B
    pps = -(-MM_SLOTS // ps)
    pool = torch.randn((MM_L, b * pps, 2, g, ps, hd), generator=gen,
                       device="cuda").to(torch.bfloat16)
    table = torch.randperm(b * pps, generator=gen, device="cuda").to(torch.int32)
    table = table.reshape(b, pps)
    lens = torch.tensor((2367, 2303, 1200, 65), dtype=torch.int32, device="cuda")
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
    q, kc, vc = mk(b, g * n, hd), mk(b, g, hd), mk(b, g, hd)
    kw = dict(scale=hd**-0.5, k_cur=kc, v_cur=vc)
    pk, pp = pool.clone(), pool.clone()
    del pool
    n0 = paged_decode_attention_commit.launches
    out = paged_decode_attention_commit(q, pk, 3, table, lens, **kw)
    ref = paged_decode_attention_ref(q, pp[3], table, lens, **kw)
    PagedKVCache(pp, table, lens).append_token(3, kc, vc)
    torch.cuda.synchronize()
    require(paged_decode_attention_commit.launches == n0 + 1, "K1 (hd 96) did not launch")
    err = expect_close("K1 hd 96 N=2", out, ref, BF16_ATOL, BF16_RTOL)
    require(torch.equal(pk, pp), "K1 hd 96 N=2: committed pool differs")
    kern = lambda: paged_decode_attention_commit(q, pk, 3, table, lens, **kw)  # noqa: E731
    ms, call_ms = timed(kern)
    plain_ms, _ = timed(lambda: paged_decode_attention_ref(q, pp[3], table, lens, **kw))
    alone = kernel_alone_ms(kern, "paged_decode")
    tokens = int(lens.sum())
    nbytes = (2 * b * g * n * hd * 2 + 2 * b * g * hd * 2 + tokens * 2 * g * hd * 2
              + b * 2 * g * hd * 2 + b * pps * 4 + b * 4)
    b_ms, by = bound(nbytes, 4 * g * n * hd * (tokens + b))
    log(f"K1 paged decode+commit at the multimodal decode B={b} lengths 2367/2303/1200/65 "
        f"(Hq 8, G 4, hd 96, N=2): max_abs_err={err:.3e} pool bit-equal; kernel_ms={ms:.4f} "
        f"(kernel alone {_fmt(alone)}) plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({by}); "
        f"per call with host overhead {call_ms:.4f}")
    del pk, pp
    torch.cuda.empty_cache()


def check_k2_multimodal(gen):
    """K2 at the multimodal prefill: B=4, T=S=256 (t_text 256), 8 / 4 heads
    of 96 padded to 128 in the wrapper, causal, the ragged key validity of
    prompts 256/200/131/17: within the bf16 tolerance plus the p flip
    allowance of the plain version; timed in turns with SDPA (causal, head
    dim 96, no key mask), with the bound on the attended pairs of this
    input.  The kernels line keeps the LM's row."""
    import torch

    from vats_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref

    b, t, hq, g, hd = MM_B, 256, MM_HQ, MM_G, MM_HD
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
    q, k, v = mk(b, t, hq, hd), mk(b, t, g, hd), mk(b, t, g, hd)
    lens = torch.tensor(MM_RAGGED, device="cuda")
    valid = torch.arange(t, device="cuda")[None, :] < lens[:, None]
    kw = dict(scale=hd**-0.5, causal=True, kv_valid=valid)
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    require(flash_attention.launches == n0 + 1, "K2 (hd 96) did not launch")
    err = expect_close("K2 hd 96 ragged", got, want, BF16_ATOL, BF16_RTOL,
                       p_flip_allowance(q, k, v, **kw))
    # attended pairs: query i over keys j <= i with j < the row's length
    pairs = int(sum(torch.clamp(torch.arange(1, t + 1), max=int(n_)).sum() for n_ in MM_RAGGED))
    flops = 4 * hq * hd * pairs
    b_ms, by = bound((q.numel() * 2 + k.numel() + v.numel()) * 2, flops)
    plain_ms, _ = timed(lambda: flash_attention_ref(q, k, v, **kw))
    ms, lib_ms, alone = flash_vs_sdpa("K2 multimodal prefill B=4 T=256 hd 96->128",
                                      lambda: flash_attention(q, k, v, **kw), q, k, v,
                                      hd**-0.5, b_ms, flops)
    log(f"K2 at the multimodal prefill (B={b}, T=S={t}, Hq 8, G 4, hd 96 -> 128, causal, "
        f"prompts {MM_RAGGED}): max_abs_err={err:.3e}; kernel_ms={ms:.4f} (forward kernel "
        f"alone {_fmt(alone)}) plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (SDPA causal, "
        f"hd 96) bound_ms={b_ms:.5f} ({by}, {pairs} attended pairs)")


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


def video_step_census(model, label, b, n=4, top=8):
    """Kernels and device ms of one inner decode step of
    ``generate_video_tokens`` (a read-mode forward of the whole frame and
    the sampling of one token), from ``n`` eager steps under torch.profiler;
    returns (kernels a step, device ms a step) or (None, None)."""
    import torch

    from vats_tpu_torch.inference import VideoGenerationSampler

    cfg = model.cfg
    hw = cfg.latent_height * cfg.latent_width
    cache = model.init_cache(b)
    text = torch.zeros((b, VID_TEXT_T, cfg.d_model), dtype=torch.bfloat16, device="cuda")
    inp = torch.zeros((b, 1, cfg.latent_height, cfg.latent_width), dtype=torch.int32,
                      device="cuda")
    valid = torch.ones((b, hw), dtype=torch.bool, device="cuda")
    sampler = VideoGenerationSampler(temperature=0.9, top_k=64)
    g = torch.Generator(device="cuda").manual_seed(0)

    def steps():
        with torch.no_grad():
            for _ in range(n):
                lg, _ = model(inp, text, None, cache=cache, spatial_valid=valid,
                              cache_mode="read", return_logits=True)
                sampler(g, lg[:, 0, 0])

    steps()
    torch.cuda.synchronize()
    per, _ = profiled(steps)
    if not per:
        log(f"census {label}: not measured (the profiler recorded no device time)")
        return None, None
    count = sum(c for _, c in per.values()) / n
    busy = sum(us for us, _ in per.values()) / n / 1e3
    log(f"census {label} B={b}: {count:.1f} kernels a decode step ({count / cfg.num_layers:.1f} "
        f"a layer), {busy:.3f} device ms a step; heaviest:")
    for name, (us, c) in sorted(per.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {us / n / 1e3:9.3f} ms {c / n:8.1f}x  {name[:100]}")
    return count, busy


def run_video_gen(fns):
    """Text->video generation at video_gen_large's full width (the
    generation and the pipeline at VID_GEN_LAYERS of its 20 layers, the
    trainer at all 20):
    ``generate_video_tokens`` at B=1 over 2 latent frames (512 raster steps,
    each a 256-token full-frame forward) with the inner step replayed from a
    CUDA graph, in turns with the eager loop over the first frame (graph,
    eager, graph; equal tokens); the JAX bench's shape (video_gen_xsmall,
    B=2, 5 frames of 8 x 8) likewise; the ``VideoGenerationPipeline`` over 2
    latent frames; three ``VideoTokenTrainer`` steps at B=1 over 15 latent
    frames (remat, dropout 0.2) after a warm-up, and ``VQVAE3DTrainer``
    steps on a 30-frame 128 x 128 clip.  Exact gates: K3's append mode once
    a layer a cached forward (read steps and frame appends alike), nothing
    else.  Tokens/s, device ms and kernels a step (``video_step_census``),
    idle share (1 - census busy x steps / wall), peak memory."""
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
    result, main_counts = {}, {}

    def generation(tag, cfg, b, frames, eager_frames):
        model = AutoregressiveVideoTransformer(cfg, device="cuda", seed=0).eval()
        n_params = sum(p.numel() for p in model.parameters())
        L, hw = cfg.num_layers, cfg.latent_height * cfg.latent_width
        text = torch.randn((b, VID_TEXT_T, cfg.d_model), generator=gen, device="cuda").to(
            torch.bfloat16)
        log(f"video_gen: {tag} d{cfg.d_model}/{L}L {cfg.num_heads}H/{cfg.query_groups}G hd "
            f"{cfg.head_dim}, {n_params / 1e6:.1f}M params (fp32, bf16 compute), B={b}, "
            f"{cfg.latent_height}x{cfg.latent_width} grid, {frames} latent frames")

        def drive(use_graph):
            n_fr = frames if use_graph else eager_frames
            want = dict(none)
            want[append] = L * n_fr * (hw + 1)  # hw read steps and one append a frame
            _zero(fns)
            t0 = time.perf_counter()
            tokens, graph = _generate_video_tokens(
                model, text, None, torch.Generator(device="cuda").manual_seed(5),
                num_frames=n_fr, sampler=sampler, start_token_id=0, use_graph=use_graph)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = _video_gate(f"{tag} {'graph' if use_graph else 'eager'}", fns, want)
            return (dict(wall_s=wall, tokens_per_s=b * n_fr * hw / wall, steps=n_fr * hw,
                         capture_s=graph.capture_s if graph else 0.0), (tokens, got))

        runs = in_turns(f"video_gen: {tag}", [("graph", lambda: drive(True)),
                                              ("eager", lambda: drive(False))],
                        order=(0, 1, 0))
        toks = [res[0] for name in runs for _, res in runs[name]]
        require(all(torch.equal(x[:, :eager_frames], toks[0][:, :eager_frames])
                    for x in toks), f"video_gen: {tag}: graph and eager runs drew different tokens")
        require(tuple(toks[0].shape) == (b, frames, cfg.latent_height, cfg.latent_width)
                and 0 <= int(toks[0].min()) and int(toks[0].max()) < cfg.num_embeddings,
                f"video_gen: {tag} tokens")
        count, step_ms = video_step_census(model, tag, b)
        rates = {m: [nums["tokens_per_s"] for nums, _ in runs[m]] for m in runs}
        idle = {}
        for m in runs:
            nums = min((nums for nums, _ in runs[m]), key=lambda x: x["wall_s"])
            # the frames' append forwards cost about a read step each
            steps = nums["steps"] + nums["steps"] // hw
            busy = None if step_ms is None else step_ms / 1e3 * steps
            idle[m] = "not measured" if busy is None else f"{1 - busy / nums['wall_s']:.3f}"
        peak = max(nums["peak_mem_gb"] for m in runs for nums, _ in runs[m])
        log(f"video_gen: {tag}: tokens/s graph {rates['graph']} eager ({eager_frames} frame"
            f"{'s' if eager_frames > 1 else ''}) {rates['eager']}; launches "
            f"{json.dumps(runs['graph'][0][1][1])}; {_fmt(count, 1)} kernels and "
            f"{_fmt(step_ms, 3)} device ms a step; idle share graph {idle['graph']} eager "
            f"{idle['eager']} (census busy x steps over the fastest run's wall); "
            f"peak_mem_gb={peak:.3f}")
        result[tag] = dict(tokens_per_s=rates, idle=idle, kernels_a_step=count,
                           device_ms_a_step=step_ms, peak_mem_gb=peak)
        if not main_counts:  # the kernels line reads video_gen_large's first graph run
            main_counts.update(runs["graph"][0][1][1])
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    videos, tokens = pipe.generate_videos(ids, torch.Generator(device="cuda").manual_seed(6),
                                          num_frames=VID_FRAMES, sampler=sampler)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _video_gate("pipeline", fns, want)
    pt, ph, pw = cfg.patch_size
    require(tuple(videos.shape) == (1, 3, VID_FRAMES * pt, cfg.latent_height * ph,
                                    cfg.latent_width * pw)
            and bool(torch.isfinite(videos).all()) and 0 <= float(videos.min())
            and float(videos.max()) <= 1, f"video_gen: pipeline videos {tuple(videos.shape)}")
    log(f"video_gen: pipeline video_gen_large (B=1, {VID_FRAMES} latent frames, graphs): "
        f"wall_s={wall:.3f} tokens_per_s={VID_FRAMES * hw / wall:.1f} capture_s="
        f"{pipe.last_graph.capture_s:.3f} peak_mem_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} launches {json.dumps(got)}; videos "
        f"{tuple(videos.shape)} in [0, 1]")
    result["pipeline_tokens_per_s"] = VID_FRAMES * hw / wall
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
    first = trainer.train_step(batch())  # the warm-up step and the capture
    batches = [batch() for _ in range(VID_TRAIN_STEPS)]
    graph = trainer.graphs[next(iter(trainer.graphs))]
    tally_gate("token trainer graph", graph, none, "video_gen")
    del graph  # train_turns captures again

    def run(k):
        return [trainer.train_step(bt) for bt in batches[:k]]

    nums, got = train_turns(
        "video_gen: VideoTokenTrainer", [trainer.graphs],
        state_tensors(trainer.state, list(trainer.model.buffers())), run, fns, none,
        VID_TRAIN_STEPS, lat_t * hw, host=(trainer._seeds.get_state, trainer._seeds.set_state),
        exact=cudnn_deterministic)
    busy = {}
    for path, use_graph in (("graph", True), ("eager", False)):
        trainer.graphs.use_graph = use_graph
        busy[path] = profile_breakdown(f"video_gen token-trainer step [{path}]",
                                       lambda: trainer.train_step(batches[0]), top=8)
    trainer.graphs.use_graph = True
    report_turns(f"video_gen: VideoTokenTrainer video_gen_large B=1, {lat_t} latent frames "
                 f"({lat_t * hw} tokens; remat, dropout 0.2)", nums, busy, "tokens_per_s",
                 trainer.graphs.capture_s)
    log(f"video_gen: VideoTokenTrainer first loss {first:.4f}; launches over a graph turn "
        f"{json.dumps(got)}")
    result["token_train_ms_per_step"] = nums["graph"]["ms"]
    result["token_train_ms_per_step_eager"] = nums["eager"]["ms"]
    del trainer, batches
    torch.cuda.empty_cache()

    # the 3-D VQ-VAE trainer at large: a 30-frame 128 x 128 clip, B=1
    vq = VQVAE3DTrainer(tcfg, VideoGenTrainingArgs(), num_training_steps=100, device="cuda")
    px = tcfg.latent_height * ph
    clips = [torch.rand((1, 3, tcfg.max_frames, px, px), generator=gen, device="cuda")
             for _ in range(VQ_TRAIN_STEPS + 1)]
    _zero(fns)
    first = vq.train_step(clips[0])  # the warm-up step and the capture
    nums, got = train_turns(
        "video_gen: VQVAE3DTrainer", [vq.graphs],
        state_tensors(vq.state, list(vq.model.buffers())),
        lambda k: [vq.train_step(c) for c in clips[1:1 + k]], fns, none, VQ_TRAIN_STEPS, 1,
        host=(vq._seeds.get_state, vq._seeds.set_state), exact=cudnn_deterministic)
    log(f"video_gen: VQVAE3DTrainer video_gen_large (d{tcfg.d_model} 3x3x3 convolutions over "
        f"a {lat_t}x{tcfg.latent_height}x{tcfg.latent_width} latent grid; clip "
        f"1x3x{tcfg.max_frames}x{px}x{px}): first loss {first:.4f}; launches {json.dumps(got)}")
    report_turns("video_gen: VQVAE3DTrainer", nums, {}, "clips_per_s", vq.graphs.capture_s)
    result["vq_train_ms_per_step"] = nums["graph"]["ms"]
    result["vq_train_ms_per_step_eager"] = nums["eager"]["ms"]
    del vq, clips
    torch.cuda.empty_cache()
    log("video_gen: " + json.dumps(result))
    return main_counts


# Card against CPU at video_gen_large's width (d1728, 12/4 heads of 144),
# 2 layers, the latent grid cut to 4 x 4 (the CPU runs every step's
# full-frame forward).  bf16 on both sides (LOGIT_ATOL, the near-tie rule);
# the trainer step in fp32, as image_gen_parity's.
VID_PARITY_GRID = 4


def run_video_gen_parity():
    """video_gen_large's width at 2 layers on a 4 x 4 grid, card against
    CPU from the same weights: greedy ``generate_video_tokens`` over 2
    frames (a near tie excused, as in ``parity``), the logits of the
    cached forwards append frame 0, read frame 1, append frame 1 (fed the
    CPU's tokens), and one fp32 ``VideoTokenTrainer`` step at B=1 over 15
    latent frames: loss, per-leaf gradients and change in the step."""
    import torch

    from vats_tpu_torch.configs import video_gen_large
    from vats_tpu_torch.inference import generate_video_tokens
    from vats_tpu_torch.models import AutoregressiveVideoTransformer
    from vats_tpu_torch.ops.cache_append import append_token_inplace
    from vats_tpu_torch.train import VideoGenTrainingArgs, VideoTokenTrainer

    gh = VID_PARITY_GRID
    cfg = video_gen_large(num_layers=2, dropout=0.0, latent_height=gh, latent_width=gh)
    gpu = AutoregressiveVideoTransformer(cfg, device="cuda", seed=7).eval()
    cpu = AutoregressiveVideoTransformer(cfg, device="meta")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, assign=True)
    g = torch.Generator().manual_seed(43)
    text = torch.randn((2, VID_TEXT_T, cfg.d_model), generator=g).to(torch.bfloat16)
    kw = dict(num_frames=VID_FRAMES, temperature=0.0, do_sample=False)
    n0 = append_token_inplace.launches
    tok_g = generate_video_tokens(gpu, text.cuda(), None, None, **kw).cpu()
    require(append_token_inplace.launches - n0 == 2 * VID_FRAMES * (gh * gh + 1),
            "video_gen_parity: K3 append launches")
    tok_c = generate_video_tokens(cpu, text, None, None, **kw)
    # the cached forwards fed the CPU's tokens
    flat = tok_c.reshape(2, -1)
    seq = torch.cat([torch.zeros((2, 1), dtype=torch.int32), flat[:, :-1]], 1).reshape(
        tok_c.shape)

    def cached(model):
        cache = model.init_cache(2)
        s = seq.to(model.device)
        out = []
        with torch.no_grad():
            for f, mode in ((0, "append"), (1, "read"), (1, "append")):
                lg, _ = model(s[:, f:f + 1], text.to(model.device), cache=cache,
                              cache_mode=mode, return_logits=True)
                out.append(lg.float().cpu())
        return torch.stack(out)

    err = expect_close("video_gen_parity logits", cached(gpu), cached(cpu), LOGIT_ATOL, 0.0)
    with torch.no_grad():
        full, _ = cpu(seq, text, return_logits=True)
    top2 = full.reshape(2, flat.shape[1], -1).topk(2, dim=-1).values
    gaps = top2[..., 0] - top2[..., 1]
    same = (tok_g.reshape(2, -1) == flat).all(0)
    first = int((~same).nonzero()[0]) if not bool(same.all()) else None
    if first is not None:
        require(bool((gaps[:, first] <= 2 * LOGIT_ATOL).any()),
                f"video_gen_parity: tokens differ at step {first} beyond a near tie")
    rep = (f"logits of 3 cached forwards max |err| {err:.3e} (atol {LOGIT_ATOL}); greedy "
           "tokens equal " + (f"over all {flat.shape[1]} steps" if first is None else
                              f"up to step {first}, a near tie (CPU top-2 gap "
                              f"{float(gaps[:, first].min()):.3e})"))
    del gpu, cpu
    torch.cuda.empty_cache()

    tcfg = video_gen_large(num_layers=2, dropout=0.0, latent_height=gh, latent_width=gh,
                           dtype="float32")
    lat_t = tcfg.max_frames // tcfg.patch_size[0]
    targs = VideoGenTrainingArgs(seed=3)
    tg = VideoTokenTrainer(tcfg, targs, num_training_steps=10, device="cuda")
    tc = VideoTokenTrainer(tcfg, targs, num_training_steps=10,
                           params={k: v.cpu() for k, v in tg.model.state_dict().items()},
                           device="cpu")
    start = {n: p.detach().clone() for n, p in tc.model.named_parameters()}
    batch = {"indices": torch.randint(0, tcfg.num_embeddings, (1, lat_t, gh, gh), generator=g),
             "text_embeddings": torch.randn((1, VID_TEXT_T, tcfg.d_model), generator=g)}
    lg_, lc_ = tg.train_step({k: v.cuda() for k, v in batch.items()}), tc.train_step(batch)
    require(abs(lg_ - lc_) <= PARITY_LOSS_ATOL, f"video_gen_parity: loss {lg_} vs {lc_}")
    grads = leaf_errors(tg.model, tc.model, leaf_grad)
    change = leaf_errors(tg.model, tc.model, lambda n, p: p.detach().cpu() - start[n])
    log(f"video_gen_parity (video_gen_large width, 2 layers, {gh}x{gh} grid, B=2, card vs "
        f"CPU): {rep}; token trainer (fp32, B=1, {lat_t} latent frames, one step): loss card "
        f"{lg_:.5f} cpu {lc_:.5f}; " + leaf_report("gradients", grads, PARITY_LEAF_GRAD_RTOL)
        + "; " + leaf_report("change in the step", change, PARITY_LEAF_CHANGE_RTOL))
    del tg, tc
    torch.cuda.empty_cache()


# --- phase: multimodal --------------------------------------------------------


def _mm_gate(label, fns, want):
    got = _counts(fns)
    _gate(label, got, want, phase="multimodal")
    return got


def mm_step_census(model, label, b, length, n=4, top=8):
    """Kernels and device ms of one decode step of ``generate_multimodal``
    (a paged T == 1 forward at ``length`` tokens a row and the masked
    sampling), from ``n`` eager steps under torch.profiler; returns (kernels
    a step, device ms a step) or (None, None)."""
    import torch

    from vats_tpu_torch.inference import ImageGenerationSampler

    cfg = model.cfg
    cache = model.init_paged_cache(b, MM_SLOTS)
    cache.lengths.fill_(length)
    cache.fresh = False
    tok = torch.full((b, 1), cfg.text_vocab_size, dtype=torch.int32, device="cuda")
    mod = torch.full((b, 1), 2, dtype=torch.int32, device="cuda")
    loc = torch.full((b, 1), 100, dtype=torch.int32, device="cuda")
    sampler = ImageGenerationSampler(temperature=0.9, top_k=64)
    g = torch.Generator(device="cuda").manual_seed(0)
    allowed = torch.arange(cfg.vocab_size, device="cuda") >= cfg.text_vocab_size

    def steps():
        with torch.no_grad():
            for _ in range(n):
                lg, _ = model(tok, mod, loc, paged_cache=cache)
                cache.lengths.fill_(length)  # every step at the same length
                sampler(g, torch.where(allowed, lg[:, 0], float("-inf")))

    steps()
    torch.cuda.synchronize()
    per, _ = profiled(steps)
    if not per:
        log(f"census {label}: not measured (the profiler recorded no device time)")
        return None, None
    count = sum(c for _, c in per.values()) / n
    busy = sum(us for us, _ in per.values()) / n / 1e3
    log(f"census {label} B={b} at {length} tokens a row: {count:.1f} kernels a decode step "
        f"({count / cfg.num_layers:.1f} a layer), {busy:.3f} device ms a step; heaviest:")
    for name, (us, c) in sorted(per.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {us / n / 1e3:9.3f} ms {c / n:8.1f}x  {name[:100]}")
    return count, busy


def run_multimodal(fns):
    """The fused stream at multimodal_small's full width (d768, 8/4 heads of
    96, vocabulary 4864) at MM_GEN_LAYERS of its 12 layers: ``generate_multimodal`` at
    the JAX bench's shape (B=4, t_text=64, 256 image + 2048 video tokens a
    row: 2303 decode forwards; temperature 0.9, top-k 64), every step after
    the first replayed from a CUDA graph, in turns with the eager loop
    (graph, eager, graph; equal codes); a ragged call at t_text=256
    (prompts 256/200/131/17) whose prefill takes K2; 64 decode steps through
    the dense cache and the paged cache fed the same tokens (K3's dense and
    paged table modes; logits within LOGIT_ATOL).  Exact gates: K1 and K3's
    paged table mode once a layer a decode forward, K2 once a layer a
    prefill at t_text >= 256 and never at 64.  Tokens/s, kernels and device ms a step
    (``mm_step_census`` at a mid-stream length), idle share (census busy x
    steps over the wall, and a profiled graph run on a sample: one video
    frame), peak memory."""
    import torch

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
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(61)
    sampler = ImageGenerationSampler(temperature=0.9, top_k=64)
    b = MM_B
    log(f"multimodal: multimodal_small d{cfg.d_model}/{L}L {cfg.num_heads}H/"
        f"{cfg.query_groups}G hd {cfg.head_dim}, vocabulary {cfg.vocab_size}, "
        f"{n_params / 1e6:.1f}M params (fp32, bf16 compute), B={b}, t_text {MM_T_TEXT}, "
        f"{cfg.image_tokens} image + {cfg.video_tokens} video tokens a row")
    ids = torch.randint(1, cfg.text_vocab_size, (b, MM_T_TEXT), generator=gen, device="cuda")
    decode_want = dict(none)
    decode_want.update({k1: L * (n_total - 1), ptab: L * (n_total - 1), pp: L * (n_total - 1)})

    def drive(use_graph, text_ids=ids, mask=None, m=model, want=decode_want):
        _zero(fns)
        t0 = time.perf_counter()
        img, vid, graph = _generate_multimodal(
            m, text_ids, mask, torch.Generator(device="cuda").manual_seed(5), sampler=sampler,
            page_size=128, use_graph=use_graph)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _mm_gate(f"generate_multimodal {'graph' if use_graph else 'eager'} t_text "
                       f"{text_ids.shape[1]}", fns, want)
        steps = m.cfg.image_tokens + m.cfg.video_tokens
        return (dict(wall_s=wall, tokens_per_s=text_ids.shape[0] * steps / wall,
                     capture_s=graph.capture_s if graph else 0.0), (img, vid, got))

    runs = in_turns("multimodal: generate_multimodal", [("graph", lambda: drive(True)),
                                                        ("eager", lambda: drive(False))],
                    order=(0, 1, 0))
    outs = [res for name in runs for _, res in runs[name]]
    require(all(torch.equal(o[0], outs[0][0]) and torch.equal(o[1], outs[0][1]) for o in outs),
            "multimodal: graph and eager runs drew different codes")
    img, vid = outs[0][0], outs[0][1]
    require(tuple(img.shape) == (b, cfg.image_grid_h, cfg.image_grid_w)
            and tuple(vid.shape) == (b, cfg.video_grid_t, cfg.video_grid_h, cfg.video_grid_w)
            and 0 <= int(img.min()) and int(img.max()) < cfg.image_vocab_size
            and 0 <= int(vid.min()) and int(vid.max()) < cfg.video_vocab_size,
            "multimodal: codes out of range")
    count, step_ms = mm_step_census(model, "multimodal decode", b, MM_T_TEXT + n_total // 2)
    rates = {m: [nums["tokens_per_s"] for nums, _ in runs[m]] for m in runs}
    idle = {}
    for m in runs:
        nums = min((nums for nums, _ in runs[m]), key=lambda x: x["wall_s"])
        idle[m] = ("not measured" if step_ms is None else
                   f"{1 - step_ms / 1e3 * (n_total - 1) / nums['wall_s']:.3f}")
    peak = max(nums["peak_mem_gb"] for m in runs for nums, _ in runs[m])
    # a profiled graph run on a sample: one video frame (256 + 256 steps)
    one = MultimodalLM(multimodal_small(video_grid_t=1, num_layers=MM_GEN_LAYERS),
                       device="meta")
    one.load_state_dict(model.state_dict(), assign=True)
    one = one.eval()
    sample_want = dict(none)
    sample_want.update({k1: L * 511, ptab: L * 511, pp: L * 511})
    busy = profile_breakdown("multimodal graph run on a sample (video_grid_t 1: 511 steps)",
                             lambda: drive(True, m=one, want=sample_want), top=6,
                             also=("prologue", "paged_decode"))
    log(f"multimodal: generate_multimodal B={b} t_text {MM_T_TEXT} ({n_total} tokens a row, "
        f"{n_total - 1} decode forwards): tokens/s graph {rates['graph']} eager "
        f"{rates['eager']}; launches {json.dumps(runs['graph'][0][1][2])}; {_fmt(count, 1)} "
        f"kernels and {_fmt(step_ms, 3)} device ms a decode step; idle share graph "
        f"{idle['graph']} eager {idle['eager']} (census busy x steps over the fastest run's "
        f"wall); sample run busy {_fmt(busy, 3)} s; peak_mem_gb={peak:.3f}")
    main_counts = {k_: v for k_, v in runs["graph"][0][1][2].items() if v}
    del one

    # ragged prompts at t_text 256: the prefill takes K2 (L launches)
    t_long = MM_RAGGED[0]
    ids_long = torch.randint(1, cfg.text_vocab_size, (b, t_long), generator=gen, device="cuda")
    mask = torch.arange(t_long, device="cuda")[None, :] < torch.tensor(MM_RAGGED,
                                                                          device="cuda")[:, None]
    ids_long = torch.where(mask, ids_long, 0)
    want = dict(decode_want)
    want[k2] = L
    nums, (img, vid, got) = drive(True, ids_long, mask, want=want)
    require(0 <= int(img.min()) and int(vid.max()) < cfg.video_vocab_size,
            "multimodal: ragged codes out of range")
    log(f"multimodal: ragged prompts {MM_RAGGED} at t_text {t_long} (graph): tokens_per_s="
        f"{nums['tokens_per_s']:.1f} wall_s={nums['wall_s']:.3f}; launches {json.dumps(got)}")

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
    err = expect_close("multimodal dense vs paged cache logits", dense_lg, paged_lg,
                       LOGIT_ATOL, 0.0)
    log(f"multimodal: {steps} decode steps through the dense and the paged cache: logits max "
        f"|err| {err:.3e} (atol {LOGIT_ATOL}); launches dense {json.dumps(got_d)} paged "
        f"{json.dumps(got_p)}")
    del model
    torch.cuda.empty_cache()
    log("multimodal: " + json.dumps(dict(tokens_per_s=rates, idle=idle, kernels_a_step=count,
                                         device_ms_a_step=step_ms, peak_mem_gb=peak)))
    return main_counts


def run_multimodal_parity():
    """multimodal_small's width at 2 layers with 2 video frames (256 image
    + 512 video tokens a row), card against CPU from the same weights:
    greedy ``generate_multimodal`` over the ragged prompts 256/200/131/17
    (the card's prefill through K2, its decode through K3's paged table
    mode and K1; codes equal up to a near tie of the CPU's masked top two
    logits, as in ``parity``), and the logits of the prefill's readout and
    of 32 decode steps fed the CPU's tokens."""
    import torch

    from vats_tpu_torch.configs import multimodal_small
    from vats_tpu_torch.inference import generate_multimodal
    from vats_tpu_torch.models import MultimodalLM
    from vats_tpu_torch.ops import cache_append as ca
    from vats_tpu_torch.ops import flash_attention as fa

    cfg = multimodal_small(num_layers=2, video_grid_t=2)
    vt, vi = cfg.text_vocab_size, cfg.image_vocab_size
    n_img, n_total = cfg.image_tokens, cfg.image_tokens + cfg.video_tokens
    gpu = MultimodalLM(cfg, device="cuda", seed=9).eval()
    cpu = MultimodalLM(cfg, device="meta")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, assign=True)
    g = torch.Generator().manual_seed(47)
    b, t_long = len(MM_RAGGED), MM_RAGGED[0]
    lens = torch.tensor(MM_RAGGED)
    mask = torch.arange(t_long)[None, :] < lens[:, None]
    ids = torch.where(mask, torch.randint(1, vt, (b, t_long), generator=g), 0)
    kw = dict(temperature=0.0, do_sample=False)
    n0 = (fa.flash_attention.launches, ca.paged_decode_prologue.table.launches)
    out_g = generate_multimodal(gpu, ids.cuda(), mask.cuda(), None, **kw)
    require((fa.flash_attention.launches - n0[0],
             ca.paged_decode_prologue.table.launches - n0[1])
            == (cfg.num_layers, cfg.num_layers * (n_total - 1)),
            "multimodal_parity: K2 / K3 table launches")
    out_c = generate_multimodal(cpu, ids, mask, None, **kw)
    flat = lambda o: torch.cat([o[0].reshape(b, -1).cpu() + vt,  # noqa: E731
                                o[1].reshape(b, -1).cpu() + vt + vi], 1)
    gen_g, gen_c = flat(out_g), flat(out_c)
    pre_mod = torch.zeros((b, t_long), dtype=torch.int32)
    pre_loc = torch.arange(t_long, dtype=torch.int32)[None, :].expand(b, -1)

    def forced(model, steps=min(32, n_img)):
        dev = model.device
        cache = model.init_paged_cache(b, t_long + n_total)
        out = []
        with torch.no_grad():
            lg, _ = model(ids.to(dev), pre_mod.to(dev), pre_loc.to(dev),
                          padding_mask=mask.to(dev), paged_cache=cache,
                          readout_positions=(lens - 1).to(dev))
            out.append(lg[:, 0].float().cpu())
            for i in range(steps):
                full = lambda x: torch.full((b, 1), x, dtype=torch.int32, device=dev)  # noqa: E731
                lg, _ = model(gen_c[:, i:i + 1].to(dev), full(1), full(i), paged_cache=cache)
                out.append(lg[:, 0].float().cpu())
        return torch.stack(out, 1)

    err = expect_close("multimodal_parity logits", forced(gpu), forced(cpu), LOGIT_ATOL, 0.0)
    # the CPU's masked top-two gaps along its own streams (uncached forwards)
    vocab = torch.arange(cfg.vocab_size)
    gaps = torch.empty((b, n_total))
    with torch.no_grad():
        for r in range(b):
            n_ = int(lens[r])
            seq = torch.cat([ids[r, :n_], gen_c[r]])[None]
            mod = torch.cat([torch.zeros(n_), torch.ones(n_img),
                             torch.full((n_total - n_img,), 2)]).to(torch.int32)[None]
            loc = torch.cat([torch.arange(n_), torch.arange(n_img),
                             torch.arange(n_total - n_img)]).to(torch.int32)[None]
            lg, _ = cpu(seq, mod, loc)
            lg = lg[0, n_ - 1:n_ - 1 + n_total]
            img_rows = torch.arange(n_total)[:, None] < n_img
            lo = torch.where(img_rows, vt, vt + vi)
            hi = torch.where(img_rows, vt + vi, cfg.vocab_size)
            top2 = torch.where((vocab >= lo) & (vocab < hi), lg, float("-inf")).topk(2).values
            gaps[r] = top2[:, 0] - top2[:, 1]
    same = (gen_g == gen_c).all(0)
    first = int((~same).nonzero()[0]) if not bool(same.all()) else None
    if first is not None:
        require(bool((gaps[:, first] <= 2 * LOGIT_ATOL).any()),
                f"multimodal_parity: codes differ at step {first} beyond a near tie")
    log(f"multimodal_parity (multimodal_small width, 2 layers, 2 video frames, prompts "
        f"{MM_RAGGED}, card vs CPU): logits of the prefill readout and 32 forced decode steps "
        f"max |err| {err:.3e} (atol {LOGIT_ATOL}); greedy codes equal "
        + (f"over all {n_total} steps" if first is None else
           f"up to step {first}, a near tie (CPU masked top-2 gap "
           f"{float(gaps[:, first].min()):.3e})"))
    del gpu, cpu
    torch.cuda.empty_cache()


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
        require(dl <= PARITY_LOSS_ATOL and dn <= PARITY_NORM_RTOL * single["metrics"]["grad_norm"],
                f"context_parallel: {mode} step loss {tr['metrics']['loss']} / grad norm "
                f"{tr['metrics']['grad_norm']} against single {single['metrics']}")
        log(f"context_parallel: {mode} against the single-process step: |loss diff| "
            f"{dl:.2e} (limit {PARITY_LOSS_ATOL}), |grad norm diff| {dn:.2e} (limit "
            f"{PARITY_NORM_RTOL} relative); "
            + leaf_report(f"{mode} gradients", tr["leaf_errs"], PARITY_LEAF_GRAD_RTOL))
    log(f"context_parallel: phase {time.perf_counter() - t0:.1f} s (its budget: 90 s)")


# --- phase: sharded ---------------------------------------------------------

SH_RANKS, SH_B, SH_T = 4, 4, 512
SH_STEPS = 10  # the schedule's length: no warmup step, so step 0 moves the weights
SH_LAYERS = 2  # of medium_moe's 12 (4 until K6): depth cut to keep the whole run in its time
# The step in fp32 first, then in bf16 (the config's own compute dtype).  Each
# is held to its single-process step's loss and grad norm and dropped
# assignments; the fp32 step also leaf by leaf (train_parity's limits): in
# bf16 the sharded and single steps round differently, a router near a tie
# picks another expert, and at capacity the slot-major order then keeps
# other tokens, so a few of 2048 tokens take another path through the layer
# and every weight's gradient moves by a few percent (read on an H100: worst
# leaf 8.9e-2, median 5.0e-2), as image_gen_parity's quantizer argmin flips
# in bf16.
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
                ref["leaves"] = {n: (leaf_grad(n, p).detach().float().cpu().clone(),
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
                    g = _to_root(leaf_grad(n, p), getattr(p, "shard_info", None))
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
                f"(limit {PARITY_LOSS_ATOL}), |grad norm diff| {dn:.2e} (limit "
                f"{PARITY_NORM_RTOL} relative); dropped assignments a layer single/sharded: "
                f"{', '.join(drops)}")
            require(dl <= PARITY_LOSS_ATOL and dn <= PARITY_NORM_RTOL * sm["grad_norm"],
                    f"sharded {label} {dt}: loss {st['loss']} / grad norm {st['grad_norm']} "
                    f"against single {sm}")
            for layer, (ds, dh, flips, allowance) in enumerate(res["flips"]):
                require(abs(ds - dh) <= allowance, f"sharded {label} {dt} layer {layer}: "
                        f"dropped {dh} assignments, the single-process step {ds}, {flips} "
                        f"tokens routed elsewhere (allowance {allowance})")
            if dt == SH_LEAF_DTYPE:
                log(f"sharded {label} {dt}: "
                    + leaf_report(f"{label} gradients", res["errs_grad"], PARITY_LEAF_GRAD_RTOL)
                    + "; " + leaf_report(f"{label} change in the step", res["errs_change"],
                                         PARITY_LEAF_CHANGE_RTOL))
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
# >= 100x that, and far under train_parity's 0.04 / 0.2, which hold the
# card against the CPU: logits relative L2, |loss - single|, each rank's
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
            n: (leaf_grad(n, p).detach().float().cpu(), p.detach().float().cpu(),
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
        for kind, t in (("grad", leaf_grad(name, p)), ("param", p)):
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
        + leaf_report("gradients", par0["errs_grad"], PP_LEAF_GRAD_RTOL) + "; "
        + leaf_report("change in one AdamW update", par0["errs_change"], PP_LEAF_CHANGE_RTOL)
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
    ]
    results = {}
    if "kernels" in phases:
        # each check draws its inputs from its own seed, so a change to one
        # check leaves the others' inputs as they were
        gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)  # noqa: E731
        results["paged_decode_attention_commit"] = check_k1(gen(0))
        results["paged_decode_attention_commit_int8"] = check_k4(gen(1))
        results["flash_attention_forward"] = check_k2(gen(2))
        (results["dense_decode_prologue"],
         results["paged_decode_prologue"]) = check_k3_prologue(gen(6))
        results["flash_attention_forward_lse"] = check_k2_lse(gen(4))
        (results["flash_attention_backward_dkv"],
         results["flash_attention_backward_dq"]) = check_k5(gen(5))
        check_vit_flash(gen(7))
        (results["dense_decode_prologue_table"],
         results["paged_decode_prologue_table"]) = check_k3_table(gen(8))
        check_k1_image_gen(gen(9))
        check_image_gen_flash(gen(10))
        check_k3(gen(3))  # the LM's cache shape (the row keeps the video shape's)
        results["dense_cache_append"] = check_k3_video(gen(11))
        check_k3_multimodal_table(gen(12))
        check_k1_multimodal(gen(13))
        check_k2_multimodal(gen(14))
        check_ring_hop(gen(15))
        results["paged_prefill_attention"] = check_k6(gen(16))
        # code_chat_8k's shapes (Mellum2, hd 128): K1 with and without its
        # window, K6's prefills under the budget, K3's YaRN table
        results["paged_decode_attention_commit"]["code_chat_8k"] = check_k1_window(gen(17))
        results["paged_prefill_attention"]["code_chat_8k"] = check_k6(
            gen(18), K6_HYBRID_SHAPES, WINDOW_HEADS[1:], WINDOW_PPS, (WINDOW_LW, -1))
        results["paged_decode_prologue_table"]["code_chat_8k"] = check_k3_yarn(gen(19))
        results["moe_grouped_gemm"] = check_k7(gen(20))
        log(f"phase kernels ended at {time.perf_counter() - t_start:.1f}s")
    counts = {"main": {}, "serve": {}, "train": {}, "image_gen": {}, "video_gen": {},
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
        "parity": run_parity,
        "serve": lambda: run_serve({r["name"]: r["fn"] for r in kernel_rows}),
        "serve_parity": run_serve_parity,
        "train": lambda: run_train([r["fn"] for r in kernel_rows] + [fa.flash_attention]),
        "train_parity": run_train_parity,
        "context_parallel": run_context_parallel,
        "sharded": run_sharded,
        "pipeline": run_pipeline,
        "scripts": lambda: run_scripts({r["name"]: r["fn"] for r in kernel_rows}),
        "vision": lambda: run_vision([fa.flash_attention, fa.flash_attention_lse,
                                      fa.flash_bwd_dkv, fa.flash_bwd_dq]),
        "vision_parity": run_vision_parity,
        "image_gen": lambda: run_image_gen([
            dense_decode_prologue.table, paged_decode_prologue.table,
            paged_decode_attention_commit, fa.flash_attention, fa.flash_attention_lse,
            fa.flash_bwd_dkv, fa.flash_bwd_dq, dense_decode_prologue, paged_decode_prologue,
            append_token_inplace]),
        "image_gen_parity": run_image_gen_parity,
        "video_gen": lambda: run_video_gen(every_kernel),
        "video_gen_parity": run_video_gen_parity,
        "multimodal": lambda: run_multimodal(every_kernel),
        "multimodal_parity": run_multimodal_parity,
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
