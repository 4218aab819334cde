"""Training cells: the port's ``make_train_step`` fed by ``device_batches``.

Set-up builds one training step over one model and optimizer state from
the seed's fp32 weights, and drives it through its first three optimizer
steps (``grad_accum_steps`` micro-steps each) on the traffic's first
batches, through the same call and feed the window uses; the first call of
each accumulation position is the program's eager warm-up and capture, so
the window only replays.  From that object it keeps, for the check, each
micro-step's loss, the per-leaf norms of the first gradient as the
optimizer holds it after one micro-step (the accumulator under
accumulation; otherwise AdamW's second moment, which is (1 - b2) g^2 of the
clipped gradient), and each leaf's change after the three optimizer steps.

The window then runs whole optimizer steps for the run's seconds, at most
two in flight, and ends on a synchronize.  Its rate counts every non-pad
token of every micro-step in it.

After the window the program is freed and the plain reference repeats the
three optimizer steps from the same weights, batches and dropout seeds.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness, work
from benchmark import traffic as tr
from benchmark.reference.model import (
    Reference,
    ReferenceTrainer,
    leaf_gap,
    moving_leaves,
    no_tf32,
)
from benchmark.weights import make_params

CHECK_OPT_STEPS = 3
#: micro-steps the traced span covers at least (it ends on an optimizer step)
TRACE_MICRO_STEPS = 8


def step_seed(seed: int, i: int) -> int:
    """The dropout seed of micro-step ``i`` of a run (< 2^62)."""
    return int(tr.rng_for(seed, 10_000 + i).integers(0, 1 << 62))


def batch_work(m: dict, batch: Dict[str, np.ndarray]):
    """(non-pad tokens, attended pairs) of a numpy micro-batch."""
    valid = batch["padding_mask"]
    tokens = int(valid.sum())
    segs = batch.get("segment_ids")
    pairs = 0
    for r in range(valid.shape[0]):
        if segs is None:
            pairs += work.causal_pairs([int(valid[r].sum())])
        else:
            _, counts = np.unique(segs[r][valid[r]], return_counts=True)
            pairs += work.causal_pairs(counts.tolist())
    return tokens, pairs


def traced_work(m: dict, b: int, t: int, works) -> dict:
    """Tokens, the flash kernels' least time (every layer's forward and
    backward over the attended pairs) and the model's FLOPs (6 x active
    parameters a token, and attention's forward and backward over the
    pairs; no recompute) of the traced micro-steps."""
    hq, g = m["num_heads"], m["query_groups"]
    hd = m["d_model"] // hq
    fpt = work.forward_flops_per_token(m)
    least = flops = 0.0
    for tokens, pairs in works:
        least += m["num_layers"] * (work.least_s(*work.flash_fwd_cost(b, t, hq, g, hd, pairs,
                                                                      lse=True))
                                    + work.least_s(*work.flash_bwd_cost(b, t, hq, g, hd, pairs)))
        flops += 3 * (fpt * tokens + work.attention_flops(m, pairs))
    return {"micro_steps": len(works), "tokens": sum(w[0] for w in works),
            "flash_least_s": least, "model_flops": flops}


def leaf_norms_first_grad(state, accum: int, b2: float) -> Dict[str, float]:
    """Per-leaf norms of the first gradient as the optimizer holds it."""
    opt = state.opt_state
    if accum > 1:
        return {n: float(a.norm()) for n, a in opt.acc_grads.items()}
    return {n: math.sqrt(float(v.double().sum()) / (1.0 - b2)) for n, v in opt.nu.items()}


def run(ctx) -> dict:
    from vats_tpu_torch.configs.nlp import ModelArgs, TrainingArgs
    from vats_tpu_torch.data.feed import device_batches
    from vats_tpu_torch.models.text_lm import TextLM
    from vats_tpu_torch.train import create_optimizer, create_train_state, make_train_step

    cfg, mix, m, dev, rec = ctx.config, ctx.mix, ctx.config["model"], ctx.device, ctx.rec
    seed, vocab = ctx.seed, m["vocab_size"]
    t_cfg = dict(cfg["trainer"])
    total_steps = int(t_cfg.pop("num_training_steps"))
    accum = int(mix["grad_accum_steps"])
    b, t = int(mix["batch"]), int(mix["seq_len"])
    with rec.phase("build"):
        if dev.type == "cuda":
            from vats_tpu_torch.ops import kernels

            kernels.build_all()
    if dev.type == "cuda":
        with rec.phase("cuda_init"):
            torch.zeros(1, device=dev)
            torch.cuda.synchronize()
    with rec.phase("weights"):
        params = make_params(m, seed, getattr(torch, m["param_dtype"]), dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    with rec.phase("model"):
        model = TextLM(ModelArgs(**m), device="meta")
        model.load_state_dict(params, assign=True)
        del params
        t_cfg["betas"] = tuple(t_cfg["betas"])
        targs = TrainingArgs(**t_cfg, grad_accum_steps=accum, batch_size=b)
        state = create_train_state(model, create_optimizer(targs, total_steps,
                                                           grad_accum_steps=accum))
        step = make_train_step(model, targs)
        p0 = {n: p.detach().clone() for n, p in state.params.items()}
    works: List[tuple] = []  # (tokens, attended pairs) of each micro-batch fed

    def logged():
        for nb in tr.lm_batches(mix, seed, vocab):
            works.append(batch_work(m, nb))
            yield nb

    feed = device_batches(logged(), dev)
    losses: List[torch.Tensor] = []
    i = 0

    def micro():
        nonlocal i, state
        with rec.span("feed"):
            batch = next(feed)
        with rec.span("train.step"):
            state, metrics = step(state, batch, step_seed(seed, i))
        losses.append(metrics["loss"])
        i += 1

    # the first three optimizer steps: captures, and what the check compares
    with rec.phase("first_steps"):
        micro()
        first_grad = leaf_norms_first_grad(state, accum, targs.betas[1])
        while i < CHECK_OPT_STEPS * accum:
            micro()
        with torch.no_grad():
            change = {n: float((p - p0[n]).norm()) for n, p in state.params.items()}
        del p0
        check_losses = [float(x) for x in losses]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.time() - ctx.process_start
    if dev.type == "cuda":  # the device's peak is the window's
        torch.cuda.reset_peak_memory_stats()
    trace = harness.DeviceTrace(rec) if ctx.trace else None
    traced, trace_from, trace_to = None, None, None
    t_ws = time.perf_counter()
    i0 = i
    pending: List[torch.cuda.Event] = []
    while True:
        if trace is not None and trace_from is None \
                and time.perf_counter() - t_ws >= ctx.seconds / 3.0:
            trace.start()
            trace_from = i
        for _ in range(accum):
            micro()
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > 2:  # at most two optimizer steps in flight
                pending.pop(0).synchronize()
        if trace_from is not None and trace_to is None and i - trace_from >= TRACE_MICRO_STEPS:
            traced, trace_to = trace.stop(), i
        if time.perf_counter() - t_ws >= ctx.seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_we = time.perf_counter()
    if trace_from is not None and trace_to is None:
        traced, trace_to = trace.stop(), i
    window_s = t_we - t_ws
    n_micro = i - i0
    tokens = sum(w[0] for w in works[i0:i])
    window_losses = torch.stack(losses[i0:]).float().cpu().numpy()
    failed = int((~np.isfinite(window_losses)).sum())
    record = {"model": m, "counters": {"window_s": window_s, "micro_steps": n_micro,
                                      "tokens": tokens}, "trace": None}
    if traced is not None:
        record["trace"] = dict(traced, counters=traced_work(m, b, t, works[trace_from:trace_to]))
    e2e = {"train_tokens_per_s": tokens / window_s}
    device = harness.device_line(ctx.chips) if dev.type == "cuda" else None
    # free the program before the reference runs
    del step, state, model, feed, losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, info = check(ctx, check_losses, first_grad, change, accum, total_steps)
    return dict(e2e=e2e, record=record, checks=checks, info=info, attempted=n_micro,
                failed=failed, device=device, setup_s=setup_s)


def reference_run(ctx, accum: int, total_steps: int, precision: str = "fp32",
                  batch_rows: slice = slice(None)):
    """The reference's micro-step losses, first-gradient norms and changes
    after CHECK_OPT_STEPS optimizer steps.  ``batch_rows`` keeps part of
    each batch (a fault the check must catch)."""
    m, mix, dev = ctx.config["model"], ctx.mix, ctx.device
    no_tf32()
    params = make_params(m, ctx.seed, getattr(torch, m["param_dtype"]), dev)
    params = {n: p.float().clone() for n, p in params.items()}
    p0 = {n: p.detach().clone() for n, p in params.items()}
    trainer = ReferenceTrainer(Reference(m, params, precision=precision, remat=True),
                               ctx.config["trainer"], accum, total_steps)
    batches = tr.lm_batches(mix, ctx.seed, m["vocab_size"])
    losses = []
    for i in range(CHECK_OPT_STEPS * accum):
        nb = next(batches)
        batch = {k: torch.as_tensor(v[batch_rows]).to(dev) for k, v in nb.items()}
        losses.append(trainer.micro_step(batch, step_seed(ctx.seed, i)))

    with torch.no_grad():
        change = {n: float((p - p0[n]).norm()) for n, p in params.items()}
    return losses, trainer.first_grad, change


def compare(prog, ref) -> Dict[str, float]:
    """The three numbers: the worst micro-step's relative loss gap; the
    median leaf's gap of first-gradient norms (the worst leaf is a router's
    [E, d] weight on every seed, whose gradient follows which tokens flip
    expert under rounding and swings 3x between seeds: ``leaf_stats``
    keeps it); and the worst leaf's gap of change norms (leaves whose
    reference gradient is nought to rounding left out)."""
    losses, grad, change = prog
    r_losses, r_grad, r_change = ref
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))
    return {"loss_rel_gap": loss_gap,
            "grad_median_leaf_gap": leaf_gap(grad, r_grad, list(r_grad), median=True),
            "change_leaf_gap": leaf_gap(change, r_change, moving_leaves(r_grad))}


def leaf_stats(prog, ref) -> dict:
    """The median leaf's gaps and the worst leaves, for the record."""
    out = {}
    for key, p, r, names in (("grad", prog[1], ref[1], list(ref[1])),
                             ("change", prog[2], ref[2], moving_leaves(ref[1]))):
        vals = sorted(r[n] for n in names)
        median = vals[len(vals) // 2]
        gaps = sorted(((abs(p[n] - r[n]) / max(r[n], median, 1e-30), n) for n in names),
                      reverse=True)
        out[f"{key}_median_leaf_gap"] = gaps[len(gaps) // 2][0]
        out[f"{key}_worst_leaves"] = [[n, g] for g, n in gaps[:3]]
    out["grad_worst_leaf_gap"] = out["grad_worst_leaves"][0][1]
    out["loss_gaps"] = [abs(a - b) / abs(b) for a, b in zip(prog[0], ref[0])]
    return out


def check(ctx, losses, first_grad, change, accum, total_steps):
    t_ref = time.perf_counter()
    ref = reference_run(ctx, accum, total_steps)
    ref_s = time.perf_counter() - t_ref
    nums = compare((losses, first_grad, change), ref)
    # a cell compares the numbers its limits file names (PERF.md says why
    # one is left out); the others stay in the record
    checks = {k: {"value": v, "limit": ctx.limits[k]} for k, v in nums.items()
              if k in ctx.limits}
    info = {"reference_s": ref_s, "compared_micro_steps": len(losses),
            **leaf_stats((losses, first_grad, change), ref),
            "not_compared": {k: v for k, v in nums.items() if k not in ctx.limits},
            "moving_leaves": len(moving_leaves(ref[1])), "leaves": len(ref[1]),
            "first_loss": losses[0], "reference_first_loss": ref[0][0]}
    return checks, info
