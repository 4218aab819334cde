"""Train and eval steps and the token-budget training loop.

Counterpart of ``vats_tpu/train/loop.py``.  One train step is forward,
backward and the (accumulated) optimizer update, run eagerly: PyTorch has no
``jit`` to wrap it in.  The step's ``rng`` is an int seed for the dropout
masks (the JAX step's dropout key).  The gradients stay in each parameter's
``.grad`` after the step; the next step frees them before its forward.

With ``grad_accum_steps <= 1`` the step owns clip and skip, as the JAX step
does: one fp32 global norm, a scale of min(1, clip / norm), and on a
non-finite norm params and moments untouched and ``skipped_steps`` + 1.  The
finite test stays on the card (``train/optimizer.py``), so a step never
waits for the device.  With accumulation the clip and skip live in the
optimizer (``MultiSteps``).  The JAX loop's semantics are kept as they are,
including what ``ADVICE.md`` records: ``max_skipped_steps`` is not enforced,
and an accumulated run reports the norm of the last boundary.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
from torch.func import functional_call

from vats_tpu_torch.configs.nlp import TrainingArgs
from vats_tpu_torch.device import resolve_dtype
from vats_tpu_torch.train.metrics import (
    IGNORE_INDEX,
    compute_loss,
    compute_perplexity,
    fused_linear_cross_entropy,
)
from vats_tpu_torch.train.optimizer import clip_scale, find_grad_norm, global_norm
from vats_tpu_torch.train.state import TrainState

logger = logging.getLogger("vats_tpu_torch.train")

Batch = Dict[str, torch.Tensor]


def _forward_loss(model, batch: Batch, training_args: TrainingArgs, rng: int):
    """(total, lm, aux) of one training forward (dropout on)."""
    cfg = model.cfg
    kw = dict(padding_mask=batch.get("padding_mask"),
              segment_ids=batch.get("segment_ids"), deterministic=False,
              dropout_seed=rng)
    fused_chunk = getattr(training_args, "fused_ce_chunk", None)
    if fused_chunk:
        hidden, _, aux = model(batch["input_ids"], return_hidden=True, **kw)
        readout = model.token_embed.weight if cfg.tie_weights else model.lm_head.weight
        lm = fused_linear_cross_entropy(hidden, readout, batch["labels"],
                                        chunk=fused_chunk,
                                        compute_dtype=resolve_dtype(cfg.dtype))
        return lm + training_args.aux_loss_weight * aux, lm, aux
    logits, _, aux = model(batch["input_ids"], **kw)
    return compute_loss(logits, batch["labels"], aux, training_args.aux_loss_weight)


def make_train_step_fn(
    model, training_args: TrainingArgs
) -> Callable[[TrainState, Batch, int], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The training step ``step(state, batch, rng) -> (state, metrics)``;
    ``state`` is updated in place and returned.  Metrics are device
    tensors."""
    accum_in_step = getattr(training_args, "grad_accum_steps", 1) <= 1

    def step(state: TrainState, batch: Batch, rng: int):
        params = state.params
        for p in params.values():
            p.grad = None
        total, lm, aux = _forward_loss(model, batch, training_args, rng)
        total.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        with torch.no_grad():
            if accum_in_step:
                gnorm = global_norm(grads)
                finite, scale = clip_scale(gnorm, float(training_args.clip_grad_norm))
                state.opt_state = state.tx.update_(params, grads, state.opt_state,
                                                   scale=scale, finite=finite)
                state.step += 1
                state.skipped_steps += (~finite).to(torch.int32)
            else:
                state.apply_gradients(grads)
                gn = find_grad_norm(state.opt_state)
                gnorm = gn if gn is not None else global_norm(grads)
            tokens = (batch["labels"] != IGNORE_INDEX).sum().to(torch.int32)
            state.tokens_seen += tokens
        metrics = {"loss": total.detach(), "lm_loss": lm.detach(),
                   "aux_loss": aux.detach(), "tokens": tokens, "grad_norm": gnorm}
        return state, metrics

    return step


def make_train_step(model, training_args: TrainingArgs):
    """The training step (eager; the JAX version jits the same function)."""
    return make_train_step_fn(model, training_args)


def make_eval_step(model, training_args: TrainingArgs):
    """``step(params, batch) -> metrics``: a deterministic forward of
    ``model`` with ``params`` (a name -> tensor mapping, e.g.
    ``state.params``)."""

    def step(params, batch: Batch):
        with torch.no_grad():
            logits, _, aux = functional_call(
                model, dict(params), (batch["input_ids"],),
                dict(padding_mask=batch.get("padding_mask"),
                     segment_ids=batch.get("segment_ids"), deterministic=True),
            )
            total, lm, aux = compute_loss(logits, batch["labels"], aux,
                                          training_args.aux_loss_weight)
            tokens = (batch["labels"] != IGNORE_INDEX).sum().to(torch.int32)
        return {"loss": total, "lm_loss": lm, "aux_loss": aux, "tokens": tokens}

    return step


eval_step = make_eval_step


def train(
    model,
    state: TrainState,
    data_iter: Iterable[Batch],
    training_args: TrainingArgs,
    *,
    rng: int,
    max_steps: Optional[int] = None,
    train_step_fn=None,
    log_every: Optional[int] = None,
    callbacks: Optional[Dict[str, Callable]] = None,
) -> Tuple[TrainState, Dict[str, Any]]:
    """Token-budget training loop: stops when ``max_train_tokens`` is
    reached (checked at log points), or the data or ``max_steps`` run out.
    Each step's dropout seed is drawn from a CPU generator seeded by
    ``rng``.  Metrics stay on the device between log points, where they are
    read with one transfer."""
    train_step_fn = train_step_fn or make_train_step(model, training_args)
    log_every = log_every or training_args.logging_steps
    callbacks = callbacks or {}
    seeds = torch.Generator().manual_seed(int(rng))
    totals = {"loss": 0.0, "lm_loss": 0.0, "aux_loss": 0.0}
    pending = []
    steps = 0
    t0 = time.time()
    stop_early = False

    def drain():
        if pending:
            for row in torch.stack(pending).tolist():
                for key, val in zip(totals, row):
                    totals[key] += val
            pending.clear()

    for batch in data_iter:
        if max_steps is not None and steps >= max_steps:
            break
        step_rng = int(torch.randint(0, 1 << 62, (1,), generator=seeds))
        state, metrics = train_step_fn(state, batch, step_rng)
        steps += 1
        pending.append(torch.stack([metrics[k].float() for k in totals]))
        if "on_step" in callbacks:
            callbacks["on_step"](state, metrics, steps)
        if steps % log_every == 0:
            drain()
            tokens_seen = int(state.tokens_seen)
            elapsed = time.time() - t0
            logger.info(
                "step=%d loss=%.4f ppl=%.2f aux=%.4f tokens=%d tok/s=%.0f",
                steps, totals["loss"] / steps,
                compute_perplexity(totals["lm_loss"] / steps),
                totals["aux_loss"] / steps, tokens_seen,
                tokens_seen / max(elapsed, 1e-9),
            )
            if tokens_seen >= training_args.max_train_tokens:
                stop_early = True
                break

    drain()
    denom = max(steps, 1)
    summary = {
        "avg_loss": totals["loss"] / denom,
        "avg_lm_loss": totals["lm_loss"] / denom,
        "avg_aux_loss": totals["aux_loss"] / denom,
        "perplexity": compute_perplexity(totals["lm_loss"] / denom),
        "steps": steps,
        "tokens_seen": int(state.tokens_seen),
        "stop_early": stop_early,
        "wall_time_s": time.time() - t0,
    }
    return state, summary


def validate(
    model,
    state: TrainState,
    data_iter: Iterable[Batch],
    training_args: TrainingArgs,
    *,
    eval_step_fn=None,
    max_batches: Optional[int] = None,
) -> Dict[str, Any]:
    """Evaluation loop: mean loss over at most ``max_eval_batches``."""
    eval_step_fn = eval_step_fn or make_eval_step(model, training_args)
    max_batches = max_batches or training_args.max_eval_batches
    total_loss = total_lm = total_aux = 0.0
    n = 0
    for batch in data_iter:
        if n >= max_batches:
            break
        m = eval_step_fn(state.params, batch)
        total_loss += float(m["loss"])
        total_lm += float(m["lm_loss"])
        total_aux += float(m["aux_loss"])
        n += 1
    denom = max(n, 1)
    return {
        "val_loss": total_loss / denom,
        "val_lm_loss": total_lm / denom,
        "val_aux_loss": total_aux / denom,
        "val_perplexity": compute_perplexity(total_lm / denom),
        "batches": n,
    }
