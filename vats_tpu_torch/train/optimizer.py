"""AdamW, the learning-rate schedule, clip-and-skip and gradient accumulation.

Counterpart of ``vats_tpu/train/optimizer.py``, with optax's transformations
written out, because ``torch.optim.AdamW`` does not reproduce them: optax
computes the update from an fp32 first moment and stores it rounded to
``mu_dtype`` afterwards, and with a bf16 moment it decays the stored value
by b1 rounded to bf16 (``b1 * mu`` with a weak-typed scalar).  The arithmetic
below is optax's, operation for operation:

  mu  = b1 * mu + (1 - b1) * g            (fp32; b1 * mu in mu's dtype)
  nu  = b2 * nu + (1 - b2) * g * g        (fp32)
  u   = (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps) + wd * p
  p  += -lr(n - 1) * u                    (n counts applied updates)

Params, moments and counters are device tensors updated in place (the JAX
state is immutable; in place saves a copy of the parameters and moments).
Skipping a non-finite step is decided on the device too: a ``finite`` flag
turns the step into an exact no-op (decays of 1, increments of 0, a learning
rate of 0), so the host never waits for the norm.

Transformations share one interface: ``init(params) -> state`` and
``update_(params, grads, state) -> state``, which applies the update to
``params`` in place.  Call it under ``torch.no_grad()``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from vats_tpu_torch.configs.nlp import TrainingArgs
from vats_tpu_torch.device import resolve_dtype

Params = Dict[str, torch.Tensor]


def cosine_with_warmup_schedule(
    base_lr: float,
    num_warmup_steps: int,
    num_training_steps: int,
    num_cycles: float = 0.5,
) -> Callable[[Any], torch.Tensor]:
    """Linear warmup then ``0.5 * (1 + cos(2 pi num_cycles progress))``,
    times ``base_lr``; the step may be an int or a device tensor.  Read at
    the pre-increment count, so with warmup the first update has lr 0."""

    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warmup = step / max(1.0, num_warmup_steps)
        progress = (step - num_warmup_steps) / max(
            1.0, num_training_steps - num_warmup_steps
        )
        decay = 0.5 * (1.0 + torch.cos(math.pi * 2.0 * num_cycles * progress))
        factor = torch.where(step < num_warmup_steps, warmup, decay)
        return base_lr * factor

    return schedule


def global_norm(grads: Params) -> torch.Tensor:
    """fp32 global L2 norm over every leaf."""
    norms = torch._foreach_norm([g.float() for g in grads.values()])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_scale(gnorm: torch.Tensor, max_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(finite, scale): scale is min(1, max_norm / norm), or 0 when the norm
    is not finite (one NaN or Inf leaf makes it so)."""
    finite = torch.isfinite(gnorm)
    scale = torch.where(
        finite, torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0),
        torch.zeros_like(gnorm),
    )
    return finite, scale


@dataclass
class AdamWState:
    count: torch.Tensor  # int32: updates applied (adam's and the schedule's count)
    mu: Params
    nu: Params


class AdamW:
    """optax.adamw(schedule, b1, b2, eps, weight_decay, mu_dtype)."""

    def __init__(self, schedule: Callable[[Any], torch.Tensor], b1=0.9, b2=0.999,
                 eps=1e-8, weight_decay=1e-4, mu_dtype: Optional[torch.dtype] = None):
        self.schedule = schedule  # learning rate at the count of applied updates
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mu_dtype = mu_dtype

    def init(self, params: Params) -> AdamWState:
        dev = next(iter(params.values())).device
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu={n: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()},
        )

    def update_(self, params: Params, grads: Params, state: AdamWState, *,
                scale: Optional[torch.Tensor] = None,
                finite: Optional[torch.Tensor] = None) -> AdamWState:
        """One AdamW update of ``params`` in place.  ``scale`` multiplies the
        gradients first (the clip); where ``finite`` is False the step is an
        exact no-op on params, moments and count."""
        # every coefficient is made on the device from Python scalars: a
        # host-to-device copy of a scalar would wait for the backward
        dev = state.count.device
        if finite is None:
            finite = torch.ones((), dtype=torch.bool, device=dev)
        n = (state.count + 1).to(torch.float32)
        bc1 = 1.0 - torch.pow(self.b1, n)
        bc2 = 1.0 - torch.pow(self.b2, n)
        d1 = torch.where(finite, self.b1, 1.0)
        c1 = torch.where(finite, 1.0 - self.b1, 0.0)
        d2 = torch.where(finite, self.b2, 1.0)
        c2 = torch.where(finite, 1.0 - self.b2, 0.0)
        neg_lr = torch.where(finite, -self.schedule(state.count).to(torch.float32), 0.0)
        for name, p in params.items():
            g = grads[name].to(p.dtype)
            if scale is not None:
                g = g * scale.to(g.dtype)
            g = torch.where(finite, g, torch.zeros((), dtype=g.dtype, device=dev))
            mu = state.mu[name]
            mu32 = (mu * d1.to(mu.dtype)).float() + c1 * g
            nu = state.nu[name]
            nu.mul_(d2).add_(c2 * (g * g))
            u = (mu32 / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(u * neg_lr)
            mu.copy_(mu32)
        state.count += finite.to(torch.int32)
        return state


@dataclass
class ClipSkipState:
    inner_state: Any
    notfinite_count: torch.Tensor  # consecutive non-finite steps (int32)
    last_grad_norm: torch.Tensor  # pre-clip global norm (fp32)


class ClipAndSkipNonFinite:
    """Global-norm clip and skip-on-non-finite around an inner AdamW, from
    one norm (``clip_and_skip_nonfinite``): a skipped step leaves the inner
    state untouched and counts in ``notfinite_count``."""

    def __init__(self, max_norm: float, inner: AdamW):
        self.max_norm = max_norm
        self.inner = inner

    def init(self, params: Params) -> ClipSkipState:
        inner = self.inner.init(params)
        dev = inner.count.device
        return ClipSkipState(inner, torch.zeros((), dtype=torch.int32, device=dev),
                             torch.zeros((), dtype=torch.float32, device=dev))

    def update_(self, params: Params, grads: Params, state: ClipSkipState) -> ClipSkipState:
        gnorm = global_norm(grads)
        finite, scale = clip_scale(gnorm, self.max_norm)
        inner = self.inner.update_(params, grads, state.inner_state, scale=scale,
                                   finite=finite)
        count = torch.where(finite, torch.zeros_like(state.notfinite_count),
                            state.notfinite_count + 1)
        return ClipSkipState(inner, count, gnorm)


@dataclass
class MultiStepsState:
    mini_step: int  # position in the accumulation window (host: no skips here)
    gradient_step: torch.Tensor  # boundary updates applied (int32)
    inner_opt_state: Any
    acc_grads: Params


class MultiSteps:
    """optax.MultiSteps(inner, every_k_schedule=k): mini-steps average their
    gradients (acc += (g - acc) / (n + 1)) and leave params alone; the k-th
    applies the inner transformation to the average and resets it."""

    def __init__(self, inner, every_k_schedule: int):
        self.inner = inner
        self.k = int(every_k_schedule)

    def init(self, params: Params) -> MultiStepsState:
        inner = self.inner.init(params)
        dev = next(iter(params.values())).device
        return MultiStepsState(0, torch.zeros((), dtype=torch.int32, device=dev),
                               inner, {n: torch.zeros_like(p) for n, p in params.items()})

    def update_(self, params: Params, grads: Params, state: MultiStepsState) -> MultiStepsState:
        n_acc = state.mini_step
        for name, acc in state.acc_grads.items():
            acc.add_((grads[name].to(acc.dtype) - acc) / (n_acc + 1))
        inner = state.inner_opt_state
        gradient_step = state.gradient_step
        if n_acc == self.k - 1:
            inner = self.inner.update_(params, state.acc_grads, inner)
            gradient_step = gradient_step + 1
            for acc in state.acc_grads.values():
                acc.mul_(0)  # optax's (1 - emit) * acc
        return MultiStepsState((n_acc + 1) % self.k, gradient_step, inner,
                               state.acc_grads)


def find_grad_norm(opt_state) -> Optional[torch.Tensor]:
    """The last pre-clip global norm inside a (possibly wrapped) optimizer
    state; None without a ClipSkipState."""
    while opt_state is not None:
        if isinstance(opt_state, ClipSkipState):
            return opt_state.last_grad_norm
        opt_state = getattr(opt_state, "inner_opt_state", None)
    return None


def create_optimizer(
    training_args: TrainingArgs,
    num_training_steps: int,
    *,
    grad_accum_steps: Optional[int] = None,
):
    """AdamW on the warmup-cosine schedule.  With accumulation the clip and
    skip live inside MultiSteps (they see the averaged boundary gradient);
    without it the train step clips and skips, and this is bare AdamW."""
    mu_dtype = training_args.adam_mu_dtype
    if isinstance(mu_dtype, str):
        mu_dtype = resolve_dtype(mu_dtype)
    num_warmup_steps = int(training_args.warmup_ratio * num_training_steps)
    schedule = cosine_with_warmup_schedule(
        training_args.learning_rate, num_warmup_steps, num_training_steps,
        training_args.num_cycles,
    )
    adamw = AdamW(
        schedule, b1=training_args.betas[0],
        b2=training_args.betas[1], eps=training_args.epsilon,
        weight_decay=training_args.weight_decay, mu_dtype=mu_dtype,
    )
    accum = (grad_accum_steps if grad_accum_steps is not None
             else training_args.grad_accum_steps)
    if accum and accum > 1:
        return MultiSteps(ClipAndSkipNonFinite(training_args.clip_grad_norm, adamw),
                          every_k_schedule=accum)
    return adamw
