"""Logit processors and sampling on [B, V] logits.

Counterpart of ``vats_tpu/inference/sampling.py``: repetition penalty,
temperature (0 = greedy), exact top-k, top-p with the keep-first shift, and
categorical draws, vectorized over the batch.  Draws come from an explicit
``torch.Generator``; they are not JAX's bits, so sampled outputs agree with
the JAX package in distribution only (greedy decoding agrees exactly).
``sample_logits_per_row`` comes with the serving engine.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = float(torch.finfo(torch.float32).min)


def apply_repetition_penalty(
    logits: torch.Tensor,
    generated_ids: torch.Tensor,
    generated_valid: torch.Tensor,
    penalty: float,
) -> torch.Tensor:
    """For every token id present (and valid) in a row: positive logits are
    divided by the penalty, negative ones multiplied."""
    b, v = logits.shape
    presence = torch.zeros((b, v), dtype=torch.int32, device=logits.device)
    presence.scatter_reduce_(
        1, generated_ids.long(), generated_valid.to(torch.int32), reduce="amax"
    )
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(presence > 0, penalized, logits)


def exact_top_k(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the last axis, sorted descending."""
    return torch.topk(logits, k, dim=-1, sorted=True)


def apply_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Mask logits strictly below the top-k threshold to -inf. [B, V]."""
    if top_k <= 0:
        return logits
    k = min(top_k, logits.shape[-1])
    kth = exact_top_k(logits, k)[0][..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def _nucleus_remove(sorted_vals: torch.Tensor, top_p: float) -> torch.Tensor:
    """Removal mask over descending-sorted logits, shifted right so the first
    token crossing ``top_p`` is kept."""
    cum = torch.cumsum(torch.softmax(sorted_vals, dim=-1), dim=-1)
    remove = cum > top_p
    return torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]], dim=-1)


def apply_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering with the keep-first shift. [B, V]."""
    if not (0.0 < top_p < 1.0):
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    remove = _nucleus_remove(sorted_logits, top_p)
    kept_min = torch.where(remove, torch.inf, sorted_logits).amin(
        dim=-1, keepdim=True
    )
    return torch.where(logits < kept_min, NEG_INF, logits)


def _categorical(generator, logits: torch.Tensor) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def sample_logits(
    generator: Optional[torch.Generator],
    logits: torch.Tensor,
    *,
    temperature: Optional[float] = None,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    do_sample: bool = True,
    repetition_penalty: Optional[float] = None,
    generated_ids: Optional[torch.Tensor] = None,
    generated_valid: Optional[torch.Tensor] = None,
    approx_top_k: bool = False,
) -> torch.Tensor:
    """Full sampling pipeline on [B, V] logits -> [B] int32 next tokens.

    With top-k active, temperature / top-p / the draw run in the k-wide
    top-k subspace (exactly equivalent: everything below the k-th logit is
    -inf either way)."""
    if approx_top_k:
        raise NotImplementedError(
            "approx_top_k is a TPU-only approximate top-k (jax.lax.approx_max_k)"
            "; the port samples with the exact top-k"
        )
    logits = logits.float()
    if repetition_penalty is not None and repetition_penalty != 1.0:
        if repetition_penalty <= 0:
            raise ValueError(
                f"expected repetition_penalty > 0, got {repetition_penalty}"
            )
        logits = apply_repetition_penalty(
            logits, generated_ids, generated_valid, repetition_penalty
        )
    if temperature is not None:
        if temperature < 0:
            raise ValueError(f"expected temperature >= 0, got {temperature}")
        if temperature == 0:
            do_sample = False
    if top_k is not None:
        if top_k < 1:
            raise ValueError(f"expected top_k >= 1, got {top_k}")
        if top_k == 1:
            do_sample = False
    if top_p is not None and not (0.0 < top_p <= 1.0):
        raise ValueError(f"expected 0 < top_p <= 1, got {top_p}")

    if do_sample and top_k is not None and 1 < top_k < logits.shape[-1]:
        vals, idx = exact_top_k(logits, top_k)
        if temperature is not None and temperature != 0:
            vals = vals / temperature
        if top_p is not None and top_p < 1.0:
            vals = torch.where(_nucleus_remove(vals, top_p), NEG_INF, vals)
        choice = _categorical(generator, vals)
        return torch.gather(idx, 1, choice[:, None])[:, 0].to(torch.int32)

    if temperature is not None and temperature != 0:
        logits = logits / temperature
    if top_k is not None and top_k > 1:
        logits = apply_top_k(logits, top_k)
    if top_p is not None:
        logits = apply_top_p(logits, top_p)
    if do_sample:
        return _categorical(generator, logits).to(torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)
