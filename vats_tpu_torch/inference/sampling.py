"""Logit processors and sampling on [B, V] logits.

Counterpart of ``vats_tpu/inference/sampling.py``: repetition penalty,
temperature (0 = greedy), exact top-k (equal logits in index order, as
``lax.top_k`` orders them), top-p with the keep-first shift, and
categorical draws, vectorized over the batch.  Draws come from an explicit
``torch.Generator``; they are not JAX's bits, so sampled outputs agree with
the JAX package in distribution only (greedy decoding agrees exactly).

:func:`sample_logits_per_row` serves the continuous-batching engine: each
row has its own temperature / top-k / top-p, and a seeded row draws from a
counter-based stream keyed by (seed, position), computed on the device with
integer hashing: reproducible whatever the batch composition or preemption,
but not JAX's threefry bits.
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
    """Exact top-k over the last axis, sorted descending, equal values in
    index order: ``lax.top_k``'s (values, indices) bit for bit.  A stable
    sort, because ``torch.topk`` leaves unspecified both the order of equal
    values and which of them make the k (on the CPU it differs from
    ``lax.top_k`` on bf16 logits upcast to fp32)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


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
    -inf either way).

    ``approx_top_k`` is JAX's ``lax.approx_max_k`` followed by a stable sort
    of the values.  Off the TPU (on the CPU and the GPU) XLA computes
    ``approx_max_k`` exactly, as ``lax.top_k``, so the function JAX computes
    there is the exact top-k, and the re-sort of a top-k that is sorted
    already, ties in index order, changes nothing: the flag selects the same
    :func:`exact_top_k`.  Nothing approximate is left to fall back from."""
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


_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without int64 overflow."""
    hi = ((x >> 16) * c) & 0xFFFF
    return ((hi << 16) + (x & 0xFFFF) * c) & _MASK32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser (xorshift-multiply, "lowbias32")."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keyed_uniform(seeds: torch.Tensor, positions: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] float32 uniforms in (0, 1), a function of (seeds[b],
    positions[b], j) only: row b's stream at a position is the same in any
    batch, on any device.  seeds are uint32 values (held in any int dtype)."""
    seed = seeds.to(torch.int64) & _MASK32
    pos = positions.to(torch.int64) & _MASK32
    j = torch.arange(n, device=seeds.device, dtype=torch.int64)
    h = _hash32(seed)[:, None]
    h = _hash32(h ^ pos[:, None])
    h = _hash32(h ^ _mul32(j[None, :] + 1, 0x9E3779B9))
    # 24 random bits, centred in their cell: never 0 or 1
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def sample_logits_per_row(
    generator: Optional[torch.Generator],
    logits: torch.Tensor,
    *,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
    row_seeds: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    kmax: int = 64,
) -> torch.Tensor:
    """Per-row sampling for continuous batching: logits [B, V];
    temperature/top_p float32 [B]; top_k int32 [B] -> [B] int32.

      * temperature <= 0 or top_k == 1 => greedy (argmax);
      * top_k in [1, kmax] => exact top-k restriction;
      * top_k == 0 => no explicit top-k, but sampling stays within the
        top-``kmax`` logits (a static bound, as in the JAX package);
      * top_p in (0, 1) => nucleus over the sorted subspace, keep-first.

    With ``row_seeds``/``positions``, row i draws Gumbel noise from
    :func:`keyed_uniform` (seed i, position i); otherwise every row draws
    from ``generator``."""
    logits = logits.float()
    kmax = min(kmax, logits.shape[-1])
    vals, idx = exact_top_k(logits, kmax)  # sorted descending
    pos = torch.arange(kmax, device=logits.device)[None, :]
    k_eff = torch.where(top_k > 0, torch.clamp(top_k, max=kmax), kmax)
    vals = torch.where(pos < k_eff[:, None], vals, NEG_INF)
    greedy = (temperature <= 0.0) | (top_k == 1)
    safe_t = torch.where(greedy, 1.0, torch.clamp(temperature, min=1e-6))
    vals = vals / safe_t[:, None]
    cum = torch.cumsum(torch.softmax(vals, dim=-1), dim=-1)
    remove = cum > top_p[:, None]
    remove = torch.cat([torch.zeros_like(remove[:, :1]), remove[:, :-1]], dim=-1)
    use_p = (top_p > 0.0) & (top_p < 1.0)
    vals = torch.where(use_p[:, None] & remove, NEG_INF, vals)
    if row_seeds is not None:
        u = keyed_uniform(row_seeds, positions, kmax)
        choice = torch.argmax(vals - torch.log(-torch.log(u)), dim=-1)
    else:
        choice = _categorical(generator, vals)
    # sorted-descending subspace: index 0 IS the argmax for greedy rows
    choice = torch.where(greedy, 0, choice)
    return torch.gather(idx, 1, choice[:, None])[:, 0].to(torch.int32)
