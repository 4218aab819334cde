"""Rotary positional embeddings (1D interleaved), fp32 island.

Counterpart of the 1-D part of ``vats_tpu/nn/rope.py``::

    x1 = x[..., 0::2]; x2 = x[..., 1::2]
    out[..., 0::2] = x1*cos - x2*sin
    out[..., 1::2] = x1*sin + x2*cos

Positions are absolute (decode passes each row's own positions).  The 2-D
and 3-D variants come with the vision and generation workloads.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rope_inv_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """inv_freq[i] = 1 / theta^(2i/head_dim), i over even dims (fp32)."""
    if head_dim % 2 != 0:
        raise ValueError(f"head_dim ({head_dim}) must be even for RoPE")
    exponents = (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    )
    return 1.0 / (theta**exponents)


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [T] or [B, T] -> cos/sin of shape positions.shape + [hd/2]."""
    inv_freq = rope_inv_freq(head_dim, theta, device=positions.device)
    freqs = positions.float()[..., None] * inv_freq
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope_interleaved(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """x: [..., T, H, hd]; cos/sin: [T, hd/2] or [B, T, hd/2]."""
    x32 = x.float()
    x1 = x32[..., 0::2]
    x2 = x32[..., 1::2]
    c = cos[..., None, :]
    s = sin[..., None, :]
    r1 = x1 * c - x2 * s
    r2 = x1 * s + x2 * c
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def apply_rope_1d(
    x: torch.Tensor, positions: torch.Tensor, theta: float
) -> torch.Tensor:
    """1D RoPE on [B, T, H, hd] given absolute positions [T] or [B, T]."""
    cos, sin = rope_cos_sin(positions, x.shape[-1], theta)
    return apply_rope_interleaved(x, cos, sin)
