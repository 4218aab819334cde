"""Rotary positional embeddings (1D interleaved), fp32 island.

Counterpart of the 1-D part of ``vats_tpu/nn/rope.py``::

    x1 = x[..., 0::2]; x2 = x[..., 1::2]
    out[..., 0::2] = x1*cos - x2*sin
    out[..., 1::2] = x1*sin + x2*cos

Positions are absolute (decode passes each row's own positions).  The
axial 2-D (ViT-2D) and 3-D (ViT-3D, video generation) rotations are here
too, and the NTK-scaled raster-order 2-D and 3-D rotations of the
generation stacks, whose per-token tables (:func:`rope_2d_ntk_cos_sin`,
:func:`rope_3d_ntk_cos_sin`) are also what K3's table mode reads
(``ops/cache_append.py``), and YaRN's 1-D table (:func:`yarn_inv_freq`,
:func:`rope_table_cos_sin`), which the full-attention layers of a
``HybridModelArgs`` model rotate by.  Angles are fp32 and each result is cast
back to x's dtype, as in JAX.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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


def yarn_inv_freq(head_dim: int, theta: float, factor: float, original_max_position: int,
                  beta_fast: float = 32.0, beta_slow: float = 1.0,
                  device=None) -> torch.Tensor:
    """YaRN's inv_freq [hd/2] (fp32), as HF ``_compute_yarn_parameters``
    makes it: between the plain frequencies (extrapolation) and those
    divided by ``factor`` (interpolation) by a ramp over the pair index i,
    clamp((i - low) / (high - low), 0, 1), with low = floor(d(beta_fast))
    and high = ceil(d(beta_slow)), d(b) = hd ln(original / (2 pi b)) /
    (2 ln theta), clipped to [0, hd - 1]: pairs below low keep their
    frequency, pairs above high take the interpolated one."""

    def corr_dim(rotations):
        return (head_dim * math.log(original_max_position / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(corr_dim(beta_fast)), 0)
    high = min(math.ceil(corr_dim(beta_slow)), head_dim - 1)
    if low == high:
        high += 0.001
    extra = rope_inv_freq(head_dim, theta, device=device)
    ramp = torch.clamp((torch.arange(head_dim // 2, dtype=torch.float32, device=device) - low)
                       / (high - low), 0, 1)
    return extra / factor * ramp + extra * (1 - ramp)


def rope_table_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor,
                       scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (cos, sin) of shape positions.shape + [hd/2] at ``positions``
    (any shape) by a 1-D ``inv_freq``, each times ``scale`` (YaRN's
    attention factor: q.k scales by its square).  Computed on the
    positions' device with no host sync."""
    angles = positions.float()[..., None] * inv_freq
    cos, sin = torch.cos(angles), torch.sin(angles)
    if scale != 1.0:
        cos, sin = cos * scale, sin * scale
    return cos, sin


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


# --- axial 2-D RoPE (ViT-2D) -------------------------------------------------


def grid_positions_2d(grid_h: int, grid_w: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row / column ids of a row-major flattened [grid_h * grid_w] grid."""
    rows = torch.arange(grid_h, device=device).repeat_interleave(grid_w)
    cols = torch.arange(grid_w, device=device).repeat(grid_h)
    return rows, cols


def apply_rope_2d_axial(
    x: torch.Tensor,
    grid_h: int,
    grid_w: int,
    theta: float,
    ntk_scale_factor: Optional[float] = None,
) -> torch.Tensor:
    """Axial 2-D RoPE on [B, N, H, hd] with N == grid_h * grid_w.

    hd splits into four contiguous quarters (x1, x2, y1, y2): (x1, x2)
    rotate by row angles, (y1, y2) by column angles, with
    inv_freq = theta^-(i / (hd/4)).  ``ntk_scale_factor`` multiplies the
    positions."""
    head_dim = x.shape[-1]
    if head_dim % 4 != 0:
        raise ValueError(f"head_dim ({head_dim}) must be divisible by 4 for 2D RoPE")
    f = head_dim // 4
    rows, cols = grid_positions_2d(grid_h, grid_w, device=x.device)
    rows, cols = rows.float(), cols.float()
    if ntk_scale_factor is not None:
        rows = rows * ntk_scale_factor
        cols = cols * ntk_scale_factor
    inv_freq = 1.0 / (theta ** (torch.arange(f, dtype=torch.float32, device=x.device) / f))
    ang_r = (rows[:, None] * inv_freq)[None, :, None, :]  # [1, N, 1, f]
    ang_c = (cols[:, None] * inv_freq)[None, :, None, :]
    cos_r, sin_r, cos_c, sin_c = ang_r.cos(), ang_r.sin(), ang_c.cos(), ang_c.sin()
    x1, x2, y1, y2 = x.float().split(f, dim=-1)
    out = torch.cat([x1 * cos_r - x2 * sin_r, x1 * sin_r + x2 * cos_r,
                     y1 * cos_c - y2 * sin_c, y1 * sin_c + y2 * cos_c], dim=-1)
    return out.to(x.dtype)


# --- NTK-scaled raster 2-D RoPE (image generation) ----------------------------


def _ntk_cos_sin(rows: torch.Tensor, cols: torch.Tensor, head_dim: int, theta: float,
                 ntk_scale_factor: Optional[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (cos, sin) of shape rows.shape + [hd/2]: the first hd/4 pairs
    rotate by the row, the rest by the column, positions scaled by
    ``ntk_scale_factor``."""
    if head_dim % 4 != 0:
        raise ValueError(f"head_dim ({head_dim}) must be divisible by 4")
    inv_freq = rope_inv_freq(head_dim // 2, theta, device=rows.device)  # [hd/4]
    rows, cols = rows.float(), cols.float()
    if ntk_scale_factor is not None:
        rows = rows * ntk_scale_factor
        cols = cols * ntk_scale_factor
    angles = torch.cat([rows[..., None] * inv_freq, cols[..., None] * inv_freq], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def rope_2d_ntk_cos_sin(
    positions: torch.Tensor,
    head_dim: int,
    grid_w: int,
    theta: float,
    ntk_scale_factor: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-token table of the raster 2-D NTK rotation: integer
    positions (any shape; row = pos // grid_w, col = pos % grid_w) -> fp32
    cos / sin of shape positions.shape + [hd/2].  Computed on the
    positions' device with no host sync, so a captured decode step makes it
    from the cache's length."""
    rows = torch.div(positions, grid_w, rounding_mode="floor")
    cols = torch.remainder(positions, grid_w)
    return _ntk_cos_sin(rows, cols, head_dim, theta, ntk_scale_factor)


def apply_rope_2d_ntk(
    x: torch.Tensor,
    grid_h: int,
    grid_w: int,
    theta: float,
    ntk_scale_factor: Optional[float] = None,
) -> torch.Tensor:
    """NTK-scaled 2-D RoPE on [B, N, heads, hd] over a row-major
    grid_h x grid_w grid: interleaved pairs, the first hd/4 rotated by the
    row and the rest by the column."""
    rows, cols = grid_positions_2d(grid_h, grid_w, device=x.device)
    return apply_rope_interleaved(
        x, *_ntk_cos_sin(rows, cols, x.shape[-1], theta, ntk_scale_factor))


def apply_rope_2d_ntk_positions(
    x: torch.Tensor,
    positions: torch.Tensor,
    grid_w: int,
    theta: float,
    ntk_scale_factor: Optional[float] = None,
) -> torch.Tensor:
    """:func:`apply_rope_2d_ntk` at raster-order positions ([T] or [B, T]),
    for cached decode where a token sits at any absolute position."""
    return apply_rope_interleaved(
        x, *rope_2d_ntk_cos_sin(positions, x.shape[-1], grid_w, theta, ntk_scale_factor))


# --- NTK-scaled raster 3-D RoPE (video token streams) --------------------------


def rope_3d_ntk_cos_sin(
    positions: torch.Tensor,
    head_dim: int,
    grid_h: int,
    grid_w: int,
    theta: float,
    ntk_scale_factor: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-token table of the raster 3-D NTK rotation: integer
    positions (any shape; t-major raster over frames of grid_h x grid_w:
    t = pos // (grid_h grid_w), then row and column within the frame) ->
    fp32 cos / sin of shape positions.shape + [hd/2].  The hd/2 pairs split
    into three chunks of hd/6 rotated by t, row and column, each with
    inv_freq = theta^-(i / (hd/6)); ``ntk_scale_factor`` scales the
    coordinates.  Computed on the positions' device with no host sync."""
    if head_dim % 6 != 0:
        raise ValueError(f"head_dim ({head_dim}) must be divisible by 6")
    c = head_dim // 6
    inv_freq = 1.0 / (theta ** (torch.arange(c, dtype=torch.float32,
                                             device=positions.device) / c))
    fpf = grid_h * grid_w
    rem = torch.remainder(positions, fpf)
    coords = [torch.div(positions, fpf, rounding_mode="floor").float(),
              torch.div(rem, grid_w, rounding_mode="floor").float(),
              torch.remainder(rem, grid_w).float()]
    if ntk_scale_factor is not None:
        coords = [x * ntk_scale_factor for x in coords]
    angles = torch.cat([x[..., None] * inv_freq for x in coords], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def apply_rope_3d_ntk_positions(
    x: torch.Tensor,
    positions: torch.Tensor,
    grid_h: int,
    grid_w: int,
    theta: float,
    ntk_scale_factor: Optional[float] = None,
) -> torch.Tensor:
    """Interleaved 3-D RoPE on [B, T, heads, hd] at t-major raster positions
    ([T] or [B, T]) by :func:`rope_3d_ntk_cos_sin`: full forwards
    (positions == arange(N)) and cached decode alike."""
    return apply_rope_interleaved(
        x, *rope_3d_ntk_cos_sin(positions, x.shape[-1], grid_h, grid_w, theta,
                                ntk_scale_factor))


# --- axial 3-D RoPE (ViT-3D) -------------------------------------------------


def rope_3d_axial_cos_sin(
    mode: str,
    head_dim: int,
    theta: float,
    *,
    grid_t: int = 1,
    grid_h: int = 1,
    grid_w: int = 1,
    t_positions: Optional[torch.Tensor] = None,
    ntk_scale_factor: Optional[float] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole-head (cos, sin) table [N, hd/2] of the axial 3-D RoPE: hd
    splits into t, h and w thirds, each rotated as interleaved pairs by its
    own coordinate (inv_freq over the third, positions scaled by
    ``ntk_scale_factor``).

    mode='all':      N = grid_t * grid_h * grid_w, t-major; all three thirds.
    mode='spatial':  N = grid_h * grid_w; h and w, the t third's pairs get
                     the identity (cos 1, sin 0: they pass unchanged).
    mode='temporal': N = len(t_positions); t, identity for h and w.

    Made once a forward, the table rotates every tensor of that forward."""
    if head_dim % 6 != 0:
        raise ValueError(f"head_dim ({head_dim}) must be divisible by 6 for 3D RoPE")
    third = head_dim // 3

    def cos_sin(p):
        if ntk_scale_factor is not None:
            p = p.float() * ntk_scale_factor
        return rope_cos_sin(p, third, theta)

    rows, cols = grid_positions_2d(grid_h, grid_w, device=device)
    if mode == "spatial":
        parts = [None, cos_sin(rows), cos_sin(cols)]
    elif mode == "temporal":
        parts = [cos_sin(t_positions), None, None]
    elif mode == "all":
        ts = torch.arange(grid_t, device=device).repeat_interleave(grid_h * grid_w)
        parts = [cos_sin(ts), cos_sin(rows.repeat(grid_t)), cos_sin(cols.repeat(grid_t))]
    else:
        raise ValueError(f"unknown 3D RoPE mode: {mode}")
    n = next(p_[0].shape[0] for p_ in parts if p_ is not None)
    ident = (torch.ones(n, third // 2, device=device), torch.zeros(n, third // 2, device=device))
    parts = [ident if p_ is None else p_ for p_ in parts]
    return (torch.cat([c for c, _ in parts], dim=-1), torch.cat([s_ for _, s_ in parts], dim=-1))


def apply_rope_3d_axial(
    x: torch.Tensor,
    grid_t: int,
    grid_h: int,
    grid_w: int,
    theta: float,
    mode: str = "all",
    ntk_scale_factor: Optional[float] = None,
    t_positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Axial 3-D RoPE by :func:`rope_3d_axial_cos_sin`.

    mode='all':      x [B, T*H*W, heads, hd]; rotate all three thirds.
    mode='spatial':  x [B*T, H*W, heads, hd]; rotate h and w, pass t.
    mode='temporal': x [B*H*W, T, heads, hd]; rotate t (at ``t_positions``
                     when given, else 0..T-1), pass h and w."""
    if x.shape[-1] % 6 != 0:
        raise ValueError(f"head_dim ({x.shape[-1]}) must be divisible by 6 for 3D RoPE")
    if mode == "spatial" and x.shape[1] != grid_h * grid_w:
        raise ValueError(f"spatial mode expects N == grid_h*grid_w, got {x.shape[1]}")
    if mode == "all" and x.shape[1] != grid_t * grid_h * grid_w:
        raise ValueError("mode='all' expects N == grid_t*grid_h*grid_w")
    if mode == "temporal" and t_positions is None:
        t_positions = torch.arange(x.shape[1], device=x.device)
    return apply_rope_interleaved(x, *rope_3d_axial_cos_sin(
        mode, x.shape[-1], theta, grid_t=grid_t, grid_h=grid_h, grid_w=grid_w,
        t_positions=t_positions, ntk_scale_factor=ntk_scale_factor, device=x.device))
