"""Dropout whose mask is a function of (step seed, layer, site).

Counterpart of the JAX package's ``flax.linen.Dropout`` sites: the embedding
(or patch-embedding) output, each attention block's output, each MoE layer's
output and each MoE block's output, the dense FFN's two (the SwiGLU's
output and the FFN block's) and each cross-attention block's output.  Flax draws every mask from the step's dropout key folded
with the module path; here every mask is a counter-based hash of the step
seed, the (layer, site) pair and the element's position, in plain PyTorch
integer ops.

The seed is a Python int or an int64 tensor on the device (the step's
static seed buffer when the step replays from a CUDA graph: a replay draws
from the seed copied in before it, not from the one seen at capture).  The
same seed value gives the same mask either way.  A mask is a pure function
of those three, so a block recomputed under activation checkpointing draws
the identical mask, eagerly and in a graph, with no generator state to
restore.  The masks are not flax's bits: the two packages agree on dropout
only at rate 0 or in distribution.

The hash is lowbias32 (C. Wellons) on 32-bit values held in int64: every
product stays inside int64 (the second multiplier is used as its negative
residue mod 2^32), so the arithmetic is exact on the CPU, on the card and in
Python, and nothing depends on how a device wraps an int64 product.  Per
mask: a key per row from (seed, layer, site, row) through two rounds, a
fixed key per pair of columns, and one multiply-xorshift-multiply round on
their xor per pair; each 32-bit result decides two elements by its two
16-bit halves (read as int16 through a view of the int64, little-endian on
both devices), kept below a threshold of 1 - rate in 1/65536ths.  The
element pass is what a mask costs (int64 at half the elements, then one
int16 compare): ``PERF.md`` has its device time a step.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch

#: dropout sites within a layer (the embedding uses layer -1)
SITE_EMBED, SITE_ATTN, SITE_MOE_LAYER, SITE_MOE_BLOCK = 0, 1, 2, 3
SITE_SWIGLU, SITE_FFN_BLOCK, SITE_CROSS = 4, 5, 6

#: a step's dropout seed: a Python int or an int64 (0-d) tensor
Seed = Union[int, torch.Tensor]

_M32 = 0xFFFFFFFF
_C1 = 0x7FEB352D
_C2 = 0x846CA68B - (1 << 32)  # lowbias32's second multiplier, as a negative int64
_COL_SALT = 0x9E3779B9

_COLS: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def _round(x):
    """One multiply-xorshift pair of lowbias32's two."""
    x = x ^ (x >> 16)
    x = (x * _C1) & _M32
    x = x ^ (x >> 15)
    return (x * _C2) & _M32


def mix32(x):
    """lowbias32: a bijection of [0, 2^32); ``x`` a Python int or an int64
    tensor with values in [0, 2^32)."""
    x = _round(x)
    return x ^ (x >> 16)


def _stream(layer: int, site: int) -> int:
    return mix32(((layer + 2) * 16 + site) & _M32)


def _row_keys(seed: Seed, layer: int, site: int, rows: int, device) -> torch.Tensor:
    """[rows] int64 keys in [0, 2^32) of (seed, layer, site, row)."""
    if isinstance(seed, torch.Tensor):
        seed = seed.to(device=device, dtype=torch.int64)
    lo, hi = seed & _M32, (seed >> 32) & _M32
    r = torch.arange(rows, dtype=torch.int64, device=device)
    return mix32(mix32(r ^ lo) ^ hi ^ _stream(layer, site))


def _col_keys(width: int, device: torch.device) -> torch.Tensor:
    """[width] int64 keys of the column alone; kept per (width, device),
    except when made inside a CUDA graph capture (a tensor of the graph's
    pool)."""
    cols = _COLS.get((width, device))
    if cols is None:
        cols = mix32(torch.arange(width, dtype=torch.int64, device=device) ^ _COL_SALT)
        if not (device.type == "cuda" and torch.cuda.is_current_stream_capturing()):
            _COLS[(width, device)] = cols
    return cols


def _shape2d(shape: Sequence[int]) -> Tuple[int, int]:
    """(rows, width): every dimension but the last, and the last."""
    rows = 1
    for n in shape[:-1]:
        rows *= n
    return rows, (shape[-1] if len(shape) else 1)


def uniform(seed: Seed, shape: Sequence[int], *, layer: int, site: int,
            device) -> torch.Tensor:
    """fp32 uniforms in [0, 1) (24 bits) of (seed, layer, site, position):
    one round on (row key ^ column key), whose high bits every bit of both
    reaches."""
    device = torch.device(device)
    rows, width = _shape2d(shape)
    e = _round(_row_keys(seed, layer, site, rows, device)[:, None] ^ _col_keys(width, device))
    return ((e >> 8).to(torch.float32) * (1.0 / (1 << 24))).reshape(tuple(shape))


def keep_mask(seed: Seed, shape: Sequence[int], rate: float, *, layer: int, site: int,
              device) -> torch.Tensor:
    """The bool mask of (seed, layer, site): True with probability
    round((1 - rate) * 65536) / 65536."""
    device = torch.device(device)
    rows, width = _shape2d(shape)
    half = (width + 1) // 2
    e = _row_keys(seed, layer, site, rows, device)[:, None] ^ _col_keys(half, device)
    e = (e * _C1) & _M32
    e = (e ^ (e >> 16)) * _C2  # its low 32 bits are the hash (|e * _C2| < 2^63)
    # the two low int16 lanes of each int64, uniform over [-32768, 32767]
    halves = e.view(torch.int16).reshape(rows, half, 4)[..., :2]
    keep = (halves < int(round((1.0 - rate) * 65536)) - 32768).reshape(rows, 2 * half)
    return keep[:, :width].reshape(shape)


def host_seed(seed: int, layer: int, site: int) -> int:
    """A 64-bit seed for a host ``torch.Generator`` from (seed, layer,
    site), with the row keys' arithmetic."""
    k = mix32(mix32((seed & _M32) ^ _stream(layer, site)) ^ ((seed >> 32) & _M32))
    return (k << 32) | mix32(k ^ _COL_SALT)


def dropout(
    x: torch.Tensor,
    rate: float,
    *,
    deterministic: bool,
    seed: Optional[Seed],
    layer: int,
    site: int,
) -> torch.Tensor:
    """flax Dropout semantics: keep each element with probability 1 - rate
    and scale the kept ones by 1 / (1 - rate); rate 1 gives zeros."""
    if deterministic or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if seed is None:
        raise ValueError("dropout needs a seed outside deterministic mode")
    keep = keep_mask(seed, tuple(x.shape), rate, layer=layer, site=site, device=x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))
