"""A frozen copy of the port's dropout rule (``nn/dropout.py``): the keep
mask of a step seed, a (layer, site) pair and each element's position,
through the lowbias32 hash on 32-bit values held in int64.

The reference draws the same masks as the program from the same seed, so a
training step can be compared with dropout on.  A change to the port's rule
is a change to the model's semantics; this copy keeps the yardstick fixed.
"""

from __future__ import annotations

import torch

SITE_EMBED, SITE_ATTN, SITE_MOE_LAYER, SITE_MOE_BLOCK = 0, 1, 2, 3

_M32 = 0xFFFFFFFF
_C1 = 0x7FEB352D
_C2 = 0x846CA68B - (1 << 32)
_COL_SALT = 0x9E3779B9


def _round(x):
    x = x ^ (x >> 16)
    x = (x * _C1) & _M32
    x = x ^ (x >> 15)
    return (x * _C2) & _M32


def mix32(x):
    x = _round(x)
    return x ^ (x >> 16)


def keep_mask(seed: int, shape, rate: float, *, layer: int, site: int, device) -> torch.Tensor:
    """The bool keep mask (True with probability round((1 - rate) * 65536)
    / 65536) of ``seed`` at (layer, site) over ``shape``."""
    rows = 1
    for n in shape[:-1]:
        rows *= n
    width = shape[-1]
    half = (width + 1) // 2
    lo, hi = seed & _M32, (seed >> 32) & _M32
    stream = mix32(((layer + 2) * 16 + site) & _M32)
    r = torch.arange(rows, dtype=torch.int64, device=device)
    row_keys = mix32(mix32(r ^ lo) ^ hi ^ stream)
    col_keys = mix32(torch.arange(half, dtype=torch.int64, device=device) ^ _COL_SALT)
    e = row_keys[:, None] ^ col_keys
    e = (e * _C1) & _M32
    e = (e ^ (e >> 16)) * _C2
    halves = e.view(torch.int16).reshape(rows, half, 4)[..., :2]
    keep = (halves < int(round((1.0 - rate) * 65536)) - 32768).reshape(rows, 2 * half)
    return keep[:, :width].reshape(tuple(shape))


def dropout(x: torch.Tensor, rate: float, seed, *, layer: int, site: int) -> torch.Tensor:
    if seed is None or rate == 0.0:
        return x
    keep = keep_mask(int(seed), tuple(x.shape), rate, layer=layer, site=site, device=x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))
