"""A frozen copy of the port's per-request sampling rule
(``inference/sampling.py``, ``sample_logits_per_row``): the set a request
may draw from, and the draw itself.

A request's set is a prefix of its logits sorted descending (ties in index
order), cut to the engine's static ``kmax`` and to the request's top-k,
then to the nucleus: the softmax of the kept logits over the temperature,
summed in order, keeps every token until the sum first passes top-p, that
token included.  The draw is the argmax over that set of the scaled logit
plus Gumbel noise, the noise of sorted rank j a function of (the request's
draw seed, the token's position, j) through the lowbias32 hash.

The check needs only the set (the least logit it keeps); the control draws
with it.  A change to the port's rule is a change to what a request means;
this copy keeps the yardstick fixed.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_C1 = 0x7FEB352D
_C2 = 0x846CA68B - (1 << 32)  # the same low 32 bits; keeps products in int64
_GOLDEN = 0x9E3779B9


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 over 32-bit values held in int64."""
    x = x ^ (x >> 16)
    x = (x * _C1) & _M32
    x = x ^ (x >> 15)
    x = (x * _C2) & _M32
    return x ^ (x >> 16)


def keyed_uniform(seed: int, positions: torch.Tensor, n: int) -> torch.Tensor:
    """[P, n] float32 uniforms in (0, 1) of one draw seed at ``positions``
    [P]: column j is sorted rank j's."""
    pos = positions.to(torch.int64) & _M32
    j = torch.arange(n, device=positions.device, dtype=torch.int64)
    h = _hash32(torch.full_like(pos, int(seed) & _M32))[:, None]
    h = _hash32(h ^ pos[:, None])
    h = _hash32(h ^ (((j[None, :] + 1) * _GOLDEN) & _M32))
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def _kept(logits: torch.Tensor, temperature: float, top_k: int, top_p: float, kmax: int):
    """(sorted values [P, kmax], their token ids, how many ranks the set
    keeps [P]) of fp32 logits [P, V]."""
    kmax = min(kmax, logits.shape[-1])
    vals, idx = torch.sort(logits.float(), dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :kmax], idx[:, :kmax]
    k = min(top_k, kmax) if top_k > 0 else kmax
    keep = torch.zeros_like(vals, dtype=torch.bool)
    keep[:, :k] = True
    if 0.0 < top_p < 1.0:
        scaled = torch.where(keep, vals / temperature, -torch.inf)
        cum = torch.cumsum(torch.softmax(scaled, dim=-1), dim=-1)
        before = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=-1)
        keep &= before <= top_p  # the token that first passes top_p stays
    return vals, idx, keep.sum(-1)


def set_floor(logits: torch.Tensor, temperature: float, top_k: int, top_p: float,
              kmax: int) -> torch.Tensor:
    """[P] the least logit that each position's set keeps."""
    vals, _, n = _kept(logits, temperature, top_k, top_p, kmax)
    return vals.gather(1, (n - 1)[:, None])[:, 0]


def draw(logits: torch.Tensor, temperature: float, top_k: int, top_p: float, kmax: int,
         seed: int, positions: torch.Tensor) -> torch.Tensor:
    """[P] the tokens the rule draws from fp32 logits [P, V] of one request
    with draw seed ``seed`` at sequence ``positions`` [P]."""
    vals, idx, n = _kept(logits, temperature, top_k, top_p, kmax)
    ranks = torch.arange(vals.shape[1], device=vals.device)[None, :]
    scores = torch.where(ranks < n[:, None], vals / temperature, -torch.inf)
    u = keyed_uniform(seed, positions, vals.shape[1])
    choice = torch.argmax(scores - torch.log(-torch.log(u)), dim=-1)
    return idx.gather(1, choice[:, None])[:, 0]
