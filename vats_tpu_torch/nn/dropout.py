"""Dropout whose mask is a function of (step seed, layer, site).

Counterpart of the JAX package's ``flax.linen.Dropout`` sites: the embedding
(or patch-embedding) output, each attention block's output, each MoE layer's
output and each MoE block's output, the dense FFN's two (the SwiGLU's
output and the FFN block's) and each cross-attention block's output.  Flax draws every mask from the step's dropout key folded
with the module path; here every mask is drawn from its own
``torch.Generator`` seeded from the step seed and the (layer, site) pair.

That makes a mask reproducible: a block recomputed under activation
checkpointing draws the identical mask, so its gradients are exact.
(``torch.utils.checkpoint`` restores only the default generators' state, so
a mask drawn from a shared generator would differ in the recompute.)  The
masks are not flax's bits: the two packages agree on dropout only at rate 0
or in distribution.
"""

from __future__ import annotations

from typing import Optional

import torch

#: dropout sites within a layer (the embedding uses layer -1)
SITE_EMBED, SITE_ATTN, SITE_MOE_LAYER, SITE_MOE_BLOCK = 0, 1, 2, 3
SITE_SWIGLU, SITE_FFN_BLOCK, SITE_CROSS = 4, 5, 6


def mask_seed(seed: int, layer: int, site: int) -> int:
    """Generator seed of one mask: distinct for each (seed, layer, site)."""
    return (int(seed) * 1_000_003 + (layer + 1) * 8 + site) % (1 << 63)


def dropout(
    x: torch.Tensor,
    rate: float,
    *,
    deterministic: bool,
    seed: Optional[int],
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
    gen = torch.Generator(device=x.device)
    gen.manual_seed(mask_seed(seed, layer, site))
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))
