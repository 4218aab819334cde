"""Weight initializers: the distributions of ``vats_tpu/nn/initializers.py``.

  * embeddings / lm_head:          normal(0, 0.02)
  * qkv / gate / up / router:      xavier_uniform, scaled by
                                   1/sqrt(num_layers/6) when num_layers > 12
  * attn-out / ffn-down:           normal(0, 0.02 / sqrt(2*num_layers))
  * RMSNorm scale:                 ones

Each draws from an explicit ``torch.Generator`` (on the tensor's device), so
the same seed gives the same weights on one device.  The draws are not
JAX's bits: tests that need equal weights in both packages convert them with
``vats_tpu_torch.utils.convert``.  Shapes are given in the JAX
orientation, ``fan_in`` first; stacked experts ``[E, in, out]`` take their
fans from the last two axes, as ``ExpertSwiGLU``'s per-expert init does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

INIT_STD = 0.02


def normal_(t: torch.Tensor, std: float, generator: Optional[torch.Generator]):
    with torch.no_grad():
        return t.normal_(0.0, std, generator=generator)


def embed_init_(t: torch.Tensor, generator=None):
    return normal_(t, INIT_STD, generator)


def head_init_(t: torch.Tensor, generator=None):
    return normal_(t, INIT_STD, generator)


def input_proj_init_(
    t: torch.Tensor, num_layers: int, fans: Tuple[int, int], generator=None
):
    """Xavier-uniform over (fan_in, fan_out), depth-scaled past 12 layers."""
    fan_in, fan_out = fans
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    if num_layers > 12:
        bound *= 1.0 / math.sqrt(num_layers / 6.0)
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def output_proj_init_(t: torch.Tensor, num_layers: int, generator=None):
    return normal_(t, INIT_STD / math.sqrt(2 * num_layers), generator)
