"""ViT-2D image encoder configuration.

The port's own copy of ``vats_tpu/configs/vit2d.py`` (that module imports no
JAX): the same fields, defaults, validation and tiers, so a config moves
between the two packages unchanged (``tests/test_torch_configs.py`` checks
the fields).  ``medium`` is the original repository's only tier; ``small``
and ``xsmall`` serve tests and smaller deployments.  ``num_classes`` adds a
pooled classifier head (the original model has none, though its training
loop computes a class cross-entropy).  ``attention_impl`` is shared with
the JAX package: 'auto' picks the flash kernels on the card for at least
``FLASH_MIN_SEQ_LEN`` patches.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional


@dataclass(unsafe_hash=True)
class ViT2DArgs:
    target_size: int = 384
    patch_size: int = 16
    C_in: int = 3
    d_model: int = 1152
    num_heads: int = 16
    query_groups: int = 8
    softmax_scale: Optional[float] = None
    d_ffn: int = 4608
    num_layers: int = 16
    left_window: int = -1
    right_window: int = -1
    dropout: float = 0.2
    rope_theta: float = 30000.0
    rms_norm_eps: float = 1e-7
    use_checkpointing: bool = True
    use_windowed_attn: bool = True
    use_proj_bias: bool = False
    use_fused_proj: bool = True
    use_mqa: bool = False
    use_qk_norm: bool = True
    # --- framework fields ---
    num_classes: Optional[int] = None  # None => feature encoder [B, N, d]
    pooling: str = "mean"  # 'mean' | 'max' for the classifier head
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    attention_impl: str = "auto"

    def __post_init__(self):
        if self.softmax_scale is None:
            self.softmax_scale = 1.0 / math.sqrt(self.d_model // self.num_heads)
        if self.d_model % self.num_heads != 0:
            raise ValueError("d_model must be divisible by num_heads")
        if self.num_heads % self.query_groups != 0:
            raise ValueError("num_heads must be divisible by query_groups")
        if self.target_size % self.patch_size != 0:
            raise ValueError("target_size must be divisible by patch_size")
        head_dim = self.d_model // self.num_heads
        if head_dim % 4 != 0:
            raise ValueError("head_dim must be divisible by 4 for 2D RoPE")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def grid_size(self) -> int:
        return self.target_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size**2


def vit2d_medium(**overrides) -> ViT2DArgs:
    """Reference medium tier ("320M")."""
    return ViT2DArgs(**overrides)


def vit2d_small(**overrides) -> ViT2DArgs:
    base = dict(
        target_size=224,
        patch_size=16,
        d_model=768,
        num_heads=12,
        query_groups=4,
        d_ffn=3072,
        num_layers=12,
        dropout=0.1,
    )
    base.update(overrides)
    return ViT2DArgs(**base)


def vit2d_xsmall(**overrides) -> ViT2DArgs:
    base = dict(
        target_size=64,
        patch_size=8,
        d_model=128,
        num_heads=4,
        query_groups=2,
        d_ffn=512,
        num_layers=2,
        dropout=0.0,
        use_checkpointing=False,
    )
    base.update(overrides)
    return ViT2DArgs(**base)
