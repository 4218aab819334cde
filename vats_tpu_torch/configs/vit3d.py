"""ViT-3D video encoder configuration.

The port's own copy of ``vats_tpu/configs/vit3d.py`` (that module imports no
JAX): the same fields, defaults, validation (max_frames % pt == 0, target %
patch == 0, head_dim % 6 == 0 for 3-D RoPE) and tiers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(unsafe_hash=True)
class ViT3DArgs:
    patch_size: Tuple[int, int, int] = (2, 8, 8)
    target_size: Tuple[int, int] = (128, 128)
    max_frames: int = 32
    C_in: int = 3
    d_model: int = 240
    num_heads: int = 4
    query_groups: int = 2
    softmax_scale: Optional[float] = None
    d_ffn: int = 960
    num_layers: int = 4
    window_size: Tuple[int, int] = (128, 128)
    dropout: float = 0.1
    rope_theta: float = 30000.0
    rms_norm_eps: float = 1e-7
    num_classes: int = 1000
    use_checkpointing: bool = False
    use_mqa: bool = False
    use_qk_norm: bool = True
    # --- framework fields ---
    use_classifier_head: bool = False  # the original model has num_classes but
    # no head; set True for the classification train loop
    use_proj_bias: bool = False
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
        pt, ph, pw = self.patch_size
        if self.max_frames % pt != 0:
            raise ValueError("max_frames must be divisible by temporal patch")
        if self.target_size[0] % ph != 0 or self.target_size[1] % pw != 0:
            raise ValueError("target_size must be divisible by spatial patch")
        if (self.d_model // self.num_heads) % 6 != 0:
            raise ValueError("head_dim must be divisible by 6 for 3D RoPE")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        return (
            self.max_frames // self.patch_size[0],
            self.target_size[0] // self.patch_size[1],
            self.target_size[1] // self.patch_size[2],
        )


def vit3d_xsmall(**overrides) -> ViT3DArgs:
    """The original repository's xsmall tier."""
    return ViT3DArgs(**overrides)


def vit3d_large(**overrides) -> ViT3DArgs:
    """The original repository's large tier ("1.3B"): p(2,16,16), 224^2,
    8 frames, d2112, 32H/8G, 20L."""
    base = dict(
        patch_size=(2, 16, 16),
        target_size=(224, 224),
        max_frames=8,
        d_model=2112,
        num_heads=32,
        query_groups=8,
        d_ffn=8448,
        num_layers=20,
        dropout=0.2,
        use_checkpointing=True,
    )
    base.update(overrides)
    return ViT3DArgs(**base)


def vit3d_tiny_test(**overrides) -> ViT3DArgs:
    base = dict(
        patch_size=(2, 8, 8),
        target_size=(32, 32),
        max_frames=8,
        d_model=48,
        num_heads=2,
        query_groups=1,
        d_ffn=96,
        num_layers=2,
        dropout=0.0,
        num_classes=10,
        use_checkpointing=False,
    )
    base.update(overrides)
    return ViT3DArgs(**base)
