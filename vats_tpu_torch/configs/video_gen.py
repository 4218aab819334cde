"""Autoregressive text->video generation configuration.

The port's own copy of ``vats_tpu/configs/video_gen.py`` (that module imports
no JAX): the same fields, defaults, validation (head_dim % 6 == 0 for the
3-D NTK RoPE) and tiers.  ``video_gen_large`` is d1728, 20 layers, 12 query
heads over 4 groups of head dim 144, a 16 x 16 latent grid, 15 latent frames
and 256 codes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(unsafe_hash=True)
class VideoGenArgs:
    patch_size: Tuple[int, int, int] = (2, 4, 4)
    max_frames: int = 10
    d_model: int = 144
    num_heads: int = 8
    query_groups: int = 4
    max_batch_size: int = 32
    softmax_scale: Optional[float] = None
    d_ffn: int = 512
    num_layers: int = 4
    dropout: float = 0.1
    rope_theta: float = 10000.0
    use_ntk_rope: bool = True
    ntk_scale_factor: float = 0.7
    left_window: int = -1
    right_window: int = -1
    rms_norm_eps: float = 1e-5
    vocab_size: int = 4096  # text vocab
    max_position_embeddings: int = 256
    use_checkpointing: bool = True
    use_proj_bias: bool = False
    use_qkv_proj: bool = False
    use_mqa: bool = False
    use_qk_norm: bool = True
    use_causal: bool = True
    use_windowed_attn: bool = True
    vae_encoder_activation: str = "relu"
    num_embeddings: int = 512
    commitment_beta: float = 0.7
    C_in_out: int = 3
    # latent spatial grid for the transformer (frames are patchified by the
    # 3D VQ-VAE before token modeling)
    latent_height: int = 8
    latent_width: int = 8
    # --- text encoder ---
    text_num_layers: int = 2
    text_num_heads: int = 4
    text_query_groups: int = 2
    # --- framework ---
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
        if self.use_ntk_rope and (self.d_model // self.num_heads) % 6 != 0:
            raise ValueError(
                "head_dim must be divisible by 6 for real 3D NTK RoPE "
                "(set use_ntk_rope=False to disable positional encoding, "
                "matching the reference's stub behavior)"
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def video_gen_xsmall(**overrides) -> VideoGenArgs:
    """Reference xsmall scale with a RoPE-compatible head_dim (144/8=18)."""
    return VideoGenArgs(**overrides)


def video_gen_large(**overrides) -> VideoGenArgs:
    """Reference 'large' scale ("1.2B" claim) with sane heads: d=1752 is kept
    but heads=12 (head_dim 146 -> adjusted to 1752/12=146 not %6... use
    d=1728, 12 heads, head_dim 144)."""
    base = dict(
        patch_size=(2, 8, 8),
        max_frames=30,
        d_model=1728,
        num_heads=12,
        query_groups=4,
        d_ffn=6912,
        num_layers=20,
        dropout=0.2,
        num_embeddings=256,
        latent_height=16,
        latent_width=16,
        use_checkpointing=True,
    )
    base.update(overrides)
    return VideoGenArgs(**base)


def video_gen_tiny_test(**overrides) -> VideoGenArgs:
    base = dict(
        patch_size=(2, 4, 4),
        max_frames=4,
        d_model=48,
        num_heads=4,
        query_groups=2,
        d_ffn=96,
        num_layers=2,
        dropout=0.0,
        num_embeddings=32,
        vocab_size=64,
        latent_height=4,
        latent_width=4,
        use_checkpointing=False,
        text_num_layers=1,
    )
    base.update(overrides)
    return VideoGenArgs(**base)
