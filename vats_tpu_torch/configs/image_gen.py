"""Autoregressive text->image generation configuration.

The port's own copy of ``vats_tpu/configs/image_gen.py`` (that module imports
no JAX): the same fields, defaults, validation (head_dim % 4 == 0 for the
2-D RoPE) and tiers.  The text-encoder fields are the JAX package's
additions.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional


@dataclass(unsafe_hash=True)
class ImageGenArgs:
    target_size: int = 256
    d_model: int = 768
    num_heads: int = 32
    query_groups: int = 4
    max_batch_size: int = 32
    softmax_scale: Optional[float] = None
    d_ffn: int = 3072
    num_layers: int = 12
    dropout: float = 0.2
    rope_theta: float = 10000.0
    use_ntk_rope: bool = True
    ntk_scale_factor: float = 0.7
    left_window: int = -1
    right_window: int = -1
    rms_norm_eps: float = 1e-12
    vocab_size: int = 65536  # text vocab
    max_position_embeddings: int = 2048
    use_checkpointing: bool = True
    use_proj_bias: bool = False
    use_qkv_proj: bool = True
    enable_mqa: bool = True
    use_qk_norm: bool = True
    use_causal: bool = True
    use_windowed_attn: bool = True
    vae_encoder_activation: str = "relu"  # 'relu' | 'leaky_relu' | 'sigmoid'
    num_embeddings: int = 256  # VQ codebook size
    commitment_beta: float = 0.7
    C_in_out: int = 3
    # --- text encoder (additive; reference hardcodes at call sites) ---
    text_num_layers: int = 4
    text_num_heads: int = 8
    text_query_groups: int = 4
    text_max_seq_len: int = 128
    # --- framework fields ---
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
        if (self.d_model // self.num_heads) % 4 != 0:
            raise ValueError("head_dim must be divisible by 4 for 2D RoPE")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def image_gen_xsmall(**overrides) -> ImageGenArgs:
    """Reference xsmall tier ("130M")."""
    return ImageGenArgs(**overrides)


def image_gen_tiny_test(**overrides) -> ImageGenArgs:
    base = dict(
        target_size=32,
        d_model=64,
        num_heads=8,
        query_groups=2,
        d_ffn=128,
        num_layers=2,
        dropout=0.0,
        num_embeddings=32,
        vocab_size=128,
        max_position_embeddings=256,
        use_checkpointing=False,
        text_num_layers=1,
        text_num_heads=4,
        text_query_groups=2,
        text_max_seq_len=16,
    )
    base.update(overrides)
    return ImageGenArgs(**base)
