"""Fused text+image+video token-stream configuration.

The port's own copy of ``vats_tpu/configs/multimodal.py`` (that module
imports no JAX): the same fields, defaults, validation (head_dim % 12 == 0,
so that the hd/2 rotation pairs split into the image's two and the video's
three axes) and tiers.  One decoder-only transformer models the stream
[text prompt][image codebook tokens][video codebook tokens] with a single
offset-partitioned vocabulary and one paged KV cache.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional


@dataclass(unsafe_hash=True)
class MultimodalStreamArgs:
    d_model: int = 192
    num_heads: int = 4
    query_groups: int = 2
    d_ffn: int = 512
    num_layers: int = 4
    softmax_scale: Optional[float] = None
    dropout: float = 0.0
    rope_theta: float = 10000.0
    ntk_scale_factor: Optional[float] = 0.7
    rms_norm_eps: float = 1e-5
    # --- fused vocabulary: [0, text) [text, text+image) [.., ..+video) ---
    text_vocab_size: int = 4096
    image_vocab_size: int = 256  # image codebook (ImageGenArgs.num_embeddings)
    video_vocab_size: int = 512  # video codebook (VideoGenArgs.num_embeddings)
    # --- segment shapes ---
    image_grid_h: int = 8
    image_grid_w: int = 8
    video_grid_t: int = 4
    video_grid_h: int = 8
    video_grid_w: int = 8
    max_text_len: int = 128
    # --- module knobs (shared core conventions) ---
    use_proj_bias: bool = False
    use_qkv_proj: bool = True
    use_qk_norm: bool = True
    use_checkpointing: bool = False
    tie_weights: bool = True
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    attention_impl: str = "auto"

    def __post_init__(self):
        if self.softmax_scale is None:
            self.softmax_scale = 1.0 / math.sqrt(self.head_dim)
        if self.d_model % self.num_heads != 0:
            raise ValueError("d_model must be divisible by num_heads")
        if self.num_heads % self.query_groups != 0:
            raise ValueError("num_heads must be divisible by query_groups")
        # hd/2 interleaved pairs must split into 2 (image axial) and
        # 3 (video axial) chunks
        if self.head_dim % 12 != 0:
            raise ValueError(
                "head_dim must be divisible by 12 for fused 1D/2D/3D RoPE"
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def vocab_size(self) -> int:
        return self.text_vocab_size + self.image_vocab_size + self.video_vocab_size

    @property
    def image_tokens(self) -> int:
        return self.image_grid_h * self.image_grid_w

    @property
    def video_tokens(self) -> int:
        return self.video_grid_t * self.video_grid_h * self.video_grid_w

    @property
    def max_seq_len(self) -> int:
        return self.max_text_len + self.image_tokens + self.video_tokens


def multimodal_xsmall(**overrides) -> MultimodalStreamArgs:
    return MultimodalStreamArgs(**overrides)


def multimodal_small(**overrides) -> MultimodalStreamArgs:
    base = dict(
        d_model=768, num_heads=8, query_groups=4, d_ffn=2048, num_layers=12,
        image_grid_h=16, image_grid_w=16, video_grid_t=8,
        video_grid_h=16, video_grid_w=16, max_text_len=256,
    )
    base.update(overrides)
    return MultimodalStreamArgs(**base)
