from vats_tpu_torch.nn.attention import (
    FLASH_MIN_SEQ_LEN,
    Attention,
    AttentionBlock,
    select_attention_impl,
)
from vats_tpu_torch.nn.activations import FFNBlock, SwiGLU
from vats_tpu_torch.nn.cross_attention import CrossAttention, CrossAttentionBlock
from vats_tpu_torch.nn.kv_cache import KVCache, ring_slots_for_window
from vats_tpu_torch.nn.moe import ExpertSwiGLU, MoEBlock, MoELayer, TopKRouter
from vats_tpu_torch.nn.norms import RMSNorm, l2_normalize
from vats_tpu_torch.nn.rope import (
    apply_rope_1d,
    apply_rope_2d_axial,
    apply_rope_2d_ntk,
    apply_rope_2d_ntk_positions,
    apply_rope_3d_axial,
    apply_rope_3d_ntk_positions,
    apply_rope_interleaved,
    grid_positions_2d,
    rope_2d_ntk_cos_sin,
    rope_3d_ntk_cos_sin,
    rope_cos_sin,
    rope_inv_freq,
)

__all__ = [
    "FFNBlock",
    "FLASH_MIN_SEQ_LEN",
    "Attention",
    "AttentionBlock",
    "CrossAttention",
    "CrossAttentionBlock",
    "ExpertSwiGLU",
    "KVCache",
    "MoEBlock",
    "MoELayer",
    "RMSNorm",
    "SwiGLU",
    "TopKRouter",
    "apply_rope_1d",
    "apply_rope_2d_axial",
    "apply_rope_2d_ntk",
    "apply_rope_2d_ntk_positions",
    "apply_rope_3d_axial",
    "apply_rope_3d_ntk_positions",
    "apply_rope_interleaved",
    "grid_positions_2d",
    "l2_normalize",
    "ring_slots_for_window",
    "rope_2d_ntk_cos_sin",
    "rope_3d_ntk_cos_sin",
    "rope_cos_sin",
    "rope_inv_freq",
    "select_attention_impl",
]
