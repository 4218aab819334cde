from vats_tpu_torch.nn.attention import (
    FLASH_MIN_SEQ_LEN,
    Attention,
    AttentionBlock,
    select_attention_impl,
)
from vats_tpu_torch.nn.kv_cache import KVCache, ring_slots_for_window
from vats_tpu_torch.nn.moe import ExpertSwiGLU, MoEBlock, MoELayer, TopKRouter
from vats_tpu_torch.nn.norms import RMSNorm, l2_normalize
from vats_tpu_torch.nn.rope import (
    apply_rope_1d,
    apply_rope_interleaved,
    rope_cos_sin,
    rope_inv_freq,
)

__all__ = [
    "FLASH_MIN_SEQ_LEN",
    "Attention",
    "AttentionBlock",
    "ExpertSwiGLU",
    "KVCache",
    "MoEBlock",
    "MoELayer",
    "RMSNorm",
    "TopKRouter",
    "apply_rope_1d",
    "apply_rope_interleaved",
    "l2_normalize",
    "ring_slots_for_window",
    "rope_cos_sin",
    "rope_inv_freq",
    "select_attention_impl",
]
