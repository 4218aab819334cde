from vats_tpu_torch.ops.attention_ref import (
    cached_decode_attention,
    dot_product_attention,
    make_attention_mask,
)

__all__ = ["cached_decode_attention", "dot_product_attention", "make_attention_mask"]
