from vats_tpu_torch.inference.generate import TokenGenerator, generate, generate_paged
from vats_tpu_torch.inference.sampling import (
    apply_repetition_penalty,
    apply_top_k,
    apply_top_p,
    exact_top_k,
    sample_logits,
)

__all__ = [
    "TokenGenerator",
    "apply_repetition_penalty",
    "apply_top_k",
    "apply_top_p",
    "exact_top_k",
    "generate",
    "generate_paged",
    "sample_logits",
]
