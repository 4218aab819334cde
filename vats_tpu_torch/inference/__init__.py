from vats_tpu_torch.inference.generate import TokenGenerator, generate, generate_paged
from vats_tpu_torch.inference.image_generation import (
    ImageGenerationPipeline,
    ImageGenerationSampler,
    generate_image_tokens,
    generate_image_tokens_paged,
)
from vats_tpu_torch.inference.quantize import (
    QTensor,
    QuantizedModel,
    dequantize_params,
    dequantize_tensor,
    quantize_params,
    quantize_tensor,
    quantized_bytes,
)
from vats_tpu_torch.inference.sampling import (
    apply_repetition_penalty,
    apply_top_k,
    apply_top_p,
    exact_top_k,
    sample_logits,
    sample_logits_per_row,
)
from vats_tpu_torch.inference.serving import (
    PageAllocator,
    PrefixCache,
    Request,
    SamplingParams,
    ServingEngine,
)

__all__ = [
    "ImageGenerationPipeline",
    "ImageGenerationSampler",
    "PageAllocator",
    "PrefixCache",
    "QTensor",
    "QuantizedModel",
    "Request",
    "SamplingParams",
    "ServingEngine",
    "TokenGenerator",
    "apply_repetition_penalty",
    "apply_top_k",
    "apply_top_p",
    "dequantize_params",
    "dequantize_tensor",
    "exact_top_k",
    "generate",
    "generate_image_tokens",
    "generate_image_tokens_paged",
    "generate_paged",
    "quantize_params",
    "quantize_tensor",
    "quantized_bytes",
    "sample_logits",
    "sample_logits_per_row",
]
