from vats_tpu_torch.inference.generate import TokenGenerator, generate, generate_paged
from vats_tpu_torch.inference.image_generation import (
    ImageGenerationPipeline,
    ImageGenerationSampler,
    generate_image_tokens,
    generate_image_tokens_paged,
)
from vats_tpu_torch.inference.multimodal import generate_multimodal
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
from vats_tpu_torch.inference.video_generation import (
    VideoGenerationPipeline,
    VideoGenerationSampler,
    generate_video_tokens,
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
    "VideoGenerationPipeline",
    "VideoGenerationSampler",
    "apply_repetition_penalty",
    "apply_top_k",
    "apply_top_p",
    "dequantize_params",
    "dequantize_tensor",
    "exact_top_k",
    "generate",
    "generate_image_tokens",
    "generate_image_tokens_paged",
    "generate_multimodal",
    "generate_paged",
    "generate_video_tokens",
    "quantize_params",
    "quantize_tensor",
    "quantized_bytes",
    "sample_logits",
    "sample_logits_per_row",
]
