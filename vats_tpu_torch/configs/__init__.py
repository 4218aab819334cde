from vats_tpu_torch.configs.image_gen import (
    ImageGenArgs,
    image_gen_tiny_test,
    image_gen_xsmall,
)
from vats_tpu_torch.configs.multimodal import (
    MultimodalStreamArgs,
    multimodal_small,
    multimodal_xsmall,
)
from vats_tpu_torch.configs.nlp import (
    NLP_TIERS,
    GenerationArgs,
    HybridModelArgs,
    ModelArgs,
    TrainingArgs,
    layer_attention,
    mellum2_12b,
    nlp_large,
    nlp_medium,
    nlp_small,
    nlp_xlarge,
    nlp_xsmall,
    validate_model_args,
)
from vats_tpu_torch.configs.video_gen import (
    VideoGenArgs,
    video_gen_large,
    video_gen_tiny_test,
    video_gen_xsmall,
)
from vats_tpu_torch.configs.vit2d import (
    ViT2DArgs,
    vit2d_medium,
    vit2d_small,
    vit2d_xsmall,
)
from vats_tpu_torch.configs.vit3d import (
    ViT3DArgs,
    vit3d_large,
    vit3d_tiny_test,
    vit3d_xsmall,
)

__all__ = [
    "NLP_TIERS",
    "GenerationArgs",
    "HybridModelArgs",
    "ImageGenArgs",
    "ModelArgs",
    "MultimodalStreamArgs",
    "TrainingArgs",
    "VideoGenArgs",
    "ViT2DArgs",
    "ViT3DArgs",
    "image_gen_tiny_test",
    "image_gen_xsmall",
    "layer_attention",
    "mellum2_12b",
    "multimodal_small",
    "multimodal_xsmall",
    "nlp_large",
    "nlp_medium",
    "nlp_small",
    "nlp_xlarge",
    "nlp_xsmall",
    "validate_model_args",
    "video_gen_large",
    "video_gen_tiny_test",
    "video_gen_xsmall",
    "vit2d_medium",
    "vit2d_small",
    "vit2d_xsmall",
    "vit3d_large",
    "vit3d_tiny_test",
    "vit3d_xsmall",
]
