from vats_tpu_torch.models.image_gen import (
    VQVAE,
    ARImageTransformerBlock,
    AutoregressiveImageTransformer,
    TransformerTextEncoder,
    VectorQuantizer,
    VQVAEDecoder,
    VQVAEEncoder,
)
from vats_tpu_torch.models.text_lm import TextLM, TransformerBlock
from vats_tpu_torch.models.vit2d import (
    ImageEncoder,
    ImageEncoderTransformer,
    PatchEmbeddings2D,
    SpatialTransformerBlock,
    resize_and_center_crop,
)
from vats_tpu_torch.models.vit3d import (
    PatchEmbeddings3D,
    SpatioTemporalAttention,
    SpatioTemporalAttentionBlock,
    VideoTransformer,
    VideoTransformerBlock,
)

__all__ = [
    "ARImageTransformerBlock",
    "AutoregressiveImageTransformer",
    "ImageEncoder",
    "ImageEncoderTransformer",
    "PatchEmbeddings2D",
    "PatchEmbeddings3D",
    "SpatialTransformerBlock",
    "SpatioTemporalAttention",
    "SpatioTemporalAttentionBlock",
    "TextLM",
    "TransformerBlock",
    "TransformerTextEncoder",
    "VQVAE",
    "VQVAEDecoder",
    "VQVAEEncoder",
    "VectorQuantizer",
    "VideoTransformer",
    "VideoTransformerBlock",
    "resize_and_center_crop",
]
