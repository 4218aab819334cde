from vats_tpu_torch.data.augmentations import (
    cutmix_data,
    mixup_data,
    random_augmentation,
)
from vats_tpu_torch.data.feed import device_batches
from vats_tpu_torch.data.synthetic import synthetic_lm_batches
from vats_tpu_torch.data.vision_data import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    array_batches,
    normalize_images,
    setup_data_loaders,
    setup_video_loaders,
)

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "array_batches",
    "cutmix_data",
    "device_batches",
    "mixup_data",
    "normalize_images",
    "random_augmentation",
    "setup_data_loaders",
    "setup_video_loaders",
    "synthetic_lm_batches",
]
