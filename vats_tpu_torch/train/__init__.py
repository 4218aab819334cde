from vats_tpu_torch.train.image_gen import ImageGenTrainer, ImageGenTrainingArgs
from vats_tpu_torch.train.optimizer import (
    cosine_with_warmup_schedule,
    create_optimizer,
)
from vats_tpu_torch.train.metrics import compute_loss, compute_perplexity
from vats_tpu_torch.train.state import TrainState, create_train_state
from vats_tpu_torch.train.loop import (
    eval_step,
    make_eval_step,
    make_train_step,
    make_train_step_fn,
    train,
    validate,
)
from vats_tpu_torch.train.video_gen import (
    VideoGenTrainingArgs,
    VideoTokenTrainer,
    VQVAE3DTrainer,
)
from vats_tpu_torch.train.vision import (
    VisionTrainingArgs,
    create_vision_optimizer,
    make_vision_eval_step,
    make_vision_train_step,
    smoothed_ce,
    train_epoch,
    validate_epoch,
    warmup_cosine_epoch_schedule,
)

__all__ = [
    "ImageGenTrainer",
    "ImageGenTrainingArgs",
    "TrainState",
    "VQVAE3DTrainer",
    "VideoGenTrainingArgs",
    "VideoTokenTrainer",
    "VisionTrainingArgs",
    "compute_loss",
    "compute_perplexity",
    "cosine_with_warmup_schedule",
    "create_optimizer",
    "create_train_state",
    "create_vision_optimizer",
    "eval_step",
    "make_eval_step",
    "make_train_step",
    "make_train_step_fn",
    "make_vision_eval_step",
    "make_vision_train_step",
    "smoothed_ce",
    "train",
    "train_epoch",
    "validate",
    "validate_epoch",
    "warmup_cosine_epoch_schedule",
]
