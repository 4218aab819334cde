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

__all__ = [
    "TrainState",
    "compute_loss",
    "compute_perplexity",
    "cosine_with_warmup_schedule",
    "create_optimizer",
    "create_train_state",
    "eval_step",
    "make_eval_step",
    "make_train_step",
    "make_train_step_fn",
    "train",
    "validate",
]
