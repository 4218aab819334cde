from vats_tpu_torch.utils.convert import (
    params_from_jax,
    train_state_from_jax,
    unstack_scan_params,
)
from vats_tpu_torch.utils.logging_utils import setup_logger
from vats_tpu_torch.utils.profiling import StepTimer, annotate, trace
from vats_tpu_torch.utils.visualization import plot_metrics

__all__ = [
    "StepTimer",
    "annotate",
    "params_from_jax",
    "plot_metrics",
    "setup_logger",
    "trace",
    "train_state_from_jax",
    "unstack_scan_params",
]
