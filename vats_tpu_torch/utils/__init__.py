"""Conversion from the JAX package's trees, logging, plots and profiling.

Each name is loaded from its module at first use: the layers import
``utils.profiling`` for their spans, and ``utils.convert`` imports the
training package, which imports those layers.
"""

import importlib

_MODULE_OF = {
    "annotate": "profiling",
    "params_from_jax": "convert",
    "plot_metrics": "visualization",
    "setup_logger": "logging_utils",
    "trace": "profiling",
    "train_state_from_jax": "convert",
    "unstack_scan_params": "convert",
}

__all__ = sorted(_MODULE_OF)


def __getattr__(name):
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_MODULE_OF[name]}"), name)
