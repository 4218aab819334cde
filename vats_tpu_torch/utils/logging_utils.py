"""File-handler loggers.

The port's copy of ``vats_tpu/utils/logging_utils.py``, unchanged."""

from __future__ import annotations

import logging
import os
from typing import Optional


def setup_logger(
    name: str,
    log_file: Optional[str] = None,
    level: int = logging.INFO,
    log_dir: str = "logs",
) -> logging.Logger:
    """Named logger writing to ``logs/<name>.log`` (and stderr)."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(
            os.path.join(log_dir, log_file or f"{name}.log")
        )
        fh.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        logger.addHandler(fh)
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter("%(name)s %(levelname)s %(message)s"))
        logger.addHandler(sh)
    return logger
