"""Device selection shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The card unless the caller asks otherwise; raise if it is missing.

    ``None`` means ``"cuda"``.  A CUDA device without a visible GPU raises
    instead of carrying on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


def resolve_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]
