"""PyTorch / CUDA port of ``vats_tpu`` for one NVIDIA H100.

Mirrors ``vats_tpu``'s subpackages (``configs nn ops models inference
train data utils``).  Entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``; without a card they raise.  The TPU's Pallas
kernels are hand-written CUDA C++ under ``csrc/``, built at first use and
bound with ``ctypes`` (``ops/kernels.py``).
"""

from vats_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
