"""RMSNorm with a forced-fp32 numerical island, and the L2 QK-norm.

Counterpart of ``vats_tpu/nn/norms.py``:
``weight * x / sqrt(mean(x^2, -1) + eps)`` computed in float32, then cast to
the module's compute dtype.
"""

from __future__ import annotations

import torch
from torch import nn


class RMSNorm(nn.Module):
    def __init__(
        self,
        features: int,
        eps: float = 1e-7,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.features = features
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.ones(features, dtype=param_dtype, device=device)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.features:
            raise ValueError(
                f"RMSNorm expected last dim {self.features}, got {x.shape[-1]}"
            )
        x32 = x.float()
        rms = torch.sqrt(x32.square().mean(dim=-1, keepdim=True) + self.eps)
        return (self.weight.float() * (x32 / rms)).to(self.dtype)


def l2_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """L2-normalize over the last axis: ``x / max(||x||, eps)`` in fp32."""
    x32 = x.float()
    sq = x32.square().sum(dim=-1, keepdim=True)
    norm = torch.sqrt(torch.clamp(sq, min=eps * eps))
    return (x32 / norm).to(x.dtype)
