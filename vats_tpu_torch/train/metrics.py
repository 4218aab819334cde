"""Loss and perplexity.

Counterpart of ``vats_tpu/train/metrics.py``: cross-entropy over labels
that are not -100 (labels arrive shifted by the data pipeline), plus
``aux_loss_weight * aux_loss``; perplexity = exp(lm_loss).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

IGNORE_INDEX = -100


def compute_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    aux_loss: Optional[torch.Tensor] = None,
    aux_loss_weight: float = 0.01,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits [B, T, V], labels [B, T] int (-100 = ignore) -> (total,
    lm_loss, aux_loss): the mean CE over the labelled tokens."""
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    lm_loss = nll.sum() / valid.sum().clamp(min=1)
    if aux_loss is None:
        aux_loss = torch.zeros((), dtype=torch.float32, device=logits.device)
    return lm_loss + aux_loss_weight * aux_loss, lm_loss, aux_loss


def compute_perplexity(loss: Union[torch.Tensor, float]) -> float:
    return math.exp(float(loss))


def _chunk_nll(h_c: torch.Tensor, y_c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Summed NLL of one chunk: [B, c, V] logits exist only in here."""
    logits = F.linear(h_c.to(w.dtype), w).float()
    valid = y_c != IGNORE_INDEX
    safe = torch.where(valid, y_c, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, safe[..., None])[..., 0]
    return torch.where(valid, lse - tgt, 0.0).sum()


def fused_linear_cross_entropy(
    hidden: torch.Tensor,
    readout: torch.Tensor,
    labels: torch.Tensor,
    *,
    chunk: int = 128,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Mean CE of ``softmax(hidden @ readout^T)`` without the [B, T, V]
    logits: each ``chunk`` of positions computes its readout product and
    log-softmax under ``torch.utils.checkpoint`` (recomputed in the
    backward), so at most one chunk's [B, chunk, V] fp32 logits exist.

    hidden [B, T, d] (after the final norm); readout [V, d] (the tied
    embedding, or the lm_head weight); labels [B, T] with -100 ignored.
    The product runs in ``compute_dtype`` and its output is in that dtype
    before the fp32 log-softmax (the JAX kernel asks XLA for fp32 output
    from the same bf16 product).  Plain PyTorch: no Pallas kernel here."""
    b, t, d = hidden.shape
    pad = (-t) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=IGNORE_INDEX)
    w = readout.to(compute_dtype)  # cast once; its gradient flows to readout
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, t + pad, chunk):
        h_c, y_c = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_nll, h_c, y_c, w, use_reentrant=False)
        else:
            total = total + _chunk_nll(h_c, y_c, w)
    return total / (labels != IGNORE_INDEX).sum().clamp(min=1)
