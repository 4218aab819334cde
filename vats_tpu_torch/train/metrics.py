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


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with fp32 output from bf16 (or fp16) operands: products exact,
    sums in fp32.  On the card one GEMM with fp32 output; on the CPU the
    operands upcast to fp32, which holds them exactly."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _ReadoutF32(torch.autograd.Function):
    """logits = a @ w_lp^T in fp32 from low-precision a [M, d] and w_lp
    [V, d] (``w`` cast once), as JAX's ``preferred_element_type=float32``.

    The backward rounds the fp32 dlogits to a's dtype and takes both
    products with fp32 output; each gradient is rounded to the operand's
    dtype, as JAX's gradients of its bf16 operands are.  dw is returned in
    ``w``'s own dtype, so autograd sums the chunks' bf16 gradients in it
    (fp32 for an fp32 readout), as the JAX scan does.  JAX keeps dlogits in
    fp32 for those products; rounding them is the fast choice (two bf16
    GEMMs, no fp32 one), about one bf16 ulp of the largest gradient."""

    @staticmethod
    def forward(ctx, a, w, w_lp):
        ctx.save_for_backward(a, w_lp)
        ctx.w_dtype = w.dtype
        return _mm_f32(a, w_lp.t())

    @staticmethod
    def backward(ctx, dlogits):
        a, w_lp = ctx.saved_tensors
        g = dlogits.to(a.dtype)
        da = _mm_f32(g, w_lp).to(a.dtype)
        dw = _mm_f32(g.t(), a).to(w_lp.dtype).to(ctx.w_dtype)
        return da, dw, None


def _chunk_nll(
    h_c: torch.Tensor, y_c: torch.Tensor, w: torch.Tensor, w_lp: torch.Tensor
) -> torch.Tensor:
    """Summed NLL of one chunk: [B, c, V] fp32 logits exist only in here.
    w: the readout; w_lp: it in the compute dtype."""
    if w_lp.dtype == torch.float32:
        logits = F.linear(h_c.float(), w_lp)
    else:
        b, c, d = h_c.shape
        a = h_c.to(w_lp.dtype).reshape(b * c, d)
        logits = _ReadoutF32.apply(a, w, w_lp).reshape(b, c, -1)
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
    The product takes its operands in ``compute_dtype`` and gives fp32
    logits, as the JAX version asks XLA for fp32 output from the same bf16
    product (``_ReadoutF32``: one GEMM with fp32 output on the card, never
    an fp32 GEMM).  Plain PyTorch: no Pallas kernel here."""
    b, t, d = hidden.shape
    pad = (-t) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=IGNORE_INDEX)
    if compute_dtype == torch.float32:
        w = w_lp = readout.float()  # its gradient flows to readout
    else:
        w, w_lp = readout, readout.detach().to(compute_dtype)  # cast once
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, t + pad, chunk):
        h_c, y_c = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_nll, h_c, y_c, w, w_lp, use_reentrant=False)
        else:
            total = total + _chunk_nll(h_c, y_c, w, w_lp)
    return total / (labels != IGNORE_INDEX).sum().clamp(min=1)
