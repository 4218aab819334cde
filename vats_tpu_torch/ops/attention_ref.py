"""Plain PyTorch attention: counterpart of ``vats_tpu/ops/attention_xla.py``.

One masked attention covering causal masking, left/right sliding windows,
key validity and segment ids, with grouped KV heads folded into the einsum
(K/V are never repeated per query head).  Scores and softmax run in float32
whatever the input dtype; masked scores take -0.7 * fp32max (not -inf, so
no exp(-inf - -inf) NaNs), and a fully masked row softmaxes to uniform
weights, as the JAX oracle does.  The dense-cache prefill and decode
attention of the model run here, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def make_attention_mask(
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    *,
    causal: bool,
    left_window: int = -1,
    right_window: int = -1,
    kv_valid: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Boolean [B, T, S] (or [T, S]) mask; True = attend.

    q_positions [T] or [B, T]; kv_positions [S] or [B, S]; kv_valid [B, S].
    Causal attention forces right_window 0 (keys after the query are
    masked whatever right_window says)."""
    q = q_positions[..., :, None]
    k = kv_positions[..., None, :]
    shape = torch.broadcast_shapes(q.shape, k.shape)
    mask = torch.ones(shape, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k <= q)
    elif right_window >= 0:
        mask = mask & ((k - q) <= right_window)
    if left_window >= 0:
        mask = mask & ((q - k) <= left_window)
    if kv_valid is not None:
        mask = mask & kv_valid.bool()[..., None, :]
    if q_segment_ids is not None and kv_segment_ids is not None:
        mask = mask & (q_segment_ids[..., :, None] == kv_segment_ids[..., None, :])
    return mask


def _masked_softmax_pv(scores, mask, v_eq, vf, mask_value):
    while mask.dim() < 3:
        mask = mask[None]
    scores = torch.where(mask[:, None, None, :, :], scores, mask_value)
    scores_max = scores.amax(dim=-1, keepdim=True)
    unnorm = torch.exp(scores - scores_max)
    denom = unnorm.sum(dim=-1, keepdim=True)
    probs = unnorm / torch.clamp(denom, min=1e-30)
    return torch.einsum(v_eq, probs, vf)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool = False,
    left_window: int = -1,
    right_window: int = -1,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    kv_valid: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> torch.Tensor:
    """q: [B, T, Hq, hd]; k, v: [B, S, G, hd] -> [B, T, Hq, hd] in q.dtype."""
    b, t, hq, hd = q.shape
    _, s, g, _ = k.shape
    if hq % g != 0:
        raise ValueError(f"num q heads ({hq}) must be divisible by kv groups ({g})")
    n = hq // g
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(t, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(s, device=dev)
    qg = q.reshape(b, t, g, n, hd).float()
    scores = torch.einsum("btgnd,bsgd->bgnts", qg, k.float()) * scale
    mask = make_attention_mask(
        q_positions, kv_positions, causal=causal, left_window=left_window,
        right_window=right_window, kv_valid=kv_valid,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
    )
    out = _masked_softmax_pv(scores, mask, "bgnts,bsgd->btgnd", v.float(), mask_value)
    return out.reshape(b, t, hq, hd).to(q.dtype)


def cached_decode_attention(
    q: torch.Tensor,
    k_t: torch.Tensor,
    v_t: torch.Tensor,
    *,
    scale: float,
    causal: bool = True,
    left_window: int = -1,
    right_window: int = -1,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    kv_valid: Optional[torch.Tensor] = None,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> torch.Tensor:
    """Attention over the dense cache's sequence-minor layout.

    q: [B, T, Hq, hd]; k_t, v_t: [B, G, hd, S] (``KVCache.layer_t``)."""
    b, t, hq, hd = q.shape
    _, g, _, s = k_t.shape
    if hq % g != 0:
        raise ValueError(f"num q heads ({hq}) must be divisible by kv groups ({g})")
    n = hq // g
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(t, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(s, device=dev)
    qg = q.reshape(b, t, g, n, hd).float()
    scores = torch.einsum("btgnd,bgds->bgnts", qg, k_t.float()) * scale
    mask = make_attention_mask(
        q_positions, kv_positions, causal=causal, left_window=left_window,
        right_window=right_window, kv_valid=kv_valid,
    )
    out = _masked_softmax_pv(scores, mask, "bgnts,bgds->btgnd", v_t.float(), mask_value)
    return out.reshape(b, t, hq, hd).to(q.dtype)
