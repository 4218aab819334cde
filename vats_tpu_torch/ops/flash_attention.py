"""K2: flash attention forward.

Counterpart of ``vats_tpu/ops/flash_attention.py`` (``_fwd_kernel`` driven
by ``_flash_forward``, entry ``flash_attention``).  The public function keeps
the JAX layouts: q [B, T, Hq, D], k/v [B, S, G, D].  On CUDA tensors it runs
the hand-written kernel in ``csrc/flash_attention.cu``; the head dim is
zero-padded inside the wrapper to the kernel's width (60 -> 64), which is
exact.  On CPU tensors it runs :func:`flash_attention_ref`.

The masking is that of the JAX kernel: causal (which overrides
right_window), left/right windows, a [B, S] key validity mask, segment ids
and ``q_pos_offset``.  Unlike ``dot_product_attention`` a query row that
attends no key outputs 0, not the mean of V; the plain version reproduces
the kernel, not the oracle.

Forward only: the backward kernels (K5) come with training, so a CUDA call
that needs a gradient raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vats_tpu_torch.ops import kernels
from vats_tpu_torch.ops.attention_ref import make_attention_mask

_KERNEL_HEAD_DIMS = (32, 64, 128)


def _segments(q_segment_ids, kv_segment_ids, b, t, s, device):
    """JAX rule: segment masking is on when either id array is given; a
    missing one defaults to zeros."""
    if q_segment_ids is None and kv_segment_ids is None:
        return None, None
    if q_segment_ids is None:
        q_segment_ids = torch.zeros((b, t), dtype=torch.int32, device=device)
    if kv_segment_ids is None:
        kv_segment_ids = torch.zeros((b, s), dtype=torch.int32, device=device)
    return q_segment_ids.to(torch.int32), kv_segment_ids.to(torch.int32)


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool = False,
    left_window: int = -1,
    right_window: int = -1,
    kv_valid: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    q_pos_offset: int = 0,
) -> torch.Tensor:
    """Plain version of K2: masked fp32 softmax attention whose fully masked
    rows output 0.  Same arguments and layouts as :func:`flash_attention`."""
    b, t, hq, d = q.shape
    _, s, g, _ = k.shape
    n = hq // g
    dev = q.device
    q_seg, kv_seg = _segments(q_segment_ids, kv_segment_ids, b, t, s, dev)
    mask = make_attention_mask(
        torch.arange(t, device=dev) + q_pos_offset,
        torch.arange(s, device=dev),
        causal=causal, left_window=left_window, right_window=right_window,
        kv_valid=kv_valid, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
    )
    while mask.dim() < 3:
        mask = mask[None]
    mask = mask.expand(b, t, s)[:, None, None]  # [B, 1, 1, T, S]
    qg = q.reshape(b, t, g, n, d).float()
    scores = torch.einsum("btgnd,bsgd->bgnts", qg, k.float()) * scale
    scores = torch.where(mask, scores, -torch.inf)
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bgnts,bsgd->btgnd", p, v.float())
    return out.reshape(b, t, hq, d).to(q.dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool = False,
    left_window: int = -1,
    right_window: int = -1,
    kv_valid: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    q_pos_offset: int = 0,
) -> torch.Tensor:
    """q: [B, T, Hq, D]; k, v: [B, S, G, D]; kv_valid [B, S] bool (True =
    valid); segment ids [B, T] / [B, S].  Returns [B, T, Hq, D] in q.dtype."""
    b, t, hq, d = q.shape
    _, s, g, _ = k.shape
    if hq % g != 0:
        raise ValueError(f"num q heads ({hq}) % kv groups ({g}) != 0")
    kw = dict(
        scale=scale, causal=causal, left_window=left_window,
        right_window=right_window, kv_valid=kv_valid,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        q_pos_offset=q_pos_offset,
    )
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, **kw)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward on CUDA yet (kernel K5, a later "
            "slice: see ROADMAP.md); call it under torch.no_grad()"
        )
    dt = q.dtype
    kernels.require(dt in _ENTRY, f"unsupported dtype {dt}")
    dp = next((w for w in _KERNEL_HEAD_DIMS if w >= d), None)
    kernels.require(dp is not None, f"head dim {d} > {_KERNEL_HEAD_DIMS[-1]}")

    def prep(x):
        x = x.to(dt)
        if x.shape[-1] != dp:
            x = torch.nn.functional.pad(x, (0, dp - x.shape[-1]))
        return x.contiguous()

    qp, kp, vp = prep(q), prep(k), prep(v)
    if kv_valid is None:
        valid = torch.ones((b, s), dtype=torch.int32, device=q.device)
    else:
        valid = kv_valid.to(torch.int32).contiguous()
    q_seg, kv_seg = _segments(q_segment_ids, kv_segment_ids, b, t, s, q.device)
    use_segids = q_seg is not None
    if use_segids:
        q_seg, kv_seg = q_seg.contiguous(), kv_seg.contiguous()
        kernels.check_cuda_tensor(q_seg, "q_segment_ids", shape=(b, t))
        kernels.check_cuda_tensor(kv_seg, "kv_segment_ids", shape=(b, s))
    kernels.check_cuda_tensor(kp, "k", shape=(b, s, g, dp))
    kernels.check_cuda_tensor(vp, "v", shape=(b, s, g, dp))
    kernels.check_cuda_tensor(valid, "kv_valid", shape=(b, s))
    out = torch.empty((b, t, hq, dp), dtype=dt, device=q.device)
    lib = _lib()
    rc = getattr(lib, _ENTRY[dt])(
        kernels.ptr(qp), kernels.ptr(kp), kernels.ptr(vp), kernels.ptr(valid),
        kernels.ptr(q_seg) if use_segids else None,
        kernels.ptr(kv_seg) if use_segids else None,
        kernels.ptr(out), b, t, s, hq, g, dp, ctypes.c_float(scale),
        int(causal), int(left_window), int(right_window), int(q_pos_offset),
        int(use_segids), kernels.stream_ptr(q),
    )
    kernels.check(lib, rc, "flash_attention")
    flash_attention.launches += 1
    return out[..., :d] if dp != d else out


flash_attention.launches = 0

_ENTRY = {
    torch.bfloat16: "vats_flash_fwd_bf16",
    torch.float32: "vats_flash_fwd_f32",
}


def _lib() -> ctypes.CDLL:
    lib = kernels.load("flash_attention")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
            + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib
