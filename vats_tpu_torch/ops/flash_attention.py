"""K2, K2', K5a and K5b: flash attention forward and backward.

Counterpart of ``vats_tpu/ops/flash_attention.py``.  The public functions
keep the JAX layouts: q [B, T, Hq, D], k/v [B, S, G, D].

  * :func:`flash_attention` (entry ``flash_attention``): without a gradient,
    K2 (``_fwd_kernel``) on CUDA tensors; with one, the autograd Function
    :class:`FlashAttentionFn` (``_flash_fwd_rule`` / ``_flash_bwd_rule``),
    on the card and on the CPU alike.
  * :func:`flash_attention_lse` (K2', ``_fwd_kernel_lse``): the output and
    each row's logsumexp, fp32 [B, Hq, T] (the JAX kernel keeps it
    replicated over 8 sublanes, [B, Hq, 8, T]); 1e30 for a row that attends
    no key.
  * :func:`flash_attention_bwd` (``_flash_bwd_kernels``): dq per query head
    (K5b, ``_bwd_dq_kernel``) and dk/dv summed per KV group (K5a,
    ``_bwd_dkv_kernel``), fp32, from an lse and di = sum(do * o) supplied
    by the caller, as ring attention supplies them.

On CUDA tensors each runs its kernel from ``csrc/flash_attention.cu`` or
``csrc/flash_backward.cu``; the head dim is zero-padded inside the wrapper
to the kernel's width (60 -> 64), which is exact.  On CPU tensors each runs
its plain version (``*_ref``).  A wrapper launches or raises on a CUDA
tensor; it never hands the work to the plain version.

The masking is that of the JAX kernel: causal (which overrides
right_window), left/right windows, a [B, S] key validity mask, segment ids
and ``q_pos_offset``.  Unlike ``dot_product_attention`` a query row that
attends no key outputs 0, not the mean of V; the plain versions reproduce
the kernels, not the oracle.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from vats_tpu_torch.ops import kernels
from vats_tpu_torch.ops.attention_ref import make_attention_mask

_KERNEL_HEAD_DIMS = (32, 64, 128)
#: logsumexp of a row that attends no key (``_fwd_kernel_lse``'s sentinel)
LSE_EMPTY_ROW = 1e30


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


def _kernel_head_dim(d: int) -> int:
    """The kernels' head dim for a logical one (zero-padding is exact); a
    head dim past the widest kernel keeps its width (the plain versions take
    any)."""
    return next((w for w in _KERNEL_HEAD_DIMS if w >= d), d)


def _pad_head(x: torch.Tensor, dp: int) -> torch.Tensor:
    return x if x.shape[-1] == dp else F.pad(x, (0, dp - x.shape[-1]))


def _mask(b, t, s, *, causal, left_window, right_window, kv_valid, q_seg,
          kv_seg, q_pos_offset, device):
    """[B, 1, 1, T, S] bool: key j attended by query i."""
    mask = make_attention_mask(
        torch.arange(t, device=device) + q_pos_offset,
        torch.arange(s, device=device),
        causal=causal, left_window=left_window, right_window=right_window,
        kv_valid=kv_valid, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
    )
    while mask.dim() < 3:
        mask = mask[None]
    return mask.expand(b, t, s)[:, None, None]


def flash_attention_lse_ref(
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2': masked fp32 softmax attention whose fully masked
    rows output 0, and the row logsumexp [B, Hq, T] (1e30 on such rows).

    The JAX kernel's arithmetic: the normaliser sums the fp32 p, and p is
    rounded to v's dtype before the product with v (a no-op for fp32)."""
    b, t, hq, d = q.shape
    _, s, g, _ = k.shape
    n = hq // g
    q_seg, kv_seg = _segments(q_segment_ids, kv_segment_ids, b, t, s, q.device)
    mask = _mask(b, t, s, causal=causal, left_window=left_window,
                 right_window=right_window, kv_valid=kv_valid, q_seg=q_seg,
                 kv_seg=kv_seg, q_pos_offset=q_pos_offset, device=q.device)
    qg = q.reshape(b, t, g, n, d).float()
    scores = torch.einsum("btgnd,bsgd->bgnts", qg, k.float()) * scale
    scores = torch.where(mask, scores, -torch.inf)
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    p_v = p.to(v.dtype).float()
    out = torch.einsum("bgnts,bsgd->btgnd", p_v / torch.where(l == 0.0, 1.0, l),
                       v.float())
    lse = torch.where(l == 0.0, LSE_EMPTY_ROW, m + torch.log(l))[..., 0]
    return out.reshape(b, t, hq, d).to(q.dtype), lse.reshape(b, hq, t)


def flash_attention_ref(q, k, v, **kw) -> torch.Tensor:
    """Plain version of K2: the output of :func:`flash_attention_lse_ref`.
    Same arguments and layouts as :func:`flash_attention`."""
    return flash_attention_lse_ref(q, k, v, **kw)[0]


def flash_attention_bwd_ref(
    q, k, v, do, lse, di, kv_valid=None, q_seg=None, kv_seg=None, *,
    scale: float, causal: bool = False, left_window: int = -1,
    right_window: int = -1, q_pos_offset: int = 0,
):
    """Plain version of K5a + K5b: (dq [B,T,Hq,D], dk, dv [B,S,G,D]), fp32,
    with p rebuilt from ``lse`` and ``di`` = sum(do * o) per row, both
    [B, Hq, T] fp32.  Same arguments as :func:`flash_attention_bwd`.

    The JAX kernels' arithmetic: ds is formed from the fp32 p, and p (for dV)
    and ds (for dK and dQ) are rounded to the input dtype before their
    products (a no-op for fp32)."""
    b, t, hq, d = q.shape
    _, s, g, _ = k.shape
    n = hq // g
    q_seg, kv_seg = _segments(q_seg, kv_seg, b, t, s, q.device)
    mask = _mask(b, t, s, causal=causal, left_window=left_window,
                 right_window=right_window, kv_valid=kv_valid, q_seg=q_seg,
                 kv_seg=kv_seg, q_pos_offset=q_pos_offset, device=q.device)
    qg = q.reshape(b, t, g, n, d).float()
    dog = do.reshape(b, t, g, n, d).float()
    kf, vf = k.float(), v.float()
    lse5 = lse.float().reshape(b, g, n, t)[..., None]
    di5 = di.float().reshape(b, g, n, t)[..., None]
    scores = torch.einsum("btgnd,bsgd->bgnts", qg, kf) * scale
    p = torch.where(mask, torch.exp(torch.where(mask, scores, 0.0) - lse5), 0.0)
    dv = torch.einsum("bgnts,btgnd->bsgd", p.to(do.dtype).float(), dog)
    dp = torch.einsum("btgnd,bsgd->bgnts", dog, vf)
    ds = (p * (dp - di5) * scale).to(q.dtype).float()
    dq = torch.einsum("bgnts,bsgd->btgnd", ds, kf).reshape(b, t, hq, d)
    dk = torch.einsum("bgnts,btgnd->bsgd", ds, qg)
    return dq, dk, dv


# --- K2 / K2' ----------------------------------------------------------------


def _launch_fwd(q, k, v, kw, want_lse: bool):
    """One launch of csrc/flash_attention.cu; returns (out, lse or None)."""
    b, t, hq, d = q.shape
    _, s, g, _ = k.shape
    kernels.require(hq % g == 0, f"num q heads ({hq}) % kv groups ({g}) != 0")
    dt = q.dtype
    kernels.require(dt in _FWD_ENTRY, f"unsupported dtype {dt}")
    dp = _kernel_head_dim(d)
    kernels.require(dp in _KERNEL_HEAD_DIMS, f"head dim {d} > {_KERNEL_HEAD_DIMS[-1]}")
    qp, kp, vp = (_aligned(_pad_head(x.to(dt), dp).contiguous()) for x in (q, k, v))
    valid, q_seg, kv_seg = _mask_args(kw, b, t, s, q.device)
    kernels.check_cuda_tensor(kp, "k", shape=(b, s, g, dp))
    kernels.check_cuda_tensor(vp, "v", shape=(b, s, g, dp))
    out = torch.empty((b, t, hq, dp), dtype=dt, device=q.device)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device) if want_lse else None
    lib = _lib()
    rc = getattr(lib, _FWD_ENTRY[dt])(
        kernels.ptr(qp), kernels.ptr(kp), kernels.ptr(vp), kernels.ptr(valid),
        _opt_ptr(q_seg), _opt_ptr(kv_seg), kernels.ptr(out), _opt_ptr(lse),
        b, t, s, hq, g, dp, ctypes.c_float(kw["scale"]), int(kw["causal"]),
        int(kw["left_window"]), int(kw["right_window"]), int(kw["q_pos_offset"]),
        int(q_seg is not None), kernels.stream_ptr(q),
    )
    kernels.check(lib, rc, "flash_attention_lse" if want_lse else "flash_attention")
    return (out[..., :d] if dp != d else out), lse


def _opt_ptr(t):
    return kernels.ptr(t) if t is not None else None


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x, copied if its data is not 16-byte aligned (the bf16 kernels load
    tiles with TMA, the fp32 ones with 16-byte vectors)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _mask_args(kw, b, t, s, device):
    """int32 [B, S] validity and contiguous segment ids for a kernel."""
    kv_valid = kw.get("kv_valid")
    if kv_valid is None:
        valid = torch.ones((b, s), dtype=torch.int32, device=device)
    else:
        valid = kv_valid.to(torch.int32).contiguous()
    kernels.check_cuda_tensor(valid, "kv_valid", shape=(b, s))
    q_seg, kv_seg = _segments(kw.get("q_segment_ids"), kw.get("kv_segment_ids"),
                              b, t, s, device)
    if q_seg is not None:
        q_seg, kv_seg = q_seg.contiguous(), kv_seg.contiguous()
        kernels.check_cuda_tensor(q_seg, "q_segment_ids", shape=(b, t))
        kernels.check_cuda_tensor(kv_seg, "kv_segment_ids", shape=(b, s))
    return valid, q_seg, kv_seg


def flash_attention_lse(
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2': (out [B, T, Hq, D] in q.dtype, lse [B, Hq, T] fp32)."""
    kw = dict(scale=scale, causal=causal, left_window=left_window,
              right_window=right_window, kv_valid=kv_valid,
              q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
              q_pos_offset=q_pos_offset)
    if not q.is_cuda:
        return flash_attention_lse_ref(q, k, v, **kw)
    out, lse = _launch_fwd(q, k, v, kw, want_lse=True)
    kernels.count_launch(flash_attention_lse)
    return out, lse


flash_attention_lse.launches = 0


# --- K5a / K5b ---------------------------------------------------------------


def _launch_bwd(which, q, k, v, do, lse, di, kw):
    """One launch of csrc/flash_backward.cu: 'dq' -> dq; 'dkv' -> (dk, dv);
    fp32 at the kernel's head dim."""
    b, t, hq, dp = q.shape
    _, s, g, _ = k.shape
    dt = q.dtype
    kernels.require(dt in _BWD_ENTRY, f"unsupported dtype {dt}")
    kernels.require(dp in _KERNEL_HEAD_DIMS, f"head dim {dp} not in {_KERNEL_HEAD_DIMS}")
    kernels.require(hq % g == 0, f"num q heads ({hq}) % kv groups ({g}) != 0")
    for name, x, shape in (("q", q, (b, t, hq, dp)), ("k", k, (b, s, g, dp)),
                           ("v", v, (b, s, g, dp)), ("do", do, (b, t, hq, dp))):
        kernels.check_cuda_tensor(x, name, dtype=dt, shape=shape)
    q, k, v, do = (_aligned(x) for x in (q, k, v, do))
    for name, x in (("lse", lse), ("di", di)):
        kernels.check_cuda_tensor(x, name, dtype=torch.float32, shape=(b, hq, t))
    valid, q_seg, kv_seg = _mask_args(kw, b, t, s, q.device)
    dev = q.device
    if which == "dq":
        outs = (torch.empty((b, t, hq, dp), dtype=torch.float32, device=dev),)
    else:
        outs = tuple(torch.empty((b, s, g, dp), dtype=torch.float32, device=dev)
                     for _ in range(2))
    lib = _lib_bwd()
    rc = getattr(lib, _BWD_ENTRY[dt][which])(
        kernels.ptr(q), kernels.ptr(k), kernels.ptr(v), kernels.ptr(do),
        kernels.ptr(lse), kernels.ptr(di), kernels.ptr(valid), _opt_ptr(q_seg),
        _opt_ptr(kv_seg), *(kernels.ptr(o) for o in outs), b, t, s, hq, g, dp,
        ctypes.c_float(kw["scale"]), int(kw["causal"]), int(kw["left_window"]),
        int(kw["right_window"]), int(kw["q_pos_offset"]), int(q_seg is not None),
        kernels.stream_ptr(q),
    )
    kernels.check(lib, rc, f"flash_attention_bwd ({which})")
    return outs


def _bwd_kw(scale, causal=False, left_window=-1, right_window=-1, q_pos_offset=0,
            kv_valid=None, q_segment_ids=None, kv_segment_ids=None):
    return dict(scale=scale, causal=causal, left_window=left_window,
                right_window=right_window, q_pos_offset=q_pos_offset,
                kv_valid=kv_valid, q_segment_ids=q_segment_ids,
                kv_segment_ids=kv_segment_ids)


def flash_bwd_dkv(q, k, v, do, lse, di, **kw):
    """K5a on CUDA tensors already at a kernel head dim: (dk, dv) fp32.
    Keywords as :func:`flash_attention_lse`."""
    dk, dv = _launch_bwd("dkv", q, k, v, do, lse, di, _bwd_kw(**kw))
    kernels.count_launch(flash_bwd_dkv)
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, di, **kw):
    """K5b on CUDA tensors already at a kernel head dim: dq fp32.
    Keywords as :func:`flash_attention_lse`."""
    (dq,) = _launch_bwd("dq", q, k, v, do, lse, di, _bwd_kw(**kw))
    kernels.count_launch(flash_bwd_dq)
    return dq


flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    di: torch.Tensor,
    kv_valid: Optional[torch.Tensor] = None,
    q_seg: Optional[torch.Tensor] = None,
    kv_seg: Optional[torch.Tensor] = None,
    *,
    scale: float,
    causal: bool = False,
    left_window: int = -1,
    right_window: int = -1,
    q_pos_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of flash attention from its saved row statistics.

    q/do [B, T, Hq, D], k/v [B, S, G, D]; lse and di = sum(do * o) are
    [B, Hq, T] fp32 (ring attention passes statistics merged over every
    shard).  Returns fp32 dq [B, T, Hq, D] and dk, dv [B, S, G, D] summed
    over each KV group's query heads."""
    kw = dict(scale=scale, causal=causal, left_window=left_window,
              right_window=right_window, q_pos_offset=q_pos_offset)
    if not q.is_cuda:
        return flash_attention_bwd_ref(q, k, v, do, lse, di, kv_valid, q_seg,
                                       kv_seg, **kw)
    d = q.shape[-1]
    dp = _kernel_head_dim(d)
    dt = q.dtype
    qp, kp, vp, dop = (_pad_head(x.to(dt), dp).contiguous() for x in (q, k, v, do))
    lse, di = lse.float().contiguous(), di.float().contiguous()
    kw.update(kv_valid=kv_valid, q_segment_ids=q_seg, kv_segment_ids=kv_seg)
    dk, dv = flash_bwd_dkv(qp, kp, vp, dop, lse, di, **kw)
    dq = flash_bwd_dq(qp, kp, vp, dop, lse, di, **kw)
    if dp != d:
        dq, dk, dv = dq[..., :d], dk[..., :d], dv[..., :d]
    return dq, dk, dv


# --- autograd ----------------------------------------------------------------


class FlashAttentionFn(torch.autograd.Function):
    """Counterpart of ``_flash_fwd_rule`` / ``_flash_bwd_rule``: the forward
    runs K2' and saves (q, k, v, o, lse); the backward computes
    di = sum(do * o) in fp32 and runs K5a and K5b (the plain versions on CPU
    tensors).  q, k, v come in at the kernels' head dim."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, q_seg, kv_seg, scale, causal,
                left_window, right_window, q_pos_offset):
        kw = dict(scale=scale, causal=causal, left_window=left_window,
                  right_window=right_window, q_pos_offset=q_pos_offset)
        o, lse = flash_attention_lse(q, k, v, kv_valid=kv_valid,
                                     q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                                     **kw)
        ctx.save_for_backward(q, k, v, o, lse, kv_valid, q_seg, kv_seg)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_valid, q_seg, kv_seg = ctx.saved_tensors
        # [B, Hq, T]; o is promoted to fp32 inside the product (no fp32 copy)
        di = (do.float() * o).sum(dim=-1).transpose(1, 2)
        dq, dk, dv = flash_attention_bwd(q, k, v, do.to(q.dtype), lse, di,
                                         kv_valid, q_seg, kv_seg, **ctx.kw)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)) + (None,) * 8


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
    valid); segment ids [B, T] / [B, S].  Returns [B, T, Hq, D] in q.dtype.

    When a gradient is needed it goes through :class:`FlashAttentionFn`,
    with the head dim padded outside it so the pad's gradient is a slice."""
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
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        dp = _kernel_head_dim(d)
        q_seg, kv_seg = _segments(q_segment_ids, kv_segment_ids, b, t, s, q.device)
        out = FlashAttentionFn.apply(
            _pad_head(q, dp), _pad_head(k.to(q.dtype), dp),
            _pad_head(v.to(q.dtype), dp), kv_valid, q_seg, kv_seg,
            float(scale), bool(causal), int(left_window), int(right_window),
            int(q_pos_offset),
        )
        return out[..., :d] if dp != d else out
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, **kw)
    out, _ = _launch_fwd(q, k, v, kw, want_lse=False)
    kernels.count_launch(flash_attention)
    return out


flash_attention.launches = 0

_FWD_ENTRY = {
    torch.bfloat16: "vats_flash_fwd_bf16",
    torch.float32: "vats_flash_fwd_f32",
}
_BWD_ENTRY = {
    torch.bfloat16: {"dq": "vats_flash_bwd_dq_bf16", "dkv": "vats_flash_bwd_dkv_bf16"},
    torch.float32: {"dq": "vats_flash_bwd_dq_f32", "dkv": "vats_flash_bwd_dkv_f32"},
}


def _lib() -> ctypes.CDLL:
    lib = kernels.load("flash_attention")
    for name in _FWD_ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
            + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def _lib_bwd() -> ctypes.CDLL:
    lib = kernels.load("flash_backward")
    for entries in _BWD_ENTRY.values():
        for which, name in entries.items():
            fn = getattr(lib, name)
            n_out = 1 if which == "dq" else 2
            fn.argtypes = (
                [ctypes.c_void_p] * (9 + n_out) + [ctypes.c_int] * 6
                + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
    return lib
