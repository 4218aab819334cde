"""Paged KV cache + K1, the paged decode attention kernel with commit.

Counterpart of ``vats_tpu/ops/decode_attention.py``.

  * :class:`PagedKVCache`: K and V share ONE pool of pages
    ``[layers, num_pages, 2, kv_heads, page_size, head_dim_pad]``.  This is
    the port's own layout: head-dim minor, with head_dim zero-padded to the
    8-element granule (60 -> 64), so one token's K (or V) row is contiguous
    (128 bytes at hd 64, bf16) for the kernel's 16-byte loads.  The JAX pool
    is sequence-minor ``[.., head_dim_pad, page_size]`` for the TPU's
    (8, 128) tiling.  The semantics carry over: page tables, the clamp at
    capacity, zero pad rows.  The cache is updated in place (the JAX one is
    a functional pytree); methods return ``self`` for call-site parity.
  * :func:`paged_decode_attention_commit` (K1, decode hot path): attends the
    paged history plus the current token and writes that token into its
    page, in one launch of ``csrc/decode_attention.cu`` on CUDA tensors;
    :func:`paged_decode_attention` is the same kernel without the commit.
    On CPU tensors both run the plain versions
    (:func:`paged_decode_attention_ref`, :meth:`PagedKVCache.append_token`).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from vats_tpu_torch.ops import kernels

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

INT8_KV_TODO = (
    "kv_quant='int8' (kernel K4, the int8 mode of the paged decode kernel) "
    "is not ported yet: see ROADMAP.md, queue 2, K4"
)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, group) symmetric int8 quantization of [..., hd] K or V.

    Returns (int8 values, fp32 scale [...]); dequantized = values * scale.
    The scale floor keeps all-zero vectors at 1e-8/127 (dequant 0)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _pad_head_dim(head_dim: int) -> int:
    """Stored head dim: zero-padded to the 8-element granule (16 bytes of
    bf16), so every stored row is whole 16-byte vectors."""
    return -(-head_dim // 8) * 8


def _pad_last(x: torch.Tensor, size: int) -> torch.Tensor:
    if x.shape[-1] == size:
        return x
    return torch.nn.functional.pad(x, (0, size - x.shape[-1]))


@dataclass
class PagedKVCache:
    """Paged K/V pool shared by every sequence in the batch."""

    kv_pages: torch.Tensor  # [L, num_pages, 2, G, page_size, hd_pad]
    page_table: torch.Tensor  # [B, pages_per_seq] int32 physical page ids
    lengths: torch.Tensor  # [B] int32 settled tokens per sequence
    head_dim: int = 0  # logical head dim
    # True only between create() and the first append: a fresh-cache prefill
    # attends its own window causally and skips the page gather
    fresh: bool = False

    @classmethod
    def create(
        cls,
        num_layers: int,
        batch_size: int,
        max_seq_len: int,
        kv_heads: int,
        head_dim: int,
        *,
        page_size: int = 128,
        dtype: torch.dtype = torch.bfloat16,
        device=None,
    ) -> "PagedKVCache":
        if dtype == torch.int8:
            raise NotImplementedError(INT8_KV_TODO)
        if page_size % 128 != 0:
            raise ValueError(
                f"page_size ({page_size}) must be a multiple of 128, as in the "
                "JAX package (pages are whole 128-token tiles)"
            )
        pages_per_seq = -(-max_seq_len // page_size)
        num_pages = batch_size * pages_per_seq
        shape = (
            num_layers, num_pages, 2, kv_heads, page_size, _pad_head_dim(head_dim)
        )
        # identity allocation: sequence b owns pages [b*pps, (b+1)*pps)
        table = (
            torch.arange(batch_size, device=device)[:, None] * pages_per_seq
            + torch.arange(pages_per_seq, device=device)[None, :]
        ).to(torch.int32)
        return cls(
            kv_pages=torch.zeros(shape, dtype=dtype, device=device),
            page_table=table,
            lengths=torch.zeros(batch_size, dtype=torch.int32, device=device),
            head_dim=head_dim,
            fresh=True,
        )

    @property
    def page_size(self) -> int:
        return self.kv_pages.shape[4]

    @property
    def pages_per_seq(self) -> int:
        return self.page_table.shape[1]

    def _stack_kv(self, k_new: torch.Tensor, v_new: torch.Tensor, dim: int):
        hdp = self.kv_pages.shape[5]
        kv = torch.stack([_pad_last(k_new, hdp), _pad_last(v_new, hdp)], dim=dim)
        return kv.to(self.kv_pages.dtype)

    def append_token(
        self, layer_idx: int, k_new: torch.Tensor, v_new: torch.Tensor
    ) -> "PagedKVCache":
        """Write one token's K/V per sequence at its current length (clamped
        at capacity).  k_new/v_new: [B, G, hd].  ``advance`` separately."""
        kv = self._stack_kv(k_new, v_new, dim=1)  # [B, 2, G, hd_pad]
        ps = self.page_size
        pos = torch.clamp(self.lengths.long(), max=self.pages_per_seq * ps - 1)
        phys = torch.gather(self.page_table.long(), 1, (pos // ps)[:, None])[:, 0]
        self.kv_pages[layer_idx][phys, :, :, pos % ps] = kv
        self.fresh = False
        return self

    def append_tokens(
        self, layer_idx: int, k_new: torch.Tensor, v_new: torch.Tensor
    ) -> "PagedKVCache":
        """Write T tokens per sequence from its current length (prefill).
        k_new/v_new: [B, T, G, hd]."""
        kv = self._stack_kv(k_new, v_new, dim=2)  # [B, T, 2, G, hd_pad]
        ps = self.page_size
        t = k_new.shape[1]
        pos = self.lengths.long()[:, None] + torch.arange(t, device=kv.device)
        phys = torch.gather(self.page_table.long(), 1, pos // ps)
        self.kv_pages[layer_idx][phys, :, :, pos % ps] = kv
        self.fresh = False
        return self

    def append_window_pages(
        self, layer_idx: int, k_new: torch.Tensor, v_new: torch.Tensor
    ) -> "PagedKVCache":
        """Fresh-cache prefill append: write the window as whole pages (every
        row at length 0); slots past the window in its last page are zero."""
        b, t, g, _ = k_new.shape
        ps = self.page_size
        ppu = -(-t // ps)
        kv = self._stack_kv(k_new, v_new, dim=2)  # [B, T, 2, G, hd_pad]
        pad = ppu * ps - t
        if pad:
            kv = torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, 0, 0, pad))
        hdp = kv.shape[-1]
        pages = kv.reshape(b, ppu, ps, 2, g, hdp).permute(0, 1, 3, 4, 2, 5)
        pids = self.page_table[:, :ppu].reshape(-1).long()
        self.kv_pages[layer_idx][pids] = pages.reshape(b * ppu, 2, g, ps, hdp)
        self.fresh = False
        return self

    def gather_dense_t(self, layer_idx: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """A layer's pages as the dense cache's sequence-minor views
        ([B, G, hd_pad, S], the layout ``cached_decode_attention`` takes)."""
        kv = self.kv_pages[layer_idx][self.page_table.long()]  # [B,pps,2,G,ps,hdp]
        b, pps, _, g, ps, hdp = kv.shape
        kv = kv.permute(2, 0, 3, 5, 1, 4).reshape(2, b, g, hdp, pps * ps)
        return kv[0], kv[1]

    def advance(self, n: int = 1) -> "PagedKVCache":
        self.lengths = self.lengths + n
        return self

    def advance_by(self, counts: torch.Tensor) -> "PagedKVCache":
        """Per-sequence advance (ragged prefill: each row's true length)."""
        self.lengths = self.lengths + counts.to(torch.int32)
        return self


def paged_decode_attention_ref(
    q: torch.Tensor,
    kv_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float,
    k_cur: Optional[torch.Tensor] = None,
    v_cur: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of K1's attention (counterpart of
    ``paged_decode_attention_xla``).

    q [B, Hq, hd]; kv_pages: one layer's pool [P, 2, G, ps, hd_pad];
    ``lengths`` counts settled history; k_cur/v_cur [B, G, hd] add the
    current token as one extra, always-valid column.  Like the kernel, q and
    the current token are taken in pool precision and the math is fp32."""
    b, hq, hd = q.shape
    _, _, g, ps, hdp = kv_pages.shape
    n = hq // g
    pps = page_table.shape[1]
    pool_dtype = kv_pages.dtype
    gathered = kv_pages[page_table.long()].float()  # [B, pps, 2, G, ps, hdp]
    kv = gathered.permute(2, 0, 3, 1, 4, 5).reshape(2, b, g, pps * ps, hdp)
    k_seq, v_seq = kv[0, ..., :hd], kv[1, ..., :hd]  # [B, G, S, hd]
    valid = (
        torch.arange(pps * ps, device=q.device)[None, :] < lengths[:, None]
    )
    if k_cur is not None:
        k_seq = torch.cat([k_seq, k_cur.to(pool_dtype).float()[:, :, None]], dim=2)
        v_seq = torch.cat([v_seq, v_cur.to(pool_dtype).float()[:, :, None]], dim=2)
        valid = torch.cat(
            [valid, torch.ones(b, 1, dtype=torch.bool, device=q.device)], dim=1
        )
    qf = q.to(pool_dtype).float().reshape(b, g, n, hd)
    s = torch.einsum("bgnd,bgsd->bgns", qf, k_seq) * scale
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vmask, torch.exp(s - m), 0.0)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bgns,bgsd->bgnd", p / denom, v_seq)
    return out.reshape(b, hq, hd).to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,
    kv_pages: torch.Tensor,
    layer_idx: int,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float,
    k_cur: torch.Tensor,
    v_cur: torch.Tensor,
) -> torch.Tensor:
    """K1 without the commit: attend the history plus the current token,
    write nothing.  kv_pages: the full pool [L, P, 2, G, ps, hd_pad]."""
    if not q.is_cuda:
        return paged_decode_attention_ref(
            q, kv_pages[layer_idx], page_table, lengths, scale=scale,
            k_cur=k_cur, v_cur=v_cur,
        )
    return _launch(q, kv_pages, layer_idx, page_table, lengths, scale, k_cur,
                   v_cur, commit=False)


def paged_decode_attention_commit(
    q: torch.Tensor,
    kv_pages: torch.Tensor,
    layer_idx: int,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float,
    k_cur: torch.Tensor,
    v_cur: torch.Tensor,
) -> torch.Tensor:
    """Decode hot path: attend the paged history plus the current token AND
    write the token into slot ``min(lengths[b], capacity-1)`` of its page.

    q [B, Hq, hd]; kv_pages: the full pool [L, P, 2, G, ps, hd_pad], updated
    in place; k_cur/v_cur [B, G, hd].  Returns the attention [B, Hq, hd]."""
    if not q.is_cuda:
        out = paged_decode_attention_ref(
            q, kv_pages[layer_idx], page_table, lengths, scale=scale,
            k_cur=k_cur, v_cur=v_cur,
        )
        PagedKVCache(kv_pages, page_table, lengths).append_token(
            layer_idx, k_cur, v_cur
        )
        return out
    return _launch(q, kv_pages, layer_idx, page_table, lengths, scale, k_cur,
                   v_cur, commit=True)


def _launch(q, kv_pages, layer_idx, page_table, lengths, scale, k_cur, v_cur,
            *, commit: bool) -> torch.Tensor:
    b, hq, hd = q.shape
    l, p, _, g, ps, hdp = kv_pages.shape
    n = hq // g
    pps = page_table.shape[1]
    dt = kv_pages.dtype
    kernels.require(dt in _ENTRY, f"unsupported pool dtype {dt}")
    kernels.require(hq % g == 0, f"{hq} query heads do not fold into {g} groups")
    kernels.require(n <= 8 and hdp <= 128 and hdp % 8 == 0,
                    f"unsupported head shape: {n} heads/group, head dim {hdp}")
    kernels.require(0 <= layer_idx < l, f"layer {layer_idx} out of range")
    kernels.check_cuda_tensor(kv_pages, "kv_pages")
    kernels.check_cuda_tensor(page_table, "page_table", dtype=torch.int32,
                              shape=(b, pps))
    kernels.check_cuda_tensor(lengths, "lengths", dtype=torch.int32, shape=(b,))
    q_in = _pad_last(q.reshape(b, g, n, hd).to(dt), hdp).contiguous()
    cur = torch.stack([_pad_last(k_cur, hdp), _pad_last(v_cur, hdp)], dim=1)
    cur = cur.to(dt).contiguous()  # [B, 2, G, hd_pad]
    kernels.check_cuda_tensor(cur, "k_cur/v_cur", shape=(b, 2, g, hdp))
    out = torch.empty((b, g, n, hdp), dtype=dt, device=q.device)
    lib = _lib()
    rc = getattr(lib, _ENTRY[dt])(
        kernels.ptr(q_in), kernels.ptr(cur), kernels.ptr(kv_pages),
        kernels.ptr(page_table), kernels.ptr(lengths), kernels.ptr(out),
        b, g, n, hdp, p, ps, pps, layer_idx, ctypes.c_float(scale),
        int(commit), kernels.stream_ptr(q),
    )
    kernels.check(lib, rc, "paged_decode_attention")
    if commit:
        paged_decode_attention_commit.launches += 1
    else:
        paged_decode_attention.launches += 1
    return out[..., :hd].reshape(b, hq, hd).to(q.dtype)


paged_decode_attention.launches = 0
paged_decode_attention_commit.launches = 0

_ENTRY = {
    torch.bfloat16: "vats_paged_decode_bf16",
    torch.float32: "vats_paged_decode_f32",
}


def _lib() -> ctypes.CDLL:
    lib = kernels.load("decode_attention")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib
