"""The latent paged cache of multi-head latent attention (MLA) and its
decode kernel (K9).

  * :class:`LatentPagedCache`: one pool of pages ``[layers, num_pages,
    page_size, latent_dim]`` holding one vector a token a layer: the
    RMSNorm'd latent c_kv (``kv_lora_rank``) then the roped key part k_pe
    (``qk_rope_head_dim``) that every head shares; no separate V.  Page
    tables, lengths, the clamp at capacity and the last-writer rule of
    colliding writes are :class:`~vats_tpu_torch.ops.decode_attention.
    PagedKVCache`'s, so the serving engine's allocator, preemption and
    prefix cache run over it unchanged.  Appends are plain PyTorch index
    writes.
  * :func:`mla_decode_attention` (decode hot path, absorbed): each row's
    query heads, already folded through W_UK to the latent width and
    joined to their roped parts (``q_abs [B, H, latent_dim]``), attend the
    row's first ``lengths[b]`` latent vectors through the page table; the
    value of a key is its own first ``v_dim`` elements (the latent c_kv).
    Returns ``[B, H, v_dim]``, which W_UV maps to each head's value.  On
    CUDA tensors one launch of ``csrc/mla_decode.cu``, which raises on a
    shape it does not take (:func:`kernel_fits`); on the CPU the plain
    version (:func:`mla_decode_attention_ref`).
    ``mla_decode_attention.launches`` counts K9's launches (replays of a
    captured step included) and ``mla_decode_attention.plain.launches`` the
    plain version's calls.

No kernel here replaces one of the JAX package, which has no MLA: K1
(``ops/decode_attention.py``) takes at most 8 heads a group and head dims
up to 128, while absorbed MLA has 16 query heads on one 576-wide key.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from vats_tpu_torch.ops import kernels
from vats_tpu_torch.ops.decode_attention import TILE, _counters
from vats_tpu_torch.utils.profiling import annotate


@dataclass
class LatentPagedCache:
    """Paged latent pool shared by every sequence in the batch.

    ``fresh``: every row starts at 0, so a prefill's keys are its own
    window's and it reads no page (the serving engine without a prefix
    cache); else a prefill attends every position its pages hold."""

    pages: torch.Tensor  # [L, num_pages, page_size, latent_dim]
    page_table: torch.Tensor  # [B, pages_per_seq] int32 physical page ids
    lengths: torch.Tensor  # [B] int32 settled tokens per sequence
    fresh: bool = False

    @staticmethod
    def create_pool(num_layers: int, num_pages: int, page_size: int, latent_dim: int,
                    dtype: torch.dtype = torch.bfloat16, device=None) -> torch.Tensor:
        if page_size % TILE != 0:
            raise ValueError(f"page_size ({page_size}) must be a multiple of {TILE}")
        return torch.zeros((num_layers, num_pages, page_size, latent_dim), dtype=dtype,
                           device=device)

    @property
    def page_size(self) -> int:
        return self.pages.shape[2]

    @property
    def pages_per_seq(self) -> int:
        return self.page_table.shape[1]

    def append_tokens(self, layer_idx: int, latent: torch.Tensor) -> "LatentPagedCache":
        """Write T latent vectors a sequence ([B, T, latent_dim]) from its
        current length.  Positions past the table land on the row's last
        slot, and every writer of a slot writes the value of the last of
        them in (row, position) order, as ``PagedKVCache.append_tokens``
        does: the result is a sequential loop's on any device.  Does not
        advance ``lengths``."""
        b, t, w = latent.shape
        ps = self.page_size
        dev = latent.device
        pos = self.lengths.long()[:, None] + torch.arange(t, device=dev)
        pos = torch.clamp(pos, max=self.pages_per_seq * ps - 1)
        phys = torch.gather(self.page_table.long(), 1, pos // ps)
        dest = (phys * ps + pos % ps).reshape(-1)
        order = torch.arange(b * t, device=dev)
        last = torch.full((self.pages.shape[1] * ps,), -1, dtype=torch.long, device=dev)
        winner = last.scatter_reduce_(0, dest, order, reduce="amax")[dest]
        rows = latent.reshape(b * t, w)[winner].to(self.pages.dtype)
        self.pages[layer_idx].view(-1, w)[dest] = rows
        return self

    def gather(self, layer_idx: int) -> torch.Tensor:
        """Each row's pages of a layer in order, [B, pages_per_seq *
        page_size, latent_dim]."""
        b, pps = self.page_table.shape
        return self.pages[layer_idx][self.page_table.long()].reshape(
            b, pps * self.page_size, self.pages.shape[-1])

    def advance_by(self, counts: torch.Tensor) -> "LatentPagedCache":
        """Per-sequence advance, in place (``lengths`` keeps its storage)."""
        self.lengths.add_(counts.to(self.lengths.dtype))
        return self


#: rows of the plain version's gather at once (bounds its fp32 buffer)
_REF_ROWS = 8


def mla_decode_attention_ref(q_abs: torch.Tensor, pages: torch.Tensor,
                             page_table: torch.Tensor, lengths: torch.Tensor, *,
                             scale: float, v_dim: int) -> torch.Tensor:
    """Plain version of K9: what the kernel computes.

    q_abs [B, H, W]; pages: one layer's pool [P, ps, W]; each row attends
    its first min(lengths[b], capacity) positions (keys: the whole W-wide
    vector; values: its first ``v_dim`` elements).  Scores and the softmax
    in fp32 from q_abs in the pool's precision; a bf16 pool rounds p to
    bf16 for p.v (the kernel's bf16 P.V operand), the normaliser sums the
    fp32 p.  A row with nothing to attend gives zeros.  Returns [B, H,
    v_dim] in q_abs's dtype."""
    b, h, w = q_abs.shape
    ps = pages.shape[1]
    cap = page_table.shape[1] * ps
    out = torch.empty((b, h, v_dim), dtype=q_abs.dtype, device=q_abs.device)
    pos = torch.arange(cap, device=q_abs.device)
    for r0 in range(0, b, _REF_ROWS):
        r1 = min(b, r0 + _REF_ROWS)
        kv = pages[page_table[r0:r1].long()].reshape(r1 - r0, cap, w).float()
        q = q_abs[r0:r1].to(pages.dtype).float()
        s = torch.einsum("bhw,bsw->bhs", q, kv) * scale
        valid = (pos[None, :] < lengths[r0:r1, None])[:, None, :]
        m = torch.where(valid, s, -torch.inf).amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.where(valid, torch.exp(s - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        if pages.dtype == torch.bfloat16:
            p = p.to(torch.bfloat16).float()
        o = torch.einsum("bhs,bsv->bhv", p, kv[..., :v_dim])
        out[r0:r1] = (o / torch.where(l == 0, 1.0, l)).to(q_abs.dtype)
    return out


#: the one shape K9 is built for: query heads (at most), latent width, value width
MAX_HEADS, WIDTH, V_DIM = 16, 576, 512


def kernel_fits(q_abs: torch.Tensor, pages: torch.Tensor, v_dim: int) -> bool:
    """K9 takes bf16 q_abs and pool, at most 16 heads, the 576-wide latent
    (512 + 64) with 512-wide values, and pages of whole 128-token tiles."""
    return (q_abs.dtype == torch.bfloat16 and pages.dtype == torch.bfloat16
            and q_abs.shape[1] <= MAX_HEADS and q_abs.shape[2] == WIDTH
            and pages.shape[-1] == WIDTH and v_dim == V_DIM and pages.shape[-2] % TILE == 0)


def mla_decode_attention(q_abs: torch.Tensor, pages: torch.Tensor, layer_idx: int,
                         page_table: torch.Tensor, lengths: torch.Tensor, *, scale: float,
                         v_dim: int) -> torch.Tensor:
    """K9: absorbed latent decode attention.  q_abs [B, H, W] (the folded
    nope part then the roped part); pages: the full pool [L, P, ps, W];
    lengths [B] int32: the positions each row attends (its settled tokens
    and the current one, already appended).  Returns [B, H, v_dim].  The
    plain version on the CPU only: on the card a call K9 does not take
    raises."""
    with annotate("mla.decode"):
        if not q_abs.is_cuda:
            mla_decode_attention.plain.launches += 1
            return mla_decode_attention_ref(q_abs, pages[layer_idx], page_table, lengths,
                                            scale=scale, v_dim=v_dim)
        out = _launch(q_abs, pages, layer_idx, page_table, lengths, scale, v_dim)
        kernels.count_launch(mla_decode_attention)
        return out


mla_decode_attention.launches = 0
mla_decode_attention.plain = kernels.LaunchCount("mla_decode_attention.plain")

#: a row's tiles are cut into at most this many chunks, a CTA each (their
#: partials combine through the LSE), of at least MIN_CHUNK_TILES tiles
MAX_CHUNKS, MIN_CHUNK_TILES = 16, 4


def chunk_tiles(tiles: int) -> int:
    """128-token tiles a K9 CTA walks, for a table of ``tiles`` tiles."""
    return max(MIN_CHUNK_TILES, -(-tiles // MAX_CHUNKS))


def _launch(q_abs, pages, layer_idx, page_table, lengths, scale, v_dim) -> torch.Tensor:
    """One launch: checks, the output and the workspace from ``torch.empty``."""
    b, h, w = q_abs.shape
    l, p, ps, _ = pages.shape
    pps = page_table.shape[1]
    kernels.require(kernel_fits(q_abs, pages, v_dim),
                    f"K9 takes bf16, at most {MAX_HEADS} heads, width {WIDTH}, values "
                    f"{V_DIM} and pages of whole {TILE}-token tiles; got q_abs "
                    f"{tuple(q_abs.shape)} {q_abs.dtype}, pages {tuple(pages.shape)} "
                    f"{pages.dtype}, v_dim {v_dim}")
    kernels.require(b <= 65535, f"batch {b} beyond the grid")
    kernels.require(0 <= layer_idx < l, f"layer {layer_idx} out of range")
    kernels.check_cuda_tensor(q_abs, "q_abs", dtype=torch.bfloat16, shape=(b, h, w))
    kernels.check_cuda_tensor(pages, "pages", dtype=torch.bfloat16)
    kernels.require(pages.data_ptr() % 16 == 0, "pages must be 16-byte aligned")
    kernels.check_cuda_tensor(page_table, "page_table", dtype=torch.int32, shape=(b, pps))
    kernels.check_cuda_tensor(lengths, "lengths", dtype=torch.int32, shape=(b,))
    tiles = pps * ps // TILE
    ct = chunk_tiles(tiles)
    chunks = -(-tiles // ct)
    out = torch.empty((b, h, V_DIM), dtype=torch.bfloat16, device=q_abs.device)
    # per (row, chunk, head): m, l and o[V_DIM], fp32
    work = torch.empty(b * chunks * MAX_HEADS * (V_DIM + 2), dtype=torch.float32,
                       device=q_abs.device)
    lib = _lib()
    rc = lib.vats_mla_decode_bf16(
        kernels.ptr(q_abs), kernels.ptr(pages), kernels.ptr(page_table), kernels.ptr(lengths),
        kernels.ptr(out), kernels.ptr(work), kernels.ptr(_counters(q_abs.device, b)),
        b, h, p, ps, pps, layer_idx, ct, ctypes.c_float(scale),
        kernels.stream_ptr(q_abs))
    kernels.check(lib, rc, "mla_decode_attention")
    return out


def _lib() -> ctypes.CDLL:
    lib = kernels.load("mla_decode")
    fn = lib.vats_mla_decode_bf16
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
