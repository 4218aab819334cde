"""GQA attention with sliding windows, QK-norm, RoPE and three cache paths.

Counterpart of ``vats_tpu/nn/attention.py`` (``Attention``,
``AttentionBlock``, ``select_attention_impl``):

  qkv projection (fused or split, optional bias) -> optional L2 QK-norm
  -> RoPE at absolute positions -> grouped attention -> output projection.

Attention runs by one of these paths:
  * uncached: ``ops/flash_attention.flash_attention`` (K2, or K2' with K5a
    and K5b under autograd when training) or the plain PyTorch attention,
    chosen by :func:`select_attention_impl`; key padding and segment ids
    reach it as in the JAX module;
  * dense cache (``nn/kv_cache.KVCache``): the plain cached attention over
    the buffer, or over the ring (``_ring_cached_attention``); at T == 1
    the QK-norm, RoPE, pad and commit of the token are one launch of K3's
    dense prologue (``KVCache.decode_token``);
  * paged cache (``ops/decode_attention.PagedKVCache``): T == 1 through K3's
    paged prologue (QK-norm and RoPE in one launch), then K1 (K4 for an
    int8 pool, with its scales), which attends and commits the token in one
    launch; a fresh-cache prefill through K2 or the plain
    attention, then a whole-page append (quantized for an int8 pool); a
    prefill into a non-fresh cache through ``append_tokens``, then K6
    (``ops/paged_prefill_attention.py``), which reads the pages through the
    table, for a bf16 pool whose stored head dim it has a tile for, else
    the plain version (``gather_dense_t``, int8 pages dequantized into
    bf16, + ``cached_decode_attention``).

RoPE: '1d', '2d_ntk' (the image-generation stack's raster-order 2-D
rotation over a grid of width ``grid_shape[-1]``, positions scaled by
``rope_ntk_scale``), '3d_ntk' (the raster-order, t-major 3-D rotation of
video token streams over frames of ``grid_shape[-2:]``) and 'none' on every
path; '2d_axial' (ViT-2D, over ``grid_shape``) and the axial '3d_spatial',
'3d_temporal' and '3d_all' (over a (gt, gh, gw) ``grid_shape``) on the
uncached path only (the cache paths raise for them, as JAX's do).  Caller-supplied per-token
``rope_angles`` (cos, sin) take the place of any mode, as in JAX.  A
'2d_ntk', '3d_ntk' or ``rope_angles`` decode token runs K3's prologue in
table mode: the kernel reads the (cos, sin) table that
``nn/rope.rope_2d_ntk_cos_sin`` / ``rope_3d_ntk_cos_sin`` make on the
device; a 'none' decode token reads the identity table (cos 1, sin 0: the
rotation is exact).  The JAX module's logical-sharding constraints have no
counterpart (an eager tensor is already laid out on its rank).

Context parallelism (``_maybe_context_parallel``, uncached forwards only):
under a mesh whose ``seq`` axis is > 1, ``context_parallel`` 'ring'
(``ops/ring_attention.py``: K2' per live hop, K5a/K5b in the backward) or
'ulysses' (``ops/ulysses.py``) attends.  Under ``mesh.batch_sharded()``
each rank holds its tokens ``[r * tl, (r + 1) * tl)``, so RoPE takes those
global positions; where context parallelism cannot run on such a shard
(mode 'none', or segment ids under Ulysses) the K/V shards are
all-gathered and this rank's queries attend the whole sequence (logged
once, "UNSHARDED").  Under ``with mesh:`` alone each rank holds whole
sequences and attention stays local, as the JAX module falls back on a
length the seq axis does not divide (quiet at T == 1).

Tensor parallelism (uncached forwards): with ``heads`` / ``kv_heads`` over
``tensor`` (``parallel/layout.py``) a rank projects, attends (the flash
kernels included) and outputs its Hq/tp query heads and G/tp KV groups; a
fused ``w_qkv``, replicated over ``tensor`` since "qkv" has no rule, gives
each rank its q, k and v rows; ``w_o`` is row-parallel (:func:`dense`).
Ring attention runs on the local heads; Ulysses needs them divisible by
``seq`` and raises otherwise.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vats_tpu_torch.nn.dropout import SITE_ATTN, Seed, dropout
from vats_tpu_torch.nn.initializers import input_proj_init_, output_proj_init_
from vats_tpu_torch.nn.kv_cache import KVCache
from vats_tpu_torch.nn.norms import RMSNorm, l2_normalize
from vats_tpu_torch.nn.rope import (
    apply_rope_1d,
    apply_rope_2d_axial,
    apply_rope_3d_axial,
    apply_rope_interleaved,
    rope_2d_ntk_cos_sin,
    rope_3d_ntk_cos_sin,
    rope_inv_freq,
    rope_table_cos_sin,
    yarn_inv_freq,
)
from vats_tpu_torch.ops import cache_append
from vats_tpu_torch.ops import paged_prefill_attention as paged_prefill
from vats_tpu_torch.ops.attention_ref import (
    cached_decode_attention,
    dot_product_attention,
)
from vats_tpu_torch.ops.decode_attention import paged_decode_attention_commit
from vats_tpu_torch.ops.flash_attention import flash_attention
from vats_tpu_torch.ops.ring_attention import ring_attention
from vats_tpu_torch.ops.ulysses import ulysses_attention
from vats_tpu_torch.parallel.collectives import all_gather, copy_to, gather, global_sum
from vats_tpu_torch.parallel.layout import TENSOR_LOCAL, gathered, split_over
from vats_tpu_torch.parallel.mesh import ambient_mesh, inputs_sharded
from vats_tpu_torch.utils.profiling import annotate

CONTEXT_PARALLEL_MODES = ("none", "ring", "ulysses")

_warned_cp_fallbacks = set()


def _warn_cp_fallback(reason: str) -> None:
    """Log once per distinct reason when configured context parallelism
    falls back (a packed long-context train would otherwise lose its
    sequence sharding with no visible signal)."""
    if reason in _warned_cp_fallbacks:
        return
    _warned_cp_fallbacks.add(reason)
    logging.getLogger("vats_tpu_torch").warning("context-parallel fallback: %s", reason)


#: below this sequence length 'auto' takes the plain attention, as in the
#: JAX package (the flash kernel has no blocks to skip at short lengths)
FLASH_MIN_SEQ_LEN = 256
#: RoPE modes the port runs on the uncached path, and on the cache paths
ROPE_TYPES = ("1d", "2d_axial", "2d_ntk", "3d_ntk", "3d_spatial", "3d_temporal", "3d_all",
              "none", "yarn")
CACHE_ROPE_TYPES = ("1d", "2d_ntk", "3d_ntk", "none", "yarn")


def select_attention_impl(
    impl: str,
    *,
    seq_len: Optional[int] = None,
    device: Optional[torch.device] = None,
) -> str:
    """'auto' picks the flash kernel ('flash') on a CUDA device for
    sequences of at least FLASH_MIN_SEQ_LEN, the plain attention ('xla', the
    config value shared with the JAX package) otherwise.  Where the JAX
    package picks 'flash' on a TPU, this picks it on the card."""
    if impl != "auto":
        return impl
    if seq_len is not None and seq_len < FLASH_MIN_SEQ_LEN:
        return "xla"
    if device is not None and torch.device(device).type == "cuda":
        return "flash"
    return "xla"


def _tensor_block(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """This ``tensor`` rank's block along ``dim`` of an ``x`` that every
    rank holds alike (its gradient summed over the ranks)."""
    size = x.shape[dim] // mesh.shape["tensor"]
    return copy_to(x, mesh, ("tensor",)).narrow(dim, mesh.axis_index("tensor") * size, size)


def embed_rows(weight: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The rows of ``weight`` at ``ids`` ([*ids.shape, d]): flax's
    ``Embed`` lookup, by indexing rather than ``F.embedding``.  The two
    agree in the forward; on the card, indexing's backward sums each row's
    gradients in a fixed order, while ``F.embedding``'s (past 3072 ids)
    does not, and a train step replayed from a CUDA graph is held bit for
    bit to its eager step."""
    return weight[ids.reshape(-1).long()].reshape(*ids.shape, weight.shape[-1])


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax DenseGeneral(dtype=...) semantics: inputs, weight and bias are
    cast to the compute dtype before the product.

    A sharded weight (``parallel/layout.py``) is gathered on use, except a
    ``heads``/``kv_heads``/``mlp`` dimension over ``tensor``: sharded in its
    output, the layer is column-parallel (this rank's outputs, and its block
    of a replicated bias); in its input, row-parallel (the partial products
    all-reduced over ``tensor`` in fp32, then the bias)."""
    w = layer.weight
    info = getattr(w, "shard_info", None)
    bias = layer.bias
    if info is None:
        return F.linear(x.to(dtype), w.to(dtype), bias.to(dtype) if bias is not None else None)
    weight = gathered(w, TENSOR_LOCAL)
    mesh = info.mesh
    local = [a == "tensor" and n in TENSOR_LOCAL for a, n in zip(info.spec, info.logical)]
    if local[0]:
        x = copy_to(x, mesh, ("tensor",))
        if bias is not None:
            bias = _tensor_block(bias, mesh)
    if local[1]:  # the partial products summed in fp32
        y = F.linear(x.to(dtype), weight.to(dtype))
        y = global_sum(y.float(), mesh, ("tensor",)).to(dtype)
        return y + bias.to(dtype) if bias is not None else y
    return F.linear(x.to(dtype), weight.to(dtype), bias.to(dtype) if bias is not None else None)


class Attention(nn.Module):
    def __init__(
        self,
        d_model: int,
        num_heads: int,
        query_groups: int,
        rope_theta: float = 10000.0,
        softmax_scale: Optional[float] = None,
        use_proj_bias: bool = False,
        use_qkv_proj: bool = True,
        use_qk_norm: bool = True,
        num_layers: int = 1,
        impl: str = "auto",
        rope_type: str = "1d",
        rope_ntk_scale: Optional[float] = None,
        context_parallel: str = "none",
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
        device=None,
        head_dim: Optional[int] = None,
        yarn: Optional[Tuple[float, int, float, float, float]] = None,
        span: Optional[str] = None,
    ):
        super().__init__()
        if head_dim is None and d_model % num_heads != 0:
            raise ValueError(
                f"d_model ({d_model}) must be divisible by num_heads ({num_heads})"
            )
        if num_heads % query_groups != 0:
            raise ValueError(
                f"num_heads ({num_heads}) must be divisible by query_groups "
                f"({query_groups})"
            )
        if rope_type not in ROPE_TYPES:
            raise NotImplementedError(
                f"rope_type={rope_type!r} is not ported yet (only {ROPE_TYPES})"
            )
        if context_parallel not in CONTEXT_PARALLEL_MODES:
            raise ValueError(f"unknown context_parallel mode: {context_parallel}")
        if (rope_type == "yarn") != (yarn is not None):
            raise ValueError("rope_type 'yarn' takes, and alone takes, the yarn parameters")
        self._head_dim = head_dim if head_dim is not None else d_model // num_heads
        self.yarn = yarn
        self.span = span
        self.d_model = d_model
        self.num_heads = num_heads
        self.query_groups = query_groups
        self.rope_theta = rope_theta
        self.softmax_scale = softmax_scale
        self.use_qkv_proj = use_qkv_proj
        self.use_qk_norm = use_qk_norm
        self.num_layers = num_layers
        self.impl = impl
        self.rope_type = rope_type
        self.rope_ntk_scale = rope_ntk_scale
        self.context_parallel = context_parallel
        self.dtype = dtype
        hd, h, g = self.head_dim, num_heads, query_groups
        lin = lambda i, o: nn.Linear(  # noqa: E731
            i, o, bias=use_proj_bias, dtype=param_dtype, device=device
        )
        if use_qkv_proj:
            self.w_qkv = lin(d_model, (h + 2 * g) * hd)
        else:
            self.w_q = lin(d_model, h * hd)
            self.w_k = lin(d_model, g * hd)
            self.w_v = lin(d_model, g * hd)
        self.w_o = lin(h * hd, d_model)
        # the decode prologue's fp32 tables per device, made at first use on
        # that device: rope_inv_freq (as apply_rope_1d makes it) for '1d',
        # the identity (cos 1, sin 0) for 'none', yarn_inv_freq for 'yarn';
        # not buffers: a model built on the meta device could not move them
        self._rope_tables = {}

    def _table(self, key: str, device: torch.device, make):
        table = self._rope_tables.get((key, device))
        if table is None:
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                # made here, the table would be filled only by replays
                raise RuntimeError(
                    "decode prologue: no RoPE table for this device yet; run the "
                    "step once before capturing it")
            table = make()
            self._rope_tables[(key, device)] = table
        return table

    def _rope_table(self, device: torch.device) -> torch.Tensor:
        return self._table("inv_freq", device, lambda: rope_inv_freq(
            self.head_dim, self.rope_theta, device=device))

    def _decode_rotation(self, cos_sin, device: torch.device):
        """(inv_freq, cos_sin) of a decode token's prologue: the table when
        there is one, the identity table for 'none', else the 1-D
        inv_freq."""
        if cos_sin is not None:
            return None, cos_sin
        if self.rope_type == "none":
            half = self.head_dim // 2
            return None, self._table("identity", device, lambda: (
                torch.ones(half, device=device), torch.zeros(half, device=device)))
        return self._rope_table(device), None

    @property
    def head_dim(self) -> int:
        return self._head_dim

    def param_logical_axes(self):
        if self.use_qkv_proj:  # "qkv" has no rule: replicated over tensor
            axes = {"w_qkv.weight": ("qkv", "embed")}
        else:
            axes = {"w_q.weight": ("heads", "embed"), "w_k.weight": ("kv_heads", "embed"),
                    "w_v.weight": ("kv_heads", "embed")}
        axes["w_o.weight"] = ("embed", "heads")
        return axes

    def _tensor_parallel(self):
        """(mesh, tp): the ``tensor`` ranks this layer's heads are split
        over (the output projection's input sharded there), else (None, 1)."""
        mesh, tp = split_over(self.w_o.weight, "tensor")
        if tp > 1 and (self.num_heads % tp or self.query_groups % tp):
            raise ValueError(f"tensor parallelism over {tp} ranks needs the heads "
                             f"({self.num_heads}) and the KV groups ({self.query_groups}) "
                             "divisible by it")
        return mesh, tp

    def _cos_sin(self, positions, grid_shape, rope_angles):
        """The per-token (cos, sin) table of a table-driven rotation:
        ``rope_angles`` when given, the '2d_ntk' table at ``positions``
        (raster order over a grid ``grid_shape[-1]`` wide) or the '3d_ntk'
        one (t-major raster over frames of ``grid_shape[-2:]``), else
        None."""
        if rope_angles is not None:
            return rope_angles
        if self.rope_type == "yarn":
            factor, original, fast, slow, attn_factor = self.yarn
            inv_freq = self._table("yarn", positions.device, lambda: yarn_inv_freq(
                self.head_dim, self.rope_theta, factor, original, fast, slow,
                device=positions.device))
            return rope_table_cos_sin(positions, inv_freq, attn_factor)
        if self.rope_type == "2d_ntk":
            return rope_2d_ntk_cos_sin(positions, self.head_dim, grid_shape[-1],
                                       self.rope_theta, self.rope_ntk_scale)
        if self.rope_type == "3d_ntk":
            return rope_3d_ntk_cos_sin(positions, self.head_dim, grid_shape[-2],
                                       grid_shape[-1], self.rope_theta,
                                       self.rope_ntk_scale)
        return None

    def _apply_rope(self, x, positions, grid_shape, cos_sin=None):
        """RoPE of a forward at ``positions`` (1-D), by the table
        ``cos_sin``, or over ``grid_shape`` ((gh, gw) for '2d_axial',
        (gt, gh, gw) for the axial 3-D modes)."""
        if cos_sin is not None:
            return apply_rope_interleaved(x, *cos_sin)
        if self.rope_type == "none":
            return x
        if self.rope_type == "2d_axial":
            gh, gw = grid_shape
            return apply_rope_2d_axial(x, gh, gw, self.rope_theta, self.rope_ntk_scale)
        if self.rope_type in ("3d_spatial", "3d_temporal", "3d_all"):  # axial, (gt, gh, gw)
            gt, gh, gw = grid_shape
            return apply_rope_3d_axial(x, gt, gh, gw, self.rope_theta,
                                       mode=self.rope_type[3:],
                                       ntk_scale_factor=self.rope_ntk_scale)
        return apply_rope_1d(x, positions, self.rope_theta)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        ins = [self.w_qkv] if self.use_qkv_proj else [self.w_q, self.w_k, self.w_v]
        for lin in ins:
            input_proj_init_(
                lin.weight, self.num_layers, (lin.in_features, lin.out_features),
                generator,
            )
        output_proj_init_(self.w_o.weight, self.num_layers, generator)
        with torch.no_grad():
            for lin in ins + [self.w_o]:
                if lin.bias is not None:
                    lin.bias.zero_()

    def project_qkv(self, x: torch.Tensor):
        """q [B, T, H, hd], k and v [B, T, G, hd]: this rank's H = Hq/tp
        heads and G/tp groups under tensor parallelism."""
        b, t, _ = x.shape
        mesh, tp = self._tensor_parallel()
        h, g, hd = self.num_heads // tp, self.query_groups // tp, self.head_dim
        if self.use_qkv_proj and tp > 1:
            # the fused weight is whole on every tensor rank: this rank's q, k
            # and v rows (their gradients summed over the ranks)
            r = mesh.axis_index("tensor")
            rows = torch.cat([off + r * n * hd + torch.arange(n * hd, device=x.device)
                              for off, n in ((0, h), (self.num_heads * hd, g),
                                             ((self.num_heads + self.query_groups) * hd, g))])
            w = copy_to(gathered(self.w_qkv.weight), mesh, ("tensor",))[rows]
            bias = self.w_qkv.bias
            if bias is not None:
                bias = copy_to(bias, mesh, ("tensor",))[rows].to(self.dtype)
            qkv = F.linear(copy_to(x, mesh, ("tensor",)).to(self.dtype), w.to(self.dtype),
                           bias)
            q, k, v = torch.split(qkv, [h * hd, g * hd, g * hd], dim=-1)
        elif self.use_qkv_proj:
            qkv = dense(self.w_qkv, x, self.dtype)
            q, k, v = torch.split(qkv, [h * hd, g * hd, g * hd], dim=-1)
        else:
            q = dense(self.w_q, x, self.dtype)
            k = dense(self.w_k, x, self.dtype)
            v = dense(self.w_v, x, self.dtype)
        return q.reshape(b, t, h, hd), k.reshape(b, t, g, hd), v.reshape(b, t, g, hd)

    def forward(
        self,
        x: torch.Tensor,
        *,
        causal: bool = True,
        left_window: int = -1,
        right_window: int = -1,
        padding_mask: Optional[torch.Tensor] = None,
        cache: Optional[KVCache] = None,
        paged_cache=None,
        layer_idx: int = 0,
        segment_ids: Optional[torch.Tensor] = None,
        grid_shape: Optional[Tuple[int, ...]] = None,
        rope_angles: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        decode_left_window: int = -1,
    ):
        """x: [B, T, d_model] -> ([B, T, d_model], updated cache or None).

        padding_mask: bool, True = valid token; [B, T] for uncached forwards.
        With a dense ``cache`` it may instead be [B, max_seq_len], a validity
        mask over the whole buffer kept by the generation loop.
        grid_shape: the patch grid of a '2d_axial' forward (T == gh * gw);
        for '2d_ntk' its last entry is the raster grid's width, for '3d_ntk'
        its last two the frame's (gh, gw).
        rope_angles: fp32 (cos, sin) per token ([T, hd/2], or [B, T, hd/2]
        on the paged path) in place of the rope mode.
        decode_left_window: the window of a paged decode token (K1; the
        JAX package's paged decode has none, so its models pass -1).

        The attention between the projections runs under the span
        ``self.span`` when one is set (``attn.window`` / ``attn.full`` in
        ``TextLM``)."""
        b, t, _ = x.shape
        if (cache is not None or paged_cache is not None) and self._tensor_parallel()[1] > 1:
            raise NotImplementedError("KV-cached attention with heads split over tensor")
        if ((cache is not None or paged_cache is not None) and rope_angles is None
                and self.rope_type not in CACHE_ROPE_TYPES):
            raise NotImplementedError(
                f"KV-cached attention not supported for rope_type={self.rope_type}")
        q, k, v = self.project_qkv(x)
        span = annotate(self.span) if self.span else contextlib.nullcontext()
        with span:
            # a decode token's QK-norm and RoPE run inside K3's prologue
            decode = t == 1 and (cache is not None or paged_cache is not None)
            if self.use_qk_norm and not decode:
                q = l2_normalize(q)
                k = l2_normalize(k)
            scale = (
                self.softmax_scale
                if self.softmax_scale is not None
                else 1.0 / float(self.head_dim) ** 0.5
            )
            if causal:
                right_window = 0

            if paged_cache is not None:
                out, new_cache = self._paged_attention(
                    q, k, v, paged_cache, layer_idx, padding_mask, scale, left_window,
                    grid_shape, rope_angles, decode_left_window,
                )
            elif cache is None:
                positions = self._seq_offset(t) + torch.arange(t, device=x.device)
                cos_sin = self._cos_sin(positions, grid_shape, rope_angles)
                q = self._apply_rope(q, positions, grid_shape, cos_sin)
                k = self._apply_rope(k, positions, grid_shape, cos_sin)
                out = self._maybe_context_parallel(
                    q, k, v, scale, causal, left_window, right_window, padding_mask,
                    segment_ids)
                if out is None:
                    impl = select_attention_impl(self.impl, seq_len=t, device=q.device)
                    attend = flash_attention if impl == "flash" else dot_product_attention
                    out = attend(
                        q, k, v, scale=scale, causal=causal, left_window=left_window,
                        right_window=right_window, kv_valid=padding_mask,
                        q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
                    )
                new_cache = None
            else:
                start = cache.length
                positions = start + torch.arange(t, device=x.device)
                cos_sin = self._cos_sin(positions, grid_shape, rope_angles)
                if decode:
                    inv_freq, table = self._decode_rotation(cos_sin, x.device)
                    q = cache.decode_token(
                        layer_idx, q, k, v, inv_freq,
                        theta=self.rope_theta, qk_norm=self.use_qk_norm, cos_sin=table,
                    )
                    new_cache = cache
                else:
                    q = self._apply_rope(q, positions, grid_shape, cos_sin)
                    k = self._apply_rope(k, positions, grid_shape, cos_sin)
                    new_cache = cache.update_layer(layer_idx, k, v)
                if cache.ring:
                    out = self._ring_cached_attention(
                        q, k, v, new_cache, positions, padding_mask, scale,
                        causal, left_window, right_window, b, t, layer_idx,
                    )
                else:
                    k_buf, v_buf = new_cache.layer_t(layer_idx)
                    s = new_cache.max_seq_len
                    kv_valid = new_cache.valid_mask(b, extra=t)
                    if padding_mask is not None:
                        if padding_mask.shape[-1] == s:
                            kv_valid = kv_valid & padding_mask.bool()
                        else:
                            kv_valid = kv_valid & self._merge_padding(
                                padding_mask, start, b, s
                            )
                    out = self._attend_buffer(
                        q, k_buf, v_buf, scale=scale, causal=causal,
                        left_window=left_window, right_window=right_window,
                        q_positions=positions,
                        kv_positions=torch.arange(s, device=x.device),
                        kv_valid=kv_valid,
                    )

        out = out.reshape(b, t, -1)  # this rank's heads under tensor parallelism
        return dense(self.w_o, out, self.dtype), new_cache

    def _seq_offset(self, t: int) -> int:
        """The global position of this rank's first token: r * t under
        ``mesh.batch_sharded()`` with seq > 1 (r its seq coordinate), else 0."""
        mesh = ambient_mesh()
        if mesh is None or mesh.shape.get("seq", 1) == 1 or not inputs_sharded():
            return 0
        if self.rope_type in ("2d_axial", "3d_spatial", "3d_temporal", "3d_all"):
            raise NotImplementedError(
                f"rope_type={self.rope_type!r} over a sequence sharded on seq")
        return mesh.axis_index("seq") * t

    def _maybe_context_parallel(
        self, q, k, v, scale, causal, left_window, right_window,
        padding_mask, segment_ids,
    ):
        """Ring or Ulysses attention over the mesh's ``seq`` axis, or None to
        fall through to local attention (see the module docstring).  Packed
        sequences (segment ids) ride the ring (the ids rotate with their KV
        shard); Ulysses takes the gathered path for them."""
        mesh = ambient_mesh()
        if mesh is None or mesh.shape.get("seq", 1) <= 1:
            return None
        sharded = inputs_sharded()
        gathered = lambda: self._gathered_attention(  # noqa: E731
            mesh, q, k, v, scale, causal, left_window, right_window, padding_mask,
            segment_ids) if sharded else None
        if self.context_parallel == "none":
            return gathered()
        if segment_ids is not None and self.context_parallel != "ring":
            _warn_cp_fallback(
                "packed sequences (segment_ids) — the Ulysses path has no "
                "segment masking; attention runs UNSHARDED over seq "
                "(use context_parallel='ring')"
            )
            return gathered()
        if not sharded:
            t, n = q.shape[1], mesh.shape["seq"]
            if t % n != 0:
                # decode-shaped calls (T=1) hit this by design: stay quiet there
                if t > 1:
                    _warn_cp_fallback(
                        f"sequence length {t} not divisible by the seq axis ({n}); "
                        "attention runs UNSHARDED over seq")
            else:
                _warn_cp_fallback(
                    "whole sequences on every rank (not under mesh.batch_sharded()); "
                    "attention runs UNSHARDED over seq")
            return None
        kv_valid = padding_mask.bool() if padding_mask is not None else None
        if self.context_parallel == "ring":
            return ring_attention(
                q, k, v, mesh=mesh, scale=scale, causal=causal,
                left_window=left_window, right_window=right_window,
                kv_valid=kv_valid, q_segment_ids=segment_ids,
                kv_segment_ids=segment_ids,
            )
        return ulysses_attention(
            q, k, v, mesh=mesh, scale=scale, causal=causal, left_window=left_window,
            right_window=right_window, kv_valid=kv_valid,
        )

    def _gathered_attention(self, mesh, q, k, v, scale, causal, left_window,
                            right_window, padding_mask, segment_ids):
        """This rank's queries against the whole sequence: K and V
        all-gathered along seq (their gradients summed back over the ranks),
        the key mask and the segment ids too; the queries at their global
        positions."""
        t = q.shape[1]
        k, v = (gather(x, mesh, "seq", 1) for x in (k, v))
        kv_valid = None if padding_mask is None else all_gather(
            padding_mask.to(torch.int32), mesh, "seq", 1).bool()
        kv_seg = None if segment_ids is None else all_gather(
            segment_ids.to(torch.int32), mesh, "seq", 1)
        offset = mesh.axis_index("seq") * t
        impl = select_attention_impl(self.impl, seq_len=k.shape[1], device=q.device)
        if impl == "flash":
            return flash_attention(
                q, k, v, scale=scale, causal=causal, left_window=left_window,
                right_window=right_window, kv_valid=kv_valid,
                q_segment_ids=segment_ids, kv_segment_ids=kv_seg, q_pos_offset=offset)
        return dot_product_attention(
            q, k, v, scale=scale, causal=causal, left_window=left_window,
            right_window=right_window, kv_valid=kv_valid,
            q_positions=offset + torch.arange(t, device=q.device),
            q_segment_ids=segment_ids, kv_segment_ids=kv_seg)

    def _attend_buffer(self, q, k_buf, v_buf, **kw):
        """cached_decode_attention with q zero-padded to the stored head dim
        (the pad rows of the buffer are zero; a decode prologue's q comes
        padded) and the output sliced back."""
        if q.shape[-1] != k_buf.shape[2]:
            q = F.pad(q, (0, k_buf.shape[2] - q.shape[-1]))
        return cached_decode_attention(q, k_buf, v_buf, **kw)[..., :self.head_dim]

    def _ring_cached_attention(
        self, q, k, v, cache, positions, padding_mask, scale,
        causal, left_window, right_window, b, t, layer_idx,
    ):
        """Attention against a sliding-window ring cache.  Prefill (t > 1,
        from an empty cache) attends its own window; decode attends the ring
        with each slot's absolute position rebuilt from the ring arithmetic."""
        if t > 1:
            kv_valid = None
            if padding_mask is not None:
                kv_valid = padding_mask.bool()[:, :t]
            impl = select_attention_impl(self.impl, seq_len=t, device=q.device)
            attend = flash_attention if impl == "flash" else dot_product_attention
            return attend(
                q, k, v, scale=scale, causal=causal, left_window=left_window,
                right_window=right_window, kv_valid=kv_valid,
            )
        k_buf, v_buf = cache.layer_t(layer_idx)
        s = cache.max_seq_len
        slot_pos = cache.slot_positions(extra=t)  # [S] absolute, < 0 unwritten
        kv_valid = (slot_pos[None, :] >= 0).expand(b, s)
        if padding_mask is not None and padding_mask.shape[-1] != s:
            idx = torch.clamp(slot_pos, 0, padding_mask.shape[-1] - 1).long()
            kv_valid = kv_valid & padding_mask.bool()[:, idx]
        elif padding_mask is not None:
            kv_valid = kv_valid & padding_mask.bool()
        return self._attend_buffer(
            q, k_buf, v_buf, scale=scale, causal=causal,
            left_window=left_window, right_window=right_window,
            q_positions=positions, kv_positions=slot_pos, kv_valid=kv_valid,
        )

    def _paged_attention(
        self, q, k, v, paged_cache, layer_idx, padding_mask, scale, left_window,
        grid_shape=None, rope_angles=None, decode_left_window=-1,
    ):
        """Ragged-batch causal attention over a PagedKVCache; each row's
        positions start at its own ``lengths[b]``; a decode token attends
        ``decode_left_window``'s window."""
        b, t = q.shape[0], q.shape[1]
        lengths = paged_cache.lengths
        positions = lengths[:, None] + torch.arange(t, device=q.device)[None, :]
        cos_sin = self._cos_sin(positions, grid_shape, rope_angles)
        if t == 1:
            inv_freq, table = self._decode_rotation(cos_sin, q.device)
            q1, k1, v1 = cache_append.paged_decode_prologue(
                q, k, v, lengths, inv_freq,
                theta=self.rope_theta, qk_norm=self.use_qk_norm, cos_sin=table,
            )
            out = paged_decode_attention_commit(
                q1, paged_cache.kv_pages, layer_idx, paged_cache.page_table,
                lengths, scale=scale, k_cur=k1, v_cur=v1,
                kv_scales=paged_cache.kv_scales, left_window=decode_left_window,
            )
            paged_cache.fresh = False
            return out[:, None], paged_cache

        q = self._apply_rope(q, positions, grid_shape, cos_sin)
        k = self._apply_rope(k, positions, grid_shape, cos_sin)

        if paged_cache.fresh:
            # fresh-cache prefill: every row starts at 0, so attention is
            # plain causal over this window; the pages still get the roped K/V
            impl = select_attention_impl(self.impl, seq_len=t, device=q.device)
            attend = flash_attention if impl == "flash" else dot_product_attention
            out = attend(
                q, k, v, scale=scale, causal=True, left_window=left_window,
                right_window=0, kv_valid=padding_mask,
            )
            return out, paged_cache.append_window_pages(layer_idx, k, v)

        # prefill into a cache with history: append the window, then attend
        # the pages through the table with masks (K6 where it reads the pool)
        new_cache = paged_cache.append_tokens(layer_idx, k, v)
        pool = new_cache.kv_pages
        q = F.pad(q, (0, pool.shape[-1] - q.shape[-1]))
        mask = None if padding_mask is None else padding_mask.bool()
        kw = dict(scale=scale, window_mask=mask, left_window=left_window)
        if paged_prefill.kernel_fits(pool):
            out = paged_prefill.paged_prefill_attention(
                q.contiguous(), pool, layer_idx, new_cache.page_table, lengths, **kw)
        else:
            out = paged_prefill.paged_prefill_attention_ref(
                q, pool, layer_idx, new_cache.page_table, lengths,
                kv_scales=new_cache.kv_scales, **kw)
        return out[..., :self.head_dim], new_cache

    @staticmethod
    def _merge_padding(padding_mask, start, b, max_s):
        """A [B, T] window mask placed at ``start`` of an all-valid [B, S]
        mask (dynamic_update_slice semantics: the start clamps to fit)."""
        t = padding_mask.shape[-1]
        start = torch.clamp(start, max=max_s - t)
        pos = torch.arange(max_s, device=padding_mask.device)[None, :]
        rel = pos - start
        in_window = (rel >= 0) & (rel < t)
        window = torch.gather(
            padding_mask.bool(), 1, torch.clamp(rel, 0, t - 1).expand(b, max_s)
        )
        return torch.where(in_window, window, True)


class AttentionBlock(nn.Module):
    """Pre-RMSNorm -> Attention -> dropout -> residual."""

    def __init__(
        self,
        d_model: int,
        num_heads: int,
        query_groups: int,
        rope_theta: float = 10000.0,
        softmax_scale: Optional[float] = None,
        use_proj_bias: bool = False,
        use_qkv_proj: bool = True,
        use_qk_norm: bool = True,
        dropout: float = 0.0,
        eps: float = 1e-7,
        num_layers: int = 1,
        impl: str = "auto",
        rope_type: str = "1d",
        rope_ntk_scale: Optional[float] = None,
        context_parallel: str = "none",
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
        device=None,
        head_dim: Optional[int] = None,
        yarn: Optional[Tuple[float, int, float, float, float]] = None,
        span: Optional[str] = None,
    ):
        super().__init__()
        self.dropout = dropout
        self.norm = RMSNorm(d_model, eps, dtype, param_dtype, device=device)
        self.attn = Attention(
            d_model, num_heads, query_groups, rope_theta=rope_theta,
            softmax_scale=softmax_scale, use_proj_bias=use_proj_bias,
            use_qkv_proj=use_qkv_proj, use_qk_norm=use_qk_norm,
            num_layers=num_layers, impl=impl, rope_type=rope_type,
            rope_ntk_scale=rope_ntk_scale, context_parallel=context_parallel, dtype=dtype,
            param_dtype=param_dtype, device=device, head_dim=head_dim, yarn=yarn, span=span,
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.norm.weight.fill_(1.0)
        self.attn.reset_parameters(generator)

    def forward(self, x, *, deterministic: bool = True,
                dropout_seed: Optional[Seed] = None, **kw) -> Tuple:
        out, new_cache = self.attn(self.norm(x), **kw)
        out = dropout(out, self.dropout, deterministic=deterministic,
                      seed=dropout_seed, layer=kw.get("layer_idx", 0),
                      site=SITE_ATTN)
        return x + out, new_cache
