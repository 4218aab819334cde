"""Autoregressive text->video generation stack.

Counterpart of ``vats_tpu/models/video_gen.py``:

  * :class:`CausalFactorizedAttention`: one set of q/k/v projections feeds
    two parallel branches, each with its own ``+x`` residual: a spatial one
    over [B*T, H*W] tokens (causal raster order within a frame, key
    validity ``spatial_valid`` for a partly decoded frame, the '3d axial'
    RoPE on the h and w thirds of the head) and a temporal one over
    [B*H*W, T] (causal across frames, the t third rotated at absolute frame
    positions).  q, k and v are projected once and laid out for each branch;
    the RoPE tables (``nn/rope.rope_3d_axial_cos_sin``) are made once a
    forward and shared by every layer.  The branches are concatenated, then
    go through ``spatio_temporal_proj`` (2d -> d) and ``o_proj``.  With a dense
    temporal cache (``init_cache``: B*H*W rows, one slot a latent frame) a
    forward writes its frame's K/V at the cache's length in both modes:
    ``append`` then advances the length, ``read`` leaves it, so the next
    read or append overwrites the slot (JAX's read computes the same update
    functionally and drops it; every slot below the length stays as it
    was).  A one-frame write takes K3's append mode, one launch a layer.
  * :class:`FactorizedCrossAttention`: the same two branches against the
    text's K/V, repeated over frames (spatial) and over locations
    (temporal).
  * :class:`VideoGenTransformerBlock`: ``dropout(attn(norm(x)))`` with no
    outer residual (the branches' residuals carry the skip path), the same
    for the cross-attention, then the FFN block over [B, T*H*W, d].
  * :class:`AutoregressiveVideoTransformer`: codebook embed -> N blocks ->
    RMSNorm -> features [B, T, H, W, d], or fp32 codebook logits
    [B, T, H*W, V] through ``to_logits``.
  * The 3-D VQ-VAE: :class:`Encoder3D` (Conv3d k=s=patch, two 3x3x3
    convolutions, each with BatchNorm and ReLU), the shared quantizer
    (:class:`VectorQuantizer3D`), :class:`Decoder3D` (two 3x3x3 transposed
    convolutions with BatchNorm and ReLU, a k=s=patch transposed
    convolution, sigmoid) and :class:`VQVAE3D` (loss = reconstruction MSE +
    VQ loss).

Attention runs the plain ``ops/attention_ref.dot_product_attention`` on the
card and the CPU alike: the JAX model calls XLA's attention here, never its
flash kernel.  Layouts: the convolutions run NCDHW, the encoder returns and
the decoder takes channels-last latents [B, T, H, W, d] as in JAX.  flax's
``ConvTranspose`` does not flip its kernel; ``utils/convert.py`` flips all
three spatial axes for ``conv_transpose3d``.  BatchNorm is the image stack's
(flax's running statistics: momentum 0.99, biased variance).  Dropout masks
come from ``nn/dropout.py`` (rate 0 in every parity test).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vats_tpu_torch.configs.video_gen import VideoGenArgs
from vats_tpu_torch.device import resolve_device, resolve_dtype
from vats_tpu_torch.models.image_gen import (
    BatchNorm,
    VectorQuantizer,
    _lecun_normal_,
    _step_seed,
)
from vats_tpu_torch.nn.activations import FFNBlock
from vats_tpu_torch.nn.attention import dense, embed_rows
from vats_tpu_torch.nn.dropout import SITE_ATTN, SITE_CROSS, SITE_EMBED, Seed, dropout
from vats_tpu_torch.nn.initializers import (
    embed_init_,
    head_init_,
    input_proj_init_,
    output_proj_init_,
)
from vats_tpu_torch.nn.kv_cache import KVCache
from vats_tpu_torch.nn.norms import RMSNorm, l2_normalize
from vats_tpu_torch.nn.rope import apply_rope_interleaved, rope_3d_axial_cos_sin
from vats_tpu_torch.ops.attention_ref import dot_product_attention

#: a forward's (spatial, temporal) whole-head RoPE tables, each (cos, sin)
RopeTables = Tuple[Tuple[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


class _Factorized(nn.Module):
    """The projections both factorized attentions share: q [d, H hd],
    k and v [d, G hd], ``spatio_temporal_proj`` [2d, d] and ``o_proj``."""

    def __init__(self, cfg: VideoGenArgs, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = resolve_dtype(cfg.dtype)
        pdt = resolve_dtype(cfg.param_dtype)
        d, h, g, hd = cfg.d_model, cfg.num_heads, cfg.query_groups, cfg.head_dim
        lin = lambda i, o: nn.Linear(i, o, bias=cfg.use_proj_bias, dtype=pdt,  # noqa: E731
                                     device=device)
        self.q_proj = lin(d, h * hd)
        self.k_proj = lin(d, g * hd)
        self.v_proj = lin(d, g * hd)
        self.spatio_temporal_proj = lin(2 * d, d)
        self.o_proj = lin(d, d)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        n = self.cfg.num_layers
        ins = (self.q_proj, self.k_proj, self.v_proj, self.spatio_temporal_proj)
        for lin in ins:
            input_proj_init_(lin.weight, n, (lin.in_features, lin.out_features), generator)
        output_proj_init_(self.o_proj.weight, n, generator)
        with torch.no_grad():
            for lin in ins + (self.o_proj,):
                if lin.bias is not None:
                    lin.bias.zero_()

    def _project(self, lin: nn.Linear, x: torch.Tensor, heads: int) -> torch.Tensor:
        return dense(lin, x, self.dtype).reshape(*x.shape[:2], heads, self.cfg.head_dim)

    def _merge(self, spatial_out: torch.Tensor, temporal_out: torch.Tensor) -> torch.Tensor:
        st = torch.cat([spatial_out, temporal_out], dim=-1)
        return dense(self.o_proj, dense(self.spatio_temporal_proj, st, self.dtype), self.dtype)


class CausalFactorizedAttention(_Factorized):
    def _windows(self) -> Tuple[int, int]:
        cfg = self.cfg
        left, right = cfg.left_window, cfg.right_window
        if cfg.use_causal:
            right = 0
        if not cfg.use_windowed_attn:
            left, right = -1, -1
        return left, right

    def rope_tables(self, t_positions: torch.Tensor) -> Optional[RopeTables]:
        """The spatial and temporal (cos, sin) tables of a forward whose
        frames sit at ``t_positions`` (None without RoPE)."""
        cfg = self.cfg
        if not cfg.use_ntk_rope:
            return None
        kw = dict(ntk_scale_factor=cfg.ntk_scale_factor, device=t_positions.device)
        return (rope_3d_axial_cos_sin("spatial", cfg.head_dim, cfg.rope_theta,
                                      grid_h=cfg.latent_height, grid_w=cfg.latent_width, **kw),
                rope_3d_axial_cos_sin("temporal", cfg.head_dim, cfg.rope_theta,
                                      t_positions=t_positions, **kw))

    def forward(self, x: torch.Tensor, cache: Optional[KVCache] = None, layer_idx: int = 0,
                cache_mode: str = "append",
                spatial_valid: Optional[torch.Tensor] = None,
                rope: Optional[RopeTables] = None
                ) -> Tuple[torch.Tensor, Optional[KVCache]]:
        """x [B, T, HW, d] -> ([B, T, HW, d], the cache).

        spatial_valid: [B, HW] bool for a partly decoded frame: keys past
        the generation frontier are masked out of the spatial branch.
        rope: the forward's ``rope_tables`` (made here when not given).

        Both branches see the same tokens, so q, k and v are projected and
        normed once and laid out twice (JAX projects them twice; the
        products are the same rows)."""
        cfg = self.cfg
        b, t, hw, d = x.shape
        h, g, hd = cfg.num_heads, cfg.query_groups, cfg.head_dim
        left, right = self._windows()
        kw = dict(scale=cfg.softmax_scale, causal=cfg.use_causal, left_window=left,
                  right_window=right)
        t_pos = torch.arange(t, device=x.device)
        if cache is not None:
            t_pos = cache.length + t_pos
        if rope is None:
            rope = self.rope_tables(t_pos)
        xf = x.reshape(b, t * hw, d)
        q = self._project(self.q_proj, xf, h)
        k = self._project(self.k_proj, xf, g)
        v = self._project(self.v_proj, xf, g)
        if cfg.use_qk_norm:
            q, k = l2_normalize(q), l2_normalize(k)
        sp_rope, tm_rope = (None, None) if rope is None else rope

        def spatial(a, table=None):  # [B*T, HW, heads, hd]
            a = a.reshape(b * t, hw, a.shape[2], hd)
            return a if table is None else apply_rope_interleaved(a, *table)

        def temporal(a, table=None):  # [B*HW, T, heads, hd], rows ordered (b, hw)
            a = a.reshape(b, t, hw, a.shape[2], hd).transpose(1, 2).reshape(b * hw, t, -1, hd)
            return a if table is None else apply_rope_interleaved(a, *table)

        # spatial branch: causal raster attention within each frame
        sp_valid = None
        if spatial_valid is not None:
            sp_valid = spatial_valid.repeat_interleave(t, dim=0)  # [B*T, HW]
        spatial_out = dot_product_attention(
            spatial(q, sp_rope), spatial(k, sp_rope), spatial(v), kv_valid=sp_valid, **kw)
        spatial_out = spatial_out.reshape(b, t, hw, h * hd) + x

        # temporal branch: causal attention across frames, rows ordered (b, hw)
        qt, kt, vt = temporal(q, tm_rope), temporal(k, tm_rope), temporal(v)
        if cache is None:
            temporal_out = dot_product_attention(qt, kt, vt, **kw)
        else:
            # written at the length in both modes; only 'append' advances it
            cache.update_layer(layer_idx, kt, vt)
            k_buf, v_buf = cache.layer(layer_idx)
            temporal_out = dot_product_attention(
                qt, k_buf, v_buf, q_positions=t_pos,
                kv_positions=torch.arange(cache.max_seq_len, device=x.device),
                kv_valid=cache.valid_mask(b * hw, extra=t), **kw)
        temporal_out = temporal_out.reshape(b, hw, t, h * hd).transpose(1, 2) + x
        return self._merge(spatial_out, temporal_out), cache


class FactorizedCrossAttention(_Factorized):
    def _branch(self, x2d, k, v, mask):
        """x2d [B', L, d] queries against k, v [B', T_txt, G, hd]."""
        cfg = self.cfg
        q = self._project(self.q_proj, x2d, cfg.num_heads)
        if cfg.use_qk_norm:
            q = l2_normalize(q)
        out = dot_product_attention(q, k, v, scale=cfg.softmax_scale, causal=False,
                                    kv_valid=mask)
        return out.reshape(*x2d.shape[:2], cfg.num_heads * cfg.head_dim)

    def forward(self, x: torch.Tensor, text_embeddings: torch.Tensor,
                text_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        b, t, hw, d = x.shape
        k = self._project(self.k_proj, text_embeddings, cfg.query_groups)
        v = self._project(self.v_proj, text_embeddings, cfg.query_groups)
        if cfg.use_qk_norm:
            k = l2_normalize(k)
        rep = lambda a, n: None if a is None else a.repeat_interleave(n, dim=0)  # noqa: E731

        # spatial: every frame's patches attend the text
        spatial_out = self._branch(x.reshape(b * t, hw, d), rep(k, t), rep(v, t),
                                   rep(text_mask, t)).reshape(b, t, hw, d) + x
        # temporal: every location's frame sequence attends the text
        xt = x.permute(0, 2, 1, 3).reshape(b * hw, t, d)
        temporal_out = self._branch(xt, rep(k, hw), rep(v, hw), rep(text_mask, hw))
        temporal_out = temporal_out.reshape(b, hw, t, d).permute(0, 2, 1, 3) + x
        return self._merge(spatial_out, temporal_out)


class VideoGenTransformerBlock(nn.Module):
    """causal-factorized -> cross-factorized -> FFN."""

    def __init__(self, cfg: VideoGenArgs, device=None):
        super().__init__()
        self.cfg = cfg
        dtype, pdt = resolve_dtype(cfg.dtype), resolve_dtype(cfg.param_dtype)
        self.norm1 = RMSNorm(cfg.d_model, cfg.rms_norm_eps, dtype, pdt, device=device)
        self.attention = CausalFactorizedAttention(cfg, device=device)
        self.norm2 = RMSNorm(cfg.d_model, cfg.rms_norm_eps, dtype, pdt, device=device)
        self.cross_attention = FactorizedCrossAttention(cfg, device=device)
        self.ffn_block = FFNBlock(cfg.d_model, cfg.d_ffn, cfg.dropout, cfg.rms_norm_eps,
                                  cfg.num_layers, dtype, pdt, device=device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.norm1.weight.fill_(1.0)
            self.norm2.weight.fill_(1.0)
        self.attention.reset_parameters(generator)
        self.cross_attention.reset_parameters(generator)
        self.ffn_block.reset_parameters(generator)

    def forward(self, x, text_embeddings, text_mask, cache, spatial_valid, layer_idx: int,
                cache_mode: str = "append", deterministic: bool = True,
                dropout_seed: Optional[Seed] = None, rope: Optional[RopeTables] = None):
        rate = self.cfg.dropout
        h, new_cache = self.attention(self.norm1(x), cache=cache, layer_idx=layer_idx,
                                      cache_mode=cache_mode, spatial_valid=spatial_valid,
                                      rope=rope)
        x = dropout(h, rate, deterministic=deterministic, seed=dropout_seed,
                    layer=layer_idx, site=SITE_ATTN)
        h = self.cross_attention(self.norm2(x), text_embeddings, text_mask)
        x = dropout(h, rate, deterministic=deterministic, seed=dropout_seed,
                    layer=layer_idx, site=SITE_CROSS)
        b, t, hw, d = x.shape
        x = self.ffn_block(x.reshape(b, t * hw, d), deterministic=deterministic,
                           dropout_seed=dropout_seed, layer_idx=layer_idx)
        return x.reshape(b, t, hw, d), new_cache


class AutoregressiveVideoTransformer(nn.Module):
    """The AR transformer over [B, T, H, W] codebook indices, on ``device``
    (the card unless the caller asks for the CPU), weights from ``seed``;
    ``device="meta"`` builds the shapes only."""

    def __init__(self, cfg: VideoGenArgs, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = resolve_dtype(cfg.dtype)
        pdt = resolve_dtype(cfg.param_dtype)
        self.embedding = nn.Embedding(cfg.num_embeddings, cfg.d_model, dtype=pdt, device=dev)
        self.layers = nn.ModuleList(
            [VideoGenTransformerBlock(cfg, device=dev) for _ in range(cfg.num_layers)])
        self.norm = RMSNorm(cfg.d_model, cfg.rms_norm_eps, self.dtype, pdt, device=dev)
        self.to_logits = nn.Linear(cfg.d_model, cfg.num_embeddings, bias=False, dtype=pdt,
                                   device=dev)
        if dev.type != "meta":
            self.reset_parameters(torch.Generator(device=dev).manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.norm.weight.device

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        embed_init_(self.embedding.weight, generator)
        for layer in self.layers:
            layer.reset_parameters(generator)
        with torch.no_grad():
            self.norm.weight.fill_(1.0)
        head_init_(self.to_logits.weight, generator)

    def forward(
        self,
        encoding_indices: torch.Tensor,
        text_embeddings: torch.Tensor,
        text_mask: Optional[torch.Tensor] = None,
        cache: Optional[KVCache] = None,
        spatial_valid: Optional[torch.Tensor] = None,
        cache_mode: str = "append",
        return_logits: bool = False,
        deterministic: bool = True,
        dropout_seed: Optional[Seed] = None,
    ):
        """encoding_indices [B, T, H, W]; text_embeddings [B, T_txt, d];
        text_mask [B, T_txt] bool or None.

        Returns features [B, T, H, W, d], or with ``return_logits`` (fp32
        logits [B, T, H*W, num_embeddings], the cache).  A cache is written
        at its length; ``cache_mode="append"`` then advances it by T,
        ``"read"`` leaves it."""
        if cache_mode not in ("append", "read"):
            raise ValueError(f"unknown cache_mode {cache_mode!r}")
        cfg = self.cfg
        b, t, h_grid, w_grid = encoding_indices.shape
        hw = h_grid * w_grid
        seed = _step_seed(deterministic, cfg.dropout, dropout_seed)
        x = embed_rows(self.embedding.weight, encoding_indices.reshape(b, t, hw)).to(self.dtype)
        x = dropout(x, cfg.dropout, deterministic=deterministic, seed=seed, layer=-1,
                    site=SITE_EMBED)
        t_pos = torch.arange(t, device=x.device)
        if cache is not None:
            t_pos = cache.length + t_pos
        rope = self.layers[0].attention.rope_tables(t_pos)  # shared by every layer
        remat = (cfg.use_checkpointing and not deterministic and torch.is_grad_enabled()
                 and cache is None)
        for i, layer in enumerate(self.layers):
            args = (x, text_embeddings, text_mask, cache, spatial_valid, i, cache_mode,
                    deterministic, seed, rope)
            if remat:
                x, _ = checkpoint(layer, *args, use_reentrant=False, preserve_rng_state=False)
            else:
                x, _ = layer(*args)
        if cache is not None and cache_mode == "append":
            cache.advance(t)

        x = self.norm(x)
        if return_logits:
            return dense(self.to_logits, x, self.dtype).float(), cache
        return x.reshape(b, t, h_grid, w_grid, cfg.d_model)

    def init_cache(self, batch_size: int) -> KVCache:
        """The temporal cache: B * H*W rows (ordered (b, hw)), one slot a
        latent frame."""
        cfg = self.cfg
        return KVCache.create(
            num_layers=cfg.num_layers,
            batch_size=batch_size * cfg.latent_height * cfg.latent_width,
            max_seq_len=max(1, cfg.max_frames // cfg.patch_size[0]),
            kv_heads=cfg.query_groups, head_dim=cfg.head_dim, dtype=self.dtype,
            device=self.device)


# ---------------------------------------------------------------------------
# 3-D VQ-VAE
# ---------------------------------------------------------------------------


class Encoder3D(nn.Module):
    """Conv3d(k=s=patch, 'VALID') then two Conv3d(3, 'SAME'), each with
    BatchNorm and ReLU: [B, C, T, H, W] -> channels-last [B, T', H', W', d]."""

    def __init__(self, cfg: VideoGenArgs, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = resolve_dtype(cfg.dtype)
        pdt = resolve_dtype(cfg.param_dtype)
        d, p = cfg.d_model, tuple(cfg.patch_size)
        self.convs = nn.ModuleList([
            nn.Conv3d(cfg.C_in_out, d, p, stride=p, dtype=pdt, device=device),
            nn.Conv3d(d, d, 3, padding=1, dtype=pdt, device=device),
            nn.Conv3d(d, d, 3, padding=1, dtype=pdt, device=device)])
        self.bns = nn.ModuleList([BatchNorm(d, self.dtype, pdt, device=device)
                                  for _ in range(3)])

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for conv, bn in zip(self.convs, self.bns):
            _lecun_normal_(conv.weight, conv.weight[0].numel(), generator)
            with torch.no_grad():
                conv.bias.zero_()
            bn.reset_parameters()

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        x = x.to(self.dtype)
        for conv, bn in zip(self.convs, self.bns):
            x = F.conv3d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                         conv.stride, conv.padding)
            x = F.relu(bn(x, use_running_average=deterministic))
        return x.permute(0, 2, 3, 4, 1)


class Decoder3D(nn.Module):
    """Two ConvTranspose3d(3, 'SAME') with BatchNorm and ReLU, then
    ConvTranspose3d(k=s=patch, 'VALID') and a sigmoid: channels-last
    [B, T', H', W', d] -> [B, C, T, H, W]."""

    def __init__(self, cfg: VideoGenArgs, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = resolve_dtype(cfg.dtype)
        pdt = resolve_dtype(cfg.param_dtype)
        d, p = cfg.d_model, tuple(cfg.patch_size)
        self.deconvs = nn.ModuleList([
            nn.ConvTranspose3d(d, d, 3, padding=1, dtype=pdt, device=device),
            nn.ConvTranspose3d(d, d, 3, padding=1, dtype=pdt, device=device),
            nn.ConvTranspose3d(d, cfg.C_in_out, p, stride=p, dtype=pdt, device=device)])
        self.bns = nn.ModuleList([BatchNorm(d, self.dtype, pdt, device=device)
                                  for _ in range(2)])

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for deconv in self.deconvs:
            w = deconv.weight  # [in, out, kT, kH, kW]; flax's fan_in is kT kH kW in
            _lecun_normal_(w, w.shape[0] * w[0, 0].numel(), generator)
            with torch.no_grad():
                deconv.bias.zero_()
        for bn in self.bns:
            bn.reset_parameters()

    def forward(self, z_q: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        x = z_q.to(self.dtype).permute(0, 4, 1, 2, 3)
        for i, deconv in enumerate(self.deconvs):
            x = F.conv_transpose3d(x, deconv.weight.to(self.dtype),
                                   deconv.bias.to(self.dtype), deconv.stride, deconv.padding)
            if i < 2:
                x = F.relu(self.bns[i](x, use_running_average=deterministic))
        return torch.sigmoid(x)


#: the shared quantizer over [B, T, H, W, d] latents (fp32 L2 nearest row,
#: the straight-through estimator)
VectorQuantizer3D = VectorQuantizer


class VQVAE3D(nn.Module):
    """encode -> quantize -> decode, on ``device`` (the card unless the
    caller asks for the CPU), weights from ``seed``.  Returns
    (reconstruction, loss = reconstruction MSE + VQ loss, indices)."""

    def __init__(self, cfg: VideoGenArgs, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.encoder = Encoder3D(cfg, device=dev)
        self.quantizer = VectorQuantizer3D(cfg, device=dev)
        self.decoder = Decoder3D(cfg, device=dev)
        if dev.type != "meta":
            self.reset_parameters(torch.Generator(device=dev).manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.quantizer.embedding.device

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.encoder.reset_parameters(generator)
        self.quantizer.reset_parameters(generator)
        self.decoder.reset_parameters(generator)

    def forward(self, x: torch.Tensor, deterministic: bool = True):
        z = self.encoder(x, deterministic=deterministic)
        z_q, vq_loss, indices = self.quantizer(z)
        recon = self.decoder(z_q, deterministic=deterministic)
        recon_loss = (recon.float() - x.float()).square().mean()
        return recon, recon_loss + vq_loss, indices
