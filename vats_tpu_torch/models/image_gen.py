"""Autoregressive text->image generation stack.

Counterpart of ``vats_tpu/models/image_gen.py``:

  * :class:`TransformerTextEncoder`: token embed -> N bidirectional GQA
    blocks ('1d' RoPE) with FFN blocks -> RMSNorm.  At its lengths (at most
    ``text_max_seq_len`` = 128 tokens) it always takes the plain attention.
  * :class:`AutoregressiveImageTransformer`: codebook embed -> N x [causal
    self-attention with the raster 2-D NTK RoPE and a KV cache ->
    cross-attention to the text -> FFN] -> RMSNorm -> features [B, H, W, d],
    or, with ``return_logits``, fp32 codebook logits through ``to_logits``.
    The RoPE table is made once a forward (``nn/rope.rope_2d_ntk_cos_sin``
    at the forward's positions) and passed to every layer as its
    ``rope_angles``; a decode token (T == 1) therefore runs K3's prologue in
    table mode, one launch a layer.  Long uncached forwards take the flash
    kernels (K2; K2', K5a, K5b under autograd), the paged decode K1.
  * The VQ-VAE: :class:`VQVAEEncoder` (3 convolutions 4s2 / 4s2 / 3s1, each
    with BatchNorm and the activation), :class:`VectorQuantizer` (fp32 L2
    nearest codebook row, the JAX package's swapped stop-gradient loss and
    the straight-through estimator), :class:`VQVAEDecoder` (transposed
    convolutions 3s1 / 4s2 / 4s2, sigmoid) and :class:`VQVAE`, which runs
    the transformer on the quantized indices.

Layouts: the convolutions run NCHW (PyTorch's), the encoder returns and the
decoder takes NHWC latents as in JAX.  flax's ``ConvTranspose(padding=
"SAME")`` is ``conv_transpose2d`` with padding 1 and the kernel flipped in
both spatial axes (``utils/convert.py`` flips it).  :class:`BatchNorm` holds
flax's running statistics: momentum 0.99, the biased batch variance
E[x^2] - E[x]^2 in fp32, normalisation in fp32, cast to the compute dtype;
the statistics are buffers, updated in place by a training forward.
Dropout masks come from ``nn/dropout.py`` (rate 0 in every parity test).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vats_tpu_torch.configs.image_gen import ImageGenArgs
from vats_tpu_torch.device import no_tf32, resolve_device, resolve_dtype
from vats_tpu_torch.nn.activations import FFNBlock
from vats_tpu_torch.nn.attention import AttentionBlock, dense, embed_rows
from vats_tpu_torch.nn.cross_attention import CrossAttentionBlock
from vats_tpu_torch.nn.dropout import SITE_EMBED, Seed, dropout
from vats_tpu_torch.nn.initializers import embed_init_, head_init_
from vats_tpu_torch.nn.kv_cache import KVCache
from vats_tpu_torch.nn.norms import RMSNorm
from vats_tpu_torch.nn.rope import rope_2d_ntk_cos_sin
from vats_tpu_torch.ops.decode_attention import PagedKVCache


def _step_seed(deterministic: bool, rate: float, seed: Optional[Seed]) -> Optional[Seed]:
    """The forward's dropout seed: drawn from the default CPU generator when
    dropout is on and none is given."""
    if not deterministic and rate > 0 and seed is None:
        return int(torch.randint(0, 1 << 62, (1,)))
    return seed


# ---------------------------------------------------------------------------
# Text encoder
# ---------------------------------------------------------------------------


class TransformerTextEncoder(nn.Module):
    """Bidirectional GQA text encoder, on ``device`` (the card unless the
    caller asks for the CPU), weights from ``seed``; ``device="meta"``
    builds the shapes only."""

    def __init__(self, cfg: ImageGenArgs, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = resolve_dtype(cfg.dtype)
        pdt = resolve_dtype(cfg.param_dtype)
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.d_model, dtype=pdt, device=dev)
        n = cfg.text_num_layers
        self.attn_blocks = nn.ModuleList([
            AttentionBlock(cfg.d_model, cfg.text_num_heads, cfg.text_query_groups,
                           rope_theta=cfg.rope_theta, softmax_scale=None,
                           use_proj_bias=cfg.use_proj_bias, use_qkv_proj=cfg.use_qkv_proj,
                           use_qk_norm=cfg.use_qk_norm, dropout=cfg.dropout,
                           eps=cfg.rms_norm_eps, num_layers=n, dtype=self.dtype,
                           param_dtype=pdt, device=dev)
            for _ in range(n)])
        self.ffn_blocks = nn.ModuleList([
            FFNBlock(cfg.d_model, cfg.d_ffn, cfg.dropout, cfg.rms_norm_eps, n, self.dtype,
                     pdt, device=dev)
            for _ in range(n)])
        self.norm = RMSNorm(cfg.d_model, cfg.rms_norm_eps, self.dtype, pdt, device=dev)
        if dev.type != "meta":
            self.reset_parameters(torch.Generator(device=dev).manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.norm.weight.device

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        embed_init_(self.token_embed.weight, generator)
        for a, f in zip(self.attn_blocks, self.ffn_blocks):
            a.reset_parameters(generator)
            f.reset_parameters(generator)
        with torch.no_grad():
            self.norm.weight.fill_(1.0)

    def forward(self, input_ids: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                dropout_seed: Optional[Seed] = None) -> torch.Tensor:
        """input_ids [B, T] -> [B, T, d] in the compute dtype; padding_mask
        [B, T] bool, True = valid."""
        cfg = self.cfg
        seed = _step_seed(deterministic, cfg.dropout, dropout_seed)
        x = embed_rows(self.token_embed.weight, input_ids).to(self.dtype)
        x = dropout(x, cfg.dropout, deterministic=deterministic, seed=seed, layer=-1,
                    site=SITE_EMBED)
        for i, (a, f) in enumerate(zip(self.attn_blocks, self.ffn_blocks)):
            x, _ = a(x, causal=False, padding_mask=padding_mask, layer_idx=i,
                     deterministic=deterministic, dropout_seed=seed)
            x = f(x, deterministic=deterministic, dropout_seed=seed, layer_idx=i)
        return self.norm(x)


# ---------------------------------------------------------------------------
# AR image transformer
# ---------------------------------------------------------------------------


class ARImageTransformerBlock(nn.Module):
    """causal self-attention -> cross-attention -> FFN."""

    def __init__(self, cfg: ImageGenArgs, device=None):
        super().__init__()
        self.cfg = cfg
        dtype, pdt = resolve_dtype(cfg.dtype), resolve_dtype(cfg.param_dtype)
        self.causal_attention_block = AttentionBlock(
            cfg.d_model, cfg.num_heads, cfg.query_groups, rope_theta=cfg.rope_theta,
            softmax_scale=cfg.softmax_scale, use_proj_bias=cfg.use_proj_bias,
            use_qkv_proj=cfg.use_qkv_proj, use_qk_norm=cfg.use_qk_norm,
            dropout=cfg.dropout, eps=cfg.rms_norm_eps, num_layers=cfg.num_layers,
            impl=cfg.attention_impl, rope_type="2d_ntk",
            rope_ntk_scale=cfg.ntk_scale_factor if cfg.use_ntk_rope else None,
            dtype=dtype, param_dtype=pdt, device=device)
        self.cross_attention_block = CrossAttentionBlock(
            cfg.d_model, cfg.num_heads, softmax_scale=cfg.softmax_scale,
            use_proj_bias=cfg.use_proj_bias, dropout=cfg.dropout, eps=cfg.rms_norm_eps,
            num_layers=cfg.num_layers, dtype=dtype, param_dtype=pdt, device=device)
        self.ffn_block = FFNBlock(cfg.d_model, cfg.d_ffn, cfg.dropout, cfg.rms_norm_eps,
                                  cfg.num_layers, dtype, pdt, device=device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.causal_attention_block.reset_parameters(generator)
        self.cross_attention_block.reset_parameters(generator)
        self.ffn_block.reset_parameters(generator)

    def forward(self, x, text_embeddings, causal_padding_mask, cross_padding_mask, cache,
                grid_w: int, layer_idx: int, deterministic: bool = True, paged_cache=None,
                rope_angles=None, dropout_seed: Optional[Seed] = None):
        cfg = self.cfg
        x, new_cache = self.causal_attention_block(
            x, causal=cfg.use_causal,
            left_window=cfg.left_window if cfg.use_windowed_attn else -1,
            right_window=cfg.right_window, padding_mask=causal_padding_mask,
            cache=cache, paged_cache=paged_cache, layer_idx=layer_idx,
            grid_shape=(grid_w,), rope_angles=rope_angles,
            deterministic=deterministic, dropout_seed=dropout_seed)
        x = self.cross_attention_block(x, text_embeddings, cross_padding_mask,
                                       deterministic=deterministic,
                                       dropout_seed=dropout_seed, layer_idx=layer_idx)
        x = self.ffn_block(x, deterministic=deterministic, dropout_seed=dropout_seed,
                           layer_idx=layer_idx)
        return x, new_cache


class AutoregressiveImageTransformer(nn.Module):
    """The AR transformer over codebook indices, on ``device`` (the card
    unless the caller asks for the CPU), weights from ``seed``."""

    def __init__(self, cfg: ImageGenArgs, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = resolve_dtype(cfg.dtype)
        pdt = resolve_dtype(cfg.param_dtype)
        self.embedding_proj = nn.Embedding(cfg.num_embeddings, cfg.d_model, dtype=pdt,
                                           device=dev)
        self.layers = nn.ModuleList(
            [ARImageTransformerBlock(cfg, device=dev) for _ in range(cfg.num_layers)])
        self.norm = RMSNorm(cfg.d_model, cfg.rms_norm_eps, self.dtype, pdt, device=dev)
        self.to_logits = nn.Linear(cfg.d_model, cfg.num_embeddings, bias=False, dtype=pdt,
                                   device=dev)
        if dev.type != "meta":
            self.reset_parameters(torch.Generator(device=dev).manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.norm.weight.device

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        embed_init_(self.embedding_proj.weight, generator)
        for layer in self.layers:
            layer.reset_parameters(generator)
        with torch.no_grad():
            self.norm.weight.fill_(1.0)
        head_init_(self.to_logits.weight, generator)

    def rope_angles(self, positions: torch.Tensor, grid_w: int):
        """The forward's (cos, sin) table at ``positions`` over a raster grid
        ``grid_w`` wide (every layer rotates by the same angles)."""
        cfg = self.cfg
        return rope_2d_ntk_cos_sin(positions, cfg.head_dim, grid_w, cfg.rope_theta,
                                   cfg.ntk_scale_factor if cfg.use_ntk_rope else None)

    def forward(
        self,
        encoding_indices: torch.Tensor,
        text_embeddings: torch.Tensor,
        causal_padding_mask: Optional[torch.Tensor] = None,
        cross_padding_mask: Optional[torch.Tensor] = None,
        cache: Optional[KVCache] = None,
        paged_cache: Optional[PagedKVCache] = None,
        grid_w: Optional[int] = None,
        return_logits: bool = False,
        deterministic: bool = True,
        dropout_seed: Optional[Seed] = None,
    ):
        """encoding_indices [B, H, W] (full forward) or [B, T] raster tokens
        (with ``grid_w``; cached decode); text_embeddings [B, T_txt, d].

        Returns features [B, H, W, d] (or [B, T, d]), or with
        ``return_logits`` (fp32 logits [B, T, num_embeddings], cache).  A
        cache is written at its length and advanced by T (a paged cache by
        each row's true count)."""
        cfg = self.cfg
        spatial = encoding_indices.dim() == 3
        if spatial:
            b, h_grid, w_grid = encoding_indices.shape
            flat = encoding_indices.reshape(b, h_grid * w_grid)
            grid_w = w_grid
        else:
            if grid_w is None:
                raise ValueError("grid_w required for flattened token input")
            b = encoding_indices.shape[0]
            flat = encoding_indices
        t = flat.shape[1]
        seed = _step_seed(deterministic, cfg.dropout, dropout_seed)
        x = embed_rows(self.embedding_proj.weight, flat).to(self.dtype)
        x = dropout(x, cfg.dropout, deterministic=deterministic, seed=seed, layer=-1,
                    site=SITE_EMBED)

        steps = torch.arange(t, device=x.device)
        if paged_cache is not None:
            positions = paged_cache.lengths[:, None] + steps[None, :]
        elif cache is not None:
            positions = cache.length + steps
        else:
            positions = steps
        angles = self.rope_angles(positions, grid_w)

        remat = (cfg.use_checkpointing and not deterministic and torch.is_grad_enabled()
                 and cache is None and paged_cache is None)
        # a fresh paged cache lets every layer's T > 1 window skip the page
        # gather; layer 0's append clears the flag, so re-pin it for the rest
        fresh0 = paged_cache is not None and paged_cache.fresh and t > 1
        for i, layer in enumerate(self.layers):
            if fresh0 and i > 0:
                paged_cache.fresh = True
            args = (x, text_embeddings, causal_padding_mask, cross_padding_mask, cache,
                    grid_w, i, deterministic, paged_cache, angles, seed)
            if remat:
                x, _ = checkpoint(layer, *args, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, _ = layer(*args)
        if fresh0:
            paged_cache.fresh = False
        new_cache = cache
        if paged_cache is not None:
            if causal_padding_mask is not None and t > 1:
                counts = causal_padding_mask.to(torch.int32).sum(dim=1)
            else:
                counts = torch.full((b,), t, dtype=torch.int32, device=x.device)
            new_cache = paged_cache.advance_by(counts)
        elif cache is not None:
            new_cache = cache.advance(t)

        x = self.norm(x)
        if return_logits:
            return dense(self.to_logits, x, self.dtype).float(), new_cache
        return x.reshape(b, h_grid, w_grid, cfg.d_model) if spatial else x

    def init_cache(self, batch_size: int, max_len: Optional[int] = None) -> KVCache:
        cfg = self.cfg
        return KVCache.create(
            num_layers=cfg.num_layers, batch_size=batch_size,
            max_seq_len=max_len or cfg.max_position_embeddings,
            kv_heads=cfg.query_groups, head_dim=cfg.head_dim, dtype=self.dtype,
            device=self.device)

    def init_paged_cache(self, batch_size: int, max_len: Optional[int] = None,
                         page_size: int = 128) -> PagedKVCache:
        cfg = self.cfg
        return PagedKVCache.create(
            num_layers=cfg.num_layers, batch_size=batch_size,
            max_seq_len=max_len or cfg.max_position_embeddings,
            kv_heads=cfg.query_groups, head_dim=cfg.head_dim, page_size=page_size,
            dtype=self.dtype, device=self.device)


# ---------------------------------------------------------------------------
# VQ-VAE
# ---------------------------------------------------------------------------


def _activation(name: str):
    return {"relu": F.relu, "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
            "sigmoid": torch.sigmoid}[name]


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator=None):
    """flax's default conv kernel init: variance_scaling(1, 'fan_in',
    'truncated_normal'), truncated at two standard deviations."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` over the channels of NCHW activations: ``scale``
    and ``bias`` parameters, fp32 running ``mean`` / ``var`` buffers
    updated as momentum * running + (1 - momentum) * batch (the biased
    variance)."""

    def __init__(self, features: int, dtype: torch.dtype, param_dtype: torch.dtype,
                 momentum: float = 0.99, eps: float = 1e-5, device=None):
        super().__init__()
        self.dtype = dtype
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, dtype=param_dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=param_dtype, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, dtype=torch.float32, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, dtype=torch.float32, device=device))

    def reset_parameters(self):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, use_running_average: bool) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            x32 = x.float()
            axes = [0] + list(range(2, x.dim()))
            mean = x32.mean(dim=axes)
            var = torch.clamp(x32.square().mean(dim=axes) - mean.square(), min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.float().reshape(shape)
        return y.to(self.dtype)


class VQVAEEncoder(nn.Module):
    """Conv(4, s2) -> BN -> act twice, then Conv(3, s1) -> BN -> act:
    [B, C, H, W] -> NHWC [B, H/4, W/4, d]."""

    SPECS = ((4, 2), (4, 2), (3, 1))

    def __init__(self, cfg: ImageGenArgs, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = resolve_dtype(cfg.dtype)
        pdt = resolve_dtype(cfg.param_dtype)
        ins = (cfg.C_in_out, cfg.d_model, cfg.d_model)
        self.convs = nn.ModuleList([
            nn.Conv2d(c, cfg.d_model, k, s, padding=1, dtype=pdt, device=device)
            for c, (k, s) in zip(ins, self.SPECS)])
        self.bns = nn.ModuleList([BatchNorm(cfg.d_model, self.dtype, pdt, device=device)
                                  for _ in self.SPECS])

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for conv, bn in zip(self.convs, self.bns):
            _lecun_normal_(conv.weight, conv.weight[0].numel(), generator)
            with torch.no_grad():
                conv.bias.zero_()
            bn.reset_parameters()

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        act = _activation(self.cfg.vae_encoder_activation)
        x = x.to(self.dtype)
        for conv, bn in zip(self.convs, self.bns):
            x = F.conv2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                         conv.stride, conv.padding)
            x = act(bn(x, use_running_average=deterministic))
        return x.permute(0, 2, 3, 1)


class VQVAEDecoder(nn.Module):
    """ConvT(3, s1) -> BN -> act, ConvT(4, s2) -> BN -> act, ConvT(4, s2)
    -> sigmoid: NHWC [B, H', W', d] -> [B, C, 4H', 4W']."""

    def __init__(self, cfg: ImageGenArgs, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = resolve_dtype(cfg.dtype)
        pdt = resolve_dtype(cfg.param_dtype)
        specs = ((3, 1, cfg.d_model), (4, 2, cfg.d_model), (4, 2, cfg.C_in_out))
        self.deconvs = nn.ModuleList([
            nn.ConvTranspose2d(cfg.d_model, out, k, s, padding=1, dtype=pdt, device=device)
            for k, s, out in specs])
        self.bns = nn.ModuleList([BatchNorm(cfg.d_model, self.dtype, pdt, device=device)
                                  for _ in range(2)])

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for deconv in self.deconvs:
            w = deconv.weight  # [in, out, kH, kW]; flax's fan_in is kH * kW * in
            _lecun_normal_(w, w.shape[0] * w.shape[2] * w.shape[3], generator)
            with torch.no_grad():
                deconv.bias.zero_()
        for bn in self.bns:
            bn.reset_parameters()

    def forward(self, z_q: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        act = _activation(self.cfg.vae_encoder_activation)
        x = z_q.to(self.dtype).permute(0, 3, 1, 2)
        for i, deconv in enumerate(self.deconvs):
            x = F.conv_transpose2d(x, deconv.weight.to(self.dtype),
                                   deconv.bias.to(self.dtype), deconv.stride, deconv.padding)
            if i < 2:
                x = act(self.bns[i](x, use_running_average=deterministic))
        return torch.sigmoid(x)


class VectorQuantizer(nn.Module):
    """L2-nearest codebook row with the straight-through estimator; the
    loss is ``mse(sg(z_q), z) + beta * mse(z_q, sg(z))`` (the JAX package's
    sides of the stop-gradient, kept)."""

    def __init__(self, cfg: ImageGenArgs, device=None):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Parameter(torch.empty(
            cfg.num_embeddings, cfg.d_model, dtype=resolve_dtype(cfg.param_dtype),
            device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        e = self.cfg.num_embeddings
        with torch.no_grad():
            self.embedding.uniform_(-1.0 / e, 1.0 / e, generator=generator)

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """z [..., d] (image latents [B, H, W, d], video latents [B, T, H,
        W, d]) -> (z_q in z's dtype, fp32 loss, indices z.shape[:-1])."""
        shape = z.shape
        zf = z.reshape(-1, shape[-1]).float()
        cb = self.embedding.float()
        with no_tf32():  # the distances decide an argmin
            prod = zf @ cb.T
        d2 = zf.square().sum(dim=1, keepdim=True) - 2.0 * prod + cb.square().sum(dim=1)[None, :]
        indices = torch.argmin(d2, dim=-1)
        z_q = embed_rows(cb, indices).reshape(shape)
        z32 = z.float()
        codebook_loss = (z_q.detach() - z32).square().mean()
        commit_loss = (z_q - z32.detach()).square().mean()
        loss = codebook_loss + self.cfg.commitment_beta * commit_loss
        z_q = z32 + (z_q - z32).detach()
        return z_q.to(z.dtype), loss, indices.reshape(shape[:-1])


class VQVAE(nn.Module):
    """encode -> quantize -> the AR transformer on the indices -> decode,
    on ``device`` (the card unless the caller asks for the CPU), weights
    from ``seed``.  Returns (reconstruction, vq_loss, indices,
    transformer_out)."""

    def __init__(self, cfg: ImageGenArgs, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.encoder = VQVAEEncoder(cfg, device=dev)
        self.quantizer = VectorQuantizer(cfg, device=dev)
        self.model = AutoregressiveImageTransformer(cfg, device=dev)
        self.decoder = VQVAEDecoder(cfg, device=dev)
        if dev.type != "meta":
            self.reset_parameters(torch.Generator(device=dev).manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.quantizer.embedding.device

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.encoder.reset_parameters(generator)
        self.quantizer.reset_parameters(generator)
        self.model.reset_parameters(generator)
        self.decoder.reset_parameters(generator)

    def forward(self, images: torch.Tensor, text_embeddings: torch.Tensor,
                image_attention_mask: Optional[torch.Tensor] = None,
                text_attention_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True, dropout_seed: Optional[Seed] = None):
        z = self.encoder(images, deterministic=deterministic)
        z_q, vq_loss, indices = self.quantizer(z)
        causal_mask = None
        if image_attention_mask is not None:
            b, _, h, w = images.shape
            hd, wd = z.shape[1], z.shape[2]
            m = image_attention_mask.reshape(b, 1, h, w).float()
            # jax.image.resize 'nearest' samples at half-pixel centres
            m = F.interpolate(m, size=(hd, wd), mode="nearest-exact")
            causal_mask = m.reshape(b, hd * wd) > 0.5
        transformer_out = self.model(indices, text_embeddings,
                                     causal_padding_mask=causal_mask,
                                     cross_padding_mask=text_attention_mask,
                                     deterministic=deterministic, dropout_seed=dropout_seed)
        recon = self.decoder(z_q, deterministic=deterministic)
        return recon, vq_loss, indices, transformer_out
