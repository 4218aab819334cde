"""MoE decoder language model (the flagship workload).

Counterpart of ``vats_tpu/models/text_lm.py``:

  token embed -> dropout -> N x (AttentionBlock -> MoEBlock) -> RMSNorm
  -> lm_head (optionally tied to the embedding)

returning ``(logits, cache, total_aux_loss)``.  Caches are updated in place
and also returned, so call sites read like the JAX ones.

Training (``deterministic=False`` under autograd, no cache): dropout masks
come from ``dropout_seed`` and each (layer, site) (``nn/dropout.py``), and
``gradient_checkpointing`` wraps each block in
``torch.utils.checkpoint.checkpoint`` as ``_remat_block`` wraps it in
``nn.remat``: ``remat_policy='full'`` saves the block inputs only, 'dots'
also saves every weight-matmul output (``aten.mm`` / ``aten.addmm``, the
products with no batch dimension, as ``dots_with_no_batch_dims_saveable``)
and recomputes the rest, attention included.  ``scan_layers`` is a no-op:
the layers are a Python loop either way.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from vats_tpu_torch.configs.nlp import LatentModelArgs, ModelArgs, layer_attention
from vats_tpu_torch.device import resolve_device, resolve_dtype
from vats_tpu_torch.nn.activations import FFNBlock
from vats_tpu_torch.nn.attention import AttentionBlock, dense, embed_rows
from vats_tpu_torch.nn.dropout import SITE_EMBED, Seed, dropout
from vats_tpu_torch.nn.initializers import embed_init_, head_init_
from vats_tpu_torch.nn.kv_cache import KVCache
from vats_tpu_torch.nn.mla import MLABlock
from vats_tpu_torch.nn.moe import MoEBlock
from vats_tpu_torch.nn.norms import RMSNorm
from vats_tpu_torch.parallel.layout import gathered


class TransformerBlock(nn.Module):
    """Attention block followed by MoE block; threads cache and aux loss.
    Layer ``layer_idx`` attends by its kind (``configs.nlp.layer_attention``:
    its windows, its RoPE, its span).  A ``LatentModelArgs`` layer attends
    by MLA (``nn/mla.MLABlock``) and, below ``first_k_dense_replace``, runs
    a dense SwiGLU (``nn/activations.FFNBlock``, ``ffn_block``) in place of
    the experts; its experts carry the shared ones and the router's
    options."""

    def __init__(self, cfg: ModelArgs, device=None, layer_idx: int = 0):
        super().__init__()
        self.cfg = cfg
        self.kind = kind = layer_attention(cfg, layer_idx)
        dtype = resolve_dtype(cfg.dtype)
        param_dtype = resolve_dtype(cfg.param_dtype)
        if isinstance(cfg, LatentModelArgs):
            self.attn_block = MLABlock(cfg, device=device)
            if layer_idx < cfg.first_k_dense_replace:
                self.ffn_block = FFNBlock(cfg.d_model, cfg.dense_d_ffn, cfg.dropout,
                                          cfg.rms_norm_eps, cfg.num_layers, dtype, param_dtype,
                                          device=device)
                return
            extra = dict(shared_d_ffn=cfg.n_shared_experts * cfg.d_ffn,
                         norm_topk_prob=cfg.norm_topk_prob)
            self._moe_block(cfg, dtype, param_dtype, device, **extra)
            return
        yarn = None
        if kind.rope == "yarn":
            yarn = (cfg.yarn_factor, cfg.yarn_original_max_position, cfg.yarn_beta_fast,
                    cfg.yarn_beta_slow, cfg.yarn_attention_factor or 1.0)
        self.attn_block = AttentionBlock(
            d_model=cfg.d_model,
            num_heads=cfg.num_heads,
            query_groups=cfg.query_groups,
            rope_theta=cfg.rope_base,
            softmax_scale=cfg.softmax_scale,
            use_proj_bias=cfg.use_proj_bias,
            use_qkv_proj=cfg.use_qkv_proj,
            use_qk_norm=cfg.use_qk_norm,
            dropout=cfg.dropout,
            eps=cfg.rms_norm_eps,
            num_layers=cfg.num_layers,
            impl=cfg.attention_impl,
            context_parallel=cfg.context_parallel,
            dtype=dtype,
            param_dtype=param_dtype,
            device=device,
            head_dim=cfg.head_dim,
            rope_type=kind.rope,
            yarn=yarn,
            span=kind.span,
        )
        self._moe_block(cfg, dtype, param_dtype, device)

    def _moe_block(self, cfg, dtype, param_dtype, device, **extra):
        self.moe_block = MoEBlock(
            d_model=cfg.d_model,
            d_ffn=cfg.d_ffn,
            num_experts=cfg.num_experts,
            top_k=cfg.top_k,
            dropout=cfg.dropout,
            eps=cfg.rms_norm_eps,
            double_norm=cfg.moe_double_norm,
            dispatch=cfg.moe_dispatch,
            capacity_factor=cfg.capacity_factor,
            num_layers=cfg.num_layers,
            dtype=dtype,
            param_dtype=param_dtype,
            device=device,
            **extra,
        )

    @property
    def ffn(self) -> nn.Module:
        """The layer's feed-forward block: its experts, or a dense layer's
        SwiGLU."""
        return self.ffn_block if hasattr(self, "ffn_block") else self.moe_block

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.attn_block.reset_parameters(generator)
        self.ffn.reset_parameters(generator)

    def forward(
        self,
        x: torch.Tensor,
        padding_mask: Optional[torch.Tensor] = None,
        cache: Optional[KVCache] = None,
        segment_ids: Optional[torch.Tensor] = None,
        paged_cache=None,
        layer_idx: int = 0,
        deterministic: bool = True,
        dropout_seed: Optional[Seed] = None,
    ):
        cfg = self.cfg
        x, new_cache = self.attn_block(
            x,
            causal=cfg.use_causal,
            left_window=self.kind.left_window,
            decode_left_window=self.kind.decode_window,
            right_window=cfg.right_window,
            padding_mask=padding_mask,
            cache=cache,
            paged_cache=paged_cache,
            layer_idx=layer_idx,
            segment_ids=segment_ids,
            deterministic=deterministic,
            dropout_seed=dropout_seed,
        )
        if hasattr(self, "ffn_block"):
            x = self.ffn_block(x, deterministic=deterministic, dropout_seed=dropout_seed,
                               layer_idx=layer_idx)
            return x, new_cache, torch.zeros((), dtype=torch.float32, device=x.device)
        x, aux_loss = self.moe_block(x, deterministic=deterministic,
                                     dropout_seed=dropout_seed, layer_idx=layer_idx)
        return x, new_cache, aux_loss


#: ops whose outputs remat_policy='dots' keeps for the backward
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS_SAVED:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context_fn(policy: str):
    """``context_fn`` for ``checkpoint`` under a ``remat_policy``; None for
    'full' (save the block inputs only)."""
    if policy == "full":
        return None
    if policy == "dots":
        return functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    raise ValueError(f"unknown remat_policy {policy!r}")


class TextLM(nn.Module):
    """The MoE text LM, built on ``device`` (the card unless the caller asks
    for the CPU) with weights drawn from ``torch.Generator`` seeded by
    ``seed``.  ``device="meta"`` builds the shapes only, for
    ``load_state_dict(..., assign=True)``."""

    def __init__(self, cfg: ModelArgs, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = resolve_dtype(cfg.dtype)
        param_dtype = resolve_dtype(cfg.param_dtype)
        self.token_embed = nn.Embedding(
            cfg.vocab_size, cfg.d_model, dtype=param_dtype, device=dev
        )
        self.layers = nn.ModuleList(
            [TransformerBlock(cfg, device=dev, layer_idx=i) for i in range(cfg.num_layers)]
        )
        self.norm = RMSNorm(cfg.d_model, cfg.rms_norm_eps, self.dtype, param_dtype,
                            device=dev)
        self.lm_head = (
            None
            if cfg.tie_weights
            else nn.Linear(cfg.d_model, cfg.vocab_size, bias=False,
                           dtype=param_dtype, device=dev)
        )
        if dev.type != "meta":
            self.reset_parameters(torch.Generator(device=dev).manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.token_embed.weight.device

    def param_logical_axes(self):
        axes = {"token_embed.weight": ("vocab", "embed")}
        if self.lm_head is not None:
            axes["lm_head.weight"] = ("vocab", "embed")
        return axes

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        embed_init_(self.token_embed.weight, generator)
        for layer in self.layers:
            layer.reset_parameters(generator)
        with torch.no_grad():
            self.norm.weight.fill_(1.0)
        if self.lm_head is not None:
            head_init_(self.lm_head.weight, generator)

    def forward(
        self,
        input_ids: torch.Tensor,
        padding_mask: Optional[torch.Tensor] = None,
        cache: Optional[KVCache] = None,
        segment_ids: Optional[torch.Tensor] = None,
        paged_cache=None,
        deterministic: bool = True,
        readout_positions: Optional[torch.Tensor] = None,
        return_hidden: bool = False,
        dropout_seed: Optional[Seed] = None,
    ):
        """input_ids [B, T] -> (logits [B, T, V] fp32, cache, aux_loss).

        padding_mask [B, T] bool, True = valid (a dense cache also takes a
        [B, max_seq_len] buffer mask).  A cache is appended at its length
        and advanced by T (a paged cache by each row's true count).
        readout_positions [B]: logits only at these positions ([B, 1, V]).
        return_hidden: return the post-norm hidden states instead of logits.
        dropout_seed: the step's dropout seed (the JAX ``rngs={'dropout':
        key}``), an int or an int64 device tensor (a graph's static seed);
        drawn from the default CPU generator when dropout is on and none is
        given.
        """
        cfg = self.cfg
        if not deterministic and cfg.dropout > 0 and dropout_seed is None:
            dropout_seed = int(torch.randint(0, 1 << 62, (1,)))
        x = self.embed(input_ids)
        x = dropout(x, cfg.dropout, deterministic=deterministic,
                    seed=dropout_seed, layer=-1, site=SITE_EMBED)
        remat = (cfg.gradient_checkpointing and not deterministic
                 and torch.is_grad_enabled() and cache is None
                 and paged_cache is None)
        if remat:
            ckpt = dict(use_reentrant=False, preserve_rng_state=False)
            context_fn = _remat_context_fn(cfg.remat_policy)
            if context_fn is not None:
                ckpt["context_fn"] = context_fn
        total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new_cache = cache
        new_paged = paged_cache
        # a fresh paged cache lets every layer's prefill skip the page
        # gather; layer 0's append clears the flag, so re-pin it for the rest
        fresh0 = bool(getattr(paged_cache, "fresh", False))
        for i, layer in enumerate(self.layers):
            if fresh0 and i > 0:
                new_paged.fresh = True
            args = (x, padding_mask, new_cache, segment_ids, new_paged, i,
                    deterministic, dropout_seed)
            if remat:
                x, returned, aux = checkpoint(layer, *args, **ckpt)
            else:
                x, returned, aux = layer(*args)
            if paged_cache is not None:
                new_paged = returned
            else:
                new_cache = returned
            total_aux = total_aux + aux.float()
        if fresh0:
            new_paged.fresh = False

        t = input_ids.shape[1]
        if paged_cache is not None:
            # ragged advance: each row gains its true token count
            if padding_mask is not None and t > 1:
                counts = padding_mask.to(torch.int32).sum(dim=1)
            else:
                counts = torch.full((input_ids.shape[0],), t, dtype=torch.int32,
                                    device=x.device)
            new_cache = new_paged.advance_by(counts)
        elif new_cache is not None:
            new_cache = new_cache.advance(t)

        x = self.norm(x)
        if readout_positions is not None:
            idx = readout_positions.long()[:, None, None].expand(-1, 1, x.shape[-1])
            x = torch.gather(x, 1, idx)
        if return_hidden:
            return x, new_cache, total_aux
        return self.unembed(x), new_cache, total_aux

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """The token embedding of ``input_ids``, in the compute dtype."""
        return embed_rows(gathered(self.token_embed.weight), input_ids).to(self.dtype)

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 logits of post-norm hidden states: the tied embedding's
        ``attend`` or ``lm_head``."""
        if self.lm_head is None:
            # flax Embed.attend: both operands in the compute dtype
            w = gathered(self.token_embed.weight)
            logits = F.linear(x.to(w.dtype).to(self.dtype), w.to(self.dtype))
        else:
            logits = dense(self.lm_head, x, self.dtype)
        return logits.float()

    def init_cache(
        self, batch_size: int, max_seq_len: Optional[int] = None, ring: bool = False
    ) -> KVCache:
        """A dense cache on the model's device; ``ring=True`` allocates a
        sliding-window ring of ``max_seq_len`` slots."""
        cfg = self.cfg
        return KVCache.create(
            num_layers=cfg.num_layers,
            batch_size=batch_size,
            max_seq_len=max_seq_len or cfg.max_seq_len,
            kv_heads=cfg.query_groups,
            head_dim=cfg.head_dim,
            dtype=self.dtype,
            ring=ring,
            device=self.device,
        )
