"""Carry ``vats_tpu`` TextLM, ViT-2D and ViT-3D weights across into the port.

:func:`params_from_jax` takes the JAX ``TextLM`` parameter tree as nested
dicts of numpy arrays (``{"params": ...}`` or the inner dict; flax's
partitioning boxes already unwrapped) and returns a ``state_dict`` for
:class:`vats_tpu_torch.models.TextLM`:

  * a flax ``Dense`` kernel is ``[in, out]``; a torch ``Linear`` weight is
    ``[out, in]``, so kernels are transposed;
  * the stacked expert weights ``[E, d, f]`` / ``[E, f, d]`` stay stacked;
  * a scan-mode tree (``layers/block`` stacked on axis 0) is first unstacked
    into ``layer_{i}`` subtrees, in numpy, as ``TextLM.unstack_scan_params``
    does.

Given a ``ViT2DArgs`` or ``ViT3DArgs`` config, :func:`params_from_jax`
does the same for ``ImageEncoder`` or ``VideoTransformer``; a flax ``Conv``
kernel is HWIO (DHWIO), a torch one OIHW (OIDHW), and flax's auto-names
(``RMSNorm_0``, ``SwiGLU_0``, ``Attention_0``) map onto the port's
attributes.  The JAX vision models have no scan mode.

Given an ``ImageGenArgs`` config it carries any tree of the image-generation
stack, told apart by its keys: the ``TransformerTextEncoder``, the
``AutoregressiveImageTransformer``, the ``VQVAEEncoder``, the
``VQVAEDecoder``, the ``VectorQuantizer`` (the codebook), or the whole
``VQVAE``; a variables dict (``{"params", "batch_stats"}``) brings its
BatchNorm running statistics into the port's fp32 ``running_mean`` /
``running_var`` buffers.  A flax ``ConvTranspose`` kernel (kH, kW, in, out)
becomes the (in, out, kH, kW) weight of ``conv_transpose2d``, flipped in
both spatial axes.

Given a ``VideoGenArgs`` config it carries any tree of the video-generation
stack, told apart the same way: the ``AutoregressiveVideoTransformer``, the
``Encoder3D``, the ``Decoder3D``, the quantizer's codebook, or the whole
``VQVAE3D`` with its ``batch_stats``.  A flax ``Conv`` kernel (kT, kH, kW,
in, out) becomes OIDHW; a ``ConvTranspose`` one becomes the (in, out, kT,
kH, kW) weight of ``conv_transpose3d``, flipped in all three spatial axes.
Given a ``MultimodalStreamArgs`` config it carries the ``MultimodalLM``.

A gradient tree has the params' structure, so the same function carries JAX
gradients across for a leaf-by-leaf comparison with the port's ``.grad``,
and optax's moments and accumulated gradients into the port's optimizer
state (:func:`train_state_from_jax`).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from vats_tpu_torch.configs.image_gen import ImageGenArgs
from vats_tpu_torch.configs.multimodal import MultimodalStreamArgs
from vats_tpu_torch.configs.nlp import ModelArgs, TrainingArgs
from vats_tpu_torch.configs.video_gen import VideoGenArgs
from vats_tpu_torch.configs.vit2d import ViT2DArgs
from vats_tpu_torch.configs.vit3d import ViT3DArgs
from vats_tpu_torch.device import resolve_dtype
from vats_tpu_torch.train.optimizer import (
    AdamWState,
    ClipSkipState,
    MultiSteps,
    MultiStepsState,
)
from vats_tpu_torch.train.state import TrainState, create_train_state


def unstack_scan_params(params: Mapping, num_layers: int) -> dict:
    """Scan-mode params ('layers' stacked on axis 0) -> 'layer_{i}' subtrees."""
    p = dict(params)
    stacked = p.pop("layers")["block"]

    def take(tree, i):
        if isinstance(tree, Mapping):
            return {k: take(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    for i in range(num_layers):
        p[f"layer_{i}"] = take(stacked, i)
    return p


class _StateDict(dict):
    """A state dict filled from numpy leaves, each copied as fp32 and cast
    to ``dtype``."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype

    def put(self, name, arr, perm=None, dtype=None):
        a = np.array(arr, dtype=np.float32)  # an owned, writable copy
        if perm is not None:
            a = np.ascontiguousarray(a.transpose(perm))
        self[name] = torch.from_numpy(a).to(dtype or self.dtype)

    def put_dense(self, prefix, tree):
        """flax Dense / DenseGeneral ``kernel`` [in, out] -> Linear [out, in]."""
        self.put(f"{prefix}.weight", tree["kernel"], perm=(1, 0))
        if "bias" in tree:
            self.put(f"{prefix}.bias", tree["bias"])

    def put_ffn(self, prefix, tree):
        """FFNBlock: RMSNorm_0 and SwiGLU_0 (w_gate, w_up, w_down as [in, out])."""
        self.put(f"{prefix}.norm.weight", tree["RMSNorm_0"]["weight"])
        for name in ("w_gate", "w_up", "w_down"):
            self.put(f"{prefix}.swiglu.{name}.weight", tree["SwiGLU_0"][name], perm=(1, 0))


def _vit2d_params_from_jax(params_np: Mapping, cfg: ViT2DArgs,
                          dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """JAX ImageEncoder params (numpy) -> port ImageEncoder state_dict."""
    p = params_np.get("params", params_np)
    sd = _StateDict(dtype or resolve_dtype(cfg.param_dtype))
    pe = p["patch_embeddings"]["proj"]
    sd.put("patch_embeddings.proj.weight", pe["kernel"], perm=(3, 2, 0, 1))  # HWIO -> OIHW
    sd.put("patch_embeddings.proj.bias", pe["bias"])
    names = ("w_qkv", "w_o") if cfg.use_fused_proj else ("w_q", "w_k", "w_v", "w_o")
    for i in range(cfg.num_layers):
        lp = p[f"layer_{i}"]
        ab = lp["attention_block"]
        pre = f"layers.{i}.attention_block"
        sd.put(f"{pre}.norm.weight", ab["RMSNorm_0"]["weight"])
        for name in names:
            sd.put_dense(f"{pre}.attn.{name}", ab["Attention_0"][name])
        sd.put_ffn(f"layers.{i}.ffn_block", lp["ffn_block"])
    sd.put("norm.weight", p["RMSNorm_0"]["weight"])
    if cfg.num_classes is not None:
        sd.put_dense("classifier", p["classifier"])
    return dict(sd)


def _vit3d_params_from_jax(params_np: Mapping, cfg: ViT3DArgs,
                          dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """JAX VideoTransformer params (numpy) -> port VideoTransformer state_dict."""
    p = params_np.get("params", params_np)
    sd = _StateDict(dtype or resolve_dtype(cfg.param_dtype))
    sd.put("patch_embeddings.projection.weight",
           p["patch_embeddings"]["projection"]["kernel"], perm=(4, 3, 0, 1, 2))  # DHWIO -> OIDHW
    for i in range(cfg.num_layers):
        lp = p[f"layer_{i}"]
        ab = lp["attention_block"]
        pre = f"layers.{i}.attention_block"
        sd.put(f"{pre}.norm.weight", ab["RMSNorm_0"]["weight"])
        for name in ("w_qkv", "w_o"):
            sd.put_dense(f"{pre}.attention.{name}", ab["attention"][name])
        sd.put_ffn(f"layers.{i}.ffn_block", lp["ffn_block"])
    sd.put("norm.weight", p["RMSNorm_0"]["weight"])
    if cfg.use_classifier_head:
        sd.put_dense("classifier", p["classifier"])
    return dict(sd)


def _put_attention(sd: _StateDict, prefix: str, ab: Mapping, fused: bool) -> None:
    """An AttentionBlock (RMSNorm_0, Attention_0)."""
    sd.put(f"{prefix}.norm.weight", ab["RMSNorm_0"]["weight"])
    for name in ("w_qkv", "w_o") if fused else ("w_q", "w_k", "w_v", "w_o"):
        sd.put_dense(f"{prefix}.attn.{name}", ab["Attention_0"][name])


def _put_bn(sd: _StateDict, prefix: str, p: Mapping, stats: Mapping) -> None:
    """flax BatchNorm: scale / bias parameters, fp32 running statistics."""
    sd.put(f"{prefix}.weight", p["scale"])
    sd.put(f"{prefix}.bias", p["bias"])
    if stats:
        sd.put(f"{prefix}.running_mean", stats["mean"], dtype=torch.float32)
        sd.put(f"{prefix}.running_var", stats["var"], dtype=torch.float32)


def _image_gen_into(sd: _StateDict, prefix: str, p: Mapping, stats: Mapping,
                    cfg: ImageGenArgs) -> None:
    """One tree of the image-generation stack into ``sd`` under ``prefix``."""
    fused = cfg.use_qkv_proj
    if "token_embed" in p:  # TransformerTextEncoder
        sd.put(f"{prefix}token_embed.weight", p["token_embed"]["embedding"])
        for i in range(cfg.text_num_layers):
            _put_attention(sd, f"{prefix}attn_blocks.{i}", p[f"attn_{i}"], fused)
            sd.put_ffn(f"{prefix}ffn_blocks.{i}", p[f"ffn_{i}"])
        sd.put(f"{prefix}norm.weight", p["RMSNorm_0"]["weight"])
    elif "embedding_proj" in p:  # AutoregressiveImageTransformer
        sd.put(f"{prefix}embedding_proj.weight", p["embedding_proj"]["embedding"])
        for i in range(cfg.num_layers):
            lp, pre = p[f"layer_{i}"], f"{prefix}layers.{i}"
            _put_attention(sd, f"{pre}.causal_attention_block",
                           lp["causal_attention_block"], fused)
            cb = lp["cross_attention_block"]
            sd.put(f"{pre}.cross_attention_block.norm.weight", cb["RMSNorm_0"]["weight"])
            for name in ("w_q", "w_k", "w_v", "w_o"):
                sd.put_dense(f"{pre}.cross_attention_block.attn.{name}",
                             cb["CrossAttention_0"][name])
            sd.put_ffn(f"{pre}.ffn_block", lp["ffn_block"])
        sd.put(f"{prefix}norm.weight", p["RMSNorm_0"]["weight"])
        sd.put_dense(f"{prefix}to_logits", p["to_logits"])
    elif "conv1" in p:  # VQVAEEncoder: HWIO -> OIHW
        for i in range(3):
            c = p[f"conv{i + 1}"]
            sd.put(f"{prefix}convs.{i}.weight", c["kernel"], perm=(3, 2, 0, 1))
            sd.put(f"{prefix}convs.{i}.bias", c["bias"])
            _put_bn(sd, f"{prefix}bns.{i}", p[f"bn{i + 1}"], stats.get(f"bn{i + 1}"))
    elif "deconv1" in p:  # VQVAEDecoder: (kH, kW, in, out) flipped -> (in, out, kH, kW)
        for i in range(3):
            c = p[f"deconv{i + 1}"]
            sd.put(f"{prefix}deconvs.{i}.weight", np.asarray(c["kernel"])[::-1, ::-1],
                   perm=(2, 3, 0, 1))
            sd.put(f"{prefix}deconvs.{i}.bias", c["bias"])
            if i < 2:
                _put_bn(sd, f"{prefix}bns.{i}", p[f"bn{i + 1}"], stats.get(f"bn{i + 1}"))
    elif set(p) == {"embedding"}:  # VectorQuantizer
        sd.put(f"{prefix}embedding", p["embedding"])
    else:  # VQVAE
        for name in ("encoder", "quantizer", "model", "decoder"):
            _image_gen_into(sd, f"{prefix}{name}.", p[name], stats.get(name, {}), cfg)


def _image_gen_params_from_jax(tree: Mapping, cfg: ImageGenArgs,
                               dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """A JAX image-generation tree (params, or variables with
    batch_stats; numpy) -> the port module's state_dict."""
    sd = _StateDict(dtype or resolve_dtype(cfg.param_dtype))
    _image_gen_into(sd, "", tree.get("params", tree), tree.get("batch_stats", {}), cfg)
    return dict(sd)


def _put_factorized(sd: _StateDict, prefix: str, p: Mapping) -> None:
    """A factorized (causal or cross) attention of the video transformer."""
    for name in ("q_proj", "k_proj", "v_proj", "spatio_temporal_proj", "o_proj"):
        sd.put_dense(f"{prefix}.{name}", p[name])


def _video_gen_into(sd: _StateDict, prefix: str, p: Mapping, stats: Mapping,
                    cfg: VideoGenArgs) -> None:
    """One tree of the video-generation stack into ``sd`` under ``prefix``."""
    if set(p) == {"embedding"}:  # the quantizer's codebook
        sd.put(f"{prefix}embedding", p["embedding"])
    elif "layer_0" in p:  # AutoregressiveVideoTransformer
        sd.put(f"{prefix}embedding.weight", p["embedding"]["embedding"])
        for i in range(cfg.num_layers):
            lp, pre = p[f"layer_{i}"], f"{prefix}layers.{i}"
            sd.put(f"{pre}.norm1.weight", lp["RMSNorm_0"]["weight"])
            sd.put(f"{pre}.norm2.weight", lp["RMSNorm_1"]["weight"])
            _put_factorized(sd, f"{pre}.attention", lp["attention"])
            _put_factorized(sd, f"{pre}.cross_attention", lp["cross_attention"])
            sd.put_ffn(f"{pre}.ffn_block", lp["ffn_block"])
        sd.put(f"{prefix}norm.weight", p["RMSNorm_0"]["weight"])
        sd.put_dense(f"{prefix}to_logits", p["to_logits"])
    elif "conv1" in p:  # Encoder3D: DHWIO -> OIDHW
        for i in range(3):
            c = p[f"conv{i + 1}"]
            sd.put(f"{prefix}convs.{i}.weight", c["kernel"], perm=(4, 3, 0, 1, 2))
            sd.put(f"{prefix}convs.{i}.bias", c["bias"])
            _put_bn(sd, f"{prefix}bns.{i}", p[f"bn{i + 1}"], stats.get(f"bn{i + 1}"))
    elif "deconv1" in p:  # Decoder3D: (kT, kH, kW, in, out) flipped -> (in, out, kT, kH, kW)
        for i in range(3):
            c = p[f"deconv{i + 1}"]
            sd.put(f"{prefix}deconvs.{i}.weight", np.asarray(c["kernel"])[::-1, ::-1, ::-1],
                   perm=(3, 4, 0, 1, 2))
            sd.put(f"{prefix}deconvs.{i}.bias", c["bias"])
            if i < 2:
                _put_bn(sd, f"{prefix}bns.{i}", p[f"bn{i + 1}"], stats.get(f"bn{i + 1}"))
    else:  # VQVAE3D
        for name in ("encoder", "quantizer", "decoder"):
            _video_gen_into(sd, f"{prefix}{name}.", p[name], stats.get(name, {}), cfg)


def _multimodal_params_from_jax(p: Mapping, cfg: MultimodalStreamArgs,
                                dtype: Optional[torch.dtype] = None
                                ) -> Dict[str, torch.Tensor]:
    """JAX MultimodalLM params (numpy) -> port MultimodalLM state_dict."""
    sd = _StateDict(dtype or resolve_dtype(cfg.param_dtype))
    sd.put("token_embed.weight", p["token_embed"]["embedding"])
    for i in range(cfg.num_layers):
        _put_attention(sd, f"attn_blocks.{i}", p[f"attn_{i}"], cfg.use_qkv_proj)
        sd.put_ffn(f"ffn_blocks.{i}", p[f"ffn_{i}"])
    sd.put("norm.weight", p["RMSNorm_0"]["weight"])
    if not cfg.tie_weights:
        sd.put_dense("lm_head", p["lm_head"])
    return dict(sd)


def params_from_jax(params_np: Mapping, cfg,
                    dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """JAX TextLM params (numpy) -> port TextLM state_dict, in ``dtype``
    (by default cfg.param_dtype); a ViT2DArgs or ViT3DArgs config carries
    the vision model of that config instead, an ImageGenArgs or
    VideoGenArgs config any tree of that generation stack (params, or
    variables with batch_stats), a MultimodalStreamArgs config the
    MultimodalLM."""
    if isinstance(cfg, ImageGenArgs):
        return _image_gen_params_from_jax(params_np, cfg, dtype)
    if isinstance(cfg, VideoGenArgs):
        sd = _StateDict(dtype or resolve_dtype(cfg.param_dtype))
        _video_gen_into(sd, "", params_np.get("params", params_np),
                        params_np.get("batch_stats", {}), cfg)
        return dict(sd)
    if isinstance(cfg, MultimodalStreamArgs):
        return _multimodal_params_from_jax(params_np.get("params", params_np), cfg, dtype)
    if isinstance(cfg, ViT2DArgs):
        return _vit2d_params_from_jax(params_np, cfg, dtype)
    if isinstance(cfg, ViT3DArgs):
        return _vit3d_params_from_jax(params_np, cfg, dtype)
    p = params_np.get("params", params_np)
    if "layers" in p:
        p = unstack_scan_params(p, cfg.num_layers)
    sd = _StateDict(dtype or resolve_dtype(cfg.param_dtype))
    sd.put("token_embed.weight", p["token_embed"]["embedding"])
    names = ("w_qkv", "w_o") if cfg.use_qkv_proj else ("w_q", "w_k", "w_v", "w_o")
    for i in range(cfg.num_layers):
        lp = p[f"layer_{i}"]
        ab = lp["attn_block"]
        pre = f"layers.{i}.attn_block"
        sd.put(f"{pre}.norm.weight", ab["RMSNorm_0"]["weight"])
        for name in names:
            sd.put_dense(f"{pre}.attn.{name}", ab["Attention_0"][name])
        mb = lp["moe_block"]
        pre = f"layers.{i}.moe_block"
        sd.put(f"{pre}.norm.weight", mb["RMSNorm_0"]["weight"])
        ml = mb["MoELayer_0"]
        if cfg.moe_double_norm:
            sd.put(f"{pre}.moe.norm.weight", ml["RMSNorm_0"]["weight"])
        sd.put(f"{pre}.moe.router.router.weight", ml["TopKRouter_0"]["router"],
               perm=(1, 0))
        sd.put(f"{pre}.moe.router.router.bias", ml["TopKRouter_0"]["router_bias"])
        ex = ml["ExpertSwiGLU_0"]
        for name in ("w_gate", "w_up", "w_down"):
            sd.put(f"{pre}.moe.experts.{name}", ex[name])
    sd.put("norm.weight", p["RMSNorm_0"]["weight"])
    if not cfg.tie_weights:
        sd.put("lm_head.weight", p["lm_head"]["kernel"], perm=(1, 0))
    return dict(sd)


def _unbox(tree):
    """Nested dicts with flax's partitioning boxes taken off (duck-typed:
    a box has ``unbox()``), leaves as they are."""
    if callable(getattr(tree, "unbox", None)):
        return _unbox(tree.unbox())
    if isinstance(tree, Mapping):
        return {k: _unbox(v) for k, v in tree.items()}
    return tree


def _copy_tree(dst: Dict[str, torch.Tensor], tree_np, cfg: ModelArgs, what: str) -> None:
    """A JAX tree of the params' structure, converted as the params are,
    copied into ``dst`` (a name -> tensor dict, dtype and device kept)."""
    leaves = _unbox(tree_np)
    dtype = next(iter(dst.values())).dtype
    for leaf in _leaves(leaves):
        if (str(np.asarray(leaf).dtype) == "bfloat16") != (dtype == torch.bfloat16):
            raise ValueError(f"{what}: the JAX state holds {np.asarray(leaf).dtype}, the "
                             f"port's optimizer {dtype} (another adam_mu_dtype)")
    for name, t in params_from_jax(leaves, cfg, dtype=dtype).items():
        dst[name].copy_(t)


def _leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _adamw_from_jax(dst: AdamWState, chain, cfg: ModelArgs) -> None:
    """optax.adamw's state (ScaleByAdamState, EmptyState,
    ScaleByScheduleState) into the port's AdamWState."""
    adam, sched = chain[0], chain[2]
    if int(adam.count) != int(sched.count):
        raise ValueError(f"adam count {int(adam.count)} != schedule count "
                         f"{int(sched.count)}: the port keeps one count")
    dst.count.fill_(int(adam.count))
    _copy_tree(dst.mu, adam.mu, cfg, "mu")
    _copy_tree(dst.nu, adam.nu, cfg, "nu")


def train_state_from_jax(state_np, model, training_args: TrainingArgs, tx) -> TrainState:
    """A ``vats_tpu`` TrainState with numpy leaves (for instance
    ``load_checkpoint(path, target=jax.device_get(state))``) as the port's
    TrainState over ``model`` (a port TextLM of the same config, on the
    device the state should live on; its parameters are overwritten).

    ``tx`` is the port's optimizer for ``training_args``.  Both layouts of
    ``vats_tpu/train/optimizer.py`` are carried: bare ``optax.adamw``
    (``grad_accum_steps <= 1``) into :class:`AdamWState`, and
    ``MultiSteps(clip_and_skip_nonfinite(adamw))`` into
    :class:`MultiStepsState` / :class:`ClipSkipState`.  Moments and
    accumulated gradients have the params' structure and go through the
    params' mapping (kernels transposed), in the port's moment dtypes."""
    cfg = model.cfg
    model.load_state_dict(params_from_jax(_unbox(state_np.params), cfg))
    accum = training_args.grad_accum_steps > 1
    jopt = state_np.opt_state
    if accum != isinstance(tx, MultiSteps) or accum != hasattr(jopt, "mini_step"):
        raise ValueError("the JAX optimizer state, the port's tx and grad_accum_steps="
                         f"{training_args.grad_accum_steps} disagree on the layout")
    state = create_train_state(model, tx)
    with torch.no_grad():
        if accum:
            ms: MultiStepsState = state.opt_state
            ms.mini_step = int(jopt.mini_step)
            ms.gradient_step.fill_(int(jopt.gradient_step))
            _copy_tree(ms.acc_grads, jopt.acc_grads, cfg, "acc_grads")
            cs: ClipSkipState = ms.inner_opt_state
            jcs = jopt.inner_opt_state
            cs.notfinite_count.fill_(int(jcs.notfinite_count))
            cs.last_grad_norm.fill_(float(np.asarray(jcs.last_grad_norm)))
            _adamw_from_jax(cs.inner_state, jcs.inner_state, cfg)
        else:
            _adamw_from_jax(state.opt_state, jopt, cfg)
        for name in ("step", "tokens_seen", "skipped_steps"):
            getattr(state, name).fill_(int(getattr(state_np, name)))
    return state
