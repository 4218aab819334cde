"""NLP (MoE decoder LLM) configuration dataclasses.

The port's own copy of ``vats_tpu/configs/nlp.py``: the same field names,
defaults, validation and size tiers, so a config moves between the two
packages unchanged (``tests/test_torch_configs.py`` checks the fields).
``gradient_checkpointing`` and ``remat_policy`` are honoured by the training
forward (``models/text_lm.py``: 'full' checkpoints each block, 'dots' saves
the weight-matmul outputs); ``scan_layers`` is kept so configs carry over and
is a no-op here (the layers are a Python loop).  ``dropout_rng_impl`` is a
JAX PRNG choice and is ignored (dropout masks come from explicit
``torch.Generator`` seeds).
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import NamedTuple, Optional, Tuple


@dataclass(unsafe_hash=True)
class ModelArgs:
    d_model: int = 256
    num_heads: int = 16
    query_groups: int = 2
    softmax_scale: Optional[float] = None
    d_ffn: int = 1024
    num_layers: int = 8
    dropout: float = 0.1
    rope_base: float = 10000.0
    rms_norm_eps: float = 1e-7
    left_window: int = 128
    right_window: int = 0
    vocab_size: int = 512
    max_seq_len: int = 128
    tie_weights: bool = True
    max_batch_size: int = 2048
    gradient_checkpointing: bool = True
    use_proj_bias: bool = False
    use_qkv_proj: bool = True
    use_causal: bool = True
    use_mqa: bool = True
    use_cache: bool = False
    num_experts: int = 1
    top_k: int = 1
    use_qk_norm: bool = True
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    attention_impl: str = "auto"  # 'auto' | 'xla' (plain PyTorch) | 'flash'
    context_parallel: str = "none"  # 'none' | 'ring' | 'ulysses'
    moe_dispatch: str = "auto"  # 'auto' | 'dense' | 'scatter' | 'sort'
    capacity_factor: float = -1.0  # <=0: lossless dispatch
    moe_double_norm: bool = True
    scan_layers: bool = False
    remat_policy: str = "full"
    apply_window_in_xla: bool = True  # honor the sliding window in attention

    def __post_init__(self):
        if self.softmax_scale is None:
            self.softmax_scale = 1.0 / math.sqrt(self.d_model // self.num_heads)
        validate_model_args(self)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ModelArgs":
        known = {k: v for k, v in d.items() if k in cls.__dataclass_fields__}
        return cls(**known)


def validate_model_args(args: ModelArgs) -> None:
    if args.d_model % args.num_heads != 0:
        raise ValueError(
            f"d_model ({args.d_model}) must be divisible by num_heads "
            f"({args.num_heads})"
        )
    if args.num_heads % args.query_groups != 0:
        raise ValueError(
            f"num_heads ({args.num_heads}) must be divisible by query_groups "
            f"({args.query_groups})"
        )
    if args.d_ffn <= 0:
        raise ValueError(f"d_ffn must be positive, got {args.d_ffn}")
    if args.num_experts < args.top_k:
        raise ValueError(
            f"num_experts ({args.num_experts}) must be >= top_k ({args.top_k})"
        )
    if not args.use_causal:
        raise ValueError("use_causal must be True for causal language modeling")
    if args.right_window != 0:
        raise ValueError(
            f"right_window must be 0 for causal language modeling, got "
            f"{args.right_window}"
        )
    if args.left_window == 0:
        raise ValueError("left_window must be nonzero (use -1 for unbounded)")


# --- per-layer attention kinds (a port-only extension) -----------------------

#: the two attention kinds of :class:`HybridModelArgs` layers (HF's names)
SLIDING, FULL = "sliding_attention", "full_attention"


@dataclass(unsafe_hash=True)
class HybridModelArgs(ModelArgs):
    """A ``ModelArgs`` whose layers attend by kinds of their own: the port's
    extension for published models with mixed sliding-window and full
    attention (Mellum2), which the JAX package has no counterpart of.

    ``layer_types`` gives each layer's kind: ``SLIDING`` layers attend a
    window (``left_window``: query q sees key k iff 0 <= q - k <=
    left_window, on every path, the paged decode's K1 included) and rotate
    by plain 1-D RoPE at ``rope_base``; ``FULL`` layers attend the whole
    causal context and rotate by YaRN (``nn/rope.yarn_inv_freq``) when
    ``yarn_factor`` > 1, else by plain RoPE.  ``head_dim`` is the heads'
    width, decoupled from ``d_model // num_heads``; the default softmax
    scale is ``head_dim ** -0.5``."""

    head_dim: int = 0  # 0: d_model // num_heads
    layer_types: Tuple[str, ...] = ()
    yarn_factor: float = 1.0
    yarn_original_max_position: int = 0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_attention_factor: Optional[float] = None

    def __post_init__(self):
        if not self.head_dim:
            self.head_dim = self.d_model // self.num_heads
        self.layer_types = tuple(self.layer_types)
        if self.softmax_scale is None:
            self.softmax_scale = 1.0 / math.sqrt(self.head_dim)
        if len(self.layer_types) != self.num_layers:
            raise ValueError(f"layer_types has {len(self.layer_types)} entries for "
                             f"{self.num_layers} layers")
        bad = sorted(set(self.layer_types) - {SLIDING, FULL})
        if bad:
            raise ValueError(f"unknown layer types {bad}")
        if SLIDING in self.layer_types and self.left_window < 0:
            raise ValueError("sliding layers need a left_window >= 1")
        if self.head_dim % 2:
            raise ValueError(f"head_dim ({self.head_dim}) must be even for RoPE")
        if self.yarn_factor > 1 and self.yarn_original_max_position <= 0:
            raise ValueError("YaRN needs yarn_original_max_position")
        super().__post_init__()


def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    """DeepSeek's ``yarn_get_mscale``: 0.1 mscale ln(factor) + 1 above a
    factor of 1, else 1."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


@dataclass(unsafe_hash=True)
class LatentModelArgs(ModelArgs):
    """A ``ModelArgs`` whose layers attend by multi-head latent attention
    (MLA, DeepSeek-V2) over shared and routed experts: the port's extension
    for DeepSeek-V2-style models, which the JAX package has no counterpart
    of.

    Attention (no q LoRA): q_proj maps d_model to ``num_heads`` heads of
    ``qk_nope_head_dim + qk_rope_head_dim``; kv_a_proj maps it to a latent
    of ``kv_lora_rank`` (RMSNorm'd) and one ``qk_rope_head_dim`` key part
    shared by every head; kv_b_proj maps the latent to each head's
    ``qk_nope_head_dim`` key part and ``v_head_dim`` value; o_proj maps the
    heads' values back.  RoPE (interleaved pairs, YaRN when ``yarn_factor``
    > 1) rotates the rope parts alone; its cos and sin are scaled by
    yarn_mscale(factor, ``yarn_mscale``) / yarn_mscale(factor,
    ``yarn_mscale_all_dim``), and the default softmax scale is
    (nope + rope)^-0.5 times yarn_mscale(factor, ``yarn_mscale_all_dim``)
    squared (when that is set).  A paged cache holds one latent vector a
    token (``kv_lora_rank + qk_rope_head_dim``).

    Feed-forward: the first ``first_k_dense_replace`` layers are a dense
    SwiGLU of ``dense_d_ffn``; the rest route to ``num_experts`` experts of
    ``d_ffn`` top ``top_k`` (weights renormalised only with
    ``norm_topk_prob``; ``routed_scaling_factor`` must be 1, the only
    value a configuration here uses) beside
    ``n_shared_experts`` shared ones, one SwiGLU of ``n_shared_experts *
    d_ffn`` that every token passes through.  ``query_groups`` is the
    head count (MLA has no grouped KV heads)."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_shared_experts: int = 0
    first_k_dense_replace: int = 0
    dense_d_ffn: int = 0
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    yarn_factor: float = 1.0
    yarn_original_max_position: int = 0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0

    def __post_init__(self):
        self.query_groups = self.num_heads
        if self.softmax_scale is None:
            scale = (self.qk_nope_head_dim + self.qk_rope_head_dim) ** -0.5
            if self.yarn_mscale_all_dim:
                scale *= yarn_mscale(self.yarn_factor, self.yarn_mscale_all_dim) ** 2
            self.softmax_scale = scale
        if self.qk_rope_head_dim % 2:
            raise ValueError(f"qk_rope_head_dim ({self.qk_rope_head_dim}) must be even "
                             "for RoPE")
        if not 0 <= self.first_k_dense_replace <= self.num_layers:
            raise ValueError(f"first_k_dense_replace ({self.first_k_dense_replace}) out of "
                             f"[0, {self.num_layers}]")
        if self.first_k_dense_replace and self.dense_d_ffn <= 0:
            raise ValueError("dense layers need a dense_d_ffn > 0")
        if self.yarn_factor > 1 and self.yarn_original_max_position <= 0:
            raise ValueError("YaRN needs yarn_original_max_position")
        if self.routed_scaling_factor != 1:
            raise ValueError(f"routed_scaling_factor ({self.routed_scaling_factor}) must be 1: "
                             "no other value is implemented")
        super().__post_init__()

    @property
    def latent_dim(self) -> int:
        """Width of the one vector a paged cache holds a token a layer."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def rope_scale(self) -> float:
        """The factor on YaRN's cos and sin (1 without YaRN)."""
        if self.yarn_factor <= 1:
            return 1.0
        return (yarn_mscale(self.yarn_factor, self.yarn_mscale)
                / yarn_mscale(self.yarn_factor, self.yarn_mscale_all_dim))


class LayerAttention(NamedTuple):
    """How one layer attends: ``left_window`` on every path but the paged
    decode, ``decode_window`` in the paged decode (K1), its RoPE
    (``'1d'`` or ``'yarn'``) and the span its attention runs under."""

    left_window: int
    decode_window: int
    rope: str
    span: str


def layer_attention(cfg: ModelArgs, i: int) -> LayerAttention:
    """Layer ``i``'s attention.  A plain ``ModelArgs`` gives every layer
    ``left_window`` (when ``apply_window_in_xla``) everywhere but in the
    paged decode, which attends every settled token, as the JAX package's
    does; a :class:`HybridModelArgs` layer applies its kind's window on
    every path; a :class:`LatentModelArgs` layer attends the whole causal
    context by MLA."""
    if isinstance(cfg, LatentModelArgs):
        return LayerAttention(-1, -1, "yarn" if cfg.yarn_factor > 1 else "1d", "attn.mla")
    if isinstance(cfg, HybridModelArgs):
        if cfg.layer_types[i] == SLIDING:
            return LayerAttention(cfg.left_window, cfg.left_window, "1d", "attn.window")
        return LayerAttention(-1, -1, "yarn" if cfg.yarn_factor > 1 else "1d", "attn.full")
    lw = cfg.left_window if cfg.apply_window_in_xla and cfg.left_window is not None else -1
    return LayerAttention(lw, -1, "1d", "attn.window" if lw >= 0 else "attn.full")


# --- size tiers ------------------------------------------------------------


def nlp_xsmall(**overrides) -> ModelArgs:
    base = dict(
        d_model=256,
        num_heads=16,
        query_groups=2,
        d_ffn=1024,
        num_layers=8,
        dropout=0.1,
        rope_base=10000.0,
        rms_norm_eps=1e-7,
        left_window=128,
        right_window=0,
        vocab_size=512,
        max_seq_len=128,
        tie_weights=True,
        max_batch_size=2048,
        gradient_checkpointing=True,
        use_qkv_proj=True,
        use_mqa=True,
        num_experts=1,
        top_k=1,
        softmax_scale=math.sqrt(256 // 16),
    )
    base.update(overrides)
    return ModelArgs(**base)


def nlp_small(**overrides) -> ModelArgs:
    base = dict(
        d_model=768,
        num_heads=32,
        query_groups=8,
        d_ffn=768 * 4,
        num_layers=10,
        dropout=0.1,
        left_window=256,
        vocab_size=32768,
        max_seq_len=512,
        max_batch_size=1024,
        gradient_checkpointing=False,
        use_mqa=False,
        num_experts=1,
        top_k=1,
    )
    base.update(overrides)
    return ModelArgs(**base)


def nlp_medium(**overrides) -> ModelArgs:
    base = dict(
        d_model=1440,
        num_heads=24,
        query_groups=8,
        d_ffn=5760,
        num_layers=20,
        dropout=0.2,
        left_window=384,
        vocab_size=65536,
        max_seq_len=4096,
        max_batch_size=1024,
        gradient_checkpointing=True,
        use_mqa=False,
        num_experts=1,
        top_k=1,
    )
    base.update(overrides)
    return ModelArgs(**base)


def nlp_large(**overrides) -> ModelArgs:
    """32 experts / top-2 MoE, MQA, 32k context."""
    base = dict(
        d_model=4096,
        num_heads=32,
        query_groups=8,
        d_ffn=14336,
        num_layers=32,
        dropout=0.2,
        left_window=512,
        vocab_size=65536,
        max_seq_len=32768,
        max_batch_size=2048,
        gradient_checkpointing=True,
        use_mqa=True,
        num_experts=32,
        top_k=2,
    )
    base.update(overrides)
    return ModelArgs(**base)


def nlp_xlarge(**overrides) -> ModelArgs:
    """64 experts / top-2 MoE."""
    base = dict(
        d_model=5120,
        num_heads=40,
        query_groups=10,
        d_ffn=20480,
        num_layers=40,
        dropout=0.2,
        left_window=1024,
        vocab_size=65536,
        max_seq_len=32768,
        tie_weights=False,
        max_batch_size=2048,
        gradient_checkpointing=False,
        use_mqa=True,
        num_experts=64,
        top_k=2,
    )
    base.update(overrides)
    return ModelArgs(**base)


def mellum2_12b(**overrides) -> HybridModelArgs:
    """Mellum2-12B-A2.5B-Instruct at its published values
    (huggingface.co/JetBrains/Mellum2-12B-A2.5B-Instruct, config.json): 28
    layers of hidden 2304, 32 query and 4 KV heads of 128, three sliding
    layers (window 1024: ``left_window`` 1023) then one full, every layer
    64 experts of 896 top-8 renormalised, RoPE theta 500000 with YaRN
    (factor 16 over 8192, beta 32 / 1, attention factor 1.27726) on the full
    layers, eps 1e-6, vocabulary 98304, untied head, no attention bias, no
    QK-norm and one pre-norm to the experts.  Serving settings: no dropout,
    bf16."""
    base = dict(
        d_model=2304,
        num_heads=32,
        query_groups=4,
        head_dim=128,
        d_ffn=896,
        num_layers=28,
        num_experts=64,
        top_k=8,
        layer_types=(SLIDING, SLIDING, SLIDING, FULL) * 7,
        left_window=1023,
        rope_base=500000.0,
        yarn_factor=16.0,
        yarn_original_max_position=8192,
        yarn_beta_fast=32.0,
        yarn_beta_slow=1.0,
        yarn_attention_factor=1.2772588722239782,
        rms_norm_eps=1e-6,
        vocab_size=98304,
        max_seq_len=131072,
        tie_weights=False,
        use_qk_norm=False,
        moe_double_norm=False,
        use_mqa=False,
        dropout=0.0,
        gradient_checkpointing=False,
        capacity_factor=-1.0,
        dtype="bfloat16",
        param_dtype="bfloat16",
    )
    base.update(overrides)
    return HybridModelArgs(**base)


def deepseek_v2_lite(**overrides) -> LatentModelArgs:
    """DeepSeek-V2-Lite at its published values
    (huggingface.co/deepseek-ai/DeepSeek-V2-Lite, config.json): 27 layers
    of hidden 2048, MLA with 16 heads (no q LoRA, latent 512, nope 128,
    rope 64, v 128), RoPE theta 10000 with YaRN (factor 40 over 4096, beta
    32 / 1, mscale = mscale_all_dim = 0.707), layer 0 a dense SwiGLU of
    10944, layers 1-26 64 experts of 1408 top-6 (softmax, not
    renormalised, x 1) beside 2 shared experts, eps 1e-6, vocabulary
    102400, untied head, no attention bias.  Serving settings: no dropout,
    bf16, lossless routing."""
    base = dict(
        d_model=2048,
        num_heads=16,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        d_ffn=1408,
        num_layers=27,
        num_experts=64,
        top_k=6,
        n_shared_experts=2,
        first_k_dense_replace=1,
        dense_d_ffn=10944,
        norm_topk_prob=False,
        routed_scaling_factor=1.0,
        rope_base=10000.0,
        yarn_factor=40.0,
        yarn_original_max_position=4096,
        yarn_beta_fast=32.0,
        yarn_beta_slow=1.0,
        yarn_mscale=0.707,
        yarn_mscale_all_dim=0.707,
        rms_norm_eps=1e-6,
        vocab_size=102400,
        max_seq_len=163840,
        tie_weights=False,
        use_qk_norm=False,
        moe_double_norm=False,
        use_mqa=False,
        left_window=-1,
        dropout=0.0,
        gradient_checkpointing=False,
        capacity_factor=-1.0,
        dtype="bfloat16",
        param_dtype="bfloat16",
    )
    base.update(overrides)
    return LatentModelArgs(**base)


NLP_TIERS = {
    "xsmall": nlp_xsmall,
    "small": nlp_small,
    "medium": nlp_medium,
    "large": nlp_large,
    "xlarge": nlp_xlarge,
}


@dataclass
class TrainingArgs:
    """The JAX package's training arguments, every field and default."""

    learning_rate: float = 6e-4
    batch_size: int = 32
    epsilon: float = 1e-6
    clip_grad_norm: float = 1.0
    weight_decay: float = 5e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    warmup_ratio: float = 0.05
    aux_loss_weight: float = 0.01
    eta_min: float = 6e-7
    num_cycles: float = 0.5
    grad_accum_steps: int = 4
    logging_steps: int = 100
    eval_steps: int = 500
    save_steps: int = 500
    max_eval_batches: int = 250
    max_skipped_steps: int = 1000
    max_train_tokens: int = 1_000_000_000
    seed: int = 42
    # chunk size of the fused readout + cross-entropy
    # (train/metrics.py:fused_linear_cross_entropy); None = full-logits CE
    fused_ce_chunk: Optional[int] = None
    # dtype of AdamW's first moment; None = fp32 (the second stays fp32)
    adam_mu_dtype: Optional[str] = None
    # the JAX package's dropout PRNG implementation; not read here
    dropout_rng_impl: str = "rbg"


@dataclass
class GenerationArgs:
    max_new_tokens: int = 256
    temperature: float = 0.7
    top_k: int = 50
    top_p: float = 0.95
    do_sample: bool = True
    pad_token_id: Optional[int] = None
    eos_token_id: Optional[int] = None
    use_cache: bool = True
    repetition_penalty: float = 1.7
    return_only_new_tokens: bool = True
    generation_frequency: int = 10_000
