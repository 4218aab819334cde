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
from typing import Optional, Tuple


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
