from vats_tpu_torch.configs.nlp import (
    NLP_TIERS,
    GenerationArgs,
    ModelArgs,
    TrainingArgs,
    nlp_large,
    nlp_medium,
    nlp_small,
    nlp_xlarge,
    nlp_xsmall,
    validate_model_args,
)

__all__ = [
    "NLP_TIERS",
    "GenerationArgs",
    "ModelArgs",
    "TrainingArgs",
    "nlp_large",
    "nlp_medium",
    "nlp_small",
    "nlp_xlarge",
    "nlp_xsmall",
    "validate_model_args",
]
