from vats_tpu_torch.models.text_lm import TextLM, TransformerBlock

__all__ = ["TextLM", "TransformerBlock"]
