from vats_tpu_torch.data.synthetic import synthetic_lm_batches

__all__ = ["synthetic_lm_batches"]
