from vats_tpu_torch.data.feed import device_batches
from vats_tpu_torch.data.synthetic import synthetic_lm_batches

__all__ = ["device_batches", "synthetic_lm_batches"]
