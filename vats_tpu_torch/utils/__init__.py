from vats_tpu_torch.utils.convert import params_from_jax, unstack_scan_params

__all__ = ["params_from_jax", "unstack_scan_params"]
