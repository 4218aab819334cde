"""The training flash kernels' share of their roofline in the traced span,
in percent: the least time of every layer's attention forward and backward
over the attended pairs that the causal, segment-masked micro-batches need
(``benchmark/work.py``), over the device time of the kernels whose name
holds one of ``KERNELS`` (the forward with its log-sum-exp, recomputed
under remat too, and the two backward kernels)."""

KERNELS = ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel",
           "flash_fwd_f32_kernel", "flash_bwd_dq_f32_kernel", "flash_bwd_dkv_f32_kernel")


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    dev = sum(s for name, s in tr["by_name"].items() if any(k in name for k in KERNELS))
    least = tr["counters"].get("flash_least_s", 0.0)
    if dev <= 0 or least <= 0:
        return None
    return 100.0 * least / dev
