"""The latent decode kernel's share of its roofline in the traced span, in
percent: the least time of every decode forward's K9 calls (each row's
latent vectors read once, 1,152 bytes a token, q in and the latent output
out, against 2 x 16 x keys x (576 + 512) FLOPs; ``benchmark/work_mla.py``)
over the device time of the kernels whose name holds ``KERNELS``."""

KERNELS = ("mla_decode_kernel",)


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    dev = sum(s for name, s in tr["by_name"].items() if any(k in name for k in KERNELS))
    least = tr["counters"].get("mla_decode_least_s", 0.0)
    if dev <= 0 or least <= 0:
        return None
    return 100.0 * least / dev
