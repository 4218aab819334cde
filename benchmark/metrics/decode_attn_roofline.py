"""The paged decode-attention kernel's share of its roofline in the traced
span, in percent: the least time of every decode forward's attention
(each needed row's valid history read once, q in, out and the committed
K/V out, against its q.k and p.v; ``benchmark/work.py``) over the device
time of the kernels whose name holds ``KERNELS``."""

KERNELS = ("paged_decode_kernel",)


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    dev = sum(s for name, s in tr["by_name"].items() if any(k in name for k in KERNELS))
    least = tr["counters"].get("decode_attn_least_s", 0.0)
    if dev <= 0 or least <= 0:
        return None
    return 100.0 * least / dev
