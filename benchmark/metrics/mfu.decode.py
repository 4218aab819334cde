"""The whole serving step's share of the chip's peak in the traced span, in
percent: the sum over every forward (decode and prefill) of its least time,
the larger of its FLOPs over 989 TFLOP/s and its bytes (weights read, KV
read and written) over 3.35 TB/s, divided by the span (``benchmark/work.py``)."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0 or not tr["counters"].get("forward_least_s"):
        return None
    return 100.0 * tr["counters"]["forward_least_s"] / tr["window_s"]
