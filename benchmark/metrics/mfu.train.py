"""The whole training step's share of the chip's bf16 peak in the traced
span, in percent: model FLOPs (6 x the parameters a token multiplies, the
top-k experts only, plus attention's forward and backward over the attended
pairs; no recompute) of the traced micro-steps over span x 989 TFLOP/s."""

from benchmark.work import PEAK_BF16_FLOPS


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0 or not tr["counters"].get("model_flops"):
        return None
    return 100.0 * tr["counters"]["model_flops"] / (tr["window_s"] * PEAK_BF16_FLOPS)
