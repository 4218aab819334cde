"""The device time of an eager decode forward under the program's
``attn.window`` spans (the window layers' attention between their
projections: K3's prologue, then K1) over all of its device time, in
percent: the device seconds launched beneath ``serve.dispatch`` in the
driver's probe after the window (``decode_probe``: eager engine steps
under their own profiler, ``spans.probe_serve``).  Eager and replayed
decode forwards run the same kernels in the same order."""

from benchmark.spans import under


def read(rec):
    dev = (rec.get("decode_probe") or {}).get("device_s")
    if not dev:
        return None
    block = under(dev, beneath="serve.dispatch")
    if block <= 0:
        return None
    return 100.0 * under(dev, "attn.window", beneath="serve.dispatch") / block
