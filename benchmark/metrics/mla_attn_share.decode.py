"""The device time of an eager decode forward under the program's
``attn.mla`` spans (each layer's latent attention between its projections:
RoPE, the latent append, the absorption through W_UK, K9, W_UV) over all of
its device time, in percent: the device seconds launched beneath
``serve.dispatch`` in the driver's probe after the window
(``decode_probe``: eager engine steps under their own profiler,
``spans.probe_serve``).  Eager and replayed decode forwards run the same
kernels in the same order."""

from benchmark.spans import under


def read(rec):
    dev = (rec.get("decode_probe") or {}).get("device_s")
    if not dev:
        return None
    block = under(dev, beneath="serve.dispatch")
    if block <= 0:
        return None
    return 100.0 * under(dev, "attn.mla", beneath="serve.dispatch") / block
