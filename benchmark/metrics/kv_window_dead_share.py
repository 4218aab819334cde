"""The share of the K/V pool's bytes in use that windowed layers hold at
positions their decode no longer attends (more than the layer's window
behind the row's length), in percent, averaged over the window's steps:
what a pool kept per layer kind could free.  From the engine's host
counters (``kv_window_dead_bytes`` over ``kv_bytes_in_use``), read after
every step with no device sync."""


def read(rec):
    c = rec["counters"]
    if not c.get("kv_share_steps"):
        return None
    return 100.0 * c["kv_dead_share_sum"] / c["kv_share_steps"]
