"""Mean live rows per decode forward over the window (the engine's rows
that needed the forward's token), from the harness's count of each decode
block's rows."""


def read(rec):
    c = rec["counters"]
    if not c.get("decode_forwards"):
        return None
    return c["decode_rows"] / c["decode_forwards"]
