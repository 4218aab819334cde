"""Device busy milliseconds per output token in the traced span: the union
of the device's operation intervals over the tokens the engine gave the
host there."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["counters"].get("output_tokens"):
        return None
    return tr["busy_s"] * 1e3 / tr["counters"]["output_tokens"]
