"""Device busy milliseconds per 1,000 trained tokens in the traced span."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["counters"].get("tokens"):
        return None
    return tr["busy_s"] * 1e3 / (tr["counters"]["tokens"] / 1000.0)
