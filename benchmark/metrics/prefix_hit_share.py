"""The prefix cache's hit share over the window, in percent: prompt tokens
served from cached pages over prompt tokens admitted (the change of the
engine's ``prefix_cache.hit_tokens`` / ``query_tokens``)."""


def read(rec):
    c = rec["counters"]
    if not c.get("prefix_query_tokens"):
        return None
    return 100.0 * c["prefix_hit_tokens"] / c["prefix_query_tokens"]
