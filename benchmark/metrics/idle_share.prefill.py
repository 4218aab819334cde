"""The device's idle share of the traced span of a prefill-heavy serving cell, in
percent: 1 - (union of operation intervals) / span."""

from benchmark.harness import idle_percent


def read(rec):
    return idle_percent(rec)
