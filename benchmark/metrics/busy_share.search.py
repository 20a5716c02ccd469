"""The card's busy share of the traced requests: the union of its
intervals over the traced span's length, in %."""

from benchmark.metrics._shares import busy_share


def read(m):
    return busy_share(m) if m["work"].get("kind") == "search" else None
