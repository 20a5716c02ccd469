"""The card's busy share of the traced train steps: the union of its
intervals over the traced span's length, in %."""

from benchmark.metrics._shares import busy_share


def read(m):
    return busy_share(m) if m["work"].get("kind") == "train" else None
