"""The image tower's attention forward (K1 at ViT-L/14) against its
roofline: the least time of the traced requests' real rows (padding rows
are no work) over the card time of the hand-written attention groups,
in %."""

from benchmark.metrics._shares import attention_share


def read(m):
    if m["work"].get("kind") != "search":
        return None
    return attention_share(m)
