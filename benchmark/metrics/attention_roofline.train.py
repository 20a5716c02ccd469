"""The train step's attention kernels (K1, K2d, K3 and the bodies they
fall back to) against their roofline: the least time of the traced span's
attention work (forward and backward, `flops.attention_*_bound_s`) over
the card time of the hand-written attention groups, in %."""

from benchmark.metrics._shares import attention_share


def read(m):
    if m["work"].get("kind") != "train":
        return None
    return attention_share(m)
