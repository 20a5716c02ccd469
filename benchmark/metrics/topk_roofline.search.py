"""The exact top-k (K4 and its pass 2) against its roofline: the least
time of the traced requests' searches (`flops.topk_bound_s`: the keys read
once a request, 2 * Bq * N * D at bf16's peak) over the card time of the
K4 groups, in %."""

from benchmark import flops
from benchmark.metrics._shares import group_ms, share


def read(m):
    w = m["work"]
    if w.get("kind") != "search":
        return None
    bound = sum(flops.topk_bound_s(*c) for c in w["topk_calls"])
    return share(bound, group_ms(m["aggregate"],
                                 lambda g: g.startswith("K4")))
