"""The whole request's share of the card's bf16 peak: a query's model
FLOPs (the image tower's forward plus the search's 2 * N * D; padding rows
are no model work) times the untraced window's queries/s, over 989
TFLOP/s, in %."""

from benchmark import flops


def read(m):
    w = m["work"]
    if w.get("kind") != "search":
        return None
    return 100.0 * flops.mfu(w["untraced_queries_per_s"],
                             w["flops_per_query"])
