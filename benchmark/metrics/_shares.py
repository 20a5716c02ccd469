"""What the per-layer readers share: the card time of kernel groups in the
traced span's aggregate, and the roofline share of a piece of work."""

from benchmark import flops


def group_ms(agg, keep) -> float:
    """Card ms of the categories (hand-written kernel groups) `keep` takes."""
    return sum(ms for g, ms in (agg.get("per_category_ms") or {}).items()
               if keep(g))


def is_attention(group: str) -> bool:
    return " fwd " in group or " bwd " in group


def share(bound_s: float, ms: float):
    """The roofline share in %, or None when the span ran none of it."""
    if ms <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / (ms / 1e3)


def attention_share(m):
    bound = 0.0
    for kind, b, n, heads, hd, bias in m["work"].get("attention_calls", ()):
        f = (flops.attention_fwd_bound_s if kind == "fwd"
             else flops.attention_bwd_bound_s)
        bound += f(b, n, heads, hd, bias=bias)
    return share(bound, group_ms(m["aggregate"], is_attention))


def busy_share(m):
    agg = m["aggregate"]
    if not agg.get("busy_ms") or not agg.get("window_ms"):
        return None
    return 100.0 * agg["busy_ms"] / agg["window_ms"]
