"""Card time a train step in PyTorch's elementwise kernels (the dropout
hash, LayerNorm, GELU, casts): the "elementwise" category of the traced
span over its steps."""


def read(m):
    w, agg = m["work"], m["aggregate"]
    ms = (agg.get("per_category_ms") or {}).get("elementwise")
    if w.get("kind") != "train" or ms is None:
        return None
    return ms / w["steps"]
