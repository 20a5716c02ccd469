"""The card's idle time a request (the service's host work around the
towers and the search: the frames' crop and upload, the embeddings' fetch,
the label lookup): the traced span's idle ms over its requests."""


def read(m):
    w, agg = m["work"], m["aggregate"]
    if w.get("kind") != "search" or agg.get("idle_ms") is None:
        return None
    return agg["idle_ms"] / w["requests"]
