"""Kernel launches a train step: the kernel events of the traced span over
its steps (the host's dispatch of the step, `train/loop.py`)."""


def read(m):
    w, agg = m["work"], m["aggregate"]
    if w.get("kind") != "train" or agg.get("kernel_events") is None:
        return None
    return agg["kernel_events"] / w["steps"]
