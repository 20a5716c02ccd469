"""The whole train step's share of the card's bf16 peak: the model FLOPs a
sample (`flops.train_flops` of each tower) times the untraced
window's samples/s, over 989 TFLOP/s, in %."""

from benchmark import flops


def read(m):
    w = m["work"]
    if w.get("kind") != "train":
        return None
    return 100.0 * flops.mfu(w["untraced_samples_per_s"],
                             w["flops_per_sample"])
