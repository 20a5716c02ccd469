"""ms per step of the flagship's LoRA contrastive train step, by variant.

Counterpart of tools/profile_train_step.py. The flagship (random seeded
weights, bf16, frozen weights in bf16, dropout 0.1) on the JAX tool's
batch (uint8 (256, 384) frames through the device train augmentation).
The JAX tool's --no-aug, --no-dropout, --remat and --rbg are not carried:
`trace_train_step --remat-policy` traces remat, and its split shows the
augmentation's and the dropout's kernels.

  grad    the loss and its backward over the trainable set, no optimizer
          update (`train/loop.make_train_step`'s `loss_fn`)
  fwd     the loss alone, no autograd graph
  update  AdamW alone over fixed gradients (ones)
  fused   `train/loop.make_train_step`: forward, backward and AdamW
  flat    the fused step graphed: each step the replay of a CUDA graph
          (`train/graphs.StepGraphs`, `loop.make_scan_train_step`), the
          card's counterpart of the JAX variant's flat state (leaves packed
          in one vector to save dispatches, `train/flat_state.py`, which
          the port does not have); on the CPU the steps run eagerly

    python -m bioscan_clip_tpu_torch.tools.profile_train_step \\
        --variant fused [--batch 48] [--steps 8] [--cpu]

`compile_s` is the first call's host seconds (the kernels' build, the
warm-up and, for `flat`, the capture). `step_ms` is CUDA events around
`--steps` steps on the card, the host clock on the CPU. Runs on the card
unless `--cpu` is given; without CUDA it raises. Prints one JSON line with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import time

from bioscan_clip_tpu_torch.device import resolve_device
from bioscan_clip_tpu_torch.tools.trace_train_step import (
    build_model,
    card_line,
    flagship_args,
    make_inputs,
    timed_call,
)

VARIANTS = ("grad", "fused", "flat", "update", "fwd")
SEED = 7


def variant_call(variant: str, model, batch: dict):
    """A call of one step of `variant`, returning the step's loss (None
    for `update`)."""
    import torch

    from bioscan_clip_tpu_torch.train.loop import (
        make_scan_train_step,
        make_train_step,
    )
    from bioscan_clip_tpu_torch.train.schedules import constant
    from bioscan_clip_tpu_torch.train.state import create_train_state

    state = create_train_state(model, constant(1e-3))
    holder = {"state": state, "seed": SEED}
    trainable = [p for p in model.parameters() if p.requires_grad]
    if variant == "fused":
        step = make_train_step(model)

        def call():
            holder["state"], loss = step(holder["state"], batch,
                                         holder["seed"])
            holder["seed"] += 1
            return loss
    elif variant == "flat":
        scan = make_scan_train_step(model, 1, same_batch=True)

        def call():
            holder["state"], losses = scan(holder["state"], batch,
                                           [holder["seed"]])
            holder["seed"] += 1
            return losses[0]
    elif variant in ("grad", "fwd"):
        loss_fn = make_train_step(model).loss_fn

        def call():
            model.train()
            seed, holder["seed"] = holder["seed"], holder["seed"] + 1
            if variant == "fwd":
                with torch.no_grad():
                    return loss_fn(batch, seed)
            for p in trainable:
                p.grad = None
            loss = loss_fn(batch, seed)
            loss.backward()
            return loss.detach()
    elif variant == "update":
        for p in trainable:
            p.grad = torch.ones_like(p)

        def call():
            holder["state"].set_lr()
            holder["state"].optimizer.step()
            return None
    else:
        raise ValueError(f"variant {variant!r}, expected one of {VARIANTS}")
    return call


def run_variant(variant: str, batch: int, steps: int, dev) -> dict:
    """{step_ms, samples_per_s, compile_s, loss} of `steps` steps."""
    from bioscan_clip_tpu_torch.train.loop import device_batch

    model, _ = build_model(flagship_args(batch, dev), dev)
    call = variant_call(variant, model, device_batch(make_inputs(batch), dev))
    t0 = time.perf_counter()
    timed_call(call, dev)
    if variant == "flat":
        timed_call(call, dev)  # the second step captures the graph
    compile_s = time.perf_counter() - t0

    def run():
        for _ in range(steps):
            loss = call()
        return loss

    loss, ms = timed_call(run, dev)
    return {"step_ms": round(ms / steps, 2),
            "samples_per_s": round(batch * steps / ms * 1e3, 1),
            "compile_s": round(compile_s, 1),
            "loss": None if loss is None else float(loss)}


def main(argv=None, emit=print) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="\n".join(__doc__.splitlines()[1:]))
    ap.add_argument("--variant", choices=VARIANTS, default="fused")
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (host clock, no card fields)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    res = run_variant(args.variant, args.batch, args.steps, dev)
    out = {"variant": args.variant, "batch": args.batch,
           "step_ms": res.pop("step_ms"),
           "samples_per_s": res.pop("samples_per_s"),
           "compile_s": res.pop("compile_s"), "device": dev.type,
           "steps": args.steps, "card": card_line(dev),
           "timer": "cuda events" if dev.type == "cuda" else "host clock",
           **res}
    emit(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
