"""ms per tower forward of the flagship's extraction, at one batch.

Counterpart of tools/profile_towers.py, timing the same four functions:
the device eval transform of uint8 (256, 384) frames
(`eval_transform_ms`), ViT-B/16 on transformed images (`vit_ms`),
BarcodeBERT on 133 DNA tokens (`barcode_bert_ms`) and BERT-small on 20
text tokens (`bert_small_ms`), bf16, random seeded weights, in inference
mode. Each of `--steps` timed calls takes its own input (seeded numpy
draws uploaded before the timing), after a warm-up call on another; the
time is CUDA events around the timed calls, over their count (the JAX
tool's chained carry has no use on the card).

    python -m bioscan_clip_tpu_torch.tools.profile_towers [--batch 256] \\
        [--steps 12] [--cpu]

Runs on the card unless `--cpu` is given (then the host clock); without
CUDA it raises. Prints one JSON line with the card's name and power limit.
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
    sync,
)


def time_calls(fn, inputs, dev) -> float:
    """ms per call of fn over `inputs` (one call each, after a warm-up
    call on the first): CUDA events on the card, the host clock on the
    CPU."""
    import torch

    fn(inputs[0])
    sync(dev)
    timed = inputs[1:]
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for x in timed:
            fn(x)
        return 1e3 * (time.perf_counter() - t0) / len(timed)
    ev = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
    ev[0].record()
    for x in timed:
        fn(x)
    ev[1].record()
    ev[1].synchronize()
    return ev[0].elapsed_time(ev[1]) / len(timed)


def tower_ms(model, dev, batch: int, steps: int) -> dict:
    """{eval_transform_ms, vit_ms, barcode_bert_ms, bert_small_ms}."""
    import torch

    from bioscan_clip_tpu_torch.data.transforms import eval_transform
    from bioscan_clip_tpu_torch.train.loop import _to_device

    hosts = [make_inputs(batch, seed=s) for s in range(steps + 1)]
    u8 = [_to_device(h["image_u8"], dev) for h in hosts]
    with torch.inference_mode():
        out = {"eval_transform_ms": time_calls(eval_transform, u8, dev)}
        images = [eval_transform(x) for x in u8]
        del u8
        out["vit_ms"] = time_calls(model.encode_image, images, dev)
        del images
        out["barcode_bert_ms"] = time_calls(
            model.encode_dna, [_to_device(h["dna"], dev) for h in hosts],
            dev)
        out["bert_small_ms"] = time_calls(
            model.encode_language,
            [_to_device(h["language"], dev) for h in hosts], dev)
    return {k: round(v, 6) for k, v in out.items()}


def main(argv=None, emit=print) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (host clock, no card fields)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    model, _ = build_model(flagship_args(args.batch, dev), dev,
                           frozen_bf16=False)
    res = {"batch": args.batch,
           **tower_ms(model, dev, args.batch, args.steps),
           "device": dev.type, "steps": args.steps, "card": card_line(dev),
           "timer": "cuda events" if dev.type == "cuda" else "host clock"}
    emit(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
