"""Where extraction's and serving's card time goes, from a traced run.

Counterpart of tools/trace_extract.py. It traces `--steps` calls of the
flagship's embed step (the device eval transform of uint8 (256, 384)
frames, then the image, DNA and text towers, bf16, random seeded weights:
`train/loop.make_embed_step` per modality, as `extract_features` runs
them) at `--batch` and aggregates the trace with
`trace_train_step.aggregate`: card time by category and kernel group, top
ops, the busy share of the traced calls' wall time, the idle gaps and the
host op running in each. `--batch 24` is the eval job's batch.

`--search` traces one `/search` request instead: 64 barcodes through
`retrieval/service.handle_request` against `--keys` resident fp32 keys
(`cli/serve.build_service`), as the serving path answers it.

    python -m bioscan_clip_tpu_torch.tools.trace_extract \\
        [--batch 256] [--steps 4] [--search [--keys 1048576]] [--keep] \\
        [--cpu]

Runs on the card unless `--cpu` is given; without CUDA it raises. Prints
one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile

from bioscan_clip_tpu_torch.device import resolve_device
from bioscan_clip_tpu_torch.tools.trace_train_step import (
    build_model,
    card_line,
    counter_growth,
    flagship_args,
    make_inputs,
    timed_call,
    traced_call,
    untraced_share,
)


SEARCH_QUERIES = 64  # the serving phase's barcode request


def embed_call(model, dev, host):
    """A call of the embed step on one batch of `host` (numpy) inputs,
    uploaded once: the three towers' normalized embeddings."""
    import torch

    from bioscan_clip_tpu_torch.train.loop import _to_device, make_embed_step

    inputs = {"image": _to_device(host["image_u8"], dev),
              "dna": _to_device(host["dna"], dev),
              "language": _to_device(host["language"], dev)}
    steps = {m: make_embed_step(model, m) for m in inputs}

    def call():
        with torch.inference_mode():
            return [steps[m](x) for m, x in inputs.items()]
    return call


def search_call(dev, n_keys: int, n_queries: int):
    """A call of one `/search` request of `n_queries` 658-bp barcodes
    against `n_keys` resident fp32 keys (768-d, seeded)."""
    import numpy as np

    from bioscan_clip_tpu_torch.cli.serve import build_service
    from bioscan_clip_tpu_torch.config.core import ConfigNode
    from bioscan_clip_tpu_torch.retrieval.service import handle_request
    from bioscan_clip_tpu_torch.tools.trace_train_step import FLAGSHIP

    rng = np.random.default_rng(0)
    args = ConfigNode({"model_config": dict(FLAGSHIP), "serve": {
        "device": str(dev), "max_k": 5, "max_batch": 256}})
    service = build_service(args, out=lambda *_: None)
    keys = rng.standard_normal((n_keys, FLAGSHIP["output_dim"]),
                               dtype=np.float32)
    labels = [{"order": f"o{i % 4}", "family": f"f{i % 40}",
               "genus": f"g{i % 400}", "species": f"s{i}"}
              for i in range(1000)]
    service.set_keys(keys, [labels[i % 1000] for i in range(n_keys)])
    del keys
    body = {"dna": ["".join(rng.choice(list("ACGT"), size=658))
                    for _ in range(n_queries)]}
    return lambda: handle_request(service, body)


def main(argv=None, emit=print) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="\n".join(__doc__.splitlines()[1:]))
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--search", action="store_true",
                    help="trace one /search request in place of the embed "
                    "step")
    ap.add_argument("--keys", type=int, default=1 << 20)
    ap.add_argument("--keep", action="store_true",
                    help="keep the Chrome trace for Perfetto")
    ap.add_argument("--cpu", action="store_true",
                    help="run and trace on the CPU (no card fields)")
    args = ap.parse_args(argv)
    from bioscan_clip_tpu_torch.train.graphs import read_counters

    dev = resolve_device("cpu" if args.cpu else None)
    steps = 1 if args.search else args.steps
    if args.search:
        one = search_call(dev, args.keys, SEARCH_QUERIES)
    else:
        model, _ = build_model(flagship_args(args.batch, dev), dev,
                               frozen_bf16=False)
        one = embed_call(model, dev, make_inputs(args.batch))

    def call():
        for _ in range(steps):
            out = one()
        return out

    trace_dir = tempfile.mkdtemp(prefix="bscan_xtrace_")
    try:
        timed_call(one, dev)  # builds the kernels, warms up
        _, untraced = timed_call(call, dev)
        before = read_counters()
        _, wall, agg = traced_call(call, dev,
                                   os.path.join(trace_dir, "trace.json"))
        counters = counter_growth(before, read_counters())
    finally:
        if not args.keep:
            shutil.rmtree(trace_dir, ignore_errors=True)
    res = {"batch": SEARCH_QUERIES if args.search else args.batch,
           "steps": steps, "trace_dir": trace_dir if args.keep else None,
           "agg": agg,
           "per_step_leaf_ms": round(agg["leaf_total_ms"] / steps, 2),
           "path": "search" if args.search else "embed",
           "keys": args.keys if args.search else None,
           "device": dev.type, "card": card_line(dev), "wall_ms": round(wall, 6),
           "untraced_wall_ms": round(untraced, 6),
           "untraced_busy_share": untraced_share(agg, untraced),
           "counters": counters}
    emit(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
