"""Top-k kernel decomposition probe on the card: how much of the top-k
kernels' time goes to the products and how much to keeping the lists.

Counterpart of tools/bench_topk_variants.py. Rows, one JSON object each:
  dispatch_floor  K7 (`ops.topk.tiny`, x + 1 on (8, 128) fp32): "ms" is the
                  card's time per launch in a pipelined run, "host_ms" one
                  call plus a synchronize on the host clock (the floor of a
                  call through the port's ctypes route)
  mm_only_f32     K6 fp32 (`ops.topk.mm_only`), precision "default" (one
                  bf16 product) and "high" (six): K4's pass-1 walk and
                  products and a row max, no screen or lists
  topk_f32        K4 (`ops.topk.topk`) at k
  mm_only_i8      K6 int8: K5's pass-1 walk and products and a row max
  topk_i8         K5 (`ops.topk.topk_i8`) at max(k, 21), the engine's
                  oversampled k for an int8 search
for each query count Bq of --bq. The JAX script sweeps Pallas grid
parameters (`tile`, `q_block`); the port's kernels choose their own tiling
(TILING below), which each row names, so the sweep runs over Bq.

Timing: CUDA events around --iters calls, each on its own query set (one
distinct input per timed call, as the JAX script), after a warm-up call on
another set; "ms" is per call. Keys (--keys x --dim, unit rows) and queries
are drawn on the device from --seed. Every row names its device; on the
CPU (`--device cpu`, the plain versions) times are the host clock's.

    python -m bioscan_clip_tpu_torch.tools.bench_topk_variants \\
        [--keys 1048576] [--queries 1024] [--bq 1,64,256,1024] [--out FILE]

Output goes to stdout, and is appended to --out only when it is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from bioscan_clip_tpu_torch.ops import topk as topk_ops

TILING = ("pass 1: 16, 32 or 64 queries from Bq x 128 keys per tile "
          "(K6 on the mma.sync walks: the mma plans of ops.topk.plan_f32 "
          "and ops.topk.plan_i8), key axis split over ~2 blocks per SM")
I8_MIN_K = 21  # max(4k, k + 16) at the engine's default k = 5


def query_block(bq: int) -> int:
    """The query block of the mma.sync walks' plans (K6, K5) at width
    768."""
    return 16 if bq <= 16 else (32 if bq <= 32 else 64)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_per_call(fn, inputs, device) -> float:
    """ms per call of fn over inputs[1:] after a warm-up call on inputs[0]:
    CUDA events on the card, the host clock on the CPU."""
    fn(inputs[0])
    _sync(device)
    n = len(inputs) - 1
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for x in inputs[1:]:
            fn(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for x in inputs[1:]:
        fn(x)
    return 1e3 * (time.perf_counter() - t0) / n


def host_sync_ms(fn, inputs, device) -> float:
    """ms per call on the host clock, each call followed by a
    synchronize."""
    fn(inputs[0])
    _sync(device)
    total = 0.0
    for x in inputs[1:]:
        t0 = time.perf_counter()
        fn(x)
        _sync(device)
        total += time.perf_counter() - t0
    return 1e3 * total / (len(inputs) - 1)


def _unit_rows(n, d, gen, device):
    x = torch.randn(n, d, generator=gen, device=device)
    return x / x.norm(dim=1, keepdim=True)


def probe_rows(n_keys=1 << 20, queries=1024, dim=768, k=5, bqs=(1, 64, 256,
               1024), iters=8, seed=0, device="cuda"):
    """Yield the probe's rows (dicts) in order."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    keys = _unit_rows(n_keys, dim, gen, device)
    k_i8, k_sc = topk_ops.quantize_rows_i8_torch(keys)
    sets = []  # iters + 1 distinct query sets (one is the warm-up)
    for _ in range(iters + 1):
        q = _unit_rows(queries, dim, gen, device)
        sets.append((q,) + topk_ops.quantize_rows_i8_torch(q))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    base = {"device": name, "keys": n_keys, "dim": dim}

    tin = [torch.randn(8, 128, generator=gen, device=device)
           for _ in range(iters + 1)]
    yield dict(base, variant="dispatch_floor",
               ms=time_per_call(topk_ops.tiny, tin, device),
               host_ms=host_sync_ms(topk_ops.tiny, tin, device))

    k_i8_eff = max(k, I8_MIN_K)
    n_tiles = -(-n_keys // 128)
    for bq in bqs:
        if bq > queries:
            raise ValueError(f"--bq {bq} > --queries {queries}")
        qs = [tuple(t[:bq].contiguous() for t in s) for s in sets]
        row = dict(base, queries=bq, tiling=TILING,
                   tiles=-(-bq // query_block(bq)) * n_tiles)
        calls = []
        for prec in ("default", "high"):
            calls.append((dict(variant="mm_only_f32", precision=prec),
                          lambda v, p=prec: topk_ops.mm_only(
                              v[0], keys, n_keys, precision=p)))
        plan = topk_ops.plan_f32(bq, n_keys, k, "high", dim)
        plan8 = topk_ops.plan_i8(bq, n_keys, k_i8_eff, dim)
        calls += [
            (dict(variant="topk_f32", k=k, tiling=(
                f"K4's {plan.body} body: {plan.qb} queries x 128 keys per "
                "tile (ops.topk.plan_f32)"),
                tiles=-(-bq // plan.qb) * n_tiles),
             lambda v: topk_ops.topk(v[0], keys, n_keys, k)),
            (dict(variant="mm_only_i8"),
             lambda v: topk_ops.mm_only(v[1], k_i8, n_keys, int8=True)),
            (dict(variant="topk_i8", k=k_i8_eff, tiling=(
                f"K5's {plan8.body} body: {plan8.qb} queries x 128 keys per "
                "tile (ops.topk.plan_i8)"),
                tiles=-(-bq // plan8.qb) * n_tiles),
             lambda v: topk_ops.topk_i8(v[1], v[2], k_i8, k_sc, n_keys,
                                        k_i8_eff)),
        ]
        for extra, fn in calls:
            ms = time_per_call(fn, qs, device)
            out = {**row, **extra}
            yield dict(out, ms=ms, us_per_tile=1e3 * ms / out["tiles"])


def main(argv=None, emit=print):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, default=1 << 20)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--bq", default="1,64,256,1024")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="also append the rows to this file")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("bench_topk_variants: CUDA is not available", file=sys.stderr)
        return 1
    rows = []
    for row in probe_rows(args.keys, args.queries, args.dim, args.k,
                          [int(b) for b in args.bq.split(",")], args.iters,
                          args.seed, args.device):
        line = json.dumps(row)
        emit(line)
        rows.append(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write("".join(r + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
