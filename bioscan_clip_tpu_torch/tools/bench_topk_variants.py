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
  screen_ms       what the screen and lists cost: K4's time minus K6
                  "high"'s ("kernel": "k4") and K5's minus K6 int8's
                  ("k5"), K6 timed at the same body and query block as the
                  top-k kernel (on the card, under a forced plan where K6's
                  own plan chooses another); "share" of the top-k time
for each query count Bq of --bq. The JAX script sweeps Pallas grid
parameters (`tile`, `q_block`); the port's kernels choose their own tiling
(their plans: TILING below), which each row names, so the sweep runs over
Bq.

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

TILING = ("pass 1: the plan's query block x 128 keys per tile (K6: "
          "ops.topk.plan_mm_only, the row-max launch of K4's or K5's Hopper "
          "body from MM_SM90_MIN_BQ queries up, else the mma.sync walks; "
          "K4: plan_f32; K5: plan_i8), key axis split over about one block "
          "per SM (two on the mma.sync walks)")
I8_MIN_K = 21  # max(4k, k + 16) at the engine's default k = 5


def _k6_at(plan, bq, n, dim, mode, sms):
    """K6's plan on the walk and at the query block of a top-k plan (K4's
    F32Plan or K5's I8Plan): its own plan where that already matches, else
    the sm90 walk forced to the block, with as many stages as fit."""
    own = topk_ops.plan_mm_only(bq, n, dim, mode, sms, body=plan.body)
    if own.qb == plan.qb or plan.body == "mma":
        return own
    lo, hi = topk_ops._MM_SM90_STAGES[mode]
    stages = max(st for st in range(lo, hi + 1)
                 if topk_ops.mm_sm90_smem(plan.qb, mode, st)
                 <= topk_ops.MAX_SMEM)
    return topk_ops.mm_sm90_plan(bq, n, mode, sms, plan.qb, stages)


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
    sms = (topk_ops._device_sms(device) if device.type == "cuda"
           else topk_ops.H100_SMS)

    def k6(mode, plan):
        return dict(variant="mm_only_i8" if mode == "int8" else
                    "mm_only_f32", tiling=(
                        f"K6's {plan.body} walk: {plan.qb} queries x 128 "
                        "keys per tile (ops.topk.plan_mm_only)"),
                    tiles=-(-bq // plan.qb) * n_tiles)

    for bq in bqs:
        if bq > queries:
            raise ValueError(f"--bq {bq} > --queries {queries}")
        qs = [tuple(t[:bq].contiguous() for t in s) for s in sets]
        row = dict(base, queries=bq, tiling=TILING)
        calls = []
        for prec in ("default", "high"):
            calls.append((dict(k6(prec, topk_ops.plan_mm_only(
                bq, n_keys, dim, prec, sms)), precision=prec),
                lambda v, p=prec: topk_ops.mm_only(
                    v[0], keys, n_keys, precision=p)))
        plan = topk_ops.plan_f32(bq, n_keys, k, "high", dim, sms)
        plan8 = topk_ops.plan_i8(bq, n_keys, k_i8_eff, dim, sms)
        calls += [
            (dict(variant="topk_f32", k=k, tiling=(
                f"K4's {plan.body} body: {plan.qb} queries x 128 keys per "
                "tile (ops.topk.plan_f32)"),
                tiles=-(-bq // plan.qb) * n_tiles),
             lambda v: topk_ops.topk(v[0], keys, n_keys, k)),
            (k6("int8", topk_ops.plan_mm_only(bq, n_keys, dim, "int8", sms)),
             lambda v: topk_ops.mm_only(v[1], k_i8, n_keys, int8=True)),
            (dict(variant="topk_i8", k=k_i8_eff, tiling=(
                f"K5's {plan8.body} body: {plan8.qb} queries x 128 keys per "
                "tile (ops.topk.plan_i8)"),
                tiles=-(-bq // plan8.qb) * n_tiles),
             lambda v: topk_ops.topk_i8(v[1], v[2], k_i8, k_sc, n_keys,
                                        k_i8_eff)),
        ]
        timed = {}
        for extra, fn in calls:
            ms = time_per_call(fn, qs, device)
            out = {**row, **extra}
            timed[(extra["variant"], extra.get("precision"))] = (ms, out)
            yield dict(out, ms=ms, us_per_tile=1e3 * ms / out["tiles"])
        # the screen's cost: the top-k kernel minus K6 at its body and query
        # block
        for kernel, top, mode, tplan, mine in (
                ("k4", ("topk_f32", None), "high", plan,
                 ("mm_only_f32", "high")),
                ("k5", ("topk_i8", None), "int8", plan8,
                 ("mm_only_i8", None))):
            top_ms = timed[top][0]
            kp = _k6_at(tplan, bq, n_keys, dim, mode, sms)
            own = topk_ops.plan_mm_only(bq, n_keys, dim, mode, sms)
            if device.type == "cpu" or kp == own:
                k6_ms = timed[mine][0]
            else:
                launch = (topk_ops._launch_mm_sm90 if kp.body == "sm90"
                          else topk_ops._launch_mm_mma)
                k6_ms = time_per_call(
                    lambda v, kp=kp, launch=launch: launch(
                        v[1] if mode == "int8" else v[0],
                        k_i8 if mode == "int8" else keys, n_keys, mode, kp),
                    qs, device)
            yield dict(base, queries=bq, variant="screen_ms", kernel=kernel,
                       body=tplan.body, qb=tplan.qb, ms=top_ms - k6_ms,
                       topk_ms=top_ms, mm_only_ms=k6_ms,
                       share=(top_ms - k6_ms) / top_ms if top_ms else None)


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
