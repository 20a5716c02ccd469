"""Design sweep of K5's Hopper body (`csrc/topk_i8_sm90.cu`) on the card,
beside its mma.sync body (`csrc/topk.cu`), timed in one process so that
they share a card.

Variants, each through `ops/topk._launch_i8_sm90` under a plan of
`ops/topk.plan_i8`:
  as_built         the source as built, under the plan's own choice
  no_seed          as built without the seed: each query's threshold
                   starts at -inf in every key split
  nq=N,stages=S    the source as built at query block (wgmma's N side) N
                   and S ring stages: for each N whose lists fit, 2 stages
                   and the most that fit
  chunk_64         64-byte depth chunks (the 64-byte swizzle; as built:
                   128), at each query block, as many stages as fit
  q_once           the query block's codes loaded once, with the first
                   tile's chunks, into a region of NQ x D bytes beside the
                   ring, which then holds the keys alone (as built: a
                   query tile in every ring slot, read from L2 again for
                   every key tile); as many stages as fit, NQ <= 128
  products_only    no screen or lists (every candidate empty; timing
                   only): the walk and the products alone, three dots
                   kept live so that ptxas keeps every product; under the
                   plan and at each other query block
  merge_smem       K4's merge (topk_common.cuh merge_row, the buffer read
                   from shared memory for every entry's rank; as built: by
                   warp shuffles over registers, merge_row_shfl)
  merge_any        a query's buffer merged after every tile that added to
                   it (as built: once it holds 16 of its 32 scores)
  merge_full       merged only once it is full
  clocks           as built, with clock64() sums of each consumer warp's
                   cycles waiting for chunks, in the products, waiting for
                   the other warps before the screen, forming the scores,
                   in the screen, over the walk, and the producer's waiting
                   for free slots ("clocks": their shares of the walk)
  mma              the mma.sync body of csrc/topk.cu under its own plan
The text variants are built side by side from edits of
csrc/topk_i8_sm90.cu. Cases: Bq = 1, 16, 64, 128, 256 and 1024 over --keys
random unit rows' codes, and "rising" (Bq = 256 over collinear keys whose
scales rise with the index: every score passes the screen); D = 768, k =
21 (the engine's int8 oversampling of k = 5). Rows, one JSON object each:
variant, case, body, query block, stages, ms (CUDA events over --iters
launches after a warm-up) and bit_equal (values and indices against
`ops.topk.topk_i8_reference`; null for products_only), with the card's
name and power limit. `as_built` runs first and last in each case, so
that drift shows.

--crossing times the sm90 body with and without its seed against the
mma.sync body (each under its own plan, bit-equal checked) at Bq = 1, 2,
4, 8, 16, 32, 64, 128, 256, 512, 960, 1024 (or --crossing-bq) over --n key
counts, in turns (sm90, no seed, mma, mma, no seed, sm90), for
`topk.I8_MMA_WINS` and `topk.I8_SEED_MIN_BQ`. Needs a CUDA device and
nvcc.

    python -m bioscan_clip_tpu_torch.tools.sweep_k5_sm90 [--keys 1048576]
        [--iters 10] [--crossing [--n 19937,1048576,5000000]
        [--crossing-bq 1,960]] [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys

import torch

from bioscan_clip_tpu_torch.ops import _build
from bioscan_clip_tpu_torch.ops import topk as topk_ops

CHUNK = "constexpr int kChunk = 128;"
MERGE = "constexpr int kMergeAt = BUF / 2;"
SHFL_SCREEN = ("      screen_scores<NQ, MAXK, kMergeAt, NQ == 128 ? kFloodCarry "
               ": kFloodNone,\n                    true, Sync>(\n")
SHFL_FINAL = "  merge_buffers_shfl<NQ, MAXK>(L, 1, a.k, warp, lane);\n"
# pass 1's screen of a tile: its scores formed in place and screened
SCREEN = (
    "      screen_scores<NQ, MAXK, kMergeAt, NQ == 128 ? kFloodCarry : "
    "kFloodNone,\n                    true, Sync>(\n"
    "          [&](int j) { return __uint_as_float(acc[j]); }, L, q0, a.bq, "
    "key,\n"
    "          a.n_valid, a.k, warp, lane, flood, qvalid);\n")
SCORES = "    // each dot becomes its score in place"
STAGE = "  return (kTileKeys + nq) * kChunk;\n"
LISTS = "  const uint32_t lists = base + stages * kStage;\n"
EXPECT = "        mbar_expect_tx(full, kStage);\n"
Q_LOAD = ("        tma_load(st + kTileKeys * kChunk, &tm_q, full, col, q0, "
          "0);\n")
Q_TILE = ("                         base + s * kStage + kTileKeys * kChunk, "
          "wg, ")
CHECK = "      smem != smem_bytes(nq, maxk, stages) || "
EMPTY_WAIT = ("        if (use > 0) mbar_wait(bars + 8 * kMaxStages + 8 * s, "
              "(use - 1) & 1);\n")
WALK_START = "  query_bits<NQ>(qvalid, q0, a.bq, t4);\n"
WAIT = "      mbar_wait(bars + 8 * s, (c / stages) & 1);\n"
PRODUCTS = "      chunk_products<NQ>(acc, base + s * kStage,\n"
RELEASE = ("        mbar_arrive(bars + 8 * kMaxStages + 8 * ((c - 1) % "
           "stages));\n    }\n")
LAST_WAIT = ("    wgmma_wait();  // the tile's dots are complete\n"
             "    fence_acc(acc);\n")
FINAL = "  Sync::sync();  // every screen is done: merge what is buffered\n"
ERROR_STRING = "const char* bscan_error_string(int err) {"
# The clock64() cycles each consumer warp spends waiting for its chunks,
# in its products (their issue and the waits for their completion),
# waiting at a barrier added before the screen for the other consumer
# warps (skew), forming the scores in place, in the screen
# proper (compares, appends, merges), and in the walk; and the producer
# thread's cycles waiting for free slots. Summed over the warps of every
# CTA (pass 1 only) into a device array that `bscan_clocks` reads.
CLOCK_NAMES = ("wait", "products", "skew", "scores", "screen", "walk",
               "slots")
CLOCKS = [
    (MERGE, MERGE + "\n__device__ unsigned long long g_clocks[7];"),
    (EMPTY_WAIT, "        const long long te = clock64();\n" + EMPTY_WAIT
                 + "        if (!SEED) atomicAdd(&g_clocks[6], "
                   "(unsigned long long)(clock64() - te));\n"),
    (WALK_START, WALK_START + "  long long clk[6] = {0, 0, 0, 0, 0, 0};\n"
                              "  const long long t_all = clock64();\n"),
    (WAIT, "      const long long t0 = clock64();\n" + WAIT),
    (PRODUCTS, "      const long long t1 = clock64();\n"
               "      clk[0] += t1 - t0;\n" + PRODUCTS),
    (RELEASE, RELEASE.replace("    }\n", "      clk[1] += clock64() - t1;\n"
                                     "    }\n")),
    (LAST_WAIT, "    const long long tw = clock64();\n" + LAST_WAIT
                + "    clk[1] += clock64() - tw;\n"),
    (SCORES, "    const long long ts0 = clock64();\n"
             "    if (!SEED) Sync::sync();\n"
             "    const long long ts1 = clock64();\n" + SCORES),
    ("    if constexpr (SEED) {\n#pragma unroll\n",
     "    const long long ts2 = clock64();\n"
     "    clk[2] += ts1 - ts0;\n    clk[3] += ts2 - ts1;\n"
     "    if constexpr (SEED) {\n#pragma unroll\n"),
    (SCREEN, SCREEN + "      clk[4] += clock64() - ts2;\n"),
    (FINAL, "  clk[5] = clock64() - t_all;\n"
            "  if (lane == 0) {\n"
            "    for (int i = 0; i < 6; ++i)\n"
            "      atomicAdd(&g_clocks[i], (unsigned long long)clk[i]);\n"
            "  }\n" + FINAL),
    (ERROR_STRING,
     "// The clock sums (CLOCK_NAMES of tools/sweep_k5_sm90.py), then "
     "zeroed.\n"
     "int bscan_clocks(unsigned long long* out) {\n"
     "  cudaError_t e = cudaMemcpyFromSymbol(out, g_clocks, "
     "sizeof(g_clocks));\n"
     "  if (e != cudaSuccess) return (int)e;\n"
     "  const unsigned long long zero[7] = {0, 0, 0, 0, 0, 0, 0};\n"
     "  return (int)cudaMemcpyToSymbol(g_clocks, zero, sizeof(zero));\n"
     "}\n\n" + ERROR_STRING),
]
Q_ONCE = [
    (STAGE, "  return kTileKeys * kChunk;\n"),
    (LISTS, "  const uint32_t qreg = base + stages * kStage;\n"
            "  const uint32_t lists = qreg + NQ * a.d;\n"),
    (EXPECT, "        mbar_expect_tx(full, kStage + (c < cpt ? NQ * kChunk "
             ": 0));\n"),
    (Q_LOAD, "        if (c < cpt)\n"
             "          tma_load(qreg + c * NQ * kChunk, &tm_q, full, col, "
             "q0, 0);\n"),
    (Q_TILE, "                         qreg + kc * NQ * kChunk, wg, "),
    (CHECK, "      smem != smem_bytes(nq, maxk, stages) + (long long)nq "
            "* d ||\n      "),
]
# three dots kept live, so that ptxas keeps every product
PRODUCTS_ONLY = [(SCREEN, "      if (acc[0] == 1u && acc[NQ / 2 - 1] == 2u)"
                          "\n        a.cand_v[0] = (float)acc[1];\n")]
VARIANTS = {
    "chunk_64": [(CHUNK, "constexpr int kChunk = 64;")],
    # the queries' region of NQ x D bytes after the ring (a multiple of
    # 8 KB at d % 128 == 0), filled by the first tile's loads
    "q_once": Q_ONCE,
    "products_only": PRODUCTS_ONLY,
    # K4's merge (topk_common.cuh merge_row: the buffer read from shared
    # memory in a loop for every entry's rank)
    "merge_smem": [(SHFL_SCREEN, SHFL_SCREEN.replace("true,", "false,")),
                   (SHFL_FINAL, SHFL_FINAL.replace("_shfl", ""))],
    "merge_any": [(MERGE, "constexpr int kMergeAt = 1;")],
    "merge_full": [(MERGE, "constexpr int kMergeAt = BUF;")],
    "clocks": CLOCKS,
}
UNCHECKED = ("products_only",)
BQS = (1, 16, 64, 128, 256, 1024)
# 960: the eval job's queries a search (seen and unseen splits)
CROSSING_BQS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 960, 1024)
D, K = 768, 21


def variant_sources(source: str) -> dict[str, str]:
    """Each text variant of csrc/topk_i8_sm90.cu; raises if an edit no
    longer applies to `source`."""
    out = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise ValueError(f"{name}: {old!r} not in "
                                 "csrc/topk_i8_sm90.cu")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(out_dir, names=None) -> dict:
    """Compile the text variants (`names`, default every one) in parallel;
    their entry points."""
    sources = {name: (text, _build.CSRC_DIR) for name, text in
               variant_sources((_build.CSRC_DIR / "topk_i8_sm90.cu")
                               .read_text()).items()
               if names is None or name in names}
    return {name: topk_ops.i8_sm90_entry(lib) for name, lib in
            _build.build_sources(sources, out_dir).items()}


def _most_stages(smem) -> int | None:
    """The most ring stages (2-8) whose shared memory `smem(stages)` fits;
    None if two do not."""
    fit = [s for s in range(2, 9) if smem(s) <= topk_ops.MAX_SMEM]
    return fit[-1] if fit else None


def configs(bq, n, sms, libs, d=D, k=K):
    """(variant, plan, launch) for every configuration of one case; launch
    None runs the mma.sync body."""
    plan = topk_ops.plan_i8(bq, n, k, d, sms, body="sm90")
    own = topk_ops._i8_sm90_kernel()
    maxk = topk_ops._maxk_i8(k)
    yield "as_built", plan, own
    yield "no_seed", dataclasses.replace(plan, seed_groups=0), own
    for nq in topk_ops._i8_sm90_blocks(maxk):
        most = _most_stages(lambda s: topk_ops.i8_sm90_smem(nq, maxk, s))
        for stages in sorted({2, most}):
            yield (f"nq={nq},stages={stages}",
                   topk_ops.i8_sm90_plan(bq, n, k, sms, nq, stages), own)
    for name, lib in libs.items():
        if name == "chunk_64":
            for nq in topk_ops._i8_sm90_blocks(maxk):
                most = _most_stages(
                    lambda s: topk_ops.i8_sm90_smem(nq, maxk, s, 64))
                p = topk_ops.i8_sm90_plan(bq, n, k, sms, nq, most)
                yield (f"{name},nq={nq}", dataclasses.replace(
                    p, smem=topk_ops.i8_sm90_smem(nq, maxk, most, 64)), lib)
        elif name == "q_once":
            for nq in topk_ops._i8_sm90_blocks(maxk):
                most = _most_stages(lambda s: topk_ops.i8_sm90_smem(
                    nq, maxk, s) - s * nq * 128 + nq * d)
                if most is None:
                    continue
                p = topk_ops.i8_sm90_plan(bq, n, k, sms, nq, most)
                yield (f"{name},nq={nq}", dataclasses.replace(
                    p, smem=p.smem - most * nq * 128 + nq * d), lib)
        else:
            yield name, plan, lib
            if name == "products_only":
                for nq in topk_ops._i8_sm90_blocks(maxk):
                    if nq != plan.qb:
                        yield (f"{name},nq={nq}", topk_ops.i8_sm90_plan(
                            bq, n, k, sms, nq, _most_stages(
                                lambda s: topk_ops.i8_sm90_smem(nq, maxk,
                                                                s))), lib)
    yield "mma", topk_ops.plan_i8(bq, n, k, d, sms, body="mma"), None
    yield "as_built", plan, own


def cases(n, gen, dev, bqs=BQS):
    """(name, query codes, query scales, key codes, key scales) at each Bq
    of `bqs`, then "rising"."""
    quantize = topk_ops.quantize_rows_i8_torch
    x = torch.randn(n, D, device=dev, generator=gen)
    kc, ks = quantize(x / x.norm(dim=1, keepdim=True))
    del x
    q = torch.randn(max(bqs), D, device=dev, generator=gen)
    qc, qs = quantize(q / q.norm(dim=1, keepdim=True))
    for bq in bqs:
        yield f"Bq={bq}", qc[:bq].contiguous(), qs[:bq].contiguous(), kc, ks
    u = torch.randn(1, D, device=dev, generator=gen)
    uc, us = quantize(u)
    qc, qs = quantize(u + 0.1 * torch.randn(256, D, device=dev,
                                            generator=gen))
    ks = us * (1 + torch.arange(n, device=dev, dtype=torch.float32) / n)
    yield "rising", qc, qs, uc.expand(n, D).contiguous(), ks


def time_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def clock_shares(kern, run) -> dict:
    """The `clocks` variant's cycles of one launch's pass 1, summed over
    its consumer warps: each CLOCK_NAMES part's share of the walk (slots:
    of the producer thread's), and the walk's cycles summed over the
    warps."""
    buf = (ctypes.c_ulonglong * len(CLOCK_NAMES))()
    fn = kern.lib.bscan_clocks
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn(buf)  # zero what the timing left
    run()
    torch.cuda.synchronize()
    if fn(buf):
        raise RuntimeError("bscan_clocks failed")
    got = dict(zip(CLOCK_NAMES, (int(x) for x in buf)))
    walk = got.pop("walk")
    # one producer thread a CTA against 8 consumer warps
    out = {name: v / walk for name, v in got.items()}
    out["slots"] *= 8
    out["walk_cycles"] = walk
    return out


def _runner(plan, kern, qc, qs, kc, ks, n_valid, k=K):
    if kern is None:
        return lambda: topk_ops._launch_i8_mma(qc, qs, kc, ks, n_valid, k,
                                               plan)
    return lambda: topk_ops._launch_i8_sm90(kern, qc, qs, kc, ks, n_valid, k,
                                            plan)


def crossing(ns, sms, gen, dev, iters, power, bqs=CROSSING_BQS, rounds=1):
    """The sm90 body against the mma.sync body at every Bq of `bqs` over
    each key count of `ns`, in `rounds` rounds of turns. `plan_sm90_ms`:
    the sm90 body with the seed as `plan_i8` sets it; `faster`: the body
    with the least time, of the plan's sm90 and mma.sync; `mma_wins`: the
    share of rounds whose mma.sync readings were both below the plan's
    sm90 ones."""
    quantize = topk_ops.quantize_rows_i8_torch
    rows = []
    for n in ns:
        kc = torch.randint(-127, 128, (n, D), device=dev, generator=gen,
                           dtype=torch.int8)
        ks = 1e-3 + 1e-3 * torch.rand(n, device=dev, generator=gen)
        q = torch.randn(max(bqs), D, device=dev, generator=gen)
        qc_all, qs_all = quantize(q)
        for bq in bqs:
            qc, qs = qc_all[:bq].contiguous(), qs_all[:bq].contiguous()
            ref = topk_ops.topk_i8_reference(qc, qs, kc, ks, n, K)
            times = {"sm90": [], "no_seed": [], "mma": []}
            plans = {b: topk_ops.plan_i8(bq, n, K, D, sms, body=b)
                     for b in ("sm90", "mma")}
            plans["sm90"] = dataclasses.replace(plans["sm90"], seed_groups=K)
            plans["no_seed"] = dataclasses.replace(plans["sm90"],
                                                   seed_groups=0)
            kerns = {"sm90": topk_ops._i8_sm90_kernel(), "mma": None,
                     "no_seed": topk_ops._i8_sm90_kernel()}
            equal = True
            for _ in range(rounds):
                for body in ("sm90", "no_seed", "mma", "mma", "no_seed",
                             "sm90"):
                    run = _runner(plans[body], kerns[body], qc, qs, kc, ks,
                                  n)
                    v, i = run()
                    equal &= (torch.equal(v, ref[0])
                              and torch.equal(i, ref[1]))
                    times[body].append(time_ms(run, iters))
            seeded = topk_ops.plan_i8(bq, n, K, D, sms,
                                      body="sm90").seed_groups > 0
            own = times["sm90" if seeded else "no_seed"]
            wins = sum(max(times["mma"][2 * r:2 * r + 2])
                       < min(own[2 * r:2 * r + 2]) for r in range(rounds))
            row = {"crossing": True, "keys": n, "bq": bq,
                   "sm90_ms": min(times["sm90"]), "mma_ms": min(times["mma"]),
                   "no_seed_ms": min(times["no_seed"]),
                   "readings": times, "plan_seed": seeded,
                   "sm90_qb": plans["sm90"].qb, "mma_qb": plans["mma"].qb,
                   "plan_body": topk_ops.plan_i8(bq, n, K, D, sms).body,
                   "bit_equal": equal, "device": power}
            row["plan_sm90_ms"] = row["sm90_ms" if seeded else "no_seed_ms"]
            row["ratio"] = row["plan_sm90_ms"] / row["mma_ms"]
            row["faster"] = "sm90" if row["ratio"] < 1 else "mma"
            row["mma_wins"] = wins / rounds
            print(json.dumps(row), flush=True)
            rows.append(row)
        del kc, ks
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--crossing", action="store_true")
    ap.add_argument("--n", default="19937,131072,1048576,5000000")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of turns a --crossing case")
    ap.add_argument("--crossing-bq", default=None,
                    help="comma-separated Bq values of --crossing "
                         "(default CROSSING_BQS)")
    ap.add_argument("--bq", default=None,
                    help="comma-separated cases (Bq values, 'rising'; "
                         "default BQS and 'rising')")
    ap.add_argument("--variants", default=None,
                    help="comma-separated variants to build and run")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_k5_sm90: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    power = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if args.crossing:
        bqs = (tuple(int(x) for x in args.crossing_bq.split(","))
               if args.crossing_bq else CROSSING_BQS)
        rows = crossing([int(x) for x in args.n.split(",")], sms, gen, dev,
                        args.iters, power, bqs, args.rounds)
    else:
        names = args.variants.split(",") if args.variants else None
        libs = build(_build.BUILD_DIR.parent / "topk_i8_sm90_sweep", names)
        want = set(args.bq.split(",")) if args.bq else None
        bqs = tuple(sorted(int(b) for b in want - {"rising"})) if want else BQS
        rows = []
        for case, qc, qs, kc, ks in cases(args.keys, gen, dev, bqs or BQS):
            if want and case.removeprefix("Bq=") not in want:
                continue
            bq, n = qc.shape[0], kc.shape[0]
            ref = topk_ops.topk_i8_reference(qc, qs, kc, ks, n, K)
            for name, plan, kern in configs(bq, n, sms, libs):
                run = _runner(plan, kern, qc, qs, kc, ks, n)
                v, i = run()
                row = {"variant": name, "case": case, "body": plan.body,
                       "query_block": plan.qb, "stages": plan.stages,
                       "ms": time_ms(run, args.iters), "keys": n,
                       "bit_equal": None if name.startswith(UNCHECKED) else (
                           torch.equal(v, ref[0]) and torch.equal(i, ref[1])),
                       "device": power}
                if name == "clocks":
                    row["clocks"] = clock_shares(kern, run)
                print(json.dumps(row), flush=True)
                rows.append(row)
            del ref
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 1 if any(r["bit_equal"] is False for r in rows) else 0


if __name__ == "__main__":
    raise SystemExit(main())
