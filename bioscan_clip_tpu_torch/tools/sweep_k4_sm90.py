"""Design sweep of K4's Hopper body (`csrc/topk_sm90.cu`) on the card, beside
its mma.sync body (`csrc/topk.cu`), timed in one process so that they share
a card.

Variants, each through `ops/topk._launch_sm90` under a plan of
`ops/topk.plan_f32`:
  plan             the source as built, under the plan's own choice
  nq=N,stages=S    the source as built at query block (wgmma's N side) N
                   and S ring stages, for every pair that fits
  fadd_1, fadd_2   "high" with the six products' running sum added by FADD
                   after every k-step or every two (as built: every four,
                   one 64-deep chunk)
  merge_any        a query's buffer merged after every tile that added to
                   it (as the mma.sync body does; as built: once it holds
                   16 of its 32 scores)
  merge_full       merged only once it is full
  prefetch_N       the keys prefetched into L2 N chunks ahead of their load
                   (as built: none)
  products_only    no screen or lists (every candidate empty; timing
                   only): the walk and the products alone, three scores
                   kept live so that ptxas keeps every product
  multicast        clusters of two neighbouring key splits, each CTA
                   loading half of every query piece tile by TMA multicast
                   into both (the plan's splits rounded up to even)
  mma              the mma.sync body of csrc/topk.cu under its own plan
                   (the crossing: where the plan switches bodies)
The text variants are built side by side from edits of csrc/topk_sm90.cu.
Cases: "high" and "default" at Bq = 1, 16, 17, 32, 64, 128, 256 and 1024
over --keys random unit rows, and "rising" (Bq = 256 over keys u * (1 + i /
n), whose scores rise with the index for queries near u: every score
passes the screen); D = 768, k = 5. Rows, one JSON object each: variant,
precision, case, body, query block, stages, ms (CUDA events over --iters
launches after a warm-up) and err_plain (max |values - the plain
version's|; not for products_only), with the card's name and power limit.
`plan` runs first and last in each case, so that drift shows. Needs a CUDA
device and nvcc.

    python -m bioscan_clip_tpu_torch.tools.sweep_k4_sm90 [--keys 1048576]
        [--iters 10] [--out FILE]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys

import torch

from bioscan_clip_tpu_torch.ops import _build
from bioscan_clip_tpu_torch.ops import topk as topk_ops

FADD = "constexpr int kFaddSteps = 4;"
MERGE = "constexpr int kMergeAt = BUF / 2;"
SCREEN = ("        screen<NQ, MAXK>(acc, L, q0, a.bq, key, a.n_valid, a.k, "
          "warp, lane);\n")
HELPERS = "__device__ __forceinline__ float4 lds128"
LOAD = ("  auto load = [&](int c) {\n"
        "    const int s = c % stages, use = c / stages;\n")
FIRST_LOADS = ("    for (int c = 0; c < stages - 1 && c < n_chunks; ++c) "
               "load(c);\n")


def prefetch(ahead: int) -> list:
    """Edits that prefetch chunk c + `ahead`'s keys into L2 as chunk c is
    loaded (and the chunks before the first load's reach up front)."""
    helper = r"""// A box of a tensor map into L2 only.
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map, int col,
                                             int row, int batch) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.3d.L2.global.tile [%0, {%1, %2, %3}];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(batch)
      : "memory");
}

"""
    fetch = ("  auto prefetch = [&](int c) {\n"
             "    const int col = (c % cpt) * kChunk;\n"
             "    const int key0 = (tile0 + c / cpt) * kTileKeys;\n"
             "    tma_prefetch(&tm_keys, col, key0, 0);\n"
             "    tma_prefetch(&tm_keys, col + kBoxFloats, key0, 0);\n"
             "  };\n")
    return [
        (HELPERS, helper + HELPERS),
        (LOAD, fetch + LOAD + f"    if (c + {ahead} < n_chunks) "
                              f"prefetch(c + {ahead});\n"),
        (FIRST_LOADS, f"    for (int c = stages - 1; c < {ahead} && "
                      "c < n_chunks; ++c) prefetch(c);\n" + FIRST_LOADS),
    ]


# Clusters of two neighbouring key splits sharing each query piece tile:
# each CTA loads half of its rows by TMA multicast into both, walks as many
# chunks as the cluster's first split has (loading keys past its own split
# without screening them), and frees a slot once all 16 warps of the
# cluster have released it.
MULTICAST = [
    (HELPERS, r"""__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar,
                                                   uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(bar), "r"(rank));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          remote)
      : "memory");
}

__device__ __forceinline__ void tma_load_multicast(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   uint32_t bar, int col,
                                                   int row, int batch,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(batch), "h"(mask)
      : "memory");
}

""" + HELPERS),
    ("__global__ void __launch_bounds__(TPB, 1)\n",
     "__global__ void __cluster_dims__(1, 2, 1) __launch_bounds__(TPB, 1)\n"),
    ("  const int n_chunks = max(0, tile1 - tile0) * cpt;\n",
     "  const int first = blockIdx.y / 2 * 2 * a.tiles_per_split;\n"
     "  const int n_chunks =\n"
     "      max(0, min((a.n_valid + kTileKeys - 1) / kTileKeys,\n"
     "                 first + a.tiles_per_split) - first) * cpt;\n"
     "  const uint32_t rank = cluster_rank();\n"),
    ("mbar_init(bars + 32 + 8 * s, TPB / 32);",
     "mbar_init(bars + 32 + 8 * s, TPB / 32 * 2);"),
    ("  __syncthreads();\n\n  // thread 0: chunk c's keys",
     "  __syncthreads();\n  cluster_sync();  // every barrier is ready\n\n"
     "  // thread 0: chunk c's keys"),
    ("      tma_load(st + kKeyBytes + t * NQ * kPieceRowBytes, &tm_q, full, "
     "col, q0,\n               t);\n",
     "      tma_load_multicast(\n"
     "          st + kKeyBytes + (t * NQ + rank * (NQ / 2)) * kPieceRowBytes,\n"
     "          &tm_q, full, col, q0 + rank * (NQ / 2), t, 3);\n"),
    ("    if (lane == 0) mbar_arrive(bars + 32 + 8 * s);\n",
     "    if (lane == 0) {\n"
     "      mbar_arrive(bars + 32 + 8 * s);\n"
     "      mbar_arrive_remote(bars + 32 + 8 * s, rank ^ 1u);\n"
     "    }\n"),
    (SCREEN, "      if (tile0 + c / cpt < tile1)\n  " + SCREEN),
    ("      a.cand_i[o] = L.li()[r * MAXK + p];\n    }\n  }\n}\n",
     "      a.cand_i[o] = L.li()[r * MAXK + p];\n    }\n  }\n"
     "  // no CTA leaves while the other may still arrive on its barriers\n"
     "  cluster_sync();\n}\n"),
    ("      (long long)(splits - 1) * tiles_per_split >= n_tiles ||",
     "      splits % 2 != 0 ||\n"
     "      (long long)(splits - 2) * tiles_per_split >= n_tiles ||"),
    ("!encode(&mq, pieces, terms, bq, d, nq))",
     "!encode(&mq, pieces, terms, bq, d, nq / 2))"),
]
VARIANTS = {
    "fadd_1": [(FADD, "constexpr int kFaddSteps = 1;")],
    "fadd_2": [(FADD, "constexpr int kFaddSteps = 2;")],
    "merge_any": [(MERGE, "constexpr int kMergeAt = 1;")],
    "merge_full": [(MERGE, "constexpr int kMergeAt = BUF;")],
    "prefetch_2": prefetch(2),
    "prefetch_4": prefetch(4),
    "prefetch_8": prefetch(8),
    # three scores kept live, so that ptxas keeps every product
    "products_only": [(SCREEN, "      if (acc[0] == -1.f && acc[NQ / 2 - 1] "
                               "== -2.f) a.cand_v[0] = acc[1];\n")],
    "multicast": MULTICAST,
}
HIGH_ONLY = ("fadd_1", "fadd_2")
BQS = (1, 16, 17, 32, 64, 128, 256, 1024)
D, K = 768, 5


def variant_sources(source: str) -> dict[str, str]:
    """Each text variant of csrc/topk_sm90.cu; raises if an edit no longer
    applies to `source`."""
    out = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise ValueError(f"{name}: {old!r} not in csrc/topk_sm90.cu")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(out_dir) -> dict:
    """Compile every text variant in parallel; their entry points."""
    sources = {name: (text, _build.CSRC_DIR) for name, text in
               variant_sources((_build.CSRC_DIR / "topk_sm90.cu")
                               .read_text()).items()}
    return {name: topk_ops.sm90_entry(lib) for name, lib in
            _build.build_sources(sources, out_dir).items()}


def cases(n, gen, dev):
    """(name, queries, keys): unit rows at each Bq, then rising scores."""
    keys = torch.randn(n, D, device=dev, generator=gen)
    keys /= keys.norm(dim=1, keepdim=True)
    q = torch.randn(max(BQS), D, device=dev, generator=gen)
    q /= q.norm(dim=1, keepdim=True)
    for bq in BQS:
        yield f"Bq={bq}", q[:bq].contiguous(), keys
    u = torch.randn(1, D, device=dev, generator=gen)
    u /= u.norm()
    q = u + 0.1 * torch.randn(256, D, device=dev, generator=gen)
    yield "rising", q / q.norm(dim=1, keepdim=True), u * (
        1 + torch.arange(n, device=dev, dtype=torch.float32)[:, None] / n)


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


def configs(bq, n, precision, sms, libs):
    """(variant, plan, launch) for every configuration of one case."""
    plan = topk_ops.plan_f32(bq, n, K, precision, D, sms, body="sm90")
    own = topk_ops._sm90_kernel()
    yield "plan", plan, own
    terms = 3 if precision == "high" else 1
    maxk = topk_ops._maxk(K)
    for nq in topk_ops._sm90_blocks(precision):
        for stages in (2, 3, 4):
            if topk_ops.sm90_smem(nq, maxk, terms, stages) > topk_ops.MAX_SMEM:
                continue
            yield (f"nq={nq},stages={stages}",
                   topk_ops.sm90_plan(bq, n, K, precision, sms, nq, stages),
                   own)
    for name, lib in libs.items():
        if name == "multicast":
            splits = plan.splits + plan.splits % 2
            yield name, dataclasses.replace(plan, splits=splits,
                                            n_cand=bq * splits * K), lib
        elif precision == "high" or name not in HIGH_ONLY:
            yield name, plan, lib
    yield "mma", topk_ops.plan_f32(bq, n, K, precision, D, sms,
                                   body="mma"), None
    yield "plan", plan, own


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_k4_sm90: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    power = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    libs = build(_build.BUILD_DIR.parent / "topk_sm90_sweep")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows = []
    for case, q, keys in cases(args.keys, gen, dev):
        bq, n = q.shape[0], keys.shape[0]
        for precision in ("high", "default"):
            ref_v, _ = topk_ops.topk_reference(q, keys, n, K, precision)
            mode = topk_ops.PRECISIONS[precision]
            for name, plan, kern in configs(bq, n, precision, sms, libs):
                if kern is None:
                    def run(plan=plan):
                        return topk_ops._launch_mma(q, keys, n, K, mode, plan)
                else:
                    def run(plan=plan, kern=kern):
                        return topk_ops._launch_sm90(kern, q, keys, n, K,
                                                     precision, plan)
                v = run()[0].clone()
                row = {"variant": name, "precision": precision,
                       "case": case, "body": plan.body, "query_block":
                       plan.qb, "stages": plan.stages,
                       "ms": time_ms(run, args.iters), "keys": n,
                       "device": power}
                if name != "products_only":
                    row["err_plain"] = (v - ref_v).abs().max().item()
                print(json.dumps(row), flush=True)
                rows.append(row)
            del ref_v
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    bad = [r for r in rows if r.get("err_plain", 0.0) > 1e-5]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
