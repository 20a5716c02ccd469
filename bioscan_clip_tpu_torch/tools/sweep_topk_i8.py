"""Design sweep of the int8 top-k kernel's mma.sync body (K5 below its
plan's crossing, and K6's int8 walk) on the card: variants of
`csrc/topk.cu`, each one text edit of its K5 constants or launches, built
side by side and timed in one process, so that they share a card. K5's
Hopper body has its own sweep, `tools/sweep_k5_sm90.py`.

Variants:
  as_built       the source as it is
  cluster_1      no cluster merge: pass 2 reads every key split's k
                 candidates
  cluster_4      four key splits merged per cluster
  chunk_64       64-byte depth chunks (half lines) at every query block
  pass1_only     pass 1 alone (pass 2 not launched; no check)
  pass2_only     pass 2 alone on stale candidates (pass 1 not launched; no
                 check)
Each variant runs under `ops.topk.plan_i8(body="mma")`, its key splits
rounded to the variant's cluster. Rows, one JSON object each: variant,
case (Bq = 1, 16, 64, 256, and "rising": Bq = 256 over collinear keys
whose scales rise with the index, so every score passes the screen),
query block, splits, ms (CUDA events over --iters launches after a
warm-up), and whether the output is bit-equal to
`ops.topk.topk_i8_reference`. N = --keys, D = 768, k = 21
(the engine's int8 oversampling of k = 5). Needs a CUDA device and nvcc.

    python -m bioscan_clip_tpu_torch.tools.sweep_topk_i8 [--keys 1048576]
        [--iters 20] [--out FILE]
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

CLUSTER = "constexpr int CLUSTER = 2;"
CHUNK = "constexpr int i8_dc(int qb) { return qb == 64 ? 64 : 128; }"
PASS1 = "  topk_i8_pass1<MAXK, QB><<<grid1, TPB, smem, stream>>>("
# K4's launch ends the same way, so pass1_only drops its pass 2 too
PASS2 = ("  return launch_pass2<MAXK>(bq, splits / CLUSTER * k, k, cand_v, "
         "cand_i,\n                            out_v, out_i, stream);")
VARIANTS = {
    "as_built": [],
    "cluster_1": [(CLUSTER, "constexpr int CLUSTER = 1;")],
    "cluster_4": [(CLUSTER, "constexpr int CLUSTER = 4;")],
    "chunk_64": [(CHUNK, "constexpr int i8_dc(int qb) { return 64; }")],
    "pass1_only": [(PASS2, "  return cudaSuccess;")],
    "pass2_only": [(PASS1, "  if (false) " + PASS1.lstrip())],
}
CHECKED = ("as_built", "cluster_1", "cluster_4", "chunk_64")
D, K = 768, 21


def variant_sources(source: str) -> dict[str, str]:
    """Each variant's text of csrc/topk.cu; raises if an edit no longer
    applies to `source`."""
    out = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise ValueError(f"{name}: {old!r} not in csrc/topk.cu")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(out_dir) -> dict[str, ctypes.CDLL]:
    """Compile every variant with the port's nvcc flags, in parallel."""
    sources = variant_sources((_build.CSRC_DIR / "topk.cu").read_text())
    libs = _build.build_sources(
        {name: (text, _build.CSRC_DIR) for name, text in sources.items()},
        out_dir)
    for lib in libs.values():
        lib.bscan_topk_i8.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_longlong]
            + [ctypes.c_void_p] * 5)
    return libs


def variant_plan(name, bq, n, sms):
    """The mma.sync body's plan for a variant: its key splits (none empty)
    rounded up to a multiple of the variant's cluster, and the candidates
    pass 2 then reads."""
    plan = topk_ops.plan_i8(bq, n, K, D, sms, body="mma")
    cluster = {"cluster_1": 1, "cluster_4": 4}.get(name, topk_ops._CLUSTER)
    n_tiles = -(-n // topk_ops._KEY_TILE)
    used = -(-n_tiles // plan.tiles_per_split)  # splits holding a tile
    splits = -(-used // cluster) * cluster
    return dataclasses.replace(plan, splits=splits,
                               n_cand=bq * splits // cluster * K)


def cases(n, gen, dev):
    """(name, query codes, query scales, key codes, key scales)."""
    quantize = topk_ops.quantize_rows_i8_torch
    x = torch.randn(n, D, device=dev, generator=gen)
    kc, ks = quantize(x / x.norm(dim=1, keepdim=True))
    del x
    q = torch.randn(256, D, device=dev, generator=gen)
    qc, qs = quantize(q / q.norm(dim=1, keepdim=True))
    for bq in (1, 16, 64, 256):
        yield f"Bq={bq}", qc[:bq].contiguous(), qs[:bq].contiguous(), kc, ks
    u = torch.randn(1, D, device=dev, generator=gen)
    uc, us = quantize(u)
    qc, qs = quantize(u + 0.1 * torch.randn(256, D, device=dev,
                                            generator=gen))
    ks = us * (1 + torch.arange(n, device=dev, dtype=torch.float32) / n)
    yield "rising", qc, qs, uc.expand(n, D).contiguous(), ks


def run(lib, name, qc, qs, kc, ks, iters):
    """(ms per launch, query block, splits, output (values, indices))."""
    dev = qc.device
    bq, n = qc.shape[0], kc.shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = variant_plan(name, bq, n, sms)
    qb, splits, per_split, n_cand = (plan.qb, plan.splits,
                                     plan.tiles_per_split, plan.n_cand)
    cand_v = torch.zeros(n_cand, device=dev)
    cand_i = torch.zeros(n_cand, device=dev, dtype=torch.int32)
    out_v = torch.empty(bq, K, device=dev)
    out_i = torch.empty(bq, K, device=dev, dtype=torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        err = lib.bscan_topk_i8(
            qc.data_ptr(), qs.data_ptr(), kc.data_ptr(), ks.data_ptr(), bq, n,
            D, n, K, qb, splits, per_split, n_cand, cand_v.data_ptr(),
            cand_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), stream)
        if err:
            raise RuntimeError(f"bscan_topk_i8: CUDA error {err}")

    launch()
    torch.cuda.synchronize(dev)
    out = (out_v.clone(), out_i.clone())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, qb, splits, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_topk_i8: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    power = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    libs = build(_build.BUILD_DIR.parent / "topk_i8_sweep")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows = []
    for case, qc, qs, kc, ks in cases(args.keys, gen, dev):
        ref = topk_ops.topk_i8_reference(qc, qs, kc, ks, kc.shape[0], K)
        for name, lib in libs.items():
            ms, qb, splits, (v, i) = run(lib, name, qc, qs, kc, ks,
                                         args.iters)
            equal = (torch.equal(v, ref[0]) and torch.equal(i, ref[1])
                     if name in CHECKED else None)
            row = {"variant": name, "case": case, "query_block": qb,
                   "splits": splits, "ms": ms, "bit_equal": equal,
                   "keys": kc.shape[0], "device": power}
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    bad = [r for r in rows if r["bit_equal"] is False]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
