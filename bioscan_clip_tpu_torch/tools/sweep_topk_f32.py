"""Design sweep of the fp32 top-k kernel (K4) on the card: variants of
`csrc/topk.cu`, each one text edit, and optionally another checkout's
`csrc/topk.cu` (`--parent`), built side by side and timed in one process,
so that they share a card.

Variants:
  as_built         the source as it is
  pass1_only       pass 1 alone (pass 2 not launched; no check)
  one_accumulator  "high"'s six products summed into the running score on
                   the tensor cores, without the FADD of each k-step's sum
  ring_2           two ring stages (one chunk in flight) at 64 query rows
  no_products      no products (every score 0; timing only: the ring, the
                   query split and the screen)
  no_split         the query split skipped (stale pieces; timing only)
  parent:NAME      (with --parent DIR, repeatable) DIR's csrc/topk.cu
                   through its own entry points, NAME the directory's name
Cases: "high" and "default" at Bq = 1, 16, 64, 256 over --keys random
unit rows, and "rising" (Bq = 256 over keys u * (1 + i / n), whose scores
rise with the index for queries near u: every score passes the screen);
D = 768, k = 5. Rows, one JSON object each: variant, precision, case,
round, query block, ms (CUDA events over --iters launches after a
warm-up), err_plain (max |values - the plain version's|) and err_f64
(max |values - float64 scores of the returned keys over the operands as
the precision sees them: fp32 for "high", bf16 for "default"), and the
card; one "library" row per case and precision: torch.topk over the
product (fp32, or bf16 operands cast before the timing). The variants run
in order, then again in reverse order (round 2), so that the parent's and
this tree's times bracket each other. Needs a CUDA device and nvcc.

    python -m bioscan_clip_tpu_torch.tools.sweep_topk_f32 [--parent DIR]
        [--keys 1048576] [--iters 10] [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from bioscan_clip_tpu_torch.ops import _build
from bioscan_clip_tpu_torch.ops import topk as topk_ops
from bioscan_clip_tpu_torch.tools.sweep_topk_i8 import PASS2

FADD = "          acc[mt][nb][e] = __fadd_rn(acc[mt][nb][e], c[nb][e]);"
MMA = "    f32_mma_chunk<QB, TERMS>(slot, ap, warp, lane, acc);\n"
SPLIT = "    f32_split_queries<QB, TERMS>(slot, ap);\n"
VARIANTS = {
    "as_built": [],
    "pass1_only": [(PASS2, "  return cudaSuccess;")],
    "one_accumulator": [
        ("      float c[2][4] = {};", "      float (&c)[2][4] = acc[mt];"),
        (FADD, "          ;"),
    ],
    "ring_2": [("  return qb == 64 ? 3 : 4;  // at 64 query rows",
                "  return qb == 64 ? 2 : 4;  // at 64 query rows")],
    "no_products": [(MMA, "")],
    "no_split": [(SPLIT, "")],
}
CHECKED = ("as_built", "one_accumulator")
D, K = 768, 5
PRECISIONS = {"high": 0, "default": 1}


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


def build(out_dir, parents=()) -> dict[str, ctypes.CDLL]:
    """Compile every variant (and each parent's source) in parallel."""
    sources = {name: (text, _build.CSRC_DIR) for name, text in
               variant_sources((_build.CSRC_DIR / "topk.cu").read_text())
               .items()}
    for parent in parents:
        csrc = Path(parent) / "bioscan_clip_tpu_torch" / "csrc"
        sources[f"parent:{Path(parent).resolve().name}"] = (
            (csrc / "topk.cu").read_text(), csrc)
    return _build.build_sources(sources, out_dir)


class Launch:
    """One launch configuration of a library's K4 for (bq, n): its plan
    and buffers, through this tree's entry point (`ops/topk.plan_f32`'s
    mma.sync plan, the candidate count passed for the entry to check) or
    an older tree's (its C plan `bscan_topk_f32_plan`, or `bscan_topk_plan`
    and 64-query blocks)."""

    def __init__(self, lib, bq, n, dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        ints = [ctypes.c_int() for _ in range(3)]
        n_cand = ctypes.c_longlong()
        if not (hasattr(lib, "bscan_topk_f32_plan")
                or hasattr(lib, "bscan_topk_plan")):
            plan = topk_ops.plan_f32(bq, n, K, "high", D, sms, body="mma")
            n_cand.value = plan.n_cand
            self.plan = [plan.qb, plan.splits, plan.tiles_per_split,
                         plan.n_cand]
            plan_types = [ctypes.c_int] * 3 + [ctypes.c_longlong]
        elif hasattr(lib, "bscan_topk_f32_plan"):
            lib.bscan_topk_f32_plan.argtypes = (
                [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4)
            lib.bscan_topk_f32_plan.restype = None
            lib.bscan_topk_f32_plan(bq, n, K, sms,
                                    *[ctypes.byref(v) for v in ints],
                                    ctypes.byref(n_cand))
            self.plan = [v.value for v in ints]
            plan_types = [ctypes.c_int] * 3
        else:
            lib.bscan_topk_plan.argtypes = (
                [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
            lib.bscan_topk_plan.restype = None
            lib.bscan_topk_plan(bq, n, K, sms,
                                *[ctypes.byref(v) for v in ints[1:]],
                                ctypes.byref(n_cand))
            self.plan = [v.value for v in ints[1:]]
            plan_types = [ctypes.c_int] * 2
        lib.bscan_topk_f32.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + plan_types
            + [ctypes.c_void_p] * 5)
        self.query_block = self.plan[0] if len(self.plan) >= 3 else 64
        self.lib, self.bq, self.n = lib, bq, n
        self.cand_v = torch.zeros(n_cand.value, device=dev)
        self.cand_i = torch.zeros(n_cand.value, device=dev,
                                  dtype=torch.int32)
        self.out_v = torch.empty(bq, K, device=dev)
        self.out_i = torch.empty(bq, K, device=dev, dtype=torch.int32)
        self.stream = torch.cuda.current_stream(dev).cuda_stream

    def __call__(self, q, keys, precision):
        err = self.lib.bscan_topk_f32(
            q.data_ptr(), keys.data_ptr(), self.bq, self.n, D, self.n, K,
            PRECISIONS[precision], *self.plan, self.cand_v.data_ptr(),
            self.cand_i.data_ptr(), self.out_v.data_ptr(),
            self.out_i.data_ptr(), self.stream)
        if err:
            raise RuntimeError(f"bscan_topk_f32: CUDA error {err}")
        return self.out_v, self.out_i


def cases(n, gen, dev):
    """(name, queries, keys): unit rows at each Bq, then rising scores."""
    keys = torch.randn(n, D, device=dev, generator=gen)
    keys /= keys.norm(dim=1, keepdim=True)
    q = torch.randn(256, D, device=dev, generator=gen)
    q /= q.norm(dim=1, keepdim=True)
    for bq in (1, 16, 64, 256):
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", action="append", default=[],
                    help="another checkout whose K4 is timed beside "
                         "(repeatable)")
    ap.add_argument("--keys", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_topk_f32: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    power = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    libs = build(_build.BUILD_DIR.parent / "topk_f32_sweep", args.parent)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    data = list(cases(args.keys, gen, dev))
    order = list(libs)
    rows = []

    def emit(row):
        row.update(keys=args.keys, device=power)
        print(json.dumps(row), flush=True)
        rows.append(row)

    for rnd, names in ((1, order), (2, order[::-1])):
        for precision in PRECISIONS:
            for case, q, keys in data:
                bq, n = q.shape[0], keys.shape[0]
                ref_v, _ = topk_ops.topk_reference(q, keys, n, K, precision)
                qd, kd = ((x.to(torch.bfloat16) for x in (q, keys))
                          if precision == "default" else (q, keys))
                for name in names:
                    launch = Launch(libs[name], bq, n, dev)
                    v, i = (t.clone() for t in launch(q, keys, precision))
                    torch.cuda.synchronize()
                    row = {"variant": name, "precision": precision,
                           "case": case, "round": rnd,
                           "query_block": launch.query_block,
                           "ms": time_ms(lambda: launch(q, keys, precision),
                                         args.iters)}
                    if name in CHECKED or name.startswith("parent"):
                        s64 = (qd.double()[:, None, :]
                               * kd[i.long()].double()).sum(-1)
                        row["err_plain"] = (v - ref_v).abs().max().item()
                        row["err_f64"] = (v.double() - s64).abs().max().item()
                    emit(row)
                if rnd == 1:
                    emit({"variant": "library", "precision": precision,
                          "case": case, "round": rnd,
                          "ms": time_ms(lambda: torch.topk(qd @ kd.T, K,
                                                           dim=1),
                                        args.iters)})
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    bad = [r for r in rows if r.get("err_plain", 0.0) > 1e-5]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
