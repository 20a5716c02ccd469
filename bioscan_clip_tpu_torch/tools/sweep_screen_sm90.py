"""The Hopper top-k bodies' screen policies on flooded tiles, timed in
turns: K5 (`csrc/topk_i8_sm90.cu`) and K4 (`csrc/topk_sm90.cu`) as built,
and built with another policy of `csrc/topk_sm90_common.cuh`'s screen
(the FLOOD argument of their `screen_scores` call), on random keys and on
keys whose scores rise with the index (every tile floods).

Variants (text edits of the sources, built side by side):
  k5:as_built, k4:as_built   the sources as they are (K5: kFloodCarry at
                             128 queries, kFloodNone below; K4: kFloodVote)
  k5:none, k4:none           kFloodNone: no raise, the screen as it was
                             before the raise
  k5:vote                    K4's policy in K5 at 128 queries: a vote, one
                             barrier a tile, the raise inline
  k5:carry_all               kFloodCarry at every query block
  k5:parent, k4:parent       with --parent DIR: that checkout's sources and
                             headers

Cases: K5 (k = 21) at Bq = 1, 16, 64, 128, 256 and 1024 over --keys random
unit rows' codes, and "rising" (Bq = 256, collinear keys whose scales rise
with the index); K4 (k = 5) "default" and "high" at Bq = 64 and 256, and
"rising". Each variant runs each case once a round, in --rounds rounds
whose order alternates (forward, backward, ...); a reading is CUDA events
over --iters launches. One JSON object per reading ("kernel", "variant",
"case", "precision", "round", "ms", "bit_equal" for K5 against
`topk_i8_reference`, "err" for K4 against `topk_reference`, "card"), then
one per (kernel, case, precision, variant) with the median and its ratio
to the parent's (with --parent) or to as_built.

    python -m bioscan_clip_tpu_torch.tools.sweep_screen_sm90 \\
        [--parent build/parent] [--rounds 3] [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import torch

from bioscan_clip_tpu_torch.ops import _build
from bioscan_clip_tpu_torch.ops import topk as topk_ops
from bioscan_clip_tpu_torch.tools import sweep_k5_sm90

K5_FLOOD = "NQ == 128 ? kFloodCarry : kFloodNone"
K4_FLOOD = "screen_scores<NQ, MAXK, kMergeAt, kFloodVote>("
K5_VARIANTS = {"none": [(K5_FLOOD, "kFloodNone")],
               "vote": [(K5_FLOOD, "NQ == 128 ? kFloodVote : kFloodNone")],
               "carry_all": [(K5_FLOOD, "kFloodCarry")]}
K4_VARIANTS = {"none": [(K4_FLOOD, K4_FLOOD.replace("kFloodVote",
                                                     "kFloodNone"))]}
K5_BQS = (1, 16, 64, 128, 256, 1024)
K4_BQS = (64, 256)
D, K5_K, K4_K = 768, 21, 5


def _edit(source: str, edits, what: str) -> str:
    for old, new in edits:
        if old not in source:
            raise ValueError(f"{what}: {old!r} not in the source")
        source = source.replace(old, new)
    return source


def variant_sources(k5_source: str, k4_source: str) -> dict:
    """{"k5:<name>" or "k4:<name>": text} of every edited variant; raises if
    an edit no longer applies."""
    out = {f"k5:{n}": _edit(k5_source, e, f"k5:{n}")
           for n, e in K5_VARIANTS.items()}
    out.update({f"k4:{n}": _edit(k4_source, e, f"k4:{n}")
                for n, e in K4_VARIANTS.items()})
    return out


def _entry(lib, kernel: str):
    """A library's top-k entry point, argument types set (the parent's
    libraries have no other entry that this tool calls)."""
    lib.bscan_error_string.argtypes = [ctypes.c_int]
    lib.bscan_error_string.restype = ctypes.c_char_p
    if kernel == "k5":
        fn = lib.bscan_topk_i8_sm90
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 6)
    else:
        fn = lib.bscan_topk_f32_sm90
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
                       + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    return SimpleNamespace(lib=lib, topk=fn)


def build(out_dir, parent=None) -> dict:
    """Every variant's entry point, keyed "k5:<name>" / "k4:<name>"."""
    csrc = _build.CSRC_DIR
    k5 = (csrc / "topk_i8_sm90.cu").read_text()
    k4 = (csrc / "topk_sm90.cu").read_text()
    sources = {name.replace(":", "_"): (text, csrc)
               for name, text in variant_sources(k5, k4).items()}
    if parent is not None:
        pdir = Path(parent) / "bioscan_clip_tpu_torch" / "csrc"
        sources["k5_parent"] = ((pdir / "topk_i8_sm90.cu").read_text(), pdir)
        sources["k4_parent"] = ((pdir / "topk_sm90.cu").read_text(), pdir)
    libs = _build.build_sources(sources, out_dir)
    kerns = {name.replace("_", ":", 1): _entry(lib, name[:2])
             for name, lib in libs.items()}
    kerns["k5:as_built"] = _entry(_build.load("topk_i8_sm90"), "k5")
    kerns["k4:as_built"] = _entry(_build.load("topk_sm90"), "k4")
    return kerns


def _k4_cases(n, gen, dev):
    keys = torch.randn(n, D, device=dev, generator=gen)
    keys /= keys.norm(dim=1, keepdim=True)
    q = torch.randn(max(K4_BQS), D, device=dev, generator=gen)
    q /= q.norm(dim=1, keepdim=True)
    cases = [(f"Bq={bq}", q[:bq].contiguous(), keys) for bq in K4_BQS]
    u = torch.randn(1, D, device=dev, generator=gen)
    u /= u.norm()
    qr = u + 0.1 * torch.randn(256, D, device=dev, generator=gen)
    qr /= qr.norm(dim=1, keepdim=True)
    rising = u * (1 + torch.arange(n, device=dev,
                                   dtype=torch.float32)[:, None] / n)
    return cases + [("rising", qr, rising)]


def sweep(kerns, n, rounds, iters, emit):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = topk_ops._device_sms(dev)
    card = torch.cuda.get_device_name(0)
    readings = []

    def order(kernel, rnd):
        names = sorted(v for v in kerns if v.startswith(kernel))
        return names if rnd % 2 == 0 else names[::-1]

    def record(row):
        readings.append(row)
        emit(json.dumps(row))

    k5_cases = list(sweep_k5_sm90.cases(n, gen, dev, bqs=K5_BQS))
    for rnd in range(rounds):
        for case, qc, qs, kc, ks in k5_cases:
            plan = topk_ops.plan_i8(qc.shape[0], n, K5_K, D, sms,
                                    body="sm90")
            rv, ri = topk_ops.topk_i8_reference(qc, qs, kc, ks, n, K5_K)
            for name in order("k5", rnd):
                def run(kern=kerns[name]):
                    return topk_ops._launch_i8_sm90(kern, qc, qs, kc, ks, n,
                                                    K5_K, plan)
                v, i = run()
                record({"kernel": "k5", "variant": name, "case": case,
                        "precision": None, "round": rnd,
                        "ms": sweep_k5_sm90.time_ms(run, iters),
                        "bit_equal": bool(torch.equal(v, rv)
                                          and torch.equal(i, ri)),
                        "card": card})
    del k5_cases
    torch.cuda.empty_cache()
    k4_cases = _k4_cases(n, gen, dev)
    for rnd in range(rounds):
        for case, q, keys in k4_cases:
            for prec in ("default", "high"):
                plan = topk_ops.plan_f32(q.shape[0], n, K4_K, prec, D, sms,
                                         body="sm90")
                rv, _ = topk_ops.topk_reference(q, keys, n, K4_K, prec)
                for name in order("k4", rnd):
                    def run(kern=kerns[name]):
                        return topk_ops._launch_sm90(kern, q, keys, n, K4_K,
                                                     prec, plan)
                    v, _ = run()
                    record({"kernel": "k4", "variant": name, "case": case,
                            "precision": prec, "round": rnd,
                            "ms": sweep_k5_sm90.time_ms(run, iters),
                            "err": (v - rv).abs().max().item(),
                            "card": card})
    return readings


def summary(readings):
    """The median of each (kernel, case, precision, variant) and its ratio
    to the parent's median (else as_built's)."""
    groups = {}
    for r in readings:
        key = (r["kernel"], r["case"], r["precision"])
        groups.setdefault(key, {}).setdefault(r["variant"], []).append(
            r["ms"])
    rows = []
    for (kernel, case, prec), by_variant in groups.items():
        med = {v: statistics.median(ms) for v, ms in by_variant.items()}
        base = med.get(f"{kernel}:parent", med.get(f"{kernel}:as_built"))
        for v, m in sorted(med.items()):
            rows.append({"summary": True, "kernel": kernel, "case": case,
                         "precision": prec, "variant": v, "median_ms": m,
                         "to_base": m / base})
    return rows


def main(argv=None, emit=print):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, default=1 << 20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--parent", default=None,
                    help="another checkout whose K4 and K5 run beside")
    ap.add_argument("--build-dir", default="build/sweep_screen")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_screen_sm90: CUDA is not available", file=sys.stderr)
        return 1
    power = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    emit(json.dumps({"card": power}))
    kerns = build(args.build_dir, args.parent)
    readings = sweep(kerns, args.keys, args.rounds, args.iters, emit)
    rows = summary(readings)
    for row in rows:
        emit(json.dumps(row))
    if args.out:
        with open(args.out, "a") as f:
            f.write("".join(json.dumps(r) + "\n" for r in readings + rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
