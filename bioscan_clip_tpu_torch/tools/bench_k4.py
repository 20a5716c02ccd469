"""K4 (`ops/topk.topk`, fp32 keys) and K5 (`ops/topk.topk_i8`, int8 codes)
on the card at the search paths' query counts, beside the library call and
the bound.

Cases: "high" and "default" precision at Bq = 1, 16, 64, 256 and 1024 over
--keys random unit rows (D = 768, k = 5), and "rising" (Bq = 256 over keys
u * (1 + i / n) whose scores rise with the index for queries near u: every
score passes the screen). Each time is CUDA events over --reps calls after a
warm-up. One JSON object per case:

  precision, case  "high" / "default"; "Bq=<n>" or "rising"
  bq, keys         the query count and N
  k4_ms            card ms per `topk` call
  body             the body the package's plan chose ("sm90", "mma"; null
                   for a package without `plan_f32` bodies)
  library_ms       torch.topk(q @ keys.T) on the operands as the precision
                   sees them (fp32; in "default" bf16, cast before the
                   timing)
  library_cast_ms  "default" only: the same with the cast of q and the keys
                   to bf16 inside the timing
  bound_ms         max(bytes / 3.35 TB/s, operations / 989 TFLOP/s): the
                   keys and queries read once, the top-k written once; one
                   bf16 product ("default") or six ("high")
  max_abs_err      max |topk - topk_reference| over the values

K5 (`--kernels k5`): k = 21 (the engine's int8 oversampling of k = 5) at
Bq = 1, 16, 64, 256 and 1024 over the codes of --keys random unit rows,
"rising" (Bq = 256 over collinear keys whose scales rise with the index:
every score passes the screen), and at Bq = 256 and 1 over --keys-5m
random codes (the BIOSCAN-5M key set's size; 0 skips them). One JSON
object per case:

  kernel, case     "k5"; "Bq=<n>", "rising", "5M Bq=<n>"
  bq, keys         the query count and N
  k5_ms            card ms per `topk_i8` call
  body             the body the package's plan chose ("sm90", "mma"; "mma"
                   for a package whose plan has no bodies)
  library_ms       torch._int_mm (Bq padded to 32 rows) + the two scales +
                   torch.topk
  bound_ms         max(bytes / 3.35 TB/s, operations / 1,979 TOP/s): the
                   codes and scales read once, the top-k written once
  bit_equal        values and indices equal to `topk_i8_reference`'s

K6 (`--kernels k6`, `ops/topk.mm_only`): "high", "default" and "int8" at
Bq = 1, 16, 17, 32, 64, 256 and 1024 over --keys random unit rows (their
codes for int8), and "rising" (Bq = 256 over the fp32 keys u * (1 + i /
n); int8: u's codes on every key). One JSON object per case and mode:

  kernel, mode, case  "k6"; "high" / "default" / "int8"; "Bq=<n>" or
                   "rising"
  k6_ms            card ms per `mm_only` call, on the walk the package's
                   plan chooses (`body`: "sm90", "mma"; "mma" for a
                   package whose plan has no walks)
  sm90_ms, mma_ms  the same on each walk under its own plan (null for a
                   package without `plan_mm_only`)
  nq128_ms         "default" at Bq = 256: the sm90 walk at a query block
                   of 128 (four stages) in place of the plan's 256 (three)
  library_ms       (q @ keys.T).amax in fp32 ("high"), in bf16 with the
                   operands cast before the timing ("default"; with the
                   cast inside it: library_cast_ms), torch._int_mm (Bq
                   padded to 32 rows) + amax (int8)
  bound_ms         max(bytes / 3.35 TB/s, operations / 989 TFLOP/s bf16
                   or 1,979 TOP/s int8): the keys and queries read once,
                   (Bq, 128) fp32 written once; six products in "high"
  max_abs_err      max |mm_only - mm_only_reference| (int8: 0 when
                   bit-equal)

The package is the one on the import path, so one checkout's script times
another checkout's K4: run it from that checkout's root with `PYTHONPATH=.`,
and compare two packages in one call, in turns (parent, change, change,
parent):

    PYTHONPATH=. python3 path/to/bench_k4.py [--keys 1048576] [--reps 10]
        [--kernels k4,k5,k6] [--keys-5m 5000000]

The first line names the imported package's file and the card (name and
power limit, as nvidia-smi gives them). `--sass` adds one row per
instantiation of K4, K5 and K6 in the package's built libraries (the
Hopper bodies of csrc/topk_sm90.cu and csrc/topk_i8_sm90.cu, whose
row-max instantiations are K6's, and the mma.sync bodies and K6 walks of
csrc/topk.cu), read with cuobjdump: `registers`, `stack`, `local`, the
SASS `instructions` and `sha1`, a hash of their text in order without
addresses or encodings, so that two checkouts' code can be compared.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import shutil
import subprocess
from pathlib import Path

BQS = (1, 16, 64, 256, 1024)
# K6: the crossing's query counts (16 | 17, 32) beside the probe's
K6_BQS = (1, 16, 17, 32, 64, 256, 1024)
D, K, K_I8 = 768, 5, 21
PEAK_BYTES, PEAK_BF16, PEAK_INT8 = 3.35e12, 989e12, 1979e12


def events_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Card ms per call of `fn`: CUDA events around `reps` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cases(n, gen):
    """(name, queries, keys): unit rows at each Bq, then rising scores."""
    import torch

    keys = torch.randn(n, D, device="cuda", generator=gen)
    keys /= keys.norm(dim=1, keepdim=True)
    q = torch.randn(max(BQS), D, device="cuda", generator=gen)
    q /= q.norm(dim=1, keepdim=True)
    for bq in BQS:
        yield f"Bq={bq}", q[:bq].contiguous(), keys
    u = torch.randn(1, D, device="cuda", generator=gen)
    u /= u.norm()
    q = u + 0.1 * torch.randn(256, D, device="cuda", generator=gen)
    yield "rising", q / q.norm(dim=1, keepdim=True), u * (
        1 + torch.arange(n, device="cuda", dtype=torch.float32)[:, None] / n)


def i8_cases(n, n5m, gen):
    """(name, query codes, query scales, key codes, key scales): unit rows'
    codes at each Bq, rising scores, then random codes over n5m keys."""
    import torch

    from bioscan_clip_tpu_torch.ops import topk

    quantize = topk.quantize_rows_i8_torch
    x = torch.randn(n, D, device="cuda", generator=gen)
    kc, ks = quantize(x / x.norm(dim=1, keepdim=True))
    del x
    q = torch.randn(max(BQS), D, device="cuda", generator=gen)
    qc, qs = quantize(q / q.norm(dim=1, keepdim=True))
    for bq in BQS:
        yield f"Bq={bq}", qc[:bq].contiguous(), qs[:bq].contiguous(), kc, ks
    u = torch.randn(1, D, device="cuda", generator=gen)
    uc, us = quantize(u)
    qr, qrs = quantize(u + 0.1 * torch.randn(256, D, device="cuda",
                                             generator=gen))
    yield "rising", qr, qrs, uc.expand(n, D).contiguous(), us * (
        1 + torch.arange(n, device="cuda", dtype=torch.float32) / n)
    del kc, ks
    if n5m:
        kc = torch.randint(-127, 128, (n5m, D), device="cuda", generator=gen,
                           dtype=torch.int8)
        ks = 1e-3 + 1e-3 * torch.rand(n5m, device="cuda", generator=gen)
        for bq in (256, 1):
            yield (f"5M Bq={bq}", qc[:bq].contiguous(), qs[:bq].contiguous(),
                   kc, ks)


def bench_k5(args, gen):
    import torch

    from bioscan_clip_tpu_torch.ops import topk

    for case, qc, qs, kc, ks in i8_cases(args.keys, args.keys_5m, gen):
        bq, n = qc.shape[0], kc.shape[0]
        v, i = topk.topk_i8(qc, qs, kc, ks, n, K_I8)
        rv, ri = topk.topk_i8_reference(qc, qs, kc, ks, n, K_I8)
        equal = torch.equal(v, rv) and torch.equal(i, ri)
        del v, i, rv, ri
        k5_ms = events_ms(lambda: topk.topk_i8(qc, qs, kc, ks, n, K_I8),
                          args.reps)
        body = "mma"
        if hasattr(topk, "I8Plan"):
            body = topk.plan_i8(bq, n, K_I8, D,
                                topk._device_sms(qc.device)).body
        qp = torch.zeros(max(32, -(-bq // 8) * 8), D, device="cuda",
                         dtype=torch.int8)
        qp[:bq] = qc

        def library():
            s = torch._int_mm(qp, kc.T)[:bq].to(torch.float32)
            return torch.topk((s * qs[:, None]) * ks[None, :], K_I8, dim=1)

        lib_ms = events_ms(library, args.reps)
        n_bytes = n * D + 4 * n + bq * D + 4 * bq + bq * K_I8 * 8
        bound = 1e3 * max(n_bytes / PEAK_BYTES, 2 * bq * n * D / PEAK_INT8)
        print(json.dumps({
            "kernel": "k5", "case": case, "bq": bq, "keys": n,
            "k5_ms": k5_ms, "body": body, "library_ms": lib_ms,
            "bound_ms": bound, "bit_equal": equal}), flush=True)
        torch.cuda.empty_cache()


def bench_k6(args, gen):
    import torch

    from bioscan_clip_tpu_torch.ops import topk

    n = args.keys
    keys = torch.randn(n, D, device="cuda", generator=gen)
    keys /= keys.norm(dim=1, keepdim=True)
    kc, _ = topk.quantize_rows_i8_torch(keys)
    q_all = torch.randn(max(K6_BQS), D, device="cuda", generator=gen)
    q_all /= q_all.norm(dim=1, keepdim=True)
    qc_all, _ = topk.quantize_rows_i8_torch(q_all)
    u = torch.randn(1, D, device="cuda", generator=gen)
    u /= u.norm()
    qr = u + 0.1 * torch.randn(256, D, device="cuda", generator=gen)
    qr /= qr.norm(dim=1, keepdim=True)
    cases = [(f"Bq={bq}", q_all[:bq].contiguous(),
              qc_all[:bq].contiguous(), keys, kc) for bq in K6_BQS]
    cases.append(("rising", qr, topk.quantize_rows_i8_torch(qr)[0], None,
                  None))
    sms = topk._device_sms(keys.device)
    walks = hasattr(topk, "plan_mm_only")
    for case, q, qc, kf, ki in cases:
        if kf is None:  # rising: made here, freed after
            kf = u * (1 + torch.arange(n, device="cuda",
                                       dtype=torch.float32)[:, None] / n)
            ki = topk.quantize_rows_i8_torch(u)[0].expand(n, D).contiguous()
        bq = q.shape[0]
        for mode in ("high", "default", "int8"):
            qq, kk = (qc, ki) if mode == "int8" else (q, kf)
            kw = (dict(int8=True) if mode == "int8"
                  else dict(precision=mode))
            out = topk.mm_only(qq, kk, n, **kw)
            ref = topk.mm_only_reference(qq, kk, n, **kw)
            err = (out - ref).abs().max().item()
            del out, ref
            k6_ms = events_ms(lambda: topk.mm_only(qq, kk, n, **kw),
                              args.reps)
            body, walk_ms, nq128 = "mma", {}, None
            if walks:
                body = topk.plan_mm_only(bq, n, D, mode, sms).body
                for walk in ("sm90", "mma"):
                    wp = topk.plan_mm_only(bq, n, D, mode, sms, body=walk)
                    launch = (topk._launch_mm_sm90 if walk == "sm90"
                              else topk._launch_mm_mma)
                    walk_ms[walk] = events_ms(
                        lambda wp=wp, launch=launch: launch(qq, kk, n, mode,
                                                            wp), args.reps)
                if mode == "default" and bq == 256:
                    wp = topk.mm_sm90_plan(bq, n, mode, sms, 128, 4)
                    nq128 = events_ms(lambda: topk._launch_mm_sm90(
                        qq, kk, n, mode, wp), args.reps)
            cast_ms = None
            if mode == "int8":
                qp = torch.zeros(max(32, -(-bq // 8) * 8), D, device="cuda",
                                 dtype=torch.int8)
                qp[:bq] = qq

                def library():
                    return torch._int_mm(qp, kk.T)[:bq].amax(dim=1)
            elif mode == "default":
                ql, kl = qq.to(torch.bfloat16), kk.to(torch.bfloat16)

                def library():
                    return (ql @ kl.T).amax(dim=1)

                cast_ms = events_ms(lambda: (
                    qq.to(torch.bfloat16) @ kk.to(torch.bfloat16).T).amax(
                        dim=1), args.reps)
            else:
                def library():
                    return (qq @ kk.T).amax(dim=1)
            lib_ms = events_ms(library, args.reps)
            size = 1 if mode == "int8" else 4
            n_bytes = (n * D + bq * D) * size + bq * 128 * 4
            n_ops = 2 * (6 if mode == "high" else 1) * bq * n * D
            peak = PEAK_INT8 if mode == "int8" else PEAK_BF16
            bound = 1e3 * max(n_bytes / PEAK_BYTES, n_ops / peak)
            print(json.dumps({
                "kernel": "k6", "mode": mode, "case": case, "bq": bq,
                "keys": n, "k6_ms": k6_ms, "body": body,
                "sm90_ms": walk_ms.get("sm90"), "mma_ms": walk_ms.get("mma"),
                "nq128_ms": nq128, "library_ms": lib_ms,
                "library_cast_ms": cast_ms, "bound_ms": bound,
                "max_abs_err": err}), flush=True)
            torch.cuda.empty_cache()
        if case == "rising":
            del kf, ki


# (what, library, symbol, label of its groups): K4's bodies, K5's and the
# row-max (K6) instantiations of the Hopper bodies, K6's mma.sync walks
SASS_SYMBOLS = (
    ("sm90", "topk_sm90",
     re.compile(r"topk_f32_sm90ILi(\d+)ELi(\d+)ELi(\d+)E(?:Lb(\d)E)?"),
     lambda m, q, t, r: (f"K6 sm90 NQ={q} TERMS={t}" if r == "1" else
                         f"K4 sm90 MAXK={m} QB={q} TERMS={t}")),
    ("mma.sync", "topk",
     re.compile(r"topk_f32_pass1ILi(\d+)ELi(\d+)ELi(\d+)E"),
     lambda m, q, t: f"K4 mma.sync MAXK={m} QB={q} TERMS={t}"),
    ("sm90", "topk_i8_sm90",
     re.compile(r"topk_i8_sm90ILi(\d+)ELi(\d+)ELb(\d)E(?:Lb(\d)E)?"),
     lambda m, q, seed, r: (f"K6 sm90 int8 NQ={q}" if r == "1" else
                            f"K5 sm90 MAXK={m} NQ={q} SEED={seed}")),
    ("mma.sync", "topk", re.compile(r"topk_i8_pass1ILi(\d+)ELi(\d+)E"),
     lambda m, q: f"K5 mma.sync MAXK={m} QB={q}"),
    ("mma.sync", "topk", re.compile(r"mm_only_f32_pass1ILi(\d+)ELi(\d+)E"),
     lambda q, t: f"K6 mma.sync QB={q} TERMS={t}"),
    ("mma.sync", "topk", re.compile(r"mm_only_i8_pass1ILi(\d+)E"),
     lambda q: f"K6 mma.sync int8 QB={q}"),
)


def _cuobjdump(*args) -> str:
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([exe, *args], capture_output=True, text=True,
                          check=True).stdout


def sass_rows():
    """{"sass", "registers", "stack", "local", "instructions", "sha1"} of
    each instantiation of SASS_SYMBOLS in the package's built libraries
    ("sha1": the first 16 hex digits of the hash of its instructions'
    text, addresses and encodings left out). A package built before K6's
    row-max flag names its Hopper instantiations without it: they are the
    flag's off state."""
    from bioscan_clip_tpu_torch.ops import _build

    rows = []
    for _, lib, symbol, label in SASS_SYMBOLS:
        path = str(_build._library_path(lib))
        if not Path(path).exists():
            continue
        found, fn = {}, None
        for ln in _cuobjdump("-res-usage", path).splitlines():
            m = symbol.search(ln)
            if "Function" in ln:
                fn = m.groups() if m else None
            elif fn and "REG:" in ln:
                use = dict(re.findall(r"(\w+):(\d+)", ln))
                found[fn] = {
                    "sass": label(*(g or "0" for g in fn)),
                    "registers": int(use["REG"]), "stack": int(use["STACK"]),
                    "local": int(use["LOCAL"]), "instructions": 0,
                    "sha1": hashlib.sha1()}
                fn = None
        for ln in _cuobjdump("-sass", path).splitlines():
            m = symbol.search(ln)
            if "Function :" in ln:
                fn = m.groups() if m and m.groups() in found else None
                continue
            ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?"
                           r"([A-Z]\S*)", ln)
            if fn and ins:
                found[fn]["instructions"] += 1
                found[fn]["sha1"].update(
                    ln.split("*/", 1)[1].split(";")[0].strip().encode()
                    + b"\n")
        rows += [dict(r, sha1=r["sha1"].hexdigest()[:16])
                 for _, r in sorted(found.items())]
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--keys", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default="k4,k5")
    ap.add_argument("--keys-5m", type=int, default=5_000_000)
    ap.add_argument("--sass", action="store_true",
                    help="also K4's, K5's and K6's registers and SASS from "
                         "cuobjdump")
    args = ap.parse_args(argv)
    kernels = set(filter(None, args.kernels.split(",")))

    import torch

    from bioscan_clip_tpu_torch.ops import topk

    if not torch.cuda.is_available():
        raise SystemExit("bench_k4: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({"package": topk.__file__, "card": card}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for case, q, keys in (cases(args.keys, gen) if "k4" in kernels
                          else ()):
        bq, n = q.shape[0], keys.shape[0]
        for precision in ("high", "default"):
            vals, _ = topk.topk(q, keys, n, K, precision=precision)
            ref, _ = topk.topk_reference(q, keys, n, K, precision=precision)
            err = (vals - ref).abs().max().item()
            del vals, ref
            k4_ms = events_ms(lambda: topk.topk(q, keys, n, K,
                                                precision=precision),
                              args.reps)
            body = None
            if hasattr(topk, "F32Plan"):
                body = topk.plan_f32(bq, n, K, precision, D,
                                     topk._device_sms(q.device)).body
            if precision == "default":
                ql, kl = q.to(torch.bfloat16), keys.to(torch.bfloat16)
            else:
                ql, kl = q, keys
            lib_ms = events_ms(lambda: torch.topk(ql @ kl.T, K, dim=1),
                               args.reps)
            del ql, kl
            cast_ms = None
            if precision == "default":
                cast_ms = events_ms(lambda: torch.topk(
                    q.to(torch.bfloat16) @ keys.to(torch.bfloat16).T, K,
                    dim=1), args.reps)
            n_bytes = n * D * 4 + bq * D * 4 + bq * K * 8
            n_ops = 2 * (6 if precision == "high" else 1) * bq * n * D
            bound = 1e3 * max(n_bytes / PEAK_BYTES, n_ops / PEAK_BF16)
            print(json.dumps({
                "precision": precision, "case": case, "bq": bq, "keys": n,
                "k4_ms": k4_ms, "body": body, "library_ms": lib_ms,
                "library_cast_ms": cast_ms, "bound_ms": bound,
                "max_abs_err": err}), flush=True)
            torch.cuda.empty_cache()
        del q, keys
    if "k5" in kernels:
        bench_k5(args, gen)
    if "k6" in kernels:
        bench_k6(args, gen)
    if args.sass:
        for row in sass_rows():
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
