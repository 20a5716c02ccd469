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

The package is the one on the import path, so one checkout's script times
another checkout's K4: run it from that checkout's root with `PYTHONPATH=.`,
and compare two packages in one call, in turns (parent, change, change,
parent):

    PYTHONPATH=. python3 path/to/bench_k4.py [--keys 1048576] [--reps 10]
        [--kernels k4,k5] [--keys-5m 5000000]

The first line names the imported package's file and the card (name and
power limit, as nvidia-smi gives them). `--sass` adds one row per K4
instantiation of the package's built libraries (the Hopper body of
csrc/topk_sm90.cu, the mma.sync body of csrc/topk.cu), read with
cuobjdump: `registers`, `stack`, `local`, the SASS `instructions` and
`sha1`, a hash of their text in order without addresses or encodings,
so that two checkouts' K4 code can be compared.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import shutil
import subprocess

BQS = (1, 16, 64, 256, 1024)
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


K4_SYMBOLS = (("sm90", "topk_sm90",
                re.compile(r"topk_f32_sm90ILi(\d+)ELi(\d+)ELi(\d+)E")),
              ("mma.sync", "topk",
               re.compile(r"topk_f32_pass1ILi(\d+)ELi(\d+)ELi(\d+)E")))


def _cuobjdump(*args) -> str:
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([exe, *args], capture_output=True, text=True,
                          check=True).stdout


def sass_rows():
    """{"sass", "registers", "stack", "local", "instructions", "sha1"} of
    each K4 instantiation (MAXK, query block, TERMS) in the package's built
    libraries ("sha1": the first 16 hex digits of the hash of its
    instructions' text, addresses and encodings left out)."""
    from bioscan_clip_tpu_torch.ops import _build

    rows = []
    for body, lib, symbol in K4_SYMBOLS:
        path = str(_build._library_path(lib))
        found, fn = {}, None
        for ln in _cuobjdump("-res-usage", path).splitlines():
            m = symbol.search(ln)
            if "Function" in ln:
                fn = m.groups() if m else None
            elif fn and "REG:" in ln:
                use = dict(re.findall(r"(\w+):(\d+)", ln))
                found[fn] = {
                    "sass": f"K4 {body} MAXK={fn[0]} QB={fn[1]} "
                            f"TERMS={fn[2]}",
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
                    help="also K4's registers and SASS from cuobjdump")
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
    if args.sass:
        for row in sass_rows():
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
