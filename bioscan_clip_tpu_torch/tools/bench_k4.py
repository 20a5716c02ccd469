"""K4 (`ops/topk.topk`, fp32 keys) on the card at the search paths' query
counts, beside torch.topk and the bound.

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

The package is the one on the import path, so one checkout's script times
another checkout's K4: run it from that checkout's root with `PYTHONPATH=.`,
and compare two packages in one call, in turns (parent, change, change,
parent):

    PYTHONPATH=. python3 path/to/bench_k4.py [--keys 1048576] [--reps 10]

The first line names the imported package's file and the card (name and
power limit, as nvidia-smi gives them).
"""

from __future__ import annotations

import argparse
import json
import subprocess

BQS = (1, 16, 64, 256, 1024)
D, K = 768, 5
PEAK_BYTES, PEAK_BF16 = 3.35e12, 989e12


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--keys", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

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
    for case, q, keys in cases(args.keys, gen):
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


if __name__ == "__main__":
    main()
