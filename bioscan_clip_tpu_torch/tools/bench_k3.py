"""K3 (`ops/attention.mha_bwd`, bf16, no mask, no key bias) on the card at
the training paths' shapes, beside SDPA's backward and the bound.

Shapes (B, N, D, heads, layout, dropout): ViT-B/16 at B = 400 (packed qkv,
N = 197, D = 768, h = 12), BarcodeBERT at B = 400 (split q/k/v, N = 133,
row-keyed dropout 0.1) and ViT-L/14 at B = 64 (packed, N = 257, D = 1024,
h = 16). Each time is CUDA events over --reps calls after warm-up (a call
is ~1 ms, far above its wrapper's host cost). One JSON object per shape:

  shape        [B, N, D, heads]
  packed, rate the layout and the dropout rate
  k3_ms        card ms per `mha_bwd` call
  sdpa_ms      card ms per backward of `scaled_dot_product_attention` on
               the same q, k, v, g (with `dropout_p` at the same rate: other
               random bits)
  bound_ms     max(bytes / 3.35 TB/s, operations / 989 TFLOP/s): q, k, v,
               g read once, dq, dk, dv written once; 10 B h N^2 hd
               operations (five products)
  max_rel_err  max over dq, dk, dv of |mha_bwd - mha_bwd_reference| /
               max(1, max |plain|)
  sm90         the package has K3's sm90 body and this call went through it

The package is the one on the import path, so one checkout's script times
another checkout's K3: run it from that checkout's root with
`PYTHONPATH=.`, and compare two packages in one call, in turns:

    PYTHONPATH=. python3 path/to/bench_k3.py [--reps 20]

The first line names the imported package's file and the card (name and
power limit, as nvidia-smi gives them).
"""

from __future__ import annotations

import argparse
import json
import subprocess

SHAPES = ((400, 197, 768, 12, True, 0.0), (400, 133, 768, 12, False, 0.1),
          (64, 257, 1024, 16, True, 0.0))
PEAK_BYTES, PEAK_BF16 = 3.35e12, 989e12


def events_ms(fn, reps: int = 20, warmup: int = 3) -> float:
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from bioscan_clip_tpu_torch.ops import attention

    if not torch.cuda.is_available():
        raise SystemExit("bench_k3: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({"package": attention.__file__, "card": card}),
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for b, n, d, heads, packed, rate in SHAPES:
        hd = d // heads

        def rand(width):
            return torch.randn(b, n, width, device="cuda",
                               generator=gen).to(torch.bfloat16)

        qkv = rand(3 * d) if packed else None
        q, k, v = ((qkv[..., i * d:(i + 1) * d] for i in range(3)) if packed
                   else (rand(d) for _ in range(3)))
        g = rand(d)
        seeds = torch.randint(0, 2**32, (b,), device="cuda", generator=gen,
                              dtype=torch.int64)
        kw = dict(dropout_rate=rate, dropout_seed=seeds) if rate else {}

        def k3():
            if packed:
                return attention.mha_bwd(None, None, None, g, heads,
                                         packed_qkv=qkv, **kw)
            return attention.mha_bwd(q, k, v, g, heads, **kw)

        before = getattr(attention.mha_bwd, "sm90_launches", None)
        out = k3()
        sm90 = (before is not None
                and attention.mha_bwd.sm90_launches == before + 1)
        out = out.split(d, dim=-1) if packed else out[:3]
        ref = attention.mha_bwd_reference(q, k, v, g, heads, **kw)[:3]
        err = max(((o.float() - r.float()).abs().max()
                   / max(1.0, r.float().abs().max().item())).item()
                  for o, r in zip(out, ref))
        del out, ref
        k3_ms = events_ms(k3, args.reps)

        def view(t):
            return t.detach().view(b, n, heads, hd).transpose(1, 2)

        lq, lk, lv = (view(t).requires_grad_() for t in (q, k, v))
        lo = F.scaled_dot_product_attention(lq, lk, lv, dropout_p=rate)
        lg = view(g)
        sdpa_ms = events_ms(lambda: torch.autograd.grad(
            lo, (lq, lk, lv), lg, retain_graph=True), args.reps)
        n_bytes = 7 * b * n * d * 2
        n_ops = 10 * b * heads * n * n * hd
        bound = 1e3 * max(n_bytes / PEAK_BYTES, n_ops / PEAK_BF16)
        print(json.dumps({"shape": [b, n, d, heads], "packed": packed,
                          "rate": rate, "k3_ms": k3_ms, "sdpa_ms": sdpa_ms,
                          "bound_ms": bound, "max_rel_err": err,
                          "sm90": sm90}), flush=True)
        del qkv, q, k, v, g, lq, lk, lv, lo, lg
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
