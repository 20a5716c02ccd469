"""K3 and K3m (`ops/attention.mha_bwd`, bf16, no key bias) on the card at
the training paths' shapes, beside SDPA's backward and the bound.

K3's shapes (B, N, D, heads, layout, dropout): ViT-B/16 at B = 400 (packed
qkv, N = 197, D = 768, h = 12), BarcodeBERT at B = 400 (split q/k/v,
N = 133, row-keyed dropout 0.1) and ViT-L/14 at B = 64 (packed, N = 257,
D = 1024, h = 16), each timed by CUDA events over --reps calls after
warm-up (a call is ~1 ms, far above its wrapper's host cost). K3m's
(packed, OpenCLIP's causal (N, N) mask, D = 768, h = 12): B = 64 at the
CLIP context N = 77 and the training path's B = 10 at N = 20, each timed
as replays of a CUDA graph of --reps calls (the training step replays it
so; at B = 10 a call is shorter than its wrapper's host cost), SDPA's
backward with the float mask too. One JSON object per shape:

  shape        [B, N, D, heads]
  packed, rate the layout and the dropout rate
  causal       K3m under the causal mask
  k3_ms        card ms per `mha_bwd` call
  sdpa_ms      card ms per backward of `scaled_dot_product_attention` on
               the same q, k, v, g (with `dropout_p` at the same rate: other
               random bits)
  bound_ms     max(bytes / 3.35 TB/s, operations / 989 TFLOP/s): q, k, v,
               g (and the mask) read once, dq, dk, dv written once;
               10 B h N^2 hd operations (five products)
  max_rel_err  max over dq, dk, dv of |mha_bwd - mha_bwd_reference| /
               max(1, max |plain|)
  sm90         the package has K3's sm90 body (K3m's, with the mask) and
               this call went through it

The package is the one on the import path, so one checkout's script times
another checkout's K3: run it from that checkout's root with
`PYTHONPATH=.`, and compare two packages in one call, in turns:

    PYTHONPATH=. python3 path/to/bench_k3.py [--reps 20]

The first line names the imported package's file and the card (name and
power limit, as nvidia-smi gives them). `--sass` adds one row per K3
instantiation without a mask or read-out (pass A at 144, 208 and 272 key
rows and pass B, each with and without dropout) read from the package's
built library with cuobjdump: `registers`, the SASS `instructions` and
`sha1`, a hash of their text in order (addresses and encodings left out),
so that two checkouts' K3 code can be compared.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import subprocess

SHAPES = ((400, 197, 768, 12, True, 0.0), (400, 133, 768, 12, False, 0.1),
          (64, 257, 1024, 16, True, 0.0))
MASK_SHAPES = ((64, 77, 768, 12), (10, 20, 768, 12))  # K3m: B, N, D, heads
# K3's instantiations without a mask or read-out, mangled: pass A <KT, DROP,
# READOUT> or <KT, DROP, MASK, READOUT>, pass B <DROP, READOUT> or <DROP,
# MASK, READOUT>, all false but DROP
K3_SYMBOL = re.compile(
    r"mha_bwd_sm90_pass_(a|b)I(?:Li(\d+)E)?Lb(\d)E(?:Lb0E)?Lb0EE")
SASS_KT = (9, 13, 17)  # pass A at 144, 208 and 272 key rows
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


def grad_graph_ms(forward, inputs, grad, reps: int = 20) -> float:
    """Card ms per backward of `forward(*inputs)` against `grad`, as
    replays of a CUDA graph of `reps` backwards. The forward runs once,
    eagerly, on the capturing stream, on fresh leaves of `inputs`: autograd
    runs a backward, and a leaf's gradient accumulator, on the stream of
    their first forward use."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    inputs = tuple(x.detach().requires_grad_() for x in inputs)
    with torch.cuda.stream(stream):
        out = forward(*inputs)
        torch.autograd.grad(out, inputs, grad, retain_graph=True)
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            torch.autograd.grad(out, inputs, grad, retain_graph=True)
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(b, n, d, heads, extra_bytes=0):
    """K3's bound in ms: 7 B N D bf16 (+ `extra_bytes`) over 3.35 TB/s,
    10 B h N^2 hd operations over 989 TFLOP/s, the larger."""
    n_ops = 10 * b * heads * n * n * (d // heads)
    return 1e3 * max((7 * b * n * d * 2 + extra_bytes) / PEAK_BYTES,
                     n_ops / PEAK_BF16)


def _rel_err(out, ref):
    return max(((o.float() - r.float()).abs().max()
                / max(1.0, r.float().abs().max().item())).item()
               for o, r in zip(out, ref))


def _k3m_row(gen, b, n, d, heads, reps):
    """K3m packed under the causal mask, timed as graph replays."""
    import torch
    import torch.nn.functional as F

    from bioscan_clip_tpu_torch.models.openclip import causal_mask
    from bioscan_clip_tpu_torch.ops import attention
    from bioscan_clip_tpu_torch.tools.bench_k1 import graph_ms

    qkv = torch.randn(b, n, 3 * d, device="cuda",
                      generator=gen).to(torch.bfloat16)
    g = torch.randn(b, n, d, device="cuda", generator=gen).to(torch.bfloat16)
    mask = causal_mask(n, "cuda")

    def k3m():
        return attention.mha_bwd(None, None, None, g, heads, packed_qkv=qkv,
                                 mask=mask)

    before = getattr(attention.mha_bwd, "mask_sm90_launches", None)
    out = k3m().split(d, dim=-1)
    sm90 = (before is not None
            and attention.mha_bwd.mask_sm90_launches == before + 1)
    q, k, v = qkv.split(d, dim=-1)
    err = _rel_err(out, attention.mha_bwd_reference(q, k, v, g, heads,
                                                    mask=mask)[:3])
    del out

    def view(t):
        return t.detach().view(b, n, heads, d // heads).transpose(1, 2)

    lqkv = tuple(view(t).requires_grad_() for t in (q, k, v))
    sdpa_ms = grad_graph_ms(
        lambda *x: F.scaled_dot_product_attention(
            *x, attn_mask=mask.to(torch.bfloat16)), lqkv, view(g), reps)
    return {"shape": [b, n, d, heads], "packed": True, "rate": 0.0,
            "causal": True, "k3_ms": graph_ms(k3m, reps),
            "sdpa_ms": sdpa_ms, "bound_ms": bound(b, n, d, heads, n * n * 4),
            "max_rel_err": err, "sm90": sm90}


def sass_rows(lib_path):
    """{"sass", "registers", "instructions", "sha1"} of each K3
    instantiation of `K3_SYMBOL` (pass A at `SASS_KT`) in the library at
    `lib_path`."""
    from bioscan_clip_tpu_torch.tools.bench_k1 import _cuobjdump

    def name(m):
        if not m or (m[1] == "a" and int(m[2]) not in SASS_KT):
            return None
        rows = f" at {16 * int(m[2])} key rows" if m[1] == "a" else ""
        return (f"K3 pass {m[1].upper()}{rows}"
                f"{' dropout' if m[3] == '1' else ''}")

    rows, fn = {}, None
    for ln in _cuobjdump("-res-usage", lib_path).splitlines():
        if "Function" in ln:
            fn = name(K3_SYMBOL.search(ln))
        elif fn and "REG:" in ln:
            rows[fn] = {"sass": fn, "registers": int(re.search(
                r"REG:(\d+)", ln)[1]), "instructions": 0,
                "sha1": hashlib.sha1()}
            fn = None
    for ln in _cuobjdump("-sass", lib_path).splitlines():
        if "Function :" in ln:
            fn = name(K3_SYMBOL.search(ln))
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z]\S*)",
                       ln)
        if fn in rows and ins:
            rows[fn]["instructions"] += 1
            rows[fn]["sha1"].update(
                ln.split("*/", 1)[1].split(";")[0].strip().encode() + b"\n")
    return [dict(r, sha1=r["sha1"].hexdigest()[:16])
            for _, r in sorted(rows.items())]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sass", action="store_true",
                    help="also K3's registers and SASS from cuobjdump")
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
        err = _rel_err(out, attention.mha_bwd_reference(q, k, v, g, heads,
                                                        **kw)[:3])
        del out
        k3_ms = events_ms(k3, args.reps)

        def view(t):
            return t.detach().view(b, n, heads, hd).transpose(1, 2)

        lq, lk, lv = (view(t).requires_grad_() for t in (q, k, v))
        lo = F.scaled_dot_product_attention(lq, lk, lv, dropout_p=rate)
        lg = view(g)
        sdpa_ms = events_ms(lambda: torch.autograd.grad(
            lo, (lq, lk, lv), lg, retain_graph=True), args.reps)
        print(json.dumps({"shape": [b, n, d, heads], "packed": packed,
                          "rate": rate, "causal": False, "k3_ms": k3_ms,
                          "sdpa_ms": sdpa_ms,
                          "bound_ms": bound(b, n, d, heads),
                          "max_rel_err": err, "sm90": sm90}), flush=True)
        del qkv, q, k, v, g, lq, lk, lv, lo, lg
        torch.cuda.empty_cache()
    for b, n, d, heads in MASK_SHAPES:
        print(json.dumps(_k3m_row(gen, b, n, d, heads, args.reps)),
              flush=True)
    if args.sass:
        for row in sass_rows(attention._bwd_sm90_kernel()[0]._name):
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
