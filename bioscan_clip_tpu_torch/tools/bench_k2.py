"""K2 and K2d (`ops/attention.mha`, `mha_dropout`, bf16, split q/k/v) on
the card at the BERT towers' shapes, on each forward body, beside SDPA and
the bound.

Shapes (name, B, N, D, heads, key bias, dropout rate): BarcodeBERT's K2 at
eval's batches of 24 and at B = 256, BERT-small's K2 at B = 256 with its
padding bias (and at N = 16, the body's 16-key instantiation that
shorter label strings take); K2d at the training batch of 400 for both
towers (row-keyed seeds, rate 0.1). Each call is captured --reps times into one CUDA graph
and the replay timed with CUDA events, so the time is the card's and not
the wrapper's host cost. One JSON object per shape:

  shape        [B, N, D, heads]
  k2           "mha" or "mha_dropout"; bias: the (B, N) padding bias
  ms           card ms per call on the body the plan chooses
  sm90_ms      card ms on the Hopper body (`csrc/mha_fwd_sm90.cu`) under
               `sm90_fwd_plan`, also where the plan chooses another body
               (BarcodeBERT's K2d at B = 400: the mma.sync body); null
               where the package has no such body
  old_ms       card ms on the bodies of `csrc/mha_fwd.cu` (`_launch_fwd`:
               the mma.sync body above N = 32, FFMA at N <= 32)
  sdpa_ms      `scaled_dot_product_attention` on the heads-major views,
               with the bias as a float mask and `dropout_p` (other random
               bits)
  bound_ms     max(bytes / 3.35 TB/s, operations / 989 TFLOP/s): q, k, v
               (and the bias, the (B,) seeds) read once, o written once;
               4 B h N^2 hd operations
  max_abs_err  |mha - mha_reference| (the plain version), and per body
               (`sm90_err`, `old_err`)
  body         the body the plan chooses (`plan_split_fwd`), or null

The package is the one on the import path, so one checkout's script times
another checkout's K2: run it from that checkout's root with
`PYTHONPATH=.`, and compare two packages in one call, in turns:

    PYTHONPATH=. python3 path/to/bench_k2.py [--reps 20]

The first line names the imported package's file and the card (name and
power limit, as nvidia-smi gives them).
"""

from __future__ import annotations

import argparse
import json
import subprocess

# (name, B, N, D, heads, bias, rate)
SHAPES = (("barcodebert", 24, 133, 768, 12, False, 0.0),
          ("barcodebert", 256, 133, 768, 12, False, 0.0),
          ("bert-small", 256, 20, 512, 8, True, 0.0),
          ("bert-small", 256, 16, 512, 8, True, 0.0),
          ("barcodebert", 400, 133, 768, 12, False, 0.1),
          ("bert-small", 400, 20, 512, 8, True, 0.1),
          ("bert-small", 400, 16, 512, 8, True, 0.1))
PEAK_BYTES, PEAK_BF16 = 3.35e12, 989e12


def bodies(attention, q, k, v, heads, bias, rate, seeds):
    """{body: a call of it}: the plan's (`mha`), the Hopper body under a
    forced plan (where the package has one) and csrc/mha_fwd.cu's."""
    import torch

    b, n, d = q.shape
    hd = d // heads
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    outs = {"plan": lambda: attention.mha(q, k, v, heads, bias=bias,
                                          dropout_rate=rate,
                                          dropout_seed=seeds)}
    if hasattr(attention, "sm90_fwd_plan"):
        plan = attention.sm90_fwd_plan(b, n, heads, bias is not None)
        o_sm90 = torch.empty_like(q)

        def sm90():
            attention._launch_sm90(
                ptrs, o_sm90, d, plan, hd ** -0.5, bias,
                attention._drop_args(rate, seeds, b, q.device))
            return o_sm90

        outs["sm90"] = sm90
    o_old = torch.empty_like(q)

    def old():
        attention._launch_fwd(ptrs, o_old, b, n, heads, hd, d, hd ** -0.5,
                              q.dtype, bias, rate, seeds)
        return o_old

    outs["old"] = old
    return outs


# the row's keys of each body's time and error
KEYS = {"plan": ("ms", "max_abs_err"), "sm90": ("sm90_ms", "sm90_err"),
        "old": ("old_ms", "old_err")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from bioscan_clip_tpu_torch.ops import attention
    from bioscan_clip_tpu_torch.tools.bench_k1 import graph_ms

    if not torch.cuda.is_available():
        raise SystemExit("bench_k2: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({"package": attention.__file__, "card": card}),
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for name, b, n, d, heads, with_bias, rate in SHAPES:
        hd = d // heads
        q, k, v = (torch.randn(b, n, d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
        bias = None
        if with_bias:
            lengths = torch.randint(5, n + 1, (b,), device="cuda",
                                    generator=gen)
            keep = torch.arange(n, device="cuda")[None, :] < lengths[:, None]
            bias = torch.where(keep, 0.0, -1e9).float()
        seeds = (torch.randint(0, 2**32, (b,), device="cuda", generator=gen,
                               dtype=torch.int64) if rate > 0 else None)
        mask = None if bias is None else bias[:, None, None, :].to(q.dtype)
        views = [t.view(b, n, heads, hd).transpose(1, 2) for t in (q, k, v)]
        row = {"shape": [b, n, d, heads], "tower": name,
               "k2": "mha_dropout" if rate > 0 else "mha",
               "bias": with_bias, "rate": rate}
        with torch.inference_mode():
            ref = attention.mha_reference(q, k, v, heads, bias=bias,
                                          dropout_rate=rate,
                                          dropout_seed=seeds)
            calls = bodies(attention, q, k, v, heads, bias, rate, seeds)
            row["sm90_ms"] = row["sm90_err"] = None
            for key, fn in calls.items():
                ms_key, err_key = KEYS[key]
                row[err_key] = (fn().float() - ref.float()).abs().max().item()
                row[ms_key] = graph_ms(fn, args.reps)
            row["sdpa_ms"] = graph_ms(
                lambda: F.scaled_dot_product_attention(
                    *views, attn_mask=mask, dropout_p=rate), args.reps)
        plan = getattr(attention, "plan_split_fwd", None)
        row["body"] = (plan(b, n, heads, hd, q.dtype, bias is not None,
                            rate > 0).body if plan else None)
        n_bytes = (4 * b * n * d * 2 + (0 if bias is None else b * n * 4)
                   + (0 if seeds is None else b * 4))
        n_ops = 4 * b * heads * n * n * hd
        row["bound_ms"] = 1e3 * max(n_bytes / PEAK_BYTES, n_ops / PEAK_BF16)
        print(json.dumps(row), flush=True)
        del q, k, v, ref, calls
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
