"""Host cost of one attention call through the port's wrappers, on the card.

The attention forwards (`ops/attention.mha_packed`, `mha`, `mha_dropout`)
run as `torch.library` custom ops when autograd records, and call their
kernels directly under `no_grad` / `inference_mode`. This script times a
run of --iters back-to-back calls of each wrapper, in each grad mode, at
the shapes the flagship serves and trains with, and prints one JSON object
per row:

  case      the wrapper and its shape (B, N, D, heads, dtype)
  mode      "inference" (`torch.inference_mode`) or "grad" (inputs that
            require grad, grad enabled: the forward only, no backward)
  host_us   host clock per call over the run, a synchronize at its end
            only: the issue rate while the card keeps up
  card_us   CUDA events per call over the same run
A first row, `launch_floor`, times `ops.topk.tiny` (one ctypes launch and
nothing else) the same way, for scale.

Where host_us is above card_us the calls are host-bound and host_us is
what one more wrapper layer costs them. The package is the one on the
import path, so one checkout's script can time another checkout's
package: run it from that checkout's root with `PYTHONPATH=.`:

    PYTHONPATH=. python3 path/to/bench_attention_dispatch.py [--iters 400]

The first row names the imported package's file and the card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time


def _run(fn, iters: int):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / iters * 1e6
    return host, start.elapsed_time(end) / iters * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from bioscan_clip_tpu_torch.ops import attention, topk

    if not torch.cuda.is_available():
        raise SystemExit("bench_attention_dispatch: needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    print(json.dumps({"package": attention.__file__,
                      "device": torch.cuda.get_device_name(0)}))
    bf16 = torch.bfloat16
    # (name, wrapper, B, N, D, heads): ViT-B/16 images (packed qkv),
    # BarcodeBERT DNA (N = 133) and BERT-small text (N = 20, padding bias);
    # B = 1 for the host-bound end, the serving batch for the other
    cases = []
    for b in (1, 64):
        cases += [("mha_packed", b, 197, 768, 12),
                  ("mha", b, 133, 768, 12),
                  ("mha_dropout", b, 133, 768, 12),
                  ("mha", b, 20, 512, 8)]
    x = torch.ones(8, 128, device="cuda")
    host, card = _run(lambda: topk.tiny(x), args.iters)
    print(json.dumps({"case": "launch_floor (ops.topk.tiny (8, 128))",
                      "host_us": round(host, 2), "card_us": round(card, 2)}))
    for name, b, n, d, heads in cases:
        for mode in ("inference", "grad"):
            grad = mode == "grad"
            if name == "mha_packed":
                qkv = torch.randn(b, n, 3 * d, device="cuda", generator=gen
                                  ).to(bf16).requires_grad_(grad)

                def fn(qkv=qkv):
                    return attention.mha_packed(qkv, heads)
            else:
                q, k, v = (torch.randn(b, n, d, device="cuda", generator=gen
                                       ).to(bf16).requires_grad_(grad)
                           for _ in range(3))
                bias = torch.zeros(b, n, device="cuda")
                bias[:, n - n // 4:] = -1e9
                seeds = torch.arange(b, device="cuda")
                if name == "mha":
                    def fn(q=q, k=k, v=v, bias=bias):
                        return attention.mha(q, k, v, heads, bias=bias)
                else:
                    def fn(q=q, k=k, v=v, bias=bias, seeds=seeds):
                        return attention.mha(q, k, v, heads, bias=bias,
                                             dropout_rate=0.1,
                                             dropout_seed=seeds)
            ctx = (contextlib.nullcontext() if grad
                   else torch.inference_mode())
            with ctx:
                host, card = _run(fn, args.iters)
            print(json.dumps({
                "case": f"{name} B={b} N={n} D={d} heads={heads} bf16",
                "mode": mode, "host_us": round(host, 2),
                "card_us": round(card, 2), "iters": args.iters}))


if __name__ == "__main__":
    main()
