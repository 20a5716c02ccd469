"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py                    # every phase, as the check runs it
    python3 chip_smoke.py --phases kernels   # device, build and kernel phases

Phases, in order; any failure exits non-zero:
  device    the card's name and power limit (nvidia-smi)
  build     nvcc builds every kernel under bioscan_clip_tpu_torch/csrc
  kernels   each kernel against its plain PyTorch version at the shapes of
            its path (fp32 and bf16 for attention, the masked K1m and its
            backward K3m at N = 77 and 20, K1 and K3 at ViT-L/14; int8 top-k
            bit for bit at 1,048,576 and 5,000,000 keys; the matmul-only
            control K6 and K7), with the kernel's, the plain version's and
            one library call's time
  serving   the flagship model at full width (random seeded weights, bf16)
            behind cli/serve.build_service over 1,048,576 resident keys:
            handle_request for dna, text, embedding and embed_images, and
            HTTP /search and /embed on localhost; then the same keys as
            int8 codes under each rescore mode; K1, K2, K4 and K5 must have
            launched
  eval      the evaluation job at full width: in-memory batches of 24 (all
            keys 1,920, seen 960, unseen 960 records) through
            train.loop.extract_features per batch and grouped, then the
            5 x 6 retrieval sweep (retrieval.report) in high and int8
            precision; the card's sweep equals the CPU's on the same
            embeddings; K1, K2, K4 and K5 launched and no plain version
  training  the flagship LoRA contrastive step (train.loop.make_train_step
            driven by train_epoch) at full width, B=400, bf16, frozen
            weights in bf16, dropout 0.1: 6 steps over one synthetic batch;
            finite falling loss, frozen weights unchanged, adapters and
            heads moved, K1, K2d and K3 launched, K2 and no plain version
  openclip  the OpenCLIP ablation (ViT-L/14 + OpenCLIP text + BarcodeBERT)
            at full width, same service, keys and request kinds (text as
            WordPiece ids at N = 20), plus encode_language at context 77;
            K1m, K1, K2 and K4 must have launched, no plain version
  openclip_training
            the OpenCLIP ablation's LoRA step (make_train_step with
            openclip_norm, driven by train_epoch) at full width, B=10, bf16,
            frozen weights in bf16: 6 steps, a checkpoint saved after step 3
            (train.checkpoint) and restored into a fresh state that runs
            steps 4-6 again, equal to the uninterrupted run; K1, K1m, K2d,
            K3 and K3m launched, K2 and no plain version
  probe     the port's top-k decomposition probe at Bq = 256 (K7, K6, K4,
            K5 rows, bioscan_clip_tpu_torch/tools/bench_topk_variants.py)
  parity    the fp32 port on the card against the same model on the CPU:
            embeddings, then one train step (loss, gradients, AdamW); then
            the OpenCLIP towers at full width and 2 layers each, their
            embeddings and one train step (K3m on the card)

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Needs CUDA: without it the script exits 1
and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense): the bound of each kernel is the larger
# of its bytes over the memory rate and its operations over the peak for
# their type.
PEAK = {"bytes": 3.35e12, "bfloat16": 989e12, "float32": 67e12,
        "int8": 1979e12}
ALL_PHASES = ("device", "build", "kernels", "serving", "openclip", "eval",
              "training", "openclip_training", "probe", "parity")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float, dtype_name: str):
    t_bytes = n_bytes / PEAK["bytes"]
    t_ops = n_ops / PEAK[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_device():
    import torch

    line = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(line)
    log(f"phase device ok: {torch.cuda.get_device_name(0)}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return line


def phase_build():
    from bioscan_clip_tpu_torch.ops import _build

    secs = _build.build()
    for name, text in sorted(_build.build_logs.items()):
        fn = spills = ""
        for ln in text.splitlines():
            # ptxas -v: "Function properties for <mangled name>", then its
            # stack/spill line, then its "Used N registers" line
            if "Function properties for" in ln:
                fn = ln.rsplit(" ", 1)[-1]
            elif "spill" in ln:
                spills = ln.strip()
            elif "registers" in ln or "error" in ln:
                log(f"  nvcc {name} {fn}: {ln.split(':', 1)[-1].strip()}; "
                    f"{spills}")
    log(f"phase build ok: {_build.sources()} in {secs:.1f} s")


def _attention_case(name, b, n, d, heads, dtype, with_bias, gen, packed,
                    causal=False):
    """K1/K2 (K1m with `causal`: OpenCLIP's (N, N) -1e9 mask) against the
    plain version, timed beside SDPA with the same bias or float mask."""
    import torch
    import torch.nn.functional as F

    from bioscan_clip_tpu_torch.models.openclip import causal_mask
    from bioscan_clip_tpu_torch.ops import attention

    dev = torch.device("cuda")
    hd = d // heads
    score_mask = causal_mask(n, dev) if causal else None
    if packed:
        qkv = torch.randn(b, n, 3 * d, device=dev, generator=gen).to(dtype)
        q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]

        def kernel():
            return attention.mha_packed(qkv, heads, mask=score_mask)
    else:
        q, k, v = (torch.randn(b, n, d, device=dev, generator=gen).to(dtype)
                   for _ in range(3))

    bias = None
    if with_bias:
        lengths = torch.randint(5, n + 1, (b,), device=dev, generator=gen)
        keep = torch.arange(n, device=dev)[None, :] < lengths[:, None]
        bias = torch.where(keep, 0.0, -1e9).float()
    if not packed:
        def kernel():
            return attention.mha(q, k, v, heads, bias=bias)

    def plain():
        return attention.mha_reference(q, k, v, heads, bias=bias,
                                       mask=score_mask)

    def view(t):
        return t.view(b, n, heads, hd).transpose(1, 2)

    mask = None if bias is None else bias[:, None, None, :].to(dtype)
    if causal:
        mask = score_mask.to(dtype)

    def library():
        return F.scaled_dot_product_attention(view(q), view(k), view(v),
                                              attn_mask=mask)

    out = kernel()
    torch.cuda.synchronize()
    ref = plain()
    err = (out.float() - ref.float()).abs().max().item()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    if not err <= tol:
        raise AssertionError(f"{name}: max |kernel - plain| {err} > {tol}")
    es = torch.tensor([], dtype=dtype).element_size()
    n_bytes = (4 * b * n * d * es + (0 if bias is None else b * n * 4)
               + (n * n * 4 if causal else 0))
    n_ops = 4 * b * heads * n * n * hd
    dname = str(dtype).split(".")[-1]
    bms, by = bound_ms(n_bytes, n_ops, dname)
    row = {
        "ms": time_ms(kernel), "plain_ms": time_ms(plain, reps=3),
        "library_ms": time_ms(library), "bound_ms": bms, "bound_by": by,
        "max_abs_err": err,
    }
    log(f"  {name} {dname} B={b} N={n} D={d} h={heads}"
        f"{' bias' if with_bias else ''}{' causal mask' if causal else ''}: "
        f"err {err:.3g} (tol {tol:g}), kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, bound "
        f"{bms:.4f} ms ({by})")
    return row


def _topk_case(gen, bq=256, n=1 << 20, d=768, k=5):
    import torch

    from bioscan_clip_tpu_torch.ops import topk as topk_mod

    dev = torch.device("cuda")
    keys = torch.randn(n, d, device=dev, generator=gen)
    keys /= keys.norm(dim=1, keepdim=True)
    q = torch.randn(bq, d, device=dev, generator=gen)
    q /= q.norm(dim=1, keepdim=True)
    vals, idx = topk_mod.topk(q, keys, n, k)
    torch.cuda.synchronize()
    rv, ri = topk_mod.topk_reference(q, keys, n, k)
    err = (vals - rv).abs().max().item()
    if not err <= 1e-5:
        raise AssertionError(f"topk: max |kernel - plain| {err} > 1e-5")
    # index sets equal except where the differing keys score within 1e-5 of
    # the k-th value (a near-tie that summation order may break either way)
    for r in range(bq):
        a, bset = set(idx[r].tolist()), set(ri[r].tolist())
        if a != bset:
            diff = sorted(a ^ bset)
            sc = q[r].double() @ keys[diff].double().T
            if (sc - rv[r, -1].double()).abs().max().item() > 1e-5:
                raise AssertionError(f"topk row {r}: {sorted(a)} vs "
                                     f"{sorted(bset)}")

    def kernel():
        return topk_mod.topk(q, keys, n, k)

    def plain():
        return topk_mod.topk_reference(q, keys, n, k)

    def library():
        return torch.topk(q @ keys.T, k, dim=1)

    n_bytes = n * d * 4 + bq * d * 4 + bq * k * 8
    bms, by = bound_ms(n_bytes, 2 * bq * n * d, "float32")
    row = {
        "ms": time_ms(kernel, reps=5, warmup=1),
        "plain_ms": time_ms(plain, reps=2, warmup=1),
        "library_ms": time_ms(library, reps=5, warmup=1),
        "bound_ms": bms, "bound_by": by, "max_abs_err": err,
    }
    log(f"  topk fp32 Bq={bq} N={n} D={d} k={k}: err {err:.3g} (tol 1e-5), "
        f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"torch.topk(q@k.T) {row['library_ms']:.4f} ms, "
        f"bound {bms:.4f} ms ({by})")
    for few in (1, 64):  # the serving sizes below the FFMA-bound regime
        qf = q[:few].contiguous()
        fms = time_ms(lambda: topk_mod.topk(qf, keys, n, k), reps=5)
        fb, fby = bound_ms(n * d * 4 + few * d * 4 + few * k * 8,
                           2 * few * n * d, "float32")
        log(f"  topk fp32 Bq={few}: kernel {fms:.4f} ms, bound {fb:.4f} ms "
            f"({fby})")
    return keys, row


def _topk_i8_case(gen, n, bqs, d=768, k=21, codes_on_card=False):
    """K5 against its plain version, values and indices bit for bit, at
    each query count of `bqs`; timed beside torch._int_mm + the two scales
    + torch.topk (Bq padded to 32 rows, as _int_mm needs more than 16).
    Returns the row of the first query count."""
    import torch

    from bioscan_clip_tpu_torch.ops import topk as topk_mod

    quantize = topk_mod.quantize_rows_i8_torch
    dev = torch.device("cuda")
    if codes_on_card:  # the BIOSCAN-5M key set's size: 3.8 GB of codes
        kc = torch.randint(-127, 128, (n, d), device=dev, generator=gen,
                           dtype=torch.int8)
        ks = 1e-3 + 1e-3 * torch.rand(n, device=dev, generator=gen)
    else:
        x = torch.randn(n, d, device=dev, generator=gen)
        kc, ks = quantize(x / x.norm(dim=1, keepdim=True))
        del x
    q = torch.randn(max(bqs), d, device=dev, generator=gen)
    qc_all, qs_all = quantize(q / q.norm(dim=1, keepdim=True))
    first = None
    for bq in bqs:
        qc, qs = qc_all[:bq].contiguous(), qs_all[:bq].contiguous()
        v, i = topk_mod.topk_i8(qc, qs, kc, ks, n, k)
        torch.cuda.synchronize()
        rv, ri = topk_mod.topk_i8_reference(qc, qs, kc, ks, n, k)
        if not (torch.equal(v, rv) and torch.equal(i, ri)):
            raise AssertionError(f"topk_i8 N={n} Bq={bq}: kernel != plain "
                                 f"(max |dv| {(v - rv).abs().max().item()})")
        qp = torch.zeros(max(32, -(-bq // 8) * 8), d, device=dev,
                         dtype=torch.int8)
        qp[:bq] = qc

        def library():
            s = torch._int_mm(qp, kc.T)[:bq].to(torch.float32)
            return torch.topk((s * qs[:, None]) * ks[None, :], k, dim=1)

        lib_same = torch.equal(library().values, v)
        n_bytes = n * d + 4 * n + bq * d + 4 * bq + bq * k * 8
        bms, by = bound_ms(n_bytes, 2 * bq * n * d, "int8")
        row = {
            "ms": time_ms(lambda: topk_mod.topk_i8(qc, qs, kc, ks, n, k),
                          reps=5, warmup=1),
            "plain_ms": time_ms(lambda: topk_mod.topk_i8_reference(
                qc, qs, kc, ks, n, k), reps=2, warmup=1),
            "library_ms": time_ms(library, reps=5, warmup=1),
            "bound_ms": bms, "bound_by": by, "max_abs_err": 0.0,
        }
        log(f"  topk_i8 Bq={bq} N={n} D={d} k={k}: bit-equal to plain, "
            f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"_int_mm+topk {row['library_ms']:.4f} ms (values equal: "
            f"{lib_same}), bound {bms:.4f} ms ({by})")
        first = first or row
    del kc, ks
    torch.cuda.empty_cache()
    return first


def _mm_only_case(gen, keys, bqs=(1, 256)):
    """K6 against its plain version at each query count over `keys`: fp32
    "high" and "default" within 1e-5 (unit vectors, 768 products summed in
    another order), int8 bit for bit; timed beside one library call: (q @
    k.T).amax in fp32 ("high"), in bf16 ("default", operands cast before
    the timing), torch._int_mm + amax (int8, Bq padded to 32 rows). Returns
    the rows of fp32 "high" at the largest Bq."""
    import torch

    from bioscan_clip_tpu_torch.ops import topk as topk_mod

    n, d = keys.shape
    dev = keys.device
    kc, _ = topk_mod.quantize_rows_i8_torch(keys)
    k16 = keys.to(torch.bfloat16)
    q_all = torch.randn(max(bqs), d, device=dev, generator=gen)
    q_all /= q_all.norm(dim=1, keepdim=True)
    qc_all, _ = topk_mod.quantize_rows_i8_torch(q_all)
    rows = {}
    for bq in bqs:
        q, qc = q_all[:bq].contiguous(), qc_all[:bq].contiguous()
        qp = torch.zeros(max(32, -(-bq // 8) * 8), d, device=dev,
                         dtype=torch.int8)
        qp[:bq] = qc
        q16 = q.to(torch.bfloat16)
        cases = {
            "high": (q, keys, dict(), "float32",
                     lambda: (q @ keys.T).amax(dim=1)),
            "default": (q, keys, dict(precision="default"), "bfloat16",
                        lambda: (q16 @ k16.T).amax(dim=1)),
            "int8": (qc, kc, dict(int8=True), "int8",
                     lambda: torch._int_mm(qp, kc.T)[:bq].amax(dim=1)),
        }
        for mode, (qq, kk, kw, dname, library) in cases.items():
            out = topk_mod.mm_only(qq, kk, n, **kw)
            torch.cuda.synchronize()
            ref = topk_mod.mm_only_reference(qq, kk, n, **kw)
            err = (out - ref).abs().max().item()
            tol = 0.0 if mode == "int8" else 1e-5
            if not err <= tol:
                raise AssertionError(f"mm_only {mode} Bq={bq}: max |kernel "
                                     f"- plain| {err} > {tol}")
            lib_err = (library().float() - ref[:, 0]).abs().max().item()
            n_bytes = (n * d + bq * d) * qq.element_size() + bq * 128 * 4
            bms, by = bound_ms(n_bytes, 2 * bq * n * d, dname)
            row = {
                "ms": time_ms(lambda: topk_mod.mm_only(qq, kk, n, **kw),
                              reps=5, warmup=1),
                "plain_ms": time_ms(lambda: topk_mod.mm_only_reference(
                    qq, kk, n, **kw), reps=2, warmup=1),
                "library_ms": time_ms(library, reps=5, warmup=1),
                "bound_ms": bms, "bound_by": by, "max_abs_err": err,
            }
            rows[(mode, bq)] = row
            log(f"  mm_only {mode} Bq={bq} N={n} D={d}: err {err:.3g} (tol "
                f"{tol:g}), kernel {row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} "
                f"ms (|library - plain| {lib_err:.3g}), bound {bms:.4f} ms "
                f"({by})")
    del kc, k16
    torch.cuda.empty_cache()
    return rows[("high", max(bqs))]


def _tiny_case(gen):
    """K7 against x + 1, exact; its time per launch in a pipelined run
    (CUDA events) beside the plain version's and one `torch.add`'s, and one
    call plus a synchronize on the host clock."""
    import torch

    from bioscan_clip_tpu_torch.ops import topk as topk_mod

    x = torch.randn(8, 128, device="cuda", generator=gen)
    out = topk_mod.tiny(x)
    torch.cuda.synchronize()
    err = (out - topk_mod.tiny_reference(x)).abs().max().item()
    if not err == 0.0:
        raise AssertionError(f"tiny: max |kernel - (x + 1)| {err} > 0")
    host = []
    for _ in range(50):
        t = time.perf_counter()
        topk_mod.tiny(x)
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t))
    bms, by = bound_ms(2 * x.numel() * 4, x.numel(), "float32")
    row = {"ms": time_ms(lambda: topk_mod.tiny(x), reps=100, warmup=10),
           "plain_ms": time_ms(lambda: topk_mod.tiny_reference(x), reps=100,
                               warmup=10),
           "library_ms": time_ms(lambda: torch.add(x, 1.0), reps=100,
                                 warmup=10),
           "bound_ms": bms, "bound_by": by, "max_abs_err": err}
    log(f"  tiny (8, 128): exact, kernel {row['ms']:.4f} ms per launch "
        f"pipelined, {sorted(host)[len(host) // 2]:.4f} ms median per call "
        f"+ synchronize (host clock), plain {row['plain_ms']:.4f} ms, "
        f"torch.add {row['library_ms']:.4f} ms, bound {bms:.2e} ms ({by})")
    return row


def _rel_err(out, ref):
    """max |out - ref| over max(1, max |ref|), in fp32."""
    err = (out.float() - ref.float()).abs().max().item()
    return err / max(1.0, ref.float().abs().max().item())


def _seeds(b, gen):
    import torch

    return torch.randint(0, 2**32, (b,), device="cuda", generator=gen,
                         dtype=torch.int64)


def _padding_bias(b, n, gen):
    import torch

    lengths = torch.randint(5, n + 1, (b,), device="cuda", generator=gen)
    keep = torch.arange(n, device="cuda")[None, :] < lengths[:, None]
    return torch.where(keep, 0.0, -1e9).float()


def _dropout_case(b, n, d, heads, dtype, with_bias, gen, rate=0.1):
    """K2d against its plain version (the same hash): row-keyed (B,) seeds,
    and one scalar seed for the batch-index keying."""
    import torch
    import torch.nn.functional as F

    from bioscan_clip_tpu_torch.ops import attention

    hd = d // heads
    q, k, v = (torch.randn(b, n, d, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    bias = _padding_bias(b, n, gen) if with_bias else None
    seeds = _seeds(b, gen)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    err = 0.0
    for seed in (seeds, 0x9E3779B9):
        out = attention.mha_dropout(q, k, v, heads, seed, rate, bias=bias)
        torch.cuda.synchronize()
        ref = attention.mha_reference(q, k, v, heads, bias=bias,
                                      dropout_rate=rate, dropout_seed=seed)
        err = max(err, (out.float() - ref.float()).abs().max().item())
    if not err <= tol:
        raise AssertionError(f"mha_dropout: max |kernel - plain| {err} > "
                             f"{tol}")

    def view(t):
        return t.view(b, n, heads, hd).transpose(1, 2)

    mask = None if bias is None else bias[:, None, None, :].to(dtype)
    es = torch.tensor([], dtype=dtype).element_size()
    n_bytes = 4 * b * n * d * es + b * 4 + (0 if bias is None else b * n * 4)
    dname = str(dtype).split(".")[-1]
    bms, by = bound_ms(n_bytes, 4 * b * heads * n * n * hd, dname)
    row = {
        "ms": time_ms(lambda: attention.mha_dropout(q, k, v, heads, seeds,
                                                    rate, bias=bias)),
        "plain_ms": time_ms(lambda: attention.mha_reference(
            q, k, v, heads, bias=bias, dropout_rate=rate,
            dropout_seed=seeds), reps=3),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            view(q), view(k), view(v), attn_mask=mask, dropout_p=rate)),
        "bound_ms": bms, "bound_by": by, "max_abs_err": err,
    }
    log(f"  mha_dropout {dname} B={b} N={n} D={d} h={heads} rate={rate}"
        f"{' bias' if with_bias else ''}: err {err:.3g} (tol {tol:g}), "
        f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"sdpa(dropout_p) {row['library_ms']:.4f} ms, bound {bms:.4f} ms "
        f"({by})")
    return row


def _bwd_case(name, b, n, d, heads, dtype, gen, packed=False,
              with_bias=False, rate=0.0, causal=False):
    """K3 (K3m with `causal`: OpenCLIP's (N, N) -1e9 mask, packed) against
    its plain version: every gradient within tol * max(1, max |plain|);
    timed beside SDPA's backward with the same bias or float mask."""
    import torch
    import torch.nn.functional as F

    from bioscan_clip_tpu_torch.models.openclip import causal_mask
    from bioscan_clip_tpu_torch.ops import attention

    hd = d // heads
    if packed:
        qkv = torch.randn(b, n, 3 * d, device="cuda", generator=gen).to(dtype)
        q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
    else:
        q, k, v = (torch.randn(b, n, d, device="cuda",
                               generator=gen).to(dtype) for _ in range(3))
    g = torch.randn(b, n, d, device="cuda", generator=gen).to(dtype)
    bias = _padding_bias(b, n, gen) if with_bias else None
    seeds = _seeds(b, gen) if rate > 0 else None
    score_mask = causal_mask(n, "cuda") if causal else None
    kw = dict(bias=bias, dropout_rate=rate, dropout_seed=seeds,
              mask=score_mask)

    def kernel():
        if packed:
            return attention.mha_bwd(None, None, None, g, heads,
                                     packed_qkv=qkv, mask=score_mask)
        return attention.mha_bwd(q, k, v, g, heads, need_dbias=with_bias,
                                 **kw)

    def plain():
        return attention.mha_bwd_reference(q, k, v, g, heads, **kw)

    out = kernel()
    torch.cuda.synchronize()
    ref = plain()
    if packed:
        out = (out[..., :d], out[..., d : 2 * d], out[..., 2 * d :], None)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    err = max(_rel_err(o, r) for o, r in zip(out, ref) if r is not None)
    if not err <= tol:
        raise AssertionError(f"{name}: max |kernel - plain| / max(1, "
                             f"max |plain|) {err} > {tol}")
    del out, ref

    def view(t):
        return t.detach().view(b, n, heads, hd).transpose(1, 2)

    lq, lk, lv = (view(t).requires_grad_() for t in (q, k, v))
    mask = None if bias is None else bias[:, None, None, :].to(dtype)
    if causal:
        mask = score_mask.to(dtype)
    lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask,
                                        dropout_p=rate)
    lg = view(g)

    es = torch.tensor([], dtype=dtype).element_size()
    n_bytes = (7 * b * n * d * es + (0 if bias is None else 2 * b * n * 4)
               + (n * n * 4 if causal else 0))
    dname = str(dtype).split(".")[-1]
    bms, by = bound_ms(n_bytes, 10 * b * heads * n * n * hd, dname)
    row = {
        "ms": time_ms(kernel), "plain_ms": time_ms(plain, reps=2),
        "library_ms": time_ms(lambda: torch.autograd.grad(
            lo, (lq, lk, lv), lg, retain_graph=True)),
        "bound_ms": bms, "bound_by": by, "max_abs_err": err,
    }
    log(f"  {name} {dname} B={b} N={n} D={d} h={heads}"
        f"{' bias+dbias' if with_bias else ''}"
        f"{' causal mask' if causal else ''}"
        f"{f' rate={rate}' if rate else ''}: err/max(1,|plain|) {err:.3g} "
        f"(tol {tol:g}), kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, sdpa backward {row['library_ms']:.4f} "
        f"ms, bound {bms:.4f} ms ({by})")
    return row


def phase_kernels(rows: dict):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        r = _attention_case("mha_packed", 256, 197, 768, 12, dtype, False,
                            gen, packed=True)
        if dtype == torch.bfloat16:
            rows["mha_packed"] = r
        r = _attention_case("mha", 256, 133, 768, 12, dtype, False, gen,
                            packed=False)
        if dtype == torch.bfloat16:
            rows["mha"] = r
        _attention_case("mha", 256, 20, 512, 8, dtype, True, gen,
                        packed=False)
    # K2d and K3 at the flagship config's training batch
    for dtype in (torch.float32, torch.bfloat16):
        r = _dropout_case(TRAIN_BATCH, 133, 768, 12, dtype, False, gen)
        if dtype == torch.bfloat16:
            rows["mha_dropout"] = r
        _dropout_case(TRAIN_BATCH, 20, 512, 8, dtype, True, gen)
        r = _bwd_case("mha_bwd packed", TRAIN_BATCH, 197, 768, 12, dtype,
                      gen, packed=True)
        if dtype == torch.bfloat16:
            rows["mha_bwd"] = r
        _bwd_case("mha_bwd", TRAIN_BATCH, 133, 768, 12, dtype, gen,
                  rate=0.1)
        _bwd_case("mha_bwd", TRAIN_BATCH, 20, 512, 8, dtype, gen,
                  with_bias=True, rate=0.1)
        torch.cuda.empty_cache()
    # the OpenCLIP ablation's shapes: K1m in the text tower at full context
    # and at the service's 20 WordPiece tokens, K1 at ViT-L/14
    for dtype in (torch.float32, torch.bfloat16):
        r = _attention_case("mha_packed", OPENCLIP_BATCH, 77, 768, 12, dtype,
                            False, gen, packed=True, causal=True)
        if dtype == torch.bfloat16:
            rows["mha_packed_mask"] = r
        _attention_case("mha_packed", OPENCLIP_BATCH, 20, 768, 12, dtype,
                        False, gen, packed=True, causal=True)
        _attention_case("mha_packed", 256, 257, 1024, 16, dtype, False, gen,
                        packed=True)
        torch.cuda.empty_cache()
    # OpenCLIP training's backward shapes: K3m beside K1m (N = 77) and at
    # the train path's WordPiece N = 20, B = 10; K3 at ViT-L/14
    for dtype in (torch.float32, torch.bfloat16):
        r = _bwd_case("mha_bwd packed", OPENCLIP_BATCH, 77, 768, 12, dtype,
                      gen, packed=True, causal=True)
        if dtype == torch.bfloat16:
            rows["mha_bwd_mask"] = r
        _bwd_case("mha_bwd packed", OPENCLIP_TRAIN_BATCH, 20, 768, 12, dtype,
                  gen, packed=True, causal=True)
        for b in (OPENCLIP_TRAIN_BATCH, OPENCLIP_BATCH):
            _bwd_case("mha_bwd packed", b, 257, 1024, 16, dtype, gen,
                      packed=True)
        torch.cuda.empty_cache()
    keys, rows["topk"] = _topk_case(gen)
    rows["mm_only"] = _mm_only_case(gen, keys)
    del keys
    torch.cuda.empty_cache()
    rows["topk_i8"] = _topk_i8_case(gen, N_KEYS, (256, 64, 1))
    _topk_i8_case(gen, 5_000_000, (256, 1), codes_on_card=True)
    rows["tiny"] = _tiny_case(gen)
    log("phase kernels ok")


KERNELS = {
    # name: (route, source, the TPU kernel it replaces)
    "mha_packed": ("cuda", "bioscan_clip_tpu_torch/csrc/mha_fwd.cu",
                   "bioscan_clip_tpu/ops/attention.py:425"),
    "mha": ("cuda", "bioscan_clip_tpu_torch/csrc/mha_fwd.cu",
            "bioscan_clip_tpu/ops/attention.py:449"),
    "mha_dropout": ("cuda", "bioscan_clip_tpu_torch/csrc/mha_fwd.cu",
                    "bioscan_clip_tpu/ops/attention.py:449"),
    "mha_bwd": ("cuda", "bioscan_clip_tpu_torch/csrc/mha_bwd.cu",
                "bioscan_clip_tpu/ops/attention.py:321"),
    "topk": ("cuda", "bioscan_clip_tpu_torch/csrc/topk.cu",
             "bioscan_clip_tpu/ops/topk_pallas.py:185"),
    "topk_i8": ("cuda", "bioscan_clip_tpu_torch/csrc/topk.cu",
                "bioscan_clip_tpu/ops/topk_pallas.py:253"),
    "mha_packed_mask": ("cuda", "bioscan_clip_tpu_torch/csrc/mha_fwd.cu",
                        "bioscan_clip_tpu/ops/attention.py:162"),
    "mha_bwd_mask": ("cuda", "bioscan_clip_tpu_torch/csrc/mha_bwd.cu",
                     "bioscan_clip_tpu/ops/attention.py:363"),
    "mm_only": ("cuda", "bioscan_clip_tpu_torch/csrc/topk.cu",
                "tools/bench_topk_variants.py:78"),
    "tiny": ("cuda", "bioscan_clip_tpu_torch/csrc/topk.cu",
             "tools/bench_topk_variants.py:118"),
}
# the main path whose run gives each kernel's launch count in that line
KERNEL_PATH = {"mha_packed": "serving", "mha": "serving", "topk": "serving",
               "topk_i8": "eval", "mha_dropout": "training",
               "mha_bwd": "training", "mha_packed_mask": "openclip",
               "mha_bwd_mask": "openclip_training", "mm_only": "probe",
               "tiny": "probe"}


def launch_counts():
    from bioscan_clip_tpu_torch.ops import attention, topk

    return {"mha_packed": attention.mha_packed.launches,
            "mha_packed_mask": attention.mha_packed.mask_launches,
            "mha": attention.mha.launches,
            "mha_dropout": attention.mha_dropout.launches,
            "mha_bwd": attention.mha_bwd.launches,
            "mha_bwd_mask": attention.mha_bwd.mask_launches,
            "topk": topk.topk.launches,
            "topk_i8": topk.topk_i8.launches,
            "mm_only": topk.mm_only.launches,
            "tiny": topk.tiny.launches}


def _plain_fns():
    from bioscan_clip_tpu_torch.ops import attention, topk

    return (attention.mha_reference, attention.mha_bwd_reference,
            topk.topk_reference, topk.topk_i8_reference,
            topk.mm_only_reference, topk.tiny_reference)


def plain_calls():
    return {fn.__name__: fn.calls for fn in _plain_fns()}


def reset_counts():
    from bioscan_clip_tpu_torch.ops import attention, topk

    for fn in (attention.mha_packed, attention.mha, attention.mha_dropout,
               attention.mha_bwd, topk.topk, topk.topk_i8, topk.mm_only,
               topk.tiny):
        fn.launches = 0
    attention.mha_packed.mask_launches = 0
    attention.mha_bwd.mask_launches = 0
    for fn in _plain_fns():
        fn.calls = 0


# The flagship tri-modal model (ViT-B/16 + BarcodeBERT + BERT-small, LoRA
# rank 4, 768-d), as model_config/lora_vit_lora_barcode_bert_lora_bert_5m
# declares it, with random seeded weights: no pretrained weights ship here.
FLAGSHIP = {
    "image": {"input_type": "image", "model": "lora_vit"},
    "dna": {"input_type": "sequence", "model": "lora_barcode_bert"},
    "language": {"input_type": "sequence", "model": "lora_bert"},
    "output_dim": 768,
    "load_ckpt": False,
}
# The OpenCLIP ablation (model_config/ablation_with_open_clip/
# trained_with_bioscan_1m_image_dna_text_with_pretrained_clip.yaml): ViT-L/14
# + OpenCLIP text + BarcodeBERT, LoRA rank 4 on q/k/v, 768-d, random seeded
# weights (the pretrained open_clip weights do not ship here).
OPENCLIP = {
    "image": {"input_type": "image", "model": "lora_clip_image"},
    "dna": {"input_type": "sequence", "model": "lora_barcode_bert"},
    "language": {"input_type": "sequence", "model": "lora_clip_text"},
    "output_dim": 768,
    "for_open_clip": True,
    "load_ckpt": False,
}
# the requests' text batch, and the OpenCLIP kernel cases' batch
OPENCLIP_BATCH = 64
# the ablation config's batch_size (trained_with_bioscan_1m_image_dna_text_
# with_pretrained_clip.yaml:2)
OPENCLIP_TRAIN_BATCH = 10
N_KEYS = 1 << 20
# model_config/lora_vit_lora_barcode_bert_lora_bert_5m.yaml:2
TRAIN_BATCH = 400
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "diptera",
         "lepidoptera", "hymenoptera", "coleoptera", "cecidomyiidae",
         "chironomidae", "noctuidae", "sciaridae", "sciara", "bradysia",
         "sp", "##ra", "##ia"]
ORDERS = ["diptera", "lepidoptera", "hymenoptera", "coleoptera"]
FAMILIES = ["cecidomyiidae", "chironomidae", "noctuidae", "sciaridae"]


def _key_labels(n):
    """Synthetic 4-level labels, shared strings: row i -> order i % 4,
    family i % 40, genus i % 4000, species i % 100000."""
    fam = [f"{FAMILIES[j % 4]}{j}" for j in range(40)]
    gen = [f"g{j}" for j in range(4000)]
    spe = [f"s{j}" for j in range(100_000)]
    return [{"order": ORDERS[i % 4], "family": fam[i % 40],
             "genus": gen[i % 4000], "species": spe[i % 100_000]}
            for i in range(n)]


def _barcodes(rng, n):
    return ["".join(rng.choice(list("ACGT"), size=658)) for _ in range(n)]


def _timed(what, fn):
    import torch

    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    log(f"  {what}: {1e3 * (time.perf_counter() - t):.1f} ms")
    return out


def _check_search(what, out, n, k):
    import numpy as np

    preds, sims = out["predictions"], np.asarray(out["similarities"])
    if len(preds) != n or sims.shape != (n, k) or not np.isfinite(sims).all():
        raise AssertionError(f"{what}: {len(preds)} predictions, "
                             f"similarities {sims.shape}")
    for p in preds:
        if any(len(p[lvl]) != k for lvl in ("order", "family", "genus",
                                             "species")):
            raise AssertionError(f"{what}: a prediction lacks {k} labels")
    if (np.diff(sims, axis=1) > 0).any():
        raise AssertionError(f"{what}: similarities not sorted")


def _check_unit(what, emb, n):
    import numpy as np

    norms = np.linalg.norm(emb, axis=1)
    if emb.shape != (n, 768) or not np.allclose(norms, 1.0, atol=1e-3):
        raise AssertionError(f"{what}: shape {emb.shape}, norms "
                             f"{norms.min()}..{norms.max()}")


def _http_round_trip(service, body):
    """On a localhost server (one new handler thread per request): POST
    `body` to /search twice and to /embed once. Returns (the last /search
    answer, the /embed answer)."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from bioscan_clip_tpu_torch.cli.serve import make_handler

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()

    def post(path, what):
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}{path}",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        return _timed(f"HTTP {path} {what} dna x{len(body['dna'])}",
                      lambda: json.loads(urllib.request.urlopen(
                          req, timeout=300).read()))

    try:
        post("/search", "#1")
        out = post("/search", "#2")
        return out, post("/embed", "#1")
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=60)


def phase_serving():
    """The main path: cli/serve.build_service at full width over 1,048,576
    resident keys, answering each request kind. Returns the launch counts
    of this run."""
    import tempfile

    import numpy as np

    from bioscan_clip_tpu_torch.cli.serve import build_service
    from bioscan_clip_tpu_torch.config.core import ConfigNode
    from bioscan_clip_tpu_torch.retrieval.engine import l2norm_np
    from bioscan_clip_tpu_torch.retrieval.service import handle_request

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        vocab = f"{tmp}/vocab.txt"
        with open(vocab, "w") as f:
            f.write("\n".join(VOCAB) + "\n")
        args = ConfigNode({"model_config": dict(FLAGSHIP), "serve": {
            "device": "cuda", "max_k": 5, "max_batch": 256,
            "vocab_path": vocab}})
        service = _timed("build_service (flagship, bf16, random weights)",
                         lambda: build_service(args, out=log))
        keys = rng.standard_normal((N_KEYS, 768), dtype=np.float32)
        labels = _key_labels(N_KEYS)
        _timed(f"set_keys ({N_KEYS} x 768 fp32)",
               lambda: service.set_keys(keys, labels))
        barcodes = _barcodes(rng, 64)
        texts = [f"{ORDERS[i % 4]} {FAMILIES[i % 4]} sciara sp"
                 for i in range(64)]
        rows = rng.choice(N_KEYS, size=256, replace=False)
        queries = l2norm_np(keys[rows])
        images = [rng.integers(0, 256, size=(int(h), int(w), 3),
                               dtype=np.uint8)
                  for h, w in rng.integers(240, 420, size=(8, 2))]

        reset_counts()  # the main path's launches are counted from here
        for rep in ("cold", "warm"):
            out = _timed(f"{rep} /search dna x64",
                         lambda: handle_request(service, {"dna": barcodes}))
            _check_search("dna", out, 64, 5)
            out = _timed(f"{rep} /search text x64",
                         lambda: handle_request(service, {"text": texts}))
            _check_search("text", out, 64, 5)
            out = _timed(f"{rep} /search embedding x256",
                         lambda: handle_request(
                             service, {"embedding": queries.tolist()}))
            _check_search("embedding", out, 256, 5)
            top1 = [p["species"][0] for p in out["predictions"]]
            if top1 != [labels[r]["species"] for r in rows]:
                raise AssertionError("embedding search: a key's own "
                                     "embedding did not find it first")
            if not np.allclose(np.asarray(out["similarities"])[:, 0], 1.0,
                               atol=1e-5):
                raise AssertionError("embedding search: self-similarity "
                                     "is not 1")
            emb = _timed(f"{rep} embed_images x8",
                         lambda: service.embed_images(images))
            _check_unit("embed_images", emb, 8)
        # where a request's time goes: the towers vs the search
        emb = _timed("embed_dna x64", lambda: service.embed_dna(barcodes))
        _check_unit("embed_dna", emb, 64)
        _timed("search_embeddings x64 (1M keys)",
               lambda: service.search_embeddings(emb))
        _check_unit("embed_text", _timed(
            "embed_text x64", lambda: service.embed_text(texts)), 64)
        for rep in ("first", "second"):
            _timed(f"{rep} direct /search dna x4",
                   lambda: handle_request(service, {"dna": barcodes[:4]}))
        out, embedded = _http_round_trip(service,
                                         {"dna": barcodes[:4], "k": 3})
        _check_search("HTTP /search", out, 4, 3)
        _check_unit("HTTP /embed", np.asarray(embedded["embeddings"]), 4)
        _serve_int8(service, keys, labels, rows, queries, rng)
        counts = launch_counts()
    log(f"  launches on the serving path: {counts}")
    missing = [name for name in ("mha_packed", "mha", "topk", "topk_i8")
               if counts[name] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the serving path: "
                             f"{missing}")
    log("phase serving ok")
    return counts


def _serve_int8(service, keys, labels, rows, queries, rng):
    """serve.key_precision=int8: the same keys installed as int8 codes
    under each rescore mode. Each key's own embedding comes first (with
    self-similarity 1 within 1e-5 under the fp32 rescore), and top-1 of
    256 queries near keys (cosine ~0.45) agrees with the fp32 service's on
    at least 99% of them."""
    import numpy as np

    from bioscan_clip_tpu_torch.retrieval.engine import l2norm_np
    from bioscan_clip_tpu_torch.retrieval.service import handle_request

    near = l2norm_np(l2norm_np(keys[rows]) + 2.0 * l2norm_np(
        rng.standard_normal((256, 768), dtype=np.float32)))
    ref = [p["species"][0] for p in service.search_embeddings(near)[0]]
    want = [labels[r]["species"] for r in rows]
    sim_tol = {"float32": 1e-5, "bfloat16": 1e-2, "none": 2e-2}
    service.key_precision = "int8"
    for mode in ("float32", "bfloat16", "none"):
        service.key_rescore = mode
        _timed(f"set_keys int8 rescore={mode} ({N_KEYS} x 768)",
               lambda: service.set_keys(keys, labels))
        out = _timed(f"/search embedding x256 int8 rescore={mode}",
                     lambda: handle_request(
                         service, {"embedding": queries.tolist()}))
        _check_search(f"int8 {mode}", out, 256, 5)
        if [p["species"][0] for p in out["predictions"]] != want:
            raise AssertionError(f"int8 {mode}: a key's own embedding did "
                                 "not find it first")
        err = np.abs(np.asarray(out["similarities"])[:, 0] - 1.0).max()
        if not err <= sim_tol[mode]:
            raise AssertionError(f"int8 {mode}: self-similarity off 1 by "
                                 f"{err} > {sim_tol[mode]}")
        top1 = [p["species"][0] for p in service.search_embeddings(near)[0]]
        agree = float(np.mean([a == b for a, b in zip(top1, ref)]))
        log(f"  int8 rescore={mode}: self-similarity within {err:.3g} of 1 "
            f"(tol {sim_tol[mode]:g}); top-1 agrees with fp32 on "
            f"{100 * agree:.1f}% of 256 near queries")
        if agree < 0.99:
            raise AssertionError(f"int8 {mode}: top-1 agrees with fp32 on "
                                 f"{agree:.3f} < 0.99")
    service.key_precision, service.key_rescore = "high", "bfloat16"


def _clip_ids(rng, b, n=77, vocab=49408):
    """(b, n) CLIP-BPE-shaped ids: <start_of_text> (vocab - 2), random
    tokens, <end_of_text> (vocab - 1, the row's maximum), zero padding."""
    import numpy as np

    ids = np.zeros((b, n), np.int64)
    for r, length in enumerate(rng.integers(3, n + 1, size=b)):
        ids[r, 0] = vocab - 2
        ids[r, 1 : length - 1] = rng.integers(1, vocab - 2, size=length - 2)
        ids[r, length - 1] = vocab - 1
    return ids


def phase_openclip():
    """The OpenCLIP ablation served at full width (ViT-L/14 24 x 1024 x 16
    heads, N = 257; text 12 x 768, causal; BarcodeBERT; bf16, random seeded
    weights) behind cli/serve.build_service over 1,048,576 resident fp32
    keys: handle_request for text x64 (BERT-small WordPiece ids, N = 20, as
    the JAX service feeds them), dna x64 and embedding x256, embed_images
    x8, and encode_language on (64, 77) CLIP-BPE-shaped ids (K1m at full
    context). Checks: unit-norm embeddings, each key's own embedding found
    first, K1m, K1, K2 and K4 launched and no plain version. Returns the
    launch counts of this run."""
    import tempfile

    import numpy as np
    import torch

    from bioscan_clip_tpu_torch.cli.serve import build_service
    from bioscan_clip_tpu_torch.config.core import ConfigNode
    from bioscan_clip_tpu_torch.retrieval.engine import l2norm_np
    from bioscan_clip_tpu_torch.retrieval.service import handle_request

    torch.cuda.empty_cache()
    rng = np.random.default_rng(5)
    with tempfile.TemporaryDirectory() as tmp:
        vocab = f"{tmp}/vocab.txt"
        with open(vocab, "w") as f:
            f.write("\n".join(VOCAB) + "\n")
        args = ConfigNode({"model_config": dict(OPENCLIP), "serve": {
            "device": "cuda", "max_k": 5, "max_batch": 256,
            "vocab_path": vocab}})
        service = _timed("build_service (OpenCLIP ViT-L/14, bf16, random "
                         "weights)", lambda: build_service(args, out=log))
        n_params = sum(p.numel() for p in service.model.parameters())
        log(f"  {n_params} parameters; openclip_norm "
            f"{service.openclip_norm}")
        keys = rng.standard_normal((N_KEYS, 768), dtype=np.float32)
        labels = _key_labels(N_KEYS)
        _timed(f"set_keys ({N_KEYS} x 768 fp32)",
               lambda: service.set_keys(keys, labels))
        barcodes = _barcodes(rng, OPENCLIP_BATCH)
        texts = [f"{ORDERS[i % 4]} {FAMILIES[i % 4]} sciara sp"
                 for i in range(OPENCLIP_BATCH)]
        rows = rng.choice(N_KEYS, size=256, replace=False)
        queries = l2norm_np(keys[rows])
        images = [rng.integers(0, 256, size=(int(h), int(w), 3),
                               dtype=np.uint8)
                  for h, w in rng.integers(240, 420, size=(8, 2))]
        clip_ids = torch.from_numpy(_clip_ids(rng, OPENCLIP_BATCH)).cuda()

        reset_counts()  # this path's launches are counted from here
        for rep in ("cold", "warm"):
            out = _timed(f"{rep} /search text x{OPENCLIP_BATCH}",
                         lambda: handle_request(service, {"text": texts}))
            _check_search("text", out, OPENCLIP_BATCH, 5)
            out = _timed(f"{rep} /search dna x{OPENCLIP_BATCH}",
                         lambda: handle_request(service, {"dna": barcodes}))
            _check_search("dna", out, OPENCLIP_BATCH, 5)
            out = _timed(f"{rep} /search embedding x256",
                         lambda: handle_request(
                             service, {"embedding": queries.tolist()}))
            _check_search("embedding", out, 256, 5)
            if [p["species"][0] for p in out["predictions"]] != [
                    labels[r]["species"] for r in rows]:
                raise AssertionError("openclip: a key's own embedding did "
                                     "not find it first")
            emb = _timed(f"{rep} embed_images x8 (ViT-L/14)",
                         lambda: service.embed_images(images))
            _check_unit("embed_images", emb, 8)
            with torch.inference_mode():
                emb = _timed(f"{rep} encode_language ({OPENCLIP_BATCH}, 77) "
                             "CLIP-BPE ids", lambda: service.model.
                             encode_language({"input_ids": clip_ids}))
            _check_unit("encode_language (77)", emb.cpu().numpy(),
                        OPENCLIP_BATCH)
        _check_unit("embed_text", _timed(
            f"embed_text x{OPENCLIP_BATCH}",
            lambda: service.embed_text(texts)), OPENCLIP_BATCH)
        _check_unit("embed_dna", _timed(
            f"embed_dna x{OPENCLIP_BATCH}",
            lambda: service.embed_dna(barcodes)), OPENCLIP_BATCH)
        counts, plain = launch_counts(), plain_calls()
    log(f"  launches on the OpenCLIP path: {counts}; plain calls {plain}")
    want = ("mha_packed_mask", "mha_packed", "mha", "topk")
    if any(counts[k] <= 0 for k in want) or any(plain.values()):
        raise AssertionError(f"openclip: launches {counts}, plain {plain}")
    del service
    torch.cuda.empty_cache()
    log("phase openclip ok")
    return counts


def phase_probe():
    """The port's top-k decomposition probe
    (bioscan_clip_tpu_torch/tools/bench_topk_variants.py) over 1,048,576
    keys at Bq = 256: dispatch_floor (K7), mm_only (K6) fp32 default/high
    and int8, topk_f32 (K4) and topk_i8 (K5), one distinct query set per
    timed call. Returns the launch counts of this run."""
    import torch

    from bioscan_clip_tpu_torch.tools import bench_topk_variants

    torch.cuda.empty_cache()
    reset_counts()
    rc = bench_topk_variants.main(
        ["--keys", str(N_KEYS), "--queries", "256", "--bq", "256"],
        emit=lambda line: log(f"  probe {line}"))
    counts, plain = launch_counts(), plain_calls()
    log(f"  launches in the probe: {counts}; plain calls {plain}")
    want = ("tiny", "mm_only", "topk", "topk_i8")
    if rc != 0 or any(counts[k] <= 0 for k in want) or any(plain.values()):
        raise AssertionError(f"probe: rc {rc}, launches {counts}, plain "
                             f"{plain}")
    torch.cuda.empty_cache()
    log("phase probe ok")
    return counts


# the evaluation job: inference_and_eval.py sets batch_size = 24 (:126)
EVAL_BATCH = 24
N_EVAL_KEYS, N_EVAL_SEEN, N_EVAL_UNSEEN = 1920, 960, 960
EVAL_FRAME = (256, 341)  # the loader's shorter-side-256 frame: crop branch
ODD_FRAME = (333, 251)   # one batch through the device resize branch


def _mutate(rng, barcode, snps):
    """`barcode` with `snps` random substitutions: another specimen of the
    same species."""
    b = list(barcode)
    for pos in rng.choice(len(b), size=snps, replace=False):
        b[pos] = "ACGT"[("ACGT".index(b[pos]) + int(rng.integers(1, 4))) % 4]
    return "".join(b)


def _eval_records(rng, n, frame_hw, like=None, snps=0):
    """n synthetic records: distinct tiled uint8 frames (a random 16x16 tile
    per record, repeated), 658-bp barcodes, 20-token text and 4-level
    labels (4 records per species). `like`: other specimens of these
    records' species, with their text and labels and their barcodes after
    `snps` substitutions (0: the same barcodes)."""
    import numpy as np

    from bioscan_clip_tpu_torch.data.tokenizers import tokenize_dna_batch

    h, w = frame_hw
    tiles = rng.integers(0, 256, size=(n, 16, 16, 3), dtype=np.uint8)
    frames = np.tile(tiles, (1, -(-h // 16), -(-w // 16), 1))[:, :h, :w]
    ids = [f"r{rng.integers(1 << 40)}" for _ in range(n)]
    if like is not None:
        barcodes = [_mutate(rng, b, snps) for b in like["barcodes"]]
        return dict(like, image_u8=np.ascontiguousarray(frames), ids=ids,
                    barcodes=barcodes, dna=tokenize_dna_batch(barcodes))
    mask = (np.arange(20)[None, :]
            < rng.integers(6, 21, size=(n, 1))).astype(np.int32)
    species = rng.integers(0, 100_000) + np.arange(n) // 4
    barcodes = _barcodes(rng, n)
    return {
        "image_u8": np.ascontiguousarray(frames),
        "barcodes": barcodes,
        "dna": tokenize_dna_batch(barcodes),
        "language": {
            "input_ids": (rng.integers(0, 30522, size=(n, 20))
                          * mask).astype(np.int32),
            "token_type_ids": np.zeros((n, 20), np.int32),
            "attention_mask": mask},
        "label_dicts": [{"order": ORDERS[s % 4],
                         "family": f"{FAMILIES[s % 4]}{s % 40}",
                         "genus": f"g{s % 4000}", "species": f"s{s}"}
                        for s in species],
        "ids": ids,
    }


def _take(rec, idx):
    """Rows `idx` of a record dict (arrays, dicts of arrays, lists)."""
    out = {}
    for k, v in rec.items():
        if isinstance(v, dict):
            out[k] = {kk: vv[idx] for kk, vv in v.items()}
        elif isinstance(v, list):
            out[k] = [v[i] for i in idx]
        else:
            out[k] = v[idx]
    return out


def _batches(rec, n):
    """The loader's batch dicts of EVAL_BATCH rows over n records."""
    import numpy as np

    return [_take(rec, np.arange(s, min(s + EVAL_BATCH, n)))
            for s in range(0, n, EVAL_BATCH)]


def _max_diff(a, b):
    import numpy as np

    return max(float(np.abs(a[k] - b[k]).max()) for k in a
               if isinstance(a[k], np.ndarray))


def phase_eval():
    """The evaluation job (scripts/inference_and_eval.py) at full width:
    the flagship (bf16, random seeded weights) embeds all_keys, seen and
    unseen from in-memory uint8 batches through extract_features, per
    batch and grouped, then the 5 x 6 sweep runs in high and int8 precision
    on the card. Checks: grouped equals per-batch within bf16 tolerance;
    the card's sweep equals the same sweep on the CPU over the same
    embeddings; int8 top-1 agrees with high on >= 99% of the queries; K1,
    K2, K4 and K5 launched and no plain version ran. Returns the launch
    counts of the card's run."""
    import numpy as np
    import torch

    from bioscan_clip_tpu_torch.config.core import ConfigNode
    from bioscan_clip_tpu_torch.data.transforms import eval_transform
    from bioscan_clip_tpu_torch.models.clip import load_clip_model
    from bioscan_clip_tpu_torch.retrieval.report import (
        inference_and_print_result,
    )
    from bioscan_clip_tpu_torch.train.loop import extract_features

    torch.cuda.empty_cache()
    rng = np.random.default_rng(4)
    keys_rec = _eval_records(rng, N_EVAL_KEYS, EVAL_FRAME)
    # seen: the key records' specimens again (same barcodes and text), in
    # new frames; unseen: other specimens of the remaining key species,
    # 4 substitutions off their barcodes. The random DNA tower maps every
    # barcode within cosine ~0.999 of every other, so only a near-copy
    # gives a DNA query a top-1 that a 1e-4 score error cannot reorder.
    seen_rec = _eval_records(rng, N_EVAL_SEEN, EVAL_FRAME,
                             like=_take(keys_rec, np.arange(N_EVAL_SEEN)))
    unseen_rec = _eval_records(
        rng, N_EVAL_UNSEEN, EVAL_FRAME, snps=4,
        like=_take(keys_rec, np.arange(N_EVAL_KEYS - N_EVAL_UNSEEN,
                                       N_EVAL_KEYS)))
    odd_rec = _eval_records(rng, EVAL_BATCH, ODD_FRAME)
    loaders = {"keys": _batches(keys_rec, N_EVAL_KEYS),
               "seen": _batches(seen_rec, N_EVAL_SEEN),
               "unseen": _batches(unseen_rec, N_EVAL_UNSEEN),
               "odd": _batches(odd_rec, EVAL_BATCH)}
    args = ConfigNode({"model_config": dict(FLAGSHIP)})
    model = load_clip_model(args, device="cuda", dtype=torch.bfloat16,
                            seed=0)

    # the device transform's resize branch on the card against the CPU
    odd = torch.from_numpy(odd_rec["image_u8"])
    err = (eval_transform(odd.cuda()).cpu() - eval_transform(odd)).abs().max()
    log(f"  eval_transform resize branch {ODD_FRAME}: max |card - cpu| "
        f"{err.item():.3g} (tol 1e-5)")
    if not err.item() <= 1e-5:
        raise AssertionError(f"eval_transform card vs cpu: {err.item()}")

    reset_counts()  # the eval path's launches are counted from here
    splits, grouped = {}, {}
    for name, batches in loaders.items():
        n_rows = sum(len(b["ids"]) for b in batches)
        for group, out in ((0, splits), (None, grouped)):
            out[name] = _timed(
                f"extract_features {name} x{n_rows} "
                f"({'per batch' if group == 0 else 'grouped'})",
                lambda: extract_features(model, batches,
                                         for_key_set=name == "keys",
                                         group_samples=group))
        d = splits[name]
        for k in ("encoded_image_feature", "encoded_dna_feature",
                  "encoded_language_feature"):
            _check_unit(f"{name} {k}", d[k], n_rows)
        diff = _max_diff(splits[name], grouped[name])
        log(f"  {name}: grouped vs per batch max |diff| {diff:.3g} "
            "(tol 2e-2, bf16)")
        if not diff <= 2e-2:
            raise AssertionError(f"grouped extraction of {name}: {diff}")
    _time_modalities(model, loaders["keys"][0])

    results = {}
    for precision in ("high", "int8"):
        ies = {"retrieval_precision": precision}
        sweep_args = ConfigNode({"model_config": dict(FLAGSHIP),
                                 "inference_and_eval_setting": ies})
        results[precision] = _timed(
            f"5x6 sweep {precision} on the card",
            lambda: inference_and_print_result(
                splits["keys"], splits["seen"], splits["unseen"],
                args=sweep_args, k_list=[1, 3, 5], device="cuda",
                out=lambda *_: None))
    counts, plain = launch_counts(), plain_calls()
    log(f"  launches on the eval path: {counts}; plain calls {plain}")
    want = ("mha_packed", "mha", "topk", "topk_i8")
    if any(counts[k] <= 0 for k in want) or any(plain.values()):
        raise AssertionError(f"eval: launches {counts}, plain {plain}")

    for precision in ("high", "int8"):
        ies = {"retrieval_precision": precision}
        sweep_args = ConfigNode({"model_config": dict(FLAGSHIP),
                                 "inference_and_eval_setting": ies})
        cpu = _timed(f"5x6 sweep {precision} on the CPU (reference)",
                     lambda: inference_and_print_result(
                         splits["keys"], splits["seen"], splits["unseen"],
                         args=sweep_args, k_list=[1, 3, 5], device="cpu",
                         out=lambda *_: None))
        acc = results[precision][0]
        same = cpu[0] == acc
        log(f"  sweep {precision}: card accuracy == cpu: {same}; "
            "seen top-1 species image->image "
            f"{acc['encoded_image_feature']['encoded_image_feature']['seen']['micro_acc'][1]['species']:.4f}, "
            "dna->dna "
            f"{acc['encoded_dna_feature']['encoded_dna_feature']['seen']['micro_acc'][1]['species']:.4f}")
        if precision == "int8" and not same:
            # K5 equals its plain version bit for bit and the rescore is
            # the same numpy on both: no room for any difference
            raise AssertionError("sweep int8: the card differs from the CPU")
        if precision == "high":
            ties = _high_searches_agree(splits)
            if not same and not ties:
                raise AssertionError("sweep high: the card's accuracy "
                                     "differs from the CPU's with no "
                                     "near-tie to explain it")
    agree = total = 0
    misses = {}
    for qt, per_key in results["high"][2].items():
        for kt, preds in per_key.items():
            for split in ("curr_seen_pred_list", "curr_unseen_pred_list"):
                hi = preds.get(split, [])
                lo = results["int8"][2][qt][kt].get(split, [])
                same = sum(a["species"][0] == b["species"][0]
                           for a, b in zip(hi, lo))
                agree += same
                total += len(hi)
                if same < len(hi):
                    misses[f"{qt}->{kt} {split[5:-10]}"] = len(hi) - same
    worst = sorted(misses.items(), key=lambda kv: -kv[1])[:4]
    log(f"  int8 top-1 agrees with high on {agree}/{total} queries "
        f"({100 * agree / total:.2f}%); most misses: {worst}")
    if agree < 0.99 * total:
        raise AssertionError(f"int8 top-1 agrees on {agree}/{total}")
    log("phase eval ok")
    del model
    torch.cuda.empty_cache()
    return counts


def _high_searches_agree(splits, k=5, tie=1e-5):
    """Every fp32 search of the sweep, K4 on the card against its plain
    version on the CPU: a position may hold another key only when the two
    keys' float64 scores are within `tie`. K4 sums the 768 products in
    order, the CPU's BLAS in blocks; for scores near 1 the two differ by up
    to ~1e-6 (the fp32 error bound of such a dot is 768 * 2^-24 ~ 4.6e-5),
    and the DNA tower's random-weight embeddings lie within cosine 0.998 of
    each other, so near-ties abound. Returns the rows that differ."""
    import numpy as np

    from bioscan_clip_tpu_torch.retrieval.engine import (
        PreparedKeys,
        l2norm_np,
        topk_search,
    )
    from bioscan_clip_tpu_torch.retrieval.report import (
        ALL_TYPE_OF_FEATURES_OF_KEY,
        ALL_TYPE_OF_FEATURES_OF_QUERY,
    )

    differ = rows = 0
    for kt in ALL_TYPE_OF_FEATURES_OF_KEY:
        kf = splits["keys"].get(kt)
        if kf is None:
            continue
        on_card = PreparedKeys(kf, device="cuda")
        on_cpu = PreparedKeys(kf, device="cpu")
        kn = l2norm_np(kf).astype(np.float64)
        for qt in ALL_TYPE_OF_FEATURES_OF_QUERY:
            for split in ("seen", "unseen"):
                q = splits[split].get(qt)
                if q is None or q.shape[1] != kf.shape[1]:
                    continue
                qn = l2norm_np(q)
                _, ic = topk_search(qn, on_card, k)
                _, ih = topk_search(qn, on_cpu, k)
                rows += len(qn)
                for r in np.nonzero((ic != ih).any(axis=1))[0]:
                    sc = kn @ qn[r].astype(np.float64)
                    pos = ic[r] != ih[r]
                    gap = np.abs(sc[ic[r][pos]] - sc[ih[r][pos]]).max()
                    if gap > tie:
                        raise AssertionError(
                            f"sweep high {qt} x {kt} {split} row {r}: card "
                            f"{ic[r]} vs cpu {ih[r]}, score gap {gap}")
                    differ += 1
    log(f"  sweep high: K4 on the card vs the CPU over {rows} searches: "
        f"{differ} rows differ, each only by keys within {tie:g} of each "
        "other (near-ties)")
    return differ


def _time_modalities(model, batch):
    """Card ms per batch of EVAL_BATCH for each tower (CUDA events)."""
    import torch

    from bioscan_clip_tpu_torch.train.loop import _to_device, make_embed_step

    parts = []
    with torch.inference_mode():
        for m, key in (("image", "image_u8"), ("dna", "dna"),
                       ("language", "language")):
            step = make_embed_step(model, m)
            x = _to_device(batch[key], "cuda")
            parts.append(f"{m} {time_ms(lambda: step(x), reps=5):.2f} ms")
    log(f"  towers per batch of {EVAL_BATCH} (card, CUDA events): "
        + ", ".join(parts))


TRAIN_STEPS = 6


def _train_batch(rng, b, tiled=True):
    """One synthetic flagship batch: (224, 224, 3) uint8 frames (as the
    host augmentation ships them), 658-bp barcodes through the port's DNA
    tokenizer, 20-token text with padding, instance labels.

    `tiled`: each frame is one random 16x16 tile repeated over the 14x14
    patch grid. The towers' weights are random, so attention is near uniform
    and the ViT sees a frame mostly through its mean patch: i.i.d. noise
    frames would all embed alike and the loss could not fall from log(B); a
    tiled frame gives every instance its own mean patch. Its patch tokens
    are all alike, though, so the attention backward's dp - rowsum(dp * p)
    is a difference of near-equal terms: the fp32 parity check uses i.i.d.
    noise frames instead."""
    import numpy as np

    from bioscan_clip_tpu_torch.data.tokenizers import tokenize_dna_batch

    mask = (np.arange(20)[None, :]
            < rng.integers(6, 21, size=(b, 1))).astype(np.int64)
    if tiled:
        tiles = rng.integers(0, 256, size=(b, 16, 16, 3), dtype=np.uint8)
        frames = np.tile(tiles, (1, 14, 14, 1))
    else:
        frames = rng.integers(0, 256, size=(b, 224, 224, 3), dtype=np.uint8)
    return {
        "image_u8": frames,
        "dna": tokenize_dna_batch(_barcodes(rng, b)).astype(np.int64),
        "language": {"input_ids": rng.integers(0, 30522, size=(b, 20)) * mask,
                     "token_type_ids": np.zeros((b, 20), np.int64),
                     "attention_mask": mask},
        "labels": np.arange(b),
    }


def _profile_step(state, step, batch):
    """Where one more train step's card time goes (torch.profiler, after
    the checked run): kernel time by group, and the card's busy share of
    the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bioscan_clip_tpu_torch.train.loop import device_batch

    groups = (("K3/K3m mha_bwd", ("bwd_query_rows", "bwd_key_rows",
                                  "dbias_sum_heads")),
              ("K1/K1m/K2d mha_fwd", ("mha_fwd_kernel",)),
              ("GEMM (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")))
    b = device_batch(batch, "cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, b, 0x600D5EED)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    total, others = {}, []
    for ev in prof.key_averages():
        # kernel events only: an operator's own entry repeats its kernels
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.device_time_total / 1e3
        name = next((g for g, keys in groups
                     if any(k in ev.key.lower() for k in keys)),
                    "other kernels")
        total[name] = total.get(name, 0.0) + ms
        if name == "other kernels":
            others.append((ms, ev.count, ev.key[:90]))
    busy = sum(total.values())
    if busy <= 0:
        log("  profiled step: the profiler shows no card time (not measured)")
        return
    parts = ", ".join(f"{k} {v:.1f} ms ({100 * v / busy:.1f}%)"
                      for k, v in sorted(total.items(), key=lambda kv: -kv[1]))
    log(f"  profiled step: wall {wall_ms:.1f} ms, card busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.1f}%): {parts}")
    for ms, count, key in sorted(others, reverse=True)[:8]:
        log(f"    other: {ms:.1f} ms in {count} launches of {key}")


def phase_training():
    """The main path of training: the flagship LoRA contrastive step
    (make_train_step) driven by train_epoch for TRAIN_STEPS steps over one
    fixed batch of TRAIN_BATCH, at full width, bf16 compute, frozen weights
    stored in bf16, dropout 0.1 in both BERT towers. Returns the launch
    counts of this run."""
    import math

    import numpy as np
    import torch

    from bioscan_clip_tpu_torch.config.core import ConfigNode
    from bioscan_clip_tpu_torch.models.clip import load_clip_model
    from bioscan_clip_tpu_torch.models.lora import LORA_A_NAMES
    from bioscan_clip_tpu_torch.train.loop import make_train_step, train_epoch
    from bioscan_clip_tpu_torch.train.schedules import build_schedule
    from bioscan_clip_tpu_torch.train.state import (
        cast_frozen_params,
        create_train_state,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = ConfigNode({"model_config": dict(FLAGSHIP)})
    model = load_clip_model(args, device="cuda", dtype=torch.bfloat16,
                            seed=0)
    cast_frozen_params(model)  # tpu.frozen_dtype: bfloat16
    state = create_train_state(model, build_schedule(args.model_config,
                                                     TRAIN_STEPS))
    labels = state.labels
    params = dict(model.named_parameters())
    frozen0 = {n: p.detach().clone() for n, p in params.items()
               if labels[n] == "frozen"}
    train0 = {n: p.detach().clone() for n, p in params.items()
              if labels[n] != "frozen"}
    batch = _train_batch(np.random.default_rng(2), TRAIN_BATCH)
    step = make_train_step(model)
    events, snaps = [], []

    def timed_step(st, b, seed):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = step(st, b, seed)
        ev[1].record()
        events.append(ev)
        if len(snaps) < 2:
            snaps.append({n: params[n].detach().clone() for n in train0})
        return out

    reset_counts()  # the training path's launches are counted from here
    state, stats = train_epoch(state, timed_step, [batch] * TRAIN_STEPS,
                               torch.Generator().manual_seed(0), epoch=0,
                               total_epochs=1)
    torch.cuda.synchronize()
    counts, plain = launch_counts(), plain_calls()
    step_ms = [a.elapsed_time(b) for a, b in events]
    peak = torch.cuda.max_memory_allocated()
    losses = stats["losses"]
    log(f"  losses: {[round(x, 5) for x in losses]}")
    log(f"  step ms (card, CUDA events): {[round(t, 1) for t in step_ms]}; "
        f"steps 2-{TRAIN_STEPS} mean {np.mean(step_ms[1:]):.1f} ms")
    log(f"  samples/s {stats['samples_per_s']:.1f}, steady "
        f"{stats.get('samples_per_s_steady', float('nan')):.1f}, peak "
        f"memory {peak / 2**30:.2f} GiB (max_memory_allocated), B="
        f"{TRAIN_BATCH}")
    log(f"  launches on the training path: {counts}; plain calls {plain}")

    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"training: losses {losses}")
    if not np.mean(losses[3:]) < losses[0]:
        raise AssertionError(f"training: loss did not fall: {losses}")
    moved = [n for n, p in frozen0.items() if not torch.equal(p, params[n])]
    if moved:
        raise AssertionError(f"training: frozen parameters moved: {moved[:5]}")
    # B and the heads move at step 1; A's gradient is zero while B is zero
    still = [n for n, p in train0.items()
             if torch.equal(p, snaps[1 if any(a in n for a in LORA_A_NAMES)
                                     else 0][n])]
    if still:
        raise AssertionError(f"training: trainable parameters did not move: "
                             f"{still[:5]}")
    want = ("mha_packed", "mha_dropout", "mha_bwd")
    if (any(counts[k] <= 0 for k in want) or counts["mha"] != 0
            or any(plain.values())):
        raise AssertionError(f"training: launches {counts}, plain {plain}")
    _profile_step(state, step, batch)
    log(f"phase training ok: {len(frozen0)} frozen tensors unchanged, "
        f"{len(train0)} trainable tensors moved")
    del state, model, step, snaps, frozen0, train0, params
    torch.cuda.empty_cache()
    return counts


def phase_openclip_training():
    """The OpenCLIP ablation trained on the card: ViT-L/14 + OpenCLIP text +
    BarcodeBERT (dropout 0.1), LoRA rank 4 on q/k/v, at full width, bf16
    compute, frozen weights stored in bf16, random seeded weights. The
    train step with CLIP's image normalization (make_train_step(
    openclip_norm=True)) driven by train_epoch for TRAIN_STEPS steps over
    one fixed batch of OPENCLIP_TRAIN_BATCH (tiled uint8 frames, barcodes,
    text as WordPiece ids at N = 20, as the loader feeds every model). After
    step 3 the state is saved (train.checkpoint, in the background) under
    the repo's git-ignored build/; a freshly built state of other weights
    restores it and runs steps 4-6 again, and its losses and trainable
    parameters must equal the uninterrupted run's. Returns the launch
    counts of the uninterrupted run."""
    import math
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from bioscan_clip_tpu_torch.config.core import ConfigNode
    from bioscan_clip_tpu_torch.models.clip import load_clip_model
    from bioscan_clip_tpu_torch.models.lora import LORA_A_NAMES
    from bioscan_clip_tpu_torch.train import checkpoint
    from bioscan_clip_tpu_torch.train.loop import make_train_step, train_epoch
    from bioscan_clip_tpu_torch.train.schedules import build_schedule
    from bioscan_clip_tpu_torch.train.state import (
        cast_frozen_params,
        create_train_state,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = ConfigNode({"model_config": dict(OPENCLIP)})

    def fresh_state(seed):
        model = load_clip_model(args, device="cuda", dtype=torch.bfloat16,
                                seed=seed)
        cast_frozen_params(model)  # tpu.frozen_dtype: bfloat16
        return create_train_state(
            model, build_schedule(args.model_config, TRAIN_STEPS), seed=seed)

    state = fresh_state(0)
    params = dict(state.model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    frozen0 = {n: p.detach().clone() for n, p in params.items()
               if state.labels[n] == "frozen"}
    train0 = {n: p.detach().clone() for n, p in params.items()
              if state.labels[n] != "frozen"}
    log(f"  {n_params} parameters, {sum(p.numel() for p in train0.values())}"
        f" trainable in {len(train0)} tensors")
    batch = _train_batch(np.random.default_rng(7), OPENCLIP_TRAIN_BATCH)
    step = make_train_step(state.model, openclip_norm=True)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="openclip_ckpt_", dir=build)
    resume_at = TRAIN_STEPS // 2
    events, snaps = [], []

    def timed_step(st, b, seed):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = step(st, b, seed)
        ev[1].record()
        events.append(ev)
        if len(snaps) < 2:
            snaps.append({n: params[n].detach().clone() for n in train0})
        if st.step == resume_at:  # the generator has drawn this many seeds
            t = time.perf_counter()
            checkpoint.save_checkpoint(ckpt_dir, st, block=False)
            log(f"  save_checkpoint after step {resume_at} returned in "
                f"{1e3 * (time.perf_counter() - t):.1f} ms (writes in the "
                "background)")
        return out

    try:
        reset_counts()  # this path's launches are counted from here
        state, stats = train_epoch(state, timed_step,
                                   [batch] * TRAIN_STEPS, state.generator,
                                   epoch=0, total_epochs=1)
        torch.cuda.synchronize()
        counts, plain = launch_counts(), plain_calls()
        t = time.perf_counter()
        checkpoint.wait_for_checkpoints()
        wait_ms = 1e3 * (time.perf_counter() - t)
        log(f"  checkpoint write finished {wait_ms:.1f} ms after the run; "
            f"{Path(ckpt_dir, 'last').stat().st_size} bytes")
        step_ms = [a.elapsed_time(b) for a, b in events]
        peak = torch.cuda.max_memory_allocated()
        losses = stats["losses"]
        log(f"  losses: {[round(x, 5) for x in losses]}")
        log(f"  step ms (card, CUDA events): {[round(t, 1) for t in step_ms]}"
            f"; steps 2-{TRAIN_STEPS} mean {np.mean(step_ms[1:]):.1f} ms")
        log(f"  samples/s {stats['samples_per_s']:.1f}, steady "
            f"{stats.get('samples_per_s_steady', float('nan')):.1f}, peak "
            f"memory {peak / 2**30:.2f} GiB (max_memory_allocated), B="
            f"{OPENCLIP_TRAIN_BATCH}")
        log(f"  launches on the OpenCLIP training path: {counts}; plain calls "
            f"{plain}")
        if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"openclip_training: losses {losses}")
        if not np.mean(losses[3:]) < losses[0]:
            raise AssertionError(f"openclip_training: loss did not fall: "
                                 f"{losses}")
        moved = [n for n, p in frozen0.items()
                 if not torch.equal(p, params[n])]
        if moved:
            raise AssertionError(f"openclip_training: frozen parameters "
                                 f"moved: {moved[:5]}")
        # B and the decoder move at step 1; A's gradient is zero while B is
        still = [n for n, p in train0.items()
                 if torch.equal(p, snaps[1 if any(a in n for a in LORA_A_NAMES)
                                         else 0][n])]
        if still:
            raise AssertionError(f"openclip_training: trainable parameters "
                                 f"did not move: {still[:5]}")
        want = ("mha_packed", "mha_packed_mask", "mha_dropout", "mha_bwd",
                "mha_bwd_mask")
        if (any(counts[k] <= 0 for k in want) or counts["mha"] != 0
                or any(plain.values())):
            raise AssertionError(f"openclip_training: launches {counts}, "
                                 f"plain {plain}")
        del frozen0, snaps
        _check_resume(fresh_state, ckpt_dir, batch, state, losses, train0,
                      resume_at)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    _profile_step(state, step, batch)
    log(f"phase openclip_training ok: {n_params} parameters, "
        f"{len(train0)} trainable tensors moved")
    del state, step, train0, params
    torch.cuda.empty_cache()
    return counts


def _check_resume(fresh_state, ckpt_dir, batch, ref, ref_losses, train0,
                  resume_at):
    """Restore the checkpoint into a state built from other weights and
    another generator seed, run the remaining steps, and hold the losses
    and trainable parameters against the uninterrupted run `ref`: bit
    equality expected (the same kernels on the same inputs in the same
    order); a difference is printed with where it is, and must stay within
    1e-6 relative."""
    import torch

    from bioscan_clip_tpu_torch.train import checkpoint
    from bioscan_clip_tpu_torch.train.loop import make_train_step, train_epoch

    st = fresh_state(1)
    t = time.perf_counter()
    checkpoint.restore_checkpoint(ckpt_dir, st)
    torch.cuda.synchronize()
    log(f"  restore_checkpoint: {1e3 * (time.perf_counter() - t):.1f} ms, "
        f"step {st.step}")
    if st.step != resume_at:
        raise AssertionError(f"restore: step {st.step} != {resume_at}")
    st, stats = train_epoch(st, make_train_step(st.model, openclip_norm=True),
                            [batch] * (TRAIN_STEPS - resume_at), st.generator,
                            epoch=0, total_epochs=1)
    losses = stats["losses"]
    want = ref_losses[resume_at:]
    ours = dict(st.model.named_parameters())
    refs = dict(ref.model.named_parameters())
    diffs = {n: (ours[n].float() - refs[n].float()).abs().max().item()
             / max(refs[n].float().abs().max().item(), 1e-30)
             for n in train0}
    worst = max(diffs.items(), key=lambda kv: kv[1])
    same_loss = losses == want
    same_params = worst[1] == 0.0 and all(
        torch.equal(ours[n], refs[n]) for n in ours)
    log(f"  resumed steps {resume_at + 1}-{TRAIN_STEPS}: losses {losses} vs "
        f"uninterrupted {want}; bit-equal losses {same_loss}, parameters "
        f"{same_params}")
    if not (same_loss and same_params):
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        log(f"  resume differs: losses by {rel:.3g} relative, worst "
            f"trainable tensor {worst[0]} by {worst[1]:.3g} relative")
        if not (rel <= 1e-6 and worst[1] <= 1e-6):
            raise AssertionError(f"resume: losses {losses} vs {want}, "
                                 f"{worst}")
    del st


def phase_parity():
    """The fp32 port on the card against the same model on the CPU (the
    kernels' plain versions), 4 rows per tower, at full width."""
    import copy

    import numpy as np
    import torch

    from bioscan_clip_tpu_torch.config.core import ConfigNode
    from bioscan_clip_tpu_torch.data.tokenizers import tokenize_dna_batch
    from bioscan_clip_tpu_torch.models.clip import load_clip_model

    args = ConfigNode({"model_config": dict(FLAGSHIP)})
    cpu = load_clip_model(args, device="cpu", dtype=torch.float32, seed=1)
    gpu = copy.deepcopy(cpu).to("cuda")
    rng = np.random.default_rng(1)
    mask = np.ones((4, 20), np.int64)
    mask[1, 7:] = 0
    mask[3, 12:] = 0
    x = {
        "image": rng.random((4, 224, 224, 3), dtype=np.float32),
        "dna": tokenize_dna_batch(_barcodes(rng, 4)).astype(np.int64),
        "language": {"input_ids": rng.integers(0, 30522, size=(4, 20)),
                     "token_type_ids": np.zeros((4, 20), np.int64),
                     "attention_mask": mask},
    }

    def embed(model, dev):
        def t(a):
            return torch.from_numpy(a).to(dev)

        with torch.inference_mode():
            return {
                "image": model.encode_image(t(x["image"])),
                "dna": model.encode_dna(t(x["dna"])),
                "language": model.encode_language(
                    {k: t(v) for k, v in x["language"].items()}),
            }

    ref = embed(cpu, "cpu")
    out = embed(gpu, "cuda")
    for name in ref:
        err = (out[name].cpu() - ref[name]).abs().max().item()
        log(f"  {name}: max |card - cpu| {err:.3g} (tol 1e-3)")
        if not err <= 1e-3:
            raise AssertionError(f"parity {name}: {err} > 1e-3")
    _train_step_parity(cpu, gpu)
    del cpu, gpu
    _openclip_parity(x)
    log("phase parity ok")


def _openclip_parity(x, layers=2):
    """The OpenCLIP towers at full width and `layers` layers each (the full
    ViT-L/14 is slow on the CPU), fp32, LoRA B drawn non-zero: the card
    (K1, K1m, K2) against the CPU (the plain versions), tol 1e-3 on the
    normalized embeddings as above, on 4 images, 4 barcodes, the 4
    WordPiece rows and 4 CLIP-BPE-shaped rows at context 77; then one train
    step with CLIP's image normalization and dropout 0.1 in BarcodeBERT
    (K1, K1m, K2d forward; K3, K3m backward) as `_train_step_parity`."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from bioscan_clip_tpu_torch.models.bert import (
        BARCODE_BERT_CONFIG,
        BarcodeBertDnaEncoder,
    )
    from bioscan_clip_tpu_torch.models.clip import MultiModalCLIP, init_weights
    from bioscan_clip_tpu_torch.models.lora import LORA_B_NAMES
    from bioscan_clip_tpu_torch.models.openclip import (
        OpenClipImageTower,
        OpenClipTextAdapter,
        OpenClipTextConfig,
        OpenClipVisionConfig,
    )

    cut = {"layers": layers}
    cpu = init_weights(MultiModalCLIP(
        image_encoder=OpenClipImageTower(dataclasses.replace(
            OpenClipVisionConfig(), **cut)),
        dna_encoder=BarcodeBertDnaEncoder(dataclasses.replace(
            BARCODE_BERT_CONFIG, num_layers=layers)),
        language_encoder=OpenClipTextAdapter(dataclasses.replace(
            OpenClipTextConfig(), **cut)),
    ), seed=2).eval()
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if any(b in name.split(".")[-2:] for b in LORA_B_NAMES):
                p.normal_(0.0, 0.02, generator=gen)
    gpu = copy.deepcopy(cpu).to("cuda")
    clip_ids = _clip_ids(np.random.default_rng(6), 4)

    def embed(model, dev):
        def t(a):
            return torch.from_numpy(a).to(dev)

        with torch.inference_mode():
            return {
                "image": model.encode_image(t(x["image"])),
                "dna": model.encode_dna(t(x["dna"])),
                "language (WordPiece, N=20)": model.encode_language(
                    {k: t(v) for k, v in x["language"].items()}),
                "language (CLIP-BPE, N=77)": model.encode_language(
                    {"input_ids": t(clip_ids)}),
            }

    ref = embed(cpu, "cpu")
    reset_counts()
    out = embed(gpu, "cuda")
    counts = launch_counts()
    for name in ref:
        err = (out[name].cpu() - ref[name]).abs().max().item()
        log(f"  openclip {layers}-layer {name}: max |card - cpu| {err:.3g} "
            "(tol 1e-3)")
        if not err <= 1e-3:
            raise AssertionError(f"parity openclip {name}: {err} > 1e-3")
    if min(counts[k] for k in ("mha_packed", "mha_packed_mask", "mha")) <= 0:
        raise AssertionError(f"parity openclip: launches {counts}")
    reset_counts()
    _train_step_parity(cpu, gpu, openclip_norm=True,
                       what=f"openclip {layers}-layer ")
    counts = launch_counts()
    if min(counts[k] for k in ("mha_bwd", "mha_bwd_mask")) <= 0:
        raise AssertionError(f"parity openclip train step: launches {counts}")


def _train_step_parity(cpu, gpu, openclip_norm=False, what=""):
    """One fp32 train step at full width, B=4, dropout 0.1 (row-keyed, the
    same step seed) on the card against the CPU: the loss within 1e-5
    relative, each trainable gradient within 1e-4 * max |g| (fp32 sums in
    another order through 28 layers), and AdamW on the card, given the
    card's gradients, equal to AdamW on the CPU given the same gradients
    (atol 1e-6: one fp32 update of parameters of |p| < 1). `openclip_norm`:
    the OpenCLIP ablation's image normalization."""
    import numpy as np
    import torch

    from bioscan_clip_tpu_torch.train.loop import device_batch, make_train_step
    from bioscan_clip_tpu_torch.train.schedules import constant
    from bioscan_clip_tpu_torch.train.state import create_train_state

    batch = _train_batch(np.random.default_rng(3), 4, tiled=False)
    seed = 0x5EED1234
    st_c = create_train_state(cpu, constant(1e-3))
    st_g = create_train_state(gpu, constant(1e-3))
    step_c = make_train_step(cpu, openclip_norm=openclip_norm)
    step_g = make_train_step(gpu, openclip_norm=openclip_norm)
    cpu.train()
    loss_c = step_c.loss_fn(device_batch(batch, "cpu"), seed)
    loss_c.backward()
    _, loss_g = step_g(st_g, device_batch(batch, "cuda"), seed)
    rel = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
    log(f"  {what}train step loss: card {loss_g.item():.7f}, cpu "
        f"{loss_c.item():.7f}, rel {rel:.3g} (tol 1e-5)")
    if not rel <= 1e-5:
        raise AssertionError(f"parity train loss: rel {rel} > 1e-5")
    pc, pg = dict(cpu.named_parameters()), dict(gpu.named_parameters())
    worst = (0.0, "")
    for name, p in pc.items():
        if not p.requires_grad:
            continue
        gc, gg = p.grad, pg[name].grad.cpu()
        err = (gg - gc).abs().max().item() / max(gc.abs().max().item(),
                                                 1e-30)
        worst = max(worst, (err, name))
        p.grad = gg  # the CPU AdamW below takes the card's gradients
    log(f"  {what}train step grads: max |card - cpu| / max |g| {worst[0]:.3g} "
        f"({worst[1]}) (tol 1e-4)")
    if not worst[0] <= 1e-4:
        raise AssertionError(f"parity train grads: {worst}")
    st_c.apply_gradients()
    err = max((pg[n].detach().cpu() - p.detach()).abs().max().item()
              for n, p in pc.items())
    log(f"  {what}params after AdamW: max |card - cpu| {err:.3g} (tol 1e-6)")
    if not err <= 1e-6:
        raise AssertionError(f"parity AdamW: {err} > 1e-6")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(ALL_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    # fp32 products on the card stay full fp32 (the parity contract)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    rows: dict = {}
    path_counts = {}
    phase_device()
    phase_build()
    if "kernels" in phases:
        phase_kernels(rows)
    if "serving" in phases:
        path_counts["serving"] = phase_serving()
    if "openclip" in phases:
        path_counts["openclip"] = phase_openclip()
    if "eval" in phases:
        path_counts["eval"] = phase_eval()
    if "training" in phases:
        path_counts["training"] = phase_training()
    if "openclip_training" in phases:
        path_counts["openclip_training"] = phase_openclip_training()
    if "probe" in phases:
        path_counts["probe"] = phase_probe()
    if "parity" in phases:
        phase_parity()
    log(f"elapsed {time.perf_counter() - t0:.1f} s")
    launches = {name: path_counts.get(path, {}).get(name)
                for name, path in KERNEL_PATH.items()}

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = rows.get(name, {})
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r.get("max_abs_err"), "ms": r.get("ms"),
            "plain_ms": r.get("plain_ms"), "bound_ms": r.get("bound_ms"),
            "bound_by": r.get("bound_by"), "library_ms": r.get("library_ms"),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
