"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py                    # every phase, as the check runs it
    python3 chip_smoke.py --phases kernels   # device, build and kernel phases

Phases, in order; any failure exits non-zero:
  device    the card's name and power limit (nvidia-smi), whether libjpeg
            (jpeglib.h, libjpeg.so) and CUDA's nvJPEG (nvjpeg.h,
            libnvjpeg) are on the machine, and which of pandas, h5py, PIL,
            cv2, matplotlib, sklearn and scipy import (a report)
  build     nvcc builds every kernel under bioscan_clip_tpu_torch/csrc and
            prints ptxas' registers, shared memory and spills per kernel
            (one "K4 pass 1 MAXK= QB= TERMS=" line per fp32 top-k and one
            "K5 pass 1 MAXK= QB=" line per int8 top-k instantiation)
  kernels   each kernel against its plain PyTorch version at the shapes of
            its path (fp32 FFMA and bf16 tensor-core bodies for attention,
            bf16 forwards at N <= 32 on the FFMA body, the masked K1m and
            its backward K3m at N = 77 and 20, K1 and K3 at ViT-L/14, K2d's
            keep mask read out bit for bit, two K3 launches bit-equal; top-k
            in "high" and "default" precision at Bq 256, 64, 16, 1 and
            keys whose scores rise with the index at Bq 256;
            int8 top-k bit for bit at 1,048,576 keys (Bq 256, 64, 16, 1,
            and keys whose scores rise with the index at Bq 256) and at
            5,000,000 keys (Bq 256, 1); the
            matmul-only control K6 and K7), with the kernel's, the plain
            version's and one library call's time
  serving   the flagship model at full width (random seeded weights, bf16)
            behind cli/serve.build_service over 1,048,576 resident keys:
            handle_request for dna, text, embedding and embed_images, and
            HTTP /search and /embed on localhost; then the same keys as
            int8 codes under each rescore mode; K1, K2, K4 and K5 must have
            launched
  eval      the evaluation job at full width: in-memory batches of 24 (all
            keys 1,920, seen 960, unseen 960 records) through
            train.loop.extract_features per batch and grouped, then the
            5 x 6 retrieval sweep (retrieval.report) in high, default
            (K4's single bf16 pass) and int8 precision; the card's sweep
            equals the CPU's on the same embeddings up to near-ties; K1, K2,
            K4 (high and default) and K5 launched and no plain version
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
  train_cl  the training entry point, cli/train_cl.run, at full width: the
            flagship at B=400, bf16, frozen weights in bf16, dropout 0.1,
            GradCache 4 x 100 (merged stage 1, gc_s1_chunk 200), the device
            train augmentation from (256, 341) uint8 frames, 2 epochs of 3
            steps from in-memory loaders, the eval phase after each (480
            keys, 240 seen, 240 unseen), last/best/config.yaml under the
            git-ignored build/, a resume from `last` after epoch 0 with
            epoch 1's losses bit-equal; K1, K2d, K3, K2 and K4 launched, no
            plain version; then one step under remat "full" and "dots" and
            the GradCache step against the plain step (gradients, ms, peak
            memory), and the train augmentation card vs CPU
  insect    the INSECT path and the supervised fine-tunes at full width
            (random seeded weights, bf16), from in-memory loaders in
            InsectLoader's contract ((256, 341) uint8 frames; the .mat
            splits written with scipy.io.savemat and read back with
            load_insect_mat): cli/fine_tune_vitb_on_insect (ViT-B/16, every
            weight trained, 797-way head, B=200, 4 steps, eval on 400
            test-seen records, the feature CSV of 1,000), cli/
            supervised_fine_tune_bioscan_clip_model_on_insect (the image
            and DNA towers with two 797-way heads, B=200, 3 steps, eval,
            the BZSL CSVs), cli/extract_feature_for_insect_dataset then
            cli/bzsl_eval, cli/train_cl in INSECT mode (B=400 with
            ColorJitter, 2 steps, the eval phase over 4 splits of 240
            merged as keys), cli/method_one_eval and cli/method_two_
            fine_tuning_and_eval (480 seen keys, 240 records per other
            split, method 2's fine-tune 2 steps); ms per step and peak
            memory of the full-ViT and the joint step; K1, K2, K2d, K3 and
            K4 launched, no plain version
  data_tools
            the slice's tools that need none of the packages the card's
            machine lacks (h5py, matplotlib, sklearn, libjpeg):
            utils/flops' counts per sample against FLOPS_PER_SAMPLE;
            data/splits.create_splits over 200,000 records of 4,000
            long-tailed species, get_species_taxo_labels over that table,
            process_insect_dataset's .mat -> CSV at INSECT's 21,212 images;
            interop/torch_export.save_pth of the flagship
            at full width (random seeded weights, bf16) read back by
            train/checkpoint.load_pth_into_params into a fresh model, state
            dicts and one batch's embeddings bit-equal; the 5 x 6 sweep's
            results.csv (retrieval/report.py, 96 keys, 48 seen and 48
            unseen records) through cli/flatten_csv, one row per (metric,
            value column); K1, K2 and K4 launched, no plain version
  distributed
            the distributed train step over a 1-rank NCCL group on the
            card (parallel/distributed.py, parallel/mesh.py): the flagship
            at B=400, the plain step and GradCache 4 x 100 over the mesh
            bit-equal to the steps without it (losses, gradients, the
            parameters after 3 AdamW steps); ms per step and the NCCL
            kernels' card time; remat "dots" launches no attention forward
            in the backward
  graphs    K train steps per call as CUDA graphs (train/graphs.py):
            the flagship at B=400 (plain K=4 in two calls, GradCache
            4 x 100 K=4, remat "full" K=2, the plain step over a 1-rank
            NCCL mesh K=2) and the OpenCLIP ablation at B=10 K=8, each
            bit-equal to as many eager steps from the same state (losses,
            trainable parameters, AdamW moments), with eager and graphed
            ms per step, the card's busy share of a graphed call, peak
            memory, and K1, K2d, K3 (and K1m, K3m) in the replays'
            counters and profiler trace, no plain version; then
            cli/train_cl.run with tpu.steps_per_call=4 under GradCache,
            2 epochs of 6 steps and a bit-equal resume
  streaming host-slab streaming and the sharded search
            (retrieval/engine.py): 4,194,304 fp32 keys in slabs of
            1,048,576 ("high", "default") and 2,097,152 int8 keys in slabs
            of 524,288 (each rescore mode), and the same keys sharded four
            ways on the one card, against the resident search; ms per
            search, the stream's copy rate and the copy hidden under the
            search
  probe     the port's top-k decomposition probe at Bq = 256 (K7, K6, K4,
            K5 rows, bioscan_clip_tpu_torch/tools/bench_topk_variants.py)
  parity    the fp32 port on the card against the same model on the CPU:
            embeddings, then one train step (loss, gradients, AdamW); then
            the OpenCLIP towers at full width and 2 layers each, their
            embeddings and one train step (K3m on the card); then the
            fine-tunes' classifier and joint steps (ViT-B/16 and
            BarcodeBERT at 2 layers, every weight trainable, B=8)

Every flagship step time (training, train_cl, insect, distributed, graphs)
and the eval phase's extraction rate has an MFU line beside it: utils/flops'
matmul FLOPs per sample over the 989 TFLOP/s bf16 dense peak, with the
card's name and power limit.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Needs CUDA: without it the script exits 1
and prints no result.
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense): the bound of each kernel is the larger
# of its bytes over the memory rate and its operations over the peak for
# their type.
PEAK = {"bytes": 3.35e12, "bfloat16": 989e12, "float32": 67e12,
        "int8": 1979e12}
# Matmul FLOPs per sample of the flagship's steps by the JAX package's count
# (utils/flops.py; tests/test_torch_flops_viz_export.py ties these to it):
# the data_tools phase holds the port's counts against them.
FLOPS_PER_SAMPLE = {"plain": 118467084288.0, "gradcache": 177601994752.0,
                    "extract": 59134910464.0, "vit_full": 105381900288.0,
                    "joint_full": 175586697216.0}
ALL_PHASES = ("device", "build", "kernels", "serving", "openclip", "eval",
              "training", "openclip_training", "train_cl", "insect",
              "data_tools", "distributed", "graphs", "streaming", "probe",
              "parity")


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


@functools.lru_cache(maxsize=None)
def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def phase_device():
    import torch

    line = card_line()
    log(line)
    log(f"  libjpeg: {_libjpeg()}")
    log(f"  nvJPEG: {_nvjpeg()}")
    log(f"  host libraries that import: {_host_libraries()}")
    log(f"phase device ok: {torch.cuda.get_device_name(0)}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return line


# the host libraries the port imports only inside the functions that need
# them; the device phase reports which of them the machine has
HOST_LIBRARIES = ("pandas", "h5py", "PIL", "cv2", "matplotlib", "sklearn",
                  "scipy")


def _host_libraries() -> dict:
    """name -> its version, or "missing": each imported in a child process,
    so this one does not load them. A report, never a failure."""
    code = ("import importlib, json\nout = {}\n"
            f"for name in {HOST_LIBRARIES!r}:\n"
            "    try:\n"
            "        m = importlib.import_module(name)\n"
            "        out[name] = getattr(m, '__version__', 'present')\n"
            "    except Exception as e:\n"
            "        out[name] = f'missing ({type(e).__name__})'\n"
            "print(json.dumps(out))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    try:
        return json.loads(r.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        return {"error": (r.stderr or r.stdout)[-300:]}


def _nvjpeg() -> str:
    """Whether CUDA's nvJPEG is on the machine, for a card-side JPEG decode:
    nvjpeg.h in the toolkit's include paths, libnvjpeg in its library paths
    and the Python wheels', and by ctypes.util.find_library. A report,
    never a failure."""
    import ctypes.util
    import glob
    import os
    import site

    heads = sorted({h for d in ("/usr/local/cuda/include",
                                "/usr/local/cuda/targets/*/include",
                                "/usr/include")
                    for h in glob.glob(os.path.join(d, "nvjpeg.h"))})
    lib_dirs = ["/usr/local/cuda/lib64", "/usr/local/cuda/targets/*/lib",
                "/usr/lib/x86_64-linux-gnu"]
    lib_dirs += [os.path.join(p, "nvidia", "*", "lib")
                 for p in site.getsitepackages()]
    libs = sorted({x for d in lib_dirs
                   for x in glob.glob(os.path.join(d, "libnvjpeg.so*"))})
    return (f"nvjpeg.h {heads or 'not found'}; libnvjpeg {libs or 'not found'}"
            f"; find_library {ctypes.util.find_library('nvjpeg')}")


def _port_flops() -> dict:
    """The port's utils/flops counts per sample, by FLOPS_PER_SAMPLE's
    keys."""
    from bioscan_clip_tpu_torch.utils import flops

    vit, dna = flops.vit_b16(), flops.barcode_bert()
    return {"plain": flops.flagship_train_flops_per_sample("plain"),
            "gradcache": flops.flagship_train_flops_per_sample("gradcache"),
            "extract": flops.flagship_fwd_flops_per_sample(),
            "vit_full": vit.train_full(),
            "joint_full": vit.train_full() + dna.train_full()}


def _mfu(what, ms, samples, kind):
    """Log the model-FLOPs utilization of `samples` samples in `ms` by the
    port's count `kind` (FLOPS_PER_SAMPLE's keys: recomputation is not
    model work), against the bf16 dense peak, beside the card's name and
    power limit; returns it."""
    from bioscan_clip_tpu_torch.utils import flops

    per = _port_flops()[kind]
    m = flops.mfu(samples / (ms / 1e3), per)
    log(f"  MFU {what}: {samples} samples in {ms:.1f} ms x "
        f"{per / 1e9:.2f} GFLOP ({kind}) = {100 * m:.2f}% of "
        f"{flops.PEAK_TFLOPS['h100_bf16']:.0f} TFLOP/s bf16 ({card_line()})")
    return m


def _libjpeg() -> str:
    """Whether libjpeg is on the machine that runs this script, for the
    native JPEG decode pool (native/bscan_io.cc): jpeglib.h under the CUDA
    toolkit's or the system's include paths, and the shared library by
    ctypes.util.find_library. A report, never a failure."""
    import ctypes.util
    import glob
    import os

    dirs = ["/usr/local/cuda/include", "/usr/local/cuda/targets/*/include",
            "/usr/include", "/usr/include/*-linux-gnu", "/usr/local/include"]
    headers = sorted({h for d in dirs
                      for h in glob.glob(os.path.join(d, "jpeglib.h"))})
    return (f"jpeglib.h {headers or 'not found'}; libjpeg.so "
            f"{ctypes.util.find_library('jpeg') or 'not found'}")


def phase_build():
    from bioscan_clip_tpu_torch.ops import _build
    from bioscan_clip_tpu_torch.ops import topk as topk_mod

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
                k4 = re.search(r"topk_f32_pass1ILi(\d+)ELi(\d+)ELi(\d+)E",
                               fn)
                if k4:  # K4's, by list size, query block and products
                    smem = topk_mod._kernel().smem_f32(int(k4[2]),
                                                       int(k4[1]), int(k4[3]))
                    log(f"  K4 pass 1 MAXK={k4[1]} QB={k4[2]} "
                        f"TERMS={k4[3]}: {ln.split(':', 1)[-1].strip()}; "
                        f"{spills}; {smem} bytes of dynamic shared memory")
                k5 = re.search(r"topk_i8_pass1ILi(\d+)ELi(\d+)E", fn)
                if k5:  # K5's instantiations, by list size and query block
                    log(f"  K5 pass 1 MAXK={k5[1]} QB={k5[2]}: "
                        f"{ln.split(':', 1)[-1].strip()}; {spills}")
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


def _topk_case(gen, n=1 << 20, d=768, k=5, bqs=(256, 64, 16, 1),
               rising_bq=256):
    """K4 in "high" and "default" precision at each query count of `bqs`
    over n unit keys, and at `rising_bq` over keys u * (1 + i / n) whose
    scores rise with the index for queries near u (every score passes the
    screen): each against its plain version (_topk_row). Returns the keys
    and the rows of "high" and "default" at the first query count."""
    import torch

    dev = torch.device("cuda")
    keys = torch.randn(n, d, device=dev, generator=gen)
    keys /= keys.norm(dim=1, keepdim=True)
    q = torch.randn(max(bqs), d, device=dev, generator=gen)
    q /= q.norm(dim=1, keepdim=True)
    u = torch.randn(1, d, device=dev, generator=gen)
    u /= u.norm()
    keys_r = u * (1 + torch.arange(n, device=dev,
                                   dtype=torch.float32)[:, None] / n)
    q_r = u + 0.1 * torch.randn(rising_bq, d, device=dev, generator=gen)
    q_r /= q_r.norm(dim=1, keepdim=True)
    cases = [(f"Bq={bq}", q[:bq].contiguous(), keys) for bq in bqs]
    cases.append((f"Bq={rising_bq} rising scores", q_r, keys_r))
    rows = {}
    for precision in ("high", "default"):
        for what, qq, kk in cases:
            row, idx = _topk_row(qq, kk, k, precision, what)
            rows.setdefault(precision, row)
            if kk is keys_r and precision == "high" and not (
                    idx[:, 0] == n - 1).all():
                raise AssertionError("topk rising scores: top-1 is not the "
                                     "last key")
    del keys_r, q_r, cases
    torch.cuda.empty_cache()
    return keys, rows["high"], rows["default"]


def _topk_row(q, keys, k, precision, what):
    """K4 at one shape against its plain version: values within 1e-5 (unit
    rows; "high" is the six-product bf16 split, "default" exact bf16
    products, both summed in fp32 in another order than the plain
    version's), index sets equal except for keys whose float64 scores over
    the operands as the precision sees them lie within 1e-5 of the k-th
    value (a near-tie that summation order may break either way), and a
    second launch bit-equal to the first; timed beside the plain version,
    torch.topk over the product of the operands as the precision sees them
    (fp32, or bf16 cast before the timing) and the bound: the keys' bytes
    against the products on the tensor cores (six for "high"), with FFMA's
    time for "high" in the log line. Returns (row, kernel indices)."""
    import torch

    from bioscan_clip_tpu_torch.ops import topk as topk_mod

    n, d = keys.shape
    bq = q.shape[0]
    vals, idx = topk_mod.topk(q, keys, n, k, precision=precision)
    v2, i2 = topk_mod.topk(q, keys, n, k, precision=precision)
    torch.cuda.synchronize()
    if not (torch.equal(vals, v2) and torch.equal(idx, i2)):
        raise AssertionError(f"topk {precision} {what}: two launches differ")
    rv, ri = topk_mod.topk_reference(q, keys, n, k, precision=precision)
    err = (vals - rv).abs().max().item()
    if not err <= 1e-5:
        raise AssertionError(f"topk {precision} {what}: max |kernel - plain| "
                             f"{err} > 1e-5")
    if precision == "default":
        ql, kl = q.to(torch.bfloat16), keys.to(torch.bfloat16)
    else:
        ql, kl = q, keys
    for r in range(bq):
        a, bset = set(idx[r].tolist()), set(ri[r].tolist())
        if a != bset:
            diff = sorted(a ^ bset)
            sc = ql[r].double() @ kl[diff].double().T
            if (sc - rv[r, -1].double()).abs().max().item() > 1e-5:
                raise AssertionError(f"topk {precision} {what} row {r}: "
                                     f"{sorted(a)} vs {sorted(bset)}")
    n_bytes = n * d * 4 + bq * d * 4 + bq * k * 8
    products = 6 if precision == "high" else 1
    bms, by = bound_ms(n_bytes, 2 * products * bq * n * d, "bfloat16")
    row = {
        "ms": time_ms(lambda: topk_mod.topk(q, keys, n, k,
                                            precision=precision),
                      reps=5, warmup=1),
        "plain_ms": time_ms(lambda: topk_mod.topk_reference(
            q, keys, n, k, precision=precision), reps=2, warmup=1),
        "library_ms": time_ms(lambda: torch.topk(ql @ kl.T, k, dim=1),
                              reps=5, warmup=1),
        "bound_ms": bms, "bound_by": by, "max_abs_err": err,
    }
    del ql, kl
    qb, splits, _, _ = topk_mod.plan_f32(bq, n, k, q.device)
    ffma = (f", FFMA {1e3 * 2 * bq * n * d / PEAK['float32']:.4f} ms"
            if precision == "high" else "")
    log(f"  topk {precision} {what} N={n} D={d} k={k} (query block {qb}, "
        f"{splits} key splits): err {err:.3g} (tol 1e-5), two launches "
        f"bit-equal, kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, torch.topk "
        f"{row['library_ms']:.4f} ms, bound {bms:.4f} ms ({by}{ffma})")
    return row, idx


def _topk_i8_case(gen, n, bqs, d=768, k=21, codes_on_card=False,
                  rising_bq=None):
    """K5 against its plain version, values and indices bit for bit, at
    each query count of `bqs`; timed beside torch._int_mm + the two scales
    + torch.topk (Bq padded to 32 rows, as _int_mm needs more than 16).
    With `rising_bq`, one more row: collinear keys whose scales rise with
    the index, so every query's scores rise along the key axis (each tile
    beats the last: the worst case of K5's running threshold). Returns the
    row of the first query count."""
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
    cases = [(f"Bq={bq}", qc_all[:bq].contiguous(), qs_all[:bq].contiguous(),
              kc, ks) for bq in bqs]
    if rising_bq:
        u = torch.randn(1, d, device=dev, generator=gen)
        uc, us = quantize(u)
        noise = 0.1 * torch.randn(rising_bq, d, device=dev, generator=gen)
        qc_r, qs_r = quantize(u + noise)
        ks_r = us * (1 + torch.arange(n, device=dev, dtype=torch.float32) / n)
        cases.append((f"Bq={rising_bq} rising scores", qc_r, qs_r,
                      uc.expand(n, d).contiguous(), ks_r))
    first = None
    for what, qc, qs, kk, kks in cases:
        bq = qc.shape[0]
        v, i = topk_mod.topk_i8(qc, qs, kk, kks, n, k)
        torch.cuda.synchronize()
        rv, ri = topk_mod.topk_i8_reference(qc, qs, kk, kks, n, k)
        if not (torch.equal(v, rv) and torch.equal(i, ri)):
            raise AssertionError(f"topk_i8 N={n} {what}: kernel != plain "
                                 f"(max |dv| {(v - rv).abs().max().item()})")
        qp = torch.zeros(max(32, -(-bq // 8) * 8), d, device=dev,
                         dtype=torch.int8)
        qp[:bq] = qc

        def library():
            s = torch._int_mm(qp, kk.T)[:bq].to(torch.float32)
            return torch.topk((s * qs[:, None]) * kks[None, :], k, dim=1)

        lib_same = torch.equal(library().values, v)
        n_bytes = n * d + 4 * n + bq * d + 4 * bq + bq * k * 8
        bms, by = bound_ms(n_bytes, 2 * bq * n * d, "int8")
        row = {
            "ms": time_ms(lambda: topk_mod.topk_i8(qc, qs, kk, kks, n, k),
                          reps=5, warmup=1),
            "plain_ms": time_ms(lambda: topk_mod.topk_i8_reference(
                qc, qs, kk, kks, n, k), reps=2, warmup=1),
            "library_ms": time_ms(library, reps=5, warmup=1),
            "bound_ms": bms, "bound_by": by, "max_abs_err": 0.0,
        }
        qb, splits, _, _ = topk_mod.plan_i8(bq, n, d, k, dev)
        log(f"  topk_i8 {what} N={n} D={d} k={k} (query block {qb}, "
            f"{splits} key splits): bit-equal to plain, kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"_int_mm+topk {row['library_ms']:.4f} ms (values equal: "
            f"{lib_same}), bound {bms:.4f} ms ({by})")
        first = first or row
    del kc, ks, cases
    torch.cuda.empty_cache()
    return first


def _mm_only_case(gen, keys, bqs=(1, 256)):
    """K6 against its plain version at each query count over `keys`: fp32
    "high" (K4's six bf16 products) and "default" within 1e-5 (unit
    vectors, 768 products summed in another order), int8 bit for bit; timed
    beside one library call: (q @ k.T).amax in fp32 ("high"), in bf16
    ("default", operands cast before the timing), torch._int_mm + amax
    (int8, Bq padded to 32 rows). Bounds: the bytes against the products on
    the tensor cores (six for "high"). Returns the rows of fp32 "high" at
    the largest Bq."""
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
            "high": (q, keys, dict(), "bfloat16", 6,
                     lambda: (q @ keys.T).amax(dim=1)),
            "default": (q, keys, dict(precision="default"), "bfloat16", 1,
                        lambda: (q16 @ k16.T).amax(dim=1)),
            "int8": (qc, kc, dict(int8=True), "int8", 1,
                     lambda: torch._int_mm(qp, kc.T)[:bq].amax(dim=1)),
        }
        for mode, (qq, kk, kw, dname, products, library) in cases.items():
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
            bms, by = bound_ms(n_bytes, 2 * products * bq * n * d, dname)
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
    _dropout_readout(b, n, heads, hd, dtype, seeds, rate)

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


def _dropout_readout(b, n, heads, hd, dtype, seeds, rate):
    """K2d's keep mask read out through the output: q = k = 0 makes p =
    float32(1 / n) exactly, and v's row j in every head is the unit vector
    e_j of that head's dims (n <= hd), so o[i, hd h + j] = dtype(float32(1
    / n) * keep(i, j)), bit for bit, against `dropout_keep_4d`."""
    import torch

    from bioscan_clip_tpu_torch.ops import attention

    if n > hd:
        return
    q = torch.zeros(b, n, heads * hd, device="cuda", dtype=dtype)
    v = torch.zeros_like(q)
    j = torch.arange(n, device="cuda")
    for h in range(heads):
        v[:, j, h * hd + j] = 1.0
    out = attention.mha_dropout(q, q, v, heads, seeds, rate)
    keep = attention.dropout_keep_4d(seeds, b, heads, n, rate, device="cuda")
    want = (torch.tensor(1.0, device="cuda") / n * keep).to(dtype)
    got = out.view(b, n, heads, hd).permute(0, 2, 1, 3)
    if not (torch.equal(got[..., :n], want) and not got[..., n:].any()):
        raise AssertionError(f"mha_dropout {dtype} B={b} N={n}: the keep "
                             "mask does not read out bit for bit")
    log(f"  mha_dropout {str(dtype).split('.')[-1]} B={b} N={n} h={heads}: "
        f"keep mask read out bit for bit ({int((keep == 0).sum())} of "
        f"{keep.numel()} dropped)")


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
    again = kernel()
    torch.cuda.synchronize()
    pairs = zip((out,), (again,)) if packed else zip(out, again)
    if not all(a is None or torch.equal(a, a2) for a, a2 in pairs):
        raise AssertionError(f"{name}: two launches are not bit-equal")
    del again
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
        f"(tol {tol:g}), two launches bit-equal, kernel {row['ms']:.4f} ms, "
        f"plain "
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
        # the bf16 tensor-core body's keep mask (above N = 32)
        _dropout_readout(TRAIN_BATCH, 64, 8, 64, dtype,
                         _seeds(TRAIN_BATCH, gen), 0.1)
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
    keys, rows["topk"], rows["topk_default"] = _topk_case(gen)
    rows["mm_only"] = _mm_only_case(gen, keys)
    del keys
    torch.cuda.empty_cache()
    rows["topk_i8"] = _topk_i8_case(gen, N_KEYS, (256, 64, 16, 1),
                                    rising_bq=256)
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
    "topk_default": ("cuda", "bioscan_clip_tpu_torch/csrc/topk.cu",
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
# the main paths that launch each kernel: the first gives its `launches`
# in that line, every one its count in `launches_by_path`
KERNEL_PATH = {"mha_packed": ("serving", "graphs", "insect", "data_tools"),
               "mha": ("serving", "insect", "data_tools"),
               "topk": ("serving", "insect", "data_tools"),
               "topk_i8": ("eval",),
               "topk_default": ("eval",),
               "mha_dropout": ("training", "graphs", "insect"),
               "mha_bwd": ("training", "graphs", "insect"),
               "mha_packed_mask": ("openclip", "graphs"),
               "mha_bwd_mask": ("openclip_training", "graphs"),
               "mm_only": ("probe",), "tiny": ("probe",)}


def launch_counts():
    from bioscan_clip_tpu_torch.ops import attention, topk

    return {"mha_packed": attention.mha_packed.launches,
            "mha_packed_mask": attention.mha_packed.mask_launches,
            "mha": attention.mha.launches,
            "mha_dropout": attention.mha_dropout.launches,
            "mha_bwd": attention.mha_bwd.launches,
            "mha_bwd_mask": attention.mha_bwd.mask_launches,
            "topk": topk.topk.launches,
            "topk_default": topk.topk.default_launches,
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
    topk.topk.default_launches = 0
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
    batch and grouped, then the 5 x 6 sweep runs in high, default and int8
    precision on the card. Checks: grouped equals per-batch within bf16
    tolerance; the card's sweep equals the same sweep on the CPU over the
    same embeddings (high and default up to near-ties, int8 exactly); int8
    top-1 agrees with high on >= 99% of the queries; K1, K2, K4 in high and
    default precision and K5 launched and no plain version ran. Returns the
    launch counts of the card's run."""
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
            how = "per batch" if group == 0 else "grouped"
            t = time.perf_counter()
            out[name] = _timed(
                f"extract_features {name} x{n_rows} ({how})",
                lambda: extract_features(model, batches,
                                         for_key_set=name == "keys",
                                         group_samples=group))
            if name == "keys":
                ms = 1e3 * (time.perf_counter() - t)
                log(f"  extract_features keys ({how}): "
                    f"{1e3 * n_rows / ms:.1f} records/s (host clock)")
                _mfu(f"extract_features keys ({how})", ms, n_rows,
                     "extract")
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
    for precision in ("high", "default", "int8"):
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
    want = ("mha_packed", "mha", "topk", "topk_default", "topk_i8")
    if any(counts[k] <= 0 for k in want) or any(plain.values()):
        raise AssertionError(f"eval: launches {counts}, plain {plain}")

    for precision in ("high", "default", "int8"):
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
        if precision in ("high", "default"):
            ties = _searches_agree(splits, precision)
            if not same and not ties:
                raise AssertionError(f"sweep {precision}: the card's "
                                     "accuracy differs from the CPU's with "
                                     "no near-tie to explain it")
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


def _searches_agree(splits, precision, k=5, tie=1e-5):
    """Every fp32-key search of the sweep in `precision` ("high" or
    "default"), K4 on the card against its plain version on the CPU: a
    position may hold another key only when the two keys' float64 scores
    are within `tie`. K4 sums the 768 products in order, the CPU's BLAS in
    blocks; for scores near 1 the two differ by up to ~1e-6 (the fp32 error
    bound of such a dot is 768 * 2^-24 ~ 4.6e-5), and the DNA tower's
    random-weight embeddings lie within cosine 0.998 of each other, so
    near-ties abound. In "default" both sides sum the same exact products
    of bf16-rounded operands, so the float64 scores are those of the
    rounded operands and the tie width is the same 1e-5 of fp32 summation.
    Returns the rows that differ."""
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
        on_card = PreparedKeys(kf, device="cuda", precision=precision)
        on_cpu = PreparedKeys(kf, device="cpu", precision=precision)
        kn = _as_scored(l2norm_np(kf), precision)
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
                    sc = kn @ _as_scored(qn[r], precision)
                    pos = ic[r] != ih[r]
                    gap = np.abs(sc[ic[r][pos]] - sc[ih[r][pos]]).max()
                    if gap > tie:
                        raise AssertionError(
                            f"sweep high {qt} x {kt} {split} row {r}: card "
                            f"{ic[r]} vs cpu {ih[r]}, score gap {gap}")
                    differ += 1
    log(f"  sweep {precision}: K4 on the card vs the CPU over {rows} "
        f"searches: {differ} rows differ, each only by keys within {tie:g} "
        "of each other (near-ties)")
    return differ


def _as_scored(x, precision):
    """float64 operands as the product sees them: rounded to bf16 first
    in "default" precision."""
    import numpy as np
    import torch

    if precision == "default":
        x = torch.from_numpy(np.ascontiguousarray(x)).bfloat16().float()
        x = x.numpy()
    return np.asarray(x, dtype=np.float64)


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

    groups = (("K3/K3m mha_bwd pass A", ("bwd_query_rows",)),
              ("K3/K3m mha_bwd pass B + C", ("bwd_key_rows",
                                             "dbias_sum_heads")),
              ("K1/K1m/K2d mha_fwd", ("mha_fwd_kernel", "mha_fwd_mma")),
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
    _mfu(f"training, the plain step at B={TRAIN_BATCH} (steps 2-"
         f"{TRAIN_STEPS} mean)", float(np.mean(step_ms[1:])), TRAIN_BATCH,
         "plain")
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


# train_cl phase: the flagship's training entry point at full width
TRAIN_CL_STEPS = 3       # tpu.max_steps_per_epoch
TRAIN_CL_EPOCHS = 2
TRAIN_CL_ACCUM = 4       # GradCache 4 x 100
TRAIN_CL_S1_CHUNK = 200  # tpu.gc_s1_chunk
N_CL_KEYS, N_CL_SEEN, N_CL_UNSEEN = 480, 240, 240


class _MemoryLoader:
    """A train loader over batches held in memory: len, iteration and the
    epoch setter the CLI calls."""

    def __init__(self, batches):
        self.batches, self.epoch = batches, 0

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)

    def set_epoch(self, epoch):
        self.epoch = epoch


def _train_cl_batch(rng, b, frame_hw=EVAL_FRAME):
    """A train batch as the loader ships it with `tpu.train_crop` off:
    (b, 256, 341, 3) uint8 frames (tiled, as `_train_batch`), 658-bp
    barcodes through the DNA tokenizer, 20-token text, instance labels."""
    import numpy as np

    rec = _eval_records(rng, b, frame_hw)
    return {"image_u8": rec["image_u8"], "dna": rec["dna"].astype(np.int64),
            "language": {k: v.astype(np.int64)
                         for k, v in rec["language"].items()},
            "labels": np.arange(b)}


def _train_cl_args(root, **tpu):
    from bioscan_clip_tpu_torch.config.core import ConfigNode

    mc = dict(FLAGSHIP, batch_size=TRAIN_BATCH, epochs=TRAIN_CL_EPOCHS,
              evaluation_period=1, model_output_name="train_cl")
    return ConfigNode({
        "model_config": mc, "project_root_path": str(root),
        "model_output_dir": "ckpt", "save_ckpt": True, "debug_flag": False,
        "activate_wandb": False, "save_inference": False, "device": "cuda",
        "inference_and_eval_setting": {"k_list": [1, 3, 5],
                                       "retrieval_precision": "high"},
        "tpu": dict({"frozen_dtype": "bfloat16"}, **tpu)})


def _step_grads(args, batch, factory, seed=0x7E57, reps=1, merged=False,
                **kw):
    """`reps` steps of a fresh flagship model (seeded weights, frozen
    weights in bf16; `merged`: a rank-0 model for GradCache's stage 1) ->
    (losses, trainable grads of the last step, card ms per step (CUDA
    events, steps after the first), peak GiB, state, step, device batch)."""
    import torch

    from bioscan_clip_tpu_torch.models.clip import load_clip_model
    from bioscan_clip_tpu_torch.train.loop import device_batch
    from bioscan_clip_tpu_torch.train.schedules import constant
    from bioscan_clip_tpu_torch.train.state import (
        cast_frozen_params,
        create_train_state,
    )

    torch.cuda.empty_cache()
    model = load_clip_model(args, device="cuda", dtype=torch.bfloat16)
    cast_frozen_params(model)
    state = create_train_state(model, constant(1e-4))
    if merged:
        kw["merged_model"] = load_clip_model(args, device="cuda",
                                             dtype=torch.bfloat16,
                                             lora_rank=0)
    step = factory(model, **kw)
    b = device_batch(batch, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(reps):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        state, loss = step(state, b, seed)
        ev[1].record()
        times.append(ev)
        losses.append(loss)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = [a.elapsed_time(z) for a, z in times]
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters() if p.requires_grad}
    return ([x.item() for x in losses], grads,
            sum(ms[1:]) / (len(ms) - 1) if len(ms) > 1 else ms[0], peak,
            state, step, b)


def _grad_rel_err(g, ref):
    """(||g - ref|| / ||ref|| over the whole trainable set, the worst
    tensor's max |g - ref| / max |ref|, that tensor's name)."""
    num = sum(float((g[n] - r).square().sum()) for n, r in ref.items())
    den = sum(float(r.square().sum()) for r in ref.values())
    worst = max(((g[n] - r).abs().max().item()
                 / max(r.abs().max().item(), 1e-30), n)
                for n, r in ref.items())
    return (num / max(den, 1e-60)) ** 0.5, *worst


def phase_train_cl():
    """The training entry point a user runs, cli/train_cl.run, at full
    width on the card: the flagship (random seeded weights, bf16, frozen
    weights in bf16, dropout 0.1) at its B = 400, GradCache 4 x 100 with
    the merged stage 1 and `gc_s1_chunk` 200, the device augmentation from
    (256, 341) uint8 frames, 2 epochs of 3 steps, the eval phase after each
    (480 keys, 240 seen, 240 unseen records), `last`, `best` and
    `config.yaml` under the repo's git-ignored build/. The loaders are in
    memory (the card's machine has no h5py): `load_dataloader` in the CLI's
    namespace gives them. Checks: finite losses; frozen weights unchanged,
    adapters and heads moved; the files written; a second run resumed from
    `last` as it stood after epoch 0 repeats epoch 1's losses bit for bit;
    K1, K2d, K3, K2 and K4 launched and no plain version. Then, outside the
    CLI: one step at B = 400 under per-layer remat ("full", "dots") against
    the step without it; the GradCache step's gradients against the plain
    step's; the device augmentation on the card against the CPU. Returns
    the launch counts of the first CLI run."""
    import math
    import shutil
    from pathlib import Path

    import numpy as np
    import torch

    import bioscan_clip_tpu_torch.models.clip as clip_mod
    import bioscan_clip_tpu_torch.retrieval.report as report_mod
    import bioscan_clip_tpu_torch.train.loop as loop_mod
    from bioscan_clip_tpu_torch.cli import train_cl
    from bioscan_clip_tpu_torch.data import transforms
    from bioscan_clip_tpu_torch.train.checkpoint import wait_for_checkpoints

    torch.cuda.empty_cache()
    log("  " + card_line())
    rng = np.random.default_rng(10)
    t0 = time.perf_counter()
    train = _MemoryLoader([_train_cl_batch(rng, TRAIN_BATCH)
                           for _ in range(TRAIN_CL_STEPS)])
    keys_rec = _eval_records(rng, N_CL_KEYS, EVAL_FRAME)
    seen = _batches(_eval_records(rng, N_CL_SEEN, EVAL_FRAME, like=_take(
        keys_rec, np.arange(N_CL_SEEN))), N_CL_SEEN)
    unseen = _batches(_eval_records(rng, N_CL_UNSEEN, EVAL_FRAME, snps=4,
                                    like=_take(keys_rec, np.arange(
                                        N_CL_KEYS - N_CL_UNSEEN,
                                        N_CL_KEYS))), N_CL_UNSEEN)
    keys = _batches(keys_rec, N_CL_KEYS)
    log(f"  synthetic data: {1e3 * (time.perf_counter() - t0):.0f} ms")
    root = Path("build") / "chip_smoke_train_cl"
    shutil.rmtree(root, ignore_errors=True)
    args = _train_cl_args(root, accum_steps=TRAIN_CL_ACCUM,
                          gradcache_merged=True, gc_s1_chunk=TRAIN_CL_S1_CHUNK,
                          max_steps_per_epoch=TRAIN_CL_STEPS)

    built, eval_s = {}, {"s": 0.0}
    real_load = clip_mod.load_clip_model
    real_extract = loop_mod.extract_features
    real_sweep = report_mod.inference_and_print_result

    def load(*a, **kw):
        model = real_load(*a, **kw)
        if kw.get("lora_rank") is None:  # the trained model, not stage 1's
            built["model"] = model
            built["init"] = {n: p.detach().clone()
                             for n, p in model.named_parameters()}
        return model

    def timed(fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            eval_s["s"] += time.perf_counter() - t
            return out
        return call

    copy = root / "after_epoch_0"
    lines = []

    def out(line):
        lines.append(line)
        if not line.startswith(("Initialize", "Construct")) and (
                "ckpt" in line or line.startswith("epoch")
                or "Resumed" in line or "merged" in line):
            log(f"    | {line}")
        if line.startswith("Last ckpt: ") and not copy.exists():
            wait_for_checkpoints()  # `last` as it stood after epoch 0
            copy.mkdir(parents=True)
            shutil.copy(line[len("Last ckpt: "):], copy / "last")

    def losses_of(lns, epoch):
        prefix = f"epoch {epoch} losses "
        return [float(x) for x in next(
            ln[len(prefix):] for ln in lns if ln.startswith(prefix)
        ).strip("[]").split(",")]

    real_loaders = train_cl.load_dataloader
    train_cl.load_dataloader = lambda a, **kw: (train, seen, unseen, keys)
    clip_mod.load_clip_model = load
    loop_mod.extract_features = timed(real_extract)
    report_mod.inference_and_print_result = timed(real_sweep)
    try:
        reset_counts()  # the train_cl path's launches are counted from here
        t = time.perf_counter()
        state, best = train_cl.run(args, out=out)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        counts, plain = launch_counts(), plain_calls()
        eval_1 = eval_s["s"]
        first = [losses_of(lines, e) for e in range(TRAIN_CL_EPOCHS)]
        model, init = built["model"], built["init"]
        labels = state.labels
        frozen = [n for n, lab in labels.items() if lab == "frozen"]
        params = dict(model.named_parameters())
        moved = [n for n in frozen if not torch.equal(
            params[n], init[n].to(params[n].dtype))]
        still = [n for n, lab in labels.items()
                 if lab != "frozen" and torch.equal(params[n], init[n])]
        folder = Path(next(ln for ln in lines if ln.startswith(
            "Last ckpt: "))[len("Last ckpt: "):]).parent
        files = sorted(p.name for p in folder.iterdir())
        rates = [ln for ln in lines if re.match(r"epoch \d+: ", ln)]
        log(f"  train_cl run: {run_s:.1f} s for {TRAIN_CL_EPOCHS} epochs of "
            f"{TRAIN_CL_STEPS} steps at B={TRAIN_BATCH} (GradCache "
            f"{TRAIN_CL_ACCUM} x {TRAIN_BATCH // TRAIN_CL_ACCUM}); eval phase "
            f"{eval_1:.1f} s in all ({eval_1 / TRAIN_CL_EPOCHS:.1f} s per "
            f"eval); {rates}; best {best:.4f}; files {files}")
        log(f"  losses by epoch: {first}")
        log(f"  launches on the train_cl path: {counts}; plain calls {plain}")
        del state, model, init, params, built["model"], built["init"]
        torch.cuda.empty_cache()

        resumed = []
        args2 = _train_cl_args(root, accum_steps=TRAIN_CL_ACCUM,
                               gradcache_merged=True,
                               gc_s1_chunk=TRAIN_CL_S1_CHUNK,
                               max_steps_per_epoch=TRAIN_CL_STEPS)
        args2["resume"] = str(copy)
        args2["save_ckpt"] = False
        state2, _ = train_cl.run(args2, out=resumed.append)
        again = losses_of(resumed, 1)
        log(f"  resumed from `last` after epoch 0: epoch 1 losses {again} vs "
            f"{first[1]}: bit-equal {again == first[1]}")
        del state2
        built.clear()
    finally:
        train_cl.load_dataloader = real_loaders
        clip_mod.load_clip_model = real_load
        loop_mod.extract_features = real_extract
        report_mod.inference_and_print_result = real_sweep
        wait_for_checkpoints()
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    if not all(math.isfinite(x) for ep in first for x in ep):
        raise AssertionError(f"train_cl: losses {first}")
    if moved or still:
        raise AssertionError(f"train_cl: frozen moved {moved[:3]}, "
                             f"trainable still {still[:3]}")
    if not {"last", "best", "config.yaml"} <= set(files):
        raise AssertionError(f"train_cl: run folder holds {files}")
    if again != first[1]:
        raise AssertionError(f"train_cl resume: {again} vs {first[1]}")
    want = ("mha_packed", "mha_dropout", "mha_bwd", "mha", "topk")
    if any(counts[k] <= 0 for k in want) or any(plain.values()):
        raise AssertionError(f"train_cl: launches {counts}, plain {plain}")

    # ---- outside the CLI: remat, GradCache against the plain step
    from bioscan_clip_tpu_torch.train.loop import (
        make_gradcache_train_step,
        make_train_step,
    )

    batch = train.batches[0]
    plain_args = _train_cl_args(root)
    l0, g0, ms0, peak0, st, step, b = _step_grads(plain_args, batch,
                                                  make_train_step, reps=3)
    del st, step, b
    log(f"  plain step: {ms0:.1f} ms (CUDA events, steps 2-3), peak "
        f"{peak0:.2f} GiB, samples/s {1e3 * TRAIN_BATCH / ms0:.1f}")
    _mfu("train_cl, the plain step", ms0, TRAIN_BATCH, "plain")
    for policy in ("full", "dots"):
        r_args = _train_cl_args(root, remat=True, remat_policy=policy)
        lr, gr, msr, peakr, st, step, b = _step_grads(
            r_args, batch, make_train_step, reps=3)
        del st, step, b
        norm, rel, name = _grad_rel_err(gr, g0)
        drel = abs(lr[0] - l0[0]) / abs(l0[0])
        log(f"  remat {policy}: {msr:.1f} ms (CUDA events), peak "
            f"{peakr:.2f} GiB, samples/s {1e3 * TRAIN_BATCH / msr:.1f}; loss "
            f"{lr[0]:.7f} vs {l0[0]:.7f} (rel {drel:.3g}), grads rel "
            f"{norm:.3g} (norm), worst tensor {rel:.3g} ({name}) (tol: loss "
            "1e-3, grads 2e-2 max, bf16)")
        _mfu(f"train_cl, remat {policy}", msr, TRAIN_BATCH, "plain")
        if not (drel <= 1e-3 and rel <= 2e-2):
            raise AssertionError(f"remat {policy}: loss {drel}, grads {rel}")
    lg, gg, msg, peakg, st, step, b = _step_grads(
        plain_args, batch, make_gradcache_train_step, reps=3,
        merged=True, accum_steps=TRAIN_CL_ACCUM,
        s1_chunk=TRAIN_CL_S1_CHUNK)
    norm, rel, name = _grad_rel_err(gg, g0)
    drel = abs(lg[0] - l0[0]) / abs(l0[0])
    log(f"  GradCache {TRAIN_CL_ACCUM} x {TRAIN_BATCH // TRAIN_CL_ACCUM} "
        f"(merged stage 1, s1_chunk {TRAIN_CL_S1_CHUNK}): {msg:.1f} ms (CUDA "
        f"events), peak {peakg:.2f} GiB, samples/s "
        f"{1e3 * TRAIN_BATCH / msg:.1f}; loss rel {drel:.3g}; grads against "
        f"the plain step: rel {norm:.3g} (norm; tol 5e-2, bf16), worst "
        f"tensor max rel {rel:.3g} ({name})")
    _mfu(f"train_cl, GradCache {TRAIN_CL_ACCUM} x "
         f"{TRAIN_BATCH // TRAIN_CL_ACCUM}", msg, TRAIN_BATCH, "gradcache")
    # bf16: stage 1's embeddings (merged weights, chunks of 200) differ from
    # the recompute's by ~2^-8, which the logit scale 1/0.07 turns into a
    # few percent of the softmax; fp32 is exact to 1e-4 (tests/
    # test_torch_gpu.py) and to 1e-5 on the CPU (tests/test_torch_gradcache.py)
    if not (drel <= 1e-3 and norm <= 5e-2):
        raise AssertionError(f"GradCache vs plain: loss {drel}, grads {rel}")
    _profile_step(st, step, batch)
    del st, step, b
    torch.cuda.empty_cache()

    # ---- the device augmentation on the card against the CPU
    u8 = torch.from_numpy(batch["image_u8"][:32])
    aug = transforms.draw_train_aug(0xA11CE, u8.shape[0], EVAL_FRAME,
                                    jitter=True)
    out_c = transforms.train_transform(u8.cuda(), aug, normalize=True,
                                       jitter=True).cpu()
    ref = transforms.train_transform(u8, aug, normalize=True, jitter=True)
    err = (out_c - ref).abs().max().item()
    log(f"  train_transform {EVAL_FRAME} -> 224, normalize + jitter: max "
        f"|card - cpu| {err:.3g} (tol 1e-5)")
    if not err <= 1e-5:
        raise AssertionError(f"train_transform card vs cpu: {err}")
    log("phase train_cl ok")
    return counts


# ---------------------------------------------------------------- insect

# INSECT (Badirli et al., NeurIPS 2021): 1,213 species, 797 seen and 416
# unseen; the fine-tunes' batch (config/global_config.yaml:78)
INSECT_SEEN, INSECT_UNSEEN = 797, 416
FT_BATCH = 200
FT_VIT_STEPS, FT_JOINT_STEPS = 4, 3
# the records of res101.mat: 40 seen species x 20 and 25 unseen x 8 (the
# BZSL fit's classes, each a 768-d Student-t), 400 trainval / 400
# test-seen / 200 test-unseen
INSECT_SEEN_CLASSES, INSECT_PER_SEEN = 40, 20
INSECT_UNSEEN_CLASSES, INSECT_PER_UNSEEN = 25, 8
INSECT_CL_BATCH, INSECT_CL_STEPS, INSECT_CL_SPLIT = 400, 2, 240
METHOD_BATCH = 40  # the method CLIs' batch (method_one_eval.py:295)
N_METHOD_KEYS, N_METHOD_SPLIT, METHOD_TRAIN_STEPS = 480, 240, 2


def _insect_species():
    seen = [f"s{i}" for i in range(INSECT_SEEN)]
    return seen, [f"u{i}" for i in range(INSECT_UNSEEN)]


def _insect_mats(root, rng):
    """res101.mat, att_splits.mat (1-based indices), the species JSON and
    a BERT-small-style vocab.txt under `root` -> their paths."""
    import numpy as np
    import scipy.io as sio

    seen, unseen = _insect_species()
    species, labels = [], []
    for c in range(INSECT_SEEN_CLASSES):
        species += [seen[c]] * INSECT_PER_SEEN
        labels += [c + 1] * INSECT_PER_SEEN
    for c in range(INSECT_UNSEEN_CLASSES):
        species += [unseen[c]] * INSECT_PER_UNSEEN
        labels += [INSECT_SEEN_CLASSES + c + 1] * INSECT_PER_UNSEEN
    n = len(species)
    base = {s: b for s, b in zip(sorted(set(species)),
                                 _barcodes(rng, len(set(species))))}
    barcodes = [_mutate(rng, base[s], 4) for s in species]
    ids = [f"INSECT{i:05d}" for i in range(n)]

    def cell(strings):
        return np.array([[np.array([s])] for s in strings], dtype=object)

    sio.savemat(str(root / "res101.mat"), {
        "ids": cell(ids), "nucleotides": cell(barcodes),
        "species": cell(species), "labels": np.array(labels)[:, None]})
    n_seen = INSECT_SEEN_CLASSES * INSECT_PER_SEEN
    row = np.arange(n_seen) % INSECT_PER_SEEN
    one = np.arange(1, n + 1)  # 1-based
    splits = {"train_loc": one[:n_seen][row < 8],
              "val_loc": one[:n_seen][(row >= 8) & (row < 10)],
              "trainval_loc": one[:n_seen][row < 10],
              "test_seen_loc": one[:n_seen][row >= 10],
              "test_unseen_loc": one[n_seen:]}
    sio.savemat(str(root / "att_splits.mat"),
                {k: v[None, :] for k, v in splits.items()})
    s2o = {s: {"order": ORDERS[i % 4], "family": f"{FAMILIES[i % 4]}{i % 40}",
               "genus": f"g{i % 400}"}
           for i, s in enumerate(seen + unseen)}
    with open(root / "specie_to_other_labels.json", "w") as f:
        json.dump(s2o, f)
    (root / "vocab.txt").write_text("\n".join(VOCAB + ["s", "u", "g"]))
    return {"path_to_att_splits_mat": str(root / "att_splits.mat"),
            "path_to_res_101_mat": str(root / "res101.mat"),
            "path_to_image_hdf5": str(root / "unused.hdf5"),
            "species_to_other": str(root / "specie_to_other_labels.json"),
            "vocab": str(root / "vocab.txt")}


def _insect_split(ins, split, rng, frames=True):
    """One INSECT split as `InsectLoader` builds it, from the .mat files
    (`data/insect.py`), with tiled (256, 341) uint8 frames in place of the
    HDF5's JPEGs (the card's machine has no h5py or decoder): a record
    dict for `_take` / `_batches`."""
    from bioscan_clip_tpu_torch.data.insect import (
        load_insect_mat,
        species_list_to_input_string_list,
        species_list_to_labels,
    )
    from bioscan_clip_tpu_torch.data.tokenizers import (
        tokenize_dna_batch,
        tokenize_labels_longest,
    )

    ids, barcodes, species = load_insect_mat(
        ins["path_to_att_splits_mat"], ins["path_to_res_101_mat"], split)
    with open(ins["species_to_other"]) as f:
        s2o = json.load(f)
    rec = {"dna": tokenize_dna_batch(barcodes),
           "language": tokenize_labels_longest(
               species_list_to_input_string_list(species, s2o),
               vocab_path=ins["vocab"]),
           "label_dicts": species_list_to_labels(species, s2o), "ids": ids}
    if frames:
        rec["image_u8"] = _eval_records(rng, len(ids),
                                        EVAL_FRAME)["image_u8"]
    return rec


def _insect_train(rec, rng, b, steps):
    """A train loader over `rec` in InsectLoader's contract: `steps`
    batches of `b` (instance labels indexing `label_dicts`), the rows
    shuffled anew each pass over the split."""
    import numpy as np

    n = len(rec["ids"])
    order = np.concatenate([rng.permutation(n)
                            for _ in range(-(-steps * b // n))])
    batches = []
    for s in range(steps):
        idx = order[s * b:(s + 1) * b]
        batch = _take(rec, idx)
        batches.append({"image_u8": batch["image_u8"], "dna": batch["dna"],
                        "language": batch["language"], "labels": idx})
    loader = _MemoryLoader(batches)
    loader.label_dicts = rec["label_dicts"]
    return loader


def _eval_loader(rec, b):
    import numpy as np

    n = len(rec["ids"])
    return _MemoryLoader([_take(rec, np.arange(s, min(s + b, n)))
                          for s in range(0, n, b)])


def _timed_steps(module, name, times, peaks):
    """Wrap `module.name` (a step factory) so that each step it makes is
    timed by CUDA events into `times` and the peak memory since its first
    step goes into `peaks`."""
    import torch

    real = getattr(module, name)

    def factory(*a, **kw):
        step = real(*a, **kw)

        def timed(state, batch, seed):
            if not times:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = step(state, batch, seed)
            ev[1].record()
            times.append(ev)
            peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            return out

        timed.model = step.model
        return timed

    return factory


def _median_ms(times):
    import statistics

    import torch

    torch.cuda.synchronize()
    ms = [a.elapsed_time(z) for a, z in times]
    return statistics.median(ms[1:] if len(ms) > 1 else ms), ms


def phase_insect():
    """The INSECT path and the supervised fine-tunes at full width on the
    card (random seeded weights, bf16), their loaders in memory in
    `InsectLoader`'s contract (the .mat splits written with
    scipy.io.savemat and read back with `load_insect_mat`; (256, 341)
    uint8 frames in place of the HDF5's JPEGs):
    1. cli/fine_tune_vitb_on_insect.run: ViT-B/16 (`lora_rank=0`) + a
       797-way head, every weight trained, B=200, 4 steps; eval on 400
       test-seen records; the pre-head feature CSV of 1,000 records;
    2. cli/supervised_fine_tune_bioscan_clip_model_on_insect.run: the
       flagship's image and DNA towers + two 797-way heads, B=200, 3 steps;
       eval; the heads and the BZSL CSVs written;
    3. cli/extract_feature_for_insect_dataset.run, then cli/bzsl_eval.run
       on its CSVs;
    4. cli/train_cl.run in INSECT mode: B=400 with ColorJitter, 2 steps,
       the eval phase over the four splits of 240 merged as keys;
    5. cli/method_one_eval.run and cli/method_two_fine_tuning_and_eval.run
       on in-memory BIOSCAN loaders (480 seen keys, 240 per other split),
       method 2's fine-tune 1 epoch of 2 steps, thresholds at 1000
       intervals.
    Checks: finite losses; every ViT parameter moved; the CSV shapes;
    finite BZSL accuracies; K1 and K3 (1), K1, K2d and K3 (2), K1, K2d,
    K3, K2 and K4 (4), K1, K2 and K4 (5) launched and no plain version.
    Prints ms per step and peak GiB of the full-ViT and the joint step.
    Returns the phase's launch counts."""
    import math
    import shutil
    from pathlib import Path

    import numpy as np
    import torch

    import bioscan_clip_tpu_torch.retrieval.report as report_mod
    import bioscan_clip_tpu_torch.train.fine_tuning as ft_mod
    import bioscan_clip_tpu_torch.train.loop as loop_mod
    from bioscan_clip_tpu_torch.cli import (
        bzsl_eval,
        extract_feature_for_insect_dataset as extract_cli,
        fine_tune_vitb_on_insect as vitb_cli,
        method_one_eval as m1_cli,
        method_two_fine_tuning_and_eval as m2_cli,
        supervised_fine_tune_bioscan_clip_model_on_insect as joint_cli,
        train_cl,
    )
    from bioscan_clip_tpu_torch.config.core import ConfigNode

    torch.cuda.empty_cache()
    card = card_line()
    log("  " + card)
    t_phase = time.perf_counter()
    rng = np.random.default_rng(13)
    root = Path("build") / "chip_smoke_insect"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ins = _insect_mats(root, rng)
    trainval = _insect_split(ins, "trainval_loc", rng)
    test_seen = _insect_split(ins, "test_seen_loc", rng)
    everything = _insect_split(ins, "all", rng)
    seen, _ = _insect_species()
    # train_loc as the fine-tunes read it: its species name the classes,
    # 797 as in INSECT (label dicts only: the CLIs read no more of it)
    with open(ins["species_to_other"]) as f:
        s2o = json.load(f)
    key_labels = [dict(s2o[s], species=s) for s in seen]
    train_for_key = _MemoryLoader([{"label_dicts": key_labels[s:s + 200]}
                                   for s in range(0, INSECT_SEEN, 200)])
    log(f"  INSECT splits from the .mat files: trainval "
        f"{len(trainval['ids'])}, test seen {len(test_seen['ids'])}, all "
        f"{len(everything['ids'])} records, {INSECT_SEEN} seen species")

    def args(**extra):
        mc = dict(FLAGSHIP, batch_size=FT_BATCH, evaluation_period=1,
                  model_output_name="insect")
        mc.update(extra.pop("mc", {}))
        return ConfigNode(dict({
            "model_config": mc, "insect_data": ins,
            "general_fine_tune_setting": {"batch_size": FT_BATCH,
                                          "epoch": 1},
            "inference_and_eval_setting": {"k_list": [1, 3, 5],
                                           "retrieval_precision": "high"},
            "project_root_path": str(root), "model_output_dir": "ckpt",
            "save_ckpt": True, "debug_flag": False, "activate_wandb": False,
            "save_inference": False, "device": "cuda",
            "tpu": {"frozen_dtype": "bfloat16"}}, **extra))

    def loaders(train_steps, split_batch=FT_BATCH):
        def insect(a, load_all_in_one=False, **_):
            if load_all_in_one:
                return _eval_loader(everything, split_batch)
            return (None, train_for_key, None,
                    _eval_loader(test_seen, split_batch), None)

        def trainval_loader(a, **_):
            return _insect_train(trainval, rng, FT_BATCH, train_steps)

        return insect, trainval_loader

    def quiet(lines):
        def out(line):
            lines.append(line)
            if line.startswith(("epoch", "Evaluation", "Image Evaluation",
                                "DNA Evaluation", "BZSL", "best threshold",
                                "wrote")) or ".csv" in line:
                log(f"    | {line}")
        return out

    patched = []

    def patch(module, name, value):
        patched.append((module, name, getattr(module, name)))
        setattr(module, name, value)

    counts_by = {}
    reset_counts()  # the insect path's launches are counted from here
    try:
        # ---- 1. the full ViT-B/16 fine-tune
        ins_l, tv_l = loaders(FT_VIT_STEPS)
        patch(vitb_cli, "load_insect_dataloader", ins_l)
        patch(vitb_cli, "load_insect_dataloader_trainval", tv_l)
        vit_times, vit_peaks = [], []
        patch(ft_mod, "make_classifier_train_step", _timed_steps(
            ft_mod, "make_classifier_train_step", vit_times, vit_peaks))
        built = {}
        real_build = vitb_cli.build_classifier

        def build(*a, **kw):
            clf = real_build(*a, **kw)
            built["init"] = {n: p.detach().clone()
                             for n, p in clf.named_parameters()}
            return clf

        patch(vitb_cli, "build_classifier", build)
        lines = []
        t = time.perf_counter()
        before = launch_counts()
        state = vitb_cli.run(args(), out=quiet(lines))
        torch.cuda.synchronize()
        vit_s = time.perf_counter() - t
        counts_by["fine_tune_vitb"] = _delta(before)
        vit_ms, vit_all = _median_ms(vit_times)
        vit_loss = float(next(ln for ln in lines
                              if ln.startswith("epoch 0")).split()[-1])
        still = [n for n, p in state.model.named_parameters()
                 if torch.equal(p, built["init"][n])]
        n_params = sum(p.numel() for p in state.model.parameters())
        heads = state.model.new_linear_layer.out_features
        csv = next(ln for ln in lines if ".csv" in ln).split()[0]
        csv_shape = np.loadtxt(csv, delimiter=",").shape
        log(f"  fine_tune_vitb: {vit_s:.1f} s; {n_params / 1e6:.1f} M "
            f"trainable parameters, {heads}-way head; step at B={FT_BATCH}: "
            f"{vit_ms:.1f} ms (CUDA events, median of steps 2-"
            f"{len(vit_all)}; all {[round(x, 1) for x in vit_all]}), peak "
            f"{vit_peaks[-1]:.2f} GiB ({card}); CSV {csv_shape}")
        _mfu(f"fine_tune_vitb, the full ViT-B/16 step at B={FT_BATCH}",
             vit_ms, FT_BATCH, "vit_full")
        del state, built["init"]
        torch.cuda.empty_cache()

        # ---- 2. the joint image + DNA fine-tune
        ins_l, tv_l = loaders(FT_JOINT_STEPS)
        patch(joint_cli, "load_insect_dataloader", ins_l)
        patch(joint_cli, "load_insect_dataloader_trainval", tv_l)
        joint_times, joint_peaks = [], []
        patch(ft_mod, "make_joint_classifier_train_step", _timed_steps(
            ft_mod, "make_joint_classifier_train_step", joint_times,
            joint_peaks))
        lines = []
        t = time.perf_counter()
        before = launch_counts()
        state = joint_cli.run(args(), out=quiet(lines))
        torch.cuda.synchronize()
        joint_s = time.perf_counter() - t
        counts_by["supervised_fine_tune"] = _delta(before)
        joint_ms, joint_all = _median_ms(joint_times)
        joint_loss = float(next(ln for ln in lines
                                if ln.startswith("epoch 0")).split()[-1])
        joint_csvs = sorted(np.loadtxt(ln.split()[0], delimiter=",").shape
                            for ln in lines if ".csv" in ln)
        joint_files = sorted(p.name for p in (
            root / "ckpt" / "supervised_fine_tune_bioscan_clip_model_on_"
            "insect").glob("*/*"))
        n_params = sum(p.numel() for p in state.model.parameters())
        log(f"  supervised_fine_tune: {joint_s:.1f} s; {n_params / 1e6:.1f} "
            f"M trainable parameters; joint step at B={FT_BATCH}: "
            f"{joint_ms:.1f} ms (CUDA events, median of steps 2-"
            f"{len(joint_all)}; all {[round(x, 1) for x in joint_all]}), "
            f"peak {joint_peaks[-1]:.2f} GiB ({card}); CSVs {joint_csvs}, "
            f"files {joint_files}")
        _mfu(f"supervised_fine_tune, the joint step at B={FT_BATCH}",
             joint_ms, FT_BATCH, "joint_full")
        del state
        torch.cuda.empty_cache()

        # ---- 3. extraction into the BZSL CSVs, then BZSL on them
        patch(extract_cli, "load_insect_dataloader",
              loaders(0, split_batch=200)[0])
        lines = []
        t = time.perf_counter()
        before = launch_counts()
        dna_csv, img_csv = extract_cli.run(args(), out=quiet(lines))
        torch.cuda.synchronize()
        extract_s = time.perf_counter() - t
        counts_by["extract_feature"] = _delta(before)
        dna_shape = np.loadtxt(dna_csv, delimiter=",").shape
        img_shape = np.loadtxt(img_csv, delimiter=",").shape
        t = time.perf_counter()
        bzsl = bzsl_eval.run(args(), embeddings_dir=str(Path(dna_csv).parent),
                             out=quiet(lines))
        bzsl_s = time.perf_counter() - t
        n_classes = INSECT_SEEN_CLASSES + INSECT_UNSEEN_CLASSES
        log(f"  extract_feature_for_insect_dataset: {extract_s:.1f} s, CSVs "
            f"DNA {dna_shape} image {img_shape}; bzsl_eval {bzsl_s:.1f} s "
            f"(host): {bzsl}")

        # ---- 4. train_cl in INSECT mode
        pool = _eval_records(rng, max(INSECT_CL_BATCH * INSECT_CL_STEPS,
                                      4 * INSECT_CL_SPLIT), EVAL_FRAME)
        cl_train = _MemoryLoader([
            {"image_u8": b["image_u8"], "dna": b["dna"].astype(np.int64),
             "language": {k: v.astype(np.int64)
                          for k, v in b["language"].items()},
             "labels": np.arange(INSECT_CL_BATCH)}
            for b in (_take(pool, np.arange(s, s + INSECT_CL_BATCH))
                      for s in range(0, INSECT_CL_BATCH * INSECT_CL_STEPS,
                                     INSECT_CL_BATCH))])
        four = [_batches(_take(pool, np.arange(s, s + INSECT_CL_SPLIT)),
                         INSECT_CL_SPLIT)
                for s in range(0, 4 * INSECT_CL_SPLIT, INSECT_CL_SPLIT)]
        patch(train_cl, "load_insect_dataloader",
              lambda a, **kw: (cl_train, *four))
        flags, sweeps = [], []
        real_draw = loop_mod.draw_train_aug
        real_sweep = report_mod.inference_and_print_result

        def draw(*a, jitter=False, **kw):
            flags.append(jitter)
            return real_draw(*a, jitter=jitter, **kw)

        def sweep(keys, seen_d, unseen_d, **kw):
            sweeps.append(len(keys["label_list"]))
            return real_sweep(keys, seen_d, unseen_d, **kw)

        patch(loop_mod, "draw_train_aug", draw)
        patch(report_mod, "inference_and_print_result", sweep)
        lines = []
        cl_args = args(mc={"dataset": "INSECT",
                           "batch_size": INSECT_CL_BATCH, "epochs": 1})
        cl_args["save_ckpt"] = False
        t = time.perf_counter()
        before = launch_counts()
        state, best = train_cl.run(cl_args, out=quiet(lines))
        torch.cuda.synchronize()
        cl_s = time.perf_counter() - t
        counts_by["train_cl_insect"] = _delta(before)
        cl_flags = list(flags)
        cl_losses = [float(x) for x in next(
            ln for ln in lines if ln.startswith("epoch 0 losses")
        )[len("epoch 0 losses "):].strip("[]").split(",")]
        log(f"  train_cl INSECT: {cl_s:.1f} s for {INSECT_CL_STEPS} steps at "
            f"B={INSECT_CL_BATCH} (ColorJitter in {sum(cl_flags)} of "
            f"{len(cl_flags)} draws) and the eval phase over 4 x "
            f"{INSECT_CL_SPLIT} records ({sweeps} keys); losses {cl_losses}; "
            f"best {best:.4f}")
        del state
        torch.cuda.empty_cache()

        # ---- 5. methods 1 and 2 on BIOSCAN loaders
        keys_rec = _eval_records(rng, N_METHOD_KEYS, EVAL_FRAME)
        half = N_METHOD_KEYS - N_METHOD_SPLIT
        unseen_keys = _eval_records(rng, 2 * N_METHOD_SPLIT, EVAL_FRAME)
        n_train = METHOD_BATCH * METHOD_TRAIN_STEPS
        six = [_eval_loader(rec, METHOD_BATCH) for rec in (
            # train_seen: other specimens of the first keys' species
            _eval_records(rng, n_train, EVAL_FRAME,
                          like=_take(keys_rec, np.arange(n_train))),
            # val_seen: of the last keys' species
            _eval_records(rng, N_METHOD_SPLIT, EVAL_FRAME,
                          like=_take(keys_rec, np.arange(half,
                                                         N_METHOD_KEYS))),
            # val_unseen: 4-SNP copies of the unseen keys
            _eval_records(rng, N_METHOD_SPLIT, EVAL_FRAME, snps=4,
                          like=_take(unseen_keys,
                                     np.arange(N_METHOD_SPLIT))),
            keys_rec,
            _take(unseen_keys, np.arange(N_METHOD_SPLIT)),
            _take(unseen_keys, np.arange(N_METHOD_SPLIT,
                                         2 * N_METHOD_SPLIT)))]
        for cli in (m1_cli, m2_cli):
            patch(cli, "load_bioscan_dataloader_with_train_seen_and_"
                  "separate_keys", lambda a, **kw: six)
        results = {}
        for name, cli, kw in (("method_one", m1_cli, {}),
                              ("method_two", m2_cli,
                               {"fine_tune_epochs": 1})):
            lines = []
            t = time.perf_counter()
            before = launch_counts()
            seen_out, unseen_out = cli.run(args(), out=quiet(lines),
                                           num_intervals=1000, **kw)
            torch.cuda.synchronize()
            counts_by[name] = _delta(before)
            results[name] = (seen_out["micro_acc"][1]["species"],
                             unseen_out["micro_acc"][1]["species"],
                             seen_out["best_threshold"])
            log(f"  {name}: {time.perf_counter() - t:.1f} s; top-1 species "
                f"micro seen {results[name][0]:.4f}, unseen "
                f"{results[name][1]:.4f}, threshold {results[name][2]:.4f}")
    finally:
        for module, name, value in reversed(patched):
            setattr(module, name, value)
        shutil.rmtree(root, ignore_errors=True)
    counts, plain = launch_counts(), plain_calls()
    torch.cuda.empty_cache()
    log(f"  launches by run: {counts_by}")
    log(f"  launches on the insect path: {counts}; plain calls {plain}")
    log(f"  phase insect: {time.perf_counter() - t_phase:.1f} s ({card})")

    want = {"fine_tune_vitb": ("mha_packed", "mha_bwd"),
            "supervised_fine_tune": ("mha_packed", "mha_dropout", "mha_bwd"),
            "extract_feature": ("mha_packed", "mha"),
            "train_cl_insect": ("mha_packed", "mha_dropout", "mha_bwd",
                                "mha", "topk"),
            "method_one": ("mha_packed", "mha", "topk"),
            "method_two": ("mha_packed", "mha", "topk")}
    missing = {run: [k for k in keys if counts_by[run][k] <= 0]
               for run, keys in want.items()}
    if any(missing.values()) or any(plain.values()):
        raise AssertionError(f"insect: not launched {missing}, plain {plain}")
    if not (math.isfinite(vit_loss) and math.isfinite(joint_loss)
            and all(math.isfinite(x) for x in cl_losses)):
        raise AssertionError(f"insect: losses {vit_loss}, {joint_loss}, "
                             f"{cl_losses}")
    if still:
        raise AssertionError(f"fine_tune_vitb: not moved {still[:3]}")
    if heads != INSECT_SEEN or csv_shape != (768, 1000):
        raise AssertionError(f"fine_tune_vitb: head {heads}, CSV {csv_shape}")
    if (joint_csvs != [(768, n_classes), (768, 1000)]
            or "joint_last" not in joint_files):
        raise AssertionError(f"supervised: CSVs {joint_csvs}, files "
                             f"{joint_files}")
    if (dna_shape != (768, n_classes) or img_shape != (768, 1000)
            or not all(math.isfinite(bzsl[k])
                       for k in ("seen", "unseen", "harmonic"))):
        raise AssertionError(f"extract/bzsl: {dna_shape}, {img_shape}, {bzsl}")
    if not (cl_flags and all(cl_flags)) or sweeps != [4 * INSECT_CL_SPLIT]:
        raise AssertionError(f"train_cl INSECT: jitter {cl_flags}, keys "
                             f"{sweeps}")
    for name, (s, u, thr) in results.items():
        if not (0 <= s <= 1 and 0 <= u <= 1 and 0 <= thr <= 1):
            raise AssertionError(f"{name}: {results[name]}")
    log("phase insect ok")
    return counts


def _delta(before):
    now = launch_counts()
    return {k: now[k] - before[k] for k in now}


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


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _nccl_ms(step, state, batch, seed):
    """One more step under torch.profiler -> (wall ms, card ms in NCCL
    kernels, card busy ms), or Nones where the profiler shows no card
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, seed)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    nccl = busy = 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        busy += ev.device_time_total / 1e3
        if "nccl" in ev.key.lower():
            nccl += ev.device_time_total / 1e3
    return wall, (nccl if busy else None), (busy or None)


def phase_distributed():
    """The distributed train step on the card: a 1-rank NCCL group
    (parallel/distributed.py, tcp://localhost), its mesh
    (parallel/mesh.create_mesh), the flagship at full width, B = 400,
    frozen weights in bf16, dropout 0.1, (256, 341) frames through the
    device augmentation. The plain step and GradCache 4 x 100 (merged stage
    1, gc_s1_chunk 200) over the mesh, with the embeddings gathered and the
    gradients all-reduced through NCCL, against the same steps without a
    mesh: losses, the last step's gradients and the parameters after three
    AdamW steps bit for bit. Then per-layer remat "dots" over the mesh: its
    backward launches K3 and no attention forward (K1, K2d). The group is
    torn down at the end. Returns the launch counts of the distributed
    steps."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from bioscan_clip_tpu_torch.config.core import ConfigNode
    from bioscan_clip_tpu_torch.models.clip import load_clip_model
    from bioscan_clip_tpu_torch.ops import attention
    from bioscan_clip_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
    )
    from bioscan_clip_tpu_torch.parallel.mesh import create_mesh
    from bioscan_clip_tpu_torch.train.loop import (
        make_gradcache_train_step,
        make_train_step,
    )
    from bioscan_clip_tpu_torch.train.schedules import constant
    from bioscan_clip_tpu_torch.train.state import (
        cast_frozen_params,
        create_train_state,
    )

    torch.cuda.empty_cache()
    cfg = ConfigNode({"tpu": {"distributed": {
        "coordinator": f"localhost:{_free_port()}", "num_processes": 1,
        "process_id": 0}}})
    if maybe_initialize_distributed(cfg, log=log, device="cuda") != (0, 1):
        raise AssertionError("distributed: not a 1-rank group")
    counts = {}
    try:
        mesh = create_mesh({"data": 1})
        if dist.get_backend() != "nccl" or mesh.group is None:
            raise AssertionError(f"distributed: backend "
                                 f"{dist.get_backend()}, mesh {mesh}")
        args = ConfigNode({"model_config": dict(FLAGSHIP)})
        batch = _train_cl_batch(np.random.default_rng(11), TRAIN_BATCH)
        cases = (("plain", make_train_step, {}),
                 (f"GradCache {TRAIN_CL_ACCUM} x "
                  f"{TRAIN_BATCH // TRAIN_CL_ACCUM}",
                  make_gradcache_train_step,
                  dict(accum_steps=TRAIN_CL_ACCUM,
                       s1_chunk=TRAIN_CL_S1_CHUNK, merged=True)))
        for name, factory, kw in cases:
            runs, kept = [], []
            for axis in (None, mesh):
                if axis is not None:
                    reset_counts()  # the distributed steps' launches
                losses, grads, ms, peak, state, step, b = _step_grads(
                    args, batch, factory, reps=3, mesh=axis, **kw)
                torch.cuda.synchronize()
                if axis is not None:
                    for key, n in launch_counts().items():
                        counts[key] = counts.get(key, 0) + n
                params = {n: p.detach().clone()
                          for n, p in state.model.named_parameters()
                          if p.requires_grad}
                runs.append((losses, grads, params))
                kept.append((state, step, b, peak))
            (l0, g0, p0), (l1, g1, p1) = runs
            bad = [n for n in g0 if not torch.equal(g0[n], g1[n])]
            bad += [n for n in p0 if not torch.equal(p0[n], p1[n])]
            if l0 != l1 or bad:
                raise AssertionError(f"distributed {name}: losses {l0} vs "
                                     f"{l1}; differing tensors {bad[:5]}")
            log(f"  {name}: losses {[round(x, 6) for x in l1]} equal, "
                f"{len(g0)} gradients and {len(p0)} parameters after 3 "
                "AdamW steps bit-equal to the step without a mesh")
            # timing after the comparison: the two steps in turns (none,
            # mesh, mesh, none, twice), then one profiled step each
            ms = {0: [], 1: []}
            for which in (0, 1, 1, 0) * 2:
                state, step, b, _ = kept[which]
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                step(state, b, 0x7E57)
                ev[1].record()
                ev[1].synchronize()
                ms[which].append(ev[0].elapsed_time(ev[1]))
            for which, what in ((0, "without a mesh"),
                                (1, "over the 1-rank NCCL mesh")):
                state, step, b, peak = kept[which]
                wall, nccl, busy = _nccl_ms(step, state, b, 0x7E57)
                log(f"  {name} {what}: {np.median(ms[which]):.1f} ms per "
                    f"step (CUDA events, median of 4 in turns: "
                    f"{[round(t, 1) for t in ms[which]]}), peak "
                    f"{peak:.2f} GiB; one profiled step: wall {wall:.1f} "
                    "ms, card busy "
                    + ("not measured" if busy is None else
                       f"{busy:.1f} ms ({100 * busy / wall:.1f}%), NCCL "
                       f"kernels {nccl:.3f} ms ({100 * nccl / busy:.3f}% "
                       "of busy)"))
                _mfu(f"distributed {name} {what}",
                     float(np.median(ms[which])), TRAIN_BATCH,
                     "plain" if name == "plain" else "gradcache")
            del kept, state, step, b
            torch.cuda.empty_cache()
        # the repaired fault: remat "dots" saves the attention outputs
        rargs = ConfigNode({"model_config": dict(FLAGSHIP), "tpu": {
            "remat": True, "remat_policy": "dots"}})
        model = load_clip_model(rargs, device="cuda", dtype=torch.bfloat16)
        cast_frozen_params(model)
        create_train_state(model, constant(1e-4))
        model.train()
        from bioscan_clip_tpu_torch.train.loop import device_batch

        b = device_batch(batch, "cuda")
        loss = make_train_step(model, mesh=mesh).loss_fn(b, 0x7E57)
        fwd = (attention.mha_packed, attention.mha, attention.mha_dropout)
        before = [f.launches for f in fwd]
        bwd = attention.mha_bwd.launches
        loss.backward()
        torch.cuda.synchronize()
        again = [f.launches - n for f, n in zip(fwd, before)]
        if any(again) or attention.mha_bwd.launches == bwd:
            raise AssertionError(f"distributed: remat dots backward "
                                 f"launched forwards {again}")
        log(f"  remat dots over the mesh: the backward launched K3 "
            f"{attention.mha_bwd.launches - bwd} times and no attention "
            "forward (K1, K2, K2d: 0, 0, 0)")
        del model, loss, b
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    want = ("mha_packed", "mha_dropout", "mha_bwd")
    if any(counts.get(k, 0) <= 0 for k in want) or any(plain_calls().values()):
        raise AssertionError(f"distributed: launches {counts}")
    log(f"  launches on the distributed path: {counts}")
    log("phase distributed ok")
    return counts


# graphs phase: K train steps per call as CUDA graphs (train/graphs.py)
GRAPH_K = 4
# kernel names in a profiler trace: the attention forwards (K1, K1m, K2d
# share the bodies) and the backward's passes (K3, K3m)
FWD_KERNELS = ("mha_fwd_mma", "mha_fwd_kernel")
BWD_KERNELS = ("bwd_query_rows", "bwd_key_rows")


def _graph_schedule(step):
    """A learning rate that changes every step, so each replay must read
    the one its prelude wrote."""
    return 1e-4 * (1.0 + 0.05 * step)


def _stacked(batches):
    from bioscan_clip_tpu_torch.train.loop import device_batch, stack_batches

    return device_batch(stack_batches(batches), "cuda")


def _trainable_state(state):
    """Clones of every trainable parameter and both AdamW moments."""
    out = {}
    for n, p in state.model.named_parameters():
        if p.requires_grad:
            out[n] = p.detach().clone()
            for key, t in state.optimizer.state.get(p, {}).items():
                out[f"{n}/{key}"] = t.detach().clone()
    return out


def _profile_call(scan, state, stacked, seeds):
    """One more graphed call under torch.profiler -> (state, wall ms by CUDA
    events, card busy ms or None, the kernel names seen)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    ev = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ev[0].record()
        state, _ = scan(state, stacked, seeds)
        ev[1].record()
        torch.cuda.synchronize()
    busy, names, api = 0.0, set(), []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += e.device_time_total / 1e3
            names.add(e.key)
        elif e.key.startswith("cuda"):  # the runtime calls the host made
            api.append((e.cpu_time_total / 1e3, e.count, e.key))
    top = ", ".join(f"{key} {ms:.1f} ms in {n}"
                    for ms, n, key in sorted(api, reverse=True)[:4])
    log(f"    host time in CUDA runtime calls during the call: {top}")
    return state, ev[0].elapsed_time(ev[1]), (busy or None), names


def _graph_case(what, model, eager_step, scan_step, calls, seeds, counts,
                profile_steps=None):
    """Eager steps, then the same steps as graphed calls from the same
    state (the trainable parameters put back, a new optimizer); losses,
    trainable parameters and both AdamW moments must be bit-equal. Then
    one more graphed call, timed and profiled: its busy share, the
    attention kernels' names in its trace and their replay-adjusted
    counters. `calls`: stacked (K, B, ...) batches per call; `seeds`: K
    step seeds per call; `profile_steps`: the profiled call's steps (K by
    default; fewer keeps a long step's trace short). Adds the graphed
    calls' launches to `counts`; returns (eager ms, graphed ms, busy %,
    eager peak, graphed peak, the profiled call's launches)."""
    import numpy as np
    import torch

    from bioscan_clip_tpu_torch.train.loop import batch_rows
    from bioscan_clip_tpu_torch.train.state import create_train_state

    t_case = time.perf_counter()
    init = {n: p.detach().clone() for n, p in model.named_parameters()
            if p.requires_grad}
    k = len(seeds[0])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(model, _graph_schedule)
    step = eager_step()
    ref_losses, ms = [], []
    for stacked, ss in zip(calls, seeds):
        for j, seed in enumerate(ss):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            state, loss = step(state, batch_rows(stacked, j), seed)
            ev[1].record()
            ms.append(ev)
            ref_losses.append(loss)
    torch.cuda.synchronize()
    eager_ms = float(np.median([a.elapsed_time(b) for a, b in ms[1:]]))
    eager_peak = torch.cuda.max_memory_allocated() / 2**30
    ref = _trainable_state(state)
    ref_losses = torch.stack(ref_losses)
    del state, step
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n in init:
                p.copy_(init[n])
                p.grad = None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    state = create_train_state(model, _graph_schedule)
    scan = scan_step()
    reset_counts()
    losses = []
    for stacked, ss in zip(calls, seeds):
        t = time.perf_counter()
        state, out = scan(state, stacked, ss)
        losses.append(out)
        torch.cuda.synchronize()
        log(f"  {what}: a call of {k} graphed steps took "
            f"{1e3 * (time.perf_counter() - t):.1f} ms (host clock"
            + (", the first warms up and captures)" if len(losses) == 1
               else ")"))
    got = _trainable_state(state)
    graph_peak = torch.cuda.max_memory_allocated() / 2**30
    grown = launch_counts()
    for key, n in grown.items():
        counts[key] = counts.get(key, 0) + n
    same_losses = torch.equal(torch.cat(losses), ref_losses)
    bad = [n for n in ref if not torch.equal(ref[n], got[n])]
    log(f"  {what}: losses {[round(x, 6) for x in ref_losses.tolist()]}; "
        f"graphed vs eager bit-equal: losses {same_losses}, "
        f"{len(ref) - len(bad)} of {len(ref)} trainable tensors and AdamW "
        "moments")
    if not same_losses or bad:
        raise AssertionError(f"graphs {what}: losses {torch.cat(losses)} vs "
                             f"{ref_losses}; differing {bad[:5]}")

    n = profile_steps or k
    before = launch_counts()
    state, wall, busy, names = _profile_call(
        scan, state, batch_rows(calls[-1], slice(0, n)), seeds[-1][:n])
    replayed = {key: n - before[key] for key, n in launch_counts().items()}
    plain = plain_calls()
    graphs = scan.graphs.graphs
    captured = next(iter(graphs.values())).launches if graphs else {}
    log(f"  {what}: one graphed call of {n} steps {wall:.1f} ms (CUDA "
        f"events) = {wall / n:.1f} ms per step, eager {eager_ms:.1f} ms "
        "(median); card busy "
        + ("not measured" if busy is None
           else f"{busy:.1f} ms ({100 * busy / wall:.1f}%)")
        + f"; peak {eager_peak:.2f} GiB eager, {graph_peak:.2f} GiB graphed "
        f"(max_memory_allocated); launches in that call {replayed}; one "
        f"replay captures {captured}")
    fwd = sorted(n for n in names if any(k_ in n for k_ in FWD_KERNELS))
    bwd = sorted(n for n in names if any(k_ in n for k_ in BWD_KERNELS))
    log(f"    kernels in the replayed call's trace: forward {fwd[:4]}, "
        f"backward {bwd[:4]}; plain calls {plain}")
    if not fwd or not bwd or any(plain.values()):
        raise AssertionError(f"graphs {what}: trace forward {fwd}, backward "
                             f"{bwd}, plain {plain}")
    del state, scan, got, ref
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"  {what}: case done in {time.perf_counter() - t_case:.1f} s")
    return (eager_ms, wall / n, None if busy is None else 100 * busy / wall,
            eager_peak, graph_peak, replayed)


def _want_launched(what, replayed, names):
    if any(replayed.get(n, 0) <= 0 for n in names):
        raise AssertionError(f"graphs {what}: replayed launches {replayed}, "
                             f"want {names}")


def phase_graphs():
    """K train steps per call as CUDA graphs (train/graphs.py,
    train.loop.make_scan_train_step, make_gradcache_train_step(
    steps_per_call=K)) at full width, random seeded weights, bf16, frozen
    weights in bf16, dropout 0.1, the device augmentation of (256, 341)
    frames, a learning rate that changes every step. Each case runs eager
    steps, then the same steps as graphed calls from the same state, and
    must match them bit for bit (losses, trainable parameters, both AdamW
    moments); then one more call is timed and profiled (card busy share,
    the kernels' names in the trace, no plain version):
    - the flagship at B=400, the plain step, K=4, two calls;
    - GradCache 4 x 100 (merged stage 1, gc_s1_chunk 200), K=4;
    - per-layer remat "full", K=2;
    - the plain step over a 1-rank NCCL mesh, K=2;
    - the OpenCLIP ablation at B=10, K=8 (K1m and K3m);
    - cli/train_cl.run with tpu.steps_per_call=4 and GradCache, 2 epochs
      of 6 steps (calls of 4 and 2), then a run resumed from `last` after
      epoch 0 repeating epoch 1's losses bit for bit.
    Returns the launch counts of the graphed calls."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from bioscan_clip_tpu_torch.config.core import ConfigNode
    from bioscan_clip_tpu_torch.models.clip import load_clip_model
    from bioscan_clip_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
    )
    from bioscan_clip_tpu_torch.parallel.mesh import create_mesh
    from bioscan_clip_tpu_torch.train.loop import (
        make_gradcache_train_step,
        make_scan_train_step,
        make_train_step,
    )
    from bioscan_clip_tpu_torch.train.state import cast_frozen_params

    torch.cuda.empty_cache()
    log("  " + card_line())
    counts, table = {}, {}
    rng = np.random.default_rng(12)
    t0 = time.perf_counter()
    frames = [_train_cl_batch(rng, TRAIN_BATCH) for _ in range(GRAPH_K)]
    calls = [_stacked(frames), _stacked(frames[::-1])]
    seeds = [[int(s) for s in rng.integers(0, 2**32, GRAPH_K)]
             for _ in calls]
    log(f"  synthetic data: {1e3 * (time.perf_counter() - t0):.0f} ms")

    def flagship(**tpu):
        args = ConfigNode({"model_config": dict(FLAGSHIP), "tpu": tpu})
        model = load_clip_model(args, device="cuda", dtype=torch.bfloat16,
                                seed=0)
        return cast_frozen_params(model)

    model = flagship()
    table["plain"] = _graph_case(
        f"plain B={TRAIN_BATCH} K={GRAPH_K}", model,
        lambda: make_train_step(model),
        lambda: make_scan_train_step(model, GRAPH_K), calls, seeds, counts,
        profile_steps=2)
    merged = load_clip_model(ConfigNode({"model_config": dict(FLAGSHIP)}),
                             device="cuda", dtype=torch.bfloat16,
                             lora_rank=0)
    gc = dict(accum_steps=TRAIN_CL_ACCUM, s1_chunk=TRAIN_CL_S1_CHUNK,
              merged_model=merged)
    table["gradcache"] = _graph_case(
        f"GradCache {TRAIN_CL_ACCUM} x {TRAIN_BATCH // TRAIN_CL_ACCUM} "
        f"K={GRAPH_K}", model,
        lambda: make_gradcache_train_step(model, **gc),
        lambda: make_gradcache_train_step(model, steps_per_call=GRAPH_K,
                                          **gc),
        calls[:1], seeds[:1], counts, profile_steps=2)
    del merged, gc
    two = [{k: v[:2] if not isinstance(v, dict)
            else {kk: vv[:2] for kk, vv in v.items()}
            for k, v in calls[0].items()}]
    cfg = ConfigNode({"tpu": {"distributed": {
        "coordinator": f"localhost:{_free_port()}", "num_processes": 1,
        "process_id": 0}}})
    if maybe_initialize_distributed(cfg, log=log, device="cuda") != (0, 1):
        raise AssertionError("graphs: not a 1-rank group")
    try:
        mesh = create_mesh({"data": 1})
        if dist.get_backend() != "nccl" or mesh.group is None:
            raise AssertionError(f"graphs: backend {dist.get_backend()}")
        table["mesh"] = _graph_case(
            "plain over the 1-rank NCCL mesh K=2", model,
            lambda: make_train_step(model, mesh=mesh),
            lambda: make_scan_train_step(model, 2, mesh=mesh), two,
            [seeds[0][:2]], counts)
    finally:
        dist.destroy_process_group()
    del model
    torch.cuda.empty_cache()
    model = flagship(remat=True, remat_policy="full")
    table["remat"] = _graph_case(
        'remat "full" K=2', model, lambda: make_train_step(model),
        lambda: make_scan_train_step(model, 2), two, [seeds[1][:2]],
        counts)
    del model, calls, two, frames
    torch.cuda.empty_cache()

    oc_args = ConfigNode({"model_config": dict(OPENCLIP)})
    model = cast_frozen_params(load_clip_model(
        oc_args, device="cuda", dtype=torch.bfloat16, seed=0))
    oc = [_stacked([_train_batch(rng, OPENCLIP_TRAIN_BATCH)
                    for _ in range(8)])]
    table["openclip"] = _graph_case(
        f"OpenCLIP B={OPENCLIP_TRAIN_BATCH} K=8", model,
        lambda: make_train_step(model, openclip_norm=True),
        lambda: make_scan_train_step(model, 8, openclip_norm=True), oc,
        [[int(s) for s in rng.integers(0, 2**32, 8)]], counts)
    del model, oc
    torch.cuda.empty_cache()
    for name, row in table.items():
        want = ("mha_packed", "mha_dropout", "mha_bwd")
        if name == "openclip":
            want += ("mha_packed_mask", "mha_bwd_mask")
        _want_launched(name, row[5], want)
    _graph_train_cl(counts)
    log("  graphed against eager, ms per step (CUDA events), card busy % "
        "of a graphed call, peak GiB eager / graphed: " + "; ".join(
            f"{name} {r[0]:.1f} -> {r[1]:.1f} ms, "
            + ("busy not measured" if r[2] is None else f"busy {r[2]:.1f}%")
            + f", {r[3]:.2f} / {r[4]:.2f} GiB" for name, r in table.items()))
    for name, r in table.items():
        if name != "openclip":  # the flagship's rows, B=400
            kind = "gradcache" if name == "gradcache" else "plain"
            _mfu(f"graphs {name}, eager", r[0], TRAIN_BATCH, kind)
            _mfu(f"graphs {name}, graphed", r[1], TRAIN_BATCH, kind)
    log("phase graphs ok")
    return counts


GRAPH_CL_STEPS = 6  # tpu.max_steps_per_epoch of the graphed train_cl run


def _graph_train_cl(counts):
    """cli/train_cl.run with tpu.steps_per_call=GRAPH_K under GradCache 4 x
    100 (merged stage 1, gc_s1_chunk 200): 2 epochs of GRAPH_CL_STEPS steps
    (calls of 4 and 2), the eval phase after each (96 keys, 48 seen, 48
    unseen records), then a run resumed from `last` as it stood after
    epoch 0 repeats epoch 1's losses bit for bit."""
    import math
    import shutil
    from pathlib import Path

    import numpy as np
    import torch

    from bioscan_clip_tpu_torch.cli import train_cl
    from bioscan_clip_tpu_torch.train.checkpoint import wait_for_checkpoints

    rng = np.random.default_rng(13)
    batches = [_train_cl_batch(rng, TRAIN_BATCH) for _ in range(3)]
    train = _MemoryLoader(batches * 2)
    keys_rec = _eval_records(rng, 96, EVAL_FRAME)
    seen = _batches(_eval_records(rng, 48, EVAL_FRAME, like=_take(
        keys_rec, np.arange(48))), 48)
    unseen = _batches(_eval_records(rng, 48, EVAL_FRAME, snps=4, like=_take(
        keys_rec, np.arange(48, 96))), 48)
    keys = _batches(keys_rec, 96)
    root = Path("build") / "chip_smoke_graphs"
    shutil.rmtree(root, ignore_errors=True)
    copy = root / "after_epoch_0"
    tpu = dict(accum_steps=TRAIN_CL_ACCUM, gradcache_merged=True,
               gc_s1_chunk=TRAIN_CL_S1_CHUNK, steps_per_call=GRAPH_K,
               max_steps_per_epoch=GRAPH_CL_STEPS)
    lines = []

    def out(line):
        lines.append(line)
        if line.startswith(("epoch", "Resumed")) or "per call" in line:
            log(f"    | {line}")
        if line.startswith("Last ckpt: ") and not copy.exists():
            wait_for_checkpoints()  # `last` as it stood after epoch 0
            copy.mkdir(parents=True)
            shutil.copy(line[len("Last ckpt: "):], copy / "last")

    def losses_of(lns, epoch):
        prefix = f"epoch {epoch} losses "
        return [float(x) for x in next(
            ln[len(prefix):] for ln in lns if ln.startswith(prefix)
        ).strip("[]").split(",")]

    real_loaders = train_cl.load_dataloader
    train_cl.load_dataloader = lambda a, **kw: (train, seen, unseen, keys)
    try:
        before = launch_counts()
        t = time.perf_counter()
        state, _ = train_cl.run(_train_cl_args(root, **tpu), out=out)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        for key, n in launch_counts().items():
            counts[key] = counts.get(key, 0) + n - before[key]
        first = [losses_of(lines, e) for e in range(TRAIN_CL_EPOCHS)]
        del state
        torch.cuda.empty_cache()
        resumed = []
        args2 = _train_cl_args(root, **tpu)
        args2["resume"] = str(copy)
        args2["save_ckpt"] = False
        state2, _ = train_cl.run(args2, out=resumed.append)
        again = losses_of(resumed, 1)
        del state2
    finally:
        train_cl.load_dataloader = real_loaders
        wait_for_checkpoints()
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    log(f"  train_cl, steps_per_call={GRAPH_K}, GradCache: {run_s:.1f} s for "
        f"{TRAIN_CL_EPOCHS} epochs of {GRAPH_CL_STEPS} steps; losses "
        f"{first}; resumed from `last` after epoch 0: epoch 1 {again}, "
        f"bit-equal {again == first[1]}")
    if not all(math.isfinite(x) for ep in first for x in ep):
        raise AssertionError(f"graphs train_cl: losses {first}")
    if [len(ep) for ep in first] != [GRAPH_CL_STEPS] * TRAIN_CL_EPOCHS:
        raise AssertionError(f"graphs train_cl: losses {first}")
    if again != first[1]:
        raise AssertionError(f"graphs train_cl resume: {again} vs {first[1]}")


STREAM_F32 = (4_194_304, 1_048_576)  # keys, slab
STREAM_I8 = (2_097_152, 524_288)
STREAM_BQ, STREAM_K = 256, 5


def _unit_keys(gen, n, d=768):
    """n random unit rows made on the card, returned as a host array."""
    import numpy as np
    import torch

    out = np.empty((n, d), np.float32)
    for s in range(0, n, 1 << 20):
        e = min(s + (1 << 20), n)
        x = torch.randn(e - s, d, device="cuda", generator=gen)
        out[s:e] = torch.nn.functional.normalize(x, dim=1).cpu().numpy()
    return out


def _agree_up_to_ties(what, q, keys, got, ref, precision, tie=1e-5):
    """`got` against `ref` (values, indices): fp32 values within 1e-5,
    and a position may hold another key only when the two keys' float64
    scores (of the operands as the product sees them) are within `tie`,
    as `_searches_agree` counts a near-tie; int8 bit for bit. Returns the
    rows that differ."""
    import numpy as np

    (v, i), (rv, ri) = got, ref
    if precision == "int8":
        if not (np.array_equal(i, ri) and np.array_equal(v, rv)):
            raise AssertionError(f"{what}: int8 search differs")
        return 0
    if np.abs(v - rv).max() > 1e-5:
        raise AssertionError(f"{what}: values differ by "
                             f"{np.abs(v - rv).max()}")
    differ = 0
    for r in np.nonzero((i != ri).any(axis=1))[0]:
        pos = i[r] != ri[r]
        qr = _as_scored(q[r], precision)
        gap = np.abs(_as_scored(keys[i[r][pos]], precision) @ qr
                     - _as_scored(keys[ri[r][pos]], precision) @ qr).max()
        if gap > tie:
            raise AssertionError(f"{what} row {r}: {i[r]} vs {ri[r]}, "
                                 f"score gap {gap}")
        differ += 1
    return differ


def phase_streaming():
    """Host-slab streaming and the sharded search on the card
    (retrieval/engine.py): 4,194,304 random unit fp32 keys (768-d) in slabs
    of 1,048,576, searched by 256 queries (k = 5) in "high" and "default";
    2,097,152 keys as int8 codes in slabs of 524,288 under each rescore
    mode; each against the resident search of the same keys (fp32 up to
    near-ties, int8 bit for bit), and the same keys sharded four ways on
    the cards there are (parallel/mesh.create_mesh: four entries over
    cuda:0.., all on the one card of a one-card host).
    Prints ms per search streamed, sharded and resident, the copy rate of
    the host-to-device stream alone (pinned staging, copy stream), the
    slabs' search time alone, and the share of the copy hidden under the
    search: (copy + search - streamed) / copy. Returns the launch counts of
    the streamed and sharded searches."""
    import numpy as np
    import torch

    from bioscan_clip_tpu_torch.ops.topk import topk
    from bioscan_clip_tpu_torch.parallel.mesh import create_mesh
    from bioscan_clip_tpu_torch.retrieval.engine import (
        PreparedKeys,
        topk_search,
    )

    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(5)
    n32, slab32 = STREAM_F32
    keys = _unit_keys(gen, n32)
    q = _unit_keys(gen, STREAM_BQ)
    # planted matches in the first, a middle and the last slab
    q[:3] = keys[[0, n32 // 2 + 7, n32 - 1]]
    # four shards over the cards there are (all on cuda:0 with one card)
    cards = torch.cuda.device_count()
    four = create_mesh(devices=[torch.device("cuda", i % cards)
                                for i in range(4)])
    counts, differ = {}, 0

    def timed(fn, reps=3):
        fn()
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return res, float(np.median(out))

    def count(fn):
        reset_counts()
        res = fn()
        torch.cuda.synchronize()
        for key, n in launch_counts().items():
            counts[key] = counts.get(key, 0) + n
        return res

    for precision in ("high", "default"):
        res = PreparedKeys(keys, precision=precision, normalized=True)
        streamed = PreparedKeys(keys, precision=precision, normalized=True,
                                max_device_keys=slab32)
        sharded = PreparedKeys(keys, precision=precision, normalized=True,
                               mesh=four)
        (sh,) = streamed.shards
        if sh.slab != slab32 or [x.n for x in sharded.shards] != [
                n32 // 4] * 4:
            raise AssertionError("streaming: unexpected slabs or shards")
        ref, res_ms = timed(lambda: topk_search(q, res, STREAM_K))
        got = count(lambda: topk_search(q, streamed, STREAM_K))
        _, st_ms = timed(lambda: topk_search(q, streamed, STREAM_K))
        sgot = count(lambda: topk_search(q, sharded, STREAM_K))
        _, sh_ms = timed(lambda: topk_search(q, sharded, STREAM_K))
        differ += _agree_up_to_ties(f"streamed {precision}", q, keys, got,
                                    ref, precision)
        differ += _agree_up_to_ties(f"sharded {precision}", q, keys, sgot,
                                    ref, precision)
        if list(got[1][:3, 0]) != [0, n32 // 2 + 7, n32 - 1]:
            raise AssertionError(f"streamed {precision}: planted keys "
                                 f"{got[1][:3, 0]}")

        def copy_only():
            for _ in sh.slabs():
                pass

        _, copy_ms = timed(copy_only, reps=2)
        qd = torch.from_numpy(q).cuda()
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        for s in range(0, n32, slab32):
            topk(qd, res.shards[0].keys[s:s + slab32], slab32, STREAM_K,
                 precision)
        end.record()
        end.synchronize()
        search_ms = start.elapsed_time(end)
        hidden = (copy_ms + search_ms - st_ms) / copy_ms
        gbs = keys.nbytes / copy_ms / 1e6
        log(f"  fp32 {precision}: {n32} keys, Bq={STREAM_BQ}, k={STREAM_K}:"
            f" resident {res_ms:.2f} ms, streamed in slabs of {slab32} "
            f"{st_ms:.1f} ms, sharded 4 ways on the card {sh_ms:.2f} ms "
            f"(host clock, medians of 3); the stream alone {copy_ms:.1f} ms "
            f"= {gbs:.2f} GB/s host-to-device; the slabs' searches alone "
            f"{search_ms:.2f} ms (CUDA events); copy hidden under the "
            f"search {100 * hidden:.1f}%")
        del res, streamed, sharded, qd
        torch.cuda.empty_cache()

    n8, slab8 = STREAM_I8
    keys8 = keys[:n8]
    for rescore in ("float32", "bfloat16", "none"):
        kw = dict(precision="int8", rescore=rescore, normalized=True)
        res = PreparedKeys(keys8, **kw)
        streamed = PreparedKeys(keys8, max_device_keys=slab8, **kw)
        sharded = PreparedKeys(keys8, mesh=four, **kw)
        if streamed.shards[0].slab != slab8:
            raise AssertionError("streaming int8: unexpected slab")
        ref, res_ms = timed(lambda: topk_search(q, res, STREAM_K))
        got = count(lambda: topk_search(q, streamed, STREAM_K))
        _, st_ms = timed(lambda: topk_search(q, streamed, STREAM_K))
        sgot = count(lambda: topk_search(q, sharded, STREAM_K))
        _agree_up_to_ties(f"streamed int8 {rescore}", q, keys8, got, ref,
                          "int8")
        _agree_up_to_ties(f"sharded int8 {rescore}", q, keys8, sgot, ref,
                          "int8")
        log(f"  int8 rescore {rescore}: {n8} keys: resident {res_ms:.2f} "
            f"ms, streamed in slabs of {slab8} {st_ms:.1f} ms (host clock, "
            "medians of 3, the host rescore included); streamed and "
            "sharded bit-equal to resident")
        del res, streamed, sharded
        torch.cuda.empty_cache()
    want = ("topk", "topk_default", "topk_i8")
    if any(counts.get(k, 0) <= 0 for k in want) or any(plain_calls().values()):
        raise AssertionError(f"streaming: launches {counts}")
    log(f"  launches on the streamed and sharded searches: {counts}")
    log(f"phase streaming ok: {differ} fp32 rows differ from the resident "
        "search, each only by near-ties")
    return counts


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
    _fine_tune_parity()
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
    before = {n: p.detach().clone() for n, p in gpu.named_parameters()
              if p.requires_grad}
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
    # the card's AdamW is capturable (its lr a card tensor, for CUDA
    # graphs): the same update by the plain AdamW on the card, for scale
    plain = {n: t.requires_grad_() for n, t in before.items()}
    for n, t in plain.items():
        t.grad = pg[n].grad
    torch.optim.AdamW(list(plain.values()), lr=1e-3, betas=(0.9, 0.999),
                      eps=1e-8, weight_decay=0.01).step()
    moved = max((pg[n].detach() - t.detach()).abs().max().item()
                for n, t in plain.items())
    log(f"  {what}AdamW on the card, capturable against plain: max "
        f"|difference| {moved:.3g} after one step")
    err = max((pg[n].detach().cpu() - p.detach()).abs().max().item()
              for n, p in pc.items())
    log(f"  {what}params after AdamW: max |card - cpu| {err:.3g} (tol 1e-6)")
    if not err <= 1e-6:
        raise AssertionError(f"parity AdamW: {err} > 1e-6")


def _fine_tune_parity():
    """The supervised fine-tunes' steps in fp32 on the card against the
    CPU: ViT-B/16 and BarcodeBERT at full width and 2 layers each under
    797-way heads, every weight trainable, B=8, i.i.d. noise frames (224,
    224: the augmentation only casts them), dropout 0.1 in BarcodeBERT
    (row-keyed: the same masks on both devices). The classifier step (K1,
    K3) and the joint step (K1, K2d, K3): the loss within 1e-5 relative,
    each gradient within 1e-4 * max |g| (BERT's key biases, whose gradient
    is zero in exact arithmetic, within 1e-6 of the step's largest |g| on
    both devices), and AdamW on the card, given the card's gradients,
    equal to AdamW on the CPU given the same gradients (atol 1e-6)."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from bioscan_clip_tpu_torch.models.bert import (
        BARCODE_BERT_CONFIG,
        BarcodeBertDnaEncoder,
    )
    from bioscan_clip_tpu_torch.models.clip import init_weights
    from bioscan_clip_tpu_torch.models.heads import EncoderWithHead
    from bioscan_clip_tpu_torch.models.vit import ViTConfig, ViTImageEncoder
    from bioscan_clip_tpu_torch.train import fine_tuning as ft

    towers = (ViTImageEncoder(ViTConfig(num_layers=2)),
              BarcodeBertDnaEncoder(dataclasses.replace(BARCODE_BERT_CONFIG,
                                                        num_layers=2)))
    heads = [init_weights(EncoderWithHead(t, 768, INSECT_SEEN), seed=4 + i)
             for i, t in enumerate(towers)]
    rng = np.random.default_rng(8)
    host = _train_batch(rng, 8, tiled=False)
    target = rng.integers(0, INSECT_SEEN, size=8)
    seed = 0x5EED4321
    cases = (
        ("classifier", lambda img, dna: ft.make_classifier_train_step(img),
         {"input": host["image_u8"], "target": target},
         ("mha_packed", "mha_bwd")),
        ("joint", ft.make_joint_classifier_train_step,
         {"image": host["image_u8"], "dna": host["dna"], "target": target},
         ("mha_packed", "mha_dropout", "mha_bwd")))
    for name, make, batch, want in cases:
        cpu = [copy.deepcopy(h) for h in heads]
        gpu = [copy.deepcopy(h).cuda() for h in heads]
        step_c, step_g = make(*cpu), make(*gpu)
        st_c = ft.create_fine_tune_state(step_c.model)
        st_g = ft.create_fine_tune_state(step_g.model)
        step_c.model.train()
        loss_c = step_c.loss_fn({k: torch.from_numpy(v)
                                 for k, v in batch.items()}, seed)
        loss_c.backward()
        reset_counts()
        _, loss_g = step_g(st_g, {k: torch.from_numpy(v).cuda()
                                  for k, v in batch.items()}, seed)
        counts, plain = launch_counts(), plain_calls()
        rel = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
        log(f"  fine-tune {name} step, fp32: loss card {loss_g.item():.7f}, "
            f"cpu {loss_c.item():.7f}, rel {rel:.3g} (tol 1e-5)")
        pc = dict(step_c.model.named_parameters())
        pg = dict(step_g.model.named_parameters())
        top = max(p.grad.abs().max().item() for p in pc.values())
        worst, noise = (0.0, ""), 0.0
        for n, p in pc.items():
            gg = pg[n].grad.cpu()
            if n.endswith("attention.self.key.bias"):
                # zero in exact arithmetic (a softmax ignores a shift of a
                # row): each device holds fp32 noise, held to its size
                noise = max(noise, gg.abs().max().item(),
                            p.grad.abs().max().item())
            else:
                err = ((gg - p.grad).abs().max().item()
                       / max(p.grad.abs().max().item(), 1e-30))
                worst = max(worst, (err, n))
            p.grad = gg  # the CPU AdamW below takes the card's gradients
        st_c.apply_gradients()
        moved = max((pg[n].detach().cpu() - p.detach()).abs().max().item()
                    for n, p in pc.items())
        log(f"  fine-tune {name} step: grads max |card - cpu| / max |g| "
            f"{worst[0]:.3g} ({worst[1]}) (tol 1e-4); BERT key biases' "
            f"|g| {noise:.3g} against the largest |g| {top:.3g} (tol 1e-6 of "
            f"it); params after AdamW max |card - cpu| {moved:.3g} (tol "
            f"1e-6), {len(pc)} tensors; launches "
            f"{dict((k, counts[k]) for k in want)}")
        if not (rel <= 1e-5 and worst[0] <= 1e-4 and noise <= 1e-6 * top
                and moved <= 1e-6):
            raise AssertionError(f"parity fine-tune {name}: loss {rel}, "
                                 f"grads {worst}, key-bias noise {noise}, "
                                 f"params {moved}")
        if any(counts[k] <= 0 for k in want) or any(plain.values()):
            raise AssertionError(f"parity fine-tune {name}: launches "
                                 f"{counts}, plain {plain}")
        del cpu, gpu, step_c, step_g, st_c, st_g
    torch.cuda.empty_cache()


N_TOOLS_KEYS, N_TOOLS_QUERIES = 96, 48  # the data_tools phase's sweep
# the split generator's table: cut in records from BIOSCAN-1M's 1.1 M
# (data/splits.py masks every record once per species)
N_SPLIT_RECORDS, N_SPLIT_SPECIES = 200_000, 4_000
N_TAXO_ROWS = 20_000
# INSECT (Badirli et al.): 21,212 images of 1,213 species, 13,165 trainval,
# 4,965 test-seen, 3,082 test-unseen
N_INSECT, N_INSECT_SPECIES = 21_212, 1_213
INSECT_TRAINVAL, INSECT_TEST_SEEN = 13_165, 4_965


def _split_table(rng, n, n_species):
    """A BIOSCAN-like metadata table: long-tailed (Zipf 1.1) species over
    n records, 5% not_classified, with taxonomy columns."""
    import numpy as np
    import pandas as pd

    w = 1.0 / np.arange(1, n_species + 1) ** 1.1
    sp = rng.choice(n_species, size=n, p=w / w.sum())
    species = np.array([f"species_{i}" for i in range(n_species)],
                       dtype=object)[sp]
    species[rng.random(n) < 0.05] = "not_classified"
    return pd.DataFrame({
        "sampleid": [f"S{i:07d}" for i in range(n)],
        "uri": [f"BOLD:{i % 9973}" for i in range(n)],
        "image_file": [f"{i}.jpg" for i in range(n)],
        "species": species, "genus": [f"genus_{i % 997}" for i in sp],
        "family": [f"family_{i % 211}" for i in sp],
        "order": [f"order_{i % 13}" for i in sp]})


def _host_tables(rng, root):
    """The pandas and scipy tools at full size: data/splits.create_splits
    (every record placed once, no species in both seen and unseen splits),
    cli/get_species_taxo_labels' local-table mode over the table's first
    N_TAXO_ROWS rows (it walks rows in Python), cli/process_insect_dataset's
    .mat -> metadata CSV at INSECT's size."""
    import numpy as np
    import pandas as pd
    import scipy.io as sio

    from bioscan_clip_tpu_torch.cli import get_species_taxo_labels as taxo
    from bioscan_clip_tpu_torch.cli import process_insect_dataset as insect
    from bioscan_clip_tpu_torch.data.splits import create_splits

    md = _split_table(rng, N_SPLIT_RECORDS, N_SPLIT_SPECIES)
    t = time.perf_counter()
    out = create_splits(md, seed=0)
    secs = time.perf_counter() - t
    seen = set(out.loc[out["split"].isin(["train_seen", "val_seen",
                                          "test_seen"]), "species"])
    unseen = set(out.loc[out["split"].isin(["val_unseen", "test_unseen"]),
                         "species"])
    if not (len(out) == len(md) and out["sampleid"].is_unique
            and not seen & unseen):
        raise AssertionError("create_splits: a record or a species placed "
                             "twice")
    log(f"  data/splits.create_splits: {len(md)} records of "
        f"{md['species'].nunique()} species in {secs:.2f} s; "
        f"{out['split'].value_counts().to_dict()}")
    table = root / "taxonomy.tsv"
    md[:N_TAXO_ROWS].to_csv(table, sep="\t", index=False)
    t = time.perf_counter()
    mapping = taxo.from_metadata_table(str(table))
    if len(mapping) != md[:N_TAXO_ROWS]["species"].nunique():
        raise AssertionError(f"get_species_taxo_labels: {len(mapping)}")
    log(f"  get_species_taxo_labels: {N_TAXO_ROWS} rows, {len(mapping)} "
        "species in "
        f"{time.perf_counter() - t:.2f} s")

    labels = rng.integers(0, N_INSECT_SPECIES, size=N_INSECT)

    def cell(strings):
        return np.array([[x] for x in strings], dtype=object)

    sio.savemat(str(root / "res101.mat"), {
        "ids": cell([f"IMG{i:05d}" for i in range(N_INSECT)]),
        "bold_ids": cell([f"BOLD{i:05d}" for i in range(N_INSECT)]),
        "species": cell([f"species_{c}" for c in labels]),
        "nucleotides": cell(_barcodes(rng, N_INSECT)),
        "labels": (labels + 1).reshape(-1, 1)})
    idx = rng.permutation(N_INSECT) + 1
    test = INSECT_TRAINVAL + INSECT_TEST_SEEN
    sio.savemat(str(root / "att_splits.mat"), {
        "trainval_loc": idx[:INSECT_TRAINVAL][None],
        "train_loc": idx[:INSECT_TRAINVAL * 3 // 4][None],
        "val_loc": idx[INSECT_TRAINVAL * 3 // 4:INSECT_TRAINVAL][None],
        "test_seen_loc": idx[INSECT_TRAINVAL:test][None],
        "test_unseen_loc": idx[test:][None]})
    t = time.perf_counter()
    df = insect.save_metadata_csv(str(root / "res101.mat"),
                                  str(root / "att_splits.mat"),
                                  str(root / "INSECT_metadata.csv"))
    back = pd.read_csv(root / "INSECT_metadata.csv")
    sizes = {k: int(back[k].sum()) for k in insect.SPLITS}
    if (len(back) != N_INSECT or (back["labels"].to_numpy() != labels).any()
            or sizes["trainval_loc"] != INSECT_TRAINVAL
            or sizes["test_unseen_loc"] != N_INSECT - test):
        raise AssertionError(f"process_insect_dataset: {len(df)} rows, "
                             f"split sizes {sizes}")
    log(f"  process_insect_dataset .mat -> INSECT_metadata.csv: {len(back)} "
        f"rows in {time.perf_counter() - t:.2f} s, split sizes {sizes}")


def phase_data_tools():
    """The slice's tools that need none of the packages the card's machine
    lacks (h5py, matplotlib, sklearn and libjpeg, by the device phase's
    report of PR 14; it has pandas and scipy), at full width: the port's
    utils/flops counts against FLOPS_PER_SAMPLE; data/splits, the
    taxonomy table and INSECT's .mat -> CSV step (`_host_tables`);
    interop/torch_export.save_pth of the flagship
    (random seeded weights, bf16, on the card) and train/checkpoint.
    load_pth_into_params into a fresh model, the state dicts and one
    batch's embeddings bit-equal; the 5 x 6 sweep's results.csv, written
    by retrieval/report.py on embeddings of N_TOOLS_KEYS keys and
    N_TOOLS_QUERIES seen and unseen records, through cli/flatten_csv: one
    row per (metric, value column), each value the table's. Every step is
    fixed here, none chosen at run time. Returns the launch counts of the
    run (K1 and K2 in the embeddings)."""
    import csv
    import os
    import shutil
    from pathlib import Path

    import numpy as np
    import torch

    from bioscan_clip_tpu_torch.cli import flatten_csv
    from bioscan_clip_tpu_torch.config.core import ConfigNode
    from bioscan_clip_tpu_torch.interop.torch_export import save_pth
    from bioscan_clip_tpu_torch.models.clip import load_clip_model
    from bioscan_clip_tpu_torch.retrieval.report import (
        inference_and_print_result,
    )
    from bioscan_clip_tpu_torch.train.checkpoint import load_pth_into_params
    from bioscan_clip_tpu_torch.train.loop import extract_features

    counts = _port_flops()
    log("  utils/flops per sample: " + ", ".join(
        f"{k} {v / 1e9:.3f} GFLOP" for k, v in counts.items()))
    if counts != FLOPS_PER_SAMPLE:
        raise AssertionError(f"utils/flops: {counts} != {FLOPS_PER_SAMPLE}")

    root = Path("build") / "chip_smoke_data_tools"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cwd = os.getcwd()
    try:
        _host_tables(np.random.default_rng(15), root)
        torch.cuda.empty_cache()
        reset_counts()
        args = ConfigNode({"model_config": dict(FLAGSHIP)})
        model = load_clip_model(args, device="cuda", dtype=torch.bfloat16,
                                seed=0)
        path = root / "flagship.pth"
        t = time.perf_counter()
        save_pth(model, str(path))
        log(f"  save_pth (flagship, bf16 -> float32): "
            f"{path.stat().st_size / 2**20:.1f} MiB in "
            f"{time.perf_counter() - t:.2f} s")
        fresh = load_clip_model(args, device="cuda", dtype=torch.bfloat16,
                                seed=1)
        t = time.perf_counter()
        load_pth_into_params(str(path), fresh)
        log(f"  load_pth_into_params into a fresh model: "
            f"{time.perf_counter() - t:.2f} s")
        want, got = model.state_dict(), fresh.state_dict()
        bad = [k for k in want if not torch.equal(want[k], got[k])]
        if set(want) != set(got) or bad:
            raise AssertionError(f"save_pth -> load_pth_into_params: "
                                 f"differing {bad[:5]}")
        rng = np.random.default_rng(14)
        keys = _eval_records(rng, N_TOOLS_KEYS, EVAL_FRAME)
        batch = _batches(keys, EVAL_BATCH)[:1]
        a = extract_features(model, batch, for_key_set=True)
        b = extract_features(fresh, batch, for_key_set=True)
        feats = [k for k in a if isinstance(a[k], np.ndarray)]
        bad = [k for k in feats if not np.array_equal(a[k], b[k])]
        if bad or not feats:
            raise AssertionError(f"embeddings after the round trip: {bad}")
        log(f"  {len(want)} tensors and a batch's {len(feats)} embedding "
            "arrays bit-equal after the round trip")
        del fresh
        path.unlink()

        seen = _eval_records(rng, N_TOOLS_QUERIES, EVAL_FRAME, like=_take(
            keys, np.arange(N_TOOLS_QUERIES)))
        unseen = _eval_records(rng, N_TOOLS_QUERIES, EVAL_FRAME, snps=4,
                               like=_take(keys, np.arange(
                                   N_TOOLS_KEYS - N_TOOLS_QUERIES,
                                   N_TOOLS_KEYS)))
        splits = [extract_features(model, _batches(rec, len(rec["ids"])),
                                   for_key_set=i == 0)
                  for i, rec in enumerate((keys, seen, unseen))]
        os.chdir(root)  # report.py writes logs/ where it runs
        sweep_args = ConfigNode({"model_config": dict(FLAGSHIP),
                                 "save_inference": True})
        inference_and_print_result(*splits, args=sweep_args,
                                   k_list=[1, 3, 5], device="cuda",
                                   out=lambda *_: None)
        with open("logs/results.csv") as f:
            table = list(csv.DictReader(f))
        flatten_csv.main(["-i", "logs/results.csv", "-o", "flat.csv"])
        with open("flat.csv") as f:
            flat = list(csv.DictReader(f))
        cols = flatten_csv.METRIC_VALUE_COLUMNS
        fields = ("Query", "Key", "micro_macro", "top_k", "seen_unseen",
                  "taxon", "value")
        want = [(r["Query"], r["Key"], r["Metric"].split("_")[0],
                 r["Metric"].split("_")[1].replace("Top-", ""),
                 *c.split("_"), r[c]) for r in table for c in cols]
        got = [tuple(r[k] for k in fields) for r in flat]
        if got != want or len(flat) != len(table) * len(cols):
            raise AssertionError(f"flatten_csv: {len(flat)} rows for a "
                                 f"table of {len(table)} x {len(cols)}")
        log(f"  flatten_csv: the sweep's results.csv ({len(table)} rows x "
            f"{len(cols)} value columns) -> {len(flat)} rows, each value "
            "the table's")
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    counts, plain = launch_counts(), plain_calls()
    log(f"  launches on the data_tools path: {counts}; plain calls {plain}")
    if counts["mha_packed"] <= 0 or counts["mha"] <= 0 or any(plain.values()):
        raise AssertionError(f"data_tools: launches {counts}, plain {plain}")
    del model
    torch.cuda.empty_cache()
    log("phase data_tools ok")
    return counts


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
    if "train_cl" in phases:
        path_counts["train_cl"] = phase_train_cl()
    if "insect" in phases:
        path_counts["insect"] = phase_insect()
    if "data_tools" in phases:
        path_counts["data_tools"] = phase_data_tools()
    if "distributed" in phases:
        path_counts["distributed"] = phase_distributed()
    if "graphs" in phases:
        path_counts["graphs"] = phase_graphs()
    if "streaming" in phases:
        path_counts["streaming"] = phase_streaming()
    if "probe" in phases:
        path_counts["probe"] = phase_probe()
    if "parity" in phases:
        phase_parity()
    log(f"elapsed {time.perf_counter() - t0:.1f} s")
    by_path = {name: {path: path_counts[path].get(name) for path in paths
                      if path in path_counts}
               for name, paths in KERNEL_PATH.items()}
    launches = {name: path_counts.get(paths[0], {}).get(name)
                for name, paths in KERNEL_PATH.items()}

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = rows.get(name, {})
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_by_path": by_path[name],
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
