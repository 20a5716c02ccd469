"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py                    # every phase, as the check runs it
    python3 chip_smoke.py --phases kernels   # device, build and kernel phases

Phases, in order; any failure exits non-zero:
  device    the card's name and power limit (nvidia-smi)
  build     nvcc builds every kernel under bioscan_clip_tpu_torch/csrc
  kernels   each kernel against its plain PyTorch version at the flagship
            shapes (fp32 and bf16 for attention), with the kernel's, the
            plain version's and one library call's time
  serving   the flagship model at full width (random seeded weights, bf16)
            behind cli/serve.build_service over 1,048,576 resident keys:
            handle_request for dna, text, embedding and embed_images, and
            HTTP /search and /embed on localhost; every kernel must have
            launched
  parity    the fp32 port on the card against the same model on the CPU

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
PEAK = {"bytes": 3.35e12, "bfloat16": 989e12, "float32": 67e12}
ALL_PHASES = ("device", "build", "kernels", "serving", "parity")


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
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln or "error" in ln:
                log(f"  nvcc {name}: {ln.strip()}")
    log(f"phase build ok: {_build.sources()} in {secs:.1f} s")


def _attention_case(name, b, n, d, heads, dtype, with_bias, gen, packed):
    import torch
    import torch.nn.functional as F

    from bioscan_clip_tpu_torch.ops import attention

    dev = torch.device("cuda")
    hd = d // heads
    if packed:
        qkv = torch.randn(b, n, 3 * d, device=dev, generator=gen).to(dtype)
        q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]

        def kernel():
            return attention.mha_packed(qkv, heads)
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
        return attention.mha_reference(q, k, v, heads, bias=bias)

    def view(t):
        return t.view(b, n, heads, hd).transpose(1, 2)

    mask = None if bias is None else bias[:, None, None, :].to(dtype)

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
    n_bytes = 4 * b * n * d * es + (0 if bias is None else b * n * 4)
    n_ops = 4 * b * heads * n * n * hd
    dname = str(dtype).split(".")[-1]
    bms, by = bound_ms(n_bytes, n_ops, dname)
    row = {
        "ms": time_ms(kernel), "plain_ms": time_ms(plain, reps=3),
        "library_ms": time_ms(library), "bound_ms": bms, "bound_by": by,
        "max_abs_err": err,
    }
    log(f"  {name} {dname} B={b} N={n} D={d} h={heads}"
        f"{' bias' if with_bias else ''}: err {err:.3g} (tol {tol:g}), "
        f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"sdpa {row['library_ms']:.4f} ms, bound {bms:.4f} ms ({by})")
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
    keys, rows["topk"] = _topk_case(gen)
    del keys
    torch.cuda.empty_cache()
    log("phase kernels ok")


KERNELS = {
    # name: (route, source, the TPU kernel it replaces)
    "mha_packed": ("cuda", "bioscan_clip_tpu_torch/csrc/mha_fwd.cu",
                   "bioscan_clip_tpu/ops/attention.py:425"),
    "mha": ("cuda", "bioscan_clip_tpu_torch/csrc/mha_fwd.cu",
            "bioscan_clip_tpu/ops/attention.py:449"),
    "topk": ("cuda", "bioscan_clip_tpu_torch/csrc/topk.cu",
             "bioscan_clip_tpu/ops/topk_pallas.py:185"),
}


def launch_counts():
    from bioscan_clip_tpu_torch.ops import attention, topk

    return {"mha_packed": attention.mha_packed.launches,
            "mha": attention.mha.launches, "topk": topk.topk.launches}


def reset_counts():
    from bioscan_clip_tpu_torch.ops import attention, topk

    attention.mha_packed.launches = 0
    attention.mha.launches = 0
    topk.topk.launches = 0


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
N_KEYS = 1 << 20
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
        counts = launch_counts()
    log(f"  launches on the main path: {counts}")
    missing = [name for name, c in counts.items() if c <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    log("phase serving ok")
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
    log("phase parity ok")


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
    launches = {name: None for name in KERNELS}
    phase_device()
    phase_build()
    if "kernels" in phases:
        phase_kernels(rows)
    if "serving" in phases:
        launches = phase_serving()
    if "parity" in phases:
        phase_parity()
    log(f"elapsed {time.perf_counter() - t0:.1f} s")

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
