"""K1 and K1m (`ops/attention.mha_packed`, bf16, without and with the
causal (N, N) mask) on the card at the main path's shapes, beside SDPA and
the bound.

K1's shapes (B, N, D, heads): ViT-B/16 at serving's 8 images, eval's
batches of 24 and training's 256 and 400 (N = 197, D = 768, h = 12), and
ViT-L/14 at B = 256 (N = 257, D = 1024, h = 16). K1m's: the OpenCLIP text
tower (D = 768, h = 12) at serving's B = 64 with CLIP-BPE's N = 77 and
WordPiece's N = 20, and training's B = 10 at N = 20. Each call is captured
--reps times into one CUDA graph and the replay timed with CUDA events, so
the time is the card's and not the wrapper's host cost. One JSON object
per shape:

  shape        [B, N, D, heads]
  k1_ms        card ms per `mha_packed` call (K1)
  sdpa_ms      card ms per `scaled_dot_product_attention` on the same q, k,
               v (heads-major views of the packed tensor; for K1m with the
               mask as a float `attn_mask`)
  bound_ms     max(bytes / 3.35 TB/s, operations / 989 TFLOP/s): q, k, v
               (and the mask) read once, o written once; 4 B h N^2 hd
               operations
  max_abs_err  |mha_packed - mha_reference| (the plain version)
  sm90         the package has the sm90 body and this call went through it
K1m's rows have "mask": "causal" and, in place of k1_ms and sm90:
  k1m_ms       card ms per `mha_packed(mask=)` call, on the plan's body
  body         that body (`plan_packed_fwd(masked=True)`)
  sm90_ms      card ms on the Hopper body under a forced masked plan
               (`sm90_fwd_plan(masked=True)`), null where the package has
               no masked Hopper body
  old_ms       card ms on the bodies of `csrc/mha_fwd.cu` (`_launch_fwd`:
               mma.sync above N = 32, FFMA at N <= 32)
  sm90_err, old_err   each body's max |error| against the plain version

The package is the one on the import path, so one checkout's script times
another checkout's K1: run it from that checkout's root with
`PYTHONPATH=.`, and compare two packages in one call, in turns:

    PYTHONPATH=. python3 path/to/bench_k1.py [--reps 20]

The first line names the imported package's file and the card (name and
power limit, as nvidia-smi gives them). `--sass` adds, after the shapes,
one row per K1 instantiation they run (208 and 272 key rows) read from the
package's built library with cuobjdump: `registers`, `stack` and `local`
bytes (`-res-usage`), the SASS `instructions`, their count by opcode and
`sha1`, a hash of their text in order (`-sass`), so that two checkouts'
K1 code can be compared.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import re
import shutil
import subprocess

SHAPES = ((8, 197, 768, 12), (24, 197, 768, 12), (256, 197, 768, 12),
          (400, 197, 768, 12), (256, 257, 1024, 16))
MASK_SHAPES = ((64, 77, 768, 12), (64, 20, 768, 12), (10, 20, 768, 12))
PEAK_BYTES, PEAK_BF16 = 3.35e12, 989e12


def bound_ms(b: int, n: int, d: int, heads: int, masked: bool = False):
    """The least card ms of `mha_packed` at (B, N, D, heads) in bf16: q, k,
    v (and the (N, N) fp32 mask) read once and o written once at 3.35
    TB/s, or 4 B h N^2 hd operations at 989 TFLOP/s, whichever is
    larger."""
    n_bytes = 4 * b * n * d * 2 + (4 * n * n if masked else 0)
    n_ops = 4 * b * heads * n * n * (d // heads)
    return 1e3 * max(n_bytes / PEAK_BYTES, n_ops / PEAK_BF16)


def graph_ms(fn, reps: int = 20) -> float:
    """Card ms per call of `fn`, captured `reps` times into one CUDA graph
    and replayed: no host time between the launches, so a kernel shorter
    than its wrapper's host cost is timed as the card runs it."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sass", action="store_true",
                    help="also K1's registers and SASS from cuobjdump")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from bioscan_clip_tpu_torch.ops import attention

    if not torch.cuda.is_available():
        raise SystemExit("bench_k1: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({"package": attention.__file__, "card": card}),
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for b, n, d, heads in SHAPES:
        hd = d // heads
        qkv = torch.randn(b, n, 3 * d, device="cuda",
                          generator=gen).to(torch.bfloat16)
        q, k, v = (qkv[..., i * d:(i + 1) * d].view(b, n, heads, hd)
                   .transpose(1, 2) for i in range(3))
        with torch.inference_mode():
            before = getattr(attention.mha_packed, "sm90_launches", None)
            out = attention.mha_packed(qkv, heads)
            sm90 = (before is not None
                    and attention.mha_packed.sm90_launches == before + 1)
            ref = attention.mha_reference(
                qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], heads)
            err = (out.float() - ref.float()).abs().max().item()
            del out, ref
            k1 = graph_ms(lambda: attention.mha_packed(qkv, heads),
                          args.reps)
            sdpa = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                            args.reps)
        print(json.dumps({"shape": [b, n, d, heads], "k1_ms": k1,
                          "sdpa_ms": sdpa,
                          "bound_ms": bound_ms(b, n, d, heads),
                          "max_abs_err": err, "sm90": sm90}), flush=True)
        del qkv, q, k, v
        torch.cuda.empty_cache()
    for b, n, d, heads in MASK_SHAPES:
        print(json.dumps(_k1m_row(attention, gen, b, n, d, heads, args.reps)),
              flush=True)
        torch.cuda.empty_cache()
    if args.sass:
        lib = attention._sm90_kernel()[0]
        for row in sass_rows(lib._name, {-(-n // 16) for _, n, _, _ in
                                         SHAPES}):
            print(json.dumps(row), flush=True)


def mask_bodies(attention, qkv, heads, mask):
    """{body: a call of it} for K1m: the plan's (`mha_packed(mask=)`), the
    Hopper body under a forced masked plan (where the package has one) and
    csrc/mha_fwd.cu's."""
    import torch

    b, n, d3 = qkv.shape
    d = d3 // 3
    hd = d // heads
    p = qkv.data_ptr()
    ptrs = (p, p + 2 * d, p + 4 * d)
    outs = {"plan": lambda: attention.mha_packed(qkv, heads, mask=mask)}
    if hasattr(attention, "SM90_MASK_MAX_N"):
        plan = attention.sm90_fwd_plan(b, n, heads, masked=True)
        o_sm90 = torch.empty(b, n, d, dtype=qkv.dtype, device=qkv.device)

        def sm90():
            attention._launch_sm90(ptrs, o_sm90, d3, plan, hd ** -0.5,
                                   mask=mask)
            return o_sm90

        outs["sm90"] = sm90
    o_old = torch.empty(b, n, d, dtype=qkv.dtype, device=qkv.device)

    def old():
        attention._launch_fwd(ptrs, o_old, b, n, heads, hd, d3, hd ** -0.5,
                              qkv.dtype, None, mask=mask)
        return o_old

    outs["old"] = old
    return outs


# the K1m row's keys of each body's time and error
MASK_KEYS = {"plan": ("k1m_ms", "max_abs_err"),
             "sm90": ("sm90_ms", "sm90_err"), "old": ("old_ms", "old_err")}


def _k1m_row(attention, gen, b, n, d, heads, reps):
    import torch
    import torch.nn.functional as F

    from bioscan_clip_tpu_torch.models.openclip import causal_mask

    hd = d // heads
    qkv = torch.randn(b, n, 3 * d, device="cuda",
                      generator=gen).to(torch.bfloat16)
    mask = causal_mask(n, "cuda")
    views = [qkv[..., i * d:(i + 1) * d].view(b, n, heads, hd)
             .transpose(1, 2) for i in range(3)]
    row = {"shape": [b, n, d, heads], "mask": "causal",
           "sm90_ms": None, "sm90_err": None}
    with torch.inference_mode():
        ref = attention.mha_reference(qkv[..., :d], qkv[..., d:2 * d],
                                      qkv[..., 2 * d:], heads, mask=mask)
        for key, fn in mask_bodies(attention, qkv, heads, mask).items():
            ms_key, err_key = MASK_KEYS[key]
            row[err_key] = (fn().float() - ref.float()).abs().max().item()
            row[ms_key] = graph_ms(fn, reps)
        float_mask = mask.to(qkv.dtype)
        row["sdpa_ms"] = graph_ms(
            lambda: F.scaled_dot_product_attention(*views,
                                                   attn_mask=float_mask),
            reps)
    row["body"] = attention.plan_packed_fwd(b, n, heads, hd, qkv.dtype,
                                            masked=True).body
    row["bound_ms"] = bound_ms(b, n, d, heads, masked=True)
    return row


# K1's instantiation, mangled: mha_fwd_sm90<KT>, mha_fwd_sm90<KT, false,
# false> or mha_fwd_sm90<KT, false, false, false> (in an anonymous
# namespace: the template arguments end in "EE"); not K1m's <KT, false,
# false, true>
K1_SYMBOL = re.compile(r"mha_fwd_sm90ILi(\d+)E(?:Lb0ELb0E(?:Lb0E)?)?E")


def _cuobjdump(*args) -> str:
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([exe, *args], capture_output=True, text=True,
                          check=True).stdout


def sass_rows(lib_path, kts):
    """{"sass", "key_rows", "registers", "stack", "local", "instructions",
    "opcodes", "sha1"} of each K1 instantiation of `kts` 16-key chunks in
    the library at `lib_path` ("sha1": the first 16 hex digits of the hash
    of its instructions' text, addresses and encodings left out)."""
    rows = {}
    fn = None
    for ln in _cuobjdump("-res-usage", lib_path).splitlines():
        m = K1_SYMBOL.search(ln)
        if "Function" in ln:
            fn = int(m[1]) if m and int(m[1]) in kts else None
        elif fn and "REG:" in ln:
            use = dict(re.findall(r"(\w+):(\d+)", ln))
            rows[fn] = {"sass": f"K1 mha_fwd_sm90 at {16 * fn} key rows",
                        "key_rows": 16 * fn,
                        "registers": int(use["REG"]),
                        "stack": int(use["STACK"]),
                        "local": int(use["LOCAL"]),
                        "instructions": 0, "opcodes": collections.Counter(),
                        "sha1": hashlib.sha1()}
            fn = None
    for ln in _cuobjdump("-sass", lib_path).splitlines():
        m = K1_SYMBOL.search(ln)
        if "Function :" in ln:
            fn = int(m[1]) if m and int(m[1]) in rows else None
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z]\S*)",
                       ln)
        if fn and ins:
            rows[fn]["instructions"] += 1
            rows[fn]["opcodes"][ins[2].split(".")[0].rstrip(";")] += 1
            text = ln.split("*/", 1)[1].split(";")[0].strip()
            rows[fn]["sha1"].update(text.encode() + b"\n")
    return [dict(r, opcodes=dict(r["opcodes"].most_common()),
                 sha1=r["sha1"].hexdigest()[:16])
            for _, r in sorted(rows.items())]


if __name__ == "__main__":
    main()
