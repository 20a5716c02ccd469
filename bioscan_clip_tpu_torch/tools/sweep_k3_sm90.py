"""Design sweep of K3's sm90 body (`csrc/mha_bwd_sm90.cu`) on the card:
variants of the source, each a set of text edits, built side by side and
timed in one process, so that they share a card; then where each pass's
time goes, and the N whose pass A spills against the mma.sync body.

Variants:
  as_built   the source as it is
  turns      the two warpgroups take turns to issue their products, as
             K1's consumers do (named barriers 3 and 4)
  hash_skip  a warp whose 16 query rows (pass A) or keys (pass B) all lie
             past N skips the dropout hash
  chunks_32  pass A's dP chunks of 32 keys above 208 key rows (64 below)
Rows, one JSON object each, every one with the card (name and power
limit):
  {"variant", "ptxas"}    ptxas' lines for pass B and pass A at 144, 208
                          and 272 key rows, with and without dropout
  {"variant", "shape", "round", "ms", "bit_equal"}
                          `mha_bwd` through the variant's library at the
                          shapes of `tools/bench_k3.py`, CUDA events over
                          --reps calls; the variants in order, then in
                          reverse (round 2); bit_equal: its dq, dk, dv
                          equal as_built's
  {"passes", "shape", "rate", "ms"}
                          as_built's card ms per call of pass A and pass B
                          (torch.profiler over --reps calls), at the bench
                          shapes and BarcodeBERT's without dropout
  {"spills", "shape", "rate", "sm90_ms", "mma_ms", "max_diff"}
                          as_built at the N whose pass A spills (dropout
                          at 197 and 257, 240 and 272 without) and at
                          the flagship's, beside the mma.sync passes of
                          csrc/mha_bwd.cu (`ops.attention._launch_bwd`)
                          on the same inputs
Exit 1 if a variant's output differs from as_built's.

--mask times K3m instead, no variant built: the package's sm90 body
(`attention.bwd_sm90_plan(masked=True)`, forced below the plan's N) against
the mma.sync passes of csrc/mha_bwd.cu, packed bf16 qkv at D = 768,
h = 12 under OpenCLIP's causal mask, each at every N of --n and B of --b
as replays of a CUDA graph of --reps calls, in turns (sm90, mma.sync,
mma.sync, sm90). One row each:
  {"crossing", "shape", "sm90_ms", "mma_ms", "max_diff"}
                          crossing: the body `plan_bwd` gives the shape;
                          sm90_ms, mma_ms: both turns' ms; max_diff: max
                          |sm90 - mma.sync| over dqkv
Exit 1 if the two bodies differ by more than 2e-2 * max(1, max |dqkv|).
Needs a CUDA device and nvcc.

    python -m bioscan_clip_tpu_torch.tools.sweep_k3_sm90 [--reps 20]
    python -m bioscan_clip_tpu_torch.tools.sweep_k3_sm90 --mask \
        [--n 8,20,77] [--b 10,64]
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import subprocess
import sys

import torch

from bioscan_clip_tpu_torch.ops import _build, attention
from bioscan_clip_tpu_torch.tools.bench_k3 import SHAPES, events_ms

SOURCE = "mha_bwd_sm90.cu"
# the named-barrier turns of K1's consumers
TURNS_STRUCT = '''
struct Turns {
  int c, left;

  __device__ Turns(int c_, int items_here, int per_item)
      : c(c_), left(items_here * per_item) {
    if (c == 1 && left > 0) pass_to_other();
  }
  __device__ void take() const {
    asm volatile("bar.sync %0, 256;\\n" ::"r"(3 + c) : "memory");
  }
  __device__ void give() {
    if (--left > 0 || c == 0) pass_to_other();
  }
  __device__ void pass_to_other() const {
    asm volatile("bar.arrive %0, 256;\\n" ::"r"(4 - c) : "memory");
  }
};

// ---- pass A: per query tile'''
HERE = ("(a.items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x")
ISSUE_A = '''      wgmma_fence();
      product_nt<W>(dp, gs, vs + J0 * 16 * kRowBytes);
      wgmma_commit();
      wgmma_wait();'''
VARIANTS = {
    "as_built": [],
    "turns": [
        ("\n// ---- pass A: per query tile", TURNS_STRUCT),
        ("  if (threadIdx.x == 0 && (int)blockIdx.x < a.items) load(blockIdx.x, "
         "0);\n  int it = 0;\n  for (int item = blockIdx.x; item < a.items; "
         "item += gridDim.x, ++it) {\n    // the next item's loads run under "
         "this item's products\n    if (threadIdx.x == 0 && item + "
         "(int)gridDim.x < a.items)\n      load(item + gridDim.x, it + 1);\n"
         "    const int s = it & 1;\n    const Item w(item, a.heads, pairs);\n"
         "    const int tile = kConsumers * w.pair + c;\n    const uint32_t "
         "st = base + s * kStage;",
         "  constexpr int kTurns = 1 + 3 * ((KT + kChunk - 1) / kChunk);\n"
         f"  Turns turns(c, {HERE}, kTurns);\n"
         "  if (threadIdx.x == 0 && (int)blockIdx.x < a.items) load(blockIdx.x, "
         "0);\n  int it = 0;\n  for (int item = blockIdx.x; item < a.items; "
         "item += gridDim.x, ++it) {\n    if (threadIdx.x == 0 && item + "
         "(int)gridDim.x < a.items)\n      load(item + gridDim.x, it + 1);\n"
         "    const int s = it & 1;\n    const Item w(item, a.heads, pairs);\n"
         "    const int tile = kConsumers * w.pair + c;\n    const uint32_t "
         "st = base + s * kStage;"),
        ("    mbar_wait(bars + 8 * s, (it >> 1) & 1);\n    if (tile >= "
         "a.tiles) {  // an odd tile count: nothing for this one\n      if "
         "(tid == 0) mbar_arrive(empty);\n      continue;\n    }\n    const "
         "int row0",
         "    mbar_wait(bars + 8 * s, (it >> 1) & 1);\n    if (tile >= "
         "a.tiles) {\n      for (int i = 0; i < kTurns; ++i) {\n        "
         "turns.take();\n        turns.give();\n      }\n      if (tid == 0) "
         "mbar_arrive(empty);\n      continue;\n    }\n    const int row0"),
        ("    wgmma_fence();\n    product_nt<KT>(sc, qs, ks);\n    "
         "wgmma_commit();\n",
         "    turns.take();\n    wgmma_fence();\n    product_nt<KT>(sc, qs, "
         "ks);\n    wgmma_commit();\n    turns.give();\n"),
        (ISSUE_A, ISSUE_A.replace("      wgmma_fence();",
                                  "      turns.take();\n      wgmma_fence();")
         .replace("      wgmma_commit();",
                  "      wgmma_commit();\n      turns.give();")),
        ("      wgmma_fence();\n#pragma unroll\n      for (int u = 0; u < W; "
         "++u)\n        wgmma_rs64(dq, da[u],\n                   "
         "sw128_desc(ks + (J0 + u) * 16 * kRowBytes, 1024));\n      "
         "wgmma_commit();\n",
         "      turns.take();\n      wgmma_fence();\n#pragma unroll\n      "
         "for (int u = 0; u < W; ++u)\n        wgmma_rs64(dq, da[u],\n"
         "                   sw128_desc(ks + (J0 + u) * 16 * kRowBytes, "
         "1024));\n      wgmma_commit();\n      turns.give();\n"),
        ("                                          const Args& a, uint32_t "
         "kt,",
         "                                          Turns& turns, const Args& "
         "a, uint32_t kt,"),
        ("  wgmma_fence();\n  product_nt<W>(sT, kt, qs + q0 * kRowBytes);\n"
         "  product_nt<W>(dpT, vt, gs + q0 * kRowBytes);\n  wgmma_commit();\n",
         "  turns.take();\n  wgmma_fence();\n  product_nt<W>(sT, kt, qs + q0 "
         "* kRowBytes);\n  product_nt<W>(dpT, vt, gs + q0 * kRowBytes);\n  "
         "wgmma_commit();\n  turns.give();\n"),
        ("  fence_regs(sa);\n  wgmma_fence();",
         "  fence_regs(sa);\n  turns.take();\n  wgmma_fence();"),
        ("    wgmma_rs64(dk, sa[u], sw128_desc(qs + r * kRowBytes, 1024));\n"
         "  }\n  wgmma_commit();\n",
         "    wgmma_rs64(dk, sa[u], sw128_desc(qs + r * kRowBytes, 1024));\n"
         "  }\n  wgmma_commit();\n  turns.give();\n"),
        ("  const int tail = (a.key_rows / 16) % kChunk;\n",
         "  const int tail = (a.key_rows / 16) % kChunk;\n  const int per_item "
         f"= 2 * (full_chunks + (tail > 0));\n  Turns turns(c, {HERE}, "
         "per_item);\n"),
        ("    if (tile >= a.tiles) {  // an odd tile count: nothing for this "
         "one\n      if (tid == 0) mbar_arrive(empty);\n      continue;\n    }"
         "\n    const int j0",
         "    if (tile >= a.tiles) {\n      for (int i = 0; i < per_item; "
         "++i) {\n        turns.take();\n        turns.give();\n      }\n"
         "      if (tid == 0) mbar_arrive(empty);\n      continue;\n    }\n"
         "    const int j0"),
        ("key_chunk<kChunk, DROP, MASK, READOUT>(dk, dv, a,",
         "key_chunk<kChunk, DROP, MASK, READOUT>(dk, dv, turns, a,"),
        ("key_chunk<1, DROP, MASK, READOUT>(dk, dv, a,",
         "key_chunk<1, DROP, MASK, READOUT>(dk, dv, turns, a,"),
        ("key_chunk<2, DROP, MASK, READOUT>(dk, dv, a,",
         "key_chunk<2, DROP, MASK, READOUT>(dk, dv, turns, a,"),
        ("key_chunk<3, DROP, MASK, READOUT>(dk, dv, a,",
         "key_chunk<3, DROP, MASK, READOUT>(dk, dv, turns, a,"),
    ],
    "hash_skip": [
        ("#pragma unroll\n      for (int e = 0; e < 8 * KT; ++e) {\n        "
         "const int i = row0 + row_of(e & 7);",
         "#pragma unroll\n      for (int e = 0; e < 8 * KT; ++e) {\n        "
         "if (row0 - g >= n) break;\n        const int i = row0 + "
         "row_of(e & 7);"),
        ("        const float f = a.drop.factor(dbase, dseed, i, j, n);",
         "        const float f = j0 - g < n ? a.drop.factor(dbase, dseed, "
         "i, j, n) : 0.f;"),
        ("                                          int q0, int j0, int t,",
         "                                          int q0, int j0, int t, "
         "int g,"),
        ("stats, 16 * kChunk * q, j0, t,\n",
         "stats, 16 * kChunk * q, j0, t, g,\n"),
        ("q0, j0, t, bh, dbase, dseed, mask_j);",
         "q0, j0, t, g, bh, dbase, dseed, mask_j);"),
    ],
    "chunks_32": [
        ("    for_chunks<KT, 0>([&](auto j0, auto wn) {",
         "    for_chunks<KT, 0, (KT > 13 ? kChunk / 2 : kChunk)>([&](auto j0, "
         "auto wn) {"),
        ("template <int KT, int J, typename F>\n__device__ __forceinline__ "
         "void for_chunks(F&& f) {\n  if constexpr (J < KT) {\n    constexpr "
         "int W = KT - J < kChunk ? KT - J : kChunk;\n    f(std::"
         "integral_constant<int, J>{}, std::integral_constant<int, W>{});\n"
         "    for_chunks<KT, J + kChunk>(f);",
         "template <int KT, int J, int CH, typename F>\n__device__ "
         "__forceinline__ void for_chunks(F&& f) {\n  if constexpr (J < KT) "
         "{\n    constexpr int W = KT - J < CH ? KT - J : CH;\n    f(std::"
         "integral_constant<int, J>{}, std::integral_constant<int, W>{});\n"
         "    for_chunks<KT, J + CH, CH>(f);"),
    ],
}
# (B, N, D, heads, dropout rate): pass A's spilling instantiations and the
# flagship's two shapes, split layout
SPILL_SHAPES = ((400, 197, 768, 12, 0.1), (64, 257, 768, 12, 0.1),
                (400, 240, 768, 12, 0.0), (64, 272, 768, 12, 0.0),
                (400, 133, 768, 12, 0.1), (400, 197, 768, 12, 0.0))


def variant_sources(source: str) -> dict[str, str]:
    """Each variant's text; raises if an edit no longer applies."""
    out = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if text.count(old) < 1:
                raise ValueError(f"{name}: {old[:60]!r} not in {SOURCE}")
            text = text.replace(old, new)
        out[name] = text
    return out


def ptxas_lines(log: str) -> list[str]:
    """Registers and spills of pass B and of pass A at 144, 208 and 272 key
    rows."""
    out, fn = [], ""
    for ln in log.splitlines():
        if "Function properties for" in ln:
            a = re.search(r"pass_aILi(9|13|17)ELb(\d)ELb0E", ln)
            b = re.search(r"pass_bILb(\d)ELb0E", ln)
            fn = (f"A {16 * int(a[1])} rows drop {a[2]}" if a
                  else f"B drop {b[1]}" if b else "")
        elif fn and ("spill" in ln or "registers" in ln):
            out.append(f"{fn}: {ln.split(':', 1)[-1].strip()}")
    return out


def _library(lib):
    lib.bscan_error_string.argtypes = [ctypes.c_int]
    lib.bscan_error_string.restype = ctypes.c_char_p
    return attention.bwd_sm90_entry(lib)


@contextlib.contextmanager
def _using(kernel):
    """`ops.attention.mha_bwd` launching K3's sm90 body from `kernel`."""
    saved = attention._bwd_sm90_kernel
    attention._bwd_sm90_kernel = lambda: kernel
    try:
        yield
    finally:
        attention._bwd_sm90_kernel = saved


def _inputs(gen, b, n, d, packed):
    def rand(width):
        return torch.randn(b, n, width, device="cuda",
                           generator=gen).to(torch.bfloat16)

    if packed:
        qkv = rand(3 * d)
        return qkv, (qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:])
    return None, (rand(d), rand(d), rand(d))


def _call(q, k, v, g, heads, qkv, kw):
    if qkv is not None:
        return attention.mha_bwd(None, None, None, g, heads, packed_qkv=qkv,
                                 **kw)
    return attention.mha_bwd(q, k, v, g, heads, **kw)


def _flat(out):
    """dq | dk | dv of either layout, for comparing two launches."""
    return out if torch.is_tensor(out) else torch.cat(out[:3], -1)


def _ints(spec: str) -> list[int]:
    """"1-3,8" -> [1, 2, 3, 8]."""
    out = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out += range(int(lo), int(hi or lo) + 1)
    return out


def _pass_ms(fn, reps):
    """Card ms per call of pass A and of pass B (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        for name in ("pass_a", "pass_b"):
            if f"mha_bwd_sm90_{name}" in ev.key:
                out[name] = ev.device_time_total / 1e3 / reps
    return out


def mask_crossing(gen, ns, bs, reps, card) -> bool:
    """K3m on the sm90 body against the mma.sync passes (see --mask);
    False if the bodies disagree somewhere."""
    from bioscan_clip_tpu_torch.models.openclip import causal_mask
    from bioscan_clip_tpu_torch.tools.bench_k1 import graph_ms

    d, heads = 768, 12
    scale = (d // heads) ** -0.5
    ok = True
    for b in bs:
        for n in ns:
            qkv, (q, k, v) = _inputs(gen, b, n, d, True)
            g = _inputs(gen, b, n, d, False)[1][0]
            mask = causal_mask(n, "cuda")
            plan = attention.bwd_sm90_plan(b, n, heads, masked=True)

            def sm90():
                return attention._launch_bwd_sm90(
                    plan, None, None, None, g, scale, attention._NO_DROP,
                    qkv, mask=mask)

            def mma():
                return attention._launch_bwd(q, k, v, g, heads, scale,
                                             attention._NO_DROP,
                                             packed_qkv=qkv, mask=mask)

            ref = mma()
            diff = (sm90().float() - ref.float()).abs().max().item()
            ok &= diff <= 2e-2 * max(1.0, ref.float().abs().max().item())
            times = [graph_ms(fn, reps) for fn in (sm90, mma, mma, sm90)]
            print(json.dumps({
                "crossing": attention.plan_bwd(b, n, heads, d // heads,
                                               masked=True).body,
                "shape": [b, n, d, heads], "sm90_ms": times[::3],
                "mma_ms": times[1:3], "max_diff": diff, "device": card}),
                flush=True)
            del qkv, q, k, v, g, ref
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mask", action="store_true",
                    help="K3m's crossing against the mma.sync body only")
    ap.add_argument("--n", default=f"1-{attention.BWD_SM90_MASK_MAX_N}",
                    help="--mask: N values, a list and ranges (1-144)")
    ap.add_argument("--b", default="10,64", help="--mask: batch sizes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_k3_sm90: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    if args.mask:
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        return 0 if mask_crossing(gen, _ints(args.n), _ints(args.b),
                                  args.reps, card) else 1
    sources = {name: (text, _build.CSRC_DIR) for name, text in
               variant_sources((_build.CSRC_DIR / SOURCE).read_text())
               .items()}
    libs = {name: _library(lib) for name, lib in _build.build_sources(
        sources, _build.BUILD_DIR.parent / "k3_sm90_sweep").items()}
    for name in libs:
        print(json.dumps({"variant": name, "device": card,
                          "ptxas": ptxas_lines(_build.build_logs[name])}),
              flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    bad = []
    order = list(libs)
    for b, n, d, heads, packed, rate in SHAPES:
        qkv, (q, k, v) = _inputs(gen, b, n, d, packed)
        g = _inputs(gen, b, n, d, False)[1][0]
        seeds = torch.randint(0, 2**32, (b,), device="cuda", generator=gen)
        kw = dict(dropout_rate=rate, dropout_seed=seeds) if rate else {}
        with _using(libs["as_built"]):
            ref = _flat(_call(q, k, v, g, heads, qkv, kw))
        for rnd, names in ((1, order), (2, order[::-1])):
            for name in names:
                with _using(libs[name]):
                    same = torch.equal(
                        _flat(_call(q, k, v, g, heads, qkv, kw)), ref)
                    ms = events_ms(lambda: _call(q, k, v, g, heads, qkv, kw),
                                   args.reps)
                row = {"variant": name, "shape": [b, n, d, heads],
                       "rate": rate, "round": rnd, "ms": ms,
                       "bit_equal": same, "device": card}
                if not same:
                    bad.append(row)
                print(json.dumps(row), flush=True)
        del qkv, q, k, v, g, ref
        torch.cuda.empty_cache()
    with _using(libs["as_built"]):
        for b, n, d, heads, packed, rate in SHAPES + (
                (400, 133, 768, 12, False, 0.0),):
            qkv, (q, k, v) = _inputs(gen, b, n, d, packed)
            g = _inputs(gen, b, n, d, False)[1][0]
            seeds = torch.randint(0, 2**32, (b,), device="cuda",
                                  generator=gen)
            kw = dict(dropout_rate=rate, dropout_seed=seeds) if rate else {}
            print(json.dumps({
                "passes": _pass_ms(lambda: _call(q, k, v, g, heads, qkv, kw),
                                   args.reps),
                "shape": [b, n, d, heads], "rate": rate, "device": card}),
                flush=True)
        for b, n, d, heads, rate in SPILL_SHAPES:
            _, (q, k, v) = _inputs(gen, b, n, d, False)
            g = _inputs(gen, b, n, d, False)[1][0]
            seeds = torch.randint(0, 2**32, (b,), device="cuda",
                                  generator=gen)
            kw = dict(dropout_rate=rate, dropout_seed=seeds) if rate else {}
            drop = attention._drop_args(rate, seeds if rate else None, b,
                                        q.device)

            def mma():
                return attention._launch_bwd(q, k, v, g, heads,
                                             (d // heads) ** -0.5, drop)

            out = _flat(_call(q, k, v, g, heads, None, kw))
            diff = (out - _flat(mma())).abs().max().item()
            print(json.dumps({
                "spills": attention.plan_bwd(b, n, heads, d // heads).body,
                "shape": [b, n, d, heads], "rate": rate,
                "sm90_ms": events_ms(lambda: _call(q, k, v, g, heads, None,
                                                   kw), args.reps),
                "mma_ms": events_ms(mma, args.reps), "max_diff": diff,
                "device": card}), flush=True)
            del q, k, v, g, out
            torch.cuda.empty_cache()
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
