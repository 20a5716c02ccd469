"""Design sweep of K1's and K1m's sm90 body (`csrc/mha_fwd_sm90.cu`) on the
card: variants of the source, each one text edit, built side by side and
timed in one process, so that they share a card; and K1m's crossing
against the body of csrc/mha_fwd.cu.

Variants:
  as_built       the source as it is
  lockstep       the consumers issue their products without taking turns
                 (both warpgroups run S, then both the softmax, then both
                 P . V)
  pieces_128     score rows cut into wgmma instructions of at most 128
                 keys (272 = 128 + 128 + 16, not 256 + 16)
  regs_24_240    `setmaxnreg` 24 for the producer, 240 for the consumers
  no_setmaxnreg  no `setmaxnreg`: every warp keeps the 168 registers of
                 the launch bound
  mask_sync      K1m's mask rows staged by plain loads and stores (each
                 thread's loads waited for before it goes on) instead of
                 4-byte cp.async under the stage's wait and the S product
  mask_ldg       K1m's mask read by each thread from device memory (L1)
                 in the softmax, one `__ldg` a score, instead of staged in
                 shared memory
  no_exp         p = s - max without the exp (timing only)
  no_pv          no P . V products: o = 0 (timing only)
  loads_only     the consumers wait for each stage and release it at
                 once: the TMA loads alone, no products, no stores
                 (timing only)
Shapes (B, N, D, heads): K1 at ViT-B/16 B = 8, 24, 256, 400 (N = 197) and
ViT-L/14 at B = 256 (N = 257), and K1m with the causal mask at OpenCLIP's
text shapes (`tools/bench_k1.MASK_SHAPES`), bf16. Each launch goes through
the library's C entry point with `ops.attention.plan_packed_fwd`'s plan
(K1m: `sm90_fwd_plan(masked=True)`), and is timed as --reps launches
captured into one CUDA graph (card clock). Rows, one JSON object each:
variant, shape, mask, round, ms, err (max |out - mha_reference|, for the
variants that compute the function) and the card (name and power limit);
first, one row per variant with ptxas' lines for K1's instantiations of
208 and 272 key rows and K1m's of 32, 80 and 160. The variants run in
order, then in reverse order (round 2). `--variants` names the variants
to build (default all).

`--crossing` times, on the package's own library (no variant is built),
K1m's sm90 body (under `sm90_fwd_plan(masked=True)`) beside the body of
csrc/mha_fwd.cu (`ops.attention._launch_fwd`: mma.sync above N = 32, FFMA
at N <= 32) on the same inputs with the causal mask, at D = 768 and 12
heads for every N of CROSSING_N and B of CROSSING_B (`--n`, `--b` replace
them), each body twice (sm90, old, old, sm90): rows {"crossing", "shape",
"sm90_ms", "old_ms", "old_body", "body" (the one `plan_packed_fwd`
chooses), "max_diff", "device"}. Needs a CUDA device and nvcc.

    python -m bioscan_clip_tpu_torch.tools.sweep_k1_sm90 [--reps 20]
        [--variants as_built,mask_ldg] [--crossing] [--n 1,20,...]
        [--b 10,64,...]
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys

import torch

from bioscan_clip_tpu_torch.ops import _build, attention
from bioscan_clip_tpu_torch.tools.bench_k1 import MASK_SHAPES, SHAPES, graph_ms

SOURCE = "mha_fwd_sm90.cu"
PV = """      for (int j = 0; j < KT; ++j)
        wgmma_rs64(o, pa[j], sw128_desc(vs + j * 16 * kRowBytes, 1024));
"""
STAGE_MASK = """      if constexpr (MASK) {
        if (tile < q_tiles && tile != staged) {
          stage_mask<KT>(mask_s, add, n, tile, tid);
          staged = tile;
          restaged = true;
        }
      }
"""
CP_ASYNC4 = """\
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
"""
READ_MASK = """            const float2 mm = *reinterpret_cast<const float2*>(
                mask_g + ((x & 2) ? 8 * kMaskStride : 0) + 16 * j +
                8 * (x >> 2));
            v = __fadd_rn(v, (x & 1) ? mm.y : mm.x);
"""
LDG_MASK = """\
            const int mr = tile * kTileRows + 16 * warp + g + (x & 2) * 4;
            const int mc = 16 * j + 8 * (x >> 2) + 2 * t + (x & 1);
            v = __fadd_rn(v, mr < n && mc < n
                                 ? __ldg(add + (long long)mr * n + mc)
                                 : 0.f);
"""
VARIANTS = {
    "as_built": [],
    "lockstep": [
        ('  asm volatile("bar.sync %0, 256;\\n" ::"r"(3 + c) : "memory");\n',
         ""),
        ('  asm volatile("bar.arrive %0, 256;\\n" ::"r"(4 - c) : "memory");\n',
         "")],
    "pieces_128": [("return rest >= 16 ? 16 : rest >= 8 ? 8 :",
                    "return rest >= 8 ? 8 :")],
    "regs_24_240": [("setmaxnreg.dec.sync.aligned.u32 40;",
                     "setmaxnreg.dec.sync.aligned.u32 24;"),
                    ("setmaxnreg.inc.sync.aligned.u32 232;",
                     "setmaxnreg.inc.sync.aligned.u32 240;")],
    "no_setmaxnreg": [
        ('    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\\n" ::: '
         '"memory");\n', ""),
        ('    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\\n" ::: '
         '"memory");\n', "")],
    "mask_sync": [(CP_ASYNC4, "  *dst = valid ? __ldg(src) : 0.f;\n")],
    "mask_ldg": [(STAGE_MASK, ""), (READ_MASK, LDG_MASK)],
    "no_exp": [("const float e = __expf(sc[8 * j + x] - ((x & 2) ? m1 : m0));",
                "const float e = sc[8 * j + x] - ((x & 2) ? m1 : m0);")],
    "no_pv": [(PV, "")],
    "loads_only": [("if (tile >= q_tiles) {  // an odd tile count",
                    "if (true) {  // an odd tile count")],
}
CHECKED = ("as_built", "lockstep", "pieces_128", "regs_24_240",
           "no_setmaxnreg", "mask_sync", "mask_ldg")
# K1m's crossing grid: N over the masked plan's range (the smallest N one
# by one, both sides of the FFMA / mma.sync switch at 32, of the query
# tiles' 64 and 128, OpenCLIP's 20 and 77), B from one row past the
# training batch of 10
CROSSING_N = (1, 2, 3, 4, 5, 6, 7, 8, 16, 17, 20, 24, 32, 33, 48, 64, 65,
              77, 96, 112, 128, 129, 144, 160)
CROSSING_B = (1, 2, 4, 10, 64, 128, 256, 512)
# ptxas' lines of these instantiations: (16-key chunks, mask)
PTXAS_ROWS = {(13, "0"), (17, "0"), (2, "1"), (5, "1"), (10, "1")}


def variant_sources(source: str, names=None) -> dict[str, str]:
    """Each variant's text (`names`: those only); raises if an edit no
    longer applies."""
    out = {}
    for name, edits in VARIANTS.items():
        if names is not None and name not in names:
            continue
        text = source
        for old, new in edits:
            if old not in text:
                raise ValueError(f"{name}: {old!r} not in {SOURCE}")
            text = text.replace(old, new)
        out[name] = text
    return out


def ptxas_lines(log: str) -> list[str]:
    """ptxas' advice, registers and spills for K1 at 208 and 272 key rows
    and K1m at 32, 80 and 160 (`mha_fwd_sm90<KT, false, false, MASK>`)."""
    out, fn = [], None
    for ln in log.splitlines():
        m = re.search(r"mha_fwd_sm90ILi(\d+)ELb0ELb0ELb(\d)E", ln)
        key = (int(m[1]), m[2]) if m else None
        what = (f"{'K1m' if key[1] == '1' else 'K1'} {16 * key[0]}"
                if key in PTXAS_ROWS else None)
        if "Performance Loss" in ln and what:
            advice = ln.split(":", 1)[-1].split(" for the function")[0]
            out.append(f"{what}: {advice.strip()}")
        elif "Function properties for" in ln:
            fn = what
        elif fn and ("spill" in ln or "registers" in ln):
            out.append(f"{fn}: {ln.split(':', 1)[-1].strip()}")
    return out


class Launch:
    """K1 (K1m with `mask`) of one variant's library at one shape, on its
    plan."""

    def __init__(self, lib, qkv, heads, sms, mask=None):
        b, n, d3 = qkv.shape
        self.plan = (attention.sm90_fwd_plan(b, n, heads, sms=sms,
                                             masked=True)
                     if mask is not None else attention.plan_packed_fwd(
                         b, n, heads, d3 // 3 // heads, sms=sms))
        self.kernel = attention.sm90_entry(lib)
        p, d = qkv.data_ptr(), d3 // 3
        self.ptrs, self.d3, self.mask = (p, p + 2 * d, p + 4 * d), d3, mask
        self.out = torch.empty(b, n, d, dtype=qkv.dtype, device=qkv.device)

    def __call__(self):
        attention._launch_sm90(self.ptrs, self.out, self.d3, self.plan,
                               0.125, kernel=self.kernel, mask=self.mask)
        return self.out


def _ints(text: str) -> tuple[int, ...]:
    return tuple(int(x) for x in text.split(","))


def crossing_rows(gen, reps, bs, ns, d=768, heads=12):
    """K1m's sm90 body against the body of csrc/mha_fwd.cu at every (N, B)
    of the grid, under the causal mask."""
    from bioscan_clip_tpu_torch.models.openclip import causal_mask

    dev = torch.device("cuda")
    hd = d // heads
    for b in bs:
        for n in ns:
            qkv = torch.randn(b, n, 3 * d, device=dev,
                              generator=gen).to(torch.bfloat16)
            mask = causal_mask(n, dev)
            p = qkv.data_ptr()
            ptrs = (p, p + 2 * d, p + 4 * d)
            o_sm90, o_old = (torch.empty(b, n, d, dtype=qkv.dtype,
                                         device=dev) for _ in range(2))
            plan = attention.sm90_fwd_plan(b, n, heads, masked=True)

            def sm90():
                attention._launch_sm90(ptrs, o_sm90, 3 * d, plan,
                                       hd ** -0.5, mask=mask)

            def old():
                attention._launch_fwd(ptrs, o_old, b, n, heads, hd, 3 * d,
                                      hd ** -0.5, qkv.dtype, None, mask=mask)

            sm90()
            old()
            first = graph_ms(sm90, reps)
            old_ms = [graph_ms(old, reps), graph_ms(old, reps)]
            yield {"crossing": True, "shape": [b, n, d, heads],
                   "sm90_ms": [first, graph_ms(sm90, reps)],
                   "old_ms": old_ms, "old_body": "mma" if n > 32 else "ffma",
                   "body": attention.plan_packed_fwd(
                       b, n, heads, hd, qkv.dtype, masked=True).body,
                   "max_diff": (o_sm90.float() - o_old.float()).abs()
                   .max().item()}
            del qkv, o_sm90, o_old
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variants", type=lambda s: tuple(s.split(",")),
                    default=None, help="the variants to build (default all)")
    ap.add_argument("--crossing", action="store_true",
                    help="only K1m's crossing, on the package's library")
    ap.add_argument("--n", type=_ints, default=CROSSING_N)
    ap.add_argument("--b", type=_ints, default=CROSSING_B)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_k1_sm90: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if args.crossing:
        for row in crossing_rows(gen, args.reps, args.b, args.n):
            print(json.dumps({**row, "device": card}), flush=True)
        return 0
    from bioscan_clip_tpu_torch.models.openclip import causal_mask

    sources = {name: (text, _build.CSRC_DIR) for name, text in
               variant_sources((_build.CSRC_DIR / SOURCE).read_text(),
                               args.variants).items()}
    libs = _build.build_sources(sources,
                                _build.BUILD_DIR.parent / "k1_sm90_sweep")
    for name in libs:
        print(json.dumps({"variant": name,
                          "ptxas": ptxas_lines(_build.build_logs[name])}),
              flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bad = []
    order = list(libs)
    shapes = [(s, False) for s in SHAPES] + [(s, True) for s in MASK_SHAPES]
    for rnd, names in ((1, order), (2, order[::-1])):
        for (b, n, d, heads), masked in shapes:
            qkv = torch.randn(b, n, 3 * d, device=dev,
                              generator=gen).to(torch.bfloat16)
            mask = causal_mask(n, dev) if masked else None
            ref = attention.mha_reference(
                qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], heads,
                scale=0.125, mask=mask)
            for name in names:
                launch = Launch(libs[name], qkv, heads, sms, mask)
                row = {"variant": name, "shape": [b, n, d, heads],
                       "mask": "causal" if masked else None, "round": rnd,
                       "ms": graph_ms(launch, args.reps), "device": card}
                if name in CHECKED:
                    out = launch()
                    row["err"] = (out.float() - ref.float()).abs().max().item()
                    if not row["err"] <= 2e-2:
                        bad.append(row)
                print(json.dumps(row), flush=True)
            del qkv, ref
            torch.cuda.empty_cache()
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
