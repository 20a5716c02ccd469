"""Design sweep of K1's sm90 body (`csrc/mha_fwd_sm90.cu`) on the card:
variants of the source, each one text edit, built side by side and timed
in one process, so that they share a card.

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
  no_exp         p = s - max without the exp (timing only)
  no_pv          no P . V products: o = 0 (timing only)
  loads_only     the consumers wait for each stage and release it at
                 once: the TMA loads alone, no products, no stores
                 (timing only)
Shapes (B, N, D, heads): ViT-B/16 at B = 8, 24, 256, 400 (N = 197) and
ViT-L/14 at B = 256 (N = 257), bf16. Each launch goes through the
library's C entry point with `ops.attention.plan_packed_fwd`'s plan, and
is timed as --reps launches captured into one CUDA graph (card clock).
Rows, one JSON object each: variant, shape, round, ms, err (max |out -
mha_reference|, for the variants that compute K1) and the card (name and
power limit); first, one row per variant with ptxas' lines for the
instantiations of 208 and 272 key rows. The variants run in order, then
in reverse order (round 2). Needs a CUDA device and nvcc.

    python -m bioscan_clip_tpu_torch.tools.sweep_k1_sm90 [--reps 20]
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys

import torch

from bioscan_clip_tpu_torch.ops import _build, attention
from bioscan_clip_tpu_torch.tools.bench_k1 import SHAPES, graph_ms

SOURCE = "mha_fwd_sm90.cu"
PV = """      for (int j = 0; j < KT; ++j)
        wgmma_rs64(o, pa[j], sw128_desc(vs + j * 16 * kRowBytes, 1024));
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
    "no_exp": [("const float e = __expf(sc[8 * j + x] - ((x & 2) ? m1 : m0));",
                "const float e = sc[8 * j + x] - ((x & 2) ? m1 : m0);")],
    "no_pv": [(PV, "")],
    "loads_only": [("if (tile >= q_tiles) {  // an odd tile count",
                    "if (true) {  // an odd tile count")],
}
CHECKED = ("as_built", "lockstep", "pieces_128", "regs_24_240",
           "no_setmaxnreg")


def variant_sources(source: str) -> dict[str, str]:
    """Each variant's text; raises if an edit no longer applies."""
    out = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise ValueError(f"{name}: {old!r} not in {SOURCE}")
            text = text.replace(old, new)
        out[name] = text
    return out


def ptxas_lines(log: str) -> list[str]:
    """ptxas' advice, registers and spills for 208 and 272 key rows."""
    out, fn = [], ""
    for ln in log.splitlines():
        kt = re.search(r"mha_fwd_sm90ILi(\d+)ELb0E", ln)
        if "Performance Loss" in ln and kt and kt[1] in ("13", "17"):
            advice = ln.split(":", 1)[-1].split(" for the function")[0]
            out.append(f"{16 * int(kt[1])}: {advice.strip()}")
        elif "Function properties for" in ln:
            fn = kt[1] if kt else ""
        elif fn in ("13", "17") and ("spill" in ln or "registers" in ln):
            out.append(f"{16 * int(fn)}: {ln.split(':', 1)[-1].strip()}")
    return out


class Launch:
    """K1 of one variant's library at one shape, on its plan."""

    def __init__(self, lib, qkv, heads, sms):
        b, n, d3 = qkv.shape
        self.plan = attention.plan_packed_fwd(b, n, heads, d3 // 3 // heads,
                                              sms=sms)
        self.kernel = attention.sm90_entry(lib)
        p, d = qkv.data_ptr(), d3 // 3
        self.ptrs, self.d3 = (p, p + 2 * d, p + 4 * d), d3
        self.out = torch.empty(b, n, d, dtype=qkv.dtype, device=qkv.device)

    def __call__(self):
        attention._launch_sm90(self.ptrs, self.out, self.d3, self.plan,
                               0.125, kernel=self.kernel)
        return self.out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_k1_sm90: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    sources = {name: (text, _build.CSRC_DIR) for name, text in
               variant_sources((_build.CSRC_DIR / SOURCE).read_text())
               .items()}
    libs = _build.build_sources(sources,
                                _build.BUILD_DIR.parent / "k1_sm90_sweep")
    for name in libs:
        print(json.dumps({"variant": name,
                          "ptxas": ptxas_lines(_build.build_logs[name])}),
              flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    bad = []
    order = list(libs)
    for rnd, names in ((1, order), (2, order[::-1])):
        for b, n, d, heads in SHAPES:
            qkv = torch.randn(b, n, 3 * d, device=dev,
                              generator=gen).to(torch.bfloat16)
            ref = attention.mha_reference(
                qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], heads,
                scale=0.125)
            for name in names:
                launch = Launch(libs[name], qkv, heads, sms)
                row = {"variant": name, "shape": [b, n, d, heads],
                       "round": rnd, "ms": graph_ms(launch, args.reps),
                       "device": card}
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
