"""Design sweep of K2 and K2d on the forward's sm90 body
(`csrc/mha_fwd_sm90.cu`) on the card: variants of where the dropout hash
runs, each a set of text edits of the source, built side by side and timed
in one process, so that they share a card.

Variants:
  as_built     each consumer thread hashes its keep bits while its S
               product runs
  late         the hash after the softmax, before p is packed
  mulhi        mix32's right shifts as `__umulhi` by a power of two (the
               FMA pipe's IMAD.HI, if ptxas keeps them, in place of the
               integer pipe's SHF)
  skip_halves  a warp also skips the scores of its 8-row half and of its
               8-key half-chunks that lie wholly past N
  no_hash      every keep bit set: the body without the hash (timing only)
Shapes: `tools/bench_k2.py`'s (BarcodeBERT and BERT-small, K2 and K2d),
bf16, each launch through the variant's library under `sm90_fwd_plan`,
timed as --reps launches captured into one CUDA graph (card clock). Rows,
one JSON object each, every one with the card (name and power limit):
  {"variant", "ptxas"}   ptxas' registers and spills of the dropout
                         instantiations at 32, 144 and 272 key rows
  {"variant", "shape", "rate", "bias", "round", "ms", "bit_equal"}
                         the variants in order, then in reverse (round
                         2); bit_equal: its output equals as_built's
  {"crossing", "shape", "rate", "bias", "sm90_ms", "mma_ms", "body",
   "max_diff"}           the package's sm90 body (under `sm90_fwd_plan`)
                         beside the mma.sync body of csrc/mha_fwd.cu
                         (`ops.attention._launch_fwd`) on the same inputs,
                         at BarcodeBERT's width (D = 768, 12 heads) for
                         every N of CROSSING_N (the spilling 256 and 272
                         key rows among them) and B of CROSSING_B, K2 and
                         K2d, with and without a padding bias; each body
                         timed twice (sm90, mma, mma, sm90); `body` is
                         the one `plan_split_fwd` chooses
Exit 1 if a variant that computes K2d differs from as_built. Needs a CUDA
device and nvcc. `--crossing` runs the crossing rows alone, on the
package's own library (no variant is built); `--n` and `--b` replace the
grid's N and B.

    python -m bioscan_clip_tpu_torch.tools.sweep_k2_sm90 [--reps 20]
        [--crossing] [--n 129,133,...] [--b 64,100,...]
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys

import torch

from bioscan_clip_tpu_torch.ops import _build, attention
from bioscan_clip_tpu_torch.tools.bench_k1 import graph_ms
from bioscan_clip_tpu_torch.tools.bench_k2 import SHAPES

SOURCE = "mha_fwd_sm90.cu"
HASH = """      if constexpr (DROP) {
        if (row0 < n)
          keep_bits<KT>(keep, row0 + g, t, n, dbase, dseed, drop.threshold);
      }
"""
MIX = "if (bscan::mix32(seed ^ bscan::mix32(ctr)) >= threshold)"
MULHI = """__device__ __forceinline__ unsigned mix32_mulhi(unsigned x) {
  x = (x ^ __umulhi(x, 1u << 16)) * 0x7FEB352Du;
  x = (x ^ __umulhi(x, 1u << 17)) * 0x846CA68Bu;
  return x ^ __umulhi(x, 1u << 16);
}

"""
KEEP_BITS = "template <int KT>\n__device__ __forceinline__ void keep_bits("
VARIANTS = {
    "as_built": [],
    "late": [(HASH, ""),
             ("      // p = e * (1 / l)", HASH + "      // p = e * (1 / l)")],
    "mulhi": [(KEEP_BITS, MULHI + KEEP_BITS),
              (MIX, MIX.replace("bscan::mix32", "mix32_mulhi"))],
    "skip_halves": [(MIX, "if ((x & 2) && row + 8 >= n) continue;\n"
                     "    if (16 * (e >> 3) + 8 * (x >> 2) >= n) continue;\n"
                     "    " + MIX)],
    "no_hash": [("if (row0 < n)\n          keep_bits<KT>(keep, row0 + g, t, "
                 "n, dbase, dseed, drop.threshold);",
                 "for (auto& k : keep) k = ~0u;")],
}
CHECKED = ("as_built", "late", "mulhi", "skip_halves")
# the crossing's grid: N over the mma.sync body's range up to the sm90
# body's last instantiation, B from a fine-tune's batch to training's
CROSSING_N = (33, 48, 64, 65, 96, 128, 133, 144, 160, 176, 192, 197, 208,
              224, 240, 256, 272)
CROSSING_B = (10, 64, 400)


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
    """ptxas' registers and spills of the dropout instantiations at 32, 144
    and 272 key rows."""
    out, fn = [], None
    for ln in log.splitlines():
        m = re.search(r"mha_fwd_sm90ILi(\d+)ELb(\d)ELb1E", ln)
        if "Function properties for" in ln:
            fn = m.groups() if m and m[1] in ("2", "9", "17") else None
        elif fn and ("spill" in ln or "registers" in ln):
            what = f"{16 * int(fn[0])}{' bias' if fn[1] == '1' else ''}"
            out.append(f"{what}: {ln.split(':', 1)[-1].strip()}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--crossing", action="store_true",
                    help="only the crossing rows, on the package's library")
    ap.add_argument("--n", type=_ints, default=CROSSING_N)
    ap.add_argument("--b", type=_ints, default=CROSSING_B)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_k2_sm90: needs a CUDA device", file=sys.stderr)
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
    sources = {name: (text, _build.CSRC_DIR) for name, text in
               variant_sources((_build.CSRC_DIR / SOURCE).read_text())
               .items()}
    libs = _build.build_sources(sources,
                                _build.BUILD_DIR.parent / "k2_sm90_sweep")
    kernels = {name: attention.sm90_entry(lib) for name, lib in libs.items()}
    for name in libs:
        print(json.dumps({"variant": name, "device": card,
                          "ptxas": ptxas_lines(_build.build_logs[name])}),
              flush=True)
    bad = []
    order = list(libs)
    for rnd, names in ((1, order), (2, order[::-1])):
        for _, b, n, d, heads, with_bias, rate in SHAPES:
            q, k, v = (torch.randn(b, n, d, device=dev, generator=gen)
                       .to(torch.bfloat16) for _ in range(3))
            bias = None
            if with_bias:
                lengths = torch.randint(5, n + 1, (b,), device=dev,
                                        generator=gen)
                bias = torch.where(
                    torch.arange(n, device=dev)[None, :] < lengths[:, None],
                    0.0, -1e9).float()
            seeds = torch.randint(0, 2**32, (b,), device=dev, generator=gen,
                                  dtype=torch.int64)
            drop = attention._drop_args(rate, seeds, b, dev)
            plan = attention.sm90_fwd_plan(b, n, heads, bias is not None)
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
            launches, outs = {}, {}
            for name in names:
                out = torch.empty_like(q)

                def launch(name=name, out=out):
                    attention._launch_sm90(ptrs, out, d, plan,
                                           (d // heads) ** -0.5, bias, drop,
                                           kernel=kernels[name])
                    return out

                launches[name], outs[name] = launch, launch().clone()
            for name in names:
                row = {"variant": name, "shape": [b, n, d, heads],
                       "rate": rate, "bias": with_bias, "round": rnd,
                       "ms": graph_ms(launches[name], args.reps),
                       "device": card}
                if name in CHECKED:
                    row["bit_equal"] = torch.equal(outs[name],
                                                   outs["as_built"])
                    if not row["bit_equal"]:
                        bad.append(row)
                print(json.dumps(row), flush=True)
            del q, k, v, outs, launches
            torch.cuda.empty_cache()
    for row in crossing_rows(gen, args.reps, args.b, args.n):
        print(json.dumps({**row, "device": card}), flush=True)
    return 1 if bad else 0


def _ints(text: str) -> tuple[int, ...]:
    return tuple(int(x) for x in text.split(","))


def crossing_rows(gen, reps, bs, ns, d=768, heads=12):
    """The package's sm90 body against the mma.sync body at every (N, B)
    of the crossing's grid (`ns` x `bs`), K2 and K2d, with and without a
    padding bias."""
    dev = torch.device("cuda")
    hd = d // heads
    for b in bs:
        for n in ns:
            q, k, v = (torch.randn(b, n, d, device=dev, generator=gen)
                       .to(torch.bfloat16) for _ in range(3))
            lengths = torch.randint(5, n + 1, (b,), device=dev,
                                    generator=gen)
            padding = torch.where(
                torch.arange(n, device=dev)[None, :] < lengths[:, None],
                0.0, -1e9).float()
            seeds = torch.randint(0, 2**32, (b,), device=dev,
                                  generator=gen, dtype=torch.int64)
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
            o_sm90, o_mma = torch.empty_like(q), torch.empty_like(q)
            for with_bias, rate in ((False, 0.0), (True, 0.0), (False, 0.1),
                                    (True, 0.1)):
                bias = padding if with_bias else None
                drop = attention._drop_args(rate, seeds, b, dev)
                plan = attention.sm90_fwd_plan(b, n, heads, with_bias)

                def sm90(bias=bias, drop=drop, plan=plan):
                    attention._launch_sm90(ptrs, o_sm90, d, plan, hd ** -0.5,
                                           bias, drop)

                def mma(bias=bias, rate=rate):
                    attention._launch_fwd(ptrs, o_mma, b, n, heads, hd, d,
                                          hd ** -0.5, q.dtype, bias, rate,
                                          seeds)

                sm90()
                mma()
                first = graph_ms(sm90, reps)
                mma_ms = [graph_ms(mma, reps), graph_ms(mma, reps)]
                yield {"crossing": True, "shape": [b, n, d, heads],
                       "rate": rate, "bias": with_bias,
                       "sm90_ms": [first, graph_ms(sm90, reps)],
                       "mma_ms": mma_ms,
                       "body": attention.plan_split_fwd(
                           b, n, heads, hd, q.dtype, with_bias,
                           rate > 0).body,
                       "max_diff": (o_sm90.float() - o_mma.float()).abs()
                       .max().item()}
            del q, k, v, o_sm90, o_mma
            torch.cuda.empty_cache()


if __name__ == "__main__":
    raise SystemExit(main())
