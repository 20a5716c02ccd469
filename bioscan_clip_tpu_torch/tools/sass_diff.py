"""Compare the device code of this checkout's kernels with another
checkout's, function by function.

Each `csrc/<name>.cu` of both checkouts is built with the port's nvcc flags
(`ops/_build.build_sources`, one nvcc each, all at once) into
--out-dir/<name>@this and <name>@other. For every kernel of each library it
reads ptxas' report from the build (registers, barriers, shared memory,
stack frame, spill stores and loads) and cuobjdump's SASS, and hashes the
instructions' text (addresses and encodings left out). Names are taken with
the anonymous namespace's file-dependent tag dropped, so the same kernel
built from two directories has one name. One JSON object a line:

  {"source": name, "kernels": n, "same": n, "differ": [{"kernel", "this",
   "other"}], "only_this": [...], "only_other": [...]}

where "this" and "other" hold each side's ptxas line, SASS instruction
count and hash. Run from the repo root on the machine with nvcc:

    python3 -m bioscan_clip_tpu_torch.tools.sass_diff --other build/parent \\
        [--sources topk,mha_fwd] [--out-dir build/sass_diff]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import shutil
import subprocess
from pathlib import Path

from bioscan_clip_tpu_torch.ops import _build

_ANON = re.compile(r"(\d+)_GLOBAL__N_")
_INSTRUCTION = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(\S.*?)\s*;")


def kernel_name(mangled: str) -> str:
    """`mangled` with each anonymous namespace's name (`<len>_GLOBAL__N__
    <hash>_<len>_<file>_<hash>`, which depends on the file) cut to
    `_GLOBAL__N_`."""
    out, pos = [], 0
    for m in _ANON.finditer(mangled):
        if m.start() < pos:
            continue
        out.append(mangled[pos:m.start()] + "_GLOBAL__N_")
        pos = m.end(1) + int(m[1])
    return "".join(out) + mangled[pos:]


def ptxas_report(log: str) -> dict[str, str]:
    """{kernel: its ptxas lines} from an `-Xptxas=-v` build log: the
    "Function properties" line (stack frame, spills) and the "Used" line
    (registers, barriers, shared memory) of each entry function."""
    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = kernel_name(m[1])
            out[fn] = ""
            continue
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = kernel_name(m[1])
            continue
        if fn in out and ("spill" in ln or "Used" in ln):
            out[fn] = (out[fn] + " " + ln.split(":", 1)[-1].strip()).strip()
    return out


def sass_report(sass: str) -> dict[str, tuple[int, str]]:
    """{kernel: (instruction count, sha1 of the instructions' text)} from
    `cuobjdump -sass` output."""
    hashes, counts, fn = {}, {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = kernel_name(m[1])
            hashes[fn], counts[fn] = hashlib.sha1(), 0
            continue
        ins = _INSTRUCTION.match(ln)
        if fn and ins:
            hashes[fn].update(ins[1].encode() + b"\n")
            counts[fn] += 1
    return {fn: (counts[fn], h.hexdigest()[:16]) for fn, h in hashes.items()}


def compare(ptxas_this, sass_this, ptxas_other, sass_other, source=""):
    """The JSON row of one source from both sides' reports."""
    names = set(sass_this) | set(sass_other)
    differ, same = [], 0
    for fn in sorted(set(sass_this) & set(sass_other)):
        if (sass_this[fn] == sass_other[fn]
                and ptxas_this.get(fn) == ptxas_other.get(fn)):
            same += 1
            continue
        differ.append({"kernel": fn, **{
            side: {"ptxas": ptxas.get(fn), "instructions": sass[fn][0],
                   "sha1": sass[fn][1]}
            for side, ptxas, sass in (("this", ptxas_this, sass_this),
                                      ("other", ptxas_other, sass_other))}})
    return {"source": source, "kernels": len(names), "same": same,
            "differ": differ,
            "only_this": sorted(set(sass_this) - set(sass_other)),
            "only_other": sorted(set(sass_other) - set(sass_this))}


def _cuobjdump_sass(lib: Path) -> str:
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout


def main(argv=None, emit=print):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="the root of the other checkout")
    ap.add_argument("--sources", default=None,
                    help="comma-separated csrc/*.cu names (default: all)")
    ap.add_argument("--out-dir", default=str(_build.BUILD_DIR.parent
                                             / "sass_diff"))
    args = ap.parse_args(argv)
    other = Path(args.other) / "bioscan_clip_tpu_torch" / "csrc"
    names = (args.sources.split(",") if args.sources else _build.sources())
    sides = {"this": _build.CSRC_DIR, "other": other}
    todo = {f"{name}@{side}": ((csrc / f"{name}.cu").read_text(), csrc)
            for name in names for side, csrc in sides.items()}
    _build.build_sources(todo, args.out_dir)
    for name in names:
        got = {}
        for side in sides:
            key = f"{name}@{side}"
            got[side] = (ptxas_report(_build.build_logs[key]),
                         sass_report(_cuobjdump_sass(
                             Path(args.out_dir) / key / "lib.so")))
        emit(json.dumps(compare(*got["this"], *got["other"], source=name)))


if __name__ == "__main__":
    main()
