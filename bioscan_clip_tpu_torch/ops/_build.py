"""Build the port's CUDA kernels and load them with ctypes.

Each `bioscan_clip_tpu_torch/csrc/<name>.cu` compiles, at first use, into its
own shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/torch_kernels/lib<name>-<digest>.so <name>.cu

`<digest>` hashes the sources and flags, so an edited kernel rebuilds and an
unchanged one is reused. `build()` starts one nvcc per source, all at once,
and waits for all of them. Every C entry point returns `cudaGetLastError()`
after its launch; `check()` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register / shared-memory / spill lines) per source
# (or per `build_sources` variant) built by this process.
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
        "port's CUDA kernels are compiled on the machine with the card"
    )


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _library_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=None) -> float:
    """Compile the named sources (default: every csrc/*.cu) that are not
    built yet, one nvcc each, in parallel. Returns the wall seconds spent;
    raises with nvcc's output if any compile fails."""
    names = list(names or sources())
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        try:
            for name in names:
                out = _library_path(name)
                if out.exists():
                    continue
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC_DIR / f"{name}.cu")]
                procs[name] = (
                    subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out,
                )
            failed = []
            for name, (proc, tmp, out) in procs.items():
                log, _ = proc.communicate()
                build_logs[name] = log
                if proc.returncode != 0:
                    failed.append(f"nvcc failed for {name}.cu:\n{log}")
                else:
                    os.replace(tmp, out)
            if failed:
                raise RuntimeError("\n".join(failed))
        finally:
            for proc, _, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return time.perf_counter() - t0


def build_sources(sources: dict, out_dir) -> dict[str, ctypes.CDLL]:
    """Compile {name: (the text of a .cu source, the directory of its .cuh
    headers)} into out_dir/<name>/lib.so with NVCC_FLAGS, one nvcc each, in
    parallel, and load each library. Raises with nvcc's output if a compile
    fails. For the design sweeps: variants of one source built side by
    side."""
    procs = {}
    for name, (text, header_dir) in sources.items():
        d = Path(out_dir) / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "src.cu").write_text(text)
        for hdr in Path(header_dir).glob("*.cuh"):
            shutil.copy(hdr, d)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "src.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(Path(out_dir) / name / "lib.so"))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        lib.bscan_error_string.argtypes = [ctypes.c_int]
        lib.bscan_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.bscan_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
