"""ctypes bindings for the host's JPEG decode pool (csrc/host/bscan_io.cc).

Counterpart of bioscan_clip_tpu/data/native_io.py: a GIL-free C++ pthread
pool decodes a batch of JPEGs with libjpeg's DCT scaling straight into one
contiguous uint8 batch. `data/pipeline.BioscanLoader` takes it once it has
been built, and decodes in Python (cv2, else PIL) otherwise.

`build()` is the counterpart of `make -C native`: g++ with the JAX
Makefile's flags (`-O3 -fPIC -std=c++17 -march=native -Wall`, `-shared
-ljpeg -lpthread`) into build/host/, the library named by a hash of its
source and flags. It needs g++ and libjpeg's headers and library; a failed
build raises with the compiler's output. `available()` says whether the
library is there and loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = (Path(__file__).resolve().parent.parent / "csrc" / "host"
          / "bscan_io.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-march=native", "-Wall"]
LDFLAGS = ["-shared", "-ljpeg", "-lpthread"]
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS + LDFLAGS).encode())
    return BUILD_DIR / f"libbscan_io-{h.hexdigest()[:12]}.so"


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(library_path()))
        lib.bscan_decode_batch.restype = ctypes.c_int
        lib.bscan_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        _lib = lib
    return _lib


def available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


def build(out=print) -> Path:
    """Compile the pool with g++ into `library_path()`; raise with the
    compiler's output if it fails."""
    path = library_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", str(tmp),
           str(SOURCE), *LDFLAGS]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed: {' '.join(cmd)}"
                           f"\n{r.stdout}{r.stderr}")
    os.replace(tmp, path)  # a reader never sees a half-written library
    out(f"built {path}{(': ' + r.stderr) if r.stderr else ''}")
    return path


def decode_batch(
    buffers: list,
    target_short: int = 256,
    out_h: Optional[int] = None,
    out_w: Optional[int] = None,
    threads: int = 0,
) -> np.ndarray:
    """Decode a list of JPEG byte strings -> (N, out_h, out_w, 3) uint8.

    Each image is shorter-side resized to `target_short` (libjpeg DCT
    scaling + bilinear) and center-cropped/edge-padded into the fixed output
    slot. Defaults produce (N, 256, 256, 3). A JPEG that fails to decode
    raises ValueError naming its index in `buffers`.
    """
    lib = _load()
    n = len(buffers)
    out_h = out_h or target_short
    out_w = out_w or target_short
    if not all(isinstance(b, bytes) for b in buffers):
        raise TypeError("decode_batch takes a list of bytes")
    out = np.empty((n, out_h, out_w, 3), dtype=np.uint8)

    buf_array = (ctypes.c_char_p * n)(*buffers)
    len_array = (ctypes.c_int64 * n)(*[len(b) for b in buffers])
    rc = lib.bscan_decode_batch(
        ctypes.cast(buf_array, ctypes.POINTER(ctypes.c_char_p)),
        ctypes.cast(len_array, ctypes.POINTER(ctypes.c_int64)),
        n,
        target_short,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out_h,
        out_w,
        threads,
    )
    if rc != 0:
        raise ValueError(f"JPEG decode failed for image index {rc - 1}")
    return out
