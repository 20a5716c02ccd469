"""Fused multi-head attention forward for the short-sequence towers.

Counterpart of bioscan_clip_tpu/ops/attention.py (`mha_packed` :713 over
`_pallas_mha_packed` :425, `mha` :680 over `_pallas_mha_split` :449, without
dropout). On a CUDA tensor both wrappers launch the hand-written kernel in
`csrc/mha_fwd.cu` or raise; on a CPU tensor they run `mha_reference`, the
plain PyTorch version with the same contract (fp32 softmax, probabilities
rounded to the input dtype before P.V, output in the input dtype).

Each wrapper counts its kernel launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bioscan_clip_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def mha_reference(q, k, v, heads: int, bias=None, scale=None):
    """Plain PyTorch attention over (B, N, D) q/k/v (heads-major in D) with
    an optional (B, N) additive key bias; the `xla_mha` contract
    (JAX attention.py:529-540)."""
    b, n, d = q.shape
    hd = d // heads
    if scale is None:
        scale = hd**-0.5
    qh = q.reshape(b, n, heads, hd).float()
    kh = k.reshape(b, n, heads, hd).float()
    s = torch.einsum("bnhd,bmhd->bhnm", qh, kh) * scale
    if bias is not None:
        s = s + bias[:, None, None, :].float()
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    vh = v.reshape(b, n, heads, hd).float()
    o = torch.einsum("bhnm,bmhd->bnhd", p, vh)
    return o.reshape(b, n, d).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("mha_fwd")
    fn = lib.bscan_mha_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_longlong] * 2 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    smem = lib.bscan_mha_fwd_smem_bytes
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    smem.restype = ctypes.c_longlong
    limit = lib.bscan_max_smem_per_block
    limit.argtypes = [ctypes.c_int]
    limit.restype = ctypes.c_longlong
    return lib, fn, smem, limit


def _launch(ptrs, out, b, n, heads, hd, row_stride, scale, dtype, bias):
    if b > 65535:  # the batch is the grid's z dimension
        raise ValueError(f"mha kernel: batch {b} > 65535; split the batch")
    lib, fn, smem, max_smem = _kernel()
    dev = out.device
    need = smem(n, hd)
    limit = max_smem(dev.index if dev.index is not None else
                     torch.cuda.current_device())
    if need > limit:
        raise ValueError(
            f"mha kernel: N={n}, head_dim={hd} needs {need} bytes of shared "
            f"memory per block; this card allows {limit}"
        )
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        *ptrs, None if bias is None else bias.data_ptr(), out.data_ptr(),
        b, n, heads, hd, row_stride, n * row_stride, float(scale),
        _DTYPE_CODE[dtype], stream,
    )
    _build.check(lib, err, "mha_fwd launch")


def _check_cuda(name, tensors, dtype):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all inputs must be on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _check_heads(name, d, heads, dtype):
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {dtype} (kernel takes fp32, bf16)")
    if d % heads:
        raise ValueError(f"{name}: width {d} not divisible by {heads} heads")
    if d // heads not in _HEAD_DIMS:
        raise ValueError(
            f"{name}: head dim {d // heads} (kernel takes {_HEAD_DIMS})"
        )


def mha_packed(qkv, heads: int, scale=None):
    """Attention over a packed (B, N, 3D) qkv (q|k|v along the last axis,
    heads-major in each third: the timm fused-qkv layout) -> (B, N, D)."""
    b, n, d3 = qkv.shape
    if d3 % 3:
        raise ValueError(f"mha_packed: last dim {d3} is not 3 * D")
    d = d3 // 3
    if scale is None:
        scale = (d // heads) ** -0.5
    if qkv.device.type == "cpu":
        return mha_reference(
            qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :], heads,
            scale=scale,
        )
    _check_heads("mha_packed", d, heads, qkv.dtype)
    _check_cuda("mha_packed", [qkv], qkv.dtype)
    out = torch.empty((b, n, d), dtype=qkv.dtype, device=qkv.device)
    p = qkv.data_ptr()
    es = qkv.element_size()
    _launch((p, p + d * es, p + 2 * d * es), out, b, n, heads, d // heads,
            d3, scale, qkv.dtype, None)
    mha_packed.launches += 1
    return out


mha_packed.launches = 0


def mha(q, k, v, heads: int, bias=None, scale=None,
        dropout_rate: float = 0.0):
    """Attention over separate (B, N, D) q/k/v with an optional (B, N)
    fp32 additive key bias (0 / -1e9 padding) -> (B, N, D) in q's dtype."""
    if dropout_rate > 0:
        raise NotImplementedError(
            "attention dropout (K2d) comes with the training slice: "
            "ROADMAP.md queue 2"
        )
    b, n, d = q.shape
    if scale is None:
        scale = (d // heads) ** -0.5
    if q.device.type == "cpu":
        return mha_reference(q, k, v, heads, bias=bias, scale=scale)
    _check_heads("mha", d, heads, q.dtype)
    _check_cuda("mha", [q, k, v], q.dtype)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"mha: q/k/v shapes differ: {q.shape} {k.shape} "
                         f"{v.shape}")
    if bias is not None:
        _check_cuda("mha bias", [bias], torch.float32)
        if bias.device != q.device or tuple(bias.shape) != (b, n):
            raise ValueError(f"mha: bias must be ({b}, {n}) on {q.device}")
    out = torch.empty_like(q)
    _launch((q.data_ptr(), k.data_ptr(), v.data_ptr()), out, b, n, heads,
            d // heads, d, scale, q.dtype, bias)
    mha.launches += 1
    return out


mha.launches = 0
