"""Fused multi-head attention for the short-sequence towers: the forward,
with optional in-kernel probability dropout, and its backward.

Counterpart of bioscan_clip_tpu/ops/attention.py:
- `mha_packed` (:713, over `_pallas_mha_packed` :425): K1, ViT's packed qkv,
  and with an (N, N) additive score mask K1m (`_packed_mask_kernel` :162,
  OpenCLIP's causal text mask), counted apart in `mha_packed.mask_launches`;
- `mha` (:680, over `_pallas_mha_split` :449) without dropout: K2;
- `mha_dropout`, which `mha(..., dropout_rate > 0)` calls: K2d, the split
  forward with counter-hash probability dropout (`_split_drop_kernel` :195,
  `_split_bias_drop_kernel` :203, `_row_drop` :184);
- `mha_bwd` (`_pallas_mha_bwd` :321, body `_attend_bwd_one_row` :212): K3,
  dq/dk/dv (+ dbias) with the probabilities and the dropout mask recomputed,
  and with an (N, N) score mask (`has_mask`, :363-367) K3m, the backward of
  K1m, counted apart in `mha_bwd.mask_launches`.

`mha_packed` and `mha` are `torch.autograd.Function`s, as the JAX ops are
`jax.custom_vjp`s (:543-677): the forward is K1/K1m/K2/K2d, the backward K3
or K3m. On a CUDA tensor each wrapper launches its hand-written kernel
(`csrc/mha_fwd.cu`, `csrc/mha_bwd.cu`) or raises; on a CPU tensor it runs
its plain PyTorch version (`mha_reference`, `mha_bwd_reference`), which has
the same contract. Autograd never differentiates the plain forward: the CPU
backward is `mha_bwd_reference`, the function the card's K3/K3m is held
against.

The dropout hash (`_mix32`, `dropout_keep_2d/4d`, :60-113) is uint32
arithmetic done in int64 tensors and masked to 32 bits; seeds are Python
ints or int64 tensors holding uint32 values.

Each wrapper counts its kernel launches in `<wrapper>.launches`; the plain
versions count their calls in `<function>.calls`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from bioscan_clip_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_M32 = 0xFFFFFFFF


# --- the counter hash and the dropout masks (JAX attention.py:60-113) -----

def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 x in [0, 2**32): the constant is split
    into 16-bit halves, so no partial product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """uint32 avalanche mix (murmur3 finalizer), as JAX `_mix32`."""
    x = x & _M32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _keep_threshold(rate: float) -> int:
    """uint32 threshold: u >= thresh keeps the element (P(keep) = 1-rate)."""
    return min(int(rate * 2.0**32), 2**32 - 1)


def keep_scale(rate: float) -> float:
    """The scale of a kept element, rounded as JAX rounds it:
    float32(1) / float32(1.0 - rate), with 1.0 - rate in double."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def u32(x, device=None):
    """A uint32 value (or array) as an int64 tensor on `device`."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.int64) & _M32
    return torch.as_tensor(np.asarray(x, dtype=np.int64) & _M32,
                           device=device)


def _keep_from_hash(u, rate: float):
    return (u >= _keep_threshold(rate)).to(torch.float32) * keep_scale(rate)


def dropout_keep_2d(seed, b_idx, head, n: int, rate: float, heads: int,
                    device=None):
    """(N, N) fp32 keep/scale mask of one (batch row, head): element (i, j)
    keeps when _mix32(seed ^ _mix32(((b*heads + head)*N + i)*N + j)) >=
    threshold. Row-keyed mode passes the row's own seed and b_idx=0."""
    i = torch.arange(n, device=device)[:, None]
    j = torch.arange(n, device=device)[None, :]
    idx = (((int(b_idx) * heads + int(head)) * n + i) * n + j) & _M32
    return _keep_from_hash(_mix32(u32(seed, device) ^ _mix32(idx)), rate)


def dropout_keep_4d(seed, batch: int, heads: int, n: int, rate: float,
                    device=None):
    """(B, heads, N, N) fp32 mask with the formula of dropout_keep_2d.
    A scalar seed keys the counter with the batch index; a (B,) seed vector
    is row-keyed (no batch term: row b's mask depends on seed[b] only)."""
    seed = u32(seed, device)
    h = torch.arange(heads, device=device)[:, None, None]
    i = torch.arange(n, device=device)[None, :, None]
    j = torch.arange(n, device=device)[None, None, :]
    if seed.ndim == 1:
        idx = ((h * n + i) * n + j) & _M32
        u = _mix32(seed[:, None, None, None] ^ _mix32(idx)[None])
    else:
        b = torch.arange(batch, device=device)[:, None, None, None]
        idx = (((b * heads + h) * n + i) * n + j) & _M32
        u = _mix32(seed ^ _mix32(idx))
    return _keep_from_hash(u, rate)


# --- plain versions -------------------------------------------------------

def _heads_view(t, heads):
    b, n, d = t.shape
    return t.reshape(b, n, heads, d // heads).float()


def _scores(qh, kh, scale, bias, mask):
    """fp32 scores (B, h, N, N): q . k * scale, then the (B, N) key bias,
    then the (N, N) score mask (JAX `_attend_bwd_one_row` :231-238)."""
    s = torch.einsum("bnhd,bmhd->bhnm", qh, kh) * scale
    if bias is not None:
        s = s + bias[:, None, None, :].float()
    if mask is not None:
        s = s + mask.float()
    return s


def mha_reference(q, k, v, heads: int, bias=None, scale=None,
                  dropout_rate: float = 0.0, dropout_seed=None, mask=None):
    """Plain attention over (B, N, D) q/k/v (heads-major in D), optional
    (B, N) additive key bias, (N, N) additive score mask and probability
    dropout: fp32 softmax, p times the keep/scale mask, p rounded to v's
    dtype before P.V, output in q's dtype (JAX `_attend_one_row`
    :116-150)."""
    mha_reference.calls += 1
    b, n, d = q.shape
    if scale is None:
        scale = (d // heads) ** -0.5
    s = _scores(_heads_view(q, heads), _heads_view(k, heads), scale, bias,
                mask)
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0:
        p = p * dropout_keep_4d(dropout_seed, b, heads, n, dropout_rate,
                                q.device)
    p = p.to(v.dtype).float()
    o = torch.einsum("bhnm,bmhd->bnhd", p, _heads_view(v, heads))
    return o.reshape(b, n, d).to(q.dtype)


mha_reference.calls = 0


def mha_bwd_reference(q, k, v, g, heads: int, bias=None, scale=None,
                      dropout_rate: float = 0.0, dropout_seed=None,
                      mask=None):
    """Plain backward of `mha_reference`, the K3 contract
    (`_attend_bwd_one_row` :212-271): p and dp stay fp32, y = p * keep
    is cast to g's dtype for dv, ds * scale is cast to q's dtype for dq and
    dk. Returns (dq, dk, dv, dbias), dbias the fp32 sum of ds over heads
    and query rows (None without a bias). With `mask` it is the K3m
    contract, the function that kernel is held against."""
    mha_bwd_reference.calls += 1
    b, n, d = q.shape
    if scale is None:
        scale = (d // heads) ** -0.5
    qh, kh, vh, gh = (_heads_view(t, heads) for t in (q, k, v, g))
    p = torch.softmax(_scores(qh, kh, scale, bias, mask), dim=-1)
    dp = torch.einsum("bnhd,bmhd->bhnm", gh, vh)
    y = p
    if dropout_rate > 0:
        keep = dropout_keep_4d(dropout_seed, b, heads, n, dropout_rate,
                               q.device)
        y = p * keep
        dp = dp * keep
    dv = torch.einsum("bhnm,bnhd->bmhd", y.to(g.dtype).float(), gh)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsc = (ds * scale).to(q.dtype).float()
    dq = torch.einsum("bhnm,bmhd->bnhd", dsc, kh)
    dk = torch.einsum("bhnm,bnhd->bmhd", dsc, qh)
    dbias = None if bias is None else ds.sum(dim=(1, 2))
    return (dq.reshape(b, n, d).to(q.dtype), dk.reshape(b, n, d).to(q.dtype),
            dv.reshape(b, n, d).to(q.dtype), dbias)


mha_bwd_reference.calls = 0


# --- the kernels ----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fwd_kernel():
    lib = _build.load("mha_fwd")
    fn = lib.bscan_mha_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
        + [ctypes.c_float, ctypes.c_int]
        + [ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
           ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    smem = lib.bscan_mha_fwd_smem_bytes
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    smem.restype = ctypes.c_longlong
    return lib, fn, smem


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    lib = _build.load("mha_bwd")
    fn = lib.bscan_mha_bwd
    fn.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 4
        + [ctypes.c_float, ctypes.c_int]
        + [ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
           ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    smem = lib.bscan_mha_bwd_smem_bytes
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_longlong
    return lib, fn, smem


@functools.lru_cache(maxsize=None)
def _max_smem(device_index: int) -> int:
    lib = _build.load("mha_fwd")
    limit = lib.bscan_max_smem_per_block
    limit.argtypes = [ctypes.c_int]
    limit.restype = ctypes.c_longlong
    return limit(device_index)


def _check_smem(name, need, n, hd, dev):
    """Raise unless a CTA's `need` bytes of shared memory fit the card."""
    if n > 65535 or n < 1:
        raise ValueError(f"{name}: sequence length {n} out of range")
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    limit = _max_smem(idx)
    if need > limit:
        raise ValueError(
            f"{name}: N={n}, head_dim={hd} needs {need} bytes of shared "
            f"memory per block; this card allows {limit}"
        )


def _drop_args(rate: float, seed, b: int, dev):
    """(row_seeds pointer holder, scalar seed, threshold, scale, drop flag)
    for a kernel launch: a (B,) seed tensor goes as int32 bits on the card;
    a scalar goes by value."""
    if rate <= 0:
        return None, 0, 0, 1.0, 0
    seed = u32(seed)
    rows = None
    scalar = 0
    if seed.ndim == 1:
        if seed.shape[0] != b:
            raise ValueError(f"dropout seed vector has {seed.shape[0]} rows, "
                             f"the batch {b}")
        rows = torch.where(seed >= 2**31, seed - 2**32, seed).to(
            device=dev, dtype=torch.int32).contiguous()
    elif seed.ndim == 0:
        scalar = int(seed)
    else:
        raise ValueError("dropout seed must be a scalar or a (B,) vector")
    return rows, scalar, _keep_threshold(rate), keep_scale(rate), 1


def _launch_fwd(ptrs, out, b, n, heads, hd, row_stride, scale, dtype, bias,
                rate=0.0, seed=None, mask=None):
    if b > 65535:  # the batch is the grid's z dimension
        raise ValueError(f"mha kernel: batch {b} > 65535; split the batch")
    lib, fn, smem = _fwd_kernel()
    dev = out.device
    _check_smem("mha kernel", smem(n, hd), n, hd, dev)
    rows, scalar, thr, kscale, drop = _drop_args(rate, seed, b, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        *ptrs, None if bias is None else bias.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        b, n, heads, hd, row_stride, n * row_stride, float(scale),
        _DTYPE_CODE[dtype],
        None if rows is None else rows.data_ptr(), scalar, thr, kscale, drop,
        stream,
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


def _check_split(name, q, k, v, bias):
    b, n, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q/k/v shapes differ: {q.shape} {k.shape} "
                         f"{v.shape}")
    _check_cuda(name, [q, k, v], q.dtype)
    if bias is not None:
        _check_cuda(f"{name} bias", [bias], torch.float32)
        if bias.device != q.device or tuple(bias.shape) != (b, n):
            raise ValueError(f"{name}: bias must be ({b}, {n}) on {q.device}")


def _packed_forward(qkv, mask, heads, scale):
    d = qkv.shape[-1] // 3
    if qkv.device.type == "cpu":
        return mha_reference(qkv[..., :d], qkv[..., d : 2 * d],
                             qkv[..., 2 * d :], heads, scale=scale, mask=mask)
    _check_heads("mha_packed", d, heads, qkv.dtype)
    _check_cuda("mha_packed", [qkv], qkv.dtype)
    b, n, d3 = qkv.shape
    if mask is not None:
        _check_cuda("mha_packed mask", [mask], torch.float32)
        if mask.device != qkv.device or tuple(mask.shape) != (n, n):
            raise ValueError(f"mha_packed: mask must be ({n}, {n}) on "
                             f"{qkv.device}")
    out = torch.empty((b, n, d), dtype=qkv.dtype, device=qkv.device)
    p = qkv.data_ptr()
    es = qkv.element_size()
    _launch_fwd((p, p + d * es, p + 2 * d * es), out, b, n, heads, d // heads,
                d3, scale, qkv.dtype, None, mask=mask)
    if mask is None:
        mha_packed.launches += 1
    else:
        mha_packed.mask_launches += 1
    return out


def _split_forward(q, k, v, bias, seed, heads, scale, rate):
    if q.device.type == "cpu":
        return mha_reference(q, k, v, heads, bias=bias, scale=scale,
                             dropout_rate=rate, dropout_seed=seed)
    name = "mha_dropout" if rate > 0 else "mha"
    b, n, d = q.shape
    _check_heads(name, d, heads, q.dtype)
    _check_split(name, q, k, v, bias)
    out = torch.empty_like(q)
    _launch_fwd((q.data_ptr(), k.data_ptr(), v.data_ptr()), out, b, n, heads,
                d // heads, d, scale, q.dtype, bias, rate, seed)
    if rate > 0:
        mha_dropout.launches += 1
    else:
        mha.launches += 1
    return out


class _PackedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, mask, heads, scale):
        ctx.save_for_backward(qkv, mask)
        ctx.cfg = (heads, scale)
        return _packed_forward(qkv, mask, heads, scale)

    @staticmethod
    def backward(ctx, g):
        qkv, mask = ctx.saved_tensors
        heads, scale = ctx.cfg
        dqkv = mha_bwd(None, None, None, g.contiguous(), heads, scale=scale,
                       packed_qkv=qkv, mask=mask)
        return dqkv, None, None, None


class _SplitAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, seed, heads, scale, rate):
        ctx.save_for_backward(q, k, v, bias, seed)
        ctx.cfg = (heads, scale, rate)
        return _split_forward(q, k, v, bias, seed, heads, scale, rate)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, seed = ctx.saved_tensors
        heads, scale, rate = ctx.cfg
        dq, dk, dv, dbias = mha_bwd(
            q, k, v, g.contiguous(), heads, bias=bias, scale=scale,
            dropout_rate=rate, dropout_seed=seed,
            need_dbias=ctx.needs_input_grad[3],
        )
        return dq, dk, dv, dbias, None, None, None, None


def mha_packed(qkv, heads: int, scale=None, mask=None):
    """Attention over a packed (B, N, 3D) qkv (q|k|v along the last axis,
    heads-major in each third: the timm fused-qkv layout) -> (B, N, D).
    `mask`: an optional (N, N) fp32 additive score mask shared across the
    batch (OpenCLIP's causal text mask), added after the scale (K1m).
    Differentiable in qkv: the backward is K3 on the card, K3m with a
    mask."""
    d3 = qkv.shape[-1]
    if d3 % 3:
        raise ValueError(f"mha_packed: last dim {d3} is not 3 * D")
    if scale is None:
        scale = (d3 // 3 // heads) ** -0.5
    return _PackedAttention.apply(qkv, mask, heads, float(scale))


mha_packed.launches = 0
mha_packed.mask_launches = 0


def mha(q, k, v, heads: int, bias=None, scale=None,
        dropout_rate: float = 0.0, dropout_seed=None):
    """Attention over separate (B, N, D) q/k/v with an optional (B, N)
    fp32 additive key bias (0 / -1e9 padding) -> (B, N, D) in q's dtype.
    `dropout_rate > 0` with a uint32 `dropout_seed` (scalar, or (B,) per-row
    seeds) drops attention probabilities through `mha_dropout` (K2d).
    Differentiable in q, k, v and bias: the backward is K3 on the card."""
    if dropout_rate > 0:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        return mha_dropout(q, k, v, heads, dropout_seed, dropout_rate,
                           bias=bias, scale=scale)
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    return _SplitAttention.apply(q, k, v, bias, None, heads, float(scale),
                                 0.0)


mha.launches = 0


def mha_dropout(q, k, v, heads: int, seed, rate: float, bias=None,
                scale=None):
    """`mha` with attention-probability dropout at `rate` (K2d): the mask
    is the counter hash of `dropout_keep_4d`, computed inside the kernel."""
    if not 0 < rate < 1:
        raise ValueError(f"mha_dropout: rate {rate} outside (0, 1)")
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    # a scalar seed stays on the host (it goes to the kernel by value)
    return _SplitAttention.apply(q, k, v, bias, u32(seed), heads,
                                 float(scale), float(rate))


mha_dropout.launches = 0


def mha_bwd(q, k, v, g, heads: int, bias=None, scale=None,
            dropout_rate: float = 0.0, dropout_seed=None, packed_qkv=None,
            need_dbias: bool = False, mask=None):
    """The attention backward (K3). Either q/k/v (B, N, D) or `packed_qkv`
    (B, N, 3D) is given, and g is dL/d(output) (B, N, D). Returns
    (dq, dk, dv, dbias) in the input dtype (dbias fp32 (B, N) when
    `need_dbias` and a bias are given, else None), or the (B, N, 3D) dqkv
    for a packed input. An (N, N) fp32 score `mask`, shared across the
    batch, makes it K3m (counted in `mha_bwd.mask_launches`)."""
    packed = packed_qkv is not None
    if packed:
        d = packed_qkv.shape[-1] // 3
        q, k, v = (packed_qkv[..., :d], packed_qkv[..., d : 2 * d],
                   packed_qkv[..., 2 * d :])
    b, n, d = q.shape
    if scale is None:
        scale = (d // heads) ** -0.5
    if q.device.type == "cpu":
        dq, dk, dv, dbias = mha_bwd_reference(
            q, k, v, g, heads, bias=bias, scale=scale,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed, mask=mask)
        if packed:
            return torch.cat([dq, dk, dv], dim=-1)
        return dq, dk, dv, (dbias if need_dbias else None)

    _check_heads("mha_bwd", d, heads, q.dtype)
    if g.shape != (b, n, d):
        raise ValueError(f"mha_bwd: g {tuple(g.shape)}, expected {(b, n, d)}")
    if mask is not None:
        _check_cuda("mha_bwd mask", [mask], torch.float32)
        if mask.device != q.device or tuple(mask.shape) != (n, n):
            raise ValueError(f"mha_bwd: mask must be ({n}, {n}) on "
                             f"{q.device}")
    if b > 65535:
        raise ValueError(f"mha_bwd: batch {b} > 65535; split the batch")
    lib, fn, smem = _bwd_kernel()
    dev = q.device
    _check_smem("mha_bwd", smem(n, d // heads, _DTYPE_CODE[q.dtype]), n,
                d // heads, dev)
    es = q.element_size()
    if packed:
        _check_cuda("mha_bwd", [packed_qkv, g], packed_qkv.dtype)
        p = packed_qkv.data_ptr()
        ins = (p, p + d * es, p + 2 * d * es)
        dqkv = torch.empty_like(packed_qkv)
        o = dqkv.data_ptr()
        outs = (o, o + d * es, o + 2 * d * es)
        row = 3 * d
    else:
        _check_split("mha_bwd", q, k, v, bias)
        _check_cuda("mha_bwd g", [g], q.dtype)
        ins = (q.data_ptr(), k.data_ptr(), v.data_ptr())
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        outs = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
        row = d
    stats = torch.empty((b, heads, n, 3), dtype=torch.float32, device=dev)
    dbias = part = None
    if need_dbias and bias is not None:
        dbias = torch.empty((b, n), dtype=torch.float32, device=dev)
        part = torch.empty((b, heads, n), dtype=torch.float32, device=dev)
    rows, scalar, thr, kscale, drop = _drop_args(dropout_rate, dropout_seed,
                                                 b, dev)
    err = fn(
        *ins, g.data_ptr(), None if bias is None else bias.data_ptr(),
        None if mask is None else mask.data_ptr(), *outs,
        None if dbias is None else dbias.data_ptr(), stats.data_ptr(),
        None if part is None else part.data_ptr(),
        b, n, heads, d // heads, row, n * row, row, n * row, float(scale),
        _DTYPE_CODE[q.dtype],
        None if rows is None else rows.data_ptr(), scalar, thr, kscale, drop,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, "mha_bwd launch")
    if mask is None:
        mha_bwd.launches += 1
    else:
        mha_bwd.mask_launches += 1
    if packed:
        return dqkv
    return dq, dk, dv, dbias


mha_bwd.launches = 0
mha_bwd.mask_launches = 0
