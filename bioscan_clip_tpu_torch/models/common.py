"""Shared tower pieces.

Counterpart of bioscan_clip_tpu/models/common.py. Parameters are fp32; each
tower computes its matmuls in a compute dtype given to its constructor (bf16
on the card, fp32 on the CPU), as the Flax modules' `dtype` does.
LayerNorms compute in their own dtype, an explicit constructor argument
(default fp32), where the JAX package reads `BSCAN_FAST_LN` at trace time.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bioscan_clip_tpu_torch.ops.attention import _keep_threshold, _mix32, u32


def gelu_exact(x):
    """Exact-erf GELU (JAX common.py:31-43). torch's `approximate="none"`
    is the same erf form."""
    return F.gelu(x, approximate="none")


def dense(mod: nn.Linear, x, dtype: torch.dtype):
    """A Flax `nn.Dense(dtype=...)`: input and fp32 parameters cast to the
    compute dtype, output in it."""
    bias = None if mod.bias is None else mod.bias.to(dtype)
    return F.linear(x.to(dtype), mod.weight.to(dtype), bias)


def patch_embed(images, conv: nn.Conv2d, dtype: torch.dtype):
    """A (p x p, stride p) convolution over (B, H, W, C) NHWC images, as a
    patch reshape plus one matmul -> (B, (H/p) * (W/p), O) in `dtype`, so
    fp32 never goes through cuDNN's TF32 convolutions."""
    b, h, w, c = images.shape
    p = conv.kernel_size[0]
    x = images.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, (h // p) * (w // p), p * p * c)
    weight = conv.weight.permute(0, 2, 3, 1).reshape(conv.out_channels, -1)
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.linear(x.to(dtype), weight.to(dtype), bias)


def l2_normalize(x, dim: int = -1, eps: float = 1e-12):
    """torch F.normalize(p=2) parity: x / max(||x||, eps)."""
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=dim,
                                                        keepdim=True), eps)


class LayerNorm(nn.LayerNorm):
    """LayerNorm that computes (and returns) in `dtype`, default fp32."""

    def __init__(self, width: int, eps: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__(width, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.layer_norm(
            x.to(dt), self.normalized_shape, self.weight.to(dt),
            self.bias.to(dt), self.eps,
        )


# --- batch-composition-invariant ("per-sample") dropout -------------------
#
# JAX common.py:111-177. Every mask element is keyed by (per-row seed, site,
# position within the row) through the attention kernels' counter hash, so
# a row's dropout is the same however rows are grouped into batches. This is
# the port's only dropout mode: flax's `nn.Dropout` stream cannot be
# reproduced in torch. Seeds are (B,) int64 tensors holding uint32 values.

_SALT_GOLD = 0x9E3779B9  # golden-ratio increment (splitmix-style chains)


def row_seeds_init(base_seed, row_ids):
    """(B,) per-row seeds from a step-level uint32 seed and the rows'
    positions in the full logical batch."""
    rows = u32(row_ids)
    return _mix32(u32(base_seed, rows.device) ^ _mix32(rows + 1))


def row_salt_advance(row_salt):
    """The next layer's (B,) salt: layer k's streams depend only on
    (row seed, k)."""
    return _mix32(row_salt + _SALT_GOLD)


def site_seed(row_salt, site: int):
    """(B,) seed of dropout site `site` of the current layer."""
    c = (site * 0x85EBCA6B + 0xC2B2AE35) & 0xFFFFFFFF
    return _mix32(row_salt ^ c)


def ps_dropout(x, rate: float, row_salt, site: int):
    """Dropout over (B, ...) x whose element (b, pos) keeps when
    _mix32(site_seed[b] ^ _mix32(pos + 1)) >= threshold; kept elements are
    scaled by 1 / (1 - rate) rounded to x's dtype, as `nn.Dropout`."""
    if rate <= 0 or row_salt is None:
        return x
    pos = torch.arange(x[0].numel(), device=x.device)
    u = _mix32(site_seed(row_salt, site)[:, None] ^ _mix32(pos + 1)[None, :])
    keep = (u >= _keep_threshold(rate)).reshape(x.shape)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=x.dtype, device=x.device)
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))
