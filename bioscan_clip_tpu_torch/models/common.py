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


def gelu_exact(x):
    """Exact-erf GELU (JAX common.py:31-43). torch's `approximate="none"`
    is the same erf form."""
    return F.gelu(x, approximate="none")


def dense(mod: nn.Linear, x, dtype: torch.dtype):
    """A Flax `nn.Dense(dtype=...)`: input and fp32 parameters cast to the
    compute dtype, output in it."""
    bias = None if mod.bias is None else mod.bias.to(dtype)
    return F.linear(x.to(dtype), mod.weight.to(dtype), bias)


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
