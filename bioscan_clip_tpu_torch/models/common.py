"""Shared tower pieces.

Counterpart of bioscan_clip_tpu/models/common.py. Parameters are fp32; each
tower computes its matmuls in a compute dtype given to its constructor (bf16
on the card, fp32 on the CPU), as the Flax modules' `dtype` does.
LayerNorms compute in their own dtype, an explicit constructor argument
(default fp32), where the JAX package reads `BSCAN_FAST_LN` at trace time.

Per-layer remat (JAX common.py:46-108, `tpu.remat` / `tpu.remat_policy`)
runs each tower layer under `torch.utils.checkpoint` (non-reentrant) when
gradients are on. "full" recomputes the whole layer in the backward; the
other policies are selective checkpointing over the ops they save, and
each saves the attention output (JAX's `attn_ctx`: the `bscan::mha*`
custom ops of `ops/attention.py`, so the backward launches no attention
forward again):
- "dots": every unbatched matmul output (`aten.mm`, `aten.addmm`; JAX's
  `dots_with_no_batch_dims_saveable` leaves batched products out);
- "dots_act": "dots" plus the GELU (JAX saves its `gelu_erf`, the erfc
  intermediate; the port's GELU is one `aten.gelu`, whose output is saved);
- "narrow": the fc1 output (`mlp_pre`, the matmul under `remat_tag`);
- "wide": "dots" plus the LayerNorm outputs (`aten.native_layer_norm`).
Row-keyed dropout draws no torch RNG: the recompute draws the same masks.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from bioscan_clip_tpu_torch.ops.attention import (
    ATTENTION_OPS,
    _keep_threshold,
    _mix32,
    u32,
)


def gelu_exact(x):
    """Exact-erf GELU (JAX common.py:31-43). torch's `approximate="none"`
    is the same erf form."""
    return F.gelu(x, approximate="none")


REMAT_POLICIES = ("full", "dots", "dots_act", "narrow", "wide")
_aten = torch.ops.aten
_MATMULS = frozenset({_aten.mm.default, _aten.addmm.default})
_SAVED = {
    "dots": _MATMULS | ATTENTION_OPS,
    "dots_act": _MATMULS | ATTENTION_OPS | {_aten.erfc.default,
                                            _aten.gelu.default},
    "narrow": ATTENTION_OPS,
    "wide": _MATMULS | ATTENTION_OPS | {_aten.native_layer_norm.default},
}
_tag = threading.local()


@contextlib.contextmanager
def remat_tag(name: str):
    """Names the ops run under it for a selective remat policy (JAX's
    `checkpoint_name`); "narrow" saves the matmuls tagged "mlp_pre"."""
    prev = getattr(_tag, "name", None)
    _tag.name = name
    try:
        yield
    finally:
        _tag.name = prev


def check_remat_policy(name: str) -> str:
    if name not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat_policy {name!r}: expected full | dots | narrow "
            "| wide | dots_act")
    return name


def _selective(name: str):
    saved = _SAVED[name]

    def policy(ctx, op, *args, **kwargs):
        if op in saved or (op in _MATMULS and name == "narrow"
                           and getattr(_tag, "name", None) == "mlp_pre"):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return lambda: create_selective_checkpoint_contexts(policy)


def selective_remat_active() -> bool:
    """True while a layer runs under a selective remat policy (forward and
    recompute): the outputs the policy saves must not change in place."""
    return getattr(_tag, "selective", False)


def _flag_selective(layer):
    def call(*args):
        prev = selective_remat_active()
        _tag.selective = True
        try:
            return layer(*args)
        finally:
            _tag.selective = prev

    return call


def run_layer(layer: nn.Module, *args, remat: bool = False,
              policy: str = "full"):
    """`layer(*args)`, under per-layer remat with `policy` when `remat` is
    set and gradients are on."""
    if not (remat and torch.is_grad_enabled()):
        return layer(*args)
    # no RNG state to keep (dropout is a counter hash of the row seeds),
    # and reading the card's generator would break a CUDA graph's capture
    if policy == "full":
        return checkpoint(layer, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return checkpoint(_flag_selective(layer), *args, use_reentrant=False,
                      preserve_rng_state=False, context_fn=_selective(policy))


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
    # a fill, not a host-to-device copy (a CUDA graph captures it); the
    # same rounding to x's dtype
    scale = torch.full((), 1.0 / (1.0 - rate), dtype=x.dtype, device=x.device)
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))
