"""LoRA adapters on the attention projections, and their merge.

Counterpart of bioscan_clip_tpu/models/lora.py. Module and parameter names
follow the reference checkpoints, so a released `.pth` and
`interop.weights.state_dict_from_jax` load with `strict=True`:
- ViT fused qkv: `attn.qkv.{qkv, linear_a_q, linear_b_q, linear_a_v,
  linear_b_v}` (reference `_LoRA_qkv_timm`), deltas on the q and v thirds;
- BERT query/value: `attention.self.{query,value}.{w, w_a, w_b}`.
A torch Linear stores (out, in), so the JAX adapter A (d, r) is
`linear_a.weight.T` and B (r, d) is `linear_b.weight.T`.
"""

from __future__ import annotations

import re

import torch
from torch import nn

from bioscan_clip_tpu_torch.models.common import dense


def lora_delta(x, a: nn.Linear, b: nn.Linear, dtype: torch.dtype):
    """(x @ A) @ B in the compute dtype (JAX lora.py:39-44)."""
    return dense(b, dense(a, x, dtype), dtype)


class LoRAQKV(nn.Module):
    """ViT fused qkv projection with rank-r adapters on its q and v thirds."""

    def __init__(self, width: int, rank: int):
        super().__init__()
        self.width = width
        self.qkv = nn.Linear(width, 3 * width)
        self.linear_a_q = nn.Linear(width, rank, bias=False)
        self.linear_b_q = nn.Linear(rank, width, bias=False)
        self.linear_a_v = nn.Linear(width, rank, bias=False)
        self.linear_b_v = nn.Linear(rank, width, bias=False)

    def forward(self, x, dtype: torch.dtype):
        d = self.width
        qkv = dense(self.qkv, x, dtype)
        # in place on the fresh projection output (no other reference)
        qkv[..., :d] += lora_delta(x, self.linear_a_q, self.linear_b_q, dtype)
        qkv[..., 2 * d :] += lora_delta(x, self.linear_a_v, self.linear_b_v,
                                        dtype)
        return qkv


class LoRALinear(nn.Module):
    """BERT query/value projection `w` with a rank-r adapter `w_a`, `w_b`."""

    def __init__(self, width: int, rank: int):
        super().__init__()
        self.w = nn.Linear(width, width)
        self.w_a = nn.Linear(width, rank, bias=False)
        self.w_b = nn.Linear(rank, width, bias=False)

    def forward(self, x, dtype: torch.dtype):
        return dense(self.w, x, dtype) + lora_delta(x, self.w_a, self.w_b,
                                                    dtype)


def project(mod: nn.Module, x, dtype: torch.dtype):
    """Apply a plain Linear or a LoRA-wrapped projection."""
    if isinstance(mod, nn.Linear):
        return dense(mod, x, dtype)
    return mod(x, dtype)


_VIT_QKV = re.compile(r"^(.*\.attn\.qkv)\.qkv\.(weight|bias)$")
_BERT_QV = re.compile(r"^(.*\.attention\.self\.(?:query|value))\.w\.(weight|bias)$")


def merge_lora(state_dict: dict) -> dict:
    """Fold every adapter into its host projection (W' = W + (A @ B)^T, in
    fp32) and drop the adapter entries: the result loads into the same
    architecture built with `lora_rank=0` (JAX lora.py:47-116, the `qkv`
    and `query`/`value` branches)."""
    out = {}
    for key, val in state_dict.items():
        m = _VIT_QKV.match(key)
        if m:
            root, kind = m.groups()
            val = val.clone()
            if kind == "weight":
                d = val.shape[0] // 3
                for sl, slot in ((slice(0, d), "q"), (slice(2 * d, 3 * d),
                                                      "v")):
                    a = state_dict[f"{root}.linear_a_{slot}.weight"]
                    b = state_dict[f"{root}.linear_b_{slot}.weight"]
                    val[sl] += (b.float() @ a.float()).to(val.dtype)
            out[f"{root}.{kind}"] = val
            continue
        m = _BERT_QV.match(key)
        if m:
            root, kind = m.groups()
            if kind == "weight":
                a = state_dict[f"{root}.w_a.weight"]
                b = state_dict[f"{root}.w_b.weight"]
                val = val + (b.float() @ a.float()).to(val.dtype)
            out[f"{root}.{kind}"] = val
            continue
        if ".linear_a_" in key or ".linear_b_" in key or key.endswith(
            (".w_a.weight", ".w_b.weight")
        ):
            continue
        out[key] = val
    return out
