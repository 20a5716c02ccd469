"""LoRA adapters on the attention projections, and their merge.

Counterpart of bioscan_clip_tpu/models/lora.py. Module and parameter names
follow the reference checkpoints, so a released `.pth` and
`interop.weights.state_dict_from_jax` load with `strict=True`:
- ViT fused qkv: `attn.qkv.{qkv, linear_a_q, linear_b_q, linear_a_v,
  linear_b_v}` (reference `_LoRA_qkv_timm`), deltas on the q and v thirds;
- BERT query/value: `attention.self.{query,value}.{w, w_a, w_b}`;
- OpenCLIP packed `attn.in_proj_{weight,bias}` (torch MultiheadAttention)
  with loratorch's `attn.{q,k,v}_lora_{A,B}`, deltas on all three thirds
  (JAX `OpenClipBlock`, openclip.py:86-95).
A torch Linear stores (out, in), so the JAX adapter A (d, r) is
`linear_a.weight.T` and B (r, d) is `linear_b.weight.T`; loratorch's A is
(r, d) and B (d, r) the same way. The port's B is unscaled: a released
loratorch B is multiplied by alpha / r as it is loaded
(`interop.weights.load_into`), as the JAX converter folds it.
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch import nn

from bioscan_clip_tpu_torch.models.common import dense, selective_remat_active


# the adapter modules (and OpenCLIP's adapter parameters): each A is drawn
# at init, each B starts at zero
LORA_A_NAMES = ("linear_a_q", "linear_a_v", "w_a", "q_lora_A", "k_lora_A",
                "v_lora_A")
LORA_B_NAMES = ("linear_b_q", "linear_b_v", "w_b", "q_lora_B", "k_lora_B",
                "v_lora_B")


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
        dq = lora_delta(x, self.linear_a_q, self.linear_b_q, dtype)
        dv = lora_delta(x, self.linear_a_v, self.linear_b_v, dtype)
        if selective_remat_active():
            # the remat policy saves the projection's output: a new tensor
            return torch.cat([qkv[..., :d] + dq, qkv[..., d : 2 * d],
                              qkv[..., 2 * d :] + dv], dim=-1)
        # in place on the fresh projection output (no other reference)
        qkv[..., :d] += dq
        qkv[..., 2 * d :] += dv
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


class LoRAInProj(nn.Module):
    """OpenCLIP's packed input projection (torch MultiheadAttention's
    `in_proj_weight` (3d, d) and `in_proj_bias`) with rank-r adapters on its
    q, k and v thirds (`{q,k,v}_lora_A` (r, d), `{q,k,v}_lora_B` (d, r));
    no adapters at rank 0."""

    def __init__(self, width: int, rank: int):
        super().__init__()
        self.rank = rank
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        if rank > 0:
            for slot in "qkv":
                setattr(self, f"{slot}_lora_A",
                        nn.Parameter(torch.empty(rank, width)))
                setattr(self, f"{slot}_lora_B",
                        nn.Parameter(torch.empty(width, rank)))

    def in_proj(self, x, dtype: torch.dtype):
        """(B, N, d) -> (B, N, 3d) packed qkv in `dtype`: the projection,
        plus the concatenated (x @ A^T) @ B^T deltas (JAX adds
        `concatenate(deltas)` to the Dense output)."""
        x = x.to(dtype)
        qkv = F.linear(x, self.in_proj_weight.to(dtype),
                       self.in_proj_bias.to(dtype))
        if self.rank == 0:
            return qkv
        deltas = [
            F.linear(F.linear(x, getattr(self, f"{s}_lora_A").to(dtype)),
                     getattr(self, f"{s}_lora_B").to(dtype))
            for s in "qkv"
        ]
        return qkv + torch.cat(deltas, dim=-1)


def project(mod: nn.Module, x, dtype: torch.dtype):
    """Apply a plain Linear or a LoRA-wrapped projection."""
    if isinstance(mod, nn.Linear):
        return dense(mod, x, dtype)
    return mod(x, dtype)


_VIT_QKV = re.compile(r"^(.*\.attn\.qkv)\.qkv\.(weight|bias)$")
_IN_PROJ = re.compile(r"^(.*)\.in_proj_weight$")
_IN_PROJ_LORA = re.compile(r"\.[qkv]_lora_[AB]$")
_BERT_QV = re.compile(r"^(.*\.attention\.self\.(?:query|value))\.w\.(weight|bias)$")


def merge_lora(state_dict: dict) -> dict:
    """Fold every adapter into its host projection (W' = W + (A @ B)^T, in
    fp32) and drop the adapter entries: the result loads into the same
    architecture built with `lora_rank=0` (JAX lora.py:47-116, the `qkv`
    and `query`/`value` branches, and the `in_proj` branch, :95-102)."""
    out = {}
    for key, val in state_dict.items():
        m = _IN_PROJ.match(key)
        if m and f"{m.group(1)}.q_lora_A" in state_dict:
            val = val.clone()
            d = val.shape[1]
            for i, slot in enumerate("qkv"):
                a = state_dict[f"{m.group(1)}.{slot}_lora_A"]
                b = state_dict[f"{m.group(1)}.{slot}_lora_B"]
                val[i * d : (i + 1) * d] += (b.float() @ a.float()).to(
                    val.dtype)
            out[key] = val
            continue
        if _IN_PROJ_LORA.search(key):
            continue
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


def share_merged(merged: nn.Module, model: nn.Module):
    """Bind `merged`, the same architecture at LoRA rank 0 (built on any
    device, the meta device included), to `model`: every entry of
    `merge_lora(model.state_dict())` that is one of `model`'s tensors
    (the frozen towers, the heads) is shared by storage, so nothing of the
    towers is copied; only the folded projections get tensors of their own.
    Returns `refresh()`, which folds the current adapters into them again
    (GradCache's stage 1 runs it once a step, JAX loop.py:524-527)."""
    own = {k: v.detach() for k, v in model.state_dict().items()}
    ptrs = {v.data_ptr() for v in own.values()}
    want = set(merged.state_dict())
    folded = []
    with torch.no_grad():
        for key, val in merge_lora(own).items():
            if key not in want:  # the logit scale: not a tower's
                continue
            path, _, attr = key.rpartition(".")
            mod = merged.get_submodule(path)
            shared = val.data_ptr() in ptrs
            if not shared:
                val = val.clone()
                folded.append((mod, attr))
            if attr in mod._parameters:
                mod._parameters[attr] = nn.Parameter(val,
                                                     requires_grad=False)
            else:
                mod._buffers[attr] = val
    left = [n for n, t in merged.state_dict().items() if t.is_meta]
    if left or not want <= set(merge_lora(own)):
        raise ValueError(f"share_merged: merged model is not model at rank "
                         f"0 (unbound: {left[:5]})")
    keys = [f"{p}.{a}" for p, a in (
        (next(n for n, m in merged.named_modules() if m is mod), attr)
        for mod, attr in folded)]

    def refresh():
        sd = merge_lora({k: v.detach() for k, v in model.state_dict().items()})
        with torch.no_grad():
            for (mod, attr), key in zip(folded, keys):
                getattr(mod, attr).copy_(sd[key])

    refresh.folded = keys
    return refresh
