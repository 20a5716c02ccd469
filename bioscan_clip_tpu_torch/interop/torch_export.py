"""A port model -> the reference SimpleCLIP `.pth` layout.

Counterpart of bioscan_clip_tpu/interop/torch_export.py
(`export_simple_clip`, `save_pth` :117-156), which maps a JAX parameter
tree onto the reference's state-dict names so a trained checkpoint goes
back to the PyTorch tooling (the reference's scripts, BZSL, released-ckpt
consumers). The port's modules already carry those names (LoRA-wrapped
`blocks.{i}.attn.qkv.qkv.weight` + `linear_{a,b}_{q,v}`,
`attention.self.{query,value}.{w,w_a,w_b}` when adapters are present, the
plain layout otherwise), so the export is the model's own state dict in
float32 on the host, without the learnable `logit_scale` that JAX's export
also leaves out. `train/checkpoint.load_pth_into_params` (or
`interop/weights.load_reference_pth`) reads the file back.
"""

from __future__ import annotations

import torch
from torch import nn

NOT_EXPORTED = ("logit_scale",)


def export_state_dict(model: nn.Module) -> dict:
    """Reference-layout name -> contiguous float32 CPU tensor."""
    return {k: v.detach().to("cpu", torch.float32).contiguous()
            for k, v in model.state_dict().items()
            if k not in NOT_EXPORTED}


def save_pth(model: nn.Module, path: str) -> str:
    """Write a torch-loadable `.pth` of `export_state_dict(model)`."""
    torch.save(export_state_dict(model), path)
    return path
