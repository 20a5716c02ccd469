"""The train state: the model, masked AdamW over its trainable set, and the
learning-rate schedule.

Counterpart of bioscan_clip_tpu/train/state.py:23-188. The reference trains
the LoRA adapters and each tower's fresh projection (image `head`, DNA
`decoder`, text `proj`) with AdamW (lr from lr_config, default 1e-3) and
freezes the rest (train_cl.py:158). The JAX package expresses the freeze as
an optax `multi_transform` mask; here the labels become parameter groups:
- "trainable": AdamW with torch's defaults (b1 0.9, b2 0.999, eps 1e-8,
  weight decay 0.01);
- "scale" (the optional learnable `logit_scale`): Adam, no weight decay;
- "frozen": `requires_grad_(False)`, no optimizer state, never updated.
The learning rate of both groups is `schedule(step)` at each update, with
step counted from 0 (optax's convention).

The labels follow the JAX package's name rules on the port's names. Like the
JAX rule (a tower's fresh head is any module named head/decoder/proj above
the leaf), this also labels ViT's attention output projection
(`blocks.{i}.attn.proj`) trainable. OpenCLIP's `proj` and `text_projection`
are parameters at the tower root, with no such module above them, and its
`out_proj`/`c_proj` are no `proj`: all frozen, as in JAX.

The state also owns the CPU `torch.Generator` that `train.loop.train_epoch`
draws step seeds from (`state.generator`), so a checkpoint
(`train.checkpoint`) carries it and a resumed run draws the seeds an
uninterrupted one would.
"""

from __future__ import annotations

import torch
from torch import nn

from bioscan_clip_tpu_torch.models.lora import LORA_A_NAMES, LORA_B_NAMES

TRAINABLE_HEAD_NAMES = ("head", "decoder", "proj")
# LoRA adapter modules (the JAX package's `lora_*` leaves)
LORA_MODULE_NAMES = frozenset(LORA_A_NAMES + LORA_B_NAMES)
# tower trunks: an fc1/fc2/fc3 inside one is an MLP block, not an encoder
_TRUNK_NAMES = frozenset({"blocks", "layer", "bert", "lora_bert"})


def _label(name: str, disable_lora: bool) -> str:
    keys = name.split(".")
    if keys[0] == "logit_scale":
        return "scale"
    if disable_lora:
        return "trainable"
    if any(k in LORA_MODULE_NAMES for k in keys):
        return "trainable"
    # the JAX patch embedding is one module, `patch_embed`; the port keeps
    # the reference's `patch_embed.proj`, which is no fresh head
    if "patch_embed" in keys:
        return "frozen"
    if any(k in TRAINABLE_HEAD_NAMES for k in keys[:-1]):
        return "trainable"
    # MLP / identity encoders (feature input_type) are fully trainable
    if (any(k in ("fc1", "fc2", "fc3") for k in keys)
            and not any(k in _TRUNK_NAMES for k in keys)):
        return "trainable"
    return "frozen"


def param_labels(model: nn.Module, disable_lora: bool = False) -> dict:
    """{parameter name: 'trainable' | 'frozen' | 'scale'}."""
    return {name: _label(name, disable_lora)
            for name, _ in model.named_parameters()}


def cast_frozen_params(model: nn.Module, dtype=torch.bfloat16,
                       disable_lora: bool = False) -> nn.Module:
    """Store the frozen parameters that the towers consume in the compute
    dtype in `dtype`, in place (`tpu.frozen_dtype: bfloat16`). Under bf16
    compute every Linear/Conv/Embedding weight and bias is cast to bf16 at
    each use anyway, so this is bit-identical compute at half the resident
    size. LayerNorm parameters (consumed in fp32) and trainable parameters
    (AdamW masters) stay fp32. Only for a model computing in `dtype`."""
    labels = param_labels(model, disable_lora)
    ln = {id(p) for m in model.modules() if isinstance(m, nn.LayerNorm)
          for p in m.parameters()}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if (labels[name] == "frozen" and id(p) not in ln
                    and p.dtype == torch.float32):
                p.data = p.data.to(dtype)
    return model


class TrainState:
    """Model + optimizer + schedule + step count + the step-seed generator.
    `apply_gradients()` takes the gradients autograd left in `.grad`."""

    def __init__(self, model, optimizer, schedule, labels, seed: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.labels = labels
        self.step = 0
        self.generator = torch.Generator().manual_seed(seed)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def apply_gradients(self):
        lr = float(self.schedule(self.step))
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def create_train_state(model: nn.Module, schedule, disable_lora: bool = False,
                       weight_decay: float = 0.01, seed: int = 0) -> TrainState:
    """Masked AdamW over `model`'s trainable parameters (see module doc).
    Frozen parameters get `requires_grad_(False)`. `seed` seeds the
    step-seed generator."""
    labels = param_labels(model, disable_lora)
    groups = {"trainable": [], "scale": []}
    for name, p in model.named_parameters():
        lab = labels[name]
        p.requires_grad_(lab != "frozen")
        if lab != "frozen":
            groups[lab].append(p)
    param_groups = [{"params": groups["trainable"],
                     "weight_decay": weight_decay}]
    if groups["scale"]:
        param_groups.append({"params": groups["scale"], "weight_decay": 0.0})
    opt = torch.optim.AdamW(param_groups, lr=float(schedule(0)),
                            betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model, opt, schedule, labels, seed)
