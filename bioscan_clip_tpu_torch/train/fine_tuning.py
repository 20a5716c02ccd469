"""Supervised species-classification fine-tuning.

Counterpart of bioscan_clip_tpu/train/fine_tuning.py (the reference's
bioscanclip/epoch/fine_tuning_epoch.py):
- `label_batch_to_species_idx`: species string -> index into the unique
  seen species list (:6-9);
- `make_classifier_train_step`: cross-entropy on one `EncoderWithHead`'s
  logits (:11-37); `make_joint_classifier_train_step`: the image and DNA
  classifiers, their cross-entropies summed (:77-103);
- `evaluate_classifier`: top-k accuracy over the logits (:39-75);
- `get_all_unique_species_from_loader`: first-appearance order.

Every weight trains: `create_fine_tune_state` is AdamW over every
parameter (fp32 masters, lr 1e-3, weight decay 1e-4: optax.adamw's
defaults, as the JAX CLIs use it), with no frozen group and no bf16 copy;
compute follows the model's dtype (bf16 on the card).

Randomness is keyed by (step seed, global row), as in the contrastive
steps (`train/loop.py`): a uint8 image batch gets the device train
augmentation drawn from the step seed (no ColorJitter), a BERT tower its
row-keyed dropout seeds (`tower_row_seeds`). JAX draws both from its PRNG
key, which torch cannot reproduce, so the two packages agree at dropout 0
on pre-transformed images. Draw the step seed from the state's generator
(`loop.draw_step_seed(state.generator)`).

Over a mesh of several processes each step takes the process's rows of
the global batch, every draw made for the global batch and sliced; the
loss is the global batch's mean (each process's sum over the global row
count, summed over the processes) and the gradients are summed, so the
step equals one process on the concatenated rows. The steps run eagerly:
the JAX steps are plain `jit` with no K-steps-per-call form.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from bioscan_clip_tpu_torch.data.transforms import (
    eval_transform_auto,
    train_transform_auto,
)
from bioscan_clip_tpu_torch.parallel.mesh import all_reduce_sum
from bioscan_clip_tpu_torch.train.loop import (
    _global_rows,
    _sum_gradients,
    _to_device,
    batch_rows,
    data_axis,
    draw_batch_aug,
    tower_row_seeds,
)
from bioscan_clip_tpu_torch.train.schedules import constant
from bioscan_clip_tpu_torch.train.state import create_train_state


def label_batch_to_species_idx(label_dicts, unique_species_for_seen):
    index = {s: i for i, s in enumerate(unique_species_for_seen)}
    return np.asarray([index[d["species"]] for d in label_dicts],
                      dtype=np.int64)


def create_fine_tune_state(model: nn.Module, lr: float = 1e-3,
                           weight_decay: float = 1e-4, seed: int = 0):
    """AdamW (b1 0.9, b2 0.999, eps 1e-8) at a constant `lr` over every
    parameter of `model`; `seed` seeds the step-seed generator."""
    return create_train_state(model, constant(lr), disable_lora=True,
                              weight_decay=weight_decay, seed=seed)


def _train_input(x, step_seed, rows, modality: str, openclip_norm: bool):
    """(the classifier's input, its keyword arguments) for one step: a
    uint8 image batch through the train augmentation, a DNA batch with its
    rows' dropout seeds."""
    if modality == "image":
        if x.dtype == torch.uint8:
            aug = draw_batch_aug({"image_u8": x}, step_seed, rows=rows)
            x = train_transform_auto(x, aug, normalize=openclip_norm)
        return x, {}
    total, mine = rows
    seeds = batch_rows(tower_row_seeds(step_seed, total, x.device), mine)
    return x, {"row_seeds": seeds["dna"]}


def _classifier_step(model, mesh, loss_of):
    """train_step(state, batch, step_seed) -> (state, loss): `loss_of`
    (batch, step_seed, rows) is this process's share of the global mean
    loss; backward, the gradients summed over the processes, AdamW.
    `train_step.model` is the model its state must hold;
    `train_step.loss_fn(batch, step_seed)` the loss alone, for a caller
    that differentiates it itself."""
    def loss_fn(batch, step_seed):
        rows = _global_rows(mesh, batch["target"].shape[0])
        return loss_of(batch, step_seed, rows)

    def train_step(state, batch, step_seed):
        if state.model is not model:
            raise ValueError("train_step: the state holds another model")
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        state.set_lr()
        loss = loss_fn(batch, step_seed)
        loss.backward()
        _sum_gradients(model, mesh, skip=())
        state.optimizer.step()
        state.step += 1
        loss = loss.detach()
        if mesh is not None:
            all_reduce_sum([loss], mesh)
        return state, loss

    train_step.model = model
    train_step.loss_fn = loss_fn
    return train_step


def _ce_share(logits, target, total: int):
    return F.cross_entropy(logits.float(), target, reduction="sum") / total


def make_classifier_train_step(model, mesh=None, modality: str = "image",
                               openclip_norm: bool = False):
    """Cross-entropy fine-tune step of an `EncoderWithHead` on one
    modality. `batch`: {"input": (B, ...) images or DNA tokens, "target":
    (B,) int64 species indices}, tensors on the model's device."""
    mesh = data_axis(mesh)

    def loss_of(batch, step_seed, rows):
        x, kw = _train_input(batch["input"], step_seed, rows, modality,
                             openclip_norm)
        return _ce_share(model(x, **kw), batch["target"], rows[0])

    return _classifier_step(model, mesh, loss_of)


def make_joint_classifier_train_step(image_model, dna_model, mesh=None,
                                     openclip_norm: bool = False):
    """The joint image + DNA fine-tune: two classifiers, their
    cross-entropies summed. The state's model is the step's `model`,
    `nn.ModuleDict({"image": image_model, "dna": dna_model})`. `batch`:
    {"image", "dna", "target"}."""
    mesh = data_axis(mesh)
    model = nn.ModuleDict({"image": image_model, "dna": dna_model})

    def loss_of(batch, step_seed, rows):
        t = batch["target"]
        img, _ = _train_input(batch["image"], step_seed, rows, "image",
                              openclip_norm)
        dna, kw = _train_input(batch["dna"], step_seed, rows, "dna",
                               openclip_norm)
        return (_ce_share(image_model(img), t, rows[0])
                + _ce_share(dna_model(dna, **kw), t, rows[0]))

    return _classifier_step(model, mesh, loss_of)


def evaluate_classifier(model, dataloader, unique_species_for_seen,
                        k_values=None, modality: str = "image",
                        openclip_norm: bool = False):
    """Top-k accuracy of the classifier's logits on its device (JAX
    fine_tuning.py:102-145): uint8 images through the device eval
    transform (`eval_transform_auto`), float images as they come."""
    k_values = k_values or [1, 3, 5]
    max_k = min(max(k_values), len(unique_species_for_seen))
    device = next(model.parameters()).device
    model.eval()
    targets, preds = [], []
    with torch.inference_mode():
        for batch in dataloader:
            targets.append(label_batch_to_species_idx(
                batch["label_dicts"], unique_species_for_seen))
            x = _to_device(batch.get("image_u8", batch.get("image"))
                           if modality == "image" else batch["dna"], device)
            if modality == "image" and x.dtype == torch.uint8:
                x = eval_transform_auto(x, normalize=openclip_norm)
            logits = model(x).float()
            preds.append(torch.topk(logits, max_k, dim=-1).indices.cpu()
                         .numpy())
    targets, preds = np.concatenate(targets), np.concatenate(preds)
    return {f"top{k}_accuracy": float(
        (preds[:, :k] == targets[:, None]).any(axis=1).mean())
        for k in k_values}


def get_all_unique_species_from_loader(dataloader) -> list:
    """The species of a loader in first-appearance order (JAX
    fine_tuning.py:148-160; the reference takes a set's order)."""
    seen, out = set(), []
    for batch in dataloader:
        for d in batch["label_dicts"]:
            if d["species"] not in seen:
                seen.add(d["species"])
                out.append(d["species"])
    return out
