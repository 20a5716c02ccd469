"""The contrastive train steps, the epoch loop, and feature extraction.

Counterpart of bioscan_clip_tpu/train/loop.py:25-147 (`make_train_step`),
:273-780 (`make_accum_train_step`, `make_gradcache_train_step`),
:782-1069 (`make_embed_step`, `extract_features` and the grouped
extraction) and :1072-1241 (`train_epoch`, the plain loop). One step: the
train augmentation of uint8 frames on the device, the three tower forwards
in train mode, the 6-term soft-label InfoNCE, the backward over the
trainable set only (frozen parameters have `requires_grad=False`, so no
frozen-weight gradient is ever formed), then masked AdamW with the
scheduled learning rate. The accumulating steps cut the batch into
microbatches: per-microbatch negatives (`make_accum_train_step`), or the
full batch's through GradCache (`make_gradcache_train_step`).

Every random draw is keyed by the step's uint32 seed and the global row.
Each BERT tower's (B,) row seeds are derived as the JAX package does
(loop.py:565-576: `row_seeds_init(bits ^ 0x0D5A17, arange(B))` for dna,
`bits ^ 0x7A9C33` for language), so both packages can be handed the same
seed; the augmentation parameters come from a generator seeded by the step
seed (`data/transforms.draw_train_aug`). A microbatch or chunk takes its
rows of both, so every grouping of the rows sees the same masks and pixels.
`train_epoch` draws the step seeds from an explicit `torch.Generator`: pass
the state's own (`state.generator`), which `train.checkpoint` saves and
restores, and a resumed run draws the seeds of an uninterrupted one (JAX
derives each step's key from the step, loop.py:134).

Extraction runs the towers in eval mode under `torch.inference_mode()`; a
uint8 image batch goes through the device eval transform first
(`data/transforms.eval_transform`). Grouped extraction merges loader
batches into groups of about `group_samples` rows and runs every tower
once per group: on the card that is 1600 rows by default (as JAX picks on
the TPU), fewer and larger launches; on the CPU it is off.

Over a mesh of several processes (`parallel/mesh.create_mesh` under a
process group, one process per card) each step takes the process's own
rows, global rows [r * B / W, (r + 1) * B / W) of the global batch of B,
and equals the one-process step on the rank-ordered concatenation: every
draw (row seeds, augmentation) is made for the global batch and sliced,
the loss reads the embeddings gathered over the processes
(`parallel/mesh.gather_rows_grad`), and the adapters' gradients are
summed over the processes in one flat all_reduce per dtype. The loss is
the same on every process.

A step is a host prelude (`state.set_lr()`, `step_inputs`: the step seed
and the augmentation draw as tensors on the device) and a device body (the
forward to AdamW) that reads only those: `make_scan_train_step` and
`make_gradcache_train_step(steps_per_call=K)` run K steps per call (JAX's
`lax.scan`, loop.py:150-257, :755-778), on the card by replaying a CUDA
graph of the body (`train.graphs`), and `train_epoch(steps_per_call=K)`
feeds them K stacked loader batches (`stack_batches`).
"""

from __future__ import annotations

import collections
import math
import os
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from torch.utils.checkpoint import checkpoint

from bioscan_clip_tpu_torch.data.transforms import (
    aug_rows,
    draw_train_aug,
    draws_to_device,
    eval_transform,
    train_transform_auto,
)
from bioscan_clip_tpu_torch.losses.contrastive import (
    multimodal_contrastive_loss,
)
from bioscan_clip_tpu_torch.models.common import row_seeds_init
from bioscan_clip_tpu_torch.models.lora import share_merged
from bioscan_clip_tpu_torch.ops.attention import u32
from bioscan_clip_tpu_torch.parallel.mesh import (
    all_reduce_sum,
    gather_rows,
    gather_rows_grad,
)
from bioscan_clip_tpu_torch.train.state import param_labels

LOGIT_SCALE = 1.0 / 0.07  # fixed temperature (train_cl.py:190)
DEVICE_BATCH_KEYS = ("image", "image_u8", "dna", "language", "labels")
# distinct per-tower seed spaces, so dna and language masks never correlate
DNA_SEED_SALT = 0x0D5A17
LANGUAGE_SEED_SALT = 0x7A9C33


def make_logit_scale_param(model: nn.Module, init: float = LOGIT_SCALE):
    """Register the optional learnable log-temperature on `model`
    (`model_config.learnable_logit_scale`): `model.logit_scale` holds
    log(scale), labelled "scale" (Adam without weight decay)."""
    dev = next(model.parameters()).device
    model.logit_scale = nn.Parameter(
        torch.log(torch.tensor(init, dtype=torch.float32)).to(dev))
    return model


def logit_scale_value(model: nn.Module, fixed: float):
    """exp(logit_scale) when the model has the learnable scale, else the
    fixed reference value."""
    ls = getattr(model, "logit_scale", None)
    return ls.exp() if isinstance(ls, torch.Tensor) else fixed


def device_batch(batch: dict, device) -> dict:
    """The array-valued keys that go to the device (label dicts and ids
    stay on the host), as tensors on `device`."""
    def move(x):
        return torch.as_tensor(x).to(device, non_blocking=True)

    out = {}
    for key in DEVICE_BATCH_KEYS:
        if key in batch:
            val = batch[key]
            out[key] = ({k: move(v) for k, v in val.items()}
                        if isinstance(val, dict) else move(val))
    return out


def step_seed_tensor(step_seed, device):
    """A uint32 step seed (a Python int or a tensor) as a 0-d int64 tensor
    on `device`: an int goes by a fill, not a host-to-device copy."""
    if torch.is_tensor(step_seed):
        return u32(step_seed, device)
    return torch.full((), int(step_seed) & 0xFFFFFFFF, dtype=torch.int64,
                      device=device)


def draw_step_seed(generator: torch.Generator) -> int:
    """The next uint32 step seed from `generator` (`state.generator`)."""
    return int(torch.randint(0, 2**32, (), generator=generator,
                             dtype=torch.int64))


def tower_row_seeds(step_seed, batch_size: int, device) -> dict:
    """The (B,) row seeds of each BERT tower for one step: row r's seed
    depends on the step seed and r only, so a microbatch or chunk takes its
    slice of the global batch's seeds (JAX loop.py:565-576). `step_seed`:
    an int, or a 0-d tensor on `device` (a CUDA graph's seed buffer)."""
    rows = torch.arange(batch_size, device=device)
    bits = step_seed_tensor(step_seed, device)
    return {
        "dna": row_seeds_init(bits ^ DNA_SEED_SALT, rows),
        "language": row_seeds_init(bits ^ LANGUAGE_SEED_SALT, rows),
    }


def batch_rows(batch: dict, rows: slice) -> dict:
    """Rows `rows` of a device batch (or of a dict of per-row tensors)."""
    return {k: batch_rows(v, rows) if isinstance(v, dict) else v[rows]
            for k, v in batch.items()}


def draw_batch_aug(batch: dict, step_seed, color_jitter: bool = False,
                   rows=None):
    """The step's train augmentation parameters for every row of `batch`
    (`data/transforms.draw_train_aug`), or None when it ships no uint8
    frames. `rows`: the (global batch size, this process's slice of it)
    of a step over several processes; the draw is made for the global
    batch and sliced."""
    u8 = batch.get("image_u8")
    if u8 is None or batch.get("image") is not None:
        return None
    total, mine = rows or (u8.shape[0], slice(None))
    return aug_rows(draw_train_aug(step_seed, total, tuple(u8.shape[1:3]),
                                   jitter=color_jitter), mine)


def data_axis(mesh):
    """The mesh a train step shards over, or None for one process. A
    single process with several devices does not train: the card idiom is
    one process per card."""
    if mesh is None:
        return None
    if mesh.group is None:
        if mesh.size > 1:
            raise ValueError(
                f"a train step over {mesh.size} devices of one process: "
                "launch one process per card instead (torchrun "
                f"--nproc-per-node {mesh.size}, or the BSCAN_* variables "
                "of parallel/distributed.py)")
        return None
    return mesh


def _global_rows(mesh, b: int):
    """(global batch size, this process's rows of it) for a local batch
    of b rows."""
    if mesh is None:
        return b, slice(0, b)
    return mesh.size * b, slice(mesh.index * b, (mesh.index + 1) * b)


def step_inputs(mesh, batch, step_seed: int, color_jitter: bool) -> dict:
    """What the host decides for one step, as tensors on the batch's
    device: {"seed": the 0-d step seed, "aug": this process's rows of the
    augmentation draw (`draws_to_device`), or None}. The draw is made for
    the global batch and sliced. A step's device body reads only these,
    so a CUDA graph of the body replays any step once they are copied into
    its buffers."""
    labels = batch["labels"]
    total, mine = _global_rows(mesh, labels.shape[0])
    aug = draw_batch_aug(batch, step_seed, color_jitter, rows=(total, mine))
    return {"seed": step_seed_tensor(step_seed, labels.device),
            "aug": draws_to_device(aug, labels.device)}


def _row_seeds(mesh, batch, seed):
    """This process's rows of the global batch's row seeds, from the 0-d
    step seed tensor `seed`."""
    labels = batch["labels"]
    total, mine = _global_rows(mesh, labels.shape[0])
    return batch_rows(tower_row_seeds(seed, total, labels.device), mine)


def _eager_step(check, mesh, color_jitter, body):
    """train_step(state, batch, step_seed) -> (state, loss): the prelude
    (the learning rate into the optimizer, `step_inputs`), then `body`
    (state, batch, inputs) -> loss, the device work from the forward to
    AdamW, then the step count. `train.graphs` captures `body` alone."""
    def prelude(state, batch, step_seed):
        check(state)
        state.set_lr()
        return step_inputs(mesh, batch, step_seed, color_jitter)

    def train_step(state, batch, step_seed):
        loss = body(state, batch, prelude(state, batch, step_seed))
        state.step += 1
        return state, loss

    train_step.prelude = prelude
    train_step.body = body
    train_step.world = 1 if mesh is None else mesh.size
    return train_step


def _sum_gradients(model, mesh, skip=("logit_scale",)):
    """Sum the trainable gradients over the processes; `skip`: parameters
    whose gradient every process already holds whole (the learnable logit
    scale sees the full loss on every process)."""
    if mesh is None:
        return
    all_reduce_sum([p.grad for n, p in model.named_parameters()
                    if p.grad is not None and n not in skip], mesh)


def embed_train(model, batch: dict, seeds: dict, aug, *,
                openclip_norm: bool = False, color_jitter: bool = False,
                remat: bool = False, image=None, skip=()):
    """Train-mode embeddings of one (micro)batch -> ({modality: (b, D) or
    None}, the augmented images). `seeds` and `aug` are the rows' own
    (`tower_row_seeds`, `draw_batch_aug`); `image`: augmented images to use
    as they are; `skip`: towers to leave out; `remat`: each tower under
    `torch.utils.checkpoint` (JAX's `jax.checkpoint` per tower)."""
    def call(fn, *a, **kw):
        if remat and torch.is_grad_enabled():
            return checkpoint(fn, *a, use_reentrant=False,
                              preserve_rng_state=False, **kw)
        return fn(*a, **kw)

    embs = {}
    if model.image_encoder is not None and "image" not in skip:
        if image is None:
            image = batch.get("image")
            if image is None and "image_u8" in batch:
                image = train_transform_auto(
                    batch["image_u8"], aug, normalize=openclip_norm,
                    jitter=color_jitter)
        embs["image"] = (None if image is None
                         else call(model.encode_image, image))
    if model.dna_encoder is not None and "dna" not in skip:
        dna = batch.get("dna")
        embs["dna"] = (None if dna is None else call(
            model.encode_dna, dna, row_seeds=seeds["dna"]))
    if model.language_encoder is not None and "language" not in skip:
        lang = batch.get("language")
        embs["language"] = (None if lang is None else call(
            model.encode_language, lang, row_seeds=seeds["language"]))
    return embs, image


def _state_check(model, disable_lora: bool):
    """check(state): the state must hold `model` with the trainable set of
    `disable_lora` (its labels compared once per state)."""
    checked = []  # the labels of the state last checked

    def check(state):
        if state.model is not model:
            raise ValueError("train_step: the state holds another model")
        if checked and state.labels is checked[0]:
            return
        if state.labels != param_labels(model, disable_lora):
            raise ValueError(
                f"train_step: built with disable_lora={disable_lora}, but "
                "the state's trainable set is another (create_train_state)")
        checked[:] = [state.labels]

    return check


def make_train_step(model, logit_scale: float = LOGIT_SCALE,
                    openclip_norm: bool = False, remat: bool = False,
                    disable_lora: bool = False, color_jitter: bool = False,
                    mesh=None):
    """train_step(state, batch, step_seed) -> (state, loss) for `model`
    (the model of `state`): forward in train mode, loss, backward over the
    trainable set, AdamW. `batch` is a device batch (`device_batch`); the
    returned loss is a device scalar (no host sync). uint8 frames get the
    train augmentation on the device, its parameters drawn from the step
    seed (`color_jitter`: ColorJitter last, as INSECT training has it).
    `openclip_norm`: the train images take CLIP's mean and std, as the
    OpenCLIP ablation's do (JAX loop.py:104-107). `remat`: each tower
    under `torch.utils.checkpoint` (JAX loop.py:73-78). `disable_lora`
    must match the state's trainable set. `mesh`: the processes' data axis
    (`batch` is then this process's rows; the embeddings are gathered, so
    the loss is the global batch's). `train_step.loss_fn` (batch,
    step_seed) is the loss alone, for a caller that differentiates it
    itself."""
    check = _state_check(model, disable_lora)
    mesh = data_axis(mesh)

    def loss_of(batch, inputs):
        labels = batch["labels"]
        embs, _ = embed_train(
            model, batch, _row_seeds(mesh, batch, inputs["seed"]),
            inputs["aug"], openclip_norm=openclip_norm,
            color_jitter=color_jitter, remat=remat)
        if mesh is not None:
            embs = {k: None if v is None else gather_rows_grad(v, mesh)
                    for k, v in embs.items()}
            labels = gather_rows(labels, mesh)
        return multimodal_contrastive_loss(
            embs, labels, logit_scale_value(model, logit_scale))

    def loss_fn(batch, step_seed):
        return loss_of(batch, step_inputs(mesh, batch, step_seed,
                                          color_jitter))

    def body(state, batch, inputs):
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_of(batch, inputs)
        loss.backward()
        _sum_gradients(model, mesh)
        state.optimizer.step()
        return loss.detach()

    train_step = _eager_step(check, mesh, color_jitter, body)
    train_step.loss_fn = loss_fn
    return train_step


def _row_slices(total: int, size: int, what: str):
    """The row slices of a batch of `total` cut into parts of `size`."""
    if size < 1 or total % size:
        raise ValueError(f"{what} must divide the global batch {total} "
                         f"into equal parts (parts of {size} rows)")
    return [slice(i, i + size) for i in range(0, total, size)]


def _micro_rows(total: int, accum_steps: int):
    if accum_steps < 1 or total % accum_steps:
        raise ValueError(f"accum_steps={accum_steps} must divide the "
                         f"global batch {total}")
    return _row_slices(total, total // accum_steps, "accum_steps")


class Microbatch(NamedTuple):
    """One microbatch of a step over the processes: `rows`, this process's
    rows of it (a slice of its own batch; None when it holds none);
    `global_rows`, its rows of the global batch; `counts`, the rows each
    process holds of it, in rank order."""

    rows: Optional[slice]
    global_rows: slice
    counts: Tuple[int, ...]

    @property
    def holders(self) -> Tuple[int, ...]:
        return tuple(r for r, c in enumerate(self.counts) if c)

    @property
    def spans(self) -> bool:
        return len(self.holders) > 1


def micro_layout(world: int, rank: int, b: int, accum_steps: int):
    """The `accum_steps` microbatches of a global batch of world * b rows
    in rank order, process r holding global rows [r * b, (r + 1) * b), as
    process `rank` sees them: microbatch j is global rows [j * m,
    (j + 1) * m), m = world * b / accum_steps (JAX loop.py:292-296).
    Raises when accum_steps does not divide the global batch."""
    out = []
    for g in _micro_rows(world * b, accum_steps):
        counts = tuple(max(0, min(g.stop, (r + 1) * b) - max(g.start, r * b))
                       for r in range(world))
        first = max(g.start - rank * b, 0)
        out.append(Microbatch(
            slice(first, first + counts[rank]) if counts[rank] else None,
            g, counts))
    return out


def _gather_micro(embs: dict, mesh, counts):
    """A spanning microbatch's embeddings gathered over the processes in
    one padded all_gather, the towers side by side; differentiable in this
    process's rows."""
    names = [k for k, v in embs.items() if v is not None]
    full = gather_rows_grad(torch.cat([embs[k] for k in names], dim=1),
                            mesh, counts)
    parts = full.split([embs[k].shape[1] for k in names], dim=1)
    return {**embs, **dict(zip(names, parts))}


def make_accum_train_step(model, accum_steps: int,
                          logit_scale: float = LOGIT_SCALE,
                          openclip_norm: bool = False, remat: bool = False,
                          disable_lora: bool = False,
                          color_jitter: bool = False, mesh=None):
    """Gradient accumulation (JAX loop.py:273-384, `tpu.accum_mode:
    micro`): the batch is cut into `accum_steps` microbatches, each takes
    its own loss (InfoNCE negatives from the microbatch only, the
    reference's per-rank ContrastiveLoss) and backward, the gradients are
    averaged, and one AdamW update follows. Each row keeps its global
    row seeds and augmentation, so `accum_steps=1` is the plain step.
    Returns the mean of the microbatch losses.

    Over `mesh`, microbatch j is global rows [j * B / n, (j + 1) * B / n)
    of the global batch of B rows (JAX loop.py:292-296), for any n that
    divides B; `micro_layout` gives each process its rows of each. A
    microbatch on one process runs there with no exchange. One that spans
    processes: each holder embeds its rows, every process joins one
    padded gather of them (a process that holds none sends no rows; the
    gathers go in microbatch order, the same on every process), and every
    holder takes the loss over the gathered rows, its backward keeping
    this process's rows of the gradient. That loss and the learnable
    logit scale's gradient count once: the lowest-ranked holder keeps
    them, the others detach the scale. The gradients and losses are then
    summed over the processes. With n a multiple of the processes nothing
    spans, and the step makes no gather."""
    check = _state_check(model, disable_lora)
    mesh = data_axis(mesh)
    world = 1 if mesh is None else mesh.size
    rank = 0 if mesh is None else mesh.index

    def train_step(state, batch, step_seed):
        check(state)
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        labels = batch["labels"]
        layout = micro_layout(world, rank, labels.shape[0], accum_steps)
        inputs = step_inputs(mesh, batch, step_seed, color_jitter)
        seeds, aug = _row_seeds(mesh, batch, inputs["seed"]), inputs["aug"]
        spans = any(mb.spans for mb in layout)
        if spans:
            global_labels = gather_rows(labels, mesh)
        mine = [j for j, mb in enumerate(layout) if mb.rows is not None]
        total = torch.zeros((), device=labels.device)
        # no rows at this process's embeddings' width: its part of the
        # gathers of the spanning microbatches it holds no rows of
        blank = None
        for j in mine:
            mb = layout[j]
            embs, _ = embed_train(
                model, batch_rows(batch, mb.rows), batch_rows(seeds, mb.rows),
                aug_rows(aug, mb.rows),
                openclip_norm=openclip_norm, color_jitter=color_jitter,
                remat=remat)
            scale = logit_scale_value(model, logit_scale)
            keeps = rank == mb.holders[0]
            mb_labels = labels[mb.rows]
            if spans and blank is None:
                blank = torch.cat([v.detach()[:0] for v in embs.values()
                                   if v is not None], dim=1)
                for other in layout[:j]:  # before this process's rows
                    if other.spans:
                        gather_rows(blank, mesh, other.counts)
            if mb.spans:
                embs = _gather_micro(embs, mesh, mb.counts)
                mb_labels = global_labels[mb.global_rows]
                if not keeps and torch.is_tensor(scale):
                    scale = scale.detach()
            loss = multimodal_contrastive_loss(
                embs, mb_labels, scale) / accum_steps
            loss.backward()
            if keeps:
                total = total + loss.detach()
        for other in layout[mine[-1] + 1:]:
            if other.spans:
                gather_rows(blank, mesh, other.counts)
        if mesh is not None:
            scale_p = getattr(model, "logit_scale", None)
            if (isinstance(scale_p, torch.Tensor) and scale_p.requires_grad
                    and scale_p.grad is None):
                # it kept no microbatch's loss: a zero gradient, so that
                # every process sums the same tensors
                scale_p.grad = torch.zeros_like(scale_p)
            _sum_gradients(model, mesh, skip=())
            all_reduce_sum([total], mesh)
        state.apply_gradients()
        return state, total

    train_step.world = world
    return train_step


def make_gradcache_train_step(model, accum_steps: int,
                              logit_scale: float = LOGIT_SCALE,
                              openclip_norm: bool = False,
                              disable_lora: bool = False,
                              color_jitter: bool = False,
                              steps_per_call: int = 1,
                              same_batch: bool = False, merged_model=None,
                              s1_image_batch: int = 0,
                              cache_aug: bool = False, s1_chunk: int = 0,
                              mesh=None):
    """Accumulation with full-batch InfoNCE negatives (GradCache, Gao et
    al. 2021; JAX loop.py:387-780), the reference's batch-400 ClipLoss
    semantics at a microbatch's activation memory:
      1. embed every row without gradients, caching the (B, D) embeddings;
      2. one loss over the full batch, its gradient with respect to the
         cached embeddings (and to a learnable logit scale, whose gradient
         flows through this stage only);
      3. each microbatch again with gradients, pulling its rows of the
         stage-2 gradient back with `torch.autograd.backward`; the
         gradients accumulate, then one AdamW update.
    Every row's dropout masks and augmentation follow the step seed and its
    global row (`tower_row_seeds`, `draw_batch_aug`), however rows are
    grouped, so stage 3 recomputes stage 1's embeddings up to the rounding
    of another grouping, and the gradient is the full-batch step's.

    Stage 1 runs in chunks: `s1_chunk` rows for every tower, else
    `s1_image_batch` rows for the image tower, else one microbatch. It runs
    on `merged_model` when given: the same architecture at LoRA rank 0
    (`load_clip_model(..., lora_rank=0)`, or built on the meta device),
    which `models/lora.share_merged` binds to `model`'s tensors; only its
    folded projections are recomputed, once a step. `cache_aug`: stage 3
    takes stage 1's augmented images instead of transforming again (the
    same pixels). `steps_per_call` K > 1: K GradCache steps per call
    (JAX loop.py:755-778), `scan_train_steps` over this step; `same_batch`
    as in `make_scan_train_step`.

    Over `mesh`, stage 1 embeds this process's rows and the cached
    embeddings are gathered without gradients; stage 2 takes the global
    loss's gradient and each process keeps its rows of it; stage 3 runs
    locally, in microbatches of B / `accum_steps` rows (at most the
    process's); the adapters' gradients are then summed over the
    processes. The logit scale's stage-2 gradient is whole on every
    process. Chunk sizes count this process's rows."""
    if disable_lora:
        merged_model = None  # no adapters to fold
    check = _state_check(model, disable_lora)
    mesh = data_axis(mesh)
    refresh = None
    if merged_model is not None:
        refresh = share_merged(merged_model, model)

    towers = ("image", "dna", "language")

    def stage1(s1_model, batch, seeds, aug, b, mb):
        """Every tower's embeddings of every row, without gradients, in
        chunks; and the augmented images when `cache_aug`."""
        if s1_chunk:
            sizes = dict.fromkeys(towers, (s1_chunk, "s1_chunk"))
        else:
            sizes = dict.fromkeys(towers, (mb, "accum_steps"))
            if s1_image_batch:
                sizes["image"] = (s1_image_batch, "s1_image_batch")
        cached, images = {}, []
        for name in towers:
            size, what = sizes[name]
            size = min(size, b)
            parts = []
            for rows in _row_slices(b, size, f"{what}={size}"):
                embs, image = embed_train(
                    s1_model, batch_rows(batch, rows),
                    batch_rows(seeds, rows),
                    aug_rows(aug, rows),
                    openclip_norm=openclip_norm, color_jitter=color_jitter,
                    skip=tuple(t for t in towers if t != name))
                parts.append(embs.get(name))
                if name == "image" and cache_aug and image is not None:
                    images.append(image)
            if parts[0] is not None:
                cached[name] = torch.cat(parts)
        return cached, (torch.cat(images) if images else None)

    def body(state, batch, inputs):
        labels = batch["labels"]
        b = labels.shape[0]
        total, mine = _global_rows(mesh, b)
        mb = min(_micro_rows(total, accum_steps)[0].stop, b)
        micro = _row_slices(b, mb, f"accum_steps={accum_steps}")
        seeds, aug = _row_seeds(mesh, batch, inputs["seed"]), inputs["aug"]
        s1_model = model if merged_model is None else merged_model
        s1_model.train()
        with torch.no_grad():
            if refresh is not None:
                refresh()
            cached, images = stage1(s1_model, batch, seeds, aug, b, mb)
            if mesh is not None:
                cached = {k: gather_rows(v, mesh) for k, v in cached.items()}
                labels = gather_rows(labels, mesh)
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        full = {k: v.detach().requires_grad_() for k, v in cached.items()}
        loss = multimodal_contrastive_loss(
            {**{k: None for k in towers
                if getattr(model, f"{k}_encoder") is not None}, **full},
            labels, logit_scale_value(model, logit_scale))
        loss.backward()
        grads = {k: v.grad[mine] for k, v in full.items()}
        for rows in micro:
            embs, _ = embed_train(
                model, batch_rows(batch, rows), batch_rows(seeds, rows),
                aug_rows(aug, rows),
                openclip_norm=openclip_norm, color_jitter=color_jitter,
                image=None if images is None else images[rows])
            names = [k for k in full if embs.get(k) is not None]
            torch.autograd.backward([embs[k] for k in names],
                                    [grads[k][rows] for k in names])
        _sum_gradients(model, mesh)
        state.optimizer.step()
        return loss.detach()

    train_step = _eager_step(check, mesh, color_jitter, body)
    if steps_per_call > 1:
        return scan_train_steps(train_step, steps_per_call,
                                same_batch=same_batch,
                                modules=(model, merged_model))
    return train_step


def make_scan_train_step(model, steps_per_call: int,
                         logit_scale: float = LOGIT_SCALE,
                         openclip_norm: bool = False, remat: bool = False,
                         disable_lora: bool = False,
                         color_jitter: bool = False, same_batch: bool = False,
                         mesh=None):
    """K = `steps_per_call` full train steps per call (JAX loop.py:150-257,
    where `lax.scan` runs them in one dispatch): scan_step(state, batches,
    step_seeds) -> (state, (K,) device losses). Each step is one
    `make_train_step` step (forward, backward, AdamW) on its own batch with
    its own step seed, so the call equals K calls of that step; `batches`
    has a leading (K, ...) axis (`stack_batches` of K loader batches, on
    the device). `same_batch`: `batches` is ONE batch that every step takes
    (synthetic runs; the seeds still differ). On a card every step after
    the first is the replay of a CUDA graph of the step (`train.graphs`);
    on the CPU the steps run eagerly, which is the plain version."""
    step = make_train_step(model, logit_scale=logit_scale,
                           openclip_norm=openclip_norm, remat=remat,
                           disable_lora=disable_lora,
                           color_jitter=color_jitter, mesh=mesh)
    return scan_train_steps(step, steps_per_call, same_batch=same_batch,
                            modules=(model,))


def scan_train_steps(train_step, steps_per_call: int,
                     same_batch: bool = False, modules=()):
    """scan_step(state, batches, step_seeds) -> (state, losses): K steps of
    `train_step` (a `make_train_step` or `make_gradcache_train_step` step)
    per call; see `make_scan_train_step`. A call may run fewer than
    `steps_per_call` steps (the epoch's shorter last chunk): the graph is
    one step's, so no other capture is needed. `modules`: the modules whose
    tensors the step reads (the model, GradCache's merged stage-1 model),
    watched for replacement by `train.graphs`."""
    from bioscan_clip_tpu_torch.train.graphs import StepGraphs

    if steps_per_call < 1:
        raise ValueError(f"steps_per_call={steps_per_call} must be >= 1")
    graphs = StepGraphs(train_step,
                        [m for m in modules if m is not None])

    def scan_step(state, batches, step_seeds):
        seeds = [int(s) for s in step_seeds]
        if not 1 <= len(seeds) <= steps_per_call:
            raise ValueError(f"{len(seeds)} step seeds for a call of at "
                             f"most {steps_per_call} steps")
        stacked = batches["labels"].shape[0]
        if not same_batch and stacked != len(seeds):
            raise ValueError(f"{stacked} stacked batches for {len(seeds)} "
                             "steps")
        return graphs.run(state, [
            batches if same_batch else batch_rows(batches, k)
            for k in range(len(seeds))], seeds)

    scan_step.graphs = graphs
    scan_step.steps_per_call = steps_per_call
    scan_step.world = train_step.world
    return scan_step


def stack_batches(batches):
    """Stack K loader batch dicts into one with a leading (K, ...) axis
    (the input of a scan step), on the host: the result crosses to the
    device as one copy per leaf (JAX loop.py:260-270). Host-only keys
    (label dicts, ids) are left out."""
    def stack(parts):
        if isinstance(parts[0], dict):
            return {k: stack([p[k] for p in parts]) for k in parts[0]}
        return np.stack([np.asarray(p) for p in parts])

    return {k: stack([b[k] for b in batches]) for k in DEVICE_BATCH_KEYS
            if k in batches[0]}


def train_epoch(state, train_step, dataloader, generator: torch.Generator,
                epoch: int, total_epochs: int, log_every: int = 20,
                logger=None, wandb_run=None, profile_dir=None,
                profile_steps: int = 5, steps_per_call: int = 1,
                scan_step_factory=None):
    """One epoch over a host dataloader yielding batch dicts: a step per
    batch, its uint32 step seed drawn from `generator` (`state.generator`
    for a run that checkpoints; every process of a mesh draws the same
    seeds from its copy). `wandb_run` gets `loss`, `epoch` and `step` every
    step (JAX loop.py:1135-1136). Samples count the global batch of a
    step over several processes (`train_step.world`).

    Each step's loss is fetched one step late (after the next step is
    enqueued), so the host does not stall the card. `samples_per_s_steady`
    starts at the first fetch, once the card has done what was enqueued
    by then, leaving out the first step's (or call's) warm-up.
    `profile_dir`: a `torch.profiler` Chrome trace of the first
    `profile_steps` steps, written to `profile_dir/trace.json`.

    `steps_per_call` K > 1 with `scan_step_factory` (k -> a scan step,
    `make_scan_train_step` or `make_gradcache_train_step(steps_per_call=
    k)`): K loader batches are stacked and run by one call (JAX loop.py:
    1138-1184), the seeds drawn in the same order as one step at a time,
    so the epoch equals the one-step epoch. The losses of a call are
    fetched after the next call is enqueued; the epoch's shorter last
    chunk runs on the same scan step; the profiler traces the first
    call."""
    cuda = state.device.type == "cuda"
    world = getattr(train_step, "world", 1)
    losses = []
    t_start = time.perf_counter()
    n_samples = 0
    steady = None  # (time, samples seen) at the first loss fetch
    pending = None  # (first step index, (k,) device losses, samples seen)
    prof = None

    def record(idx, loss_v, n_seen):
        losses.append(loss_v)
        if logger is not None and (idx % log_every == 0 or idx < 3):
            logger(f"epoch {epoch}/{total_epochs} step {idx} "
                   f"loss {loss_v:.4f} "
                   f"({n_seen / (time.perf_counter() - t_start):.1f} "
                   "samples/s)")
        if wandb_run is not None:
            wandb_run.log({"loss": loss_v, "epoch": epoch, "step": idx})

    def flush():
        nonlocal pending, steady
        if pending is not None:
            base, dev_losses, n_seen = pending
            pending = None
            if steady is None:  # after the first step or call, warm-up
                if cuda:  # included: what was enqueued is done
                    torch.cuda.synchronize(state.device)
                steady = (time.perf_counter(), n_samples)
            for j, v in enumerate(dev_losses.reshape(-1).tolist()):
                record(base + j, v, n_seen)

    def start_trace():
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        trace = torch.profiler.profile(activities=activities)
        trace.start()
        return trace

    def stop_trace(what):
        prof.stop()  # synchronizes the card
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        if logger is not None:
            logger(f"profiler trace ({what}) -> {profile_dir}")

    if steps_per_call > 1 and scan_step_factory is not None:
        scan_step = scan_step_factory(steps_per_call)
        chunk, base = [], 0

        def run_chunk(chunk, base):
            nonlocal state, n_samples, pending
            stacked = device_batch(stack_batches(chunk), state.device)
            n_samples += int(stacked["labels"].shape[1]) * world * len(chunk)
            seeds = [draw_step_seed(generator) for _ in chunk]
            state, dev_losses = scan_step(state, stacked, seeds)
            flush()
            pending = (base, dev_losses, n_samples)

        for batch in dataloader:
            chunk.append(batch)
            if len(chunk) == steps_per_call:
                if profile_dir and base == 0:
                    prof = start_trace()
                run_chunk(chunk, base)
                if prof is not None:
                    stop_trace(f"first {steps_per_call}-step call")
                    prof = None
                base += len(chunk)
                chunk = []
        if chunk:
            run_chunk(chunk, base)
        flush()
    else:
        for i, batch in enumerate(dataloader):
            if profile_dir and i == 0:
                prof = start_trace()
            batch = device_batch(batch, state.device)
            n_samples += int(batch["labels"].shape[0]) * world
            state, loss = train_step(state, batch, draw_step_seed(generator))
            flush()
            pending = (i, loss, n_samples)
            if prof is not None and i + 1 >= profile_steps:
                stop_trace(f"{profile_steps} steps")
                prof = None
        flush()
        if prof is not None:  # fewer batches than profile_steps
            stop_trace(f"{profile_steps} steps")
    if cuda:
        torch.cuda.synchronize(state.device)
    dur = time.perf_counter() - t_start
    stats = {
        "epoch_time_s": dur,
        "samples_per_s": n_samples / dur if dur > 0 else 0.0,
        "mean_loss": (sum(losses) / len(losses)) if losses else math.nan,
        "losses": losses,
    }
    if steady is not None and n_samples > steady[1]:
        sdur = time.perf_counter() - steady[0]
        stats["samples_per_s_steady"] = (
            (n_samples - steady[1]) / sdur if sdur > 0 else 0.0)
    return state, stats


def _tower(model, modality: str):
    return getattr(model, f"{modality}_encoder")


def _modality_input(batch: dict, modality: str):
    if modality == "image":
        return batch.get("image_u8", batch.get("image"))
    return batch.get(modality)


def _to_device(x, device):
    """A loader array (or dict of arrays) as tensors on `device`; integer
    token arrays as int64, as the serving path feeds them."""
    if isinstance(x, dict):
        return {k: _to_device(v, device) for k, v in x.items()}
    a = np.ascontiguousarray(x)
    if a.dtype.kind in "iu" and a.dtype != np.uint8:
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(device, non_blocking=True)


def _rows(x) -> int:
    return (next(iter(x.values())) if isinstance(x, dict) else x).shape[0]


def make_embed_step(model, modality: str, openclip_norm: bool = False,
                    pre_cropped: bool = False):
    """embed(inputs) -> normalized (B, D) fp32 embeddings of one modality
    (the hot loop of the reference's get_feature_and_label,
    inference_epoch.py:8-68). A uint8 image batch gets the deterministic
    eval transform on its device first; `pre_cropped` for loaders that ship
    host-center-cropped (224, 224) frames."""
    method = {
        "image": model.encode_image,
        "dna": model.encode_dna,
        "language": model.encode_language,
    }[modality]

    def embed(inputs):
        if modality == "image" and inputs.dtype == torch.uint8:
            inputs = eval_transform(inputs, normalize=openclip_norm,
                                    pre_cropped=pre_cropped)
        return method(inputs)

    return embed


def extract_features(model, dataloader,
                     modalities=("language", "dna", "image"),
                     for_key_set: bool = False, openclip_norm: bool = False,
                     progress=None, group_samples=None,
                     pending_batches: int = 4):
    """Full-split feature extraction on the model's device -> split dict
    (the reference's get_features_and_label, inference_and_eval.py:734-783:
    one pass per modality over the loader, L2-normalized outputs, label
    dicts and ids collected on the host).

    `group_samples`: merge loader batches until about this many rows are
    buffered and run every tower once over the group (None: 1600 on the
    card, 0 = off on the CPU). `pending_batches`: results stay on the
    device for this many batches before they are fetched, so the host's
    decode and upload of the next batch overlap the towers."""
    from bioscan_clip_tpu_torch.retrieval.report import build_split_dict

    device = next(model.parameters()).device
    if group_samples is None:
        group_samples = 1600 if device.type == "cuda" else 0
    model.eval()
    avail = [m for m in modalities if _tower(model, m) is not None]
    pre_cropped = bool(getattr(dataloader, "eval_pre_cropped", False))
    feats = {m: [] for m in avail}
    label_dicts, ids = [], []
    pending = collections.deque()  # (modality, device embeddings)

    def drain(limit):
        while len(pending) > limit:
            m, emb = pending.popleft()
            feats[m].append(emb.cpu().numpy())

    with torch.inference_mode():
        if group_samples and int(group_samples) > 0:
            _extract_grouped(model, dataloader, avail, openclip_norm,
                             pre_cropped, progress, int(group_samples),
                             device, label_dicts, ids, pending, drain)
        else:
            steps = {
                m: make_embed_step(model, m, openclip_norm=openclip_norm,
                                   pre_cropped=m == "image" and pre_cropped)
                for m in avail
            }
            window = pending_batches * len(steps)
            t0 = time.perf_counter()
            for bi, batch in enumerate(dataloader):
                if progress is not None:
                    progress(bi, time.perf_counter() - t0)
                label_dicts.extend(batch.get("label_dicts", []))
                ids.extend(batch.get("ids", []))
                for m, step in steps.items():
                    inp = _modality_input(batch, m)
                    if inp is not None:
                        pending.append((m, step(_to_device(inp, device))))
                drain(window)
        drain(0)
    arrays = {m: (np.concatenate(v, axis=0) if v else None)
              for m, v in feats.items()}
    return build_split_dict(
        image=arrays.get("image"),
        dna=arrays.get("dna"),
        language=arrays.get("language"),
        label_list=label_dicts,
        file_name_list=ids,
        for_key_set=for_key_set,
    )


def _extract_grouped(model, dataloader, avail, openclip_norm, pre_cropped,
                     progress, group_samples, device, label_dicts, ids,
                     pending, drain, pending_groups: int = 2):
    """Grouped extraction (JAX `_extract_features_grouped`): K loader
    batches merge into one group of at least `group_samples` rows, and each
    tower runs once per group. The eval towers are deterministic, so only
    the products' blocking differs from the per-batch path. Unlike JAX,
    the last partial group is not padded: eager PyTorch needs no fixed
    shape."""
    steps = {m: make_embed_step(model, m, openclip_norm=openclip_norm,
                                pre_cropped=m == "image" and pre_cropped)
             for m in avail}
    buf, rows, capacity = [], 0, None

    def flush():
        nonlocal buf, rows
        if not buf:
            return
        for m in steps:
            parts = [d[m] for d in buf if m in d]
            if not parts:
                continue
            if isinstance(parts[0], dict):
                group = {k: np.concatenate([p[k] for p in parts])
                         for k in parts[0]}
            else:
                group = np.concatenate(parts)
            pending.append((m, steps[m](_to_device(group, device))))
        buf, rows = [], 0
        drain(pending_groups * len(steps))

    t0 = time.perf_counter()
    for bi, batch in enumerate(dataloader):
        if progress is not None and not buf:
            progress(bi, time.perf_counter() - t0)
        label_dicts.extend(batch.get("label_dicts", []))
        ids.extend(batch.get("ids", []))
        d = {m: x for m in avail
             if (x := _modality_input(batch, m)) is not None}
        if not d:
            continue
        b = _rows(next(iter(d.values())))
        if capacity is None:
            capacity = max(1, -(-group_samples // b)) * b
        buf.append(d)
        rows += b
        if rows >= capacity:
            flush()
    flush()
