"""The contrastive train step, the epoch loop, and feature extraction.

Counterpart of bioscan_clip_tpu/train/loop.py:25-147 (`make_train_step`),
:782-1069 (`make_embed_step`, `extract_features` and the grouped
extraction) and :1072-1241 (`train_epoch`, the plain loop). One step: the
three tower forwards in train mode, the 6-term soft-label InfoNCE, the
backward over the trainable set only (frozen parameters have `requires_grad=False`, so no
frozen-weight gradient is ever formed), then masked AdamW with the
scheduled learning rate.

Dropout is row-keyed: the step takes a uint32 step seed and derives each
BERT tower's (B,) row seeds as the JAX package does (loop.py:565-576:
`row_seeds_init(bits ^ 0x0D5A17, arange(B))` for dna, `bits ^ 0x7A9C33` for
language), so both packages can be handed the same seed. `train_epoch`
draws the step seeds from an explicit `torch.Generator`: pass the state's
own (`state.generator`), which `train.checkpoint` saves and restores, and a
resumed run draws the seeds of an uninterrupted one (JAX derives each
step's key from the step, loop.py:134).

Extraction runs the towers in eval mode under `torch.inference_mode()`; a
uint8 image batch goes through the device eval transform first
(`data/transforms.eval_transform`). Grouped extraction merges loader
batches into groups of about `group_samples` rows and runs every tower
once per group: on the card that is 1600 rows by default (as JAX picks on
the TPU), fewer and larger launches; on the CPU it is off.

Not ported yet, each raising with its ROADMAP.md queue 1 entry: remat,
`steps_per_call > 1` (a TPU dispatch saver; CUDA graphs are the card's
counterpart), the accumulation / GradCache / scan steps.
"""

from __future__ import annotations

import collections
import math
import os
import time

import numpy as np
import torch
from torch import nn

from bioscan_clip_tpu_torch.data.transforms import (
    eval_transform,
    train_transform_auto,
)
from bioscan_clip_tpu_torch.losses.contrastive import (
    multimodal_contrastive_loss,
)
from bioscan_clip_tpu_torch.models.common import row_seeds_init
from bioscan_clip_tpu_torch.ops.attention import u32

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


def tower_row_seeds(step_seed, batch_size: int, device) -> dict:
    """The (B,) row seeds of each BERT tower for one step."""
    rows = torch.arange(batch_size, device=device)
    bits = u32(step_seed)
    return {
        "dna": row_seeds_init(bits ^ DNA_SEED_SALT, rows),
        "language": row_seeds_init(bits ^ LANGUAGE_SEED_SALT, rows),
    }


def make_train_step(model, logit_scale: float = LOGIT_SCALE,
                    openclip_norm: bool = False, remat: bool = False):
    """train_step(state, batch, step_seed) -> (state, loss) for `model`
    (the model of `state`): forward in train mode, loss, backward over the
    trainable set, AdamW. `batch` is a device batch (`device_batch`); the
    returned loss is a device scalar (no host sync). `openclip_norm`: the
    train images take CLIP's mean and std, as the OpenCLIP ablation's do
    (JAX loop.py:104-107). `train_step.loss_fn` (batch, step_seed) is the
    loss alone, for a caller that differentiates it itself."""
    if remat:
        raise NotImplementedError(
            "remat (tpu.remat) is not ported yet: ROADMAP.md queue 1")

    def loss_fn(batch, step_seed):
        labels = batch["labels"]
        seeds = tower_row_seeds(step_seed, labels.shape[0], labels.device)
        image = batch.get("image")
        if image is None and "image_u8" in batch:
            image = batch["image_u8"]
        embs = {}
        if model.image_encoder is not None:
            embs["image"] = (None if image is None else model.encode_image(
                train_transform_auto(image, normalize=openclip_norm)))
        if model.dna_encoder is not None:
            dna = batch.get("dna")
            embs["dna"] = (None if dna is None else model.encode_dna(
                dna, row_seeds=seeds["dna"]))
        if model.language_encoder is not None:
            lang = batch.get("language")
            embs["language"] = (None if lang is None else
                                model.encode_language(
                                    lang, row_seeds=seeds["language"]))
        return multimodal_contrastive_loss(
            embs, labels, logit_scale_value(model, logit_scale))

    def train_step(state, batch, step_seed):
        if state.model is not model:
            raise ValueError("train_step: the state holds another model")
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(batch, step_seed)
        loss.backward()
        state.apply_gradients()
        return state, loss.detach()

    train_step.loss_fn = loss_fn
    return train_step


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md queue 1, item 1")


def make_accum_train_step(*args, **kwargs):
    """Gradient accumulation over microbatches (JAX loop.py:273)."""
    _not_ported("make_accum_train_step")


def make_gradcache_train_step(*args, **kwargs):
    """The GradCache step (JAX loop.py:387)."""
    _not_ported("make_gradcache_train_step")


def make_scan_train_step(*args, **kwargs):
    """K steps in one dispatch (JAX loop.py:150); CUDA graphs on the card."""
    _not_ported("make_scan_train_step")


def train_epoch(state, train_step, dataloader, generator: torch.Generator,
                epoch: int, total_epochs: int, log_every: int = 20,
                logger=None, profile_dir=None, profile_steps: int = 5,
                steps_per_call: int = 1):
    """One epoch over a host dataloader yielding batch dicts: a step per
    batch, its uint32 step seed drawn from `generator` (`state.generator`
    for a run that checkpoints).

    Each step's loss is fetched one step late (after the next step is
    enqueued), so the host does not stall the card. `samples_per_s_steady`
    starts at the first fetch, leaving out the first step's warm-up.
    `profile_dir`: a `torch.profiler` Chrome trace of the first
    `profile_steps` steps, written to `profile_dir/trace.json`."""
    if steps_per_call > 1:
        raise NotImplementedError(
            "steps_per_call > 1 saves TPU dispatches; the card's counterpart "
            "(CUDA graphs) is not ported yet: ROADMAP.md queue 1")
    cuda = state.device.type == "cuda"
    losses = []
    t_start = time.perf_counter()
    n_samples = 0
    steady = None  # (time, samples seen) at the first loss fetch
    pending = None  # (step index, device loss, samples seen up to it)
    prof = None

    def record(idx, loss_dev, n_seen):
        nonlocal steady
        loss_v = float(loss_dev)
        if steady is None:
            steady = (time.perf_counter(), n_seen)
        losses.append(loss_v)
        if logger is not None and (idx % log_every == 0 or idx < 3):
            logger(f"epoch {epoch}/{total_epochs} step {idx} "
                   f"loss {loss_v:.4f} "
                   f"({n_seen / (time.perf_counter() - t_start):.1f} "
                   "samples/s)")

    def stop_trace():
        prof.stop()  # synchronizes the card
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        if logger is not None:
            logger(f"profiler trace -> {profile_dir}")

    for i, batch in enumerate(dataloader):
        if profile_dir and i == 0:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        batch = device_batch(batch, state.device)
        n_samples += int(batch["labels"].shape[0])
        seed = int(torch.randint(0, 2**32, (), generator=generator,
                                 dtype=torch.int64))
        state, loss = train_step(state, batch, seed)
        if pending is not None:
            record(*pending)
        pending = (i, loss, n_samples)
        if prof is not None and i + 1 >= profile_steps:
            stop_trace()
            prof = None
    if pending is not None:
        record(*pending)
    if prof is not None:  # fewer batches than profile_steps
        stop_trace()
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
