"""Contrastive pretraining CLI on the card: the reference's
scripts/train_cl.py.

A port of bioscan_clip_tpu/cli/train_cl.py:

    python -m bioscan_clip_tpu_torch.cli.train_cl 'model_config=NAME' \\
        [key=value ...]

`device` (top-level key, default cuda; an error without CUDA) picks where
the model trains; `device=cpu` runs the kernels' plain versions. Flow
(train_cl.py:22-394): the train and eval loaders (`data/dataset.py`), the
model (`models/clip.load_clip_model`, `tpu.remat` / `tpu.remat_policy`),
the checkpoint at `model_config.ckpt_path` or the pretrained towers, the
optional learnable logit scale, frozen weights in bf16 under bf16 compute
(`tpu.frozen_dtype`), the schedule over `epochs` x the epoch's steps
(`tpu.max_steps_per_epoch` bounds them), then the train step:
- `tpu.accum_steps` > 1: GradCache (`tpu.accum_mode: gradcache`, with
  `tpu.gradcache_merged` (default on), `gc_s1_image_batch`, `gc_s1_chunk`
  and `gc_cache_aug`) or per-microbatch accumulation (`micro`, at any
  `accum_steps` that divides the global batch; over several processes a
  microbatch may span them);
- else the plain step.
`tpu.steps_per_call` K > 1 runs K steps per call, the plain or GradCache
step (`train.loop.make_scan_train_step`, `make_gradcache_train_step(
steps_per_call=K)`): on the card the first step warms up, the second is
captured as a CUDA graph and every later step replays it (`train.graphs`);
the losses, checkpoints and resume are those of one step per call. With
`accum_mode: micro` it runs one step per call, as in JAX.
`resume=<run folder>` restores its `last` checkpoint and continues at the
next epoch boundary. Every `evaluation_period` epochs, and always at the
last, `last` is saved (in the background) and the eval phase runs:
features of all_keys, seen and unseen, then the 5 x 6 sweep; the mean of
the seen and unseen image->image top-1 species micro accuracy selects
`best`. The run folder (<project_root_path>/<model_output_dir>/
<model_output_name>/<stamp>) also holds `config.yaml`.

`tpu.fast_ln`: the towers' LayerNorms compute in bf16
(`load_clip_model(ln_dtype=torch.bfloat16)`, as JAX's `BSCAN_FAST_LN`).

Several cards: one process per card, joined by `parallel/distributed.py`
(`torchrun --nproc-per-node N -m bioscan_clip_tpu_torch.cli.train_cl ...`
with `tpu.distributed=auto`, or the `BSCAN_COORDINATOR` /
`BSCAN_NUM_PROCESSES` / `BSCAN_PROCESS_ID` variables); `tpu.mesh_shape`
({data: N} or {data: -1}) must then name the process count. Each process
loads its process-strided shard of every train batch
(`data/dataset.load_dataloader`), the steps gather the embeddings and sum
the adapters' gradients (`train/loop.py`), and the losses are the same on
every process. Process 0 logs, writes wandb, `config.yaml` and the
checkpoints; every process restores. The eval phase runs on every process
over the full splits on its own card (JAX's process-local eval,
train_cl.py:320-334). One process naming several cards raises.

INSECT mode (`model_config.dataset: INSECT`, JAX train_cl.py:76-89,
:193-238, :336-349): the loaders of `data/insect.py` (the train loader
process-sharded), ColorJitter last in the device train augmentation of
every step kind, and an eval phase whose keys are the train, val,
test-seen and test-unseen splits merged (`retrieval/report.
construct_key_dict`) and whose queries are test seen and unseen.
"""

from __future__ import annotations

import datetime
import itertools
import os
import sys

from bioscan_clip_tpu_torch.data.dataset import load_dataloader
from bioscan_clip_tpu_torch.data.insect import load_insect_dataloader


def _tpu(args, key, default):
    tpu_cfg = getattr(args, "tpu", None)
    return type(default)(tpu_cfg.get(key, default)) if tpu_cfg else default


def ln_dtype_of(args):
    """The towers' LayerNorm dtype: bf16 under `tpu.fast_ln` (JAX
    train_cl.py:61-69 sets `BSCAN_FAST_LN`), else fp32."""
    import torch

    return torch.bfloat16 if _tpu(args, "fast_ln", False) else torch.float32


def steps_per_call_of(args) -> int:
    """`tpu.steps_per_call`, the train steps per call (JAX
    train_cl.py:215-244): with the plain step or GradCache; micro
    accumulation has no scan path and runs one step per call."""
    k = _tpu(args, "steps_per_call", 1)
    if (_tpu(args, "accum_steps", 1) > 1
            and _tpu(args, "accum_mode", "gradcache") == "micro"):
        return 1
    return max(k, 1)


def make_step(args, model, dtype, out=print, mesh=None):
    """The train step `args` asks for (JAX train_cl.py:147-244); `dtype`
    is the model's compute dtype; `mesh` the processes' data axis; INSECT
    mode adds ColorJitter to the train augmentation. With
    `steps_per_call_of(args)` K > 1 it is a scan step of K steps per call
    (`train.loop.make_scan_train_step`, or GradCache's with
    `steps_per_call=K`), CUDA graphs on the card. `accum_mode: micro`
    takes any `accum_steps` that divides the global batch (the processes'
    rows together), a microbatch spanning processes where their count
    does not divide it (`train.loop.make_accum_train_step`)."""
    from bioscan_clip_tpu_torch.models.clip import load_clip_model
    from bioscan_clip_tpu_torch.train.loop import (
        make_accum_train_step,
        make_gradcache_train_step,
        make_scan_train_step,
        make_train_step,
    )

    mc = args.model_config
    common = dict(openclip_norm=bool(getattr(mc, "for_open_clip", False)),
                  disable_lora=bool(getattr(mc, "disable_lora", False)),
                  color_jitter=getattr(mc, "dataset", None) == "INSECT",
                  mesh=mesh)
    accum = _tpu(args, "accum_steps", 1)
    k = steps_per_call_of(args)
    if accum <= 1:
        if k > 1:
            return make_scan_train_step(model, k, **common)
        return make_train_step(model, **common)
    if _tpu(args, "accum_mode", "gradcache") == "micro":
        return make_accum_train_step(model, accum, **common)
    merged = None
    if _tpu(args, "gradcache_merged", True) and not common["disable_lora"]:
        # the rank-0 towers; the step binds them to the model's tensors
        # (models/lora.share_merged), so their own weights are dropped
        merged = load_clip_model(args, device=next(model.parameters()).device,
                                 dtype=dtype, lora_rank=0,
                                 ln_dtype=ln_dtype_of(args))
        out("GradCache stage 1 on the merged (rank-0) towers")
    return make_gradcache_train_step(
        model, accum, **common, steps_per_call=k, merged_model=merged,
        s1_image_batch=_tpu(args, "gc_s1_image_batch", 0),
        cache_aug=_tpu(args, "gc_cache_aug", False),
        s1_chunk=_tpu(args, "gc_s1_chunk", 0))


def selection_metric(acc_dict) -> float:
    """The mean of the seen and unseen image->image top-1 species micro
    accuracy (reference train_cl.py:231), 0 without image features."""
    try:
        e = acc_dict["encoded_image_feature"]["encoded_image_feature"]
        return (e["seen"]["micro_acc"][1]["species"]
                + e["unseen"]["micro_acc"][1]["species"]) / 2
    except KeyError:
        return 0.0


def train_mesh(args, dev, out=print):
    """(rank, world, mesh, device) of this process: the process group the
    config or the environment asks for, and its data axis (None for one
    process). One process naming several devices raises."""
    import torch.distributed as dist

    from bioscan_clip_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
        process_device,
    )
    from bioscan_clip_tpu_torch.parallel.mesh import (
        create_mesh,
        mesh_from_config,
    )
    from bioscan_clip_tpu_torch.train.loop import data_axis

    rank, world = maybe_initialize_distributed(args, log=out, device=dev)
    dev = process_device(dev)
    if dist.is_initialized():
        tpu_cfg = getattr(args, "tpu", None)
        shape = tpu_cfg.get("mesh_shape", None) if tpu_cfg else None
        return rank, world, create_mesh(shape, devices=[dev]), dev
    # one process: a mesh of several devices raises (one process per card)
    data_axis(mesh_from_config(args, dev))
    return rank, world, None, dev


def run(args, max_steps_per_epoch=None, out=print, skip_final_eval=False,
        device=None):
    """Train as `args` says; returns (state, best selection metric)."""
    import torch

    from bioscan_clip_tpu_torch.config.core import save_config
    from bioscan_clip_tpu_torch.device import compute_dtype, resolve_device
    from bioscan_clip_tpu_torch.models.clip import load_clip_model
    from bioscan_clip_tpu_torch.parallel.mesh import replicate_module
    from bioscan_clip_tpu_torch.retrieval.report import (
        construct_key_dict,
        inference_and_print_result,
    )
    from bioscan_clip_tpu_torch.train.checkpoint import (
        load_pretrained_towers,
        load_pth_into_params,
        restore_checkpoint,
        save_checkpoint,
        wait_for_checkpoints,
    )
    from bioscan_clip_tpu_torch.train.loop import (
        extract_features,
        make_logit_scale_param,
        train_epoch,
    )
    from bioscan_clip_tpu_torch.train.schedules import build_schedule
    from bioscan_clip_tpu_torch.train.state import (
        cast_frozen_params,
        create_train_state,
    )
    from bioscan_clip_tpu_torch.utils.logging import WandbRun

    mc = args.model_config
    insect_mode = getattr(mc, "dataset", None) == "INSECT"
    dev = resolve_device(device or getattr(args, "device", None) or "cuda")
    rank, world, mesh, dev = train_mesh(args, dev, out=out)
    if rank:
        out = _quiet  # process 0 speaks for the run
    dtype = compute_dtype(dev)
    if args.debug_flag:
        args.activate_wandb = False
        args.save_inference = False
        args.save_ckpt = False
    writer = bool(args.save_ckpt) and rank == 0

    out("Construct dataloader...")
    if insect_mode:
        train_loader, *eval_loaders = load_insect_dataloader(
            args, process_index=rank, process_count=world)
    else:
        train_loader, *eval_loaders = load_dataloader(
            args, process_index=rank, process_count=world)

    out("Initialize model...")
    model = load_clip_model(args, device=dev, dtype=dtype,
                            ln_dtype=ln_dtype_of(args))
    if getattr(mc, "load_ckpt", True):
        ckpt = getattr(mc, "ckpt_path", None)
        if ckpt and os.path.isfile(ckpt):
            load_pth_into_params(ckpt, model)
            out(f"Loaded checkpoint {ckpt}")
        else:
            load_pretrained_towers(args, model, mc.output_dim, log=out)
    if bool(getattr(mc, "learnable_logit_scale", False)):
        make_logit_scale_param(model)
        out("learnable logit scale enabled (init 1/0.07)")
    replicate_module(model, mesh)

    if not max_steps_per_epoch:
        max_steps_per_epoch = _tpu(args, "max_steps_per_epoch", 0) or None
    steps_per_epoch = len(train_loader)
    if max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)
    schedule = build_schedule(mc, steps_per_epoch * mc.epochs)
    disable_lora = bool(getattr(mc, "disable_lora", False))
    if (_tpu(args, "frozen_dtype", "") in ("bfloat16", "bf16")
            and dtype == torch.bfloat16):
        # bit-identical under bf16 compute (the towers cast per use), half
        # the resident frozen weights
        cast_frozen_params(model, disable_lora=disable_lora)
        out("frozen params stored in bfloat16")
    state = create_train_state(model, schedule, disable_lora=disable_lora,
                               seed=42)

    resume_dir = getattr(args, "resume", None)
    start_epoch = 0
    if resume_dir:
        restore_checkpoint(str(resume_dir), state, name="last")
        start_epoch = state.step // max(steps_per_epoch, 1)
        out(f"Resumed from {resume_dir}/last at step {state.step} "
            f"(epoch {start_epoch})")
    train_step = make_step(args, model, dtype, out=out, mesh=mesh)
    steps_per_call = steps_per_call_of(args)
    if steps_per_call > 1:
        out(f"{steps_per_call} train steps per call (CUDA graphs on the "
            "card)")

    wandb_run = WandbRun(
        getattr(mc, "wandb_project_name", "BIOSCAN-CLIP-TPU"),
        getattr(mc, "model_output_name", "run"),
        activate=bool(getattr(args, "activate_wandb", False)) and rank == 0)
    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H%M%S")
    folder = os.path.join(args.project_root_path, args.model_output_dir,
                          mc.model_output_name, stamp)
    if writer:
        os.makedirs(folder, exist_ok=True)
        save_config(args, os.path.join(folder, "config.yaml"))

    eg = _tpu(args, "extract_group", -1)
    best_acc = best_epoch = None
    profile_dir = getattr(args, "profile_dir", None)
    out("training...")
    for epoch in range(start_epoch, mc.epochs):
        if hasattr(train_loader, "set_epoch"):
            # the epoch's shuffle follows the epoch, also after a resume or
            # a bounded epoch
            train_loader.set_epoch(epoch)
        batches = iter(train_loader)
        loader = (itertools.islice(batches, max_steps_per_epoch)
                  if max_steps_per_epoch else batches)
        try:
            state, stats = train_epoch(
                state, train_step, loader, state.generator, epoch,
                mc.epochs, logger=out, wandb_run=wandb_run,
                profile_dir=profile_dir if epoch == start_epoch else None,
                profile_steps=int(getattr(args, "profile_steps", 5)),
                steps_per_call=steps_per_call,
                scan_step_factory=(lambda _: train_step)
                if steps_per_call > 1 else None)
        finally:
            if hasattr(batches, "close"):
                batches.close()  # ends the loader's prefetch thread
        out(f"epoch {epoch}: {stats['samples_per_s']:.1f} samples/s, "
            f"{stats['epoch_time_s']:.1f}s"
            + (f" (steady {stats['samples_per_s_steady']:.1f}/s)"
               if "samples_per_s_steady" in stats else ""))
        out(f"epoch {epoch} losses {stats['losses']}")
        wandb_run.log({"epoch": epoch, "mean_loss": stats["mean_loss"],
                       "samples_per_s": stats["samples_per_s"]})

        eval_now = not skip_final_eval and (
            epoch % mc.evaluation_period == 0 or epoch == mc.epochs - 1)
        if not eval_now:
            continue
        if writer:
            # in the background: the eval phase runs while `last` is written
            save_checkpoint(folder, state, name="last", block=False)
            out(f"Last ckpt: {folder}/last")
        group = None if eg < 0 else eg
        if insect_mode:
            # eval_phase_for_insect (JAX train_cl.py:336-349): the keys are
            # the four splits merged, the queries test seen and unseen
            dicts = [extract_features(model, loader, group_samples=group)
                     for loader in eval_loaders]
            keys_dict = construct_key_dict(dicts)
            seen_dict, unseen_dict = dicts[2], dicts[3]
        else:
            seen_val, unseen_val, all_keys = eval_loaders
            keys_dict = extract_features(model, all_keys, for_key_set=True,
                                         group_samples=group)
            seen_dict = extract_features(model, seen_val,
                                         group_samples=group)
            unseen_dict = extract_features(model, unseen_val,
                                           group_samples=group)
        acc_dict, _, _ = inference_and_print_result(
            keys_dict, seen_dict, unseen_dict, args=args, k_list=[1, 3, 5],
            device=dev, out=out)
        overall = selection_metric(acc_dict)
        if best_acc is None or overall > best_acc:
            best_acc, best_epoch = overall, epoch
            if writer:
                save_checkpoint(folder, state, name="best")
                out(f"Best ckpt: {folder}/best")
        wandb_run.log({"overall_acc": overall, "best_epoch": best_epoch,
                       "epoch": epoch})
    wandb_run.finish()
    wait_for_checkpoints()
    return state, best_acc


def _quiet(*_):
    pass


def main(argv=None):
    from bioscan_clip_tpu_torch.config.core import load_config

    argv = argv if argv is not None else sys.argv[1:]
    return run(load_config(overrides=list(argv)))


if __name__ == "__main__":
    main()
