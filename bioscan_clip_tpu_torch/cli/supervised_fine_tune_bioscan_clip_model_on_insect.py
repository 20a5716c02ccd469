"""Joint image + DNA supervised fine-tune of a BIOSCAN-CLIP model on INSECT,
with the BZSL CSVs of the fine-tuned towers, on the card.

A copy of bioscan_clip_tpu/cli/supervised_fine_tune_bioscan_clip_model_
on_insect.py (the reference's script of that name): the config's model
(`models/clip.load_clip_model`, the checkpoint at `model_config.ckpt_path`
when it is a file), a linear head over the seen species on its image
tower and another on its DNA tower (`models/heads.EncoderWithHead`), every
weight trained by AdamW (`train/fine_tuning.create_fine_tune_state`) with
the two cross-entropies summed (`make_joint_classifier_train_step`) over
the trainval split; every `evaluation_period` epochs and at the last, top-k
accuracy of both classifiers on test_seen and, with `save_ckpt`, the heads
and towers to <project_root_path>/<model_output_dir>/supervised_fine_tune_
bioscan_clip_model_on_insect/<stamp>/joint_last and the BZSL CSVs of every
record (`retrieval/bzsl.export_bzsl_csvs`) to <project_root_path>/
embedding_from_bsc_fine_tuned_on_insect/<stamp>.

    python -m bioscan_clip_tpu_torch.cli.\\
supervised_fine_tune_bioscan_clip_model_on_insect 'model_config=NAME'

`device` (top-level key, default cuda; an error without CUDA);
`tpu.mesh_shape` naming several cards raises.
"""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np

from bioscan_clip_tpu_torch.data.insect import (
    load_insect_dataloader,
    load_insect_dataloader_trainval,
)


def run(args, max_epochs=None, out=print, device=None):
    """Fine-tune, evaluate, export; returns the train state (its model
    the {"image", "dna"} classifiers)."""
    from bioscan_clip_tpu_torch.cli.fine_tune_vitb_on_insect import (
        image_input,
        train_targets,
    )
    from bioscan_clip_tpu_torch.device import compute_dtype, resolve_device
    from bioscan_clip_tpu_torch.models.clip import (
        init_weights,
        load_clip_model,
    )
    from bioscan_clip_tpu_torch.models.heads import EncoderWithHead
    from bioscan_clip_tpu_torch.parallel.mesh import mesh_from_config
    from bioscan_clip_tpu_torch.retrieval.bzsl import (
        export_bzsl_csvs,
        res101_class_labels,
    )
    from bioscan_clip_tpu_torch.train.checkpoint import (
        load_pth_into_params,
        save_params_only,
    )
    from bioscan_clip_tpu_torch.train.fine_tuning import (
        create_fine_tune_state,
        evaluate_classifier,
        get_all_unique_species_from_loader,
        make_joint_classifier_train_step,
    )
    from bioscan_clip_tpu_torch.train.loop import (
        _to_device,
        data_axis,
        draw_step_seed,
        extract_features,
    )

    dev = resolve_device(device or getattr(args, "device", None) or "cuda")
    mc = args.model_config
    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H%M%S")
    dtype = compute_dtype(dev)
    mesh = data_axis(mesh_from_config(args, dev))

    out("Construct dataloaders...")
    (_, train_for_key, _, test_seen_loader,
     _) = load_insect_dataloader(args)
    trainval_loader = load_insect_dataloader_trainval(args)
    all_loader = load_insect_dataloader(args, load_all_in_one=True)
    unique_species = get_all_unique_species_from_loader(train_for_key)
    n_classes = len(unique_species)
    out(f"{n_classes} seen species classes")

    out("Initialize model...")
    clip = load_clip_model(args, device=dev, dtype=dtype)
    ckpt = getattr(mc, "ckpt_path", None)
    if ckpt and os.path.isfile(ckpt):
        load_pth_into_params(ckpt, clip)
        out(f"Loaded {ckpt}")
    heads = []
    for seed, tower in ((1, clip.image_encoder), (2, clip.dna_encoder)):
        clf = EncoderWithHead(tower, mc.output_dim, n_classes, dtype=dtype)
        init_weights(clf.new_linear_layer.to(dev), seed=seed)
        heads.append(clf)
    image_clf, dna_clf = heads
    step = make_joint_classifier_train_step(image_clf, dna_clf, mesh)
    state = create_fine_tune_state(step.model)

    folder = os.path.join(
        args.project_root_path, args.model_output_dir,
        "supervised_fine_tune_bioscan_clip_model_on_insect", stamp)
    epochs = max_epochs or args.general_fine_tune_setting.epoch
    out("training...")
    for epoch in range(epochs):
        losses = []
        for batch in trainval_loader:
            db = {"image": image_input(batch, dev),
                  "dna": _to_device(batch["dna"], dev),
                  "target": train_targets(trainval_loader, batch,
                                          unique_species, dev)}
            state, loss = step(state, db, draw_step_seed(state.generator))
            losses.append(loss)
        out(f"epoch {epoch}: loss "
            f"{np.mean([x.item() for x in losses]):.4f}")

        if epoch % mc.evaluation_period == 0 or epoch == epochs - 1:
            img_acc = evaluate_classifier(image_clf, test_seen_loader,
                                          unique_species, modality="image")
            dna_acc = evaluate_classifier(dna_clf, test_seen_loader,
                                          unique_species, modality="dna")
            out(f"Image Evaluation Result: {img_acc}")
            out(f"DNA Evaluation Result: {dna_acc}")
            if args.save_ckpt:
                save_params_only(folder, step.model, name="joint_last")
                # the fine-tuned towers are the CLIP model's own
                feats = extract_features(clip, all_loader)
                export_bzsl_csvs(
                    os.path.join(args.project_root_path,
                                 "embedding_from_bsc_fine_tuned_on_insect",
                                 stamp),
                    feats["encoded_dna_feature"],
                    feats["encoded_image_feature"],
                    res101_class_labels(args.insect_data.path_to_res_101_mat),
                    out=out)
    return state


def main(argv=None):
    from bioscan_clip_tpu_torch.config.core import load_config

    args = load_config(
        overrides=list(argv if argv is not None else sys.argv[1:]))
    return run(args)


if __name__ == "__main__":
    main()
