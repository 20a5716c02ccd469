"""Full ViT-B/16 supervised fine-tune on INSECT, then the image embedding
CSV for BZSL, on the card.

A copy of bioscan_clip_tpu/cli/fine_tune_vitb_on_insect.py (the
reference's scripts/fine_tune_vitb_on_insect.py, reimplemented working):
a timm-geometry ViT-B/16 without adapters (`lora_rank=0`) under a linear
head over the seen species (`models/heads.EncoderWithHead`), every weight
trained by AdamW (`train/fine_tuning.create_fine_tune_state`) at the
`general_fine_tune_setting` batch size over the trainval split, top-k
accuracy on test_seen every `evaluation_period` epochs and at the last,
then the pre-head features of every record written transposed (dim x
n_samples) to <project_root_path>/embedding_from_vitb_fine_tuned_on_insect/
<stamp>/image_embedding_from_fine_tuned_vit.csv.

    python -m bioscan_clip_tpu_torch.cli.fine_tune_vitb_on_insect \\
        'model_config=NAME'

`device` (top-level key, default cuda; an error without CUDA). The weights
are random and seeded (the JAX CLI initializes them the same way).
`tpu.mesh_shape` naming several cards raises: one process trains on one
card.
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


def build_classifier(mc, n_classes: int, device, dtype):
    """ViT-B/16 (`lora_rank=0`, head to `output_dim`) + a linear head over
    `n_classes`, seeded random weights on `device`."""
    import torch

    from bioscan_clip_tpu_torch.models.clip import init_weights
    from bioscan_clip_tpu_torch.models.heads import EncoderWithHead
    from bioscan_clip_tpu_torch.models.vit import ViT, ViTConfig

    with torch.device("meta"):
        vit = ViT(ViTConfig(num_classes=mc.output_dim, lora_rank=0),
                  dtype=dtype)
        clf = EncoderWithHead(vit, mc.output_dim, n_classes, dtype=dtype)
    return init_weights(clf.to_empty(device=device), seed=0)


def image_input(batch, device):
    """A batch's images on `device` (uint8 frames or host-transformed
    floats)."""
    from bioscan_clip_tpu_torch.train.loop import _to_device

    return _to_device(batch.get("image_u8", batch.get("image")), device)


def train_targets(loader, batch, unique_species, device):
    """A train batch's species targets: its instance labels index the
    loader's label dicts."""
    import torch

    from bioscan_clip_tpu_torch.train.fine_tuning import (
        label_batch_to_species_idx,
    )

    return torch.from_numpy(label_batch_to_species_idx(
        [loader.label_dicts[int(i)] for i in batch["labels"]],
        unique_species)).to(device)


def run(args, max_epochs=None, out=print, device=None):
    """Fine-tune, evaluate, export; returns the train state."""
    import torch

    from bioscan_clip_tpu_torch.data.transforms import eval_transform_auto
    from bioscan_clip_tpu_torch.device import compute_dtype, resolve_device
    from bioscan_clip_tpu_torch.parallel.mesh import mesh_from_config
    from bioscan_clip_tpu_torch.train.fine_tuning import (
        create_fine_tune_state,
        evaluate_classifier,
        get_all_unique_species_from_loader,
        make_classifier_train_step,
    )
    from bioscan_clip_tpu_torch.train.loop import data_axis, draw_step_seed

    dev = resolve_device(device or getattr(args, "device", None) or "cuda")
    mc = args.model_config
    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H%M%S")
    mc.batch_size = args.general_fine_tune_setting.batch_size
    mesh = data_axis(mesh_from_config(args, dev))

    (_, train_for_key, _, test_seen_loader,
     _) = load_insect_dataloader(args)
    trainval_loader = load_insect_dataloader_trainval(args)
    all_loader = load_insect_dataloader(args, load_all_in_one=True)
    unique_species = get_all_unique_species_from_loader(train_for_key)

    clf = build_classifier(mc, len(unique_species), dev, compute_dtype(dev))
    state = create_fine_tune_state(clf)
    step = make_classifier_train_step(clf, mesh, modality="image")

    epochs = max_epochs or args.general_fine_tune_setting.epoch
    for epoch in range(epochs):
        losses = []
        for batch in trainval_loader:
            db = {"input": image_input(batch, dev),
                  "target": train_targets(trainval_loader, batch,
                                          unique_species, dev)}
            state, loss = step(state, db, draw_step_seed(state.generator))
            losses.append(loss)
        out(f"epoch {epoch}: loss "
            f"{np.mean([x.item() for x in losses]):.4f}")
        if epoch % mc.evaluation_period == 0 or epoch == epochs - 1:
            acc = evaluate_classifier(clf, test_seen_loader, unique_species,
                                      modality="image")
            out(f"Evaluation Result: {acc}")

    # the per-sample pre-head features
    clf.eval()
    feats = []
    with torch.inference_mode():
        for batch in all_loader:
            x = image_input(batch, dev)
            if x.dtype == torch.uint8:
                x = eval_transform_auto(x)
            feats.append(clf.get_feature(x).float().cpu().numpy())
    image_feature = np.concatenate(feats, axis=0)
    folder = os.path.join(args.project_root_path,
                          "embedding_from_vitb_fine_tuned_on_insect", stamp)
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, "image_embedding_from_fine_tuned_vit.csv")
    np.savetxt(path, image_feature.T, delimiter=",")
    out(f"{path} {image_feature.T.shape}")
    return state


def main(argv=None):
    from bioscan_clip_tpu_torch.config.core import load_config

    args = load_config(
        overrides=list(argv if argv is not None else sys.argv[1:]))
    return run(args)


if __name__ == "__main__":
    main()
