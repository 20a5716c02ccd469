"""Dataloader factories with the reference's names and split wiring.

A copy of bioscan_clip_tpu/data/dataset.py (`get_bin_labels` :17-37,
`construct_dataloader` :48-102, `load_dataloader` :105-131,
`load_bioscan_dataloader_all_small_splits` :134-164,
`load_bioscan_dataloader_with_train_seen_and_separate_keys` :167-180) on
the port's `BioscanLoader`: the pre-training and train-seen loaders are
train loaders (shuffled, process-sharded, instance or BIN labels,
`tpu.train_crop`), the others eval loaders.
"""

from __future__ import annotations

import numpy as np

from bioscan_clip_tpu_torch.data.hdf5 import hdf5_path_for
from bioscan_clip_tpu_torch.data.pipeline import BioscanLoader


def get_bin_labels(split: str, hdf5_path: str, tsv_path: str) -> np.ndarray:
    """BIN-URI group ids for positive-pair mining (reference
    dataset.py:75-94): the metadata TSV filtered to the split's sampleids,
    each record's `uri` mapped to a dense id in first-appearance order.
    pandas is imported here only."""
    import pandas as pd

    from bioscan_clip_tpu_torch.data import h5file

    with h5file.File(hdf5_path, "r") as f:
        sample_ids = [s.decode("utf-8") for s in f[split]["sampleid"][:]]
    df = pd.read_csv(tsv_path, sep="\t")
    uris = df[df["sampleid"].isin(sample_ids)]["uri"].tolist()
    mapping: dict = {}
    out = [mapping.setdefault(u, len(mapping)) for u in uris]
    return np.asarray(out, dtype=np.int64)


def _modalities(args):
    mc = args.model_config
    with_image = hasattr(mc, "image") and getattr(
        mc.image, "input_type", "image"
    ) == "image"
    with_dna = hasattr(mc, "dna")
    with_language = True  # language tokens are always read (dataset.py:374)
    return with_image, with_dna, with_language


def construct_dataloader(args, split: str, *, for_pre_train: bool = False,
                         shuffle: bool = False, labels=None,
                         process_index: int = 0,
                         process_count: int = 1) -> BioscanLoader:
    """One split -> loader (reference construct_dataloader,
    dataset.py:291-368). `tpu.eval_host_parity_resize` (default true) picks
    the host eval transform; `tpu.eval_host_crop` (default true) the host
    center crop of the uint8 path; `tpu.train_crop` (default false) the
    host train augmentation. A pre-training loader takes BIN labels when
    `model_config.bin_for_positive_and_negative_pairs` is set."""
    mc = args.model_config
    with_image, with_dna, with_language = _modalities(args)
    path = hdf5_path_for(args)
    if (for_pre_train and labels is None
            and getattr(mc, "bin_for_positive_and_negative_pairs", False)):
        labels = get_bin_labels(split, path,
                                args.bioscan_data.path_to_tsv_data)
    tpu_cfg = getattr(args, "tpu", None)
    return BioscanLoader(
        path,
        split,
        batch_size=mc.batch_size,
        with_image=with_image,
        with_dna=with_dna,
        with_language=with_language,
        for_training=for_pre_train,
        shuffle=shuffle,
        labels=labels,
        decode_threads=getattr(mc, "num_workers", 8) * 2,
        eval_parity=bool(tpu_cfg.get("eval_host_parity_resize", True))
        if tpu_cfg else True,
        eval_host_crop=bool(tpu_cfg.get("eval_host_crop", True))
        if tpu_cfg else False,
        openclip_norm=bool(getattr(mc, "for_open_clip", False)),
        process_index=process_index,
        process_count=process_count,
        shuffle_window=int(tpu_cfg.get("shuffle_window", 0))
        if tpu_cfg else 0,
        train_crop=bool(tpu_cfg.get("train_crop", False))
        if tpu_cfg else False,
    )


def load_dataloader(args, world_size=None, rank=None, for_pretrain=True,
                    process_index: int = 0, process_count: int = 1):
    """(pre_train or train_seen, val_seen, val_unseen, all_keys) —
    dataset.py:460-546. Only the train loader is process-sharded; every
    process evaluates the full eval splits, as the reference's rank 0
    does."""
    mc = args.model_config

    def mk(split, **kw):
        return construct_dataloader(args, split, **kw)

    train_kw = dict(process_index=process_index,
                    process_count=process_count, shuffle=True)
    if for_pretrain:
        split = (
            "no_split_and_seen_train"
            if getattr(mc, "using_train_seen_for_pre_train", False)
            else "no_split"
        )
        train = mk(split, for_pre_train=True, **train_kw)
    else:
        train = mk("train_seen", **train_kw)
    return train, mk("val_seen"), mk("val_unseen"), mk("all_keys")


def load_bioscan_dataloader_all_small_splits(args, world_size=None,
                                             rank=None):
    """9 loaders over every eval split with the 1M/5M split-name mapping
    (dataset.py:549-711): train_seen, val_seen, val_unseen, test_seen,
    test_unseen, seen_keys, val_unseen_keys, test_unseen_keys, all_keys."""
    mc = args.model_config
    is_5m = getattr(mc, "dataset", None) == "bioscan_5m"

    def mk(split):
        return construct_dataloader(args, split)

    return (
        mk("seen_keys" if is_5m else "train_seen"),
        mk("val_seen"),
        mk("val_unseen"),
        mk("test_seen"),
        mk("test_unseen"),
        mk("seen_keys"),
        mk("unseen_keys" if is_5m else "val_unseen_keys"),
        mk("unseen_keys" if is_5m else "test_unseen_keys"),
        mk("all_keys"),
    )


def load_bioscan_dataloader_with_train_seen_and_separate_keys(
        args, world_size=None, rank=None, for_pretrain=True):
    """(train_seen, val_seen, val_unseen, seen_keys, val_unseen_keys,
    test_unseen_keys), train_seen shuffled: the six loaders of methods 1
    and 2 (dataset.py:371-457). Every one is an eval loader (label dicts
    and ids)."""
    def mk(split, **kw):
        return construct_dataloader(args, split, **kw)

    return (mk("train_seen", shuffle=True), mk("val_seen"),
            mk("val_unseen"), mk("seen_keys"), mk("val_unseen_keys"),
            mk("test_unseen_keys"))
