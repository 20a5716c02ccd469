"""Dataloader factories with the reference's names and split wiring.

A copy of the eval half of bioscan_clip_tpu/data/dataset.py
(`construct_dataloader` :48-102, `load_dataloader` :105-131,
`load_bioscan_dataloader_all_small_splits` :134-164) on the port's
`BioscanLoader`. A pre-training loader (`for_pre_train=True`, and
`load_dataloader(for_pretrain=True)`) needs the loader's train half and
raises until it is ported.
"""

from __future__ import annotations

from bioscan_clip_tpu_torch.data.hdf5 import hdf5_path_for
from bioscan_clip_tpu_torch.data.pipeline import BioscanLoader


def _modalities(args):
    mc = args.model_config
    with_image = hasattr(mc, "image") and getattr(
        mc.image, "input_type", "image"
    ) == "image"
    with_dna = hasattr(mc, "dna")
    with_language = True  # language tokens are always read (dataset.py:374)
    return with_image, with_dna, with_language


def construct_dataloader(args, split: str, *, for_pre_train: bool = False,
                         shuffle: bool = False, process_index: int = 0,
                         process_count: int = 1) -> BioscanLoader:
    """One split -> loader (reference construct_dataloader,
    dataset.py:291-368). `tpu.eval_host_parity_resize` (default true) picks
    the host eval transform; `tpu.eval_host_crop` (default true) the host
    center crop of the uint8 path."""
    mc = args.model_config
    with_image, with_dna, with_language = _modalities(args)
    tpu_cfg = getattr(args, "tpu", None)
    return BioscanLoader(
        hdf5_path_for(args),
        split,
        batch_size=mc.batch_size,
        with_image=with_image,
        with_dna=with_dna,
        with_language=with_language,
        for_training=for_pre_train,
        shuffle=shuffle,
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
    )


def load_dataloader(args, world_size=None, rank=None, for_pretrain=True,
                    process_index: int = 0, process_count: int = 1):
    """(pre_train or train_seen, val_seen, val_unseen, all_keys) —
    dataset.py:460-546."""
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
