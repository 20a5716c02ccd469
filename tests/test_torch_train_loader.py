"""The port's train loader (bioscan_clip_tpu_torch/data/{pipeline,dataset}.py,
`for_training=True`) against JAX `BioscanLoader(for_training=True)` on the
synthetic HDF5 fixture: two epochs of batches, every array bit-equal (the
same shuffle per epoch and seed, window shuffle, drop_last, process shard,
instance and BIN labels, uint8 frames fitted to the first frame's slot, and
the host train augmentation's frames under `train_crop`)."""

import atexit
import functools
import os
import shutil
import tempfile

import numpy as np
import pytest

from tests.fixtures import SyntheticArgs, build_synthetic_dataset

SPLIT = "no_split_and_seen_train"  # 24 records


@functools.lru_cache(maxsize=None)
def synthetic_dataset() -> str:
    """The synthetic HDF5 fixture, built once per process (its JPEGs take
    ~10 s); tests/test_torch_train_cl.py reads it too."""
    d = tempfile.mkdtemp(prefix="bscan_train_")
    atexit.register(shutil.rmtree, d, True)
    return str(build_synthetic_dataset(os.path.join(d, "synthetic.hdf5"),
                                       n_classes=4, per_class=6))


@pytest.fixture(scope="module")
def dataset_path():
    return synthetic_dataset()


def _loaders(path, batch_size=8, **kw):
    from bioscan_clip_tpu.data import pipeline as jax_pipeline
    from bioscan_clip_tpu_torch.data.pipeline import BioscanLoader

    kw = dict(for_training=True, decode_threads=4, **kw)
    jax_loader = jax_pipeline.BioscanLoader(path, SPLIT, batch_size, **kw)
    jax_loader._use_native = False  # the port decodes in Python only
    return jax_loader, BioscanLoader(path, SPLIT, batch_size, **kw)


def _same_batches(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        assert "labels" in x and "label_dicts" not in x
        for k in x:
            if isinstance(x[k], dict):
                for kk in x[k]:
                    np.testing.assert_array_equal(x[k][kk], y[k][kk])
            else:
                assert x[k].dtype == y[k].dtype, k
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("batch_size,kw", [
    (8, {}),  # instance labels, uint8 frames at the first frame's slot
    (8, {"shuffle": True, "seed": 3}),
    (8, {"shuffle": True, "shuffle_window": 5, "seed": 1}),
    (10, {"shuffle": True}),  # drop_last: 2 batches of 10, 4 rows left
    (10, {"drop_last": False, "with_image": False}),
    (4, {"shuffle": True, "process_index": 1, "process_count": 2}),
    (8, {"shuffle": True, "train_crop": True, "seed": 2}),
    (8, {"shuffle": True, "labels": np.arange(24) // 3}),  # BIN-like labels
])
def test_train_batches_match_jax(dataset_path, batch_size, kw):
    jax_loader, loader = _loaders(dataset_path, batch_size, **kw)
    assert len(loader) == len(jax_loader)
    epochs = []
    for _ in range(2):  # the epoch advances after each complete pass
        out = list(loader)
        _same_batches(out, list(jax_loader))
        assert len(out) == len(loader)
        epochs.append(np.concatenate([b["dna"] for b in out]))
    assert loader.epoch == jax_loader.epoch == 2
    if kw.get("shuffle"):
        assert not np.array_equal(*epochs)
    if kw.get("train_crop"):
        assert out[0]["image_u8"].shape == (batch_size, 224, 224, 3)
    loader.set_epoch(0)  # a resumed run sets the epoch it starts at
    _same_batches(list(loader), list(_loaders(dataset_path, batch_size,
                                              **kw)[0]))


def test_bin_labels_and_the_pretraining_factory(dataset_path, tmp_path):
    import pandas as pd

    from bioscan_clip_tpu.data import dataset as jax_dataset
    from bioscan_clip_tpu_torch.data import dataset

    tsv = tmp_path / "meta.tsv"
    pd.DataFrame({"sampleid": [f"sample_{i}" for i in range(30)],
                  "uri": [f"BOLD:{(7 * i) % 5}" for i in range(30)]}).to_csv(
        tsv, sep="\t", index=False)
    bins = dataset.get_bin_labels(SPLIT, dataset_path, str(tsv))
    np.testing.assert_array_equal(
        bins, jax_dataset.get_bin_labels(SPLIT, dataset_path, str(tsv)))
    assert bins.dtype == np.int64 and bins.max() == 4

    args = SyntheticArgs(dataset_path, batch_size=8)
    args.cfg.model_config.merge({"bin_for_positive_and_negative_pairs": True})
    args.cfg.merge({"bioscan_data": {"path_to_tsv_data": str(tsv)}})
    train, seen, unseen, keys = dataset.load_dataloader(args)
    ref = jax_dataset.load_dataloader(args)[0]
    assert (train.split, train.for_training, train.shuffle) == (
        SPLIT, True, True)
    assert not seen.for_training and keys.split == "all_keys"
    np.testing.assert_array_equal(train.labels, ref.labels)
    assert len(train) == len(ref) == 3
    ref._use_native = False
    _same_batches(list(train), list(ref))
