"""The port's train loader (bioscan_clip_tpu_torch/data/{pipeline,dataset}.py,
`for_training=True`) against JAX `BioscanLoader(for_training=True)` on the
synthetic HDF5 fixture: two epochs of batches, every array bit-equal (the
same shuffle per epoch and seed, window shuffle, drop_last, process shard,
instance and BIN labels, uint8 frames fitted to the first frame's slot, and
the host train augmentation's frames under `train_crop`)."""

import atexit
import contextlib
import functools
import hashlib
import os
import shutil
import sys
import tempfile

import numpy as np
import pytest

from tests.fixtures import SyntheticArgs, build_synthetic_dataset
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SPLIT = "no_split_and_seen_train"  # 24 records


@contextlib.contextmanager
def without_transformers():
    """`transformers` unimportable inside the block. A label tokenizer with
    no vocab then fails at its import, as it fails here at the missing
    cached BERT-small (the synthetic fixture then takes its stub tokens,
    the port's loaders raise), without the ~6 s import."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "transformers", None)
        yield


def stable_hash(s: str, salt: bytes = b"") -> int:
    """A hash of `s` that is the same in every process: Python's str hash
    is salted per process (PYTHONHASHSEED). Another `salt` gives another
    hash."""
    digest = hashlib.blake2b(s.encode(), digest_size=8, key=salt).digest()
    return int.from_bytes(digest, "little", signed=True)


def build_fixture(path, salt: bytes = b"", **kw) -> str:
    """`tests/fixtures.build_synthetic_dataset` without the import of
    `transformers`. Its stub label tokens (the JAX writer's hash of each
    label string) come from `stable_hash` under `salt`: with Python's
    salted hash they, and every loss and gradient trained on them, changed
    from one test run to the next."""
    from bioscan_clip_tpu.data import hdf5 as jax_hdf5

    with without_transformers(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_hdf5, "hash", functools.partial(stable_hash,
                                                       salt=salt),
                   raising=False)
        return str(build_synthetic_dataset(path, **kw))


@functools.lru_cache(maxsize=None)
def synthetic_dataset(salt: bytes = b"") -> str:
    """The synthetic HDF5 fixture (4 species x 6), its label tokens hashed
    under `salt`, built once per process and salt;
    tests/test_torch_{train_cl,distributed,eval}.py read it too."""
    d = tempfile.mkdtemp(prefix="bscan_train_")
    atexit.register(shutil.rmtree, d, True)
    return build_fixture(os.path.join(d, "synthetic.hdf5"), salt,
                         n_classes=4, per_class=6)


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
