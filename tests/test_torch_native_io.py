"""The port's host JPEG decode pool (bioscan_clip_tpu_torch/data/native_io.py
over csrc/host/bscan_io.cc) and the loader paths that take it, against the
JAX package's pool (native/bscan_io.cc) on the same JPEGs.

Each pool is built once for the file with g++ (the JAX Makefile's flags)
into a temporary directory: JAX's through a monkeypatched
`native_io._LIB_PATH`, the port's through `native_io.build()` with its
`BUILD_DIR` redirected; nothing is written under native/ or build/.
- `decode_batch`: frames bit-equal to JAX's at four source sizes (a
  downscale, an odd-sized portrait, an upscale, a 4:3 frame of 640) into a
  (256, 341) and the default (256, 256) slot; a corrupt JPEG raises naming
  its index, in both;
- `BioscanLoader` with both pools loaded: uint8 eval frames, their host
  center crop (`eval_host_crop`) and the host train augmentation
  (`train_crop`) bit-equal to the JAX loader's batches, every loader on
  the pool; on sources smaller than `host_resize_to` both loaders drop the
  pool and still agree; on a corrupt JPEG the port's loader raises naming
  its index, where JAX's drops the pool;
- `cli/loading_speed_test.run` over the synthetic fixture (Python decode)
  and over frames the pool takes: samples/s, stage times and each
  loader's decode path, the pool's path as JAX's run reports it."""

import os
import subprocess

import numpy as np
import pytest

from tests.fixtures import make_jpeg
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "order", "family",
         "genus", "species", "_", "0", "1", "2"]


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """(port native_io, JAX native_io), each on its freshly built pool."""
    from bioscan_clip_tpu.data import native_io as jax_nio
    from bioscan_clip_tpu_torch.data import native_io

    d = tmp_path_factory.mktemp("pools")
    jax_lib = d / "libbscan_io.so"
    jax_build = subprocess.Popen(
        ["g++", "-O3", "-fPIC", "-std=c++17", "-march=native", "-Wall",
         "-o", str(jax_lib), os.path.join(REPO, "native", "bscan_io.cc"),
         "-shared", "-ljpeg", "-lpthread"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_io, "BUILD_DIR", d / "port")
        mp.setattr(native_io, "_lib", None)
        mp.setattr(jax_nio, "_LIB_PATH", str(jax_lib))
        mp.setattr(jax_nio, "_lib", None)
        assert not native_io.available()
        lines = []
        path = native_io.build(out=lines.append)
        assert path.parent == d / "port" and lines
        _, err = jax_build.communicate(timeout=300)
        assert jax_build.returncode == 0, err
        assert native_io.available() and jax_nio.available()
        yield native_io, jax_nio


def jpegs(size, n=3, seed=0):
    return [make_jpeg(((40 + 50 * i) % 256, 90, (200 - 30 * i) % 256),
                      size=size, seed=seed + i) for i in range(n)]


@pytest.mark.parametrize("size", [(400, 300), (251, 333), (120, 90),
                                  (640, 480)])
def test_frames_match_jax(pools, size):
    port, jax_nio = pools
    bufs = jpegs(size) + jpegs((300, 400), n=1, seed=9)  # one outlier
    for slot in ((256, 341), (None, None)):
        got = port.decode_batch(bufs, 256, *slot, threads=2)
        ref = jax_nio.decode_batch(bufs, 256, *slot, threads=2)
        assert got.dtype == np.uint8
        assert got.shape == (4, slot[0] or 256, slot[1] or 256, 3)
        np.testing.assert_array_equal(got, ref)


def test_corrupt_jpeg_raises_with_its_index(pools):
    port, jax_nio = pools
    bufs = jpegs((300, 260), n=3)
    bufs[1] = b"\xff\xd8 not a jpeg"
    for mod in (port, jax_nio):
        with pytest.raises(ValueError, match="image index 1"):
            mod.decode_batch(bufs, 256, threads=2)


@pytest.fixture(scope="module")
def frames_path(tmp_path_factory):
    """An HDF5 in the loaders' layout: the four splits of `load_dataloader`
    with 6 frames of 400 x 300 each (the train split with a portrait
    outlier), a split of 64 x 48 frames, smaller than the 256 side, and
    one whose third JPEG is corrupt."""
    from bioscan_clip_tpu_torch.data.hdf5 import write_split_hdf5

    d = tmp_path_factory.mktemp("frames")
    (d / "vocab.txt").write_text("\n".join(VOCAB) + "\n")

    def records(seed, size=(400, 300), n=6):
        imgs = jpegs(size, n=n, seed=seed)
        if seed == 0:
            imgs[3] = jpegs((300, 410), n=1, seed=50)[0]
        return {"images": imgs, "barcode": ["ACGT" * 30] * n,
                "order": ["order_0"] * n, "family": ["family_1"] * n,
                "genus": [f"genus_{i % 2}" for i in range(n)],
                "species": [f"species_{i % 3}" for i in range(n)]}

    corrupt = records(5, n=4)
    corrupt["images"][2] = b"\xff\xd8 not a jpeg"
    splits = {"no_split_and_seen_train": records(0),
              "val_seen": records(1), "val_unseen": records(2),
              "all_keys": records(3), "small": records(4, size=(64, 48)),
              "corrupt": corrupt}
    path = str(d / "frames.hdf5")
    write_split_hdf5(path, splits, vocab_path=str(d / "vocab.txt"))
    return path


@pytest.mark.parametrize("split,kw,native,shape", [
    ("val_seen", dict(eval_parity=False), True, (256, 341)),
    ("val_seen", dict(eval_parity=False, eval_host_crop=True), True,
     (224, 224)),
    ("no_split_and_seen_train", dict(for_training=True, shuffle=True,
                                     train_crop=True, seed=3), True,
     (224, 224)),
    ("small", dict(eval_parity=False), False, (256, 341)),
])
def test_loader_batches_match_jax_with_the_pool(pools, frames_path, split,
                                                kw, native, shape):
    from bioscan_clip_tpu.data import pipeline as jax_pipeline
    from bioscan_clip_tpu_torch.data.pipeline import BioscanLoader

    ref_loader = jax_pipeline.BioscanLoader(frames_path, split, batch_size=4,
                                            decode_threads=2, **kw)
    loader = BioscanLoader(frames_path, split, batch_size=4,
                           decode_threads=2, **kw)
    assert loader.use_native and ref_loader._use_native
    got, ref = list(loader), list(ref_loader)
    # the first frame decides: below the 256 side both drop the pool
    assert loader.use_native == ref_loader._use_native == native
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert set(a) == set(b)
        assert a["image_u8"].dtype == np.uint8
        assert a["image_u8"].shape[1:] == (*shape, 3)
        np.testing.assert_array_equal(a["image_u8"], b["image_u8"])
        np.testing.assert_array_equal(a["dna"], b["dna"])
        if "labels" in b:
            np.testing.assert_array_equal(a["labels"], b["labels"])
        else:
            assert a["ids"] == b["ids"]


def speed_args(path, **tpu):
    from bioscan_clip_tpu_torch.config.core import ConfigNode
    from tests.fixtures import SyntheticArgs

    jax_args = SyntheticArgs(path, batch_size=4)
    args = ConfigNode(dict(jax_args.cfg))
    if tpu:
        args["tpu"] = tpu
    return jax_args, args


def test_loading_speed_test_decode_paths(pools, frames_path):
    from bioscan_clip_tpu.cli import loading_speed_test as jax_lst
    from bioscan_clip_tpu_torch.cli import loading_speed_test as lst
    from test_torch_train_loader import synthetic_dataset

    lines = []
    res = lst.run(speed_args(synthetic_dataset())[1], max_batches=2,
                  out=lines.append)
    assert res["samples"] == 8 and res["samples_per_s"] > 0
    assert set(res["stages"]) == {"read_ms", "decode_ms", "batch_ms"}
    # 64 x 48 sources: the pool is dropped, eval loaders parity-transform
    assert res["decode_paths"] == {
        "pre_train": "python (cv2/PIL)",
        **{k: "python (cv2/PIL), host eval transform"
           for k in ("val_seen", "val_unseen", "all_keys")}}
    assert "pre_train: decode path python (cv2/PIL)" in lines

    jax_args, args = speed_args(frames_path, eval_host_parity_resize=False)
    res = lst.run(args, max_batches=1, out=lambda *_: None)
    assert set(res["decode_paths"].values()) == {"native (libbscan_io)"}
    ref_lines = []
    rate = jax_lst.run(jax_args, max_batches=1, out=ref_lines.append)
    assert rate > 0 and ref_lines[0] == "decode path: native (libbscan_io)"
    assert res["samples"] == 4


def test_loader_raises_on_a_corrupt_jpeg(pools, frames_path):
    """The port's loader raises naming the image's index in its batch;
    JAX's drops the pool for the rest of its life and decodes in Python
    (which then fails on its own)."""
    from bioscan_clip_tpu.data import pipeline as jax_pipeline
    from bioscan_clip_tpu_torch.data.pipeline import BioscanLoader

    loader = BioscanLoader(frames_path, "corrupt", batch_size=4,
                           decode_threads=2, eval_parity=False)
    with pytest.raises(ValueError, match="image index 2"):
        list(loader)
    ref = jax_pipeline.BioscanLoader(frames_path, "corrupt", batch_size=4,
                                     decode_threads=2, eval_parity=False)
    with pytest.raises(Exception):
        list(ref)
    assert loader.use_native and not ref._use_native
