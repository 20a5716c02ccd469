"""The port's data-preparation modules against the JAX package on the same
seeded inputs (a handful of records each):
- `data/hdf5.write_split_hdf5` (1M and 5M flavors, WordPiece label tokens
  from a vocab written here): every dataset and attribute of the two files
  equal, bytes, shapes and dtypes included, and each package's
  `SplitReader` reads the other's file to the same rows; without a
  tokenizer the port refuses (JAX's salted-hash stub tokens are not
  copied);
- `data/splits.create_splits` on a metadata table with unclassified, tail
  and singleton species: equal split tables for two seeds; the same
  refusals on overlapping splits and on ratios that do not sum to 1;
- `cli/generate_hdf5` (`build_hdf5` and `main` on a CSV with NaN taxa and
  JPEG files): the two HDF5 files equal dataset by dataset;
- `cli/process_insect_dataset` on `.mat` files written with
  `scipy.io.savemat` and an image folder (one `.JPG`): equal CSVs, HDF5
  files equal dataset by dataset;
- `cli/get_species_taxo_labels`: equal JSON from a local table; the NCBI
  mode and the mode-less call refuse as JAX's do;
- `cli/flatten_csv`: equal rows and output files;
- `cli/read_image_with_image_file_as_name.find_record`: equal records,
  found and missing."""

import csv
import json
import os

import numpy as np
import pandas as pd
import pytest

from tests.fixtures import make_jpeg
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

LEVELS = ("order", "family", "genus", "species")
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "order", "family",
         "genus", "species", "_", "0", "1", "2", "3", "not", "classified"]


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    p = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    p.write_text("\n".join(VOCAB) + "\n")
    return str(p)


def split_records(n, seed, with_ids=True):
    rng = np.random.default_rng(seed)
    rec = {
        "images": [make_jpeg(tuple(int(c) for c in rng.integers(0, 255, 3)),
                             size=(24 + 8 * (i % 3), 16), seed=seed + i)
                   for i in range(n)],
        "barcode": ["".join(rng.choice(list("ACGTN"), size=40 + i))
                    for i in range(n)],
    }
    for lvl in LEVELS:
        rec[lvl] = [f"{lvl}_{int(c)}" for c in rng.integers(0, 3, size=n)]
    if with_ids:
        rec["sampleid"] = [f"S{seed}_{i}" for i in range(n)]
        rec["processid"] = [f"P{seed}_{i}" for i in range(n)]
        rec["image_file"] = [f"f{seed}_{i}.jpg" for i in range(n)]
    return rec


def assert_same_hdf5(a, b):
    """Every group, dataset (dtype, shape, values) and attribute equal."""
    import h5py

    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        names = []
        fa.visit(names.append)
        other = []
        fb.visit(other.append)
        assert sorted(names) == sorted(other)
        for name in names:
            x, y = fa[name], fb[name]
            assert dict(x.attrs) == dict(y.attrs), name
            assert type(x) is type(y), name
            if isinstance(x, h5py.Dataset):
                assert x.dtype == y.dtype and x.shape == y.shape, name
                np.testing.assert_array_equal(x[()], y[()], err_msg=name)
        assert dict(fa.attrs) == dict(fb.attrs)


@pytest.mark.parametrize("flavor", ["bioscan_1m", "bioscan_5m"])
def test_write_split_hdf5_matches_jax(tmp_path, vocab, flavor):
    from bioscan_clip_tpu.data import hdf5 as jax_hdf5
    from bioscan_clip_tpu_torch.data import hdf5

    splits = {"val_seen": split_records(5, 1),
              "all_keys": split_records(4, 2, with_ids=False)}
    got, ref = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    hdf5.write_split_hdf5(got, splits, dataset_flavor=flavor,
                          vocab_path=vocab)
    jax_hdf5.write_split_hdf5(ref, splits, dataset_flavor=flavor,
                              vocab_path=vocab)
    assert_same_hdf5(got, ref)
    idx = [3, 0, 3, 1]
    for path in (got, ref):  # each package reads the other's file
        a = hdf5.SplitReader(path, "val_seen")
        b = jax_hdf5.SplitReader(path, "val_seen")
        assert a.read_images_bytes(idx) == b.read_images_bytes(idx)
        assert a.read_images_bytes([2]) == [splits["val_seen"]["images"][2]]
        np.testing.assert_array_equal(a.read_dna_tokens(idx),
                                      b.read_dna_tokens(idx))
        for k, v in b.read_language_tokens(idx).items():
            np.testing.assert_array_equal(a.read_language_tokens(idx)[k], v)
        assert a.read_label_dicts(idx) == b.read_label_dicts(idx)
        assert a.read_ids(idx) == b.read_ids(idx)
        a.close()


def test_write_split_hdf5_needs_a_tokenizer(tmp_path, monkeypatch):
    from bioscan_clip_tpu_torch.data import hdf5
    from test_torch_train_loader import without_transformers

    monkeypatch.delenv("BSCAN_BERT_VOCAB", raising=False)
    with without_transformers(), pytest.raises(RuntimeError,
                                               match="BSCAN_BERT_VOCAB"):
        hdf5.write_split_hdf5(str(tmp_path / "x.h5"),
                              {"val_seen": split_records(2, 0)})


def metadata_table(seed=0):
    """60 common-species records over 10 species, 4 tail species of 2-3
    records, 2 singletons and 3 unclassified records."""
    rng = np.random.default_rng(seed)
    species = ([f"common_{i % 10}" for i in range(60)]
               + ["tail_a"] * 3 + ["tail_b"] * 2 + ["tail_c"] * 2
               + ["tail_d"] * 3
               + ["single_a", "single_b"] + ["not_classified"] * 3)
    n = len(species)
    order = rng.permutation(n)
    return pd.DataFrame({
        "sampleid": [f"S{i:03d}" for i in range(n)],
        "uri": [f"BOLD:{i % 7}" for i in range(n)],
        "image_file": [f"{i}.jpg" for i in range(n)],
        "species": [species[i] for i in order],
    })


@pytest.mark.parametrize("seed", [0, 7])
def test_create_splits_matches_jax(seed):
    from bioscan_clip_tpu.data import splits as jax_splits
    from bioscan_clip_tpu_torch.data import splits

    md = metadata_table(seed)
    got = splits.create_splits(md, min_species_size=4, seed=seed)
    ref = jax_splits.create_splits(md, min_species_size=4, seed=seed)
    pd.testing.assert_frame_equal(got, ref)
    assert {"train_seen", "val_unseen", "single_species",
            "no_split"} <= set(got["split"])


def test_splits_refuse_as_jax_does():
    from bioscan_clip_tpu.data import splits as jax_splits
    from bioscan_clip_tpu_torch.data import splits

    for mod in (splits, jax_splits):
        with pytest.raises(ValueError, match="overlap"):
            mod.assert_no_overlap(np.array(["a", "b"]),
                                  [np.array(["c"]), np.array(["b", "d"])])
        mod.assert_no_overlap(np.array(["a"]), [np.array(["b"])])
        with pytest.raises(AssertionError):
            mod.create_split_boundaries(10, [0.5, 0.4])
        assert mod.create_split_boundaries(10, [0.7, 0.1, 0.1, 0.1]) == [
            7, 8, 9]


def bioscan_metadata(image_dir):
    splits = ["train", "val", "test", "key_unseen", "test_unseen",
              "val_unseen", "pretrain", "train", "other_heldout"]
    rows = []
    for i, split in enumerate(splits):
        name = f"img_{i}.jpg"
        with open(os.path.join(image_dir, name), "wb") as f:
            f.write(make_jpeg((20 * i, 100, 200 - 10 * i), seed=i))
        rows.append({
            "processid": f"P{i}", "sampleid": f"S{i}", "split": split,
            "dna_barcode": "ACGT" * (5 + i), "image_file": name,
            "order": "order_1", "family": None if i == 2 else "family_0",
            "genus": float("nan") if i % 3 == 0 else f"genus_{i % 2}",
            "species": f"species_{i % 4}",
        })
    return pd.DataFrame(rows)


def test_generate_hdf5_matches_jax(tmp_path, vocab):
    from bioscan_clip_tpu.cli import generate_hdf5 as jax_gen
    from bioscan_clip_tpu_torch.cli import generate_hdf5 as gen

    img = tmp_path / "images"
    img.mkdir()
    md = bioscan_metadata(str(img))
    meta = tmp_path / "meta.tsv"
    md.to_csv(meta, sep="\t", index=False)
    lines = []
    got, ref = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    gen.build_hdf5(md, str(img), got, threads=2, out=lines.append,
                   vocab_path=vocab)
    jax_gen.build_hdf5(md, str(img), ref, threads=2, out=lambda *_: None,
                       vocab_path=vocab)
    assert_same_hdf5(got, ref)
    assert any(ln.startswith("all_keys: 3 records") for ln in lines)
    for mod, path in ((gen, got), (jax_gen, ref)):  # the CLIs, 1M flavor
        mod.main(["--metadata", str(meta), "--image-dir", str(img),
                  "--output", path, "--flavor", "bioscan_1m",
                  "--threads", "2", "--vocab", vocab])
    assert_same_hdf5(got, ref)
    from bioscan_clip_tpu_torch.data.hdf5 import SplitReader

    r = SplitReader(got, "val_seen")
    assert r.read_label_dicts([0]) == [{
        "order": "order_1", "family": "family_0", "genus": "genus_1",
        "species": "species_1"}]
    assert SplitReader(got, "test_seen").read_label_dicts([0])[0][
        "family"] == "not_classified"


def test_process_insect_dataset_matches_jax(tmp_path):
    import scipy.io as sio

    from bioscan_clip_tpu.cli import process_insect_dataset as jax_pid
    from bioscan_clip_tpu_torch.cli import process_insect_dataset as pid

    n = 8
    species = [f"species_{i % 3}" for i in range(n)]
    ids = [f"IMG{i:04d}" for i in range(n)]

    def cell(strings):
        return np.array([[s] for s in strings], dtype=object)

    sio.savemat(str(tmp_path / "res101.mat"), {
        "ids": cell(ids), "bold_ids": cell([f"B{i}" for i in range(n)]),
        "species": cell(species),
        "nucleotides": cell(["ACGT" * (3 + i) for i in range(n)]),
        "labels": (np.arange(n) % 3 + 1).reshape(-1, 1)})
    idx = np.arange(1, n + 1)
    sio.savemat(str(tmp_path / "att_splits.mat"), {
        "trainval_loc": idx[:6][None], "train_loc": idx[:4][None],
        "val_loc": idx[4:6][None], "test_seen_loc": idx[6:7][None],
        "test_unseen_loc": idx[7:][None]})
    for i, (sp, name) in enumerate(zip(species, ids)):
        d = tmp_path / "root" / "images" / sp
        d.mkdir(parents=True, exist_ok=True)
        ext = ".JPG" if i == 5 else ".jpg"
        (d / (name + ext)).write_bytes(make_jpeg((30 * i, 60, 90), seed=i))
    outs = {}
    for name, mod in (("port", pid), ("jax", jax_pid)):
        outs[name] = (tmp_path / f"{name}.csv", tmp_path / f"{name}.h5")
        mod.main(["--res101", str(tmp_path / "res101.mat"),
                  "--att-splits", str(tmp_path / "att_splits.mat"),
                  "--image-root", str(tmp_path / "root"),
                  "--out-csv", str(outs[name][0]),
                  "--out-hdf5", str(outs[name][1])])
    assert outs["port"][0].read_text() == outs["jax"][0].read_text()
    assert_same_hdf5(str(outs["port"][1]), str(outs["jax"][1]))
    df = pd.read_csv(outs["port"][0])
    assert df["labels"].tolist() == [i % 3 for i in range(n)]
    assert df["test_unseen_loc"].tolist() == [False] * 7 + [True]


def test_get_species_taxo_labels_matches_jax(tmp_path, capsys):
    from bioscan_clip_tpu.cli import get_species_taxo_labels as jax_tax
    from bioscan_clip_tpu_torch.cli import get_species_taxo_labels as tax

    table = tmp_path / "taxonomy.tsv"
    pd.DataFrame({
        "Species": ["s1", "s2", "s1", "s3"], "Order": ["o1", "o1", "oX", "o2"],
        "Family": ["f1", "f2", "fX", "f3"], "Genus": ["g1", "g2", "gX", "g3"],
    }).to_csv(table, sep="\t", index=False)
    species = tmp_path / "species.csv"
    pd.DataFrame({"species": ["s3", "s1", "s9"]}).to_csv(species,
                                                         index=False)
    assert (tax.from_metadata_table(str(table))
            == jax_tax.from_metadata_table(str(table)))
    outs = []
    for mod in (tax, jax_tax):
        outs.append(tmp_path / f"{mod.__name__}.json")
        mod.main(["--taxonomy-table", str(table), "--species-csv",
                  str(species), "--out", str(outs[-1])])
    got = json.loads(outs[0].read_text())
    assert got == json.loads(outs[1].read_text())
    assert got == {"s1": {"order": "o1", "family": "f1", "genus": "g1"},
                   "s3": {"order": "o2", "family": "f3", "genus": "g3"}}
    errors = []
    for mod in (tax, jax_tax):
        for argv in (["--ncbi-email", "a@b.c", "--out",
                      str(tmp_path / "n.json")], []):
            with pytest.raises((ImportError, SystemExit)) as e:
                mod.main(argv)
            errors.append((type(e.value), str(e.value)))
    assert errors[:2] == errors[2:]
    assert not (tmp_path / "n.json").exists()


def test_flatten_csv_matches_jax(tmp_path):
    from bioscan_clip_tpu.cli import flatten_csv as jax_flat
    from bioscan_clip_tpu_torch.cli import flatten_csv as flat

    fields = (["Query", "Key", "Metric"]
              + [f"{su}_{t}" for su in ("Seen", "Unseen")
                 for t in ("Order", "Family", "Genus", "Species")])
    rng = np.random.default_rng(0)
    path = tmp_path / "results.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(fields)
        for q in ("Image", "DNA"):
            for m in ("Micro", "Macro"):
                for k in (1, 3, 5):
                    w.writerow([q, "DNA", f"{m}_Top-{k}_Acc"]
                               + [f"{v:.4f}" for v in rng.random(8)])
    with open(path) as f:
        reader = csv.DictReader(f)
        rows, fieldnames = list(reader), reader.fieldnames
    got = flat.flatten(rows, fieldnames)
    assert got == jax_flat.flatten(rows, fieldnames)
    assert len(got[0]) == 12 * 8 and got[0][0]["top_k"] == "1"
    for mod in (flat, jax_flat):
        mod.main(["-i", str(path), "-o", str(tmp_path / mod.__name__)])
    assert ((tmp_path / flat.__name__).read_text()
            == (tmp_path / jax_flat.__name__).read_text())


def test_find_record_matches_jax(tmp_path, vocab):
    from bioscan_clip_tpu.cli import read_image_with_image_file_as_name as j
    from bioscan_clip_tpu_torch.cli import (
        read_image_with_image_file_as_name as r,
    )
    from bioscan_clip_tpu_torch.data.hdf5 import write_split_hdf5

    splits = {"val_seen": split_records(3, 4), "test_seen": split_records(
        3, 5)}
    for flavor, name, split, i in (("bioscan_1m", "f5_2.jpg", "test_seen", 2),
                                   ("bioscan_5m", "P4_1", "val_seen", 1)):
        path = str(tmp_path / f"{flavor}.h5")
        write_split_hdf5(path, splits, dataset_flavor=flavor,
                         vocab_path=vocab)
        got = r.find_record(path, name)
        assert got == j.find_record(path, name)
        assert got == (split, splits[split]["images"][i],
                       {lvl: splits[split][lvl][i] for lvl in LEVELS})
        assert r.find_record(path, "missing") == (None, None, None)
    out = tmp_path / "found.png"
    r.main(["--hdf5", path, "--name", "P4_1", "--out", str(out)])
    assert out.stat().st_size > 0
