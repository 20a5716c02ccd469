"""The port's file-fed entry points on the CPU with h5py unimportable
(`sys.modules["h5py"] = None`, as on the card's machine, which has none):
every split file, image store, embedding cache and export goes through the
port's own `data/h5file.py`.

- `cli/inference_and_eval` from the synthetic split file: its embeddings
  within 1e-4 of the JAX package's CLI on the same file (the eval tests'
  tolerance, tests/test_torch_eval.py); its `load_inference` re-run from
  its own cache gives its accuracy and report files again; from the JAX
  package's cache, the JAX report byte for byte.
- `cli/train_cl` for 2 steps from the file: losses and eval bit-equal to
  the same run on loaders whose records were read into memory first (by
  h5py, before it is made unimportable).
- `cli/extract_embedding` writes its nine exports; `RetrievalService.
  from_export` answers `/search` requests as a service over the in-memory
  keys does.
- `cli/process_insect_dataset.save_images_hdf5` writes the INSECT image
  store, and `InsectLoader` reads it batch for batch as JAX's loader reads
  the h5py store of the same JPEGs.
"""

import sys

import h5py
import numpy as np
import pytest

# the JAX package imports h5py when its modules load: load them first
import bioscan_clip_tpu.cli.inference_and_eval as jax_cli  # noqa: F401
import bioscan_clip_tpu.data.insect  # noqa: F401
import bioscan_clip_tpu.models.clip as jax_clip
from test_torch_eval import (  # noqa: F401 (tiny_params: a fixture)
    EMB_ATOL,
    _jax_tiny,
    _port_tiny,
    tiny_params,
)
from test_torch_insect import (  # noqa: F401 (insect: a fixture)
    assert_batches_equal,
    insect,
    jax_loader,
)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train_cl import tiny_factory
from test_torch_train_loader import synthetic_dataset
from tests.fixtures import SyntheticArgs


def _without_h5py(monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        import h5py  # noqa: F401,F811


@pytest.fixture
def cli_args(tmp_path, tiny_params, monkeypatch):
    import bioscan_clip_tpu_torch.models.clip as port_clip

    monkeypatch.setattr(jax_clip, "load_clip_model", _jax_tiny)
    monkeypatch.setattr(jax_clip, "init_clip_params",
                        lambda model, rng: tiny_params)
    monkeypatch.setattr(port_clip, "load_clip_model",
                        lambda args, device=None, dtype=None:
                        _port_tiny(tiny_params, device))
    args = SyntheticArgs(synthetic_dataset(), batch_size=8)
    args.cfg.merge({
        "project_root_path": str(tmp_path / "proj"),
        "inference_and_eval_setting": {"eval_on": "val", "k_list": [1, 3, 5],
                                       "retrieval_precision": "high"},
        "load_inference": False,
    })
    args.cfg.model_config.merge({"load_ckpt": False})
    return args


def _report(run_dir):
    return {f: (run_dir / "logs" / f).read_text()
            for f in ("accuracy.json", "results.csv", "raw.csv")}


def test_inference_and_eval_from_the_split_file(cli_args, tmp_path,
                                                monkeypatch):
    from bioscan_clip_tpu_torch.cli import inference_and_eval as cli

    mc = cli_args.model_config
    folder = tmp_path / "proj" / "extracted_embedding" / mc.dataset
    for name in ("jax", "port", "port_again", "port_on_jax"):
        (tmp_path / name).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jax_cli.run(cli_args, out=lambda *_: None)

    _without_h5py(monkeypatch)
    cli_args.cfg.merge({"device": "cpu"})
    mc.merge({"model_output_name": "port"})
    monkeypatch.chdir(tmp_path / "port")
    lines = []
    acc, _, _ = cli.run(cli_args, out=lines.append)
    assert any(ln.startswith("Saved feature cache") for ln in lines)

    def cache(name):
        return cli.load_feature_cache(
            str(folder / name / "extracted_feature_from_val_split.hdf5"),
            str(folder / name / "labels_val.json"))

    for ours, theirs in zip(cache("port"), cache("synthetic")):
        assert ours.keys() == theirs.keys()
        for k in set(ours) - {"label_list", "all_key_features_label"}:
            assert ours[k].dtype == np.float32
            np.testing.assert_allclose(ours[k], theirs[k], rtol=0,
                                       atol=EMB_ATOL, err_msg=k)
        assert ours["label_list"] == theirs["label_list"]

    cli_args.cfg.merge({"load_inference": True})
    monkeypatch.chdir(tmp_path / "port_again")
    again = []
    acc2, _, _ = cli.run(cli_args, out=again.append)
    assert again[0] == "Loading embeddings from file..."
    assert acc2 == acc
    assert _report(tmp_path / "port_again") == _report(tmp_path / "port")

    mc.merge({"model_output_name": "synthetic"})  # the JAX CLI's cache
    monkeypatch.chdir(tmp_path / "port_on_jax")
    cli.run(cli_args, out=lambda *_: None)
    assert _report(tmp_path / "port_on_jax") == _report(tmp_path / "jax")


class MemoryReader:
    """A split held in memory, read out of the file by h5py before the test
    makes it unimportable: the reader contract `BioscanLoader` uses."""

    def __init__(self, path, split):
        with h5py.File(path, "r") as f:
            self.cols = {k: v[()] for k, v in f[split].items()}

    def __len__(self):
        return len(self.cols["image"])

    def read_images_bytes(self, idx):
        return [self.cols["image"][i][:self.cols["image_mask"][i]].tobytes()
                for i in idx]

    def read_dna_tokens(self, idx):
        from bioscan_clip_tpu_torch.data.tokenizers import tokenize_dna_batch

        return tokenize_dna_batch([self.cols["barcode"][i] for i in idx])

    def read_language_tokens(self, idx):
        return {k: self.cols[f"language_tokens_{k}"][np.asarray(idx)].astype(
            np.int32) for k in ("input_ids", "token_type_ids",
                                "attention_mask")}

    def read_label_dicts(self, idx):
        return [{lvl: self.cols[lvl][i].decode() for lvl in (
            "order", "family", "genus", "species")} for i in idx]

    def read_ids(self, idx):
        return [self.cols["image_file"][i].decode() for i in idx]


def test_train_cl_from_the_split_file_equals_in_memory(tmp_path,
                                                       monkeypatch):
    import bioscan_clip_tpu_torch.models.clip as port_clip
    from bioscan_clip_tpu_torch.cli import train_cl

    path = synthetic_dataset()
    memory = {split: MemoryReader(path, split) for split in (
        "no_split_and_seen_train", "val_seen", "val_unseen", "all_keys")}
    _without_h5py(monkeypatch)
    monkeypatch.setattr(port_clip, "load_clip_model", tiny_factory)
    monkeypatch.chdir(tmp_path)
    real = train_cl.load_dataloader

    def in_memory(args, **kw):
        loaders = real(args, **kw)
        for loader in loaders:
            loader.reader = memory[loader.split]
        return loaders

    runs = {}
    for name, load in (("file", real), ("memory", in_memory)):
        args = SyntheticArgs(path, batch_size=8)
        args.cfg.merge({
            "project_root_path": str(tmp_path / name),
            "model_output_dir": "ckpt", "save_ckpt": False,
            "debug_flag": False, "activate_wandb": False, "device": "cpu",
            "inference_and_eval_setting": {"k_list": [1, 3, 5]},
            "tpu": {"max_steps_per_epoch": 2}})
        args.cfg.model_config.merge({
            "epochs": 1, "evaluation_period": 1, "load_ckpt": False,
            "model_output_name": "tc"})
        monkeypatch.setattr(train_cl, "load_dataloader", load)
        lines = []
        state, best = train_cl.run(args, out=lines.append)
        runs[name] = (state.step, best, [ln for ln in lines if ln.startswith(
            "epoch 0 losses")])
    assert runs["file"][0] == 2 and len(runs["file"][2]) == 1
    assert runs["file"] == runs["memory"]


def test_export_serves_and_the_insect_store(cli_args, tiny_params, insect,
                                            tmp_path, monkeypatch):
    from bioscan_clip_tpu_torch.cli import extract_embedding
    from bioscan_clip_tpu_torch.cli.process_insect_dataset import (
        save_images_hdf5,
    )
    from bioscan_clip_tpu_torch.data.dataset import construct_dataloader
    from bioscan_clip_tpu_torch.data.insect import InsectLoader
    from bioscan_clip_tpu_torch.retrieval.service import (
        RetrievalService,
        handle_request,
    )
    from bioscan_clip_tpu_torch.train.loop import extract_features

    jax_args, port_args, vocab = insect
    store = port_args.insect_data.path_to_image_hdf5
    with h5py.File(store, "r") as f:
        jpegs = {name: f["images"][name][()].tobytes() for name in f["images"]}
    ref = list(jax_loader(jax_args, vocab, "all", eval_parity=False))
    _without_h5py(monkeypatch)

    # the INSECT image store, written and read without h5py
    root = tmp_path / "insect_root"
    for name, data in jpegs.items():
        d = root / "images" / "sp"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{name}.jpg").write_bytes(data)
    out = str(tmp_path / "INSECT_images.hdf5")
    save_images_hdf5(str(root), ["sp"] * len(jpegs), list(jpegs), out)
    port_args.insect_data["path_to_image_hdf5"] = out
    try:
        got = list(InsectLoader(port_args, "all", eval_parity=False,
                                vocab_path=vocab))
    finally:
        port_args.insect_data["path_to_image_hdf5"] = store
    assert_batches_equal(got, ref)

    # the export and the service over it
    cli_args.cfg.merge({"device": "cpu"})
    extract_embedding.run(cli_args, out=lambda *_: None)
    mc = cli_args.model_config
    folder = (tmp_path / "proj" / "extracted_embedding" / mc.dataset
              / mc.model_output_name)
    assert len(list(folder.glob("extracted_features_of_*.hdf5"))) == 9
    model = _port_tiny(tiny_params)
    mc.batch_size = 24
    keys = extract_features(model, construct_dataloader(cli_args,
                                                        "all_keys"))
    served = RetrievalService.from_export(
        model, str(folder / "extracted_features_of_all_keys.hdf5"),
        feature_type="encoded_dna_feature", device="cpu")
    memory = RetrievalService(model, keys=keys["encoded_dna_feature"],
                              key_labels=keys["label_list"], device="cpu")
    seen = construct_dataloader(cli_args, "val_seen").reader
    barcodes = seen.read_barcodes(range(len(seen)))
    body = {"dna": [b.decode() for b in barcodes], "k": 3}
    a, b = handle_request(served, body), handle_request(memory, body)
    assert a["predictions"] == b["predictions"]
    np.testing.assert_array_equal(a["similarities"], b["similarities"])
    assert len(a["similarities"]) == len(barcodes) > 0
