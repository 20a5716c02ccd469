"""The eval slice against the JAX package on the same inputs: the device
eval transform, the metrics and the 5 x 6 sweep (`high` and `int8`), the
eval loader on the synthetic HDF5 fixture, feature extraction (per batch
and grouped) on a tiny model carried over by `state_dict_from_jax`, and the
two CLIs end to end.

Tolerances:
- eval transform: the crop and pre-cropped branches bit-equal (the same
  uint8 slice times the same fp32 reciprocal of 255); the resize branch
  within 1e-6 on [0, 1] pixels (measured <= 3.0e-7: JAX's weight matrices
  are rebuilt in numpy float32, 1 ulp apart at most, and the products sum in
  another order), and 4e-6 after the CLIP normalization (1e-6 / min std);
- metrics and the sweep over the same embeddings: equal (the same integer
  counts through the same float arithmetic);
- loader batches: equal (the same cv2 decode, resize and crops);
- embeddings: 1e-4, the towers' tolerance (tests/test_torch_towers.py);
  grouped against per-batch extraction in the port: 1e-6.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioscan_clip_tpu.data import transforms as jax_transforms
from bioscan_clip_tpu.retrieval import metrics as jax_metrics
from bioscan_clip_tpu.retrieval import report as jax_report
from bioscan_clip_tpu_torch.data import transforms
from bioscan_clip_tpu_torch.retrieval import metrics, report
from tests.fixtures import SyntheticArgs, build_synthetic_dataset

FEATURES = ("encoded_image_feature", "encoded_dna_feature",
            "encoded_language_feature", "averaged_feature",
            "concatenated_feature")
EMB_ATOL = 1e-4


def _both_transforms(x, **kw):
    ref = np.asarray(jax_transforms.eval_transform(jnp.asarray(x), **kw))
    out = transforms.eval_transform(torch.from_numpy(x), **kw).numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    return out, ref


@pytest.mark.parametrize("shape,pre_cropped", [
    ((3, 256, 341, 3), False),  # no-op resize: crop the uint8 frame
    ((2, 341, 256, 3), False),
    ((2, 224, 224, 3), True),   # the loader cropped already
])
def test_eval_transform_crop_branches_bit_equal(shape, pre_cropped):
    x = np.random.default_rng(0).integers(0, 256, size=shape, dtype=np.uint8)
    out, ref = _both_transforms(x, pre_cropped=pre_cropped)
    np.testing.assert_array_equal(out, ref)
    out, ref = _both_transforms(x, pre_cropped=pre_cropped, normalize=True)
    np.testing.assert_allclose(out, ref, rtol=0, atol=4e-6)
    auto = transforms.eval_transform_auto(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        auto, np.asarray(jax_transforms.eval_transform_auto(jnp.asarray(x))))


@pytest.mark.parametrize("shape", [(2, 300, 260, 3), (2, 48, 64, 3),
                                   (2, 333, 251, 3), (1, 224, 224, 3)])
def test_eval_transform_resize_branch(shape):
    x = np.random.default_rng(1).integers(0, 256, size=shape, dtype=np.uint8)
    out, ref = _both_transforms(x)
    assert np.abs(out - ref).max() <= 1e-6
    out, ref = _both_transforms(x, normalize=True)
    assert np.abs(out - ref).max() <= 4e-6
    if shape[1:3] != (224, 224):
        with pytest.raises(ValueError):
            transforms.eval_transform(torch.from_numpy(x), pre_cropped=True)


def _labels(n, rng, n_species=6):
    sp = rng.integers(0, n_species, size=n)
    return [{"order": f"o{s % 2}", "family": f"f{s % 3}",
             "genus": f"g{s % 4}", "species": f"s{s}"} for s in sp]


def test_metrics_match_jax():
    rng = np.random.default_rng(2)
    gt = _labels(40, rng)
    preds = [{lvl: [p[lvl] for p in _labels(5, rng)]
              for lvl in metrics.LEVELS} for _ in range(40)]
    assert (metrics.top_k_micro_accuracy(preds, gt, [1, 3, 5])
            == jax_metrics.top_k_micro_accuracy(preds, gt, [1, 3, 5]))
    assert (metrics.top_k_macro_accuracy(preds, gt, [1, 5])
            == jax_metrics.top_k_macro_accuracy(preds, gt, [1, 5]))
    assert metrics.harmonic_mean(0.3, 0.6) == jax_metrics.harmonic_mean(
        0.3, 0.6)
    assert metrics.harmonic_mean(0.0, 0.0) == 0.0


def _split(rng, n, protos, d, for_key_set=False, build=report.build_split_dict):
    labels = _labels(n, rng, len(protos))
    cls = np.array([int(lab["species"][1:]) for lab in labels])

    def feat(noise):
        return (protos[cls] + noise * rng.standard_normal((n, d))).astype(
            np.float32)

    return build(image=feat(0.8), dna=feat(0.9), language=feat(1.0),
                 label_list=labels, file_name_list=[f"r{i}" for i in range(n)],
                 for_key_set=for_key_set)


class _Args:
    """What the sweep reads of the config, without a model config."""

    def __init__(self, precision):
        self.save_inference = True
        self.model_config = None
        self.inference_and_eval_setting = type(
            "IES", (), {"retrieval_precision": precision})()


@pytest.mark.parametrize("precision", ["high", "int8"])
def test_sweep_matches_jax(precision, tmp_path, monkeypatch):
    """inference_and_print_result over the same numpy split dicts: the
    acc_dict, the printed table and the CSV/JSON files are equal."""
    rng = np.random.default_rng(3)
    protos = rng.standard_normal((6, 32)).astype(np.float32)
    keys = _split(rng, 60, protos, 32, for_key_set=True)
    seen, unseen = _split(rng, 30, protos, 32), _split(rng, 24, protos, 32)
    files = {}
    for name, mod, kw in (("jax", jax_report, {}),
                          ("port", report, {"device": "cpu"})):
        run_dir = tmp_path / name
        run_dir.mkdir()
        monkeypatch.chdir(run_dir)
        lines = []
        acc, per_class, _ = mod.inference_and_print_result(
            keys, seen, unseen, args=_Args(precision), k_list=[1, 3, 5],
            out=lines.append, **kw)
        files[name] = (acc, per_class, lines,
                       {f: (run_dir / "logs" / f).read_text()
                        for f in ("accuracy.json", "results.csv",
                                  "raw.csv")})
    assert files["port"] == files["jax"]
    acc = files["port"][0]
    assert set(acc) == set(FEATURES)
    assert all(len(acc[q]) == 6 for q in FEATURES)
    assert acc["encoded_image_feature"]["encoded_image_feature"]["seen"][
        "micro_acc"][1]["species"] > 0.5


# ---------------------------------------------------------------- the data


@pytest.fixture(scope="module")
def dataset_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("data") / "synthetic.hdf5"
    return str(build_synthetic_dataset(str(p), n_classes=4, per_class=6))


def _loaders(path, split, **kw):
    from bioscan_clip_tpu.data import pipeline as jax_pipeline
    from bioscan_clip_tpu_torch.data.pipeline import BioscanLoader

    jax_loader = jax_pipeline.BioscanLoader(path, split, batch_size=8, **kw)
    jax_loader._use_native = False  # the port decodes in Python only
    return jax_loader, BioscanLoader(path, split, batch_size=8, **kw)


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], dict):
                for kk in x[k]:
                    np.testing.assert_array_equal(x[k][kk], y[k][kk])
            elif isinstance(x[k], np.ndarray):
                assert x[k].dtype == y[k].dtype, k
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
            else:
                assert x[k] == y[k], k


@pytest.mark.parametrize("kw", [
    {},  # host eval transform (the parity path), float32 frames
    {"eval_parity": False, "eval_host_crop": False},  # uint8 256-frames
    {"eval_parity": False, "eval_host_crop": True},   # uint8 224 crops
    {"with_image": False, "shuffle": True, "seed": 3},
])
def test_loader_batches_match_jax(dataset_path, kw):
    jax_loader, loader = _loaders(dataset_path, "val_seen", **kw)
    assert len(loader) == len(jax_loader) == 2
    assert loader.eval_pre_cropped == jax_loader.eval_pre_cropped
    _same_batches(list(loader), list(jax_loader))


def test_factories_and_cancellation(dataset_path):
    import threading
    import time

    from bioscan_clip_tpu.data import dataset as jax_dataset
    from bioscan_clip_tpu_torch.data import dataset

    args = SyntheticArgs(dataset_path, batch_size=8)
    out = dataset.load_bioscan_dataloader_all_small_splits(args)
    ref = jax_dataset.load_bioscan_dataloader_all_small_splits(args)
    assert [ld.split for ld in out] == [ld.split for ld in ref]
    assert [len(ld) for ld in out] == [len(ld) for ld in ref]
    train, seen, unseen, keys = dataset.load_dataloader(
        args, for_pretrain=False)
    assert (train.split, train.shuffle, keys.split) == ("train_seen", True,
                                                        "all_keys")
    pre = dataset.load_dataloader(args)[0]  # the pre-training loader
    ref = jax_dataset.load_dataloader(args)[0]
    assert (pre.split, pre.for_training, pre.drop_last, len(pre)) == (
        ref.split, True, True, len(ref))
    from bioscan_clip_tpu_torch.data.hdf5 import get_len_dict

    assert get_len_dict(args)["val_seen"] == 12

    def producers():
        return [t for t in threading.enumerate()
                if t.name == "bscan-prefetch"]

    it = iter(dataset.construct_dataloader(args, "all_keys"))
    next(it)
    it.close()  # a consumer that stops early
    deadline = time.time() + 40
    while producers() and time.time() < deadline:
        time.sleep(0.05)
    assert not producers()


# ------------------------------------------------------- extraction + CLIs


def _jax_tiny(args=None, dtype=jnp.float32, lora_rank=2):
    from bioscan_clip_tpu.models.bert import (
        BarcodeBertDnaEncoder,
        BertConfig,
        BertTextEncoder,
    )
    from bioscan_clip_tpu.models.clip import MultiModalCLIP
    from bioscan_clip_tpu.models.vit import ViT, ViTConfig

    kw = dict(hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
              lora_rank=lora_rank, hidden_dropout=0.0, attention_dropout=0.0)
    return MultiModalCLIP(
        image_encoder=ViT(ViTConfig(image_size=224, patch_size=32,
                                    hidden_size=32, num_layers=1, num_heads=2,
                                    num_classes=32, lora_rank=lora_rank),
                          dtype=jnp.float32),
        dna_encoder=BarcodeBertDnaEncoder(BertConfig(vocab_size=1027, **kw),
                                          output_dim=32, dtype=jnp.float32),
        language_encoder=BertTextEncoder(BertConfig(vocab_size=30522, **kw),
                                         output_dim=32, dtype=jnp.float32),
    )


def _port_tiny(params, device="cpu"):
    from bioscan_clip_tpu_torch.interop.weights import (
        load_into,
        state_dict_from_jax,
    )
    from bioscan_clip_tpu_torch.models.bert import (
        BarcodeBertDnaEncoder,
        BertConfig,
        BertTextEncoder,
    )
    from bioscan_clip_tpu_torch.models.clip import MultiModalCLIP
    from bioscan_clip_tpu_torch.models.vit import ViTConfig, ViTImageEncoder

    kw = dict(hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
              lora_rank=2)
    model = MultiModalCLIP(
        image_encoder=ViTImageEncoder(ViTConfig(
            image_size=224, patch_size=32, hidden_size=32, num_layers=1,
            num_heads=2, num_classes=32, lora_rank=2)),
        dna_encoder=BarcodeBertDnaEncoder(BertConfig(vocab_size=1027, **kw),
                                          output_dim=32),
        language_encoder=BertTextEncoder(BertConfig(vocab_size=30522, **kw),
                                         output_dim=32),
    )
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return load_into(model, state_dict_from_jax(params)).to(device).eval()


@pytest.fixture(scope="module")
def tiny_params():
    from bioscan_clip_tpu.models.clip import init_clip_params

    # jitted: one compile instead of op-by-op dispatch of the init
    return jax.jit(lambda key: init_clip_params(_jax_tiny(), key))(
        jax.random.PRNGKey(0))


def _assert_split_close(out, ref, atol):
    for k in FEATURES + ("all_key_features",):
        if ref.get(k) is None:
            assert out.get(k) is None, k
            continue
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=atol,
                                   err_msg=k)
    assert out["label_list"] == ref["label_list"]
    assert out["file_name_list"] == ref["file_name_list"]


@pytest.mark.parametrize("kw", [
    {"eval_parity": False, "eval_host_crop": False},  # device transform
    {},  # host eval transform
])
def test_extract_features_matches_jax(dataset_path, tiny_params, kw):
    """Per-batch and grouped extraction of the port on the port's loader
    against JAX's per-batch extraction on JAX's loader."""
    from bioscan_clip_tpu.parallel.mesh import create_mesh
    from bioscan_clip_tpu.train.loop import (
        extract_features as jax_extract,
    )
    from bioscan_clip_tpu_torch.train.loop import extract_features

    jax_loader, loader = _loaders(dataset_path, "val_seen", **kw)
    ref = jax_extract(tiny_params, _jax_tiny(),
                      create_mesh(devices=jax.devices()[:1]), jax_loader,
                      for_key_set=True, group_samples=0)
    model = _port_tiny(tiny_params)
    marks = []
    out = extract_features(model, loader, for_key_set=True,
                           progress=lambda i, t: marks.append(i))
    assert marks == [0, 1]  # group_samples defaults to 0 on the CPU
    _assert_split_close(out, ref, EMB_ATOL)
    grouped = extract_features(model, loader, for_key_set=True,
                               group_samples=16,
                               progress=lambda i, t: marks.append(i))
    assert marks == [0, 1, 0]  # one mark per group start
    _assert_split_close(grouped, out, 1e-6)
    assert grouped["encoded_image_feature"].shape == (12, 32)


@pytest.fixture
def cli_args(dataset_path, tmp_path):
    args = SyntheticArgs(dataset_path, batch_size=8)
    args.cfg.merge({
        "project_root_path": str(tmp_path / "proj"),
        "inference_and_eval_setting": {"eval_on": "val", "k_list": [1, 3, 5],
                                       "retrieval_precision": "high"},
        "load_inference": False,
    })
    args.cfg.model_config.merge({"load_ckpt": False})
    return args


def test_clis_end_to_end(cli_args, tiny_params, tmp_path, monkeypatch):
    """The JAX inference_and_eval CLI writes its feature cache and report;
    the port's inference_and_eval in load_inference mode reads that cache
    and writes the same accuracy.json and CSVs. Then the port's two CLIs
    run end to end on the CPU with the same tiny model: their features
    agree with the JAX cache, and a second load_inference run reads the
    port's own cache."""
    import h5py

    import bioscan_clip_tpu.models.clip as jax_clip
    import bioscan_clip_tpu_torch.models.clip as port_clip
    from bioscan_clip_tpu.cli import inference_and_eval as jax_cli
    from bioscan_clip_tpu_torch.cli import extract_embedding
    from bioscan_clip_tpu_torch.cli import inference_and_eval as cli

    monkeypatch.setattr(jax_clip, "load_clip_model", _jax_tiny)
    monkeypatch.setattr(jax_clip, "init_clip_params",
                        lambda model, rng: tiny_params)
    monkeypatch.setattr(port_clip, "load_clip_model",
                        lambda args, device=None, dtype=None:
                        _port_tiny(tiny_params, device))
    mc = cli_args.model_config
    cache = (tmp_path / "proj" / "extracted_embedding" / mc.dataset
             / mc.model_output_name)

    def report_files(run_dir):
        return {f: (run_dir / "logs" / f).read_text()
                for f in ("accuracy.json", "results.csv", "raw.csv")}

    for name in ("jax", "port_cached"):
        (tmp_path / name).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jax_cli.run(cli_args, out=lambda *_: None)
    jax_files = report_files(tmp_path / "jax")

    cli_args.cfg.merge({"load_inference": True, "device": "cpu"})
    monkeypatch.chdir(tmp_path / "port_cached")
    lines = []
    acc, _, _ = cli.run(cli_args, out=lines.append)
    assert lines[0] == "Loading embeddings from file..."
    assert report_files(tmp_path / "port_cached") == jax_files
    assert acc == json.loads(jax_files["accuracy.json"], object_hook=lambda d: {
        (int(k) if k.isdigit() else k): v for k, v in d.items()})

    # the port end to end, into its own cache folder
    jax_seen, _, jax_keys = cli.load_feature_cache(
        str(cache / "extracted_feature_from_val_split.hdf5"),
        str(cache / "labels_val.json"))
    mc.merge({"model_output_name": "port"})
    cli_args.cfg.merge({"load_inference": False})
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    cli.run(cli_args, out=lambda *_: None)
    port_cache = cache.parent / "port"
    seen, _, keys = cli.load_feature_cache(
        str(port_cache / "extracted_feature_from_val_split.hdf5"),
        str(port_cache / "labels_val.json"))
    assert "all_key_features" in keys and "all_key_features" not in seen
    for ours, theirs in ((seen, jax_seen), (keys, jax_keys)):
        assert ours.keys() == theirs.keys()
        for k in set(ours) - {"label_list", "all_key_features_label"}:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=0,
                                       atol=EMB_ATOL, err_msg=k)
        assert ours["label_list"] == theirs["label_list"]

    extract_embedding.run(cli_args, out=lambda *_: None)
    with h5py.File(port_cache / "extracted_features_of_all_keys.hdf5") as f:
        assert [s.decode() for s in f["species"][()]] == [
            lab["species"] for lab in jax_keys["label_list"]]
        for k in ("encoded_image_feature", "encoded_dna_feature",
                  "encoded_language_feature"):
            np.testing.assert_allclose(f[k][()], jax_keys[k], rtol=0,
                                       atol=EMB_ATOL, err_msg=k)
    assert len(list(port_cache.glob("extracted_features_of_*.hdf5"))) == 9
