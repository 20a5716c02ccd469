"""The port's numpy copies of the routing methods and BZSL, and its method 1
and method 2 CLIs, against the JAX package on the same inputs:
- `retrieval/methods.py` on seeded random predictions, similarities and
  labels: the routed predictions, the searched threshold, the micro/macro
  accuracies and the printed rows equal JAX's;
- `retrieval/bzsl.py`: the class means and the two transposed CSVs equal;
- `retrieval/bzsl_classifier.py` on seeded Gaussian classes: the log
  posterior-predictive within rtol 1e-6 (the same numpy and scipy calls:
  equal in practice), the predictions, the seen/unseen/harmonic accuracy
  and the tuned parameters equal;
- `cli/method_one_eval.run` and `cli/method_two_fine_tuning_and_eval.run`
  (`device="cpu"`) on `tests/fixtures.build_synthetic_dataset` with the
  tiny tri-modal model of `tests/test_torch_eval.py` on the weights JAX's
  CLIs initialize, against JAX's CLIs: the same embeddings (1e-5) give
  the same threshold, routed predictions and accuracies. Method 2 runs its
  fine-tune for 0 epochs there, its head holding JAX's initial head (JAX's
  fine-tune reads `image_u8` from train_seen, an eval loader that ships
  host-transformed `image` by default); one port epoch then trains it on
  those float images."""

import sys
import types

import numpy as np
import pytest

from bioscan_clip_tpu.retrieval import bzsl as jax_bzsl
from bioscan_clip_tpu.retrieval import bzsl_classifier as jax_bc
from bioscan_clip_tpu.retrieval import methods as jax_methods
from bioscan_clip_tpu.train.loop import make_embed_step as jax_make_embed_step
from bioscan_clip_tpu_torch.retrieval import bzsl, bzsl_classifier as bc
from bioscan_clip_tpu_torch.retrieval import methods
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

LEVELS = ["order", "family", "genus", "species"]


def random_split(rng, n, k=5, n_species=6):
    def labels(s):
        return {"order": f"o{s % 2}", "family": f"f{s % 3}",
                "genus": f"g{s % 4}", "species": f"s{s}"}

    def pred():
        ss = rng.integers(0, n_species, size=k)
        return {lvl: [labels(s)[lvl] for s in ss] for lvl in LEVELS}

    return {
        "pred_labels_from_search_with_seen_keys": [pred() for _ in range(n)],
        "pred_similarity_from_search_with_seen_keys":
            rng.random((n, k)).tolist(),
        "pred_labels_from_search_with_unseen_keys": [pred()
                                                     for _ in range(n)],
        "gt_label": [labels(s) for s in rng.integers(0, n_species, size=n)],
    }


def test_methods_match_jax():
    rng = np.random.default_rng(0)
    seen, unseen = random_split(rng, 40), random_split(rng, 30)
    args = (seen["pred_labels_from_search_with_seen_keys"],
            seen["pred_similarity_from_search_with_seen_keys"],
            seen["pred_labels_from_search_with_unseen_keys"], 0.4)
    assert (methods.decide_prediction_with_threshold(*args)
            == jax_methods.decide_prediction_with_threshold(*args))
    for vals in ([0.5, 0.25], [0.3, 0.0], [1.0, 0.7, 0.2]):
        assert (methods.harmonic_mean_list(vals)
                == jax_methods.harmonic_mean_list(vals))
    got_lines, ref_lines = [], []
    got = methods.method_1_eval(seen, unseen, num_intervals=101,
                                out=got_lines.append)
    ref = jax_methods.method_1_eval(seen, unseen, num_intervals=101,
                                    out=ref_lines.append)
    assert got == ref
    methods.print_acc_for_google_doc(*got, out=got_lines.append)
    jax_methods.print_acc_for_google_doc(*ref, out=ref_lines.append)
    assert got_lines == ref_lines and len(got_lines) == 7
    kw = dict(best_threshold=0.7, k_list=[1, 3])
    assert (methods.get_final_pred_and_acc(*args[:3], seen["gt_label"], **kw)
            == jax_methods.get_final_pred_and_acc(*args[:3],
                                                  seen["gt_label"], **kw))
    final = got[0]["final_pred_labels"]
    for fn in (methods, jax_methods):
        lines = []
        fn.check_for_acc_about_correct_predict_seen_or_unseen(
            final, ["s1", "s2"], out=lines.append)
        got_lines.append(lines)
    assert got_lines[-1] == got_lines[-2]


def test_bzsl_export_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((30, 8)).astype(np.float32)
    labels = rng.integers(0, 5, size=30)
    np.testing.assert_array_equal(
        bzsl.class_averaged_embeddings(feats, labels),
        jax_bzsl.class_averaged_embeddings(feats, labels))
    img = rng.standard_normal((30, 8)).astype(np.float32)
    got = bzsl.export_bzsl_csvs(str(tmp_path / "port"), feats, img, labels,
                                out=lambda *_: None)
    ref = jax_bzsl.export_bzsl_csvs(str(tmp_path / "jax"), feats, img,
                                    labels, out=lambda *_: None)
    for a, b in zip(got, ref):
        with open(a) as fa, open(b) as fb:
            assert fa.read() == fb.read()
    assert np.loadtxt(got[0], delimiter=",").shape == (8, 5)


def gaussian_classes(rng, n_classes=8, per=12, d=6):
    means = rng.standard_normal((n_classes, d)) * 3
    x = np.concatenate([m + rng.standard_normal((per, d)) for m in means])
    y = np.repeat(np.arange(n_classes), per)
    dna = {c: means[c] + 0.1 * rng.standard_normal(d)
           for c in range(n_classes)}
    return x, y, dna


def test_bzsl_classifier_matches_jax():
    rng = np.random.default_rng(2)
    x, y, dna = gaussian_classes(rng)
    unseen = [6, 7]
    fit = y < 6
    p = bc.BZSLParams(kappa_0=0.5, K=3)
    got = bc.BZSLClassifier(p).fit(x[fit], y[fit], dna, unseen)
    ref = jax_bc.BZSLClassifier(jax_bc.BZSLParams(kappa_0=0.5, K=3)).fit(
        x[fit], y[fit], dna, unseen)
    assert got.classes_ == ref.classes_
    np.testing.assert_allclose(got.log_ppd(x), ref.log_ppd(x), rtol=1e-6)
    pred = got.predict(x)
    np.testing.assert_array_equal(pred, ref.predict(x))
    assert (bc.seen_unseen_harmonic_accuracy(y, pred, unseen)
            == jax_bc.seen_unseen_harmonic_accuracy(y, pred, unseen))
    grid = {"kappa_0": [0.1, 1.0], "kappa_1": [10.0], "m_offset": [5.0],
            "s": [0.5, 1.0], "K": [2]}
    tuned = bc.tune_hyperparameters(x[fit], y[fit], dna, grid=grid)
    ref_tuned = jax_bc.tune_hyperparameters(x[fit], y[fit], dna, grid=grid)
    assert vars(tuned[0]) == vars(ref_tuned[0])
    assert tuned[1] == ref_tuned[1]


# ------------------------------------------------------ method 1 and 2 CLIs


@pytest.fixture(scope="module")
def dataset_path(tmp_path_factory):
    from test_torch_train_loader import build_fixture

    p = tmp_path_factory.mktemp("methods") / "synthetic.hdf5"
    # 6 species: method 2 takes the classifier's top 5
    return build_fixture(str(p), n_classes=6, per_class=6)


@pytest.fixture(scope="module")
def tiny_params():
    """Seeded weights in the shapes of the tiny model's init (traced,
    not compiled)."""
    import jax

    from bioscan_clip_tpu.models.clip import init_clip_params
    from test_torch_eval import _jax_tiny
    from test_torch_fine_tuning import seeded_like

    return seeded_like(jax.eval_shape(
        lambda: init_clip_params(_jax_tiny(), jax.random.PRNGKey(0))))


@pytest.fixture(scope="module")
def jax_embed_steps():
    """JAX `make_embed_step`, memoized for the module: the tiny model's
    steps are the same functions in every CLI run of this file."""
    steps = {}

    def make(model, mesh, modality, openclip_norm=False, pre_cropped=False):
        key = (model, modality, openclip_norm, pre_cropped)
        if key not in steps:
            steps[key] = jax_make_embed_step(model, mesh, modality,
                                             openclip_norm, pre_cropped)
        return steps[key]

    return make


@pytest.fixture
def method_args(dataset_path, tiny_params, jax_embed_steps, tmp_path,
                monkeypatch):
    """(JAX args, port args) on the synthetic dataset, both packages'
    `load_clip_model` giving the tiny model on `tiny_params`."""
    import jax

    import bioscan_clip_tpu.models.clip as jax_clip
    import bioscan_clip_tpu.parallel.mesh as jax_mesh
    import bioscan_clip_tpu.train.loop as jax_loop
    import bioscan_clip_tpu_torch.models.clip as port_clip
    from bioscan_clip_tpu_torch.config.core import ConfigNode
    from test_torch_eval import _jax_tiny, _port_tiny
    from tests.fixtures import SyntheticArgs

    monkeypatch.setattr(jax_clip, "load_clip_model", _jax_tiny)
    monkeypatch.setattr(jax_clip, "init_clip_params",
                        lambda model, rng: tiny_params)
    monkeypatch.setattr(port_clip, "load_clip_model",
                        lambda args, device=None, dtype=None:
                        _port_tiny(tiny_params, device))
    # JAX's CLIs on one device, each embed step jitted once per file: their
    # SPMD compiles and per-call re-jits are not the subject
    real_mesh = jax_mesh.create_mesh
    monkeypatch.setattr(jax_mesh, "create_mesh", lambda *a, **kw: real_mesh(
        devices=jax.devices()[:1]))
    monkeypatch.setattr(jax_loop, "make_embed_step", jax_embed_steps)
    # no checkpoint is read here: JAX's CLIs get the two names they import
    # from train/checkpoint without the module's ~6 s import of orbax
    ckpt = types.ModuleType("bioscan_clip_tpu.train.checkpoint")

    def unused(*_a, **_kw):
        raise AssertionError("no checkpoint is read in these runs")

    ckpt.load_pth_into_params = ckpt.resolve_reference_ckpt = unused
    monkeypatch.setitem(sys.modules, ckpt.__name__, ckpt)
    jax_args = SyntheticArgs(dataset_path, batch_size=8)
    jax_args.cfg.merge({
        "project_root_path": str(tmp_path),
        "inference_and_eval_setting": {"k_list": [1, 3, 5]},
    })
    jax_args.cfg.model_config.merge({"load_ckpt": False, "output_dim": 32})
    port_args = ConfigNode(dict(jax_args.cfg))
    port_args["device"] = "cpu"
    return jax_args, port_args


def assert_same_outputs(got, ref):
    for a, b in zip(got, ref):
        assert a["best_threshold"] == pytest.approx(b["best_threshold"],
                                                    abs=1e-12)
        assert a["final_pred_labels"] == b["final_pred_labels"]
        assert a["gt_labels"] == b["gt_labels"]
        assert a["micro_acc"] == b["micro_acc"]
        assert a["macro_acc"] == b["macro_acc"]


def test_method_one_cli_matches_jax(method_args):
    from bioscan_clip_tpu.cli import method_one_eval as jax_m1
    from bioscan_clip_tpu_torch.cli import method_one_eval as m1

    jax_args, port_args = method_args
    ref_lines, lines = [], []
    ref = jax_m1.run(jax_args, out=ref_lines.append, num_intervals=1000)
    got = m1.run(port_args, out=lines.append, num_intervals=1000)
    assert_same_outputs(got, ref)
    assert ([ln for ln in lines if ln[:1] in " b"]
            == [ln for ln in ref_lines if ln[:1] in " b"])
    assert len(got[0]["gt_labels"]) == 18  # val_seen: 6 classes x 3


def test_method_two_cli_matches_jax(method_args, tiny_params, monkeypatch):
    import jax
    import torch

    import bioscan_clip_tpu_torch.models.clip as port_clip
    from bioscan_clip_tpu.cli import method_two_fine_tuning_and_eval as jax_m2
    from bioscan_clip_tpu.models.heads import EncoderWithHead
    from bioscan_clip_tpu_torch.cli import (
        method_two_fine_tuning_and_eval as m2,
    )
    from test_torch_fine_tuning import seeded_like

    jax_args, port_args = method_args
    # JAX's classifier init gives seeded weights in its shapes (traced,
    # not compiled: op by op it dispatches ~100 small compiles), kept: its
    # head goes into the port's head
    inits = []
    real_head_init = EncoderWithHead.init

    def seeded_init(self, rng, x):
        inits.append(seeded_like(jax.eval_shape(
            lambda: real_head_init(self, rng, x)), seed=1))
        return inits[-1]

    monkeypatch.setattr(EncoderWithHead, "init", seeded_init)
    ref = jax_m2.run(jax_args, out=lambda *_: None, fine_tune_epochs=0)
    # JAX's initial head over the 6 seen species, into the port's head
    (init,) = inits
    head = init["params"]["new_linear_layer"]
    real_init = port_clip.init_weights

    def init_weights(model, seed=0):
        if isinstance(model, torch.nn.Linear) and model.out_features == 6:
            with torch.no_grad():
                model.weight.copy_(torch.from_numpy(
                    np.asarray(head["kernel"]).T.copy()))
                model.bias.copy_(torch.from_numpy(np.asarray(head["bias"])))
            return model
        return real_init(model, seed)

    monkeypatch.setattr(port_clip, "init_weights", init_weights)
    lines = []
    got = m2.run(port_args, out=lines.append, fine_tune_epochs=0)
    assert_same_outputs(got, ref)
    assert any(ln.startswith("best threshold") for ln in lines)

    lines = []
    trained = m2.run(port_args, out=lines.append, fine_tune_epochs=1)
    loss = float(next(ln for ln in lines if ln.startswith("epoch 0"))
                 .split()[-1])
    assert np.isfinite(loss)
    assert 0.0 <= trained[1]["micro_acc"][1]["species"] <= 1.0
