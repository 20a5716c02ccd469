"""The port's FLOPs accounting, analysis plots and reference `.pth` export
against the JAX package:
- `utils/flops.py`: every count function equal to JAX's exactly (towers at
  the flagship's and other geometries, the tri-modal sums, each train
  mode), `mfu` and `retrieval_roofline` at the H100's data-sheet peaks;
  the constants `chip_smoke.py` holds the card's counts against equal to
  JAX's counts;
- `utils/viz.py`: `project_2d` (PCA here, no umap) and
  `silhouette_scores` within 1e-6 of JAX's on seeded features, the same
  printed lines and colormap; each plot written as a PNG;
- `interop/torch_export.py`: `save_pth` of a tiny tri-modal model loaded
  from a JAX tree with `state_dict_from_jax` equal to JAX's
  `save_pth(params)` key for key, bit for bit (the model's learnable
  `logit_scale` left out, as JAX leaves it out), and read back by
  `train/checkpoint.load_pth_into_params` into a fresh model bit for bit."""

import jax
import numpy as np
import pytest
import torch

from bioscan_clip_tpu.utils import flops as jax_flops
from bioscan_clip_tpu.utils import viz as jax_viz
from bioscan_clip_tpu_torch.utils import flops, viz
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_flop_counts_match_jax():
    for args in ((197, 768, 3072), (20, 512, 2048, 1), (133, 768, 3072, 3)):
        assert (flops.transformer_layer_flops(*args)
                == jax_flops.transformer_layer_flops(*args))
    assert flops.lora_layer_flops(197, 768, 4) == jax_flops.lora_layer_flops(
        197, 768, 4)
    for name, kw in (("vit_b16", {}), ("vit_b16", dict(num_classes=797,
                                                       lora_rank=0)),
                     ("barcode_bert", {}), ("barcode_bert", dict(layers=2)),
                     ("bert_small", {}), ("bert_small", dict(seq=77))):
        got, ref = getattr(flops, name)(**kw), getattr(jax_flops, name)(**kw)
        assert (got.name, got.fwd, got.lora_fwd) == (ref.name, ref.fwd,
                                                     ref.lora_fwd)
        for mode in ("train_plain", "train_full", "train_gradcache"):
            assert getattr(got, mode)() == getattr(ref, mode)()
    assert (flops.flagship_fwd_flops_per_sample()
            == jax_flops.flagship_fwd_flops_per_sample())
    for mode in ("plain", "gradcache", "full"):
        assert (flops.flagship_train_flops_per_sample(mode)
                == jax_flops.flagship_train_flops_per_sample(mode))
    with pytest.raises(ValueError):
        flops.flagship_train_flops_per_sample("remat")
    f = flops.flagship_train_flops_per_sample("plain")
    assert flops.mfu(400 / 0.425, f) == pytest.approx(400 / 0.425 * f
                                                      / 989e12, rel=1e-15)
    assert flops.mfu(1.0, 67e12, chip="h100_fp32") == pytest.approx(1.0)
    roof = flops.retrieval_roofline(1 << 20)
    ref = jax_flops.retrieval_roofline(1 << 20)
    assert (roof["hbm_bytes"], roof["flops"]) == (ref["hbm_bytes"],
                                                  ref["flops"])
    assert roof["t_hbm_s"] == pytest.approx(ref["hbm_bytes"] / 3.35e12)
    assert roof["t_mxu_s"] == pytest.approx(ref["flops"] / 989e12)


def test_chip_smoke_flop_constants_match_jax():
    import chip_smoke

    vit, dna = jax_flops.vit_b16(), jax_flops.barcode_bert()
    assert chip_smoke.FLOPS_PER_SAMPLE == {
        "plain": jax_flops.flagship_train_flops_per_sample("plain"),
        "gradcache": jax_flops.flagship_train_flops_per_sample("gradcache"),
        "extract": jax_flops.flagship_fwd_flops_per_sample(),
        "vit_full": vit.train_full(),
        "joint_full": vit.train_full() + dna.train_full(),
    }


def features_and_labels(n=48, d=12):
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((4, d)) * 3
    cls = rng.integers(0, 4, size=n)
    x = (centers[cls] + rng.standard_normal((n, d))).astype(np.float32)
    labels = [{"order": f"o{c % 2}", "family": f"f{c % 3}",
               "genus": f"g{c}", "species": f"s{c}_{i % 2}"}
              for i, c in enumerate(cls)]
    return x, labels


def test_projection_and_silhouette_match_jax():
    x, labels = features_and_labels()
    np.testing.assert_allclose(viz.project_2d(x, seed=3),
                               jax_viz.project_2d(x, seed=3), atol=1e-6)
    lines, ref_lines = [], []
    got = viz.silhouette_scores(x, labels, out=lines.append)
    ref = jax_viz.silhouette_scores(x, labels, out=ref_lines.append)
    assert set(got) == set(ref) == {"order", "family", "genus", "species"}
    for level in ref:
        assert got[level] == pytest.approx(ref[level], abs=1e-6)
    assert lines == ref_lines
    one = [dict(d, order="o0") for d in labels]  # a level of one class
    assert "order" not in viz.silhouette_scores(x, one, out=lambda *_: None)
    np.testing.assert_array_equal(viz.categorical_cmap(3, 4).colors,
                                  jax_viz.categorical_cmap(3, 4).colors)
    with pytest.raises(ValueError, match="Too many"):
        viz.categorical_cmap(11, 2)


def test_plots_are_written(tmp_path):
    x, labels = features_and_labels()
    emb = viz.plot_embeddings(x, labels, level="genus",
                              filters={"order": "o0"},
                              out_path=str(tmp_path / "a" / "emb.png"))
    assert emb.endswith("emb.png")
    assert viz.plot_embeddings(x[:2], labels[:2], out_path="x") is None
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 255, size=(2, 4, 8, 8, 3), dtype=np.uint8)
    grid = viz.plot_retrieval_grid(list(imgs[0]), [list(imgs[1][:3])] * 4,
                                   np.eye(4, 3, dtype=bool),
                                   out_path=str(tmp_path / "grid.png"))
    gt = [d["species"] for d in labels]
    cm = viz.plot_confusion_matrix(gt, gt[::-1], str(tmp_path / "cm.png"))
    assert viz.plot_confusion_matrix(["a"], ["b"]) is None
    for p in (emb, grid, cm):
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_export_matches_jax(tmp_path):
    from bioscan_clip_tpu.interop import torch_export as jax_export
    from bioscan_clip_tpu.models.clip import init_clip_params
    from bioscan_clip_tpu_torch.interop import torch_export
    from bioscan_clip_tpu_torch.train.checkpoint import load_pth_into_params
    from bioscan_clip_tpu_torch.train.loop import make_logit_scale_param
    from test_torch_eval import _jax_tiny, _port_tiny
    from test_torch_fine_tuning import seeded_like

    params = seeded_like(jax.eval_shape(
        lambda: init_clip_params(_jax_tiny(), jax.random.PRNGKey(0))))
    model = make_logit_scale_param(_port_tiny(params))
    assert "logit_scale" in model.state_dict()
    got = torch.load(torch_export.save_pth(model, str(tmp_path / "p.pth")))
    ref = torch.load(jax_export.save_pth(dict(params, logit_scale=np.zeros(
        (), np.float32)), str(tmp_path / "j.pth")))
    assert sorted(got) == sorted(ref) and len(got) == 82
    for k, v in ref.items():
        assert got[k].dtype == v.dtype == torch.float32, k
        assert got[k].shape == v.shape and torch.equal(got[k], v), k
    fresh = _port_tiny(seeded_like(jax.eval_shape(
        lambda: init_clip_params(_jax_tiny(), jax.random.PRNGKey(0))),
        seed=1))
    load_pth_into_params(str(tmp_path / "p.pth"), fresh)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, got[k]), k
