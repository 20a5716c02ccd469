"""Port top-k (bioscan_clip_tpu_torch/ops/topk.py, engine.topk_search)
against the JAX Pallas top-k in interpret mode, on the same numpy inputs.

Tolerances: values atol 1e-6 (both sides are fp32 dots of <= 32 terms with
|score| <= 1, differing only in summation order); indices equal wherever
neighbouring values differ by more than 1e-5, since a closer pair is a
near-tie that summation order may break either way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioscan_clip_tpu.ops.topk_pallas import pallas_topk, topk_search_pallas
from bioscan_clip_tpu.retrieval.engine import l2norm_np
from bioscan_clip_tpu_torch.ops import topk as topk_mod

VAL_ATOL = 1e-6
TIE = 1e-5


def _assert_same(vals, idx, ref_vals, ref_idx):
    vals, ref_vals = np.asarray(vals), np.asarray(ref_vals)
    np.testing.assert_allclose(vals, ref_vals, atol=VAL_ATOL)
    gap = np.full(vals.shape, np.inf, np.float32)
    gap[:, 1:] = np.abs(np.diff(ref_vals, axis=1))
    gap[:, :-1] = np.minimum(gap[:, :-1], np.abs(np.diff(ref_vals, axis=1)))
    clear = gap > TIE
    np.testing.assert_array_equal(np.asarray(idx)[clear],
                                  np.asarray(ref_idx)[clear])


def _port(q, ks, n_valid, k, precision="high"):
    v, i = topk_mod.topk(torch.from_numpy(q), torch.from_numpy(ks),
                         n_valid, k, precision=precision)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    return v.numpy(), i.numpy()


def _ascending_keys(n, d, rng):
    """Scores against e0 strictly ascend with the key index: every tile
    improves the running top-k (the TPU merge's worst case)."""
    u = np.zeros(d, np.float32)
    u[0] = 1.0
    v = np.zeros(d, np.float32)
    v[1] = 1.0
    ang = np.linspace(1.55, 0.001, n).astype(np.float32)
    ks = np.cos(ang)[:, None] * u + np.sin(ang)[:, None] * v
    ks[:, 2:] += 0.001 * rng.standard_normal((n, d - 2)).astype(np.float32)
    return l2norm_np(ks)


@pytest.mark.parametrize("n_keys", [100, 1300])
def test_random_keys(n_keys):
    rng = np.random.default_rng(n_keys)
    q = l2norm_np(rng.standard_normal((16, 32)).astype(np.float32))
    ks = l2norm_np(rng.standard_normal((n_keys, 32)).astype(np.float32))
    ref = topk_search_pallas(q, ks, 5, tile=256, interpret=True)
    _assert_same(*_port(q, ks, n_keys, 5), *ref)


def test_n_valid_padding():
    """Rows at index >= n_valid never enter, even when they would win."""
    rng = np.random.default_rng(1)
    q = l2norm_np(rng.standard_normal((8, 32)).astype(np.float32))
    ks = l2norm_np(rng.standard_normal((512, 32)).astype(np.float32))
    ks[300:] = q[0]  # padding rows that would score 1.0 for query 0
    ref = pallas_topk(jnp.asarray(q), jnp.asarray(ks), 300, k=5, tile=128,
                      q_block=8, interpret=True)
    vals, idx = _port(q, ks, 300, 5)
    _assert_same(vals, idx, *ref)
    assert idx.max() < 300


def test_all_negative_scores():
    rng = np.random.default_rng(2)
    q = np.ones((4, 16), np.float32)
    ks = -np.abs(rng.standard_normal((100, 16)).astype(np.float32))
    ref = topk_search_pallas(q, ks, 3, tile=64, interpret=True)
    vals, idx = _port(q, ks, 100, 3)
    assert (vals < 0).all()
    _assert_same(vals, idx, *ref)


def test_k_crossing_a_tile():
    """k=20 is larger than the JAX kernel's 16-key tile: the running top-k
    carries winners across tiles."""
    rng = np.random.default_rng(13)
    q = l2norm_np(rng.standard_normal((4, 24)).astype(np.float32))
    ks = l2norm_np(rng.standard_normal((100, 24)).astype(np.float32))
    ref = topk_search_pallas(q, ks, 20, tile=16, interpret=True)
    vals, idx = _port(q, ks, 100, 20)
    _assert_same(vals, idx, *ref)
    assert all(len(set(row)) == 20 for row in idx)


def test_sorted_ascending_keys():
    rng = np.random.default_rng(10)
    ks = _ascending_keys(512, 32, rng)
    q = l2norm_np(np.eye(1, 32, dtype=np.float32)
                  + 0.01 * rng.standard_normal((8, 32)).astype(np.float32))
    ref = topk_search_pallas(q, ks, 5, tile=64, interpret=True)
    vals, idx = _port(q, ks, 512, 5)
    _assert_same(vals, idx, *ref)
    assert (np.diff(vals, axis=1) <= 0).all()


def test_ties_take_the_smaller_index():
    """All keys equal: the winners are the k earliest indices, in order."""
    row = l2norm_np(np.ones((1, 16), np.float32))
    ks = np.repeat(row, 300, axis=0)
    q = np.repeat(row, 4, axis=0)
    _, idx = _port(q, ks, 300, 5)
    np.testing.assert_array_equal(idx, np.tile(np.arange(5), (4, 1)))


def test_numpy_wrapper_and_engine_match_jax_engine():
    from bioscan_clip_tpu.retrieval import engine as jax_engine
    from bioscan_clip_tpu_torch.retrieval import engine

    rng = np.random.default_rng(3)
    q = l2norm_np(rng.standard_normal((5, 32)).astype(np.float32))
    ks = l2norm_np(rng.standard_normal((200, 32)).astype(np.float32))
    ref = jax_engine.topk_search(q, ks, 4)
    _assert_same(*engine.topk_search(q, ks, 4, device="cpu"), *ref)
    pk = engine.PreparedKeys(ks, device="cpu")
    sims, idx = engine.topk_search(q, pk, 4)
    assert idx.dtype == np.int64
    _assert_same(sims, idx, *ref)


def test_records_and_predictions_match_jax_engine():
    """find_k_closest_records and make_prediction (raw, unnormalized
    features in; labels, similarities and indices out) equal the JAX
    engine's."""
    from bioscan_clip_tpu.retrieval import engine as jax_engine
    from bioscan_clip_tpu_torch.retrieval import engine

    rng = np.random.default_rng(4)
    keys = 3.0 * rng.standard_normal((60, 32)).astype(np.float32)
    queries = keys[[5, 41, 17]] + 0.1 * rng.standard_normal((3, 32)).astype(
        np.float32)
    names = [f"k{i}" for i in range(60)]
    labels = [{"order": f"o{i % 3}", "family": f"f{i % 5}",
               "genus": f"g{i % 7}", "species": f"s{i}"} for i in range(60)]
    assert engine.find_k_closest_records(
        ["a", "b", "c"], queries, names, keys, k=3, device="cpu"
    ) == jax_engine.find_k_closest_records(["a", "b", "c"], queries, names,
                                           keys, k=3)
    preds, sims, idx = engine.make_prediction(
        queries, keys, labels, with_similarity=True, with_indices=True,
        max_k=4, device="cpu")
    ref_preds, ref_sims, ref_idx = jax_engine.make_prediction(
        queries, keys, labels, with_similarity=True, with_indices=True,
        max_k=4)
    assert preds == ref_preds
    assert [p["species"][0] for p in preds] == ["s5", "s41", "s17"]
    _assert_same(sims, idx, ref_sims, ref_idx)


def test_int8_mesh_and_streaming_raise():
    """int8 keys and "default" precision are ported (tests/test_torch_int8.py
    and above), and so are sharded keys (tests/test_torch_parallel.py): a
    mesh of two CPU entries gives the unsharded search, for every
    precision; what is not a `parallel.mesh.Mesh` raises, and so do an
    unknown precision and rescore mode."""
    from bioscan_clip_tpu_torch.parallel.mesh import create_mesh
    from bioscan_clip_tpu_torch.retrieval import engine

    ks = np.eye(4, 64, dtype=np.float32)
    assert engine.PreparedKeys(ks, device="cpu", precision="int8").int8
    pk = engine.PreparedKeys(ks, device="cpu", precision="default")
    assert not pk.int8 and pk.shards[0].keys.dtype == torch.float32
    q = ks[:3] + 0.1 * ks[1:]
    for precision in ("high", "default", "int8"):
        ref = engine.topk_search(q, ks, 2, device="cpu", precision=precision)
        got = engine.topk_search(q, ks, 2, precision=precision,
                                 mesh=create_mesh(devices=["cpu"] * 2))
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_array_equal(got[0], ref[0])
        with pytest.raises(TypeError):
            engine.PreparedKeys(ks, device="cpu", precision=precision,
                                mesh=object())
    for precision in ("fp16", "bf16"):
        with pytest.raises(ValueError):
            engine.PreparedKeys(ks, device="cpu", precision=precision)
    with pytest.raises(ValueError, match="precision"):
        topk_mod.topk(torch.ones(2, 32), torch.ones(8, 32), 8, 2,
                      precision="fp16")
    with pytest.raises(ValueError):
        engine.PreparedKeys(ks, device="cpu", precision="int8",
                            rescore="fp16")



def _bf16(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


def test_default_precision_matches_jax_on_bf16_operands():
    """precision="default", the TPU's single bf16 pass (`Precision.DEFAULT`
    in `pallas_topk`: operands rounded to bf16, products summed in fp32).
    XLA:CPU does not emulate that pass, so the witness is JAX
    `_topk_kernel` at HIGHEST on operands already rounded to bf16
    (`pallas_topk(precision="high")` in interpret mode), with the
    tolerance and near-tie rule of `_assert_same` (bf16 products are exact
    in fp32, so the two sides differ only in summation order). The port's
    "default" keeps the TPU's semantics on both devices: on the CPU it
    therefore differs from JAX's own XLA:CPU scan, which computes "default"
    in full fp32. Then `PreparedKeys(precision="default")` and
    `topk_search` on the CPU against `topk_search_pallas` on the same
    rounded operands."""
    from bioscan_clip_tpu_torch.retrieval import engine

    rng = np.random.default_rng(21)
    q = l2norm_np(rng.standard_normal((16, 64)).astype(np.float32))
    ks = l2norm_np(rng.standard_normal((384, 64)).astype(np.float32))
    ks[280:] = q[0]  # rows past n_valid that would win for query 0
    ref = pallas_topk(jnp.asarray(_bf16(q)), jnp.asarray(_bf16(ks)), 280,
                      k=5, tile=128, q_block=8, interpret=True)
    calls = topk_mod.topk_reference.calls
    vals, idx = _port(q, ks, 280, 5, precision="default")
    assert topk_mod.topk_reference.calls == calls + 1
    _assert_same(vals, idx, *ref)
    assert idx.max() < 280
    assert not np.array_equal(vals, _port(q, ks, 280, 5)[0])

    ref = topk_search_pallas(_bf16(q), _bf16(ks[:280]), 4, tile=128,
                             interpret=True)
    pk = engine.PreparedKeys(ks[:280], device="cpu", precision="default",
                             normalized=True)
    sims, idx = engine.topk_search(q, pk, 4)
    assert idx.dtype == np.int64
    _assert_same(sims, idx, *ref)
    _assert_same(*engine.topk_search(q, ks[:280], 4, device="cpu",
                                     precision="default"), *ref)


def test_default_precision_reaches_the_service_and_the_sweep(monkeypatch):
    """`serve.key_precision=default` (RetrievalService) and
    `inference_and_eval_setting.retrieval_precision=default` (the 5x6
    sweep) search in K4's single bf16 pass on the CPU: the service's
    similarities against JAX `pallas_topk` at HIGHEST on the bf16-rounded
    normalized operands (interpret mode), and every key set of the sweep
    prepared in "default" precision."""
    from bioscan_clip_tpu_torch.models.clip import MultiModalCLIP
    from bioscan_clip_tpu_torch.retrieval import report
    from bioscan_clip_tpu_torch.retrieval.service import RetrievalService

    rng = np.random.default_rng(22)
    keys = 2.0 * rng.standard_normal((300, 32)).astype(np.float32)
    labels = [{"order": f"o{i % 3}", "family": f"f{i % 7}",
               "genus": f"g{i % 31}", "species": f"s{i}"} for i in range(300)]
    queries = keys[[3, 99, 250]] + 0.3 * rng.standard_normal(
        (3, 32)).astype(np.float32)
    svc = RetrievalService(MultiModalCLIP(), keys=keys, key_labels=labels,
                           device="cpu", max_k=4, key_precision="default")
    assert svc.prepared.precision == "default"
    out = svc.search(embeddings=queries, k=4)
    ref_sims, ref_idx = topk_search_pallas(
        _bf16(l2norm_np(queries)), _bf16(l2norm_np(keys)), 4, tile=128,
        interpret=True)
    np.testing.assert_allclose(out["similarities"], ref_sims, atol=VAL_ATOL)
    assert [p["species"] for p in out["predictions"]] == [
        [labels[j]["species"] for j in row] for row in ref_idx]
    assert [p["species"][0] for p in out["predictions"]] == ["s3", "s99",
                                                              "s250"]

    seen = []
    real = report.PreparedKeys

    def spy(*args, **kwargs):
        seen.append(kwargs.get("precision"))
        return real(*args, **kwargs)

    monkeypatch.setattr(report, "PreparedKeys", spy)
    split = dict(image=keys[:60], dna=keys[60:120], language=keys[120:180],
                 label_list=labels[:60],
                 file_name_list=[f"r{i}" for i in range(60)])
    args = type("Args", (), {"inference_and_eval_setting": type(
        "IES", (), {"retrieval_precision": "default"})()})()
    acc, _, _ = report.inference_and_print_result(
        report.build_split_dict(**split, for_key_set=True),
        report.build_split_dict(**split), report.build_split_dict(**split),
        args=args, k_list=[1], device="cpu", out=lambda *_: None)
    assert seen and set(seen) == {"default"}
    assert acc["encoded_image_feature"]["encoded_image_feature"]["seen"][
        "micro_acc"][1]["species"] == 1.0
