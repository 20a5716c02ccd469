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


def _port(q, ks, n_valid, k):
    v, i = topk_mod.topk(torch.from_numpy(q), torch.from_numpy(ks),
                         n_valid, k)
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
    _assert_same(*topk_mod.topk_search_kernel(q, ks, 4, device="cpu"), *ref)
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
    """int8 keys are ported (tests/test_torch_int8.py); a multi-GPU mesh
    still raises, for fp32 and int8 keys alike, and so do an unknown
    precision and rescore mode."""
    from bioscan_clip_tpu_torch.retrieval import engine

    ks = np.eye(4, 64, dtype=np.float32)
    assert engine.PreparedKeys(ks, device="cpu", precision="int8").int8
    for precision in ("high", "int8"):
        with pytest.raises(NotImplementedError):
            engine.PreparedKeys(ks, device="cpu", precision=precision,
                                mesh=object())
    with pytest.raises(ValueError):
        engine.PreparedKeys(ks, device="cpu", precision="default")
    with pytest.raises(ValueError):
        engine.PreparedKeys(ks, device="cpu", precision="int8",
                            rescore="fp16")

