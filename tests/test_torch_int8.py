"""Port int8 retrieval (kernel K5's plain version, `ops/topk.py`; int8
`PreparedKeys` and the rescore modes, `retrieval/engine.py`; the int8
service) against the JAX package on the same numpy inputs. The JAX Pallas
kernel `pallas_topk_i8` runs in interpret mode.

Tolerances: the int8 scores are exact integer dots times two fp32 scales
multiplied in the same order, so the plain version equals the JAX kernel
bit for bit (values and indices, on data without ties: JAX leaves the order
of equal values unspecified). The rescore is the same numpy einsum over the
same fp32 rows (bf16 rows rounded to nearest even on both sides), so its
similarities agree to 1e-6 (found bit-equal) and its indices exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioscan_clip_tpu.ops.topk_pallas import (
    pallas_topk_i8,
    quantize_rows_i8 as jax_quantize,
)
from bioscan_clip_tpu.retrieval import engine as jax_engine
from bioscan_clip_tpu.retrieval.engine import l2norm_np
from bioscan_clip_tpu_torch.ops import topk as topk_mod
from bioscan_clip_tpu_torch.retrieval import engine
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SIM_ATOL = 1e-6
TILE = 512


def _unit(rng, n, d):
    return l2norm_np(rng.standard_normal((n, d)).astype(np.float32))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def test_quantize_rows_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    x = 3.0 * rng.standard_normal((300, 64)).astype(np.float32)
    x[7] = 0.0  # a zero row: scale 1, all-zero codes
    x[9] = x[8]  # a duplicate row
    codes, scales = topk_mod.quantize_rows_i8(x)
    ref_codes, ref_scales = jax_quantize(x)
    assert codes.dtype == np.int8 and scales.shape == (300, 1)
    np.testing.assert_array_equal(codes, ref_codes)
    np.testing.assert_array_equal(_bits(scales), _bits(ref_scales))
    assert scales[7, 0] == 1.0 and not codes[7].any()


def _jax_topk_i8(q8, qs, k8, ks, n_valid, k):
    """pallas_topk_i8 in interpret mode on tile-padded keys and a
    32-row-padded query block, as the JAX engine calls it."""
    n, d = k8.shape
    n_pad = -(-n // TILE) * TILE
    kp = np.zeros((n_pad, d), np.int8)
    kp[:n] = k8
    ksp = np.ones((1, n_pad), np.float32)
    ksp[0, :n] = ks[:, 0]
    bq = q8.shape[0]
    bp = -(-bq // 32) * 32
    qp = np.zeros((bp, d), np.int8)
    qp[:bq] = q8
    qsp = np.ones((bp, 1), np.float32)
    qsp[:bq] = qs
    v, i = pallas_topk_i8(jnp.asarray(qp), jnp.asarray(qsp), jnp.asarray(kp),
                          jnp.asarray(ksp), n_valid, k=k, tile=TILE,
                          q_block=bp, interpret=True)
    return np.asarray(v)[:bq], np.asarray(i)[:bq]


@pytest.mark.parametrize("bq,k,n,n_valid", [
    (1, 1, 2500, 2500),
    (7, 5, 2500, 2400),
    (64, 21, 2500, 2500),
    (7, 37, 100, 37),  # k = n_valid: every valid key comes back
])
def test_plain_version_bit_equal_to_jax_kernel(bq, k, n, n_valid):
    rng = np.random.default_rng(bq + k)
    keys, q = _unit(rng, n, 64), _unit(rng, bq, 64)
    k8, ks = topk_mod.quantize_rows_i8(keys)
    q8, qs = topk_mod.quantize_rows_i8(q)
    before = topk_mod.topk_i8_reference.calls
    v, i = topk_mod.topk_i8(torch.from_numpy(q8), torch.from_numpy(qs[:, 0]),
                            torch.from_numpy(k8), torch.from_numpy(ks[:, 0]),
                            n_valid, k)
    assert topk_mod.topk_i8_reference.calls == before + 1
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    ref_v, ref_i = _jax_topk_i8(q8, qs, k8, ks, n_valid, k)
    np.testing.assert_array_equal(_bits(v.numpy()), _bits(ref_v))
    np.testing.assert_array_equal(i.numpy(), ref_i)
    assert i.numpy().max() < n_valid


def _search_i8(q, keys, k):
    k8, ks = topk_mod.quantize_rows_i8(keys)
    q8, qs = topk_mod.quantize_rows_i8(q)
    v, i = topk_mod.topk_i8(torch.from_numpy(q8), torch.from_numpy(qs[:, 0]),
                            torch.from_numpy(k8), torch.from_numpy(ks[:, 0]),
                            keys.shape[0], k)
    return v.numpy(), i.numpy(), _jax_topk_i8(q8, qs, k8, ks, keys.shape[0],
                                              k)


def test_ties_duplicates_and_zero_rows_take_the_smaller_index():
    """Quantized scores tie often. Duplicate keys score alike and come back
    in index order; zero rows (scale 1, zero codes) score exactly 0. JAX
    returns the same values and, where values tie, the same index set."""
    rng = np.random.default_rng(3)
    keys = _unit(rng, 200, 64)
    keys[50:55] = keys[10]
    v, i, (ref_v, ref_i) = _search_i8(keys[[10]], keys, 6)
    np.testing.assert_array_equal(i[0], [10, 50, 51, 52, 53, 54])
    assert len(set(v[0].tolist())) == 1
    np.testing.assert_array_equal(_bits(v), _bits(ref_v))
    assert set(ref_i[0]) == set(i[0])

    zeros = np.zeros((40, 64), np.float32)
    zeros[:8] = -_unit(rng, 1, 64)  # the first 8 keys score below 0
    q = -zeros[:1]
    v, i, (ref_v, ref_i) = _search_i8(q, zeros, 5)
    np.testing.assert_array_equal(i[0], [8, 9, 10, 11, 12])
    np.testing.assert_array_equal(v[0], np.zeros(5, np.float32))
    np.testing.assert_array_equal(_bits(v), _bits(ref_v))
    assert set(ref_i[0]) <= set(range(8, 40))


def _screen_case(case, rng):
    """The card tests' inputs for K5's threshold screen, at N = 1000 and D =
    64: (query codes, scales, key codes, scales, n_valid). "rising":
    collinear keys whose scales rise with the index, so u-like queries score
    higher on every later key and -u-like ones lower; "duplicates": blocks
    of identical keys whose equal scores straddle the k-th place."""
    n = 1000
    if case == "rising":
        u = _unit(rng, 1, 64)
        u8, us = topk_mod.quantize_rows_i8(u)
        k8 = np.repeat(u8, n, axis=0)
        ks = (us[0, 0] * (np.float32(1) + np.arange(n, dtype=np.float32)
                          / np.float32(n)))[:, None].astype(np.float32)
        noise = 0.05 * rng.standard_normal((5, 64)).astype(np.float32)
        q = np.concatenate([u + noise[:3], -u + noise[3:]])
        q8, qs = topk_mod.quantize_rows_i8(q)
        return q8, qs, k8, ks, n - 3
    keys = _unit(rng, n, 64)
    keys[100:140] = keys[5]
    keys[600:640] = keys[5]
    keys[700:730] = keys[300]
    q = np.concatenate([keys[[5, 300]], _unit(rng, 3, 64)])
    k8, ks = topk_mod.quantize_rows_i8(keys)
    q8, qs = topk_mod.quantize_rows_i8(q)
    return q8, qs, k8, ks, n


@pytest.mark.parametrize("case,k", [("rising", 5), ("rising", 21),
                                    ("duplicates", 5), ("duplicates", 21)])
def test_plain_version_on_the_screens_worst_cases(case, k):
    """The plain version against pallas_topk_i8 (interpret mode) on the
    inputs the card tests give K5's threshold screen. Rising scores have no
    ties: values bit for bit and indices equal. With duplicate blocks JAX
    leaves the order among equal values unspecified, so only the values are
    compared (bit for bit); the port's own order, the smaller index first,
    is asserted on the tied rows."""
    q8, qs, k8, ks, n_valid = _screen_case(case, np.random.default_rng(7))
    v, i = topk_mod.topk_i8(torch.from_numpy(q8), torch.from_numpy(qs[:, 0]),
                            torch.from_numpy(k8), torch.from_numpy(ks[:, 0]),
                            n_valid, k)
    v, i = v.numpy(), i.numpy()
    ref_v, ref_i = _jax_topk_i8(q8, qs, k8, ks, n_valid, k)
    np.testing.assert_array_equal(_bits(v), _bits(ref_v))
    if case == "rising":
        np.testing.assert_array_equal(i, ref_i)
        assert i[0].tolist() == list(range(n_valid - 1, n_valid - 1 - k, -1))
        assert i[4].tolist() == list(range(k))
    else:
        assert i[0].tolist() == ([5] + list(range(100, 140))
                                 + list(range(600, 640)))[:k]
        assert i[1].tolist() == ([300] + list(range(700, 730)))[:k]


@pytest.mark.parametrize("rescore", ["float32", "bfloat16", "none"])
def test_topk_search_int8_matches_jax(rescore):
    rng = np.random.default_rng(4)
    keys, q = _unit(rng, 3000, 64), _unit(rng, 9, 64)
    ref = jax_engine.topk_search(
        q, jax_engine.PreparedKeys(keys, precision="int8", normalized=True,
                                   rescore=rescore), 5, _interpret=True)
    pk = engine.PreparedKeys(keys, device="cpu", precision="int8",
                             normalized=True, rescore=rescore)
    (sh,) = pk.shards
    assert sh.keys.dtype == torch.int8 and sh.keys.shape == (3000, 64)
    assert sh.scales.dtype == torch.float32
    if rescore == "bfloat16":
        assert pk.host_keys.dtype == torch.bfloat16
    assert (pk.host_keys is None) == (rescore == "none")
    sims, idx = engine.topk_search(q, pk, 5)
    assert idx.dtype == np.int64 and sims.shape == (9, 5)
    np.testing.assert_array_equal(idx, ref[1])
    if rescore == "none":
        np.testing.assert_array_equal(_bits(sims), _bits(ref[0]))
    else:
        np.testing.assert_allclose(sims, ref[0], rtol=0, atol=SIM_ATOL)
    # a raw array with precision/rescore builds the same PreparedKeys
    sims2, idx2 = engine.topk_search(q, keys, 5, device="cpu",
                                     precision="int8", rescore=rescore)
    np.testing.assert_array_equal(idx2, idx)
    np.testing.assert_array_equal(sims2, sims)


@pytest.mark.parametrize("rescore", ["bfloat16", "float32"])
def test_int8_service_matches_jax(rescore):
    from bioscan_clip_tpu.retrieval.service import (
        RetrievalService as JaxService,
    )
    from bioscan_clip_tpu_torch.models.clip import MultiModalCLIP
    from bioscan_clip_tpu_torch.retrieval.service import RetrievalService

    rng = np.random.default_rng(5)
    keys = 2.0 * rng.standard_normal((700, 32)).astype(np.float32)
    labels = [{"order": f"o{i % 3}", "family": f"f{i % 7}",
               "genus": f"g{i % 31}", "species": f"s{i}"} for i in range(700)]
    queries = keys[[3, 99, 650]] + 0.3 * rng.standard_normal(
        (3, 32)).astype(np.float32)
    jax_svc = JaxService(None, None, keys=keys, key_labels=labels, max_k=4,
                         key_precision="int8", key_rescore=rescore)
    svc = RetrievalService(MultiModalCLIP(), keys=keys, key_labels=labels,
                           device="cpu", max_k=4, key_precision="int8",
                           key_rescore=rescore)
    assert svc.prepared.int8 and svc.prepared.rescore == rescore
    out = svc.search(embeddings=queries, k=4)
    ref = jax_svc.search(embeddings=queries, k=4)
    assert out["predictions"] == ref["predictions"]
    assert [p["species"][0] for p in out["predictions"]] == ["s3", "s99",
                                                              "s650"]
    np.testing.assert_allclose(out["similarities"], ref["similarities"],
                               rtol=0, atol=SIM_ATOL)


def test_k_search_beyond_the_kernel_lists_raises():
    """The kernel keeps sorted lists of up to 64 entries: an int8 search
    oversamples k to max(4k, k + 16), so k = 16 fits and k = 17 raises."""
    rng = np.random.default_rng(6)
    keys, q = _unit(rng, 300, 64), _unit(rng, 2, 64)
    pk = engine.PreparedKeys(keys, device="cpu", precision="int8",
                             normalized=True)
    assert engine.topk_search(q, pk, 16)[1].shape == (2, 16)
    with pytest.raises(ValueError, match="64"):
        engine.topk_search(q, pk, 17)
    k8, ks = topk_mod.quantize_rows_i8(keys)
    with pytest.raises(ValueError, match="64"):
        topk_mod.topk_i8(torch.from_numpy(k8[:2]), torch.from_numpy(ks[:2, 0]),
                         torch.from_numpy(k8), torch.from_numpy(ks[:, 0]),
                         300, 65)
    # rescore "none" searches k itself: no oversampling
    pk_none = engine.PreparedKeys(keys, device="cpu", precision="int8",
                                  normalized=True, rescore="none")
    assert engine.topk_search(q, pk_none, 64)[1].shape == (2, 64)
    with pytest.raises(ValueError):
        engine.PreparedKeys(keys, device="cpu", precision="int8",
                            rescore="float16")
