"""The port's counter-hash dropout against the JAX package's, on the same
numpy inputs: the uint32 hash, the attention masks (scalar and (B,) seeds),
the per-row seed chains and `ps_dropout` must be bit-equal; the plain K2d
forward (`mha_reference` with dropout) must equal the JAX Pallas dropout
kernel run in interpret mode within atol 1e-6 (fp32 softmax and sums over
N <= 20 keys of O(1) terms in another order; the masks themselves are
equal bit for bit)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioscan_clip_tpu.models import common as jax_common
from bioscan_clip_tpu.ops import attention as jax_attention
from bioscan_clip_tpu_torch.models import common
from bioscan_clip_tpu_torch.ops import attention
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

RATE = 0.1


def _u32(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def test_mix32_and_threshold_match_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1],
                                 np.uint32), _u32(rng, 4096)])
    ref = np.asarray(jax_attention._mix32(jnp.asarray(x)))
    out = attention._mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(out, ref.astype(np.int64))
    for rate in (0.0, 0.1, 0.5, 1.0):
        assert (attention._keep_threshold(rate)
                == jax_attention._keep_threshold(rate))
    assert attention.keep_scale(RATE) == float(
        jnp.float32(1.0) / jnp.float32(1.0 - RATE))


@pytest.mark.parametrize("b_idx,head", [(0, 0), (3, 5)])
def test_dropout_keep_2d_matches_jax(b_idx, head):
    seed = 0xDEADBEEF
    ref = jax_attention.dropout_keep_2d(jnp.uint32(seed), jnp.uint32(b_idx),
                                        head, 20, RATE, 8)
    out = attention.dropout_keep_2d(seed, b_idx, head, 20, RATE, 8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("row_keyed", [False, True])
def test_dropout_keep_4d_matches_jax(row_keyed):
    rng = np.random.default_rng(1)
    seed = _u32(rng, (3,)) if row_keyed else np.uint32(0x12345678)
    ref = jax_attention.dropout_keep_4d(jnp.asarray(seed), 3, 4, 17, RATE)
    out = attention.dropout_keep_4d(seed, 3, 4, 17, RATE)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    if row_keyed:  # row b of the 4-D mask is the 2-D mask of its own seed
        one = attention.dropout_keep_2d(int(seed[1]), 0, 2, 17, RATE, 4)
        np.testing.assert_array_equal(out[1, 2].numpy(), one.numpy())


def test_row_seed_chains_match_jax():
    rng = np.random.default_rng(2)
    base, rows = np.uint32(0xC0FFEE ^ 0x0D5A17), np.arange(7)
    ref = jax_common.row_seeds_init(jnp.uint32(base), jnp.asarray(rows))
    out = common.row_seeds_init(int(base), torch.from_numpy(rows))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    salt = _u32(rng, (7,))
    t_salt = torch.from_numpy(salt.astype(np.int64))
    np.testing.assert_array_equal(
        common.row_salt_advance(t_salt).numpy(),
        np.asarray(jax_common.row_salt_advance(jnp.asarray(salt))))
    for site in range(4):
        np.testing.assert_array_equal(
            common.site_seed(t_salt, site).numpy(),
            np.asarray(jax_common.site_seed(jnp.asarray(salt), site)))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_ps_dropout_matches_jax(dtype):
    rng = np.random.default_rng(3)
    salt = _u32(rng, (5,))
    x = rng.standard_normal((5, 6, 8)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                               else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16"
                                else torch.float32)
    ref = jax_common.ps_dropout(jx, RATE, jnp.asarray(salt), 2)
    out = common.ps_dropout(tx, RATE, torch.from_numpy(salt.astype(np.int64)),
                            2)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    assert 0 < (out == 0).float().mean().item() < 0.3


@pytest.mark.parametrize("row_keyed", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_k2d_plain_forward_matches_jax(row_keyed, with_bias):
    b, n, d, heads = 3, 20, 64, 4
    rng = np.random.default_rng(10 + 2 * row_keyed + with_bias)
    q, k, v = (rng.standard_normal((b, n, d)).astype(np.float32)
               for _ in range(3))
    seed = _u32(rng, (b,)) if row_keyed else np.uint32(0xABCDEF01)
    bias = None
    if with_bias:
        keep = np.arange(n)[None, :] < rng.integers(3, n + 1, size=(b, 1))
        bias = np.where(keep, 0.0, -1e9).astype(np.float32)
    ref = jax_attention.mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=heads,
        bias=None if bias is None else jnp.asarray(bias), interpret=True,
        dropout_rate=RATE, dropout_seed=jnp.asarray(seed))
    t_seed = (torch.from_numpy(seed.astype(np.int64)) if row_keyed
              else int(seed))
    out = attention.mha(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), heads,
        bias=None if bias is None else torch.from_numpy(bias),
        dropout_rate=RATE, dropout_seed=t_seed)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    # a CPU tensor runs the plain version: no kernel launch is counted
    assert attention.mha_dropout.launches == 0
