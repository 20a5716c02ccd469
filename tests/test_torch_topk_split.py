"""K4's "high" arithmetic on the card, checked on the CPU: the three-way
bf16 split of each fp32 operand (`ops.topk.split_bf16_3`) and the six
products whose piece indices sum to 2 or less, which is what the TPU's
`Precision.HIGHEST` computes and what `csrc/topk.cu` runs on the tensor
cores, against the JAX `pallas_topk(precision="high")` in interpret mode.

Tolerances: the split reconstructs x to within 2^-24 |x| (the dropped lo
remainder is below half a bf16 ulp of x - hi - mid); six-product scores of
unit vectors within 1e-6 of JAX's fp32 scores (the three dropped products
are below 2^-24 |x||y| each, and the sums of 768 terms run in another
order); top-k indices equal wherever neighbouring values differ by more
than 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from bioscan_clip_tpu.ops.topk_pallas import pallas_topk
from bioscan_clip_tpu.retrieval.engine import l2norm_np
from bioscan_clip_tpu_torch.ops import topk as topk_mod
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

BQ, N, D, K, TILE = 16, 512, 768, 5, 128
TOL = 1e-6


def _six_products(q, keys):
    """fp32 scores: the six products of the operands' bf16 pieces."""
    qp, kp = topk_mod.split_bf16_3(q), topk_mod.split_bf16_3(keys)
    s = torch.zeros(q.shape[0], keys.shape[0])
    for i, j in ((2, 0), (1, 1), (0, 2), (0, 1), (1, 0), (0, 0)):
        s += qp[i] @ kp[j].T
    return s


@pytest.fixture(scope="module")
def jax_high():
    """pallas_topk at "high" in interpret mode, jitted once."""
    return jax.jit(lambda q, k: pallas_topk(q, k, N, k=K, tile=TILE,
                                            q_block=BQ, interpret=True,
                                            precision="high"))


def test_split_reconstructs_x():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(100_000).astype(np.float32)
    x *= np.exp2(rng.integers(-30, 30, x.shape)).astype(np.float32)
    hi, mid, lo = topk_mod.split_bf16_3(torch.from_numpy(x))
    for piece in (hi, mid, lo):  # each piece is a bf16 value
        assert torch.equal(piece, piece.bfloat16().float())
    xd = torch.from_numpy(x).double()
    err = (hi.double() + mid.double() + lo.double() - xd).abs()
    assert (err <= 2.0**-24 * xd.abs()).all()
    assert (mid.abs() <= 2.0**-8 * hi.abs()).all()
    assert (lo.abs() <= 2.0**-8 * mid.abs()).all()


def test_six_products_match_jax_high(jax_high):
    rng = np.random.default_rng(1)
    q = l2norm_np(rng.standard_normal((BQ, D)).astype(np.float32))
    keys = l2norm_np(rng.standard_normal((N, D)).astype(np.float32))
    keys[300] = q[3]  # one clear winner, scored near 1
    ref_v, ref_i = (np.asarray(a) for a in jax_high(q, keys))
    s = _six_products(torch.from_numpy(q), torch.from_numpy(keys))
    full = torch.from_numpy(q).double() @ torch.from_numpy(keys).double().T
    assert (s.double() - full).abs().max().item() <= TOL
    vals, idx = torch.sort(s, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :K].numpy(), idx[:, :K].numpy()
    np.testing.assert_allclose(vals, ref_v, atol=TOL)
    gap = np.full(vals.shape, np.inf, np.float32)
    gap[:, 1:] = np.abs(np.diff(ref_v, axis=1))
    gap[:, :-1] = np.minimum(gap[:, :-1], np.abs(np.diff(ref_v, axis=1)))
    clear = gap > TOL
    np.testing.assert_array_equal(idx[clear], ref_i[clear])
    assert idx[3, 0] == 300
    # the plain version (full fp32) is what the six products approximate
    pv, pi = topk_mod.topk_reference(torch.from_numpy(q),
                                     torch.from_numpy(keys), N, K)
    np.testing.assert_allclose(pv.numpy(), vals, atol=TOL)
