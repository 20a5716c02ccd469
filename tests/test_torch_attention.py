"""Port attention (bioscan_clip_tpu_torch/ops/attention.py) against the JAX
Pallas kernels run in interpret mode, on the same numpy inputs.

Tolerance: atol 1e-5 in fp32. Both sides compute fp32 scores, an fp32
softmax and fp32 sums over N <= 133 keys of O(1) terms; they differ only
in summation order (~1e-6). N = 133 at head dim 64 (two heads) is
BarcodeBERT's length at the forward's Hopper tile width: two 64-row query
tiles and a tail of 5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioscan_clip_tpu.ops import attention as jax_attention
from bioscan_clip_tpu_torch.ops import attention
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5
B, D, HEADS = 2, 64, 4


def _bias(rng, n):
    lengths = rng.integers(3, n + 1, size=B)
    keep = np.arange(n)[None, :] < lengths[:, None]
    return np.where(keep, 0.0, -1e9).astype(np.float32)


@pytest.mark.parametrize("n", [20, 33])
def test_mha_packed_matches_jax(n):
    rng = np.random.default_rng(n)
    qkv = rng.standard_normal((B, n, 3 * D)).astype(np.float32)
    ref = jax_attention.mha_packed(jnp.asarray(qkv), heads=HEADS,
                                   interpret=True)
    before = attention.mha_packed.launches
    out = attention.mha_packed(torch.from_numpy(qkv), HEADS)
    assert out.shape == (B, n, D) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    # a CPU tensor runs the plain version: no kernel launch is counted
    assert attention.mha_packed.launches == before


@pytest.mark.parametrize("n", [20, 33, 133])
@pytest.mark.parametrize("with_bias", [False, True])
def test_mha_matches_jax(n, with_bias):
    d, heads = (128, 2) if n == 133 else (D, HEADS)
    rng = np.random.default_rng(100 + n)
    q, k, v = (rng.standard_normal((B, n, d)).astype(np.float32)
               for _ in range(3))
    bias = _bias(rng, n) if with_bias else None
    ref = jax_attention.mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=heads,
        bias=None if bias is None else jnp.asarray(bias), interpret=True,
    )
    out = attention.mha(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        heads, bias=None if bias is None else torch.from_numpy(bias),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_mha_rounds_probabilities_to_input_dtype():
    """bf16 inputs: the plain version rounds p to bf16 before P.V, as the
    kernels do; the result equals an fp32 P.V over the rounded p."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, 20, D)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    out = attention.mha(q, k, v, HEADS)
    assert out.dtype == torch.bfloat16
    hd = D // HEADS
    s = torch.einsum("bnhd,bmhd->bhnm", q.float().view(B, 20, HEADS, hd),
                     k.float().view(B, 20, HEADS, hd)) * hd**-0.5
    p = torch.softmax(s, -1).to(torch.bfloat16).float()
    ref = torch.einsum("bhnm,bmhd->bnhd", p,
                       v.float().view(B, 20, HEADS, hd)).reshape(B, 20, D)
    torch.testing.assert_close(out, ref.to(torch.bfloat16), atol=0, rtol=0)


def test_mha_dropout_raises_until_training_slice():
    """Attention dropout came with the training slice; what still raises is
    a dropout rate without a seed, or a rate outside (0, 1)."""
    x = torch.zeros(1, 4, D)
    with pytest.raises(ValueError, match="dropout_seed"):
        attention.mha(x, x, x, HEADS, dropout_rate=0.1)
    with pytest.raises(ValueError, match="rate"):
        attention.mha_dropout(x, x, x, HEADS, 7, 1.0)

