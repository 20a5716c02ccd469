"""The port's attention backward against the JAX package's, on the same
numpy inputs:
- `mha_bwd_reference` (the plain K3) against the JAX Pallas backward
  `_pallas_mha_bwd` run in interpret mode and against `jax.vjp` of the JAX
  ops `mha` / `mha_packed` (their default XLA backward `_mha_bwd_math`), for
  the packed layout, the split layout, the split layout with a key bias and
  dropout, and the bias gradient;
- the gradients autograd takes through the port's `mha` / `mha_packed`
  Functions on CPU tensors (their backward is the plain K3) against
  `jax.vjp`.

Tolerance atol 1e-5 in fp32: both sides recompute an fp32 softmax and sum
O(1) terms over N <= 20 keys and 4 heads in another order (~1e-6); the
dropout masks are bit-equal (tests/test_torch_dropout.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioscan_clip_tpu.ops import attention as jax_attention
from bioscan_clip_tpu_torch.ops import attention

ATOL = 1e-5
B, N, D, HEADS, RATE = 2, 20, 64, 4, 0.1
SCALE = (D // HEADS) ** -0.5


def _case(seed, with_bias=False, row_keyed=True):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, N, D)).astype(np.float32)
                  for _ in range(4))
    bias = None
    if with_bias:
        keep = np.arange(N)[None, :] < rng.integers(3, N + 1, size=(B, 1))
        bias = np.where(keep, 0.0, -1e9).astype(np.float32)
    seeds = (rng.integers(0, 2**32, size=(B,), dtype=np.uint64).astype(
        np.uint32) if row_keyed else np.uint32(0x2468ACE1))
    return q, k, v, g, bias, seeds


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _t_seed(seeds):
    return (torch.from_numpy(seeds.astype(np.int64)) if seeds.ndim
            else int(seeds))


def _close(out, ref):
    for o, r in zip(out, ref):
        if r is None:
            assert o is None
        else:
            np.testing.assert_allclose(np.asarray(o), np.asarray(r),
                                       atol=ATOL)


@pytest.mark.parametrize("rate,with_bias,row_keyed", [
    (0.0, False, True), (0.0, True, True), (RATE, False, True),
    (RATE, True, True), (RATE, True, False),
])
def test_plain_split_backward_matches_jax(rate, with_bias, row_keyed,
                                          monkeypatch):
    q, k, v, g, bias, seeds = _case(1, with_bias, row_keyed)
    out = attention.mha_bwd_reference(
        _t(q), _t(k), _t(v), _t(g), HEADS, bias=_t(bias),
        dropout_rate=rate, dropout_seed=_t_seed(seeds) if rate else None)
    out = [None if o is None else o.numpy() for o in out]
    jb = None if bias is None else jnp.asarray(bias)
    js = jnp.asarray(seeds) if rate else None
    # the Pallas K3 in interpret mode
    pallas = jax_attention._pallas_mha_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(g), jb,
        None, HEADS, SCALE, True, rate=rate, seed=js)
    _close(out, pallas)
    # jax.vjp of the JAX op, whose backward is the XLA math by default
    monkeypatch.setenv("BSCAN_PALLAS_MHA_BWD", "0")
    args = [jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)]
    if bias is None:
        _, vjp = jax.vjp(lambda a, b, c: jax_attention.mha(
            a, b, c, heads=HEADS, interpret=True, dropout_rate=rate,
            dropout_seed=js), *args)
        ref = list(vjp(jnp.asarray(g))) + [None]
    else:
        _, vjp = jax.vjp(lambda a, b, c, d: jax_attention.mha(
            a, b, c, heads=HEADS, bias=d, interpret=True, dropout_rate=rate,
            dropout_seed=js), *args, jb)
        ref = vjp(jnp.asarray(g))
    _close(out, ref)


@pytest.mark.parametrize("pallas_bwd", ["0", "1"])
def test_plain_packed_backward_matches_jax(pallas_bwd, monkeypatch):
    """`mha_bwd(packed_qkv=...)` on a CPU tensor against jax.vjp of JAX
    `mha_packed`, with its XLA backward and with its Pallas K3."""
    monkeypatch.setenv("BSCAN_PALLAS_MHA_BWD", pallas_bwd)
    rng = np.random.default_rng(2)
    qkv = rng.standard_normal((B, N, 3 * D)).astype(np.float32)
    g = rng.standard_normal((B, N, D)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jax_attention.mha_packed(
        x, heads=HEADS, interpret=True), jnp.asarray(qkv))
    (ref,) = vjp(jnp.asarray(g))
    out = attention.mha_bwd(None, None, None, _t(g), HEADS,
                            packed_qkv=_t(qkv))
    assert out.shape == (B, N, 3 * D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("rate", [0.0, RATE])
def test_gradients_through_mha_match_jax(rate, monkeypatch):
    """autograd through the port's `mha` Function (CPU: the plain forward
    and the plain K3) equals jax.vjp of JAX `mha`, bias gradient included."""
    monkeypatch.setenv("BSCAN_PALLAS_MHA_BWD", "0")
    q, k, v, g, bias, seeds = _case(3, with_bias=True)
    tq, tk, tv, tb = (_t(x).clone().requires_grad_() for x in (q, k, v, bias))
    y = attention.mha(tq, tk, tv, HEADS, bias=tb, dropout_rate=rate,
                      dropout_seed=_t_seed(seeds) if rate else None)
    got = torch.autograd.grad(y, (tq, tk, tv, tb), _t(g))
    js = jnp.asarray(seeds) if rate else None
    y_ref, vjp = jax.vjp(lambda a, b, c, d: jax_attention.mha(
        a, b, c, heads=HEADS, bias=d, interpret=True, dropout_rate=rate,
        dropout_seed=js), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(bias))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               atol=ATOL)
    _close([t.numpy() for t in got], vjp(jnp.asarray(g)))
    # autograd went through the Function's backward: the plain K3 ran
    assert attention.mha_bwd.launches == 0


def test_gradients_through_mha_packed_match_jax(monkeypatch):
    monkeypatch.setenv("BSCAN_PALLAS_MHA_BWD", "0")
    rng = np.random.default_rng(4)
    qkv = rng.standard_normal((B, N, 3 * D)).astype(np.float32)
    g = rng.standard_normal((B, N, D)).astype(np.float32)
    t = _t(qkv).clone().requires_grad_()
    calls = attention.mha_bwd_reference.calls
    (got,) = torch.autograd.grad(attention.mha_packed(t, HEADS), t, _t(g))
    assert attention.mha_bwd_reference.calls == calls + 1
    _, vjp = jax.vjp(lambda x: jax_attention.mha_packed(
        x, heads=HEADS, interpret=True), jnp.asarray(qkv))
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               atol=ATOL)
