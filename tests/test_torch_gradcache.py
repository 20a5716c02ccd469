"""The port's accumulating train steps (bioscan_clip_tpu_torch/train/loop.py
`make_gradcache_train_step`, `make_accum_train_step`) on the tiny tri-modal
model of tests/test_torch_train.py (perturbed adapters, dropout 0.1 in both
BERT towers, a learnable logit scale), fp32 on the CPU:
- GradCache over 2 microbatches equals the plain full-batch step (the JAX
  pattern of tests/test_accum_step.py:47): loss 1e-5 relative, every
  trainable gradient (the logit scale's included) within 1e-5 of the
  tensor's max |g| (the same sums cut into microbatches and chunks);
- its variants (the merged stage 1, `s1_image_batch`, `s1_chunk`,
  `cache_aug`) equal the plain GradCache step to the same bounds;
- handed the step bits JAX derives (`jax.random.bits(fold_in(rng, step))`),
  one port step equals JAX `make_gradcache_train_step(s1_chunk=...)`: loss
  1e-5 relative, parameters after AdamW atol 2e-6 (JAX's Pallas attention
  in interpret mode, its XLA backward, another summation order through two
  layers; a first Adam step moves each parameter by about lr). That JAX
  step is jitted once per process (`jax_gradcache_reference`), and
  tests/test_torch_remat.py holds its steps against the same step's
  gradients;
- `accum_mode=micro` with one microbatch is the plain step bit for bit.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bioscan_clip_tpu.parallel.mesh import create_mesh, shard_batch
from bioscan_clip_tpu.train.loop import (
    make_gradcache_train_step as jax_gradcache_step,
    make_logit_scale_param as jax_make_logit_scale_param,
)
from bioscan_clip_tpu.train.state import create_train_state as jax_state
from bioscan_clip_tpu_torch.interop.weights import load_into, \
    state_dict_from_jax
from bioscan_clip_tpu_torch.train import schedules
from bioscan_clip_tpu_torch.train.loop import (
    device_batch,
    make_accum_train_step,
    make_gradcache_train_step,
    make_logit_scale_param,
    make_train_step,
)
from bioscan_clip_tpu_torch.train.state import create_train_state
from test_torch_towers import jax_params, port_model
from test_torch_train import jax_model, train_batch
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

B = 8
SEED = 0x2468ACE1


@functools.lru_cache(maxsize=None)
def shared_params():
    """The perturbed tiny model's JAX parameters, initialized once per
    process (tests/test_torch_remat.py reads them too)."""
    return jax_params(seed=11)


@pytest.fixture(scope="module")
def params():
    return shared_params()


def _model(params, rank=2):
    p = jax_make_logit_scale_param(dict(params))
    model = make_logit_scale_param(port_model(rank))
    return load_into(model, state_dict_from_jax(p))


def _batch(frame=(48, 64)):
    """Train batch of B rows whose uint8 frames need the device
    augmentation (shorter side 48 -> Resize(256) -> RandomResizedCrop)."""
    batch = train_batch(5, B)
    rng = np.random.default_rng(6)
    batch["image_u8"] = rng.integers(0, 256, size=(B, *frame, 3),
                                     dtype=np.uint8)
    return device_batch(batch, "cpu")


def _run(model, factory, batch, **kw):
    state = create_train_state(model, schedules.constant(1e-3))
    step = factory(model, **kw)
    state, loss = step(state, batch, SEED)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.requires_grad}
    return loss.item(), grads


def _close(a, b, tol=1e-5):
    (la, ga), (lb, gb) = a, b
    assert la == pytest.approx(lb, rel=tol)
    assert ga.keys() == gb.keys() and "logit_scale" in ga
    for name in ga:
        err = (ga[name] - gb[name]).abs().max().item()
        assert err <= tol * gb[name].abs().max().item() + 1e-12, (name, err)


def test_gradcache_equals_the_full_batch_step(params):
    batch = _batch()
    plain = _run(_model(params), make_train_step, batch)
    gc = _run(_model(params), make_gradcache_train_step, batch,
              accum_steps=2)
    _close(gc, plain)
    assert plain[1]["logit_scale"].abs().item() > 0  # the scale learns


def test_gradcache_variants_equal_the_plain_gradcache_step(params):
    batch = _batch()
    ref = _run(_model(params), make_gradcache_train_step, batch,
               accum_steps=2, color_jitter=True)
    for kw in ({"merged_model": port_model(rank=0)},
               {"s1_image_batch": B, "cache_aug": True},
               {"s1_chunk": 4, "merged_model": port_model(rank=0)}):
        out = _run(_model(params), make_gradcache_train_step, batch,
                   accum_steps=2, color_jitter=True, **kw)
        _close(out, ref)


def test_micro_accumulation_of_one_is_the_plain_step(params):
    batch = _batch()
    plain = _run(_model(params), make_train_step, batch)
    micro = _run(_model(params), make_accum_train_step, batch, accum_steps=1)
    assert micro[0] == plain[0]
    for name, g in plain[1].items():
        assert torch.equal(micro[1][name], g), name
    two = _run(_model(params), make_accum_train_step, batch, accum_steps=2)
    assert np.isfinite(two[0]) and two[0] != plain[0]  # microbatch negatives


def test_parts_that_do_not_divide_the_batch_raise(params):
    batch = _batch()
    for kw in ({"accum_steps": 3}, {"accum_steps": 2, "s1_chunk": 3},
               {"accum_steps": 2, "s1_image_batch": 3}):
        with pytest.raises(ValueError, match="divide the global batch"):
            _run(_model(params), make_gradcache_train_step, batch, **kw)


def _first_moment_grads(opt_state, params):
    """The gradients of a first AdamW step, from its first moment:
    mu = (1 - b1) * g, b1 = 0.9 (one fp32 rounding each way)."""
    def masked(x):
        return isinstance(x, optax.MaskedNode)

    mus = [opt_state.inner_states[k].inner_state[0].mu
           for k in ("trainable", "scale")]

    def pick(p, *ms):
        m = next((m for m in ms if not masked(m)), None)
        return (np.zeros(np.shape(p), np.float32) if m is None
                else np.asarray(m) / np.float32(0.1))

    return jax.tree.map(pick, params, *mus, is_leaf=masked)


@functools.lru_cache(maxsize=None)
def jax_gradcache_reference():
    """One JAX GradCache step in its row-keyed mode (s1_chunk, loop.py:
    557-580, :696-712; accum 2, chunks of 4) on `shared_params` with a
    learnable logit scale, lr 1e-3, on pre-augmented float images (JAX's
    augmentation draws are its PRNG's), JAX's attention in its Pallas
    kernel in interpret mode with the XLA backward -> {"batch": host
    batch, "bits": the uint32 step bits it derived, "loss", "init" (the
    starting parameters), "params" after AdamW and "grads" (the full-batch
    gradient), all three as port state dicts}. Jitted once per process; tests/test_torch_remat.py reads it
    too."""
    host = train_batch(7, B)
    host["image"] = np.random.default_rng(8).random(
        (B, 224, 224, 3), dtype=np.float32)
    del host["image_u8"]
    p_jax = jax.tree.map(np.asarray, jax_make_logit_scale_param(
        dict(shared_params())))
    init = state_dict_from_jax(p_jax)
    mesh = create_mesh(devices=jax.devices()[:1])
    st = jax_state(jax_model(), jax.tree.map(jnp.asarray, p_jax),
                   lambda step: 1e-3)
    rng = jax.random.PRNGKey(3)
    bits = int(jax.random.bits(jax.random.fold_in(rng, 0), dtype=jnp.uint32))
    env = {"BSCAN_FUSED_ATTENTION": "1", "BSCAN_PALLAS_MHA_BWD": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        step = jax_gradcache_step(jax_model(), mesh, accum_steps=2,
                                  s1_chunk=4)
        st, loss = step(st, shard_batch(host, mesh), rng)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"batch": host, "bits": bits, "loss": float(loss),
            "init": init,
            "params": state_dict_from_jax(jax.tree.map(np.array, st.params)),
            "grads": state_dict_from_jax(
                _first_moment_grads(st.opt_state, p_jax))}


def test_gradcache_matches_jax_s1_chunk_mode(params):
    """JAX's GradCache in its row-keyed mode and the port's step, handed
    the same uint32 step bits (`jax_gradcache_reference`)."""
    jax_ref = jax_gradcache_reference()
    ref = jax_ref["params"]
    model = _model(params)
    state = create_train_state(model, schedules.constant(1e-3))
    port = make_gradcache_train_step(model, 2, s1_chunk=4)
    state, loss = port(state, device_batch(jax_ref["batch"], "cpu"),
                       jax_ref["bits"])
    assert loss.item() == pytest.approx(jax_ref["loss"], rel=1e-5)
    moved = 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=0, atol=2e-6, err_msg=name)
        moved += p.requires_grad
    assert moved > 20
