"""Micro accumulation (`accum_mode: micro`, bioscan_clip_tpu_torch/train/
loop.py `micro_layout`, `make_accum_train_step`) at any `accum_steps` that
divides the global batch, microbatches spanning processes where the
process count does not divide it:
- the layout of every (W, b, n) with W in 1-4, b in 1, 2, 3, 4, 6 and n
  dividing W * b, against a brute-force assignment of each global row to
  its microbatch and process; nothing spans where W divides n;
- the collectives of one process's step over a two-process axis, with
  `torch.distributed`'s all_gather and all_reduce replaced by counters:
  with n a multiple of W no gather at all, else one label gather a step
  and one a spanning microbatch; one gradient and one loss all_reduce
  either way; a holder that is not a spanning microbatch's lowest rank
  keeps neither its loss nor the learnable scale's gradient;
- against JAX: the port's one-process step at n = 3 on 12 rows and JAX's
  `make_accum_train_step(accum_steps=3)` on a 2-device mesh, where
  microbatch 1 spans both devices, on the same weights
  (tests/test_train_step.py's tiny model: dropout 0 and float images,
  since JAX draws its masks and augmentation from `jax.random`): loss
  rtol 1e-5, parameters after the update atol 1e-6 (the bounds of
  tests/test_accum_step.py).
The spanning step over real processes is held against one process in
tests/test_torch_distributed.py (two and three gloo processes).
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from bioscan_clip_tpu_torch.parallel.mesh import Mesh
from bioscan_clip_tpu_torch.train import loop
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

LAYOUT_CASES = [(w, b, n) for w in range(1, 5) for b in (1, 2, 3, 4, 6)
                for n in range(1, w * b + 1) if w * b % n == 0]


def _brute_force(world, b, n):
    """(rows each process holds of each microbatch, each process's local
    rows of each), row by row."""
    m = world * b // n
    counts = [[0] * world for _ in range(n)]
    local = [[[] for _ in range(n)] for _ in range(world)]
    for g in range(world * b):
        j, r = g // m, g // b
        counts[j][r] += 1
        local[r][j].append(g - r * b)
    return counts, local


@pytest.mark.parametrize("world,b,n", LAYOUT_CASES)
def test_micro_layout_against_brute_force(world, b, n):
    counts, local = _brute_force(world, b, n)
    m = world * b // n
    for rank in range(world):
        layout = loop.micro_layout(world, rank, b, n)
        assert len(layout) == n
        for j, mb in enumerate(layout):
            assert mb.global_rows == slice(j * m, (j + 1) * m)
            assert mb.counts == tuple(counts[j])
            assert mb.holders == tuple(r for r in range(world)
                                       if counts[j][r])
            assert mb.spans == (len(mb.holders) > 1)
            rows = [] if mb.rows is None else list(range(b))[mb.rows]
            assert rows == local[rank][j]
        if n % world == 0:
            assert not any(mb.spans for mb in layout)


def test_micro_layout_raises_where_n_does_not_divide_the_batch():
    with pytest.raises(ValueError, match="divide the global batch 12"):
        loop.micro_layout(2, 0, 6, 5)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("rank", [0, 1])
def test_collectives_of_a_step_over_two_processes(monkeypatch, n, rank):
    """One process's step as rank `rank` of two (6 rows each), the
    collectives counted: every gathered part is this process's rows."""
    from bioscan_clip_tpu_torch.train.schedules import constant
    from bioscan_clip_tpu_torch.train.state import create_train_state
    from test_torch_distributed import SEED, host_batch, tiny_model

    calls = {"all_gather": 0, "all_reduce": 0}

    def all_gather(parts, x, group=None):
        calls["all_gather"] += 1
        for p in parts:
            p.copy_(x)

    def all_reduce(x, group=None):
        calls["all_reduce"] += 1

    monkeypatch.setattr(dist, "all_gather", all_gather)
    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    model = loop.make_logit_scale_param(tiny_model())
    state = create_train_state(model, constant(1e-3))
    axis = Mesh((torch.device("cpu"),), 2, rank, group=object())
    step = loop.make_accum_train_step(model, n, mesh=axis)
    batch = loop.device_batch(host_batch(rank, b=6), "cpu")
    state, loss = step(state, batch, SEED)
    layout = loop.micro_layout(2, rank, 6, n)
    spanning = sum(mb.spans for mb in layout)
    assert calls == {"all_gather": spanning + (spanning > 0),
                     "all_reduce": 2}
    assert (spanning == 0) == (n % 2 == 0)
    kept = [mb for mb in layout if mb.rows is not None
            and mb.holders[0] == rank]
    scale_grad = model.logit_scale.grad.item()
    if kept:
        assert np.isfinite(loss.item()) and loss.item() > 0
        assert scale_grad != 0
    else:  # rank 1 of n = 1: both hold the one microbatch, rank 0 keeps it
        assert (n, rank) == (1, 1)
        assert loss.item() == 0 and scale_grad == 0


def _port_tiny_model():
    """tests/test_train_step.py's `_tiny_model` in the port."""
    from bioscan_clip_tpu_torch.models.bert import (
        BarcodeBertDnaEncoder,
        BertConfig,
    )
    from bioscan_clip_tpu_torch.models.clip import MultiModalCLIP
    from bioscan_clip_tpu_torch.models.vit import ViTConfig, ViTImageEncoder

    return MultiModalCLIP(
        image_encoder=ViTImageEncoder(ViTConfig(
            image_size=16, patch_size=8, hidden_size=32, num_layers=2,
            num_heads=2, num_classes=24, lora_rank=2)),
        dna_encoder=BarcodeBertDnaEncoder(BertConfig(
            vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, lora_rank=2, hidden_dropout=0.0,
            attention_dropout=0.0), output_dim=24),
    )


def test_micro_step_matches_jax_with_a_microbatch_across_devices():
    from bioscan_clip_tpu.parallel.mesh import create_mesh, shard_batch
    from bioscan_clip_tpu.train.loop import (
        make_accum_train_step as jax_accum_step,
    )
    from bioscan_clip_tpu.train.state import create_train_state as jax_state
    from bioscan_clip_tpu_torch.interop.weights import (
        load_into,
        state_dict_from_jax,
    )
    from bioscan_clip_tpu_torch.train.state import create_train_state
    from tests.test_train_step import _batch, _tiny_model

    host = {k: np.array(v) for k, v in _batch(12).items()}
    jax_model = _tiny_model()
    # `_init_state` of that file, its init jitted (op by op it takes ~15 s)
    params = jax.jit(jax_model.init)(
        jax.random.PRNGKey(0), host["image"][:4], host["dna"][:4])["params"]
    st = jax_state(jax_model, params, lambda s: 1e-3)
    init = state_dict_from_jax(jax.tree.map(np.array, st.params))
    mesh = create_mesh(devices=jax.devices()[:2])
    assert loop.micro_layout(2, 0, 6, 3)[1].spans  # rows 4-7 of 12
    step = jax_accum_step(jax_model, mesh, accum_steps=3)
    st, loss_ref = step(st, shard_batch(host, mesh), jax.random.PRNGKey(3))
    ref = state_dict_from_jax(jax.tree.map(np.array, st.params))

    model = load_into(_port_tiny_model(), init)
    state = create_train_state(model, lambda step: 1e-3)
    port = loop.make_accum_train_step(model, 3)
    state, loss = port(state, loop.device_batch(host, "cpu"), 0x5EED)
    assert loss.item() == pytest.approx(float(loss_ref), rel=1e-5)
    moved = 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
        moved += p.requires_grad and not torch.equal(p.detach(),
                                                     init[name])
    assert moved > 5 and state.step == int(st.step) == 1
