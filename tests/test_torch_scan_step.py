"""The port's K train steps per call (bioscan_clip_tpu_torch/train/loop.py
`make_scan_train_step`, `make_gradcache_train_step(steps_per_call=)`,
`train_epoch(steps_per_call=)`; on a card CUDA graphs, train/graphs.py) on
the CPU, where the K steps run eagerly, on the tiny tri-modal model of
tests/test_torch_towers.py, fp32:
- a K=3 call equals 3 eager `make_train_step` steps bit for bit (losses,
  parameters, both AdamW moments), with dropout 0.1, the device
  augmentation of uint8 frames and a learning rate that changes per step;
- against JAX `make_scan_train_step(K=2)` and its `same_batch=True` on the
  same weights: losses 1e-5 relative (tests/test_torch_train.py's
  train-step tolerance), parameters after the 2 AdamW steps atol 2e-6
  (tests/test_torch_gradcache.py's: a first Adam step moves each parameter
  by about lr = 1e-3, gradients agree to 1e-4 of their max). JAX's scan
  step draws flax dropout from its PRNG, which torch cannot reproduce, so
  this model is dropout-free and its images come pre-transformed; the
  step seeds are JAX's `bits(fold_in(rng, step))` all the same;
- GradCache over 2 microbatches with 2 steps per call (merged stage 1)
  equals two GradCache steps bit for bit;
- `train_epoch(steps_per_call=3)` over 7 batches (calls of 3, 3 and 1
  steps) gives the losses, the wandb records and the final state of one
  step per call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioscan_clip_tpu.parallel.mesh import (
    create_mesh,
    shard_batch,
    shard_stacked_batches,
)
from bioscan_clip_tpu.train.loop import (
    make_scan_train_step as jax_scan_step,
    stack_batches as jax_stack_batches,
)
from bioscan_clip_tpu.train.state import create_train_state as jax_state
from bioscan_clip_tpu_torch.interop.weights import load_into, \
    state_dict_from_jax
from bioscan_clip_tpu_torch.models.bert import (
    BarcodeBertDnaEncoder,
    BertConfig,
    BertTextEncoder,
)
from bioscan_clip_tpu_torch.models.clip import MultiModalCLIP, init_weights
from bioscan_clip_tpu_torch.models.vit import ViTConfig, ViTImageEncoder
from bioscan_clip_tpu_torch.train.loop import (
    device_batch,
    make_gradcache_train_step,
    make_scan_train_step,
    make_train_step,
    stack_batches,
    train_epoch,
)
from bioscan_clip_tpu_torch.train.state import create_train_state
from test_torch_gradcache import shared_params
from test_torch_towers import BERT, D_OUT, VIT, jax_model, port_model
from test_torch_train import train_batch
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

B = 4


def schedule(step):
    return 1e-3 * (1 + step)


def _model(seed=5):
    """The towers test's port model (dropout 0.1) at random weights, every
    tensor perturbed so each adapter is non-zero."""
    model = init_weights(port_model(), seed=seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model


def _batch(seed):
    """B rows whose (48, 64) uint8 frames need the device augmentation."""
    batch = train_batch(seed, B)
    batch["image_u8"] = np.random.default_rng(seed).integers(
        0, 256, size=(B, 48, 64, 3), dtype=np.uint8)
    return batch


def _same_state(a, b):
    """Equal bits: every parameter, both AdamW moments, the step."""
    assert a.step == b.step
    for (name, p), q in zip(a.model.named_parameters(),
                            b.model.parameters()):
        assert torch.equal(p, q), name
        sa, sb = a.optimizer.state.get(p, {}), b.optimizer.state.get(q, {})
        assert sa.keys() == sb.keys(), name
        for key in sa:
            assert torch.equal(sa[key], sb[key]), (name, key)


def _eager(model, factory, batches, seeds, **kw):
    state = create_train_state(model, schedule)
    step = factory(model, **kw)
    losses = []
    for batch, seed in zip(batches, seeds):
        state, loss = step(state, device_batch(batch, "cpu"), seed)
        losses.append(loss)
    return state, torch.stack(losses)


def test_scan_step_equals_the_eager_steps():
    batches = [_batch(i) for i in range(3)]
    seeds = [0x1234, 0xFFFFFFFF, 7]
    ref, ref_losses = _eager(_model(), make_train_step, batches, seeds,
                             color_jitter=True)
    model = _model()
    state = create_train_state(model, schedule)
    scan = make_scan_train_step(model, 3, color_jitter=True)
    state, losses = scan(state, device_batch(stack_batches(batches), "cpu"),
                         seeds)
    assert losses.shape == (3,) and torch.equal(losses, ref_losses)
    _same_state(state, ref)
    with pytest.raises(ValueError, match="at most 3 steps"):
        scan(state, device_batch(stack_batches(batches), "cpu"), [1] * 4)


def _dropout_free_port_model():
    drop = dict(hidden_dropout=0.0, attention_dropout=0.0)
    return MultiModalCLIP(
        image_encoder=ViTImageEncoder(ViTConfig(**VIT, lora_rank=2)),
        dna_encoder=BarcodeBertDnaEncoder(
            BertConfig(vocab_size=1027, lora_rank=2, **BERT, **drop),
            output_dim=D_OUT),
        language_encoder=BertTextEncoder(
            BertConfig(vocab_size=30522, lora_rank=2, **BERT, **drop),
            output_dim=D_OUT),
    )


@pytest.mark.parametrize("same_batch", [False, True])
def test_scan_step_matches_jax_scan(same_batch):
    params = shared_params()
    rng = np.random.default_rng(9)
    hosts = []
    for i in range(2):
        host = train_batch(20 + i, B)
        del host["image_u8"]
        host["image"] = rng.random((B, 224, 224, 3), dtype=np.float32)
        hosts.append(host)
    mesh = create_mesh(devices=jax.devices()[:1])
    key = jax.random.PRNGKey(4)
    st = jax_state(jax_model(), jax.tree.map(jnp.asarray, params),
                   lambda step: 1e-3)
    scan = jax_scan_step(jax_model(), mesh, steps_per_call=2,
                         same_batch=same_batch)
    xs = (shard_batch(hosts[0], mesh) if same_batch
          else shard_stacked_batches(jax_stack_batches(hosts), mesh))
    st, losses_ref = scan(st, xs, key)
    ref = state_dict_from_jax(jax.tree.map(np.array, st.params))

    model = load_into(_dropout_free_port_model(), state_dict_from_jax(params))
    state = create_train_state(model, lambda step: 1e-3)
    seeds = [int(jax.random.bits(jax.random.fold_in(key, s),
                                 dtype=jnp.uint32)) for s in range(2)]
    port = make_scan_train_step(model, 2, same_batch=same_batch)
    batches = hosts[0] if same_batch else stack_batches(hosts)
    state, losses = port(state, device_batch(batches, "cpu"), seeds)
    np.testing.assert_allclose(losses.numpy(), np.asarray(losses_ref),
                               rtol=1e-5)
    moved = 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=0, atol=2e-6, err_msg=name)
        moved += p.requires_grad
    assert moved > 20 and state.step == int(st.step) == 2


def test_gradcache_steps_per_call_equals_gradcache_steps():
    batches = [_batch(10 + i) for i in range(2)]
    seeds = [99, 100]
    kw = dict(accum_steps=2, s1_chunk=2)
    ref, ref_losses = _eager(_model(), make_gradcache_train_step, batches,
                             seeds, merged_model=port_model(rank=0), **kw)
    model = _model()
    state = create_train_state(model, schedule)
    scan = make_gradcache_train_step(model, steps_per_call=2,
                                     merged_model=port_model(rank=0), **kw)
    state, losses = scan(state, device_batch(stack_batches(batches), "cpu"),
                         seeds)
    assert torch.equal(losses, ref_losses)
    _same_state(state, ref)


class _Run:
    def __init__(self):
        self.records = []

    def log(self, metrics, commit=True):
        self.records.append(dict(metrics))


def test_train_epoch_in_calls_of_three_equals_one_step_per_call():
    batches = [_batch(30 + i) for i in range(7)]
    out = {}
    for k in (1, 3):
        model = _model()
        state = create_train_state(model, schedule, seed=3)
        run = _Run()
        state, stats = train_epoch(
            state, make_train_step(model), batches, state.generator, 0, 1,
            wandb_run=run, steps_per_call=k,
            scan_step_factory=lambda n: make_scan_train_step(model, n))
        out[k] = (state, stats, run.records)
    (s1, st1, rec1), (s3, st3, rec3) = out[1], out[3]
    assert len(st1["losses"]) == 7 and st3["losses"] == st1["losses"]
    assert rec3 == rec1 and [r["step"] for r in rec1] == list(range(7))
    _same_state(s3, s1)
    assert s3.generator.get_state().equal(s1.generator.get_state())
