"""Per-layer remat in the port's towers (`tpu.remat`, `tpu.remat_policy`;
bioscan_clip_tpu_torch/models/common.py) is a pure memory/compute trade, as
JAX's is (tests/test_remat.py:31): for every policy, the same forward and
the same gradients, on the tiny tri-modal model of tests/test_torch_train.py
(dropout 0.1, fp32 on the CPU):
- a tower's output bit for bit, its gradients within 1e-6 of each tensor's
  max |g| (a recompute of the same ops; saved or recomputed, the values
  are the same);
- a train step's loss and trainable gradients under each policy against
  JAX's full-batch gradient on the same step bits, from the one JAX step
  tests/test_torch_gradcache.py jits (`jax_gradcache_reference`: its
  GradCache step, the gradient read off AdamW's first moment; remat moves
  no value in JAX, tests/test_remat.py): loss 1e-5 relative, gradients
  1e-4 of each tensor's max |g| (the tolerance of
  tests/test_torch_train.py's step);
- `make_train_step(remat=True)` (each tower under one checkpoint) equals
  the step without it;
- an unknown policy raises, and `load_clip_model` reads `tpu.remat`;
- every selective policy saves the attention output, as JAX saves
  `attn_ctx` under each of them: no attention forward runs again in the
  backward (the plain version's calls on the CPU; the kernels' launches in
  `tests/test_torch_gpu.py`), and "full" recomputes it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bioscan_clip_tpu_torch.config.core import ConfigNode
from bioscan_clip_tpu_torch.interop.weights import load_into, \
    state_dict_from_jax
from bioscan_clip_tpu_torch.models.bert import (
    BarcodeBertDnaEncoder,
    BertConfig,
    BertTextEncoder,
)
from bioscan_clip_tpu_torch.models.clip import (
    MultiModalCLIP,
    load_clip_model,
    remat_of,
)
from bioscan_clip_tpu_torch.models.common import REMAT_POLICIES
from bioscan_clip_tpu_torch.models.vit import ViTConfig, ViTImageEncoder
from bioscan_clip_tpu_torch.ops import attention
from bioscan_clip_tpu_torch.train import schedules
from bioscan_clip_tpu_torch.train.loop import (
    device_batch,
    make_logit_scale_param,
    make_train_step,
)
from bioscan_clip_tpu_torch.train.state import create_train_state
from test_torch_gradcache import jax_gradcache_reference, shared_params
from test_torch_towers import BERT, D_OUT, VIT
from test_torch_train import train_batch

B = 4
SEED = 0x13572468


def port_model(remat=False, policy="full"):
    r = dict(lora_rank=2, remat=remat, remat_policy=policy)
    return MultiModalCLIP(
        image_encoder=ViTImageEncoder(ViTConfig(**VIT, **r)),
        dna_encoder=BarcodeBertDnaEncoder(
            BertConfig(vocab_size=1027, **BERT, **r), output_dim=D_OUT),
        language_encoder=BertTextEncoder(
            BertConfig(vocab_size=30522, **BERT, **r), output_dim=D_OUT),
    )


@pytest.fixture(scope="module")
def params():
    return shared_params()


def _grads(model, batch, remat_step=False, calls=None, seed=SEED):
    """(loss, trainable gradients); `calls` gets the attention forwards
    the backward ran (the plain version's calls)."""
    create_train_state(model, schedules.constant(1e-3))
    model.train()
    loss = make_train_step(model, remat=remat_step).loss_fn(batch, seed)
    before = attention.mha_reference.calls
    loss.backward()
    if calls is not None:
        calls.append(attention.mha_reference.calls - before)
    return loss.item(), {n: p.grad for n, p in model.named_parameters()
                         if p.requires_grad}


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_step_under_every_policy_matches_jax_and_no_remat(params, policy):
    ref = jax_gradcache_reference()
    batch = device_batch(ref["batch"], "cpu")

    def model(*a):
        return load_into(make_logit_scale_param(port_model(*a)),
                         ref["init"])

    loss0, g0 = _grads(model(), batch, seed=ref["bits"])
    calls = []
    launches = (attention.mha_packed.launches, attention.mha.launches,
                attention.mha_dropout.launches)
    loss1, g1 = _grads(model(True, policy), batch, calls=calls,
                       seed=ref["bits"])
    # "full" recomputes the attention of every layer (2 in each of the 3
    # towers); a selective policy saved its output (the fault repaired
    # here: the attention was an autograd.Function no policy could save,
    # so the backward ran every forward again); on the card the kernels'
    # launch counters stay put too (tests/test_torch_gpu.py)
    assert calls == [3 * 2 if policy == "full" else 0]
    assert (attention.mha_packed.launches, attention.mha.launches,
            attention.mha_dropout.launches) == launches
    assert loss1 == loss0 == pytest.approx(ref["loss"], rel=1e-5)
    assert "logit_scale" in g0
    for name, g in g0.items():
        scale = g.abs().max().item()
        assert (g1[name] - g).abs().max().item() <= 1e-6 * scale, name
        want = ref["grads"][name].numpy()
        err = np.abs(g1[name].numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (name, err)


def test_tower_under_every_policy_equals_no_remat(params):
    sd = state_dict_from_jax(params)
    x = torch.from_numpy(np.random.default_rng(1).random(
        (2, 224, 224, 3), dtype=np.float32))
    ref = load_into(port_model(), sd).image_encoder
    out0 = ref(x)
    out0.sum().backward()
    for policy in REMAT_POLICIES:
        tower = load_into(port_model(True, policy), sd).image_encoder
        out = tower(x)
        assert torch.equal(out, out0), policy
        out.sum().backward()
        for (n, p), p0 in zip(tower.named_parameters(), ref.parameters()):
            err = (p.grad - p0.grad).abs().max().item()
            assert err <= 1e-6 * p0.grad.abs().max().item(), (policy, n)


def test_tower_level_remat_step_equals_the_plain_step(params):
    sd = state_dict_from_jax(params)
    batch = device_batch(train_batch(6, B), "cpu")
    loss0, g0 = _grads(load_into(port_model(), sd), batch)
    loss1, g1 = _grads(load_into(port_model(), sd), batch, remat_step=True)
    assert loss1 == loss0
    for name, g in g0.items():
        assert (g1[name] - g).abs().max().item() <= 1e-6 * g.abs().max(
        ).item(), name


def test_unknown_policy_raises_and_the_factory_reads_tpu_remat():
    with pytest.raises(ValueError, match="unknown remat_policy"):
        ViTImageEncoder(ViTConfig(**VIT, remat=True, remat_policy="most"))
    with pytest.raises(ValueError, match="unknown remat_policy"):
        BertTextEncoder(dataclasses.replace(
            BertConfig(vocab_size=64, **BERT), remat_policy="most"))
    mc = {"image": {"input_type": "image", "model": "lora_vit"},
          "dna": {"input_type": "sequence", "model": "lora_barcode_bert"},
          "language": {"input_type": "sequence", "model": "lora_bert"},
          "output_dim": 8}
    args = ConfigNode({"model_config": mc,
                       "tpu": {"remat": True, "remat_policy": "wide"}})
    model = load_clip_model(args, device="cpu")
    cfgs = (model.image_encoder.lora_vit.cfg,
            model.dna_encoder.lora_barcode_bert.bert.cfg,
            model.language_encoder.lora_bert.cfg)
    assert all((c.remat, c.remat_policy) == (True, "wide") for c in cfgs)
    args.tpu.remat_policy = "most"
    with pytest.raises(ValueError, match="unknown remat_policy"):
        load_clip_model(args, device="cpu")
    assert remat_of(ConfigNode({"model_config": mc})) == {
        "remat": False, "remat_policy": "full"}
