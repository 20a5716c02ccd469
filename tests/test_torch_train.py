"""The port's training slice against the JAX package, on the tiny tri-modal
model of tests/test_torch_towers.py (perturbed adapters, hidden and
attention dropout 0.1, row-keyed dropout with the same seeds on both sides,
JAX attention through its Pallas kernels in interpret mode):
- train-mode tower outputs, atol 1e-4 (the towers test's tolerance: fp32
  matmuls, LayerNorms and GELU in another order through two layers);
- the 6-term InfoNCE on fixed embeddings with repeated labels, 1e-6
  relative (one fp32 matmul, log-softmax and mean in another order);
- one train step's loss (1e-5 relative) and trainable gradients (1e-4 of
  each tensor's max |g|: the backward through two layers of each tower in
  another summation order) against `jax.value_and_grad` over the JAX
  trainable partition, written here after JAX `make_train_step`'s loss_fn;
- AdamW on identical gradients against the JAX train state over two steps,
  atol 1e-7 (optax applies weight decay inside the update, torch before it:
  at most an ulp or so of parameters of |p| < 1), for the trainable, frozen
  and logit-scale groups;
- the schedules at every step of a 50-step run (rtol 1e-5 + atol 1e-12:
  JAX evaluates cos and powers in float32, the port in double);
- the trainable / frozen / scale labels;
- and, with no JAX counterpart to compare: the LoRA adapters start as the
  zero function, the learnable logit scale crosses over, frozen weights
  stored in bf16 change nothing under bf16 compute, and `train_epoch`
  lowers the loss on a repeated batch.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioscan_clip_tpu.losses.contrastive import (
    multimodal_contrastive_loss as jax_contrastive_loss,
)
from bioscan_clip_tpu.models.bert import (
    BarcodeBertDnaEncoder as JaxDna,
    BertConfig as JaxBertConfig,
    BertTextEncoder as JaxText,
)
from bioscan_clip_tpu.models.clip import MultiModalCLIP as JaxCLIP
from bioscan_clip_tpu.models.common import row_seeds_init as jax_row_seeds
from bioscan_clip_tpu.models.vit import ViT as JaxViT, ViTConfig as JaxViTConfig
from bioscan_clip_tpu.train import schedules as jax_schedules
from bioscan_clip_tpu.train.loop import (
    logit_scale_value as jax_logit_scale_value,
    make_logit_scale_param as jax_make_logit_scale_param,
)
from bioscan_clip_tpu.train.state import (
    create_train_state as jax_create_train_state,
    grads_to_full_tree,
    merge_partitions,
    param_labels as jax_param_labels,
    partition_params,
)
from bioscan_clip_tpu_torch.interop.weights import (
    load_into,
    state_dict_from_jax,
)
from bioscan_clip_tpu_torch.losses.contrastive import (
    multimodal_contrastive_loss,
)
from bioscan_clip_tpu_torch.models.clip import init_weights
from bioscan_clip_tpu_torch.train import schedules
from bioscan_clip_tpu_torch.train.loop import (
    LOGIT_SCALE,
    device_batch,
    logit_scale_value,
    make_logit_scale_param,
    make_train_step,
    train_epoch,
)
from bioscan_clip_tpu_torch.train.state import (
    cast_frozen_params,
    create_train_state,
    param_labels,
)
from test_torch_towers import BERT, D_OUT, VIT, jax_params, port_embed, \
    port_model

B = 4
STEP_SEED = 0x1234ABCD


def jax_model():
    """The towers test's tiny model with the default dropout (0.1)."""
    return JaxCLIP(
        image_encoder=JaxViT(JaxViTConfig(**VIT, lora_rank=2)),
        dna_encoder=JaxDna(JaxBertConfig(vocab_size=1027, lora_rank=2,
                                         **BERT), output_dim=D_OUT),
        language_encoder=JaxText(JaxBertConfig(vocab_size=30522, lora_rank=2,
                                               **BERT), output_dim=D_OUT),
    )


def train_batch(seed=0, b=B):
    rng = np.random.default_rng(seed)
    mask = (np.arange(20)[None, :]
            < rng.integers(6, 21, size=(b, 1))).astype(np.int64)
    return {
        "image_u8": rng.integers(0, 256, size=(b, 224, 224, 3),
                                 dtype=np.uint8),
        "dna": rng.integers(0, 1027, size=(b, 133)),
        "language": {"input_ids": rng.integers(0, 30522, size=(b, 20)) * mask,
                     "token_type_ids": np.zeros((b, 20), np.int64),
                     "attention_mask": mask},
        "labels": np.arange(b),
    }


def jax_embed_train(m, params, batch, seeds):
    v = {"params": {k: p for k, p in params.items() if k != "logit_scale"}}
    image = jnp.asarray(batch["image_u8"], jnp.float32) / 255.0
    lang = {k: jnp.asarray(a) for k, a in batch["language"].items()}
    return {
        "image": m.apply(v, image, deterministic=False,
                         method=m.encode_image),
        "dna": m.apply(v, jnp.asarray(batch["dna"]), deterministic=False,
                       row_seeds=seeds["dna"], method=m.encode_dna),
        "language": m.apply(v, lang, deterministic=False,
                            row_seeds=seeds["language"],
                            method=m.encode_language),
    }


def jax_tower_seeds(bits, b):
    rows = jnp.arange(b)
    return {"dna": jax_row_seeds(jnp.uint32(bits ^ 0x0D5A17), rows),
            "language": jax_row_seeds(jnp.uint32(bits ^ 0x7A9C33), rows)}


@pytest.fixture(scope="module")
def params():
    return jax_params(seed=7)


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setenv("BSCAN_FUSED_ATTENTION", "1")
    monkeypatch.setenv("BSCAN_PALLAS_MHA_BWD", "0")


def test_train_mode_towers_match_jax(params, fused):
    batch = train_batch(1)
    seeds = jax_tower_seeds(0xBEEF, B)
    ref = jax_embed_train(jax_model(), params, batch, seeds)
    model = load_into(port_model(), state_dict_from_jax(params)).train()
    x = device_batch(batch, "cpu")
    t_seeds = {k: torch.from_numpy(np.asarray(v).astype(np.int64))
               for k, v in seeds.items()}
    with torch.no_grad():
        out = {
            "image": model.encode_image(x["image_u8"].float() / 255.0),
            "dna": model.encode_dna(x["dna"], row_seeds=t_seeds["dna"]),
            "language": model.encode_language(
                x["language"], row_seeds=t_seeds["language"]),
        }
    for name in out:
        np.testing.assert_allclose(out[name].numpy(), np.asarray(ref[name]),
                                   atol=1e-4, err_msg=name)
    # dropout did act: eval mode gives another dna embedding
    with torch.no_grad():
        plain = model.eval().encode_dna(x["dna"])
    assert (plain - out["dna"]).abs().max().item() > 1e-3


@pytest.mark.parametrize("present", [("image", "dna", "language"),
                                     ("dna", "language")])
def test_loss_matches_jax(present):
    rng = np.random.default_rng(2)
    labels = np.array([0, 0, 1, 2, 2, 2])  # BIN-style repeated labels
    embs = {k: rng.standard_normal((6, D_OUT)).astype(np.float32)
            for k in ("image", "dna", "language")}
    embs = {k: (v if k in present else None) for k, v in embs.items()}
    ref = float(jax_contrastive_loss(
        {k: None if v is None else jnp.asarray(v) for k, v in embs.items()},
        jnp.asarray(labels), 1 / 0.07))
    out = multimodal_contrastive_loss(
        {k: None if v is None else torch.from_numpy(v)
         for k, v in embs.items()}, torch.from_numpy(labels), 1 / 0.07)
    assert out.item() == pytest.approx(ref, rel=1e-6)
    with pytest.raises(ValueError):
        multimodal_contrastive_loss({"dna": torch.zeros(2, 3)},
                                    torch.arange(2))


def test_train_step_loss_and_grads_match_jax(params, fused):
    """The loss and the trainable gradients of one step (learnable logit
    scale included) against jax.value_and_grad over the JAX trainable
    partition, with the row seeds both packages derive from one seed."""
    batch = train_batch(3)
    p_jax = jax_make_logit_scale_param(dict(params))
    trainable, frozen = partition_params(p_jax, jax_param_labels(p_jax))
    m = jax_model()
    seeds = jax_tower_seeds(STEP_SEED, B)

    def loss_t(tr):
        p = merge_partitions(tr, frozen)
        return jax_contrastive_loss(
            jax_embed_train(m, p, batch, seeds), jnp.asarray(batch["labels"]),
            jax_logit_scale_value(p, LOGIT_SCALE))

    loss_ref, g_tr = jax.jit(jax.value_and_grad(loss_t))(trainable)
    g_ref = state_dict_from_jax(jax.tree.map(
        np.array, grads_to_full_tree(g_tr, p_jax)))

    model = make_logit_scale_param(port_model())
    load_into(model, state_dict_from_jax(p_jax))
    create_train_state(model, schedules.constant(1e-3))
    step = make_train_step(model)
    model.train()
    loss = step.loss_fn(device_batch(batch, "cpu"), STEP_SEED)
    loss.backward()
    assert loss.item() == pytest.approx(float(loss_ref), rel=1e-5)
    n_trainable = 0
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None
            continue
        n_trainable += 1
        ref = g_ref[name].numpy()
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (name, err)
    assert n_trainable > 20


def test_adamw_matches_jax_train_state(params):
    """Given identical gradients, two updates of the port's masked AdamW
    equal `create_train_state(...).apply_gradients` of the JAX package."""
    p_jax = jax_make_logit_scale_param(dict(params))

    def sched(step):
        return 1e-3 * (1 + step)

    st_jax = jax_create_train_state(jax_model(), p_jax, sched)
    model = make_logit_scale_param(port_model())
    load_into(model, state_dict_from_jax(p_jax))
    state = create_train_state(model, sched)
    rng = np.random.default_rng(4)
    for _ in range(2):
        g = jax.tree.map(lambda x: 1e-2 * rng.standard_normal(
            np.shape(x)).astype(np.float32), p_jax)
        st_jax = st_jax.apply_gradients(jax.tree.map(jnp.asarray, g))
        g_port = state_dict_from_jax(g)
        for name, p in model.named_parameters():
            p.grad = g_port[name] if p.requires_grad else None
        state.apply_gradients()
    assert state.step == int(st_jax.step) == 2
    ref = state_dict_from_jax(jax.tree.map(np.array, st_jax.params))
    labels = param_labels(model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=0, atol=1e-7, err_msg=name)
    assert {"trainable", "frozen", "scale"} == set(labels.values())


@pytest.mark.parametrize("name,lr_config", [
    (None, None), ("one_cycle", {"max_lr": 2e-3}), ("exponential", None),
    ("step", {"lr": 5e-4}), ("cosine", {"lr": 1e-3, "min_lr": 1e-6}),
])
def test_schedules_match_jax(name, lr_config):
    mc = types.SimpleNamespace(lr_scheduler=name)
    if lr_config is not None:
        mc.lr_config = types.SimpleNamespace(**lr_config)
    ref = jax_schedules.build_schedule(mc, 50)
    out = schedules.build_schedule(mc, 50)
    steps = np.arange(50)
    np.testing.assert_allclose(
        [out(int(s)) for s in steps],
        [float(ref(jnp.int32(s))) for s in steps], rtol=1e-5, atol=1e-12)


def test_param_labels_match_jax(params):
    p_jax = jax_make_logit_scale_param(dict(params))
    code = {"frozen": 0.0, "trainable": 1.0, "scale": 2.0}
    coded = jax.tree.map(
        lambda lab, p: np.full(np.shape(p), code[lab], np.float32),
        jax_param_labels(p_jax), p_jax)
    ref = state_dict_from_jax(coded)
    model = make_logit_scale_param(port_model())
    labels = param_labels(model)
    assert set(labels) == set(ref)
    for name, lab in labels.items():
        assert set(np.unique(ref[name].numpy())) == {code[lab]}, name
    # LoRA adapters and the fresh heads train; the pretrained trunk does not
    assert labels["language_encoder.proj.weight"] == "trainable"
    assert labels[
        "image_encoder.lora_vit.patch_embed.proj.weight"] == "frozen"
    assert param_labels(model, disable_lora=True)[
        "image_encoder.lora_vit.blocks.0.mlp.fc1.weight"] == "trainable"


def _drop_adapters(sd):
    """The state dict of the same architecture at LoRA rank 0, adapter
    entries dropped (not folded)."""
    out = {}
    for key, val in sd.items():
        if any(t in key for t in (".linear_a_", ".linear_b_", ".w_a.",
                                  ".w_b.")):
            continue
        out[key.replace(".qkv.qkv.", ".qkv.").replace(".w.", ".")] = val
    return out


def test_lora_adapters_start_as_the_zero_function():
    model = init_weights(port_model(), seed=3)
    for name, p in model.named_parameters():
        if ".linear_b_" in name or ".w_b." in name:
            assert not p.any(), name
        if ".linear_a_" in name or ".w_a." in name:
            bound = p.shape[1] ** -0.5
            assert 0 < p.abs().max().item() <= bound, name
    rank0 = port_model(rank=0)
    rank0.load_state_dict(_drop_adapters(model.state_dict()), strict=True)
    x = {"image": np.random.default_rng(5).standard_normal(
        (2, 224, 224, 3)).astype(np.float32),
        **{k: v for k, v in train_batch(5, 2).items()
           if k in ("dna", "language")}}
    a, b = port_embed(model, x), port_embed(rank0, x)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_logit_scale_crosses_over(params):
    """`state_dict_from_jax` keeps the learnable logit scale
    (`learnable_logit_scale: true`) under the port's `logit_scale`."""
    p_jax = jax_make_logit_scale_param(dict(params))
    p_jax["logit_scale"] = p_jax["logit_scale"] + 0.25  # a trained value
    sd = state_dict_from_jax(p_jax)
    assert sd["logit_scale"].shape == ()
    model = load_into(make_logit_scale_param(port_model()), sd)
    assert model.state_dict()["logit_scale"].item() == float(
        p_jax["logit_scale"])
    assert logit_scale_value(model, LOGIT_SCALE).item() == pytest.approx(
        float(jax_logit_scale_value(p_jax, LOGIT_SCALE)), rel=1e-6)
    fresh = make_logit_scale_param(port_model())
    assert fresh.logit_scale.item() == pytest.approx(np.log(LOGIT_SCALE),
                                                     rel=1e-6)
    assert logit_scale_value(port_model(), LOGIT_SCALE) == LOGIT_SCALE


def test_frozen_bf16_storage_is_bit_identical(params):
    """`cast_frozen_params` (tpu.frozen_dtype: bfloat16) leaves the bf16
    compute unchanged, and keeps LayerNorm and trainable parameters fp32."""
    from bioscan_clip_tpu_torch.models.bert import (
        BarcodeBertDnaEncoder,
        BertConfig,
    )
    from bioscan_clip_tpu_torch.models.clip import MultiModalCLIP

    def model():
        return load_into(MultiModalCLIP(dna_encoder=BarcodeBertDnaEncoder(
            BertConfig(vocab_size=1027, lora_rank=2, **BERT),
            output_dim=D_OUT, dtype=torch.bfloat16)).eval(),
            {k: v for k, v in state_dict_from_jax(params).items()
             if k.startswith("dna_encoder.")})

    dna = torch.from_numpy(train_batch(6)["dna"])
    a = model()
    b = cast_frozen_params(model())
    with torch.no_grad():
        np.testing.assert_array_equal(a.encode_dna(dna).numpy(),
                                      b.encode_dna(dna).numpy())
    labels = param_labels(b)
    for name, p in b.named_parameters():
        want = (torch.bfloat16 if labels[name] == "frozen"
                and "LayerNorm" not in name else torch.float32)
        assert p.dtype == want, name


def test_train_epoch_lowers_the_loss(params, tmp_path):
    model = load_into(port_model(), state_dict_from_jax(params))
    state = create_train_state(model, schedules.constant(1e-3))
    step = make_train_step(model)
    batch = train_batch(8, 8)
    state, stats = train_epoch(state, step, [batch] * 3,
                               torch.Generator().manual_seed(0), epoch=0,
                               total_epochs=1, profile_dir=str(tmp_path),
                               profile_steps=2)
    losses = stats["losses"]
    assert state.step == 3 and len(losses) == 3
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert stats["samples_per_s"] > 0 and "samples_per_s_steady" in stats
    assert (tmp_path / "trace.json").is_file()
    # remat=True runs each tower under a checkpoint: the same loss
    b = device_batch(batch, "cpu")
    assert (make_train_step(model, remat=True).loss_fn(b, 7).item()
            == step.loss_fn(b, 7).item())
