"""The port's supervised fine-tuning (bioscan_clip_tpu_torch/train/
fine_tuning.py) against the JAX package on the same weights and inputs:
a 2-layer width-32 ViT (224 / 32 patches, `lora_rank=0`, as the full ViT
fine-tune builds it) and, for the joint step, that ViT with LoRA rank 2 and
a 2-layer width-32 BarcodeBERT, each under a 5-way `EncoderWithHead`,
dropout 0, pre-transformed float images (JAX draws its augmentation and
dropout from its PRNG key, the port from (step seed, row)), B = 8 on a
1-device JAX mesh. Every parameter trains (optax.adamw(1e-3), weight decay
1e-4, against the port's `create_fine_tune_state`):
- the losses of two steps within 1e-5 relative;
- each step's gradients within atol 1e-4 (JAX's read off AdamW's first
  moment; the backward through two layers in another summation order);
- every parameter after the 2 steps within atol 1e-6, the port's AdamW
  given JAX's gradients (optax applies weight decay inside the update,
  torch before it). Its own gradients are not used there: AdamW divides
  each gradient by its own scale, so where one is zero in exact arithmetic
  (the attention key biases: a softmax ignores a shift of a row) or tiny,
  the packages' fp32 noise becomes steps of up to lr;
- `evaluate_classifier` on float and uint8 (device eval transform) batches
  with equal top-1/3/5 accuracies; `label_batch_to_species_idx` and
  `get_all_unique_species_from_loader` equal.
Each JAX step is jitted once for the file; the weights are seeded numpy
arrays in the shapes of the models' `init`."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bioscan_clip_tpu.models.bert import (
    BarcodeBertDnaEncoder as JaxDna,
    BertConfig as JaxBertConfig,
)
from bioscan_clip_tpu.models.heads import EncoderWithHead as JaxHead
from bioscan_clip_tpu.models.vit import ViT as JaxViT, ViTConfig as JaxViTConfig
from bioscan_clip_tpu.parallel.mesh import (
    create_mesh,
    replicated,
    shard_batch,
)
from bioscan_clip_tpu.train import fine_tuning as jax_ft
from bioscan_clip_tpu.train.state import TrainState
from bioscan_clip_tpu_torch.interop.weights import _vit, state_dict_from_jax
from bioscan_clip_tpu_torch.models.bert import (
    BarcodeBertDnaEncoder,
    BertConfig,
)
from bioscan_clip_tpu_torch.models.heads import EncoderWithHead
from bioscan_clip_tpu_torch.models.vit import ViT, ViTConfig, ViTImageEncoder
from bioscan_clip_tpu_torch.train import fine_tuning as ft
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, N_CLASSES, D_OUT = 8, 5, 24
VIT = dict(image_size=224, patch_size=32, hidden_size=32, num_layers=2,
           num_heads=2, num_classes=D_OUT)
BERT = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
NO_DROP = dict(hidden_dropout=0.0, attention_dropout=0.0)
SPECIES = [f"s{i}" for i in range(N_CLASSES)]


def head_state_dict(params, tower_sd):
    """The port's EncoderWithHead state dict: the encoder's entries (from
    the JAX tree under "encoder") and the head's."""
    sd = dict(tower_sd)
    k = np.asarray(params["new_linear_layer"]["kernel"], np.float32)
    sd["new_linear_layer.weight"] = torch.from_numpy(np.ascontiguousarray(
        k.T))
    sd["new_linear_layer.bias"] = torch.from_numpy(np.asarray(
        params["new_linear_layer"]["bias"], np.float32))
    return sd


def vit_head_sd(params, prefix="encoder."):
    return head_state_dict(params, {k: torch.from_numpy(v) for k, v in
                                    _vit(params["encoder"], prefix).items()})


def dna_head_sd(params):
    sd = state_dict_from_jax({"dna_encoder": params["encoder"]})
    return head_state_dict(params, {"encoder." + k[len("dna_encoder."):]: v
                                    for k, v in sd.items()})


def images(rng, b=B):
    return rng.random((b, 224, 224, 3), dtype=np.float32)


def jax_state(params, mesh):
    """The JAX CLIs' state, replicated on `mesh` as the step returns it (so
    the second step reuses the first's compile)."""
    tx = optax.adamw(1e-3)
    return jax.device_put(
        TrainState(step=jnp.zeros((), jnp.int32), params=params,
                   opt_state=tx.init(params), tx=tx, apply_fn=None),
        replicated(mesh))


def seeded_like(shapes, seed=0):
    """Seeded numpy weights in the shapes of a JAX parameter tree (leaves
    with `.shape`): kernels, embeddings and adapters lecun-normal over
    their fan-in (a patch kernel's is its patch), norm scales near 1,
    small biases."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        shape, name = leaf.shape, path[-1].key
        if name == "scale":
            w = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "bias":
            w = 0.02 * rng.standard_normal(shape)
        else:
            fan_in = (np.prod(shape[:-1]) if len(shape) == 4
                      else shape[-2] if len(shape) > 1 else 1)
            w = rng.standard_normal(shape) / np.sqrt(fan_in)
        return w.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_init(model, x, seed=0):
    """`seeded_like` the shapes of `model.init`, which is traced
    (`eval_shape`), never compiled."""
    return seeded_like(jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), x))["params"], seed)


def run_jax(step, params, batch, mesh):
    """Two JAX steps on `batch` -> (losses, each step's gradients, the
    parameters after them). The gradients are read off AdamW's first
    moment: mu_1 = 0.1 g_1, mu_2 = 0.9 mu_1 + 0.1 g_2."""
    state, losses, mus = jax_state(params, mesh), [], []
    for _ in range(2):
        state, loss = step(state, shard_batch(batch, mesh),
                           jax.random.PRNGKey(9))
        losses.append(float(loss))
        mus.append(jax.tree.map(np.array, state.opt_state[0].mu))
    grads = [jax.tree.map(lambda m: m / 0.1, mus[0]),
             jax.tree.map(lambda m1, m2: (m2 - 0.9 * m1) / 0.1, *mus)]
    return dict(losses=losses, grads=grads,
                final=jax.tree.map(np.array, state.params))


@pytest.fixture(scope="module")
def mesh():
    # one device: the SPMD partitioner's compile time is not the subject
    return create_mesh(devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def vit_case(mesh):
    """The JAX classifier step's 2 steps on one batch: (init params, the
    batch, losses, first-step grads, params after 2 steps)."""
    clf = JaxHead(JaxViT(JaxViTConfig(**VIT, lora_rank=0)), N_CLASSES)
    params = jax_init(clf, jnp.zeros((2, 224, 224, 3)))
    rng = np.random.default_rng(0)
    batch = {"input": images(rng),
             "target": rng.integers(0, N_CLASSES, size=B)}
    step = jax_ft.make_classifier_train_step(clf, mesh, modality="image")
    return dict(model=clf, params=params, batch=batch,
                **run_jax(step, params, batch, mesh))


@pytest.fixture(scope="module")
def joint_case(mesh):
    img = JaxHead(JaxViT(JaxViTConfig(**VIT, lora_rank=2)), N_CLASSES)
    dna = JaxHead(JaxDna(JaxBertConfig(vocab_size=1027, lora_rank=2, **BERT,
                                       **NO_DROP), output_dim=D_OUT),
                  N_CLASSES)
    params = {"image": jax_init(img, jnp.zeros((2, 224, 224, 3)), seed=1),
              "dna": jax_init(dna, jnp.zeros((2, 133), jnp.int32), seed=2)}
    rng = np.random.default_rng(1)
    batch = {"image": images(rng),
             "dna": rng.integers(3, 1027, size=(B, 133)).astype(np.int32),
             "target": rng.integers(0, N_CLASSES, size=B)}
    step = jax_ft.make_joint_classifier_train_step(img, dna, mesh)
    return dict(params=params, batch=batch,
                **run_jax(step, params, batch, mesh))


def port_vit_classifier(params):
    clf = EncoderWithHead(ViT(ViTConfig(**VIT, lora_rank=0)), D_OUT,
                          N_CLASSES)
    clf.load_state_dict(vit_head_sd(params), strict=True)
    return clf


def port_joint(params):
    img = EncoderWithHead(ViTImageEncoder(ViTConfig(**VIT, lora_rank=2)),
                          D_OUT, N_CLASSES)
    img.load_state_dict(vit_head_sd(params["image"], "encoder.lora_vit."),
                        strict=True)
    dna = EncoderWithHead(BarcodeBertDnaEncoder(
        BertConfig(vocab_size=1027, lora_rank=2, **BERT, **NO_DROP),
        output_dim=D_OUT), D_OUT, N_CLASSES)
    dna.load_state_dict(dna_head_sd(params["dna"]), strict=True)
    return img, dna


def run_port(step, state, batch):
    """Two steps on `batch` -> (losses, each step's gradients)."""
    tb = {k: torch.from_numpy(v if v.dtype.kind == "f"
                              else v.astype(np.int64))
          for k, v in batch.items()}
    losses, grads = [], []
    for i in range(2):
        state, loss = step(state, tb, 0x5EED + i)
        losses.append(loss.item())
        grads.append({n: p.grad.clone()
                      for n, p in state.model.named_parameters()})
    return losses, grads


def check(ref, losses, grads, fresh, sd_of):
    """The port's two steps against JAX's (losses, gradients); then AdamW
    on a fresh copy of the initial model given JAX's two gradients against
    JAX's parameters after its steps."""
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    for got, want in zip(grads, ref["grads"]):
        g_ref = sd_of(want)
        assert set(g_ref) == set(got)
        for name, g in g_ref.items():
            np.testing.assert_allclose(got[name].numpy(), g.numpy(),
                                       atol=1e-4, err_msg=name)
    state = ft.create_fine_tune_state(fresh)
    named = dict(fresh.named_parameters())
    for g in ref["grads"]:
        for name, t in sd_of(g).items():
            named[name].grad = t.clone()
        state.apply_gradients()
    want = sd_of(ref["final"])
    for name, t in fresh.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), atol=1e-6,
                                   err_msg=name)


def test_classifier_step_matches_jax(vit_case):
    clf = port_vit_classifier(vit_case["params"])
    state = ft.create_fine_tune_state(clf)
    assert set(state.labels.values()) == {"trainable"}
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in clf.parameters())
    losses, grads = run_port(ft.make_classifier_train_step(clf), state,
                             vit_case["batch"])
    assert state.step == 2
    check(vit_case, losses, grads, port_vit_classifier(vit_case["params"]),
          vit_head_sd)


def test_joint_step_matches_jax(joint_case):
    step = ft.make_joint_classifier_train_step(
        *port_joint(joint_case["params"]))
    state = ft.create_fine_tune_state(step.model)
    losses, grads = run_port(step, state, joint_case["batch"])

    def sd_of(tree):
        return ({"image." + k: v for k, v in
                 vit_head_sd(tree["image"], "encoder.lora_vit.").items()}
                | {"dna." + k: v for k, v in dna_head_sd(tree["dna"]).items()})

    check(joint_case, losses, grads,
          torch.nn.ModuleDict(dict(zip(("image", "dna"),
                                       port_joint(joint_case["params"])))),
          sd_of)


def test_step_refuses_another_state(vit_case):
    clf = port_vit_classifier(vit_case["params"])
    other = ft.create_fine_tune_state(port_vit_classifier(vit_case["params"]))
    with pytest.raises(ValueError, match="another model"):
        ft.make_classifier_train_step(clf)(other, {}, 0)


def eval_batches(rng, uint8):
    out = []
    for b in (8, 8, 5):
        x = (rng.integers(0, 256, size=(b, 256, 300, 3), dtype=np.uint8)
             if uint8 else images(rng, b))
        labels = [{"species": SPECIES[i]}
                  for i in rng.integers(0, N_CLASSES, size=b)]
        out.append({"image_u8" if uint8 else "image": x,
                    "label_dicts": labels})
    return out


@pytest.mark.parametrize("uint8", [False, True])
def test_evaluate_classifier_matches_jax(vit_case, mesh, uint8):
    loader = eval_batches(np.random.default_rng(5), uint8)
    unique = ft.get_all_unique_species_from_loader(loader)
    assert unique == jax_ft.get_all_unique_species_from_loader(loader)
    np.testing.assert_array_equal(
        ft.label_batch_to_species_idx(loader[0]["label_dicts"], unique),
        jax_ft.label_batch_to_species_idx(loader[0]["label_dicts"], unique))
    params = vit_case["final"]
    ref = jax_ft.evaluate_classifier(params, vit_case["model"], mesh, loader,
                                     unique)
    got = ft.evaluate_classifier(port_vit_classifier(params), loader, unique)
    assert got == ref
    assert set(got) == {"top1_accuracy", "top3_accuracy", "top5_accuracy"}
