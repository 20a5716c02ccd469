"""The OpenCLIP ablation's training slice of the port against the JAX
package, and the port's train-state checkpoints.

The model is the OpenCLIP towers of tests/test_torch_openclip.py at the
ViT-L/14 geometry cut to width 32 (224-pixel images, patch 14, 257 tokens;
text at context 20, the WordPiece length the loader gives every model), 2
layers, 4 heads, LoRA rank 4, plus a 2-layer BarcodeBERT with dropout 0.1;
JAX params perturbed so every adapter is non-zero, carried to the port by
`state_dict_from_jax`. JAX attention runs through its fused Pallas kernels
in interpret mode (`BSCAN_FUSED_ATTENTION=1`), the backward through its XLA
math or its Pallas kernel (K3m on the text tower) by `BSCAN_PALLAS_MHA_BWD`.
- one train step (CLIP-normalized uint8 images, row-keyed DNA dropout from
  one step seed): the loss within 1e-5 relative, each trainable gradient
  within 1e-4 of its max |g| (two layers of fp32 products summed in another
  order), against `jax.value_and_grad` over the JAX trainable partition;
- the trainable / frozen labels, and the leaves `cast_frozen_params` stores
  in bf16, equal to JAX's;
- save -> restore -> continue equal bit for bit to an uninterrupted run on
  the CPU (bf16 compute, frozen weights in bf16): losses, parameters, AdamW
  moments, step and step-seed generator; a failed write leaves the previous
  checkpoint valid;
- `load_pretrained_towers` on synthetic open_clip, BarcodeBERT, timm ViT and
  bert-small state dicts equal to JAX `load_pretrained_towers` followed by
  `state_dict_from_jax`, exactly (fp32 copies).
"""

import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioscan_clip_tpu.data.transforms import CLIP_MEAN, CLIP_STD
from bioscan_clip_tpu.losses.contrastive import (
    multimodal_contrastive_loss as jax_contrastive_loss,
)
from bioscan_clip_tpu.models.bert import (
    BarcodeBertDnaEncoder as JaxDna,
    BertConfig as JaxBertConfig,
)
from bioscan_clip_tpu.models.clip import MultiModalCLIP as JaxCLIP
from bioscan_clip_tpu.models.clip import init_clip_params
from bioscan_clip_tpu.models.common import row_seeds_init as jax_row_seeds
from bioscan_clip_tpu.models.openclip import (
    OpenClipImageTower as JaxImage,
    OpenClipTextAdapter as JaxTextAdapter,
    OpenClipTextConfig as JaxTextConfig,
    OpenClipVisionConfig as JaxVisionConfig,
)
from bioscan_clip_tpu.train.checkpoint import (
    load_pretrained_towers as jax_load_pretrained_towers,
)
from bioscan_clip_tpu.train.state import (
    cast_frozen_params as jax_cast_frozen_params,
    grads_to_full_tree,
    merge_partitions,
    param_labels as jax_param_labels,
    partition_params,
)
from bioscan_clip_tpu_torch.interop.weights import (
    load_into,
    load_reference_pth,
    state_dict_from_jax,
)
from bioscan_clip_tpu_torch.models.bert import (
    BarcodeBertDnaEncoder,
    BertConfig,
)
from bioscan_clip_tpu_torch.models.clip import MultiModalCLIP, init_weights
from bioscan_clip_tpu_torch.models.openclip import (
    OpenClipImageTower,
    OpenClipTextAdapter,
    OpenClipTextConfig,
    OpenClipVisionConfig,
)
from bioscan_clip_tpu_torch.ops import attention
from bioscan_clip_tpu_torch.train import checkpoint, schedules
from bioscan_clip_tpu_torch.train.loop import (
    LOGIT_SCALE,
    device_batch,
    make_train_step,
    train_epoch,
)
from bioscan_clip_tpu_torch.train.state import (
    cast_frozen_params,
    create_train_state,
    param_labels,
)
from test_torch_towers import jax_model as flagship_jax_model
from test_torch_towers import jax_params as flagship_jax_params
from test_torch_towers import port_model as flagship_port_model
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

D_OUT = 24
VISION = dict(image_size=224, patch_size=14, width=32, layers=2, heads=4,
              output_dim=D_OUT, lora_rank=4)
TEXT = dict(context_length=20, vocab_size=97, width=32, layers=2, heads=4,
            output_dim=D_OUT, lora_rank=4)
BERT = dict(vocab_size=1027, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, lora_rank=4)  # dropout 0.1 by default
B = 4
STEP_SEED = 0x5EED1234


def jax_model():
    return JaxCLIP(
        image_encoder=JaxImage(JaxVisionConfig(**VISION)),
        dna_encoder=JaxDna(JaxBertConfig(**BERT), output_dim=D_OUT),
        language_encoder=JaxTextAdapter(JaxTextConfig(**TEXT)),
    )


def port_model(dtype=torch.float32):
    return MultiModalCLIP(
        image_encoder=OpenClipImageTower(OpenClipVisionConfig(**VISION),
                                         dtype),
        dna_encoder=BarcodeBertDnaEncoder(BertConfig(**BERT), D_OUT, dtype),
        language_encoder=OpenClipTextAdapter(OpenClipTextConfig(**TEXT),
                                             dtype),
    ).eval()


@pytest.fixture(scope="module")
def params():
    """JAX init params plus N(0, 0.05) noise: every LoRA B non-zero."""
    p = jax.jit(lambda key: init_clip_params(jax_model(), key))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rng.standard_normal(x.shape).astype(np.float32), p)


def train_batch(seed, b=B):
    """(224, 224, 3) uint8 frames, barcode tokens, and text ids at N = 20
    with padding (ids below the tiny vocab; the EOT pooling takes the row's
    maximum, as on WordPiece ids)."""
    rng = np.random.default_rng(seed)
    mask = (np.arange(20)[None, :]
            < rng.integers(6, 21, size=(b, 1))).astype(np.int64)
    return {
        "image_u8": rng.integers(0, 256, size=(b, 224, 224, 3),
                                 dtype=np.uint8),
        "dna": rng.integers(0, 1027, size=(b, 133)),
        "language": {"input_ids": rng.integers(1, 97, size=(b, 20)) * mask,
                     "token_type_ids": np.zeros((b, 20), np.int64),
                     "attention_mask": mask},
        "labels": np.arange(b),
    }


def jax_loss_fn(params, batch, bits):
    """JAX `make_train_step`'s loss on a pre-cropped uint8 batch with
    `openclip_norm`, the DNA tower's dropout row-keyed as the port keys it
    (the OpenCLIP text tower has no dropout and takes no row seeds)."""
    m = jax_model()
    v = {"params": params}
    image = (jnp.asarray(batch["image_u8"], jnp.float32) / 255.0
             - jnp.asarray(CLIP_MEAN)) / jnp.asarray(CLIP_STD)
    seeds = jax_row_seeds(jnp.uint32(bits ^ 0x0D5A17), jnp.arange(B))
    embs = {
        "image": m.apply(v, image, deterministic=False,
                         method=m.encode_image),
        "dna": m.apply(v, jnp.asarray(batch["dna"]), deterministic=False,
                       row_seeds=seeds, method=m.encode_dna),
        "language": m.apply(
            v, {k: jnp.asarray(a) for k, a in batch["language"].items()},
            deterministic=False, method=m.encode_language),
    }
    return jax_contrastive_loss(embs, jnp.asarray(batch["labels"]),
                                LOGIT_SCALE)


@pytest.mark.parametrize("pallas_bwd", ["0", "1"])
def test_train_step_matches_jax(params, pallas_bwd, monkeypatch):
    """One OpenCLIP train step through `make_train_step(openclip_norm=True)`
    against `jax.value_and_grad`, with JAX's XLA backward ("0") and its
    Pallas backward in interpret mode ("1", K3m on the text tower)."""
    monkeypatch.setenv("BSCAN_FUSED_ATTENTION", "1")
    monkeypatch.setenv("BSCAN_PALLAS_MHA_BWD", pallas_bwd)
    batch = train_batch(3)
    trainable, frozen = partition_params(params, jax_param_labels(params))
    loss_ref, g_tr = jax.jit(jax.value_and_grad(
        lambda tr: jax_loss_fn(merge_partitions(tr, frozen), batch,
                               STEP_SEED)))(trainable)
    g_ref = state_dict_from_jax(jax.tree.map(
        np.array, grads_to_full_tree(g_tr, params)))

    model = load_into(port_model(), state_dict_from_jax(params))
    create_train_state(model, schedules.constant(1e-3))
    step = make_train_step(model, openclip_norm=True)
    model.train()
    calls = attention.mha_bwd_reference.calls
    loss = step.loss_fn(device_batch(batch, "cpu"), STEP_SEED)
    loss.backward()
    # one plain backward per layer of each tower (the text's with the mask)
    assert attention.mha_bwd_reference.calls == calls + 6
    assert loss.item() == pytest.approx(float(loss_ref), rel=1e-5)
    n_text = 0
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None, name
            continue
        ref = g_ref[name].numpy()
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (name, err)
        if name.startswith("language_encoder."):
            n_text += 1
            assert np.abs(ref).max() > 0, name
    assert n_text == 6 * TEXT["layers"]


def test_param_labels_and_frozen_dtypes_match_jax(params):
    """`param_labels` equals JAX's label by label on open_clip's names, and
    `cast_frozen_params` stores in bf16 the leaves JAX's stores in bf16."""
    code = {"frozen": 0.0, "trainable": 1.0, "scale": 2.0}
    ref = state_dict_from_jax(jax.tree.map(
        lambda lab, p: np.full(np.shape(p), code[lab], np.float32),
        jax_param_labels(params), params))
    model = port_model()
    labels = param_labels(model)
    assert set(labels) == set(ref)
    for name, lab in labels.items():
        assert set(np.unique(ref[name].numpy())) == {code[lab]}, name
    # open_clip's projections are leaves at the tower roots: frozen
    for name in ("image_encoder.proj", "language_encoder.text.text_projection",
                 "image_encoder.transformer.resblocks.0.attn.out_proj.weight",
                 "language_encoder.text.transformer.resblocks.1.mlp.c_proj."
                 "weight"):
        assert labels[name] == "frozen", name
    lora = [n for n in labels if re.search(r"\.[qkv]_lora_[AB]$", n)]
    assert len(lora) == 6 * (VISION["layers"] + TEXT["layers"])
    assert all(labels[n] == "trainable" for n in lora)
    assert labels["dna_encoder.lora_barcode_bert.cls.predictions.decoder."
                  "weight"] == "trainable"

    bf16 = state_dict_from_jax(jax.tree.map(
        lambda x: np.full(x.shape, float(x.dtype == jnp.bfloat16),
                          np.float32),
        jax_cast_frozen_params(jax.tree.map(jnp.asarray, params))))
    cast_frozen_params(model)
    for name, p in model.named_parameters():
        want = torch.bfloat16 if bf16[name].numpy().all() else torch.float32
        assert p.dtype == want, name


def _bf16_state(params):
    model = load_into(port_model(torch.bfloat16), state_dict_from_jax(params))
    cast_frozen_params(model)
    return create_train_state(model, schedules.constant(1e-3), seed=7)


def _same_state(a, b):
    for (name, p), q in zip(a.model.named_parameters(),
                            b.model.parameters()):
        assert p.dtype == q.dtype and torch.equal(p, q), name
    for p, q in zip(a.optimizer.param_groups[0]["params"],
                    b.optimizer.param_groups[0]["params"]):
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[key], sb[key]), key
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_resume_equals_an_uninterrupted_run(params, tmp_path):
    """4 steps in one run against 2 steps, an async save, a third step
    while the write is in flight (the file holds the state at the save), a
    restore into a fresh fp32 state of other weights and seed, and 2 more
    steps: bit-equal losses, parameters (frozen ones back in bf16), AdamW
    moments, step and generator."""
    batches = [train_batch(10 + i) for i in range(4)]
    ref = _bf16_state(params)
    ref, ref_stats = train_epoch(ref, make_train_step(ref.model,
                                                      openclip_norm=True),
                                 batches, ref.generator, 0, 1)

    a = _bf16_state(params)
    step_a = make_train_step(a.model, openclip_norm=True)
    a, first = train_epoch(a, step_a, batches[:2], a.generator, 0, 1)
    checkpoint.save_checkpoint(tmp_path, a, block=False)
    train_epoch(a, step_a, batches[2:3], a.generator, 0, 1)
    checkpoint.wait_for_checkpoints()
    assert not (tmp_path / "last.writing").exists()

    fresh = init_weights(port_model(torch.bfloat16), seed=5)
    b = create_train_state(fresh, schedules.constant(1e-3), seed=99)
    assert next(fresh.parameters()).dtype == torch.float32
    checkpoint.restore_checkpoint(tmp_path, b)
    assert b.step == 2
    b, rest = train_epoch(b, make_train_step(fresh, openclip_norm=True),
                          batches[2:], b.generator, 0, 1)
    assert first["losses"] + rest["losses"] == ref_stats["losses"]
    _same_state(ref, b)
    assert fresh.image_encoder.conv1.weight.dtype == torch.bfloat16

    # the model entry reads as a reference checkpoint too
    sd = load_reference_pth(str(tmp_path / "last"))
    assert set(sd) == set(fresh.state_dict())
    with pytest.raises(ValueError, match="parameter groups"):
        checkpoint.restore_checkpoint(
            tmp_path, create_train_state(port_model(), schedules.constant(
                1e-3), disable_lora=True))


def test_a_failed_write_leaves_the_last_checkpoint(params, tmp_path,
                                                   monkeypatch):
    """A write that fails part-way leaves `last.writing` behind and `last`
    as it was; the next good save replaces both. Also `save_params_only` /
    `restore_params_only`."""
    model = load_into(port_model(), state_dict_from_jax(params))
    state = create_train_state(model, schedules.constant(1e-3))
    path = checkpoint.save_checkpoint(tmp_path, state)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    state.step = 5

    def broken(obj, f):
        f.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save_checkpoint(tmp_path, state)
    checkpoint.save_checkpoint(tmp_path, state, name="other", block=False)
    with pytest.raises(RuntimeError, match="failed"):
        checkpoint.wait_for_checkpoints()
    monkeypatch.undo()
    assert (tmp_path / "last.writing").is_file()

    checkpoint.restore_checkpoint(tmp_path, state)
    assert state.step == 0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    checkpoint.save_checkpoint(tmp_path, state)
    assert not (tmp_path / "last.writing").exists()
    assert path == str(tmp_path / "last")

    checkpoint.save_params_only(tmp_path, model)
    other = checkpoint.restore_params_only(tmp_path, port_model())
    for k, v in other.state_dict().items():
        assert torch.equal(v, before[k]), k


def _synthetic(model, rng, rename, extra=()):
    """Random fp32 tensors under the names `rename` gives the model's
    non-adapter entries (None drops one), plus `extra` {name: shape}."""
    out = {}
    for key, val in model.state_dict().items():
        if re.search(r"(_lora_[AB]|linear_[ab]_[qv]\.|\.w_[ab]\.)", key):
            continue
        new = rename(key)
        if new is not None:
            out[new] = val.shape
    out.update(extra)
    return {k: torch.from_numpy(rng.standard_normal(tuple(s)).astype(
        np.float32)) for k, s in out.items()}


def _barcode_mlm(model, rng, hidden):
    """A BarcodeBERT MLM checkpoint saved under DDP: `module.bert.*`, the
    prediction transform, a vocab-sized decoder and bias, a pooler and the
    position-id buffer."""
    pre = "dna_encoder.lora_barcode_bert."

    def rename(k):
        if not k.startswith(pre) or ".decoder." in k:
            return None
        return "module." + k[len(pre):].replace(".w.", ".")

    return _synthetic(model, rng, rename, {
        "module.cls.predictions.decoder.weight": (1027, hidden),
        "module.cls.predictions.decoder.bias": (1027,),
        "module.cls.predictions.bias": (1027,),
        "module.bert.pooler.dense.weight": (hidden, hidden),
        "module.bert.embeddings.position_ids": (1, 512)})


@pytest.mark.parametrize("which", ["openclip", "flagship"])
def test_load_pretrained_towers_matches_jax(which, tmp_path):
    """Synthetic artifacts in the reference layouts: open_clip ViT-L/14
    (`visual.*` and the text keys, one layer deeper than the model, with
    `logit_scale`) and BarcodeBERT for the ablation; timm ViT (a 1000-class
    head), BarcodeBERT and bert-small (a pooler) for the flagship."""
    rng = np.random.default_rng(11)
    if which == "openclip":
        jm, port = jax_model(), port_model()
        init = jax.tree.map(np.asarray, jax.jit(
            lambda key: init_clip_params(jm, key))(jax.random.PRNGKey(2)))
        hidden = BERT["hidden_size"]
        deeper = {}
        for k, v in port.state_dict().items():
            m = re.match(r"(.*transformer\.resblocks\.)1\.(.*)", k)
            if m and "_lora_" not in k:
                deeper[f"{m.group(1)}2.{m.group(2)}"] = v.shape

        def rename(k):
            if k.startswith("image_encoder."):
                return "visual." + k[len("image_encoder."):]
            if k.startswith("language_encoder.text."):
                return k[len("language_encoder.text."):]
            return None

        renamed = {rename(k): s for k, s in deeper.items()}
        arts = {"open_clip": _synthetic(port, rng, rename,
                                        dict(renamed, logit_scale=()))}
    else:
        jm, port = flagship_jax_model(rank=4), flagship_port_model(rank=4)
        init = flagship_jax_params(seed=3, rank=4)
        hidden = 32

        def timm(k):
            pre = "image_encoder.lora_vit."
            if not k.startswith(pre) or k.startswith(pre + "head."):
                return None
            return k[len(pre):].replace(".qkv.qkv.", ".qkv.")

        def bert_small(k):
            pre = "language_encoder.lora_bert."
            return (k[len(pre):].replace(".w.", ".") if k.startswith(pre)
                    else None)

        arts = {"timm_vit": _synthetic(port, rng, timm, {
                    "head.weight": (1000, 64), "head.bias": (1000,)}),
                "bert_small": _synthetic(port, rng, bert_small, {
                    "pooler.dense.weight": (32, 32)})}
    arts["barcode"] = _barcode_mlm(port, rng, hidden)
    paths = {}
    for name, sd in arts.items():
        paths[name] = str(tmp_path / f"{name}.pth")
        torch.save(sd, paths[name])
    args = SimpleNamespace(
        bioscan_bert_checkpoint=paths.pop("barcode"),
        pretrained_weights=SimpleNamespace(
            timm_vit=paths.get("timm_vit"), bert_small=paths.get("bert_small"),
            open_clip=paths.get("open_clip")))

    ref = state_dict_from_jax(jax.tree.map(
        np.asarray, jax_load_pretrained_towers(args, init, output_dim=D_OUT)))
    load_into(port, state_dict_from_jax(init))
    msgs = []
    checkpoint.load_pretrained_towers(args, port, output_dim=D_OUT,
                                      log=msgs.append)
    got = port.state_dict()
    assert set(got) == set(ref)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), ref[k].numpy(), err_msg=k)
    assert len(msgs) == (2 if which == "openclip" else 3)
    assert not any("random init" in m for m in msgs)
    # a tower took the checkpoint, not its init
    key = ("dna_encoder.lora_barcode_bert.bert.encoder.layer.1.attention."
           "self.key.weight")
    assert torch.equal(got[key], arts["barcode"]["module." + key[len(
        "dna_encoder.lora_barcode_bert."):]])


def test_missing_artifacts_leave_random_init(params, tmp_path):
    model = load_into(port_model(), state_dict_from_jax(params))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    msgs = []
    args = SimpleNamespace(
        bioscan_bert_checkpoint=str(tmp_path / "model_41.pth"),
        pretrained_weights=SimpleNamespace(
            open_clip=str(tmp_path / "ViT-L-14.pt")))
    checkpoint.load_pretrained_towers(args, model, output_dim=D_OUT,
                                      log=msgs.append)
    assert msgs == ["open_clip towers: no artifact; random init"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
