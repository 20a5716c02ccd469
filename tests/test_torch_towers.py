"""Port towers (bioscan_clip_tpu_torch/models) against the JAX towers on the
same weights: JAX `init_clip_params` on a tiny tri-modal model, perturbed so
every LoRA adapter and bias is non-zero, then `state_dict_from_jax`, then
`load_state_dict(strict=True)` into the port.

Tolerances (fp32 on the CPU, JAX attention through its fused Pallas kernel
in interpret mode):
- normalized embeddings, atol 1e-4: two layers of fp32 matmuls, LayerNorms
  (flax uses E[x^2]-E[x]^2, torch a two-pass variance) and GELU in another
  order;
- LoRA merged vs unmerged, atol 1e-5: the fold W + (A @ B)^T reassociates
  one product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioscan_clip_tpu.models.bert import (
    BarcodeBertDnaEncoder as JaxDna,
    BertConfig as JaxBertConfig,
    BertTextEncoder as JaxText,
)
from bioscan_clip_tpu.models.clip import (
    MultiModalCLIP as JaxCLIP,
    init_clip_params,
)
from bioscan_clip_tpu.models.vit import ViT as JaxViT, ViTConfig as JaxViTConfig
from bioscan_clip_tpu_torch.interop.weights import (
    load_into,
    load_reference_pth,
    state_dict_from_jax,
)
from bioscan_clip_tpu_torch.models.bert import (
    BarcodeBertDnaEncoder,
    BertConfig,
    BertTextEncoder,
)
from bioscan_clip_tpu_torch.models.clip import MultiModalCLIP
from bioscan_clip_tpu_torch.models.lora import merge_lora
from bioscan_clip_tpu_torch.models.vit import ViTConfig, ViTImageEncoder

ATOL = 1e-4
D_OUT = 24
VIT = dict(image_size=224, patch_size=32, hidden_size=64, num_layers=2,
           num_heads=4, num_classes=D_OUT)
BERT = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)


def jax_model(rank=2):
    drop = dict(hidden_dropout=0.0, attention_dropout=0.0)
    return JaxCLIP(
        image_encoder=JaxViT(JaxViTConfig(**VIT, lora_rank=rank)),
        dna_encoder=JaxDna(
            JaxBertConfig(vocab_size=1027, lora_rank=rank, **BERT, **drop),
            output_dim=D_OUT),
        language_encoder=JaxText(
            JaxBertConfig(vocab_size=30522, lora_rank=rank, **BERT, **drop),
            output_dim=D_OUT),
    )


def port_model(rank=2):
    return MultiModalCLIP(
        image_encoder=ViTImageEncoder(ViTConfig(**VIT, lora_rank=rank)),
        dna_encoder=BarcodeBertDnaEncoder(
            BertConfig(vocab_size=1027, lora_rank=rank, **BERT),
            output_dim=D_OUT),
        language_encoder=BertTextEncoder(
            BertConfig(vocab_size=30522, lora_rank=rank, **BERT),
            output_dim=D_OUT),
    ).eval()


def jax_params(seed=0, rank=2):
    model = jax_model(rank)
    # jitted: one compile instead of op-by-op dispatch of the init
    params = jax.jit(lambda key: init_clip_params(model, key))(
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        params,
    )


def inputs(seed=0, b=3):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, 20), np.int32)
    mask[0, 9:] = 0
    mask[-1, 14:] = 0
    return {
        "image": rng.standard_normal((b, 224, 224, 3)).astype(np.float32),
        "dna": rng.integers(0, 1027, size=(b, 133)).astype(np.int32),
        "language": {
            "input_ids": rng.integers(0, 30522, size=(b, 20)).astype(np.int32),
            "token_type_ids": np.zeros((b, 20), np.int32),
            "attention_mask": mask,
        },
    }


def jax_embed(params, x, monkeypatch):
    monkeypatch.setenv("BSCAN_FUSED_ATTENTION", "1")
    m = jax_model()
    v = {"params": params}
    lang = {k: jnp.asarray(a) for k, a in x["language"].items()}
    return {
        "image": np.asarray(m.apply(v, jnp.asarray(x["image"]),
                                    method=m.encode_image)),
        "dna": np.asarray(m.apply(v, jnp.asarray(x["dna"]),
                                  method=m.encode_dna)),
        "language": np.asarray(m.apply(v, lang, method=m.encode_language)),
    }


def port_embed(model, x):
    t = {k: torch.from_numpy(a.astype(np.int64))
         for k, a in x["language"].items()}
    with torch.inference_mode():
        return {
            "image": model.encode_image(torch.from_numpy(x["image"])).numpy(),
            "dna": model.encode_dna(
                torch.from_numpy(x["dna"].astype(np.int64))).numpy(),
            "language": model.encode_language(t).numpy(),
        }


@pytest.fixture(scope="module")
def params():
    return jax_params()


def test_state_dict_from_jax_loads_strict(params):
    sd = state_dict_from_jax(params)
    model = port_model()
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)


def test_towers_match_jax(params, monkeypatch):
    x = inputs()
    ref = jax_embed(params, x, monkeypatch)
    model = load_into(port_model(), state_dict_from_jax(params))
    out = port_embed(model, x)
    for name in ("image", "dna", "language"):
        assert out[name].shape == ref[name].shape == (3, D_OUT)
        np.testing.assert_allclose(out[name], ref[name], atol=ATOL,
                                   err_msg=name)


def test_jax_export_pth_loads(params, tmp_path):
    """The tree the JAX package writes with interop/torch_export.save_pth
    (reference layout) loads through load_reference_pth."""
    from bioscan_clip_tpu.interop.torch_export import save_pth

    path = save_pth(params, str(tmp_path / "best.pth"))
    sd = load_reference_pth(path)
    # DDP-wrapped checkpoints load the same way, and so do the entries the
    # reference model carries but never reads (HF pooler, the MLM bias)
    extra = {
        "language_encoder.lora_bert.pooler.dense.weight": torch.zeros(32, 32),
        "language_encoder.lora_bert.pooler.dense.bias": torch.zeros(32),
        "dna_encoder.lora_barcode_bert.cls.predictions.bias": torch.zeros(1027),
    }
    torch.save({"state_dict": {"module." + k: v
                               for k, v in {**sd, **extra}.items()}},
               tmp_path / "ddp.pth")
    for p in (path, tmp_path / "ddp.pth"):
        model = load_into(port_model(), load_reference_pth(str(p)))
        x = inputs(seed=1, b=2)
        a = port_embed(model, x)
        b = port_embed(load_into(port_model(), state_dict_from_jax(params)),
                       x)
        for name in a:
            np.testing.assert_array_equal(a[name], b[name])


def test_merge_lora_keeps_outputs(params):
    model = load_into(port_model(), state_dict_from_jax(params))
    merged_sd = merge_lora(model.state_dict())
    assert not any("linear_a" in k or ".w_a." in k for k in merged_sd)
    merged = port_model(rank=0)
    merged.load_state_dict(merged_sd, strict=True)
    x = inputs(seed=2)
    a, b = port_embed(model, x), port_embed(merged, x)
    for name in a:
        np.testing.assert_allclose(b[name], a[name], atol=1e-5,
                                   err_msg=name)


def test_bert_towers_are_eval_only():
    """The BERT towers start in eval mode; train mode (dropout) needs the
    row-keyed seeds, the port's only dropout mode."""
    model = port_model()
    assert not model.dna_encoder.lora_barcode_bert.bert.training
    assert not model.language_encoder.lora_bert.training
    model.train()
    with pytest.raises(ValueError, match="row_seeds"):
        model.encode_dna(torch.zeros(2, 133, dtype=torch.long))
