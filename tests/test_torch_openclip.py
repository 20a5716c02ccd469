"""The OpenCLIP ablation slice of the port against the JAX package, on the
same numpy weights and inputs (fp32 on the CPU):
- the ViT-L/14-geometry image tower and the text tower against JAX
  `OpenClipImageTower` / `OpenClipTextTower` (attention through the fused
  Pallas kernels in interpret mode: K1, and K1m under the causal mask), at
  width 32, 2 layers, 4 heads, image 28, patch 14, context 16, vocab 97,
  LoRA rank 4 with non-zero B, weights carried by `state_dict_from_jax`;
- the plain masked attention (`mha_reference(mask=)`, K1m's contract)
  against JAX `mha_packed(mask=, interpret=True)`, and its backward
  (`mha_bwd_reference(mask=)`, K3m's contract) against `jax.vjp`;
- a synthetic loratorch `open_clip_model.*` checkpoint through `load_into`
  against `convert_simple_clip_checkpoint`; `merge_lora` on `in_proj`
  against `merge_lora_params`; the factory; the CLIP tokenizer copy; the
  MLP, identity and head modules; a tiny OpenCLIP `RetrievalService`.

Tolerances: towers atol 2e-5, rtol 1e-3 (two layers of fp32 products,
LayerNorms and GELU summed in another order); attention and its backward
atol 1e-5 (an fp32 softmax over <= 16 keys); the MLP/head modules atol
1e-5; a merged model within 1e-5 of the unmerged one (the fold
reassociates one product).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioscan_clip_tpu.models import heads as jax_heads
from bioscan_clip_tpu.models import mlp as jax_mlp
from bioscan_clip_tpu.models.bert import (
    BarcodeBertDnaEncoder as JaxDna,
    BertConfig as JaxBertConfig,
)
from bioscan_clip_tpu.models.clip import MultiModalCLIP as JaxCLIP
from bioscan_clip_tpu.models.clip import init_clip_params
from bioscan_clip_tpu.models.lora import merge_lora_params
from bioscan_clip_tpu.models.openclip import (
    OpenClipImageTower as JaxImage,
    OpenClipTextAdapter as JaxTextAdapter,
    OpenClipTextConfig as JaxTextConfig,
    OpenClipTextTower as JaxText,
    OpenClipVisionConfig as JaxVisionConfig,
)
from bioscan_clip_tpu.ops import attention as jax_attention
from bioscan_clip_tpu_torch.interop.weights import load_into, state_dict_from_jax
from bioscan_clip_tpu_torch.models import heads, mlp
from bioscan_clip_tpu_torch.models.bert import BarcodeBertDnaEncoder, BertConfig
from bioscan_clip_tpu_torch.models.clip import MultiModalCLIP
from bioscan_clip_tpu_torch.models.lora import merge_lora
from bioscan_clip_tpu_torch.models.openclip import (
    OpenClipImageTower,
    OpenClipTextAdapter,
    OpenClipTextConfig,
    OpenClipVisionConfig,
    causal_mask,
)
from bioscan_clip_tpu_torch.ops import attention

D_OUT = 24
VISION = dict(image_size=28, patch_size=14, width=32, layers=2, heads=4,
              output_dim=D_OUT, lora_rank=4)
TEXT = dict(context_length=16, vocab_size=97, width=32, layers=2, heads=4,
            output_dim=D_OUT, lora_rank=4)
TOWER = dict(atol=2e-5, rtol=1e-3)


def _perturbed(params, seed):
    """Init params plus N(0, 0.05) noise: every LoRA B and bias non-zero."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rng.standard_normal(x.shape).astype(np.float32), params)


def _jax_clip(vision=VISION, text=TEXT, dna=False):
    drop = dict(hidden_dropout=0.0, attention_dropout=0.0)
    return JaxCLIP(
        image_encoder=JaxImage(JaxVisionConfig(**vision)),
        dna_encoder=(JaxDna(JaxBertConfig(
            vocab_size=1027, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, lora_rank=4, **drop), output_dim=D_OUT)
            if dna else None),
        language_encoder=JaxTextAdapter(JaxTextConfig(**text)),
    )


def _port_clip(vision=VISION, text=TEXT, dna=False, rank=4):
    return MultiModalCLIP(
        image_encoder=OpenClipImageTower(OpenClipVisionConfig(
            **dict(vision, lora_rank=rank))),
        dna_encoder=(BarcodeBertDnaEncoder(BertConfig(
            vocab_size=1027, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, lora_rank=rank), output_dim=D_OUT)
            if dna else None),
        language_encoder=OpenClipTextAdapter(OpenClipTextConfig(
            **dict(text, lora_rank=rank))),
    ).eval()


@pytest.fixture(scope="module")
def clip_params():
    model = _jax_clip()
    params = jax.jit(lambda key: init_clip_params(model, key))(
        jax.random.PRNGKey(0))
    return _perturbed(params, 0)


def _images(seed=0, b=2):
    return np.random.default_rng(seed).standard_normal(
        (b, 28, 28, 3)).astype(np.float32)


def _ids(seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 90, size=(4, 16))
    ids[0, 7] = 96    # the EOT mid-sequence
    ids[1, 15] = 96
    ids[2, 3] = ids[2, 9] = 96  # two maxima: the first one pools
    ids[3, :] = 5     # all equal: position 0 pools
    return ids


def test_image_tower_matches_jax(clip_params, monkeypatch):
    monkeypatch.setenv("BSCAN_FUSED_ATTENTION", "1")
    x = _images()
    ref = JaxImage(JaxVisionConfig(**VISION)).apply(
        {"params": clip_params["image_encoder"]}, jnp.asarray(x))
    model = load_into(_port_clip(), state_dict_from_jax(clip_params))
    with torch.inference_mode():
        out = model.image_encoder(torch.from_numpy(x))
    assert out.shape == (2, D_OUT)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOWER)


def test_text_tower_matches_jax(clip_params, monkeypatch):
    """K1m's path: the causal mask through the fused kernel (interpret
    mode) in JAX and the plain masked attention in the port; EOT pooling at
    the first maximum id."""
    monkeypatch.setenv("BSCAN_FUSED_ATTENTION", "1")
    ids = _ids()
    ref = JaxText(JaxTextConfig(**TEXT)).apply(
        {"params": clip_params["language_encoder"]["text"]},
        jnp.asarray(ids, jnp.int32))
    model = load_into(_port_clip(), state_dict_from_jax(clip_params))
    calls = attention.mha_reference.calls
    with torch.inference_mode():
        out = model.language_encoder(torch.from_numpy(ids))
        # the adapter ignores the BERT-style keys, as JAX's does
        same = model.language_encoder(
            torch.from_numpy(ids), attention_mask=torch.zeros(4, 16),
            token_type_ids=torch.ones(4, 16, dtype=torch.long))
    assert attention.mha_reference.calls == calls + 2 * TEXT["layers"]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOWER)
    assert torch.equal(out, same)


def test_text_adapter_is_eval_only():
    model = _port_clip().train()
    with pytest.raises(NotImplementedError, match="K3m"):
        model.encode_language({"input_ids": torch.ones(2, 16, dtype=torch.long)})


def _mask_case(seed, n=16, d=32, b=2):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, n, 3 * d)).astype(np.float32)
    g = rng.standard_normal((b, n, d)).astype(np.float32)
    return qkv, g, causal_mask(n).numpy()


def test_masked_attention_plain_matches_jax_kernel():
    """`mha_packed(mask=)` on a CPU tensor (the plain K1m) against the JAX
    K1m body, `_packed_mask_kernel` in interpret mode; a -1e9 mask gives
    exactly-zero probabilities on both sides."""
    qkv, _, mask = _mask_case(3)
    ref = jax_attention.mha_packed(jnp.asarray(qkv), heads=4,
                                   mask=jnp.asarray(mask), interpret=True)
    out = attention.mha_packed(torch.from_numpy(qkv), 4,
                               mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    # row 0 attends to key 0 only: its output is v_0 exactly
    np.testing.assert_array_equal(out[:, 0].numpy(), qkv[:, 0, 64:])
    assert attention.mha_packed.mask_launches == 0  # plain version on CPU


@pytest.mark.parametrize("pallas_bwd", ["0", "1"])
def test_masked_attention_backward_matches_jax(pallas_bwd, monkeypatch):
    """`mha_bwd_reference(mask=)` (the K3m contract) and autograd through
    the port's `mha_packed(mask=)` on CPU tensors against `jax.vjp` of JAX
    `mha_packed(mask=)`, with its XLA backward and with its Pallas K3m in
    interpret mode."""
    monkeypatch.setenv("BSCAN_PALLAS_MHA_BWD", pallas_bwd)
    qkv, g, mask = _mask_case(4)
    _, vjp = jax.vjp(lambda x: jax_attention.mha_packed(
        x, heads=4, mask=jnp.asarray(mask), interpret=True), jnp.asarray(qkv))
    (ref,) = vjp(jnp.asarray(g))
    d = 32
    q, k, v = (torch.from_numpy(qkv[..., i * d:(i + 1) * d]) for i in range(3))
    out = attention.mha_bwd_reference(q, k, v, torch.from_numpy(g), 4,
                                      mask=torch.from_numpy(mask))
    np.testing.assert_allclose(torch.cat(out[:3], -1).numpy(), np.asarray(ref),
                               atol=1e-5)
    t = torch.from_numpy(qkv).requires_grad_()
    (got,) = torch.autograd.grad(
        attention.mha_packed(t, 4, mask=torch.from_numpy(mask)), t,
        torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    # the mask matters: without it the gradient differs
    nomask = attention.mha_bwd_reference(q, k, v, torch.from_numpy(g), 4)
    assert (torch.cat(nomask[:3], -1) - got).abs().max().item() > 1e-2


def _loratorch_towers(seed=8):
    """A synthetic `for_open_clip` checkpoint: open_clip names under
    `open_clip_model.*` for both towers, loratorch `{q,k,v}_lora_{A,B}` on
    every attention (the layout of tests/test_openclip.py)."""
    rng = np.random.default_rng(seed)

    def blocks(prefix, d, layers, r=4):
        sd = {}
        for i in range(layers):
            P = f"{prefix}transformer.resblocks.{i}."
            shapes = {"ln_1.weight": (d,), "ln_1.bias": (d,),
                      "attn.in_proj_weight": (3 * d, d),
                      "attn.in_proj_bias": (3 * d,),
                      "attn.out_proj.weight": (d, d),
                      "attn.out_proj.bias": (d,),
                      "ln_2.weight": (d,), "ln_2.bias": (d,),
                      "mlp.c_fc.weight": (4 * d, d), "mlp.c_fc.bias": (4 * d,),
                      "mlp.c_proj.weight": (d, 4 * d),
                      "mlp.c_proj.bias": (d,)}
            for s in "qkv":
                shapes[f"attn.{s}_lora_A"] = (r, d)
                shapes[f"attn.{s}_lora_B"] = (d, r)
            for k, shp in shapes.items():
                sd[P + k] = 0.1 * rng.standard_normal(shp)
                if k.startswith(("ln_1.weight", "ln_2.weight")):
                    sd[P + k] += 1.0
        return sd

    d = 32
    root = "open_clip_model."
    sd = blocks(root + "visual.", d, 2)
    sd.update(blocks(root, d, 2))
    for k, shp in {"visual.conv1.weight": (d, 3, 14, 14),
                   "visual.class_embedding": (d,),
                   "visual.positional_embedding": (5, d),
                   "visual.ln_pre.weight": (d,), "visual.ln_pre.bias": (d,),
                   "visual.ln_post.weight": (d,), "visual.ln_post.bias": (d,),
                   "visual.proj": (d, D_OUT),
                   "token_embedding.weight": (97, d),
                   "positional_embedding": (16, d),
                   "ln_final.weight": (d,), "ln_final.bias": (d,),
                   "text_projection": (d, D_OUT), "logit_scale": ()}.items():
        sd[root + k] = 0.1 * rng.standard_normal(shp)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def test_loratorch_checkpoint_loads_like_jax(monkeypatch):
    """`load_into` on a released-layout `open_clip_model.*` checkpoint
    equals JAX `convert_simple_clip_checkpoint` applied to the JAX towers:
    the prefixes map, and each loratorch B takes alpha / r."""
    from bioscan_clip_tpu.interop.torch_import import (
        convert_simple_clip_checkpoint,
        merge_params,
    )

    monkeypatch.setenv("BSCAN_FUSED_ATTENTION", "1")
    sd = _loratorch_towers()
    conv = convert_simple_clip_checkpoint(sd)
    model = _jax_clip()
    params = jax.jit(lambda key: init_clip_params(model, key))(
        jax.random.PRNGKey(1))
    params = merge_params(params, conv)
    x, ids = _images(5), _ids(6)
    ref_img = model.apply({"params": params}, jnp.asarray(x),
                          method=model.encode_image)
    ref_txt = model.apply({"params": params},
                          {"input_ids": jnp.asarray(ids, jnp.int32)},
                          method=model.encode_language)

    port = load_into(_port_clip(),
                     {k: torch.from_numpy(v) for k, v in sd.items()})
    b = "language_encoder.text.transformer.resblocks.1.attn.v_lora_B"
    np.testing.assert_array_equal(
        port.state_dict()[b].numpy(),
        sd["open_clip_model.transformer.resblocks.1.attn.v_lora_B"] * 0.25)
    with torch.inference_mode():
        img = port.encode_image(torch.from_numpy(x))
        txt = port.encode_language({"input_ids": torch.from_numpy(ids)})
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), **TOWER)
    np.testing.assert_allclose(txt.numpy(), np.asarray(ref_txt), **TOWER)


def test_merge_lora_in_proj_matches_jax(clip_params):
    """`merge_lora` folds the q, k and v adapters into `in_proj_weight`
    as JAX `merge_lora_params` folds them into `in_proj/kernel`, and the
    merged rank-0 model computes what the adapted one does."""
    merged_jax = state_dict_from_jax(merge_lora_params(
        jax.tree.map(jnp.asarray, clip_params)))
    model = load_into(_port_clip(), state_dict_from_jax(clip_params))
    merged = merge_lora(model.state_dict())
    assert set(merged) == set(merged_jax)
    assert not any("_lora_" in k for k in merged)
    for k in merged:
        np.testing.assert_allclose(merged[k].numpy(), merged_jax[k].numpy(),
                                   atol=1e-6, err_msg=k)
    rank0 = _port_clip(rank=0)
    rank0.load_state_dict(merged, strict=True)
    x, ids = torch.from_numpy(_images(7)), torch.from_numpy(_ids(8))
    with torch.inference_mode():
        for a, b in ((model.encode_image(x), rank0.encode_image(x)),
                     (model.encode_language({"input_ids": ids}),
                      rank0.encode_language({"input_ids": ids}))):
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5)


ABLATION = ("ablation_with_open_clip/"
            "trained_with_bioscan_1m_image_dna_text_with_pretrained_clip")


def test_factory_builds_the_vit_l14_ablation_on_meta():
    """`models.clip.build_towers` (what `load_clip_model` materializes on
    the card) builds the ablation's ViT-L/14 + OpenCLIP text + BarcodeBERT
    with as many parameters as the JAX factory's model, without allocating
    (meta device)."""
    from bioscan_clip_tpu.config.core import load_config as jax_load_config
    from bioscan_clip_tpu.models.clip import load_clip_model as jax_factory
    from bioscan_clip_tpu_torch.config.core import load_config
    from bioscan_clip_tpu_torch.models.clip import build_towers

    cfg = load_config(model_config=ABLATION, project_root_path="/tmp")
    with torch.device("meta"):
        model = build_towers(cfg.model_config, 4, torch.bfloat16)
    img, txt = model.image_encoder, model.language_encoder.text
    assert isinstance(img, OpenClipImageTower)
    assert (img.cfg.width, img.cfg.layers, img.cfg.heads) == (1024, 24, 16)
    assert img.positional_embedding.shape == (257, 1024)
    assert (txt.cfg.width, txt.cfg.layers, txt.cfg.heads) == (768, 12, 12)
    assert txt.token_embedding.weight.shape == (49408, 768)
    assert isinstance(model.dna_encoder, BarcodeBertDnaEncoder)
    assert img.transformer.resblocks[0].attn.q_lora_A.shape == (4, 1024)
    assert next(model.parameters()).is_meta

    jcfg = jax_load_config(model_config=ABLATION, project_root_path="/tmp")
    jmodel = jax_factory(jcfg, dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda key: init_clip_params(jmodel, key, batch_size=1),
        jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == n_jax


@pytest.mark.parametrize("image,dna", [("feature", "feature"),
                                       ("image", "freeze")])
def test_factory_mlp_and_identity_branches(image, dna):
    from bioscan_clip_tpu_torch.config.core import ConfigNode
    from bioscan_clip_tpu_torch.models.clip import build_towers

    mc = {"output_dim": 768,
          "image": ({"input_type": "image", "model": "lora_vit"}
                    if image == "image" else
                    {"input_type": "feature", "hidden_dim": 64}),
          "dna": ({"input_type": "feature", "hidden_dim": 48}
                  if dna == "feature" else
                  {"input_type": "sequence", "freeze": True})}
    with torch.device("meta"):
        model = build_towers(ConfigNode(mc), 4, torch.float32)
    if image == "feature":
        assert isinstance(model.image_encoder, mlp.MLPEncoder)
        assert model.image_encoder.fc1.weight.shape == (64, 512)
        assert isinstance(model.dna_encoder, mlp.MLPEncoder)
        assert model.dna_encoder.fc3.weight.shape == (768, 48)
    else:
        assert isinstance(model.dna_encoder, mlp.IdentityEncoder)


def test_clip_tokenizer_copy_matches_jax(tmp_path):
    from bioscan_clip_tpu.data.clip_tokenizer import ClipTokenizer as JaxTok
    from bioscan_clip_tpu_torch.data.clip_tokenizer import ClipTokenizer

    merges = "#version tiny\nd i\np t</w>\ndi pt</w>\ne r\na er</w>\n"
    path = tmp_path / "bpe.txt"
    path.write_text(merges)
    texts = ["Diptera dipt", "", "Aedes aegypti 12 &amp; it's a-b",
             "x " * 40]
    for ctx in (12, 77):
        np.testing.assert_array_equal(
            ClipTokenizer(bpe_path=str(path))(texts, context_length=ctx),
            JaxTok(bpe_path=str(path))(texts, context_length=ctx))
    with pytest.raises(FileNotFoundError):
        ClipTokenizer(bpe_path=str(tmp_path / "missing.gz"))


def _dense_to_linear(lin, p):
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.asarray(p["kernel"]).T.copy()))
        lin.bias.copy_(torch.from_numpy(np.asarray(p["bias"])))


def _mlp_into(mod, p):
    for name in ("fc1", "fc2", "fc3"):
        _dense_to_linear(getattr(mod, name), p[name])


def test_mlp_identity_and_heads_match_jax():
    rng = np.random.default_rng(9)
    img = rng.standard_normal((5, 512)).astype(np.float32)
    dna = rng.standard_normal((5, 768)).astype(np.float32)
    key = jax.random.PRNGKey(2)

    jm = jax_mlp.MLPVersionCLIP(hidden_dim=64, output_dim=D_OUT)
    p = _perturbed(jm.init(key, jnp.asarray(img), jnp.asarray(dna))["params"],
                   1)
    ref = jm.apply({"params": p}, jnp.asarray(img), jnp.asarray(dna))
    m = mlp.MLPVersionCLIP(hidden_dim=64, output_dim=D_OUT)
    _mlp_into(m.image_feature_encoder, p["image_feature_encoder"])
    _mlp_into(m.dna_feature_encoder, p["dna_feature_encoder"])
    with torch.inference_mode():
        out = m(torch.from_numpy(img), torch.from_numpy(dna))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    x = torch.from_numpy(dna)
    assert mlp.IdentityEncoder()(x) is x

    jh = jax_heads.EncoderWithHead(jax_mlp.IdentityEncoder(), num_classes=7)
    p = _perturbed(jh.init(key, jnp.asarray(dna))["params"], 2)
    h = heads.EncoderWithHead(mlp.IdentityEncoder(), 768, 7)
    _dense_to_linear(h.new_linear_layer, p["new_linear_layer"])
    with torch.inference_mode():
        np.testing.assert_allclose(
            h(x).numpy(), np.asarray(jh.apply({"params": p},
                                              jnp.asarray(dna))), atol=1e-5)
        assert h.get_feature(x) is x

    jc = jax_heads.CLIPWithClassificationHead(
        image_encoder=jax_mlp.MLPEncoder(64, D_OUT), dna_encoder=None,
        language_encoder=None, hidden_dim=32, num_classes=11)
    p = _perturbed(jc.init(key, image_input=jnp.asarray(img))["params"], 3)
    ref = jc.apply({"params": p}, image_input=jnp.asarray(img))
    c = heads.CLIPWithClassificationHead(
        image_encoder=mlp.MLPEncoder(512, 64, D_OUT), input_dim=D_OUT,
        hidden_dim=32, num_classes=11)
    _mlp_into(c.image_encoder, p["image_encoder"])
    _mlp_into(c.classification_head, p["classification_head"])
    with torch.inference_mode():
        out = c(image_input=torch.from_numpy(img))
    assert out[1] is None and out[2] is None
    for i in (0, 3):
        np.testing.assert_allclose(out[i].numpy(), np.asarray(ref[i]),
                                   atol=1e-5)
    np.testing.assert_allclose(out[3].sum(-1).numpy(), 1.0, atol=1e-5)


SERVE_TEXT = dict(TEXT, context_length=20)
SERVE_VISION = dict(VISION, image_size=224)


def test_openclip_service_matches_jax(tmp_path):
    """A tiny OpenCLIP model (ViT-L/14 geometry at width 32, 224-pixel
    images, 257 tokens; text at context 20 fed the service's BERT-small
    WordPiece ids, as the JAX service feeds them; BarcodeBERT) behind the
    port's `RetrievalService(device="cpu", openclip_norm=True)` answers as
    the JAX service does on the same weights and 40 keys."""
    from bioscan_clip_tpu.retrieval.service import RetrievalService as JaxSvc
    from bioscan_clip_tpu_torch.retrieval.service import RetrievalService
    from tests.test_torch_serving import TEXT as QUERIES
    from tests.test_torch_serving import VOCAB, _barcodes, _images, _labels

    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(VOCAB) + "\n")
    jmodel = _jax_clip(SERVE_VISION, SERVE_TEXT, dna=True)
    params = _perturbed(jax.jit(lambda k: init_clip_params(jmodel, k))(
        jax.random.PRNGKey(3)), 3)
    keys = np.random.default_rng(4).standard_normal((40, D_OUT)).astype(
        np.float32)
    kw = dict(keys=keys, key_labels=_labels(40), max_k=3, max_batch=8,
              openclip_norm=True)
    jax_svc = JaxSvc(jmodel, params, **kw)
    model = load_into(_port_clip(SERVE_VISION, SERVE_TEXT, dna=True),
                      state_dict_from_jax(params))
    port_svc = RetrievalService(model, device="cpu", vocab_path=str(vocab),
                                **kw)
    for req, ref in (
        (dict(images=_images()), dict(images=_images())),
        (dict(dna=_barcodes(3)), dict(dna=_barcodes(3))),
        (dict(text=QUERIES), dict(text=QUERIES, vocab_path=str(vocab))),
    ):
        a, b = port_svc.search(k=3, **req), jax_svc.search(k=3, **ref)
        assert a["predictions"] == b["predictions"]
        np.testing.assert_allclose(a["similarities"], b["similarities"],
                                   atol=1e-4)
    # image /search as the HTTP handler takes it: base64 PNG bytes
    import base64
    import io

    from PIL import Image

    from bioscan_clip_tpu_torch.retrieval.service import handle_request

    def png(a):
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    out = handle_request(port_svc, {"image_b64": [png(a) for a in _images()],
                                    "k": 2})
    assert out == port_svc.search(images=_images(), k=2)
