"""MultiModalCLIP: the tri-modal model and its config-driven factory.

Counterpart of bioscan_clip_tpu/models/clip.py:35-230. Up to three towers;
each `encode_*` returns the L2-normalized fp32 embedding. Module names are
the reference SimpleCLIP's (`image_encoder.lora_vit`,
`dna_encoder.lora_barcode_bert`, `language_encoder.lora_bert` + `.proj`), so
`state_dict()` loads a released checkpoint and the JAX export alike.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from bioscan_clip_tpu_torch.device import compute_dtype, resolve_device
from bioscan_clip_tpu_torch.models.bert import (
    BARCODE_BERT_CONFIG,
    BERT_SMALL_CONFIG,
    BarcodeBertDnaEncoder,
    BertTextEncoder,
)
from bioscan_clip_tpu_torch.models.vit import ViTConfig, ViTImageEncoder

_LATER = "is not ported yet: ROADMAP.md queue 1"


def l2_normalize(x, dim: int = -1, eps: float = 1e-12):
    """torch F.normalize(p=2) parity: x / max(||x||, eps)."""
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=dim,
                                                        keepdim=True), eps)


class MultiModalCLIP(nn.Module):
    """Composite of optional image / dna / language towers."""

    def __init__(self, image_encoder=None, dna_encoder=None,
                 language_encoder=None):
        super().__init__()
        self.image_encoder = image_encoder
        self.dna_encoder = dna_encoder
        self.language_encoder = language_encoder

    def encode_image(self, images):
        """images: (B, H, W, 3) float NHWC, preprocessed."""
        return l2_normalize(self.image_encoder(images).float())

    def encode_dna(self, dna_tokens):
        return l2_normalize(self.dna_encoder(dna_tokens).float())

    def encode_language(self, language: dict):
        out = self.language_encoder(
            language["input_ids"],
            attention_mask=language.get("attention_mask"),
            token_type_ids=language.get("token_type_ids"),
        )
        return l2_normalize(out.float())

    def forward(self, image_input=None, dna_input=None, language_input=None):
        image = dna = language = None
        if self.image_encoder is not None and image_input is not None:
            image = self.encode_image(image_input)
        if self.dna_encoder is not None and dna_input is not None:
            dna = self.encode_dna(dna_input)
        if self.language_encoder is not None and language_input is not None:
            language = self.encode_language(language_input)
        return image, dna, language


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights: N(0, 0.02) for matrices, embeddings and the
    CLS/position tokens, ones and zeros for LayerNorms, zero biases."""
    params = list(model.parameters())
    dev = params[0].device if params else torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(seed)
    ln_params = {id(p) for m in model.modules()
                 if isinstance(m, nn.LayerNorm) for p in m.parameters()}
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for name, p in model.named_parameters():
            if id(p) in ln_params:
                continue
            if p.dim() >= 2 or name.endswith(("cls_token", "pos_embed")):
                p.normal_(0.0, 0.02, generator=gen)
            else:
                p.zero_()
    return model


def load_clip_model(args, device=None, dtype=None, lora_rank=None,
                    ln_dtype: torch.dtype = torch.float32, seed: int = 0):
    """Config-driven assembly (JAX clip.py:95-212) on `device` (default
    cuda), with seeded random weights; load a checkpoint on top with
    `interop.weights`. `dtype` is the compute dtype (default: bf16 on the
    card, fp32 on the CPU); parameters are fp32. `lora_rank` overrides the
    config's rank (0 after `merge_lora`)."""
    dev = resolve_device(device)
    dtype = compute_dtype(dev) if dtype is None else dtype
    mc = args.model_config
    rank = 0 if bool(getattr(mc, "disable_lora", False)) else 4
    if lora_rank is not None:
        rank = int(lora_rank)
    out = mc.output_dim

    if (hasattr(mc, "image") and hasattr(mc, "language")
            and mc.image.model == "lora_clip_image"
            and mc.language.model == "lora_clip_text"):
        raise NotImplementedError(f"the OpenCLIP ViT-L/14 towers {_LATER}")

    towers = {}
    # built on the meta device and materialized once on `dev`: init_weights
    # writes every parameter, so torch's default init would be wasted work
    with torch.device("meta"):
        if hasattr(mc, "image"):
            if mc.image.input_type != "image":
                raise NotImplementedError(f"the MLP image encoder {_LATER}")
            towers["image_encoder"] = ViTImageEncoder(
                ViTConfig(num_classes=out, lora_rank=rank), dtype, ln_dtype
            )
        if hasattr(mc, "language"):
            if mc.language.input_type != "sequence":
                raise TypeError(
                    f"Using {mc.language.input_type} as language input is "
                    "not supported yet."
                )
            towers["language_encoder"] = BertTextEncoder(
                _with_rank(BERT_SMALL_CONFIG, rank), out, dtype, ln_dtype
            )
        if hasattr(mc, "dna"):
            if getattr(mc.dna, "freeze", False):
                raise NotImplementedError(f"the Identity DNA encoder {_LATER}")
            if mc.dna.input_type != "sequence":
                raise NotImplementedError(f"the MLP DNA encoder {_LATER}")
            towers["dna_encoder"] = BarcodeBertDnaEncoder(
                _with_rank(BARCODE_BERT_CONFIG, rank), out, dtype, ln_dtype
            )
        model = MultiModalCLIP(**towers)
    return init_weights(model.to_empty(device=dev), seed).eval()


def _with_rank(cfg, rank):
    return dataclasses.replace(cfg, lora_rank=rank)


def maybe_merge_lora(args, model, device=None, dtype=None):
    """`tpu.merge_lora: true` (the config key the JAX package reads): fold
    the adapters into the projections and rebuild the towers with
    `lora_rank=0`. Returns the model unchanged when the key is off or the
    model has no adapters."""
    from bioscan_clip_tpu_torch.models.lora import merge_lora

    tpu_cfg = getattr(args, "tpu", None)
    if not (tpu_cfg and bool(tpu_cfg.get("merge_lora", False))):
        return model
    if bool(getattr(args.model_config, "disable_lora", False)):
        return model
    merged = load_clip_model(args, device=device, dtype=dtype, lora_rank=0)
    merged.load_state_dict(merge_lora(model.state_dict()), strict=True)
    return merged
