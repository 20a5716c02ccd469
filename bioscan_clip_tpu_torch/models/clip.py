"""MultiModalCLIP: the tri-modal model and its config-driven factory.

Counterpart of bioscan_clip_tpu/models/clip.py:35-230. Up to three towers;
each `encode_*` returns the L2-normalized fp32 embedding. Module names are
the reference SimpleCLIP's (`image_encoder.lora_vit`,
`dna_encoder.lora_barcode_bert`, `language_encoder.lora_bert` + `.proj`), so
`state_dict()` loads a released checkpoint and the JAX export alike. The
OpenCLIP ablation's towers sit as the JAX package places them
(`image_encoder.*`, `language_encoder.text.*`, open_clip's names below).
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
from bioscan_clip_tpu_torch.models.common import l2_normalize
from bioscan_clip_tpu_torch.models.lora import LORA_A_NAMES, LORA_B_NAMES
from bioscan_clip_tpu_torch.models.mlp import IdentityEncoder, MLPEncoder
from bioscan_clip_tpu_torch.models.openclip import (
    OpenClipImageTower,
    OpenClipTextAdapter,
    OpenClipTextConfig,
    OpenClipVisionConfig,
)
from bioscan_clip_tpu_torch.models.vit import ViTConfig, ViTImageEncoder

# the feature widths the JAX package initializes the MLP encoders from
# (`init_clip_params`, clip.py:248, :253)
MLP_IMAGE_INPUT_DIM = 512
MLP_DNA_INPUT_DIM = 768
# 1-D parameters drawn like matrices (the others are biases: zero)
_TOKEN_PARAMS = ("cls_token", "pos_embed", "class_embedding")


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

    def encode_dna(self, dna_tokens, row_seeds=None):
        """`row_seeds`: (B,) uint32 dropout seeds, needed in train mode by
        the BERT tower; passed on only when given, as the JAX model does
        (the MLP and identity encoders take none)."""
        kw = {} if row_seeds is None else {"row_seeds": row_seeds}
        return l2_normalize(self.dna_encoder(dna_tokens, **kw).float())

    def encode_language(self, language: dict, row_seeds=None):
        out = self.language_encoder(
            language["input_ids"],
            attention_mask=language.get("attention_mask"),
            token_type_ids=language.get("token_type_ids"),
            row_seeds=row_seeds,
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
    CLS/position tokens, ones and zeros for LayerNorms, zero biases. LoRA
    adapters start as the zero function, as in the JAX package
    (`lora_a_init`/`lora_b_init`, models/lora.py:22-36): each A (rank, dim)
    is U(-1/sqrt(dim), 1/sqrt(dim)) and each B zero."""
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
            # an adapter is a module (`linear_a_q.weight`) or, in OpenCLIP,
            # a parameter (`attn.q_lora_A`)
            owners = name.split(".")[-2:]
            if any(k in LORA_A_NAMES for k in owners):
                bound = p.shape[1] ** -0.5  # (rank, dim): fan_in = dim
                p.uniform_(-bound, bound, generator=gen)
            elif any(k in LORA_B_NAMES for k in owners):
                p.zero_()
            elif p.dim() >= 2 or name.endswith(_TOKEN_PARAMS):
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
    config's rank (0 after `merge_lora`). `tpu.remat` / `tpu.remat_policy`
    turn on per-layer remat in every transformer tower
    (`models/common.py`)."""
    dev = resolve_device(device)
    dtype = compute_dtype(dev) if dtype is None else dtype
    mc = args.model_config
    rank = 0 if bool(getattr(mc, "disable_lora", False)) else 4
    if lora_rank is not None:
        rank = int(lora_rank)
    # built on the meta device and materialized once on `dev`: init_weights
    # writes every parameter, so torch's default init would be wasted work
    with torch.device("meta"):
        model = build_towers(mc, rank, dtype, ln_dtype, remat_of(args))
    return init_weights(model.to_empty(device=dev), seed).eval()


def remat_of(args) -> dict:
    """`tpu.remat` and `tpu.remat_policy` (JAX clip.py:121-122) as the
    towers' config fields."""
    tpu_cfg = getattr(args, "tpu", None)
    return {"remat": bool(tpu_cfg.get("remat", False)) if tpu_cfg else False,
            "remat_policy": str(tpu_cfg.get("remat_policy", "full"))
            if tpu_cfg else "full"}


def build_towers(mc, rank: int, dtype: torch.dtype,
                 ln_dtype: torch.dtype = torch.float32,
                 remat: dict | None = None) -> MultiModalCLIP:
    """The towers `model_config` declares (JAX clip.py:114-212), on the
    current default device, parameters uninitialized. `remat`: the towers'
    per-layer remat fields (`remat_of`), off by default."""
    out = mc.output_dim
    remat = remat or {}

    def bert(cfg):
        return dataclasses.replace(cfg, lora_rank=rank, **remat)

    towers = {}
    if (hasattr(mc, "image") and hasattr(mc, "language")
            and mc.image.model == "lora_clip_image"
            and mc.language.model == "lora_clip_text"):
        # the OpenCLIP ViT-L/14 ablation (simple_clip.py:141-145)
        towers["image_encoder"] = OpenClipImageTower(dataclasses.replace(
            OpenClipVisionConfig(), lora_rank=rank, output_dim=out, **remat),
            dtype)
        towers["language_encoder"] = OpenClipTextAdapter(dataclasses.replace(
            OpenClipTextConfig(), lora_rank=rank, output_dim=out, **remat),
            dtype)
        if hasattr(mc, "dna"):
            towers["dna_encoder"] = BarcodeBertDnaEncoder(
                bert(BARCODE_BERT_CONFIG), out, dtype, ln_dtype)
        return MultiModalCLIP(**towers)

    if hasattr(mc, "image"):
        if mc.image.input_type == "image":
            towers["image_encoder"] = ViTImageEncoder(
                ViTConfig(num_classes=out, lora_rank=rank, **remat), dtype,
                ln_dtype)
        else:
            towers["image_encoder"] = MLPEncoder(
                MLP_IMAGE_INPUT_DIM, mc.image.hidden_dim, out, dtype)
    if hasattr(mc, "language"):
        if mc.language.input_type != "sequence":
            raise TypeError(
                f"Using {mc.language.input_type} as language input is not "
                "supported yet."
            )
        towers["language_encoder"] = BertTextEncoder(
            bert(BERT_SMALL_CONFIG), out, dtype, ln_dtype)
    if hasattr(mc, "dna"):
        if getattr(mc.dna, "freeze", False):
            towers["dna_encoder"] = IdentityEncoder()
        elif mc.dna.input_type == "sequence":
            towers["dna_encoder"] = BarcodeBertDnaEncoder(
                bert(BARCODE_BERT_CONFIG), out, dtype, ln_dtype)
        else:
            towers["dna_encoder"] = MLPEncoder(
                MLP_DNA_INPUT_DIM, mc.dna.hidden_dim, out, dtype)
    return MultiModalCLIP(**towers)


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
