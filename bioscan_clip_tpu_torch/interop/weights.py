"""Weights into the port: from the JAX parameter tree and from `.pth` files.

- `state_dict_from_jax(params)`: a JAX `MultiModalCLIP` param tree (numpy
  arrays) -> the port's `state_dict`. The mapping is a copy of
  bioscan_clip_tpu/interop/torch_export.py:17-147 (the reference SimpleCLIP
  layout, LoRA-wrapped names when adapters are present).
- `load_reference_pth(path)`: a released SimpleCLIP `.pth` (or one written
  by the JAX package's `save_pth`) -> state dict, with DDP `module.`
  prefixes stripped and a `state_dict` wrapper unwrapped (JAX
  torch_import.py:39-62).
- `load_into(model, state_dict)`: `load_state_dict(strict=True)` after
  dropping the entries the reference model carries and never reads.
- `resolve_reference_ckpt(folder)`: best.pth, else last.pth
  (JAX train/checkpoint.py:137-145).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


def _t(x):
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32).T)


def _np(x):
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


def _vit(params: dict, prefix: str = "image_encoder.lora_vit.") -> dict:
    sd = {}
    sd[prefix + "patch_embed.proj.weight"] = np.transpose(
        _np(params["patch_embed"]["kernel"]), (3, 2, 0, 1)
    )
    sd[prefix + "patch_embed.proj.bias"] = _np(params["patch_embed"]["bias"])
    sd[prefix + "cls_token"] = _np(params["cls_token"])
    sd[prefix + "pos_embed"] = _np(params["pos_embed"])
    sd[prefix + "norm.weight"] = _np(params["norm"]["scale"])
    sd[prefix + "norm.bias"] = _np(params["norm"]["bias"])
    if "head" in params:
        sd[prefix + "head.weight"] = _t(params["head"]["kernel"])
        sd[prefix + "head.bias"] = _np(params["head"]["bias"])

    blocks = params["blocks"]
    has_lora = "lora_q_a" in blocks
    for i in range(blocks["norm1"]["scale"].shape[0]):
        P = prefix + f"blocks.{i}."
        sd[P + "norm1.weight"] = _np(blocks["norm1"]["scale"][i])
        sd[P + "norm1.bias"] = _np(blocks["norm1"]["bias"][i])
        qkv_k = _t(blocks["qkv"]["kernel"][i])
        qkv_b = _np(blocks["qkv"]["bias"][i])
        if has_lora:
            sd[P + "attn.qkv.qkv.weight"] = qkv_k
            sd[P + "attn.qkv.qkv.bias"] = qkv_b
            sd[P + "attn.qkv.linear_a_q.weight"] = _t(blocks["lora_q_a"][i])
            sd[P + "attn.qkv.linear_b_q.weight"] = _t(blocks["lora_q_b"][i])
            sd[P + "attn.qkv.linear_a_v.weight"] = _t(blocks["lora_v_a"][i])
            sd[P + "attn.qkv.linear_b_v.weight"] = _t(blocks["lora_v_b"][i])
        else:
            sd[P + "attn.qkv.weight"] = qkv_k
            sd[P + "attn.qkv.bias"] = qkv_b
        sd[P + "attn.proj.weight"] = _t(blocks["proj"]["kernel"][i])
        sd[P + "attn.proj.bias"] = _np(blocks["proj"]["bias"][i])
        sd[P + "norm2.weight"] = _np(blocks["norm2"]["scale"][i])
        sd[P + "norm2.bias"] = _np(blocks["norm2"]["bias"][i])
        sd[P + "mlp.fc1.weight"] = _t(blocks["fc1"]["kernel"][i])
        sd[P + "mlp.fc1.bias"] = _np(blocks["fc1"]["bias"][i])
        sd[P + "mlp.fc2.weight"] = _t(blocks["fc2"]["kernel"][i])
        sd[P + "mlp.fc2.bias"] = _np(blocks["fc2"]["bias"][i])
    return sd


def _bert(params: dict, prefix: str) -> dict:
    sd = {}
    emb = prefix + "embeddings."
    sd[emb + "word_embeddings.weight"] = _np(
        params["word_embeddings"]["embedding"])
    sd[emb + "position_embeddings.weight"] = _np(
        params["position_embeddings"]["embedding"])
    sd[emb + "token_type_embeddings.weight"] = _np(
        params["token_type_embeddings"]["embedding"])
    sd[emb + "LayerNorm.weight"] = _np(params["emb_ln"]["scale"])
    sd[emb + "LayerNorm.bias"] = _np(params["emb_ln"]["bias"])

    L = params["layers"]
    has_lora = "lora_q_a" in L
    for i in range(L["query"]["kernel"].shape[0]):
        P = prefix + f"encoder.layer.{i}."
        S = P + "attention.self."
        if has_lora:
            sd[S + "query.w.weight"] = _t(L["query"]["kernel"][i])
            sd[S + "query.w.bias"] = _np(L["query"]["bias"][i])
            sd[S + "query.w_a.weight"] = _t(L["lora_q_a"][i])
            sd[S + "query.w_b.weight"] = _t(L["lora_q_b"][i])
            sd[S + "value.w.weight"] = _t(L["value"]["kernel"][i])
            sd[S + "value.w.bias"] = _np(L["value"]["bias"][i])
            sd[S + "value.w_a.weight"] = _t(L["lora_v_a"][i])
            sd[S + "value.w_b.weight"] = _t(L["lora_v_b"][i])
        else:
            sd[S + "query.weight"] = _t(L["query"]["kernel"][i])
            sd[S + "query.bias"] = _np(L["query"]["bias"][i])
            sd[S + "value.weight"] = _t(L["value"]["kernel"][i])
            sd[S + "value.bias"] = _np(L["value"]["bias"][i])
        sd[S + "key.weight"] = _t(L["key"]["kernel"][i])
        sd[S + "key.bias"] = _np(L["key"]["bias"][i])
        sd[P + "attention.output.dense.weight"] = _t(L["attn_out"]["kernel"][i])
        sd[P + "attention.output.dense.bias"] = _np(L["attn_out"]["bias"][i])
        sd[P + "attention.output.LayerNorm.weight"] = _np(
            L["attn_ln"]["scale"][i])
        sd[P + "attention.output.LayerNorm.bias"] = _np(
            L["attn_ln"]["bias"][i])
        sd[P + "intermediate.dense.weight"] = _t(L["inter"]["kernel"][i])
        sd[P + "intermediate.dense.bias"] = _np(L["inter"]["bias"][i])
        sd[P + "output.dense.weight"] = _t(L["out"]["kernel"][i])
        sd[P + "output.dense.bias"] = _np(L["out"]["bias"][i])
        sd[P + "output.LayerNorm.weight"] = _np(L["out_ln"]["scale"][i])
        sd[P + "output.LayerNorm.bias"] = _np(L["out_ln"]["bias"][i])
    return sd


def state_dict_from_jax(params: dict) -> dict:
    """JAX MultiModalCLIP params (numpy leaves) -> the port's state dict."""
    sd = {}
    if "image_encoder" in params:
        sd.update(_vit(params["image_encoder"]))
    if "dna_encoder" in params:
        d = params["dna_encoder"]
        pre = "dna_encoder.lora_barcode_bert."
        sd.update(_bert(d["bert"], pre + "bert."))
        tr = pre + "cls.predictions.transform."
        sd[tr + "dense.weight"] = _t(d["transform_dense"]["kernel"])
        sd[tr + "dense.bias"] = _np(d["transform_dense"]["bias"])
        sd[tr + "LayerNorm.weight"] = _np(d["transform_ln"]["scale"])
        sd[tr + "LayerNorm.bias"] = _np(d["transform_ln"]["bias"])
        sd[pre + "cls.predictions.decoder.weight"] = _t(d["decoder"]["kernel"])
        sd[pre + "cls.predictions.decoder.bias"] = _np(d["decoder"]["bias"])
    if "language_encoder" in params:
        t = params["language_encoder"]
        sd.update(_bert(t["bert"], "language_encoder.lora_bert."))
        sd["language_encoder.proj.weight"] = _t(t["proj"]["kernel"])
        sd["language_encoder.proj.bias"] = _np(t["proj"]["bias"])
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def load_reference_pth(path: str) -> dict:
    """Deserialize a .pth into {key: tensor}, stripping `module.`."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in sd.items()
    }


# Entries of the reference model that no forward of the towers reads: the
# HF BertModel pooler (the text tower), the position-id buffer older HF
# versions persist, and the MLM head's vocab-sized bias, which stays
# registered after the reference replaces BarcodeBERT's decoder.
_UNUSED_SUFFIXES = (
    ".pooler.dense.weight", ".pooler.dense.bias",
    ".embeddings.position_ids", ".cls.predictions.bias",
)


def load_into(model: torch.nn.Module, state_dict: dict) -> torch.nn.Module:
    """`model.load_state_dict(strict=True)` on a reference-layout state dict
    (keys the model does not have and never reads are dropped first)."""
    sd = {k: v for k, v in state_dict.items()
          if not k.endswith(_UNUSED_SUFFIXES)}
    model.load_state_dict(sd, strict=True)
    return model


def resolve_reference_ckpt(folder: str) -> Optional[str]:
    """best.pth with last.pth fallback (inference_and_eval.py:789-792)."""
    for name in ("best.pth", "last.pth"):
        path = os.path.join(folder, name)
        if os.path.isfile(path):
            return path
    return None
