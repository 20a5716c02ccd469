"""Train-state checkpoints, and the pretrained towers a run starts from.

Counterpart of bioscan_clip_tpu/train/checkpoint.py (orbax there,
`torch.save`/`torch.load` here):
- `save_checkpoint` / `restore_checkpoint` (:35-120): the whole train state
  under `<directory>/<name>` (`last`, `best`): the model's state dict (frozen
  weights in the dtype they are stored in, bf16 after `cast_frozen_params`),
  the AdamW state with the parameter names of each group in order, the step,
  and the state's step-seed generator, so a resumed run equals an
  uninterrupted one (JAX derives each step's key from the step instead,
  loop.py:134). The write goes to `<name>.writing` and replaces `<name>`
  only once complete, so the previous checkpoint stays valid until then.
  `block=False` copies the state to the host first and writes in a
  background thread; `wait_for_checkpoints()` joins the writes.
- `save_params_only` / `restore_params_only` (:123-134): the model's state
  dict alone.
- `load_pretrained_towers` (:189-302): the reference's from-pretrained
  initialization on the port's names: the BarcodeBERT MLM checkpoint
  (`args.bioscan_bert_checkpoint`, its vocab-sized decoder dropped), timm
  `vit_base_patch16_224` (`pretrained_weights.timm_vit`, its 1000-class head
  dropped), `prajjwal1/bert-small` (`pretrained_weights.bert_small`: a file,
  an HF model directory, or a name in the local HF cache, read with
  `transformers`, imported only then), and the open_clip ViT-L/14 state dict
  (`pretrained_weights.open_clip`) feeding both OpenCLIP towers. A missing
  artifact leaves its tower at random init, and says so through `log`.
  LoRA adapters and fresh heads stay as they are; a tower takes the
  checkpoint's first layers up to its own depth.
- `load_pth_into_params` (:148-159): a released SimpleCLIP `.pth` overlaid
  onto the model.
- `resolve_reference_ckpt`: re-exported from `interop.weights`.

A checkpoint file holds tensors, numbers, strings and lists only, and is
read with `torch.load(weights_only=True)`; its model entry is
`state_dict`, so `interop.weights.load_reference_pth` reads it too.
"""

from __future__ import annotations

import os
import re
import threading

import torch
from torch import nn

from bioscan_clip_tpu_torch.interop.weights import (  # noqa: F401
    _from_open_clip,
    load_reference_pth,
    resolve_reference_ckpt,  # re-exported, as the JAX module has it
)
from bioscan_clip_tpu_torch.models.bert import (
    BarcodeBertDnaEncoder,
    BertTextEncoder,
)
from bioscan_clip_tpu_torch.models.lora import LORA_A_NAMES, LORA_B_NAMES
from bioscan_clip_tpu_torch.models.openclip import (
    OpenClipImageTower,
    OpenClipTextAdapter,
)
from bioscan_clip_tpu_torch.models.vit import ViTImageEncoder

# background writes in flight by target path (block=False)
_PENDING: dict = {}


class _Writer(threading.Thread):
    def __init__(self, path: str, payload: dict):
        super().__init__(daemon=True)
        self.path, self.payload, self.error = path, payload, None

    def run(self):
        try:
            _write(self.path, self.payload)
        except Exception as e:  # re-raised by whoever joins the write
            self.error = e


def _join(writer: _Writer) -> None:
    writer.join()
    if writer.error is not None:
        raise RuntimeError(f"checkpoint write to {writer.path} failed"
                           ) from writer.error


def wait_for_checkpoints() -> None:
    """Join every background write; raise if one failed."""
    while _PENDING:
        _join(_PENDING.popitem()[1])


def _write(path: str, payload) -> None:
    """`payload` into `<path>.writing`, flushed to disk, then moved onto
    `path` in one rename: `path` is the old file or the new one, never a
    part of either."""
    tmp = path + ".writing"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _snapshot(obj):
    """`obj` (nested dicts, lists and tuples of tensors) copied to the host,
    so the training that goes on cannot change what is written."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _snapshot(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_snapshot(v) for v in obj)
    return obj


def _group_names(state) -> list:
    """The parameter names of each optimizer group, in order."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [[names[id(p)] for p in g["params"]]
            for g in state.optimizer.param_groups]


def _save(directory: str, name: str, payload, block: bool) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(os.path.abspath(directory), name)
    prev = _PENDING.pop(path, None)
    if prev is not None:  # two saves to one name run in order
        _join(prev)
    payload = _snapshot(payload)
    if block:
        _write(path, payload)
    else:
        writer = _Writer(path, payload)
        writer.start()
        _PENDING[path] = writer
    return path


def _load(directory: str, name: str):
    path = os.path.join(os.path.abspath(directory), name)
    prev = _PENDING.pop(path, None)
    if prev is not None:
        _join(prev)
    return torch.load(path, map_location="cpu", weights_only=True)


def save_checkpoint(directory: str, state, name: str = "last",
                    block: bool = True) -> str:
    """Save the train state (`train.state.TrainState`) to
    `<directory>/<name>`; returns that path. `block=False` returns once
    the state is copied to the host and writes in a background thread:
    call `wait_for_checkpoints()` before reading the file or exiting."""
    return _save(directory, name, {
        "step": int(state.step),
        "state_dict": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "param_groups": _group_names(state),
        "generator": state.generator.get_state(),
    }, block)


def restore_checkpoint(directory: str, state, name: str = "last"):
    """Restore `<directory>/<name>` into `state`, in place, and return it.
    The state's optimizer must hold the same parameters in the same groups
    and order as the saved one's (one built by `create_train_state` over
    the same architecture does). Each parameter comes back in the dtype it
    was saved in."""
    payload = _load(directory, name)
    groups = _group_names(state)
    if groups != payload["param_groups"]:
        raise ValueError(
            "restore_checkpoint: the optimizer's parameter groups differ "
            f"from the checkpoint's ({[len(g) for g in groups]} vs "
            f"{[len(g) for g in payload['param_groups']]} parameters)")
    _load_state_dict(state.model, payload["state_dict"])
    state.load_optimizer_state(payload["optimizer"])
    state.step = int(payload["step"])
    state.generator.set_state(payload["generator"])
    return state


def save_params_only(directory: str, model: nn.Module,
                     name: str = "params") -> str:
    """The model's state dict alone to `<directory>/<name>`."""
    return _save(directory, name, model.state_dict(), block=True)


def restore_params_only(directory: str, model: nn.Module,
                        name: str = "params") -> nn.Module:
    """`save_params_only`'s file into `model`, in place; returns it."""
    _load_state_dict(model, _load(directory, name))
    return model


def _load_state_dict(model: nn.Module, saved: dict) -> None:
    """Every entry of `model.state_dict()` from `saved`, strictly by name and
    shape; an entry saved in another dtype is stored in the saved one (a
    frozen weight saved in bf16 comes back in bf16, into the same
    `nn.Parameter`, so an optimizer over it stays valid)."""
    own = model.state_dict(keep_vars=True)
    missing, extra = own.keys() - saved.keys(), saved.keys() - own.keys()
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {sorted(missing)[:5]}, "
                       f"unexpected {sorted(extra)[:5]}")
    with torch.no_grad():
        for key, t in own.items():
            src = saved[key]
            if src.shape != t.shape:
                raise ValueError(f"{key}: saved {tuple(src.shape)}, model "
                                 f"{tuple(t.shape)}")
            if src.dtype == t.dtype:
                t.copy_(src)
            else:
                t.data = src.to(t.device)


# --- the pretrained towers --------------------------------------------------

# a plain projection -> the projection inside its LoRA wrapper
_BERT_QV = (re.compile(r"^(.*\.attention\.self\.(?:query|value))\."
                       r"(weight|bias)$"), r"\1.w.\2")
_VIT_QKV = (re.compile(r"^(.*\.attn\.qkv)\.(weight|bias)$"), r"\1.qkv.\2")


def _is_adapter(key: str) -> bool:
    return any(k in LORA_A_NAMES + LORA_B_NAMES for k in key.split(".")[-2:])


def _rooted(sd: dict, prefix: str, own: dict, wrap: tuple) -> dict:
    """`sd`'s entries under `prefix`, where the model has them; a plain
    projection the model wraps with an adapter (`wrap`: `query.weight` ->
    `query.w.weight`, `attn.qkv.weight` -> `attn.qkv.qkv.weight`) goes to
    the wrapped projection. Entries the model lacks (a deeper checkpoint's
    layers, poolers, position-id buffers) are dropped."""
    out = {}
    pattern, wrapped = wrap
    for key, val in sd.items():
        k = prefix + key
        if k not in own:
            k = pattern.sub(wrapped, k)
        if k in own:
            out[k] = val
    return out


def _require(what: str, own: dict, mapped: dict, prefix: str,
             fresh=()) -> None:
    """Raise unless `mapped` covers every entry of the tower under `prefix`
    but its adapters and `fresh` heads (the JAX converters read them all)."""
    missing = [k for k in own if k.startswith(prefix) and k not in mapped
               and not _is_adapter(k) and not k.startswith(fresh)]
    if missing:
        raise KeyError(f"{what}: the checkpoint lacks {missing[:5]}")


def _barcode_bert(sd: dict, own: dict) -> dict:
    """A BarcodeBERT `BertForMaskedLM` state dict (JAX
    `convert_barcode_bert`): the encoder and the prediction transform; the
    decoder only when it is not vocab-sized (a replaced projection, not the
    MLM decoder the reference throws away)."""
    root = "dna_encoder.lora_barcode_bert."
    out = _rooted({k[len("bert."):]: v for k, v in sd.items()
                   if k.startswith("bert.")}, root + "bert.", own, _BERT_QV)
    _require("BarcodeBERT", own, out, root + "bert.")
    out.update({root + k: v for k, v in sd.items()
                if k.startswith("cls.predictions.transform.")
                and root + k in own})
    dec = sd.get("cls.predictions.decoder.weight")
    vocab = sd["bert.embeddings.word_embeddings.weight"].shape[0]
    if dec is not None and dec.shape[0] != vocab:
        out[root + "cls.predictions.decoder.weight"] = dec
        out[root + "cls.predictions.decoder.bias"] = sd[
            "cls.predictions.decoder.bias"]
    return out


def _timm_vit(sd: dict, own: dict, output_dim: int) -> dict:
    """A timm ViT state dict, or a SimpleCLIP one under `lora_vit.` (JAX
    `convert_timm_vit`); the head only when it has `output_dim` outputs."""
    if any(k.startswith("lora_vit.") for k in sd):
        sd = {k[len("lora_vit."):]: v for k, v in sd.items()
              if k.startswith("lora_vit.")}
    head = sd.get("head.weight")
    if head is None or head.shape[0] != output_dim:
        sd = {k: v for k, v in sd.items() if not k.startswith("head.")}
    root = "image_encoder.lora_vit."
    out = _rooted(sd, root, own, _VIT_QKV)
    _require("timm ViT", own, out, root, fresh=(root + "head.",))
    return out


def _bert_small(sd: dict, own: dict) -> dict:
    """An HF `BertModel` state dict (JAX `convert_bert_encoder`); the
    tower's `proj` stays fresh."""
    root = "language_encoder.lora_bert."
    out = _rooted(sd, root, own, _BERT_QV)
    _require("bert-small", own, out, root)
    return out


def _open_clip(sd: dict, own: dict, image: bool, text: bool) -> dict:
    """An open_clip state dict (`visual.*` and the text keys at its root,
    JAX `convert_openclip_visual`/`convert_openclip_text`), mapped as a
    released checkpoint's `open_clip_model.*` is (`interop.weights`,
    loratorch adapters included)."""
    mapped = _from_open_clip({"open_clip_model." + k: v
                              for k, v in sd.items()})
    out = {}
    for tower, root in ((image, "image_encoder."),
                        (text, "language_encoder.text.")):
        if tower:
            part = {k: v for k, v in mapped.items()
                    if k.startswith(root) and k in own}
            _require("open_clip", own, part, root)
            out.update(part)
    return out


def _hf_bert_state_dict(path_or_name: str):
    """An HF BERT state dict from a file, an HF model directory
    (`pytorch_model.bin`, `model.pth` or `model.bin` inside), or a model
    name in the local HF cache (never downloaded); None if there is none."""
    if os.path.isfile(path_or_name):
        return load_reference_pth(path_or_name)
    if os.path.isdir(path_or_name):
        for fname in ("pytorch_model.bin", "model.pth", "model.bin"):
            p = os.path.join(path_or_name, fname)
            if os.path.isfile(p):
                return load_reference_pth(p)
    try:
        from transformers import BertModel

        return BertModel.from_pretrained(
            path_or_name, local_files_only=True).state_dict()
    except Exception:  # no transformers, or not in the local cache
        return None


def load_pth_into_params(pth_path: str, model: nn.Module) -> nn.Module:
    """A released SimpleCLIP `.pth` overlaid onto `model`, in place (JAX
    checkpoint.py:148-159): every entry the checkpoint and the model share
    is loaded (`interop.weights.load_reference_pth`, then the same name
    mapping as `load_into`), shapes checked against the model's; the
    model's other entries keep their values. Returns the model."""
    sd = _from_open_clip(load_reference_pth(pth_path))
    own = model.state_dict()
    shared = {k: v for k, v in sd.items() if k in own}
    if not shared:
        raise KeyError(f"{pth_path}: no entry matches the model")
    bad = [k for k, v in shared.items() if v.shape != own[k].shape]
    if bad:
        raise ValueError(f"{pth_path}: shapes differ from the model's: "
                         f"{bad[:5]}")
    model.load_state_dict(shared, strict=False)
    return model


def load_pretrained_towers(args, model: nn.Module, output_dim: int = 768,
                           log=None) -> nn.Module:
    """Overlay the pretrained towers `args` names onto `model`, in place
    (see the module doc); returns the model. Which tower a model has
    decides which artifact is read."""
    def say(msg):
        if log:
            log(msg)

    pw = getattr(args, "pretrained_weights", None)

    def artifact(key):
        p = getattr(pw, key, None) if pw is not None else None
        return str(p) if p and os.path.exists(str(p)) else None

    own = model.state_dict()
    overlay = {}
    img, dna, txt = (model.image_encoder, model.dna_encoder,
                     model.language_encoder)

    ckpt = getattr(args, "bioscan_bert_checkpoint", None)
    if isinstance(dna, BarcodeBertDnaEncoder) and ckpt and os.path.isfile(
            str(ckpt)):
        overlay.update(_barcode_bert(load_reference_pth(str(ckpt)), own))
        say(f"dna_encoder <- BarcodeBERT {ckpt}")

    if isinstance(img, ViTImageEncoder):
        path = artifact("timm_vit")
        if path:
            overlay.update(_timm_vit(load_reference_pth(path), own,
                                     output_dim))
            say(f"image_encoder <- timm ViT {path}")
        else:
            say("image_encoder: no timm_vit artifact; random init")

    if isinstance(txt, BertTextEncoder):
        src = None
        if pw is not None and getattr(pw, "bert_small", None):
            src = _hf_bert_state_dict(str(pw.bert_small))
        if src is None:
            src = _hf_bert_state_dict("prajjwal1/bert-small")
        if src is not None:
            overlay.update(_bert_small(src, own))
            say("language_encoder <- bert-small weights")
        else:
            say("language_encoder: no bert-small artifact; random init")

    oc_img = isinstance(img, OpenClipImageTower)
    oc_txt = isinstance(txt, OpenClipTextAdapter)
    oc_path = artifact("open_clip")
    if (oc_img or oc_txt) and oc_path:
        overlay.update(_open_clip(load_reference_pth(oc_path), own, oc_img,
                                  oc_txt))
        say(f"open_clip towers <- {oc_path}")
    elif oc_img or oc_txt:
        say("open_clip towers: no artifact; random init")

    with torch.no_grad():
        for key, val in overlay.items():
            if tuple(val.shape) != tuple(own[key].shape):
                raise ValueError(f"shape mismatch in {key}: model "
                                 f"{tuple(own[key].shape)} vs checkpoint "
                                 f"{tuple(val.shape)}")
            own[key].copy_(val)
    return model
