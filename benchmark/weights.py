"""The benchmark's weights: every parameter of a configuration's towers,
named as the published checkpoints name them, drawn from `--seed` on the
device in one call and handed alike to the program and to the reference.

Nothing here reads the program: the names and shapes follow from the
configuration file's `geometry`. A LoRA adapter's B is drawn non-zero, as
in a trained adapter, so every adapter leaf has a gradient at the first
step. `frozen_bf16`: the frozen leaves that the towers consume in their
products are rounded to bfloat16, the type they are trained in
(`tpu.frozen_dtype: bfloat16`); LayerNorms and trainable leaves stay
float32.
"""

from __future__ import annotations

import torch

# the standard deviation (or the shift and spread) of each kind of leaf
WEIGHT_STD = 0.02
LORA_B_STD = 0.05
LN_WEIGHT_STD = 0.1
LN_BIAS_STD = 0.05
TRAINABLE_PARENTS = ("head", "decoder", "proj")


def _ln(pre):
    return [(pre + ".weight", None, "lnw"), (pre + ".bias", None, "lnb")]


def _dense(pre, out_f, in_f, bias=True):
    leaves = [(pre + ".weight", (out_f, in_f), "w")]
    if bias:
        leaves.append((pre + ".bias", (out_f,), "b"))
    return leaves


def _with_shapes(leaves, width):
    return [(n, s if s is not None else (width,), k) for n, s, k in leaves]


def vit_spec(g, pre):
    d, r, p = g["hidden"], g["lora_rank"], g["patch"]
    n = (g["image_size"] // p) ** 2 + 1
    out = [(pre + "cls_token", (1, 1, d), "w"), (pre + "pos_embed", (1, n, d), "w"),
           (pre + "patch_embed.proj.weight", (d, 3, p, p), "w"),
           (pre + "patch_embed.proj.bias", (d,), "b")]
    for i in range(g["layers"]):
        b = f"{pre}blocks.{i}."
        a = b + "attn.qkv."
        out += _ln(b + "norm1") + _dense(a + "qkv", 3 * d, d)
        out += [(a + "linear_a_q.weight", (r, d), "la"),
                (a + "linear_b_q.weight", (d, r), "lb"),
                (a + "linear_a_v.weight", (r, d), "la"),
                (a + "linear_b_v.weight", (d, r), "lb")]
        out += _dense(b + "attn.proj", d, d) + _ln(b + "norm2")
        out += _dense(b + "mlp.fc1", g["mlp"], d) + _dense(b + "mlp.fc2", d,
                                                            g["mlp"])
    out += _ln(pre + "norm") + _dense(pre + "head", g["output_dim"], d)
    return _with_shapes(out, d)


def bert_spec(g, pre):
    d, r, m = g["hidden"], g["lora_rank"], g["intermediate"]
    e = pre + "embeddings."
    out = [(e + "word_embeddings.weight", (g["vocab"], d), "w"),
           (e + "position_embeddings.weight", (g["max_positions"], d), "w"),
           (e + "token_type_embeddings.weight", (g["type_vocab"], d), "w")]
    out += _ln(e + "LayerNorm")
    for i in range(g["layers"]):
        ly = f"{pre}encoder.layer.{i}."
        sa = ly + "attention.self."
        for slot in ("query", "value", "key"):
            if slot == "key":
                out += _dense(sa + "key", d, d)
                continue
            out += _dense(sa + slot + ".w", d, d)
            out += [(sa + slot + ".w_a.weight", (r, d), "la"),
                    (sa + slot + ".w_b.weight", (d, r), "lb")]
        out += _dense(ly + "attention.output.dense", d, d)
        out += _ln(ly + "attention.output.LayerNorm")
        out += _dense(ly + "intermediate.dense", m, d)
        out += _dense(ly + "output.dense", d, m) + _ln(ly + "output.LayerNorm")
    return _with_shapes(out, d)


def barcode_bert_spec(g, pre="dna_encoder.lora_barcode_bert."):
    d = g["hidden"]
    t = pre + "cls.predictions."
    out = bert_spec(g, pre + "bert.")
    out += _with_shapes(_dense(t + "transform.dense", d, d)
                        + _ln(t + "transform.LayerNorm")
                        + _dense(t + "decoder", g["output_dim"], d), d)
    return out


def bert_small_spec(g, pre="language_encoder."):
    return (bert_spec(g, pre + "lora_bert.")
            + _dense(pre + "proj", g["output_dim"], g["hidden"]))


def _openclip_blocks(g, pre):
    d, r = g["hidden"], g["lora_rank"]
    out = []
    for i in range(g["layers"]):
        b = f"{pre}transformer.resblocks.{i}."
        out += _ln(b + "ln_1")
        out += [(b + "attn.in_proj_weight", (3 * d, d), "w"),
                (b + "attn.in_proj_bias", (3 * d,), "b")]
        for s in "qkv":
            out += [(b + f"attn.{s}_lora_A", (r, d), "la"),
                    (b + f"attn.{s}_lora_B", (d, r), "lb")]
        out += _dense(b + "attn.out_proj", d, d) + _ln(b + "ln_2")
        out += _dense(b + "mlp.c_fc", g["mlp"], d)
        out += _dense(b + "mlp.c_proj", d, g["mlp"])
    return out


def openclip_visual_spec(g, pre="image_encoder."):
    d, p = g["hidden"], g["patch"]
    n = (g["image_size"] // p) ** 2 + 1
    out = [(pre + "class_embedding", (d,), "w"),
           (pre + "positional_embedding", (n, d), "w"),
           (pre + "proj", (d, g["output_dim"]), "w"),
           (pre + "conv1.weight", (d, 3, p, p), "w")]
    out += _ln(pre + "ln_pre") + _openclip_blocks(g, pre) + _ln(pre + "ln_post")
    return _with_shapes(out, d)


def openclip_text_spec(g, pre="language_encoder.text."):
    d = g["hidden"]
    out = [(pre + "positional_embedding", (g["context"], d), "w"),
           (pre + "text_projection", (d, g["output_dim"]), "w"),
           (pre + "token_embedding.weight", (g["vocab"], d), "w")]
    out += _openclip_blocks(g, pre) + _ln(pre + "ln_final")
    return _with_shapes(out, d)


TOWER_SPECS = {
    "vit": lambda g: vit_spec(g, "image_encoder.lora_vit."),
    "barcode_bert": barcode_bert_spec,
    "bert_small": bert_small_spec,
    "openclip_visual": openclip_visual_spec,
    "openclip_text": openclip_text_spec,
}


def model_spec(geometry: dict):
    """[(name, shape, kind)] of every tower the configuration declares."""
    out = []
    for role in ("image", "dna", "language"):
        if role in geometry:
            g = geometry[role]
            out += TOWER_SPECS[g["tower"]](g)
    return out


def trainable(name: str) -> bool:
    """The trained set: the LoRA adapters and each tower's fresh projection
    (a module named head, decoder or proj above the leaf, but ViT's patch
    embedding), the rule of the JAX package that the port follows."""
    keys = name.split(".")
    if any(k.startswith(("linear_a_", "linear_b_")) or k in ("w_a", "w_b")
           or k[1:] in ("_lora_A", "_lora_B") for k in keys):
        return True
    if "patch_embed" in keys:
        return False
    return any(k in TRAINABLE_PARENTS for k in keys[:-1])


def make_weights(geometry: dict, seed: int, device, frozen_bf16: bool = False):
    """{name: float32 tensor} of every leaf of `model_spec(geometry)`, drawn
    from one normal draw of a generator on `device` seeded with `seed`."""
    spec = model_spec(geometry)
    sizes = [torch.Size(s).numel() for _, s, _ in spec]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    with torch.no_grad():
        for (name, shape, kind), n in zip(spec, sizes):
            v = flat[off:off + n].view(shape)
            off += n
            if kind == "w" or kind == "b":
                v.mul_(WEIGHT_STD)
            elif kind == "lnw":
                v.mul_(LN_WEIGHT_STD).add_(1.0)
            elif kind == "lnb":
                v.mul_(LN_BIAS_STD)
            elif kind == "la":
                v.mul_(shape[1] ** -0.5)
            elif kind == "lb":
                v.mul_(LORA_B_STD)
            if frozen_bf16 and kind in ("w", "b") and not trainable(name):
                v.copy_(v.to(torch.bfloat16))
            out[name] = v
    return out
