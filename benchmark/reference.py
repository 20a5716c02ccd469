"""The plain reference of the benchmark's cells: PyTorch operations on a
dict of float32 tensors, no kernels, no cache, no batching tricks.

It imports torch and numpy only: nothing of the program under test, and
neither JAX nor the JAX package. Everything the program derives from the
shared inputs (the step seeds, the augmentation draws, the dropout keep
bits, the merged LoRA weights) is worked out again here from the same
seeds, with frozen copies of the published formulas:

- ViT-B/16 (timm geometry, LoRA rank r on q and v), BarcodeBERT and
  BERT-small (HF BERT geometry, LoRA on query and value, row-keyed counter
  hash dropout), the 6-term soft-label InfoNCE of BIOSCAN-CLIP;
- OpenCLIP ViT-L/14's image tower (LoRA on q, k and v, merged for serving);
- the train augmentation (RandomResizedCrop as two products, flips, nearest
  rotation) and the eval transform (center crops, CLIP normalize).

`Numerics` rounds every product's operands, and the gradients that come
back into the products: float32 is the reference itself; "fp8"
(per-tensor scaled e4m3) is the lower precision of the correctness
control. TF32 is switched off by `no_tf32`.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

M32 = 0xFFFFFFFF
FP8_MAX = 448.0  # the largest float8_e4m3fn value


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32, not TF32, while the block runs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_round(t):
    """`t` scaled by its absolute maximum to e4m3's range, rounded to
    float8_e4m3fn and scaled back."""
    s = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _Fp8Grad(torch.autograd.Function):
    """The identity, whose gradient is rounded by `fp8_round`."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g)


class Numerics:
    """How the operands of a product are rounded: "float32" (not at all) or
    "fp8" (`fp8_round`, forward and backward: a product's inputs are
    rounded, and so is the gradient that comes back into it, so that every
    product of the backward takes operands in fp8 too)."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def q(self, t):
        """`t` with its values rounded; the gradient passes as through
        the identity (a straight-through rounding), so the backward's
        products take the rounded operands the forward saved."""
        if self.precision == "float32":
            return t
        return t + (fp8_round(t.detach()) - t.detach())

    def out(self, y):
        """A product's result, whose gradient is rounded on its way back
        into the product."""
        return y if self.precision == "float32" else _Fp8Grad.apply(y)

    def linear(self, x, w, b=None):
        y = self.out(torch.matmul(self.q(x), self.q(w).t()))
        return y if b is None else y + b

    def matmul(self, a, b):
        return self.out(torch.matmul(self.q(a), self.q(b)))


FP32 = Numerics("float32")


# --- the counter hash of the dropout masks --------------------------------

def mul32(x, c: int):
    """(x * c) mod 2**32 on int64 values in [0, 2**32)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def mix32(x):
    """The murmur3 finalizer on uint32 values held in int64."""
    x = x & M32
    x = mul32(x ^ (x >> 16), 0x7FEB352D)
    x = mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def keep_threshold(rate: float) -> int:
    return min(int(rate * 2.0**32), 2**32 - 1)


def keep_scale(rate: float) -> float:
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def row_seeds(step_seed: int, salt: int, rows, device):
    """(B,) row seeds of one tower: mix32(step ^ salt ^ mix32(row + 1))."""
    r = torch.as_tensor(rows, dtype=torch.int64, device=device) & M32
    base = torch.full((), (int(step_seed) ^ salt) & M32, dtype=torch.int64,
                      device=device)
    return mix32(base ^ mix32(r + 1))


def salt_advance(salt):
    return mix32(salt + 0x9E3779B9)


def site_seed(salt, site: int):
    c = (site * 0x85EBCA6B + 0xC2B2AE35) & M32
    return mix32(salt ^ c)


def hidden_dropout(x, rate: float, salt, site: int):
    """Element (b, p) of (B, ...) x keeps when mix32(site_seed[b] ^
    mix32(p + 1)) >= the threshold; kept elements scale by 1 / (1 - rate)."""
    if salt is None or rate <= 0:
        return x
    pos = torch.arange(x[0].numel(), device=x.device)
    u = mix32(site_seed(salt, site)[:, None] ^ mix32(pos + 1)[None, :])
    keep = (u >= keep_threshold(rate)).reshape(x.shape)
    return torch.where(keep, x * (1.0 / (1.0 - rate)), torch.zeros_like(x))


def attention_keep(seed, heads: int, n: int, rate: float):
    """(B, heads, N, N) keep-and-scale mask: element (b, h, i, j) keeps when
    mix32(seed[b] ^ mix32((h * N + i) * N + j)) >= the threshold."""
    dev = seed.device
    h = torch.arange(heads, device=dev)[:, None, None]
    i = torch.arange(n, device=dev)[None, :, None]
    j = torch.arange(n, device=dev)[None, None, :]
    idx = ((h * n + i) * n + j) & M32
    u = mix32(seed[:, None, None, None] ^ mix32(idx)[None])
    return (u >= keep_threshold(rate)).to(torch.float32) * keep_scale(rate)


# --- building blocks ------------------------------------------------------

def layer_norm(x, p, pre, eps):
    return F.layer_norm(x, x.shape[-1:], p[pre + ".weight"], p[pre + ".bias"],
                        eps)


def gelu(x):
    return F.gelu(x, approximate="none")


def attention(qm, km, vm, heads, nx: Numerics, bias=None, keep=None):
    """Softmax attention over (B, N, D) q, k, v split into heads; `bias` a
    (B, N) additive key bias, `keep` a (B, h, N, N) keep-and-scale mask on
    the probabilities."""
    b, n, d = qm.shape
    hd = d // heads

    def split(t):
        return t.reshape(b, n, heads, hd).transpose(1, 2)

    s = nx.matmul(split(qm), split(km).transpose(-1, -2)) * hd ** -0.5
    if bias is not None:
        s = s + bias[:, None, None, :]
    pr = torch.softmax(s, dim=-1)
    if keep is not None:
        pr = pr * keep
    o = nx.matmul(pr, split(vm))
    return o.transpose(1, 2).reshape(b, n, d)


def lora(x, p, a, b, nx):
    return nx.linear(nx.linear(x, p[a]), p[b])


def patchify(images, patch: int):
    """(B, H, W, C) -> (B, (H/p)(W/p), p*p*C), rows in (py, px, c) order."""
    b, h, w, c = images.shape
    x = images.reshape(b, h // patch, patch, w // patch, patch, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, -1, patch * patch * c)


def conv_as_matrix(w):
    """An (O, C, p, p) convolution weight as the (O, p*p*C) matrix of
    `patchify`'s rows."""
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)


# --- the flagship's towers -------------------------------------------------

def vit_b16(p, g, images, nx=FP32, pre="image_encoder.lora_vit."):
    """timm ViT-B/16 with LoRA on the q and v thirds of the fused qkv:
    (B, 224, 224, 3) float -> (B, output_dim)."""
    d = g["hidden"]
    x = nx.linear(patchify(images, g["patch"]),
                  conv_as_matrix(p[pre + "patch_embed.proj.weight"]),
                  p[pre + "patch_embed.proj.bias"])
    cls = p[pre + "cls_token"].expand(x.shape[0], -1, -1)
    x = torch.cat([cls, x], dim=1) + p[pre + "pos_embed"]
    for i in range(g["layers"]):
        blk = f"{pre}blocks.{i}."
        h = layer_norm(x, p, blk + "norm1", g["ln_eps"])
        qkv = nx.linear(h, p[blk + "attn.qkv.qkv.weight"],
                        p[blk + "attn.qkv.qkv.bias"])
        a = blk + "attn.qkv."
        qm = qkv[..., :d] + lora(h, p, a + "linear_a_q.weight",
                                 a + "linear_b_q.weight", nx)
        vm = qkv[..., 2 * d:] + lora(h, p, a + "linear_a_v.weight",
                                     a + "linear_b_v.weight", nx)
        o = attention(qm, qkv[..., d:2 * d], vm, g["heads"], nx)
        x = x + nx.linear(o, p[blk + "attn.proj.weight"],
                          p[blk + "attn.proj.bias"])
        h = layer_norm(x, p, blk + "norm2", g["ln_eps"])
        h = gelu(nx.linear(h, p[blk + "mlp.fc1.weight"],
                           p[blk + "mlp.fc1.bias"]))
        x = x + nx.linear(h, p[blk + "mlp.fc2.weight"],
                          p[blk + "mlp.fc2.bias"])
    c = layer_norm(x[:, 0], p, pre + "norm", g["ln_eps"])
    return nx.linear(c, p[pre + "head.weight"], p[pre + "head.bias"])


def bert(p, g, pre, ids, nx=FP32, mask=None, seeds=None):
    """HF BERT (post-LN) with LoRA on query and value -> (B, N, hidden).
    `seeds`: the (B,) row seeds in train mode (dropout at g["dropout"] on
    the embeddings, the attention probabilities, the attention output and
    the MLP output), None in eval mode."""
    rate = g["dropout"] if seeds is not None else 0.0
    n = ids.shape[1]
    e = pre + "embeddings."
    x = (p[e + "word_embeddings.weight"][ids]
         + p[e + "position_embeddings.weight"][:n][None]
         + p[e + "token_type_embeddings.weight"][0][None, None])
    x = hidden_dropout(layer_norm(x, p, e + "LayerNorm", g["ln_eps"]), rate,
                       seeds, 0)
    bias = None
    if mask is not None:
        bias = torch.where(mask > 0, 0.0, -1e9).to(x.dtype)
    salt = seeds
    for i in range(g["layers"]):
        ly = f"{pre}encoder.layer.{i}."
        if salt is not None:
            salt = salt_advance(salt)
        sa = ly + "attention.self."
        qm = (nx.linear(x, p[sa + "query.w.weight"], p[sa + "query.w.bias"])
              + lora(x, p, sa + "query.w_a.weight", sa + "query.w_b.weight",
                     nx))
        km = nx.linear(x, p[sa + "key.weight"], p[sa + "key.bias"])
        vm = (nx.linear(x, p[sa + "value.w.weight"], p[sa + "value.w.bias"])
              + lora(x, p, sa + "value.w_a.weight", sa + "value.w_b.weight",
                     nx))
        keep = (attention_keep(site_seed(salt, 1), g["heads"], n, rate)
                if rate > 0 else None)
        o = attention(qm, km, vm, g["heads"], nx, bias=bias, keep=keep)
        y = hidden_dropout(
            nx.linear(o, p[ly + "attention.output.dense.weight"],
                      p[ly + "attention.output.dense.bias"]), rate, salt, 2)
        x = layer_norm(x + y, p, ly + "attention.output.LayerNorm",
                       g["ln_eps"])
        y = gelu(nx.linear(x, p[ly + "intermediate.dense.weight"],
                           p[ly + "intermediate.dense.bias"]))
        y = hidden_dropout(nx.linear(y, p[ly + "output.dense.weight"],
                                     p[ly + "output.dense.bias"]), rate,
                           salt, 3)
        x = layer_norm(x + y, p, ly + "output.LayerNorm", g["ln_eps"])
    return x


def barcode_bert(p, g, ids, nx=FP32, seeds=None,
                 pre="dna_encoder.lora_barcode_bert."):
    """BarcodeBERT: BERT, the MLM transform, the replaced decoder, a softmax
    over the output features and a mean over the tokens."""
    x = bert(p, g, pre + "bert.", ids, nx, seeds=seeds)
    t = pre + "cls.predictions."
    x = gelu(nx.linear(x, p[t + "transform.dense.weight"],
                       p[t + "transform.dense.bias"]))
    x = layer_norm(x, p, t + "transform.LayerNorm", g["ln_eps"])
    x = nx.linear(x, p[t + "decoder.weight"], p[t + "decoder.bias"])
    return torch.softmax(x, dim=-1).mean(dim=1)


def bert_small(p, g, ids, mask, nx=FP32, seeds=None,
               pre="language_encoder."):
    """BERT-small, an unmasked mean over the tokens, then `proj`."""
    x = bert(p, g, pre + "lora_bert.", ids, nx, mask=mask, seeds=seeds)
    return nx.linear(x.mean(dim=1), p[pre + "proj.weight"],
                     p[pre + "proj.bias"])


def l2n(x):
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def contrastive_loss(embs, labels, logit_scale: float):
    """The mean over ordered modality pairs of the soft-label InfoNCE:
    -sum_j [labels_i == labels_j] log_softmax(scale * a_i . b_j)."""
    target = (labels[None, :] == labels[:, None]).to(torch.float32)
    feats = [l2n(e) for e in embs]
    terms = []
    for i, a in enumerate(feats):
        for j, b in enumerate(feats):
            if i != j:
                logp = torch.log_softmax(logit_scale * a @ b.t(), dim=-1)
                terms.append(-(target * logp).sum(dim=-1).mean())
    return sum(terms) / len(terms)


# --- OpenCLIP ViT-L/14, served with its LoRA merged ------------------------

def merge_openclip_lora(p, g, pre="image_encoder."):
    """{in_proj_weight of each block: W + [B_q A_q; B_k A_k; B_v A_v]}."""
    out = {}
    for i in range(g["layers"]):
        a = f"{pre}transformer.resblocks.{i}.attn."
        w = p[a + "in_proj_weight"].clone()
        d = w.shape[1]
        for j, s in enumerate("qkv"):
            w[j * d:(j + 1) * d] += p[a + f"{s}_lora_B"] @ p[a + f"{s}_lora_A"]
        out[a + "in_proj_weight"] = w
    return out


def openclip_visual(p, g, images, nx=FP32, merged=None, pre="image_encoder."):
    """OpenCLIP's `visual`: (B, 224, 224, 3) normalized -> (B, output_dim).
    `merged`: `merge_openclip_lora(p, g)`."""
    merged = merged if merged is not None else merge_openclip_lora(p, g, pre)
    x = nx.linear(patchify(images, g["patch"]),
                  conv_as_matrix(p[pre + "conv1.weight"]))
    cls = p[pre + "class_embedding"].expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + p[pre + "positional_embedding"]
    x = layer_norm(x, p, pre + "ln_pre", g["ln_eps"])
    d = g["hidden"]
    for i in range(g["layers"]):
        blk = f"{pre}transformer.resblocks.{i}."
        h = layer_norm(x, p, blk + "ln_1", g["ln_eps"])
        qkv = nx.linear(h, merged[blk + "attn.in_proj_weight"],
                        p[blk + "attn.in_proj_bias"])
        o = attention(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:],
                      g["heads"], nx)
        x = x + nx.linear(o, p[blk + "attn.out_proj.weight"],
                          p[blk + "attn.out_proj.bias"])
        h = layer_norm(x, p, blk + "ln_2", g["ln_eps"])
        h = gelu(nx.linear(h, p[blk + "mlp.c_fc.weight"],
                           p[blk + "mlp.c_fc.bias"]))
        x = x + nx.linear(h, p[blk + "mlp.c_proj.weight"],
                          p[blk + "mlp.c_proj.bias"])
    c = layer_norm(x[:, 0], p, pre + "ln_post", g["ln_eps"])
    return nx.matmul(c, p[pre + "proj"])


# --- image transforms -------------------------------------------------------

INV_255 = float(np.float32(1.0) / np.float32(255.0))
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def eval_crop(frames_u8, serve_crop: int = 256, size: int = 224):
    """The served image path for frames whose shorter side is already
    `serve_crop`: the central (serve_crop, serve_crop) square, then the
    central (size, size) window, as float in [0, 1]."""
    _, h, w, _ = frames_u8.shape
    if min(h, w) != serve_crop:
        raise ValueError("the reference serves frames whose shorter side is "
                         f"{serve_crop}, got {(h, w)}")
    top = (h - serve_crop) // 2 + (serve_crop - size) // 2
    left = (w - serve_crop) // 2 + (serve_crop - size) // 2
    x = frames_u8[:, top:top + size, left:left + size]
    return x.to(torch.float32) * INV_255


def clip_normalize(x):
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std


def step_seeds(base: int, n: int):
    """The first n uint32 step seeds a training run seeded with `base`
    draws: randint(0, 2**32) from a CPU generator, one per step."""
    gen = torch.Generator().manual_seed(int(base))
    return [int(torch.randint(0, 2**32, (), generator=gen,
                              dtype=torch.int64)) for _ in range(n)]


AUG_SALT = 0xA06


def draw_train_aug(step_seed: int, b: int, h: int, w: int,
                   scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """One step's augmentation draws for b rows of (h, w) frames (the
    shorter side already 256): RandomResizedCrop boxes (10 proposals each,
    the first that fits, else the ratio-clamped central crop), flip bits,
    rotation angles in +-45 degrees, from a CPU generator seeded with
    (step_seed << 12) | 0xA06, in that order."""
    gen = torch.Generator().manual_seed(((int(step_seed) & M32) << 12)
                                        | AUG_SALT)
    area = h * w
    ta = area * (scale[0] + (scale[1] - scale[0])
                 * torch.rand((b, 10), generator=gen))
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    r = torch.exp(lo + (hi - lo) * torch.rand((b, 10), generator=gen))
    u_i, u_j = torch.rand((2, b), generator=gen)
    ws = torch.round(torch.sqrt(ta * r)).to(torch.int64)
    hs = torch.round(torch.sqrt(ta / r)).to(torch.int64)
    valid = (ws > 0) & (ws <= w) & (hs > 0) & (hs <= h)
    sel = valid.to(torch.int8).argmax(dim=1, keepdim=True)
    any_valid = valid.any(dim=1)
    w_s, h_s = ws.gather(1, sel)[:, 0], hs.gather(1, sel)[:, 0]
    i_s = torch.floor(u_i * (h - h_s + 1).float()).to(torch.int64)
    j_s = torch.floor(u_j * (w - w_s + 1).float()).to(torch.int64)
    in_ratio = w / h
    if in_ratio < ratio[0]:
        w_f, h_f = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        h_f, w_f = h, int(round(h * ratio[1]))
    else:
        w_f, h_f = w, h
    i_f, j_f = (h - h_f) // 2, (w - w_f) // 2

    def pick(s, f):
        return torch.where(any_valid, s, torch.full_like(s, f))

    boxes = (pick(i_s, i_f), pick(j_s, j_f), pick(h_s, h_f), pick(w_s, w_f))
    flips = torch.rand((2, b), generator=gen)
    angles = (-45.0 + 90.0 * torch.rand(b, generator=gen)) * (math.pi / 180)
    return {"boxes": boxes, "flips": (flips[0] < 0.5, flips[1] < 0.5),
            "angles": angles}


def _interp(starts, sizes, extent: int, out: int):
    """(B, out, extent) weights that crop [start, start + size) and resize
    it to `out` with the antialiased triangle filter."""
    starts = starts.to(torch.float32)[:, None]
    sizes = sizes.to(torch.float32)[:, None]
    dev = starts.device
    o = torch.arange(out, dtype=torch.float32, device=dev)[None, :]
    scale = sizes / torch.full_like(sizes, float(out))
    src = starts + (o + 0.5) * scale - 0.5
    support = torch.clamp_min(scale, 1.0)
    hh = torch.arange(extent, dtype=torch.float32, device=dev)[None, None, :]
    wgt = torch.clamp_min(1.0 - (hh - src[:, :, None]).abs()
                          / support[:, :, None], 0.0)
    inside = ((hh >= starts[:, :, None] - 0.5)
              & (hh <= (starts + sizes)[:, :, None] - 0.5))
    wgt = torch.where(inside, wgt, 0.0)
    return wgt / torch.clamp_min(wgt.sum(dim=-1, keepdim=True), 1e-8)


def train_augment(frames_u8, aug, size: int = 224):
    """RandomResizedCrop(size) -> HFlip -> VFlip -> RandomRotation(45,
    nearest, zero fill) with the draws `aug`, on (B, H, W, 3) uint8 frames
    whose shorter side is 256: float32 (B, size, size, 3)."""
    b, hh, ww, c = frames_u8.shape
    if min(hh, ww) != 256:
        raise ValueError("the reference augments frames whose shorter side "
                         f"is 256, got {(hh, ww)}")
    dev = frames_u8.device
    x = frames_u8.to(torch.float32) * INV_255
    i, j, h, w = (t.to(dev) for t in aug["boxes"])
    wy, wx = _interp(i, h, hh, size), _interp(j, w, ww, size)
    t = torch.bmm(wy, x.reshape(b, hh, ww * c))
    t = t.reshape(b, size, ww, c).transpose(1, 2)
    x = torch.bmm(wx, t.reshape(b, ww, size * c))
    x = x.reshape(b, size, size, c).transpose(1, 2)
    do_h, do_v = (f.to(dev)[:, None, None, None] for f in aug["flips"])
    x = torch.where(do_h, x.flip(2), x)
    x = torch.where(do_v, x.flip(1), x)
    a = aug["angles"].to(torch.float32)[:, None, None]
    cos, sin = torch.cos(a).to(dev), torch.sin(a).to(dev)
    cy = cx = (size - 1) / 2.0
    yy = torch.arange(size, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(size, dtype=torch.float32, device=dev)[None, :]
    sy = cy + (yy - cy) * cos + (xx - cx) * sin
    sx = cx - (yy - cy) * sin + (xx - cx) * cos
    iy, ix = torch.round(sy).to(torch.int64), torch.round(sx).to(torch.int64)
    inb = (iy >= 0) & (iy < size) & (ix >= 0) & (ix < size)
    idx = iy.clamp(0, size - 1) * size + ix.clamp(0, size - 1)
    out = x.reshape(b, size * size, c).gather(
        1, idx.reshape(b, size * size, 1).expand(-1, -1, c))
    return torch.where(inb[..., None], out.reshape(b, size, size, c), 0.0)
