"""OpenCLIP-geometry towers: the ViT-L/14 image tower and the text tower of
the ablation configs (`for_open_clip`).

Counterpart of bioscan_clip_tpu/models/openclip.py:35-239:
- image: conv1 (p x p, stride p, no bias) -> class token + positional
  embedding -> ln_pre -> pre-LN blocks (packed qkv, 4x MLP, exact GELU) ->
  ln_post on the CLS token -> `proj`;
- text: token embedding + `positional_embedding[:N]` -> the same blocks
  under a causal (N, N) score mask of -1e9 above the diagonal (the JAX
  value, :204-206, not open_clip's -inf) -> ln_final -> the row at the
  first maximum token id (the EOT of CLIP-BPE ids) -> `text_projection`.
Every attention carries LoRA on its q, k and v thirds
(`models.lora.LoRAInProj`, JAX :86-95). LayerNorms (eps 1e-5) compute in
fp32 and cast to the compute dtype; the residual stream and the products run
in the compute dtype; attention goes through `ops.attention.mha_packed` (K1,
and K1m with the causal mask; backward K3, and K3m with the mask). The
blocks have no dropout (the JAX blocks accept `deterministic` and never read
it), so train mode computes what eval mode computes.

Parameter names are open_clip's (`conv1`, `class_embedding`,
`transformer.resblocks.{i}.attn.in_proj_weight`, `mlp.c_fc`, `ln_final`,
`text_projection`, ...), so a released `open_clip_model.*` checkpoint maps
by prefix (`interop.weights.load_into`).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from bioscan_clip_tpu_torch.models.common import (
    LayerNorm,
    dense,
    gelu_exact,
    patch_embed,
)
from bioscan_clip_tpu_torch.models.lora import LoRAInProj
from bioscan_clip_tpu_torch.ops.attention import mha_packed

CAUSAL_MASK_VALUE = -1e9


@dataclasses.dataclass(frozen=True)
class OpenClipVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    output_dim: int = 768
    lora_rank: int = 4
    ln_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class OpenClipTextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 768
    layers: int = 12
    heads: int = 12
    output_dim: int = 768
    lora_rank: int = 4
    ln_eps: float = 1e-5


class _Attention(LoRAInProj):
    """torch MultiheadAttention's parameters under open_clip's names:
    `in_proj_weight`/`in_proj_bias` (with the adapters) and `out_proj`."""

    def __init__(self, width: int, heads: int, rank: int):
        super().__init__(width, rank)
        self.heads = heads
        self.out_proj = nn.Linear(width, width)


class _Mlp(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)


class OpenClipBlock(nn.Module):
    """ResidualAttentionBlock (JAX `OpenClipBlock`, :65-123): pre-LN, packed
    qkv + LoRA, optional (N, N) additive score mask, 4x MLP."""

    def __init__(self, width: int, heads: int, lora_rank: int, ln_eps: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ln_1 = LayerNorm(width, ln_eps)
        self.attn = _Attention(width, heads, lora_rank)
        self.ln_2 = LayerNorm(width, ln_eps)
        self.mlp = _Mlp(width)

    def forward(self, x, mask=None):
        dt = self.dtype
        qkv = self.attn.in_proj(self.ln_1(x).to(dt), dt)
        y = mha_packed(qkv, self.attn.heads, mask=mask)
        x = x + dense(self.attn.out_proj, y, dt)
        y = gelu_exact(dense(self.mlp.c_fc, self.ln_2(x).to(dt), dt))
        return x + dense(self.mlp.c_proj, y, dt)


class _Transformer(nn.Module):
    def __init__(self, width, heads, layers, lora_rank, ln_eps, dtype):
        super().__init__()
        self.resblocks = nn.ModuleList(
            OpenClipBlock(width, heads, lora_rank, ln_eps, dtype)
            for _ in range(layers)
        )

    def forward(self, x, mask=None):
        for blk in self.resblocks:
            x = blk(x, mask)
        return x


class OpenClipImageTower(nn.Module):
    """open_clip's `visual` (JAX `OpenClipImageTower`, :145-184)."""

    def __init__(self, cfg: OpenClipVisionConfig = OpenClipVisionConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, c.width, c.patch_size, stride=c.patch_size,
                               bias=False)
        self.class_embedding = nn.Parameter(torch.empty(c.width))
        self.positional_embedding = nn.Parameter(
            torch.empty((c.image_size // c.patch_size) ** 2 + 1, c.width))
        self.ln_pre = LayerNorm(c.width, c.ln_eps)
        self.transformer = _Transformer(c.width, c.heads, c.layers,
                                        c.lora_rank, c.ln_eps, dtype)
        self.ln_post = LayerNorm(c.width, c.ln_eps)
        self.proj = nn.Parameter(torch.empty(c.width, c.output_dim))

    def forward(self, images):
        """images: (B, H, W, 3) float, preprocessed (NHWC)."""
        dt = self.dtype
        x = patch_embed(images, self.conv1, dt)
        cls = self.class_embedding.to(dt).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        x = self.transformer(self.ln_pre(x).to(dt))
        # LN is per token: slicing CLS first equals LN-then-slice
        return self.ln_post(x[:, 0]).to(dt) @ self.proj.to(dt)


def causal_mask(n: int, device=None):
    """(n, n) fp32: 0 on and below the diagonal, -1e9 above (JAX :204-206).
    exp(-1e9 - max) is exactly 0 in fp32, as with -inf."""
    full = torch.full((n, n), CAUSAL_MASK_VALUE, dtype=torch.float32,
                      device=device)
    return torch.triu(full, diagonal=1)


class OpenClipTextTower(nn.Module):
    """open_clip's text encoder (JAX `OpenClipTextTower`, :187-223)."""

    def __init__(self, cfg: OpenClipTextConfig = OpenClipTextConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.dtype = dtype
        self.token_embedding = nn.Embedding(c.vocab_size, c.width)
        self.positional_embedding = nn.Parameter(
            torch.empty(c.context_length, c.width))
        self.transformer = _Transformer(c.width, c.heads, c.layers,
                                        c.lora_rank, c.ln_eps, dtype)
        self.ln_final = LayerNorm(c.width, c.ln_eps)
        self.text_projection = nn.Parameter(
            torch.empty(c.width, c.output_dim))

    def forward(self, token_ids):
        """token_ids: (B, N) int, N <= context_length (the EOT is the highest
        id of a CLIP-BPE row)."""
        dt = self.dtype
        n = token_ids.shape[1]
        x = (self.token_embedding(token_ids).to(dt)
             + self.positional_embedding[:n].to(dt))
        x = self.transformer(x, causal_mask(n, token_ids.device))
        rows = torch.arange(x.shape[0], device=x.device)
        # torch.argmax, as jnp.argmax, takes the first maximum on every
        # device; LN is per token: picking the EOT row first equals
        # LN-then-pick
        pooled = self.ln_final(x[rows, token_ids.argmax(dim=-1)])
        return pooled.to(dt) @ self.text_projection.to(dt)


class OpenClipTextAdapter(nn.Module):
    """The text tower behind MultiModalCLIP's language-encoder signature
    (JAX `OpenClipTextAdapter`, :226-239): `attention_mask` and
    `token_type_ids` are taken and ignored (CLIP text is causal with EOT
    pooling), and so is `row_seeds`, which `MultiModalCLIP.encode_language`
    always passes: the tower has no dropout."""

    def __init__(self, cfg: OpenClipTextConfig = OpenClipTextConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.text = OpenClipTextTower(cfg, dtype)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                row_seeds=None):
        return self.text(input_ids)
