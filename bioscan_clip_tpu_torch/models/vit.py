"""ViT-B/16 (timm geometry) with optional LoRA(q, v) adapters, eval only.

Counterpart of bioscan_clip_tpu/models/vit.py:39-198: 16x16 patch embed,
prepended CLS token, learned position embedding, pre-LN blocks (fused qkv
with bias, exact-erf GELU, LN eps 1e-6), final LN on the CLS token, and a
linear head. Parameter names are the reference's (`patch_embed.proj`,
`blocks.{i}.attn.qkv[.qkv]`, ...), so `state_dict()` keys match a released
checkpoint under `image_encoder.lora_vit.`.

Numerics follow the Flax module: the residual stream and matmuls run in the
compute dtype, LayerNorms in their own dtype (fp32 by default), attention
through `ops.attention.mha_packed` (fp32 softmax).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from bioscan_clip_tpu_torch.models.common import LayerNorm, dense, gelu_exact
from bioscan_clip_tpu_torch.models.lora import LoRAQKV, project
from bioscan_clip_tpu_torch.ops.attention import mha_packed


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    num_classes: int = 768
    lora_rank: int = 4
    ln_eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.patch = cfg.patch_size
        # Conv2d only holds the (O, 3, p, p) weight; the forward is a patch
        # reshape plus a matmul, so fp32 never goes through cuDNN's TF32
        # convolutions.
        self.proj = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                              stride=cfg.patch_size)

    def forward(self, images, dtype):
        b, h, w, c = images.shape  # NHWC, as the JAX model takes it
        p = self.patch
        x = images.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, (h // p) * (w // p), p * p * c)
        weight = self.proj.weight.permute(0, 2, 3, 1).reshape(
            self.proj.out_channels, -1
        )
        return torch.nn.functional.linear(
            x.to(dtype), weight.to(dtype), self.proj.bias.to(dtype)
        )


class _Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.qkv = (LoRAQKV(d, cfg.lora_rank) if cfg.lora_rank > 0
                    else nn.Linear(d, 3 * d))
        self.proj = nn.Linear(d, d)


class _Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.fc1 = nn.Linear(d, cfg.mlp_ratio * d)
        self.fc2 = nn.Linear(cfg.mlp_ratio * d, d)


class ViTBlock(nn.Module):
    """One pre-LN block (JAX vit.py:67-130)."""

    def __init__(self, cfg: ViTConfig, dtype, ln_dtype):
        super().__init__()
        d = cfg.hidden_size
        self.dtype = dtype
        self.norm1 = LayerNorm(d, cfg.ln_eps, ln_dtype)
        self.attn = _Attention(cfg)
        self.norm2 = LayerNorm(d, cfg.ln_eps, ln_dtype)
        self.mlp = _Mlp(cfg)

    def forward(self, x):
        dt = self.dtype
        qkv = project(self.attn.qkv, self.norm1(x), dt)
        y = mha_packed(qkv, self.attn.heads)
        x = x + dense(self.attn.proj, y, dt)
        y = gelu_exact(dense(self.mlp.fc1, self.norm2(x), dt))
        return x + dense(self.mlp.fc2, y, dt)


class ViT(nn.Module):
    """timm-geometry ViT with CLS pooling and a linear head."""

    def __init__(self, cfg: ViTConfig = ViTConfig(),
                 dtype: torch.dtype = torch.float32,
                 ln_dtype: torch.dtype = torch.float32):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.dtype = dtype
        self.patch_embed = _PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, d))
        self.blocks = nn.ModuleList(
            ViTBlock(cfg, dtype, ln_dtype) for _ in range(cfg.num_layers)
        )
        self.norm = LayerNorm(d, cfg.ln_eps, ln_dtype)
        self.head = (nn.Linear(d, cfg.num_classes) if cfg.num_classes > 0
                     else None)

    def forward(self, images):
        """images: (B, H, W, 3) float, already preprocessed (NHWC)."""
        dt = self.dtype
        x = self.patch_embed(images, dt)
        cls = self.cls_token.to(dt).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        for blk in self.blocks:
            x = blk(x)
        # LN is per token: slicing CLS first equals LN-then-slice
        x = self.norm(x[:, 0])
        if self.head is not None:
            x = dense(self.head, x, dt)
        return x


class ViTImageEncoder(nn.Module):
    """The reference's `LoRA_ViT_timm` wrapper: the ViT under `lora_vit`."""

    def __init__(self, cfg: ViTConfig = ViTConfig(),
                 dtype: torch.dtype = torch.float32,
                 ln_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lora_vit = ViT(cfg, dtype, ln_dtype)

    def forward(self, images):
        return self.lora_vit(images)
