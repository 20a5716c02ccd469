"""The benchmark's yardstick of work: FLOPs per sample, the card's published
peaks, and the roofline bounds of the kernels that per-layer metrics read.

The count functions down to `mfu` are a frozen copy of the port's
`utils/flops.py` (matmul FLOPs only, one multiply-add = 2 FLOPs; the LoRA
backward counted as it runs: the dX chain through the frozen weights plus
the adapters' dW; no recompute). Added here: OpenCLIP ViT-L/14's forward,
the exact search's 2 * N * D a query, and the bounds below.

A roofline bound counts the work, not the implementation: every input read
once and every output written once, and the products the mathematics needs,
once. The least time is the larger of bytes / HBM_BYTES_PER_S and FLOPs /
the peak of the precision. So no kernel can read above 100% by doing less
than that work.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM data sheet, dense, at the card's full 700 W limit
PEAK_TFLOPS = {"h100_bf16": 989.0, "h100_fp32": 67.0}
HBM_GBPS = 3350.0
PEAK_BF16_FLOPS = PEAK_TFLOPS["h100_bf16"] * 1e12
HBM_BYTES_PER_S = HBM_GBPS * 1e9


def transformer_layer_flops(seq: int, hidden: int, inter: int,
                            qkv_dims: int = 3) -> float:
    """Matmul FLOPs of one transformer encoder layer, batch 1:
    (qkv_dims + 1) * 2*s*h^2 + 2 * 2*s^2*h + 2 * 2*s*h*inter."""
    proj = (qkv_dims + 1) * 2 * seq * hidden * hidden
    attn = 2 * 2 * seq * seq * hidden
    mlp = 2 * 2 * seq * hidden * inter
    return float(proj + attn + mlp)


def lora_layer_flops(seq: int, hidden: int, rank: int,
                     n_adapted: int = 2) -> float:
    return float(n_adapted * 2 * seq * (hidden * rank + rank * hidden))


@dataclass
class TowerFlops:
    name: str
    fwd: float
    lora_fwd: float

    def train_plain(self) -> float:
        return 2 * self.fwd + 2 * self.lora_fwd


def vit_b16(seq: int = 197, hidden: int = 768, layers: int = 12,
            inter: int = 3072, lora_rank: int = 4,
            num_classes: int = 768, patch_size: int = 16) -> TowerFlops:
    patch = 2 * (seq - 1) * (patch_size * patch_size * 3) * hidden
    body = layers * transformer_layer_flops(seq, hidden, inter)
    head = 2 * hidden * num_classes
    lora = layers * lora_layer_flops(seq, hidden, lora_rank)
    return TowerFlops("vit_b16", patch + body + head + lora, lora)


def barcode_bert(seq: int = 133, hidden: int = 768, layers: int = 12,
                 inter: int = 3072, lora_rank: int = 4,
                 out: int = 768) -> TowerFlops:
    body = layers * transformer_layer_flops(seq, hidden, inter)
    head = 2 * seq * hidden * out
    lora = layers * lora_layer_flops(seq, hidden, lora_rank)
    return TowerFlops("barcode_bert", body + head + lora, lora)


def bert_small(seq: int = 20, hidden: int = 512, layers: int = 4,
               inter: int = 2048, lora_rank: int = 4,
               out: int = 768) -> TowerFlops:
    body = layers * transformer_layer_flops(seq, hidden, inter)
    head = 2 * hidden * out
    lora = layers * lora_layer_flops(seq, hidden, lora_rank)
    return TowerFlops("bert_small", body + head + lora, lora)


def flagship_train_flops_per_sample() -> float:
    """The plain step's model FLOPs a sample (118.47 GFLOP)."""
    return sum(t.train_plain() for t in (vit_b16(), barcode_bert(),
                                         bert_small()))


def tower_tokens(g: dict) -> int:
    """The tokens of an image tower: its patches and the class token."""
    return (g["image_size"] // g["patch"]) ** 2 + 1


# the train step's count of each tower a configuration's geometry names
# (its "tower"), at `seq` tokens
TRAIN_TOWERS = {
    "vit": lambda g, seq: vit_b16(seq, g["hidden"], g["layers"], g["mlp"],
                                  g["lora_rank"], g["output_dim"],
                                  g["patch"]),
    "barcode_bert": lambda g, seq: barcode_bert(
        seq, g["hidden"], g["layers"], g["intermediate"], g["lora_rank"],
        g["output_dim"]),
    "bert_small": lambda g, seq: bert_small(
        seq, g["hidden"], g["layers"], g["intermediate"], g["lora_rank"],
        g["output_dim"]),
}


def train_flops(g: dict, seq: int) -> float:
    """The plain train step's model FLOPs a sample in the tower `g`."""
    if g["tower"] not in TRAIN_TOWERS:
        raise ValueError(f"no train FLOP count for the tower {g['tower']!r}")
    return TRAIN_TOWERS[g["tower"]](g, seq).train_plain()


def mfu(samples_per_s: float, flops_per_sample: float,
        chip: str = "h100_bf16") -> float:
    return samples_per_s * flops_per_sample / (PEAK_TFLOPS[chip] * 1e12)


# --- added: OpenCLIP ViT-L/14 and the exact search -------------------------

def openclip_visual_fwd(image_size: int = 224, patch: int = 14,
                        hidden: int = 1024, layers: int = 24,
                        inter: int = 4096, output_dim: int = 768) -> float:
    """ViT-L/14's forward FLOPs an image, LoRA merged (161.96 GFLOP)."""
    seq = (image_size // patch) ** 2 + 1
    conv = 2 * (seq - 1) * (patch * patch * 3) * hidden
    body = layers * transformer_layer_flops(seq, hidden, inter)
    return float(conv + body + 2 * hidden * output_dim)


# the forward's count of each tower a served configuration can embed with
FORWARD_TOWERS = {
    "openclip_visual": lambda g: openclip_visual_fwd(
        g["image_size"], g["patch"], g["hidden"], g["layers"], g["mlp"],
        g["output_dim"]),
}


def forward_flops(g: dict) -> float:
    """The forward's model FLOPs an input of the tower `g`."""
    if g["tower"] not in FORWARD_TOWERS:
        raise ValueError(f"no forward FLOP count for the tower "
                         f"{g['tower']!r}")
    return FORWARD_TOWERS[g["tower"]](g)


def search_flops(n_keys: int, dim: int) -> float:
    """The exact inner-product search's FLOPs a query: 2 * N * D."""
    return 2.0 * n_keys * dim


def bound_s(n_bytes: float, flops: float,
            peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time of a piece of work on the card."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / peak_flops)


def attention_fwd_bound_s(b: int, n: int, heads: int, hd: int,
                          elem: int = 2, bias: bool = False) -> float:
    """One attention forward: q, k, v read and o written once (and a (B, N)
    fp32 key bias), 4*B*h*N^2*hd FLOPs (QK^T and PV)."""
    d = heads * hd
    n_bytes = 4 * b * n * d * elem + (4 * b * n if bias else 0)
    return bound_s(n_bytes, 4.0 * b * heads * n * n * hd)


def attention_bwd_bound_s(b: int, n: int, heads: int, hd: int,
                          elem: int = 2, bias: bool = False) -> float:
    """One attention backward: q, k, v, dO read and dq, dk, dv written once,
    8*B*h*N^2*hd FLOPs (dV, dP, dQ, dK; S is the forward's, not counted
    again)."""
    d = heads * hd
    n_bytes = 7 * b * n * d * elem + (4 * b * n if bias else 0)
    return bound_s(n_bytes, 8.0 * b * heads * n * n * hd)


def topk_bound_s(bq: int, n_keys: int, dim: int, k: int) -> float:
    """One exact top-k over fp32 keys: the keys and the fp32 queries read
    once, k values and indices written a query, 2*Bq*N*D FLOPs at bf16's
    peak whatever precision branch runs."""
    n_bytes = 4 * (n_keys + bq) * dim + bq * k * (4 + 8)
    return bound_s(n_bytes, 2.0 * bq * n_keys * dim)
