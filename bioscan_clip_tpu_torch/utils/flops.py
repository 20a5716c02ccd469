"""Analytic FLOPs per sample and MFU for the flagship towers on the H100.

A copy of bioscan_clip_tpu/utils/flops.py with the card's peaks in place of
the TPU's (`PEAK_TFLOPS` :30-34): every count function is unchanged. FLOPs
are counted from the tower geometry, matmul terms only (LayerNorm, softmax
and GELU are bandwidth, not FLOPs); MFU is the achieved matmul FLOP/s over
the card's peak for the dtype.

Conventions:
  - one fused multiply-add = 2 FLOPs;
  - forward cost counts every matmul the forward executes;
  - backward-full = 2x forward (dX and dW products);
  - backward-LoRA = 1x forward + the rank-r adapter dW terms (frozen-weight
    dW products never run; the dX chain through the frozen weights does);
  - GradCache = stage-1 forward + stage-3 forward + backward. Recomputation
    (remat) is not model work and is not counted.

Reference geometry: ViT-B/16 at 224^2 -> 197 tokens (image_encoder.py),
BarcodeBERT = BERT-base at 133 DNA tokens (dna_encoder.py:25-35),
BERT-small = 4L/512h at 20 text tokens (language_encoder.py,
generate_hdf5_file_5m.py:281-285).
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM data sheet, dense (TFLOP/s): tensor-core bf16 and fp32
# outside the tensor cores, at the card's full 700 W limit.
PEAK_TFLOPS = {
    "h100_bf16": 989.0,
    "h100_fp32": 67.0,
}
HBM_GBPS = 3350.0  # H100 SXM HBM3


def transformer_layer_flops(seq: int, hidden: int, inter: int,
                            qkv_dims: int = 3) -> float:
    """Matmul FLOPs of one post-LN transformer encoder layer, batch 1.

    qkv+out projections: (3+1) * 2*s*h^2; attention scores + attn@V:
    2 * 2*s^2*h; MLP up+down: 2 * 2*s*h*inter."""
    proj = (qkv_dims + 1) * 2 * seq * hidden * hidden
    attn = 2 * 2 * seq * seq * hidden
    mlp = 2 * 2 * seq * hidden * inter
    return float(proj + attn + mlp)


def lora_layer_flops(seq: int, hidden: int, rank: int,
                     n_adapted: int = 2) -> float:
    """Rank-r LoRA adapters on q and v (2 sites/layer): x@A (h->r) and
    (xA)@B (r->h), forward."""
    return float(n_adapted * 2 * seq * (hidden * rank + rank * hidden))


@dataclass
class TowerFlops:
    name: str
    fwd: float          # forward FLOPs per sample
    lora_fwd: float     # of which LoRA adapter terms

    def train_plain(self) -> float:
        """Full fwd + LoRA backward (dX chain 1x fwd + adapter dW ~= 2x
        adapter fwd)."""
        return 2 * self.fwd + 2 * self.lora_fwd

    def train_full(self) -> float:
        """disable_lora: fwd + full backward. The adapters don't run in
        this mode, so their terms are excluded from fwd."""
        return 3 * (self.fwd - self.lora_fwd)

    def train_gradcache(self) -> float:
        """Stage 1 fwd + stage 3 (fwd + LoRA backward)."""
        return self.fwd + self.train_plain()


def vit_b16(seq: int = 197, hidden: int = 768, layers: int = 12,
            inter: int = 3072, lora_rank: int = 4,
            num_classes: int = 768) -> TowerFlops:
    patch = 2 * (seq - 1) * (16 * 16 * 3) * hidden  # patchify conv as matmul
    body = layers * transformer_layer_flops(seq, hidden, inter)
    head = 2 * hidden * num_classes
    lora = layers * lora_layer_flops(seq, hidden, lora_rank)
    return TowerFlops("vit_b16", patch + body + head + lora, lora)


def barcode_bert(seq: int = 133, hidden: int = 768, layers: int = 12,
                 inter: int = 3072, lora_rank: int = 4,
                 out: int = 768) -> TowerFlops:
    body = layers * transformer_layer_flops(seq, hidden, inter)
    # replaced MLM decoder: Linear(768 -> 768) applied per token, then
    # softmax-of-logits mean pooling (dna_encoder.py:93-105)
    head = 2 * seq * hidden * out
    lora = layers * lora_layer_flops(seq, hidden, lora_rank)
    return TowerFlops("barcode_bert", body + head + lora, lora)


def bert_small(seq: int = 20, hidden: int = 512, layers: int = 4,
               inter: int = 2048, lora_rank: int = 4,
               out: int = 768) -> TowerFlops:
    body = layers * transformer_layer_flops(seq, hidden, inter)
    head = 2 * hidden * out  # proj(mean tokens) (language_encoder.py:87-89)
    lora = layers * lora_layer_flops(seq, hidden, lora_rank)
    return TowerFlops("bert_small", body + head + lora, lora)


def flagship_towers() -> dict:
    return {t.name: t for t in (vit_b16(), barcode_bert(), bert_small())}


def flagship_fwd_flops_per_sample() -> float:
    """Tri-modal extraction: all three towers forward once per sample."""
    return sum(t.fwd for t in flagship_towers().values())


def flagship_train_flops_per_sample(mode: str = "plain") -> float:
    """mode: plain (1 fwd + LoRA bwd) | gradcache (2 fwd + LoRA bwd) |
    full (disable_lora)."""
    towers = flagship_towers().values()
    if mode == "plain":
        return sum(t.train_plain() for t in towers)
    if mode == "gradcache":
        return sum(t.train_gradcache() for t in towers)
    if mode == "full":
        return sum(t.train_full() for t in towers)
    raise ValueError(mode)


def mfu(samples_per_s: float, flops_per_sample: float,
        chip: str = "h100_bf16") -> float:
    """Model-FLOPs-utilization: achieved matmul FLOP/s over peak."""
    return samples_per_s * flops_per_sample / (PEAK_TFLOPS[chip] * 1e12)


def retrieval_roofline(n_keys: int, dim: int = 768, bytes_per_elem: int = 4,
                       q_block: int = 256, hbm_gbps: float = HBM_GBPS,
                       chip: str = "h100_bf16") -> dict:
    """Per-(q_block x n_keys) search pass: memory bytes (keys stream once
    per query block), matmul FLOPs, and the bound times."""
    hbm_bytes = n_keys * dim * bytes_per_elem
    flops = 2.0 * q_block * n_keys * dim
    return {
        "hbm_bytes": hbm_bytes,
        "flops": flops,
        "t_hbm_s": hbm_bytes / (hbm_gbps * 1e9),
        "t_mxu_s": flops / (PEAK_TFLOPS[chip] * 1e12),
    }


if __name__ == "__main__":
    import json

    t = flagship_towers()
    print(json.dumps({
        **{k: {"fwd_gflops": round(v.fwd / 1e9, 3),
               "train_plain_gflops": round(v.train_plain() / 1e9, 3),
               "train_gradcache_gflops": round(v.train_gradcache() / 1e9, 3)}
           for k, v in t.items()},
        "tri_modal_fwd_gflops": round(flagship_fwd_flops_per_sample() / 1e9, 3),
        "tri_modal_train_plain_gflops": round(
            flagship_train_flops_per_sample("plain") / 1e9, 3),
        "tri_modal_train_gradcache_gflops": round(
            flagship_train_flops_per_sample("gradcache") / 1e9, 3),
    }, indent=2))
