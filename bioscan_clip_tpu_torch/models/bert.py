"""BERT encoder (HF geometry) and the two BIOSCAN-CLIP heads on it, eval only.

Counterpart of bioscan_clip_tpu/models/bert.py:47-358:
- `BarcodeBertDnaEncoder`: BarcodeBERT (vocab 1027, 12L/768/12 heads), no
  attention mask; the MLM transform head, then the replaced decoder, then a
  softmax over the output features in fp32 and a mean over tokens.
- `BertTextEncoder`: BERT-small (4L/512/8 heads), key-padding bias from the
  attention mask, an unmasked token mean, then `proj`.
Post-LN residuals with the LN in its own dtype (fp32 by default) and the
result cast back to the compute dtype (:181-186); attention through
`ops.attention.mha` with a (B, N) fp32 bias of 0 / -1e9 (:266-270).
Parameter names are HF's, so `state_dict()` keys match the reference
checkpoints. Dropout belongs to training, which comes in a later slice:
switching these modules to train mode raises.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from bioscan_clip_tpu_torch.models.common import LayerNorm, dense, gelu_exact
from bioscan_clip_tpu_torch.models.lora import LoRALinear, project
from bioscan_clip_tpu_torch.ops.attention import mha

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    lora_rank: int = 4
    ln_eps: float = 1e-12


BARCODE_BERT_CONFIG = BertConfig(vocab_size=1027)
BERT_SMALL_CONFIG = BertConfig(
    vocab_size=30522, hidden_size=512, num_layers=4, num_heads=8,
    intermediate_size=2048,
)


class _Embeddings(nn.Module):
    def __init__(self, c: BertConfig, ln_dtype):
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings,
                                                c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size,
                                                  c.hidden_size)
        self.LayerNorm = LayerNorm(c.hidden_size, c.ln_eps, ln_dtype)


class _SelfAttention(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        d, r = c.hidden_size, c.lora_rank
        self.query = LoRALinear(d, r) if r > 0 else nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = LoRALinear(d, r) if r > 0 else nn.Linear(d, d)


class _DenseLN(nn.Module):
    """HF's `BertSelfOutput` / `BertOutput`: dense + LayerNorm."""

    def __init__(self, d_in: int, d_out: int, eps: float, ln_dtype):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.LayerNorm = LayerNorm(d_out, eps, ln_dtype)


class _Attention(nn.Module):
    def __init__(self, c: BertConfig, ln_dtype):
        super().__init__()
        self.self = _SelfAttention(c)
        self.output = _DenseLN(c.hidden_size, c.hidden_size, c.ln_eps,
                               ln_dtype)


class _Intermediate(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.dense = nn.Linear(c.hidden_size, c.intermediate_size)


class BertLayer(nn.Module):
    """One post-LN layer with LoRA on query and value (JAX bert.py:76-210)."""

    def __init__(self, c: BertConfig, dtype, ln_dtype):
        super().__init__()
        self.heads = c.num_heads
        self.dtype = dtype
        self.attention = _Attention(c, ln_dtype)
        self.intermediate = _Intermediate(c)
        self.output = _DenseLN(c.intermediate_size, c.hidden_size, c.ln_eps,
                               ln_dtype)

    def forward(self, x, bias):
        dt = self.dtype
        sa = self.attention.self
        q = project(sa.query, x, dt)
        k = dense(sa.key, x, dt)
        v = project(sa.value, x, dt)
        y = mha(q, k, v, self.heads, bias=bias)
        out = self.attention.output
        x = out.LayerNorm(x + dense(out.dense, y, dt)).to(dt)
        y = gelu_exact(dense(self.intermediate.dense, x, dt))
        return self.output.LayerNorm(x + dense(self.output.dense, y, dt)).to(dt)


class _Layers(nn.Module):
    def __init__(self, c: BertConfig, dtype, ln_dtype):
        super().__init__()
        self.layer = nn.ModuleList(
            BertLayer(c, dtype, ln_dtype) for _ in range(c.num_layers)
        )


class BertEncoder(nn.Module):
    """Embeddings + layers -> last_hidden_state (B, N, D) (HF BertModel
    without the pooler)."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32,
                 ln_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embeddings = _Embeddings(cfg, ln_dtype)
        self.encoder = _Layers(cfg, dtype, ln_dtype)
        super().train(False)

    def train(self, mode: bool = True):
        if mode:
            raise NotImplementedError(
                "the BERT towers are eval-only until the training slice "
                "(dropout, ROADMAP.md queue 1)"
            )
        return super().train(False)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        dt = self.dtype
        e = self.embeddings
        n = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = torch.arange(n, device=input_ids.device)[None, :]
        x = (e.word_embeddings(input_ids).to(dt)
             + e.position_embeddings(pos).to(dt)
             + e.token_type_embeddings(token_type_ids).to(dt))
        x = e.LayerNorm(x).to(dt)
        bias = None
        if attention_mask is not None:
            bias = torch.where(attention_mask > 0, 0.0, NEG_INF).to(
                device=x.device, dtype=torch.float32
            ).contiguous()
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x


class _PredictionTransform(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d, d)
        # always fp32 (JAX bert.py:318-320)
        self.LayerNorm = LayerNorm(d, eps, torch.float32)


class _Predictions(nn.Module):
    def __init__(self, d: int, out: int, eps: float):
        super().__init__()
        self.transform = _PredictionTransform(d, eps)
        self.decoder = nn.Linear(d, out)


class _ClsHead(nn.Module):
    def __init__(self, d: int, out: int, eps: float):
        super().__init__()
        self.predictions = _Predictions(d, out, eps)


class _BarcodeBert(nn.Module):
    """The reference's BertForMaskedLM with its decoder replaced."""

    def __init__(self, cfg: BertConfig, output_dim: int, dtype, ln_dtype):
        super().__init__()
        self.bert = BertEncoder(cfg, dtype, ln_dtype)
        self.cls = _ClsHead(cfg.hidden_size, output_dim, cfg.ln_eps)


class BarcodeBertDnaEncoder(nn.Module):
    """BarcodeBERT + MLM transform head + replaced decoder + softmax-mean
    pool (JAX bert.py:294-326), under the reference's `lora_barcode_bert`."""

    def __init__(self, cfg: BertConfig = BARCODE_BERT_CONFIG,
                 output_dim: int = 768, dtype: torch.dtype = torch.float32,
                 ln_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.lora_barcode_bert = _BarcodeBert(cfg, output_dim, dtype,
                                              ln_dtype)

    def forward(self, input_ids):
        dt = self.dtype
        m = self.lora_barcode_bert
        x = m.bert(input_ids)  # no attention mask (JAX bert.py:311)
        p = m.cls.predictions
        x = gelu_exact(dense(p.transform.dense, x, dt))
        x = p.transform.LayerNorm(x)
        x = dense(p.decoder, x, dt)
        # softmax over the output features, then a mean over tokens, in fp32
        return torch.softmax(x.float(), dim=-1).mean(dim=1)


class BertTextEncoder(nn.Module):
    """BERT-small + unmasked token mean + `proj` (JAX bert.py:329-358),
    under the reference's `lora_bert`."""

    def __init__(self, cfg: BertConfig = BERT_SMALL_CONFIG,
                 output_dim: int = 768, dtype: torch.dtype = torch.float32,
                 ln_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.lora_bert = BertEncoder(cfg, dtype, ln_dtype)
        self.proj = nn.Linear(cfg.hidden_size, output_dim)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        x = self.lora_bert(input_ids, attention_mask=attention_mask,
                           token_type_ids=token_type_ids)
        return dense(self.proj, x.mean(dim=1), self.dtype)
