"""BERT encoder (HF geometry) and the two BIOSCAN-CLIP heads on it.

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
checkpoints.

Train mode applies hidden and attention dropout (0.1 each by default) in the
JAX package's row-keyed mode, the port's only one: the towers take
`row_seeds`, a (B,) uint32 seed per row, and every mask follows from it
(JAX bert.py:84-291): the embeddings drop on site 0 of the raw salt; each
layer runs on the advanced salt, with attention probabilities on site 1 (the
(B,) seed of K2d), the attention output on site 2 and the MLP output on
site 3. Train mode without `row_seeds` raises.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from bioscan_clip_tpu_torch.models.common import (
    LayerNorm,
    check_remat_policy,
    dense,
    gelu_exact,
    ps_dropout,
    remat_tag,
    row_salt_advance,
    run_layer,
    site_seed,
)
from bioscan_clip_tpu_torch.models.lora import LoRALinear, project
from bioscan_clip_tpu_torch.ops.attention import mha, u32

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
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    ln_eps: float = 1e-12
    # per-layer remat and what it saves (models/common.py)
    remat: bool = False
    remat_policy: str = "full"


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
        self.hidden_dropout = c.hidden_dropout
        self.attention_dropout = c.attention_dropout
        self.dtype = dtype
        self.attention = _Attention(c, ln_dtype)
        self.intermediate = _Intermediate(c)
        self.output = _DenseLN(c.intermediate_size, c.hidden_size, c.ln_eps,
                               ln_dtype)

    def forward(self, x, bias, row_salt=None):
        """`row_salt`: this layer's (B,) dropout salt in train mode, None in
        eval mode (no dropout)."""
        dt = self.dtype
        sa = self.attention.self
        q = project(sa.query, x, dt)
        k = dense(sa.key, x, dt)
        v = project(sa.value, x, dt)
        if row_salt is not None and self.attention_dropout > 0:
            y = mha(q, k, v, self.heads, bias=bias,
                    dropout_rate=self.attention_dropout,
                    dropout_seed=site_seed(row_salt, 1))
        else:
            y = mha(q, k, v, self.heads, bias=bias)
        out = self.attention.output
        y = ps_dropout(dense(out.dense, y, dt), self.hidden_dropout, row_salt,
                       2)
        x = out.LayerNorm(x + y).to(dt)
        with remat_tag("mlp_pre"):
            y = dense(self.intermediate.dense, x, dt)
        y = ps_dropout(dense(self.output.dense, gelu_exact(y), dt),
                       self.hidden_dropout,
                       row_salt, 3)
        return self.output.LayerNorm(x + y).to(dt)


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
        check_remat_policy(cfg.remat_policy)
        self.embeddings = _Embeddings(cfg, ln_dtype)
        self.encoder = _Layers(cfg, dtype, ln_dtype)
        self.train(False)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                row_seeds=None):
        """`row_seeds`: (B,) uint32 per-row dropout seeds, required in train
        mode and ignored in eval mode."""
        dt = self.dtype
        row_salt = None
        if self.training:
            if row_seeds is None:
                raise ValueError(
                    "a BERT tower in train mode needs row_seeds: the port "
                    "has only the row-keyed dropout mode"
                )
            row_salt = u32(row_seeds, input_ids.device)
        e = self.embeddings
        n = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = torch.arange(n, device=input_ids.device)[None, :]
        x = (e.word_embeddings(input_ids).to(dt)
             + e.position_embeddings(pos).to(dt)
             + e.token_type_embeddings(token_type_ids).to(dt))
        x = ps_dropout(e.LayerNorm(x).to(dt), self.cfg.hidden_dropout,
                       row_salt, 0)
        bias = None
        if attention_mask is not None:
            bias = torch.where(attention_mask > 0, 0.0, NEG_INF).to(
                device=x.device, dtype=torch.float32
            ).contiguous()
        for layer in self.encoder.layer:
            # the embeddings used the raw salt; every layer advances first
            if row_salt is not None:
                row_salt = row_salt_advance(row_salt)
            x = run_layer(layer, x, bias, row_salt, remat=self.cfg.remat,
                          policy=self.cfg.remat_policy)
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

    def forward(self, input_ids, row_seeds=None):
        dt = self.dtype
        m = self.lora_barcode_bert
        # no attention mask (JAX bert.py:311)
        x = m.bert(input_ids, row_seeds=row_seeds)
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

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                row_seeds=None):
        x = self.lora_bert(input_ids, attention_mask=attention_mask,
                           token_type_ids=token_type_ids,
                           row_seeds=row_seeds)
        return dense(self.proj, x.mean(dim=1), self.dtype)
