"""Classification-head variants for supervised fine-tuning.

Counterpart of bioscan_clip_tpu/models/heads.py:
- `EncoderWithHead`: an encoder, then one Linear (`new_linear_layer`);
  `get_feature` returns the encoder's raw output;
- `ClassificationHeadMLP`: hidden -> hidden -> n_classes with ReLU, then a
  softmax in fp32 (the reference trains cross-entropy on these
  probabilities);
- `CLIPWithClassificationHead`: the CLIP towers' normalized embeddings plus
  the head's output over the image embedding.
A Flax Dense infers its input width; here `input_dim` is given (the
encoder's output width, 768 for the CLIP embeddings).
"""

from __future__ import annotations

import torch
from torch import nn

from bioscan_clip_tpu_torch.models.common import dense, l2_normalize


class EncoderWithHead(nn.Module):
    def __init__(self, encoder: nn.Module, input_dim: int, num_classes: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder = encoder
        self.new_linear_layer = nn.Linear(input_dim, num_classes)

    def get_feature(self, x):
        return self.encoder(x)

    def forward(self, x, **kw):
        """`kw` goes to the encoder (a BERT tower's `row_seeds`)."""
        return dense(self.new_linear_layer, self.encoder(x, **kw),
                     self.dtype)


class ClassificationHeadMLP(nn.Module):
    def __init__(self, input_dim: int = 768, hidden_dim: int = 768,
                 num_classes: int = 1024, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(input_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, hidden_dim)
        self.fc3 = nn.Linear(hidden_dim, num_classes)

    def forward(self, x):
        dt = self.dtype
        x = torch.relu(dense(self.fc1, x, dt))
        x = torch.relu(dense(self.fc2, x, dt))
        return torch.softmax(dense(self.fc3, x, dt).float(), dim=-1)


class CLIPWithClassificationHead(nn.Module):
    """SimpleCLIPWithClassificationHead: (image, dna, language, head
    output), absent modalities None."""

    def __init__(self, image_encoder=None, dna_encoder=None,
                 language_encoder=None, input_dim: int = 768,
                 hidden_dim: int = 768, num_classes: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.image_encoder = image_encoder
        self.dna_encoder = dna_encoder
        self.language_encoder = language_encoder
        self.classification_head = ClassificationHeadMLP(
            input_dim, hidden_dim, num_classes, dtype)

    def forward(self, image_input=None, dna_input=None, language_input=None):
        image = dna = language = None
        if image_input is not None and self.image_encoder is not None:
            image = l2_normalize(self.image_encoder(image_input).float())
        if dna_input is not None and self.dna_encoder is not None:
            dna = l2_normalize(self.dna_encoder(dna_input).float())
        if language_input is not None and self.language_encoder is not None:
            language = l2_normalize(self.language_encoder(
                language_input["input_ids"],
                attention_mask=language_input.get("attention_mask"),
                token_type_ids=language_input.get("token_type_ids"),
            ).float())
        return image, dna, language, self.classification_head(image)
