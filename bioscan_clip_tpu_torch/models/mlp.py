"""MLP encoders for pre-extracted-feature inputs, and the identity encoder.

Counterpart of bioscan_clip_tpu/models/mlp.py: Linear(in -> hidden), ReLU,
Linear(hidden -> hidden), ReLU, Linear(hidden -> out), each in the compute
dtype. A Flax Dense infers its input width at init; a torch Linear is given
it: the JAX package initializes the image MLP from 512-wide and the DNA MLP
from 768-wide features (`init_clip_params`, clip.py:248, :253), and so do
`MLPVersionCLIP`'s defaults here.
"""

from __future__ import annotations

import torch
from torch import nn

from bioscan_clip_tpu_torch.models.common import dense, l2_normalize


class MLPEncoder(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int = 512,
                 output_dim: int = 512, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(input_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, hidden_dim)
        self.fc3 = nn.Linear(hidden_dim, output_dim)

    def forward(self, x):
        dt = self.dtype
        x = torch.relu(dense(self.fc1, x, dt))
        x = torch.relu(dense(self.fc2, x, dt))
        return dense(self.fc3, x, dt)


class MLPVersionCLIP(nn.Module):
    """Two-tower MLP CLIP over pre-extracted features (JAX mlp.py:27-52):
    returns the L2-normalized fp32 (image, dna) embeddings."""

    def __init__(self, image_input_dim: int = 512, dna_input_dim: int = 768,
                 hidden_dim: int = 512, output_dim: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.image_feature_encoder = MLPEncoder(image_input_dim, hidden_dim,
                                                output_dim, dtype)
        self.dna_feature_encoder = MLPEncoder(dna_input_dim, hidden_dim,
                                              output_dim, dtype)

    def forward(self, image_feature, dna_feature):
        img = self.image_feature_encoder(image_feature)
        dna = self.dna_feature_encoder(dna_feature)
        return l2_normalize(img.float()), l2_normalize(dna.float())


class IdentityEncoder(nn.Module):
    """Pre-extracted features pass through unchanged (JAX mlp.py:55-61)."""

    def forward(self, x):
        return x
