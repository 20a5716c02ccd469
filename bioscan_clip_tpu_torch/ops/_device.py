"""The card's SM count, which the kernels' launch plans size their grids by."""

from __future__ import annotations

import functools

import torch

H100_SMS = 132  # an H100 SXM's SMs: the plans' default


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The SMs of CUDA device `device_index`."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count
