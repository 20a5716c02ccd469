"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: `None`
means `cuda`, and a missing CUDA device is an error, never a silent CPU run.
The compute dtype follows the device (bf16 on the card, fp32 on the CPU, as
the JAX serving CLI picks bf16 on the TPU); parameters stay fp32.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev


def compute_dtype(device) -> torch.dtype:
    """bf16 on the card, fp32 on the CPU."""
    return (
        torch.bfloat16 if torch.device(device).type == "cuda"
        else torch.float32
    )
