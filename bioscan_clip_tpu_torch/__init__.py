"""PyTorch/CUDA port of bioscan_clip_tpu for NVIDIA Hopper.

Module names mirror the JAX package (`bioscan_clip_tpu`), which stays the
reference: each module here names its JAX counterpart. The port imports
torch and never JAX or the JAX package. Its kernels are CUDA C++ for
sm_90a under `csrc/`, built at first use (`ops/_build.py`).
"""

__version__ = "0.1.0"
