"""Card-only tests of the port's CUDA kernels against their plain PyTorch
versions. They skip without a CUDA device. This file imports neither JAX nor
the JAX package, so it also runs on a machine without them:

    python3 -m pytest -q -p no:cacheprovider --noconftest -m gpu \\
        tests/test_torch_gpu.py

Tolerances: attention fp32 atol 1e-5 (fp32 sums in another order), bf16
atol 2e-2 (one bf16 ulp at |x| ~ 1 is 7.8e-3, and p is rounded to bf16
before P.V on both sides); top-k values atol 1e-5 on unit vectors.
"""

import pytest
import torch

from bioscan_clip_tpu_torch.ops import attention, topk

pytestmark = pytest.mark.gpu


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_attention_kernels_match_plain(gen, dtype, tol):
    d = 768
    qkv = torch.randn(8, 197, 3 * d, device="cuda", generator=gen).to(dtype)
    before = attention.mha_packed.launches
    out = attention.mha_packed(qkv, 12)
    assert attention.mha_packed.launches == before + 1
    ref = attention.mha_reference(qkv[..., :d], qkv[..., d : 2 * d],
                                  qkv[..., 2 * d :], 12)
    assert (out.float() - ref.float()).abs().max().item() <= tol

    q, k, v = (torch.randn(8, 20, 512, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    bias = torch.zeros(8, 20, device="cuda")
    bias[:, 15:] = -1e9
    for b in (None, bias):
        out = attention.mha(q, k, v, 8, bias=b)
        ref = attention.mha_reference(q, k, v, 8, bias=b)
        assert (out.float() - ref.float()).abs().max().item() <= tol


def test_attention_wrapper_rejects_what_the_kernel_cannot_take(gen):
    x = torch.randn(2, 10, 3 * 48, device="cuda", generator=gen)
    with pytest.raises(ValueError, match="head dim"):
        attention.mha_packed(x, 3)  # head dim 16
    q = torch.randn(2, 10, 64, device="cuda", generator=gen)
    with pytest.raises(TypeError):
        attention.mha(q.half(), q.half(), q.half(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        attention.mha(q.transpose(0, 1), q.transpose(0, 1),
                      q.transpose(0, 1), 2)


def test_topk_kernel_matches_plain(gen):
    keys = torch.randn(100_000, 768, device="cuda", generator=gen)
    keys /= keys.norm(dim=1, keepdim=True)
    q = keys[:37] + 0.01 * torch.randn(37, 768, device="cuda", generator=gen)
    for k in (1, 5, 20):
        v, i = topk.topk(q, keys, 99_001, k)
        rv, ri = topk.topk_reference(q, keys, 99_001, k)
        assert (v - rv).abs().max().item() <= 1e-5
        assert (i[:, 0] == ri[:, 0]).all()
        assert (i < 99_001).all()
    with pytest.raises(ValueError):
        topk.topk(q, keys, 99_001, topk.MAX_K + 1)
