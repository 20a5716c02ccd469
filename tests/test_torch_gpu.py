"""Card-only tests of the port's CUDA kernels against their plain PyTorch
versions. They skip without a CUDA device. This file imports neither JAX nor
the JAX package, so it also runs on a machine without them:

    python3 -m pytest -q -p no:cacheprovider --noconftest -m gpu \\
        tests/test_torch_gpu.py

Tolerances: attention fp32 atol 1e-5 (fp32 sums in another order), bf16
atol 2e-2 (one bf16 ulp at |x| ~ 1 is 7.8e-3, and p is rounded to bf16
before P.V on both sides), the masked forward (K1m) as K1; the attention
backward (K3, and K3m with the mask) the same, scaled by max(1, max |plain|)
per gradient; top-k values atol 1e-5 on unit vectors; int8 top-k (K5)
bit-equal to its plain version, values and indices (exact integer dots times
two scales in the same order, the same tie rule); the matmul-only control
(K6) int8 bit-equal, fp32 atol 1e-5 on unit vectors in both precisions (fp32
sums of 768 products in another order); K7 exact.
"""

import pytest
import torch

from bioscan_clip_tpu_torch.models.openclip import causal_mask
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


def _seeds(gen, b):
    return torch.randint(0, 2**32, (b,), device="cuda", generator=gen,
                         dtype=torch.int64)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_dropout_kernel_matches_plain(gen, dtype, tol):
    """K2d against the plain version with the same hash, for (B,) row seeds
    and one scalar seed; a mismatched mask element moves an output by
    ~p * |v| ~ 1e-2, so this also shows the masks equal on the card."""
    q, k, v = (torch.randn(6, 133, 768, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    bias = torch.zeros(6, 133, device="cuda")
    bias[:, 100:] = -1e9
    before = attention.mha_dropout.launches
    for seed in (_seeds(gen, 6), 0xFEEDBEEF):
        for b in (None, bias):
            out = attention.mha(q, k, v, 12, bias=b, dropout_rate=0.1,
                                dropout_seed=seed)
            ref = attention.mha_reference(q, k, v, 12, bias=b,
                                          dropout_rate=0.1,
                                          dropout_seed=seed)
            assert (out.float() - ref.float()).abs().max().item() <= tol
    assert attention.mha_dropout.launches == before + 4


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_backward_kernel_matches_plain(gen, dtype, tol):
    """K3 against the plain backward, each gradient within tol * max(1,
    max |plain|): packed, split with dropout, split with bias, dropout and
    the bias gradient."""
    def close(out, ref):
        for o, r in zip(out, ref):
            scale = max(1.0, r.float().abs().max().item())
            assert (o.float() - r.float()).abs().max().item() <= tol * scale

    qkv = torch.randn(4, 197, 3 * 768, device="cuda", generator=gen).to(dtype)
    g = torch.randn(4, 197, 768, device="cuda", generator=gen).to(dtype)
    before = attention.mha_bwd.launches
    dqkv = attention.mha_bwd(None, None, None, g, 12, packed_qkv=qkv)
    ref = attention.mha_bwd_reference(qkv[..., :768], qkv[..., 768:1536],
                                      qkv[..., 1536:], g, 12)
    close(dqkv.split(768, dim=-1), ref[:3])
    for n, d, heads, with_bias in ((133, 768, 12, False),
                                   (20, 512, 8, True)):
        q, k, v, g = (torch.randn(4, n, d, device="cuda",
                                  generator=gen).to(dtype) for _ in range(4))
        bias = None
        if with_bias:
            bias = torch.zeros(4, n, device="cuda")
            bias[1, 9:] = -1e9
        seeds = _seeds(gen, 4)
        out = attention.mha_bwd(q, k, v, g, heads, bias=bias,
                                dropout_rate=0.1, dropout_seed=seeds,
                                need_dbias=with_bias)
        ref = attention.mha_bwd_reference(q, k, v, g, heads, bias=bias,
                                          dropout_rate=0.1,
                                          dropout_seed=seeds)
        close([o for o in out if o is not None],
              [r for r in ref if r is not None])
    assert attention.mha_bwd.launches == before + 3


def test_gradients_flow_through_the_kernels(gen):
    """autograd through `mha` (K2d forward, K3 backward) and `mha_packed`
    (K1, K3) on the card: q gets a non-zero gradient equal to the plain
    backward's."""
    q, k, v, g = (torch.randn(3, 20, 512, device="cuda", generator=gen)
                  for _ in range(4))
    seeds = _seeds(gen, 3)
    tq = q.clone().requires_grad_()
    before = attention.mha_bwd.launches
    attention.mha(tq, k, v, 8, dropout_rate=0.1, dropout_seed=seeds).backward(g)
    assert attention.mha_bwd.launches == before + 1
    ref = attention.mha_bwd_reference(q, k, v, g, 8, dropout_rate=0.1,
                                      dropout_seed=seeds)[0]
    assert tq.grad is not None and tq.grad.abs().max().item() > 0
    assert (tq.grad - ref).abs().max().item() <= 1e-5

    qkv = torch.randn(3, 50, 3 * 256, device="cuda",
                      generator=gen).requires_grad_()
    g = torch.randn(3, 50, 256, device="cuda", generator=gen)
    attention.mha_packed(qkv, 4).backward(g)
    d = 256
    ref = attention.mha_bwd_reference(qkv[..., :d].detach(),
                                      qkv[..., d:2 * d].detach(),
                                      qkv[..., 2 * d:].detach(), g, 4)
    assert qkv.grad[..., :d].abs().max().item() > 0
    assert (qkv.grad - torch.cat(ref[:3], -1)).abs().max().item() <= 1e-5


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


def _codes(x):
    """Per-row int8 codes and (N,) fp32 scales of a (N, D) card tensor."""
    codes, scales = topk.quantize_rows_i8(x.cpu().numpy())
    return (torch.from_numpy(codes).to(x.device),
            torch.from_numpy(scales[:, 0]).to(x.device))


def _same_i8(q, keys, n_valid, k):
    qc, qs = _codes(q)
    kc, ks = _codes(keys)
    before = topk.topk_i8.launches
    v, i = topk.topk_i8(qc, qs, kc, ks, n_valid, k)
    assert topk.topk_i8.launches == before + 1
    rv, ri = topk.topk_i8_reference(qc, qs, kc, ks, n_valid, k)
    assert torch.equal(v, rv) and torch.equal(i, ri)
    return v, i


@pytest.mark.parametrize("bq,k", [(1, 1), (37, 21), (130, 64)])
def test_int8_topk_kernel_bit_equal_to_plain(gen, bq, k):
    keys = torch.randn(50_000, 768, device="cuda", generator=gen)
    q = torch.randn(bq, 768, device="cuda", generator=gen)
    _, i = _same_i8(q, keys, 49_001, k)
    assert (i < 49_001).all()


def test_int8_topk_kernel_duplicates_zero_rows_and_k_equal_n_valid(gen):
    """Ties everywhere: duplicate keys come back in index order, zero rows
    (scale 1, zero codes) score 0, and k = n_valid returns every key."""
    keys = torch.randn(3000, 768, device="cuda", generator=gen)
    keys[1000:1040] = keys[7]
    keys[2000:2100] = 0.0
    q = torch.cat([keys[7:8], -keys[7:8], torch.zeros(1, 768, device="cuda")])
    v, i = _same_i8(q, keys, 3000, 41)
    assert i[0, :41].tolist() == [7] + list(range(1000, 1040))
    assert (v[2] == 0).all() and i[2].tolist() == list(range(41))
    v, i = _same_i8(q, keys[:60], 60, 60)
    assert sorted(i[0].tolist()) == list(range(60))
    with pytest.raises(ValueError, match="64"):
        qc, qs = _codes(q)
        topk.topk_i8(qc, qs, *_codes(keys), 3000, 65)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_masked_attention_kernel_matches_plain(gen, dtype, tol):
    """K1m at the OpenCLIP text shapes (N = 77, and the service's 20) under
    the causal mask, and under an arbitrary dense fp32 mask; counted in
    `mask_launches`, apart from K1."""
    d = 768
    for n, mask in ((77, causal_mask(77, "cuda")), (20, causal_mask(20, "cuda")),
                    (77, torch.randn(77, 77, device="cuda", generator=gen))):
        qkv = torch.randn(4, n, 3 * d, device="cuda", generator=gen).to(dtype)
        before = (attention.mha_packed.launches,
                  attention.mha_packed.mask_launches)
        out = attention.mha_packed(qkv, 12, mask=mask)
        assert (attention.mha_packed.launches,
                attention.mha_packed.mask_launches) == (before[0],
                                                        before[1] + 1)
        ref = attention.mha_reference(qkv[..., :d], qkv[..., d : 2 * d],
                                      qkv[..., 2 * d :], 12, mask=mask)
        assert (out.float() - ref.float()).abs().max().item() <= tol
    with pytest.raises(ValueError, match="mask"):
        attention.mha_packed(qkv, 12, mask=mask[:20, :20].contiguous())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_attention_kernel_at_vit_l14(gen, dtype, tol):
    """K1 at ViT-L/14's shape: N = 257, D = 1024, 16 heads (144,016 B of
    shared memory per block)."""
    d = 1024
    qkv = torch.randn(3, 257, 3 * d, device="cuda", generator=gen).to(dtype)
    out = attention.mha_packed(qkv, 16)
    ref = attention.mha_reference(qkv[..., :d], qkv[..., d : 2 * d],
                                  qkv[..., 2 * d :], 16)
    assert (out.float() - ref.float()).abs().max().item() <= tol


def _close_grads(out, ref, tol):
    for o, r in zip(out, ref):
        scale = max(1.0, r.float().abs().max().item())
        assert (o.float() - r.float()).abs().max().item() <= tol * scale


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_masked_backward_kernel_matches_plain(gen, dtype, tol):
    """K3m at the OpenCLIP text shapes (the train path's N = 20, CLIP-BPE's
    77) under the causal mask and a dense random fp32 mask, counted in
    `mha_bwd.mask_launches` apart from K3; above the diagonal of the causal
    mask the probabilities are exactly 0, so k and v of the last key get
    gradient only from the last query row."""
    d = 768
    for n, mask in ((20, causal_mask(20, "cuda")),
                    (77, causal_mask(77, "cuda")),
                    (77, torch.randn(77, 77, device="cuda", generator=gen))):
        qkv = torch.randn(4, n, 3 * d, device="cuda", generator=gen).to(dtype)
        g = torch.randn(4, n, d, device="cuda", generator=gen).to(dtype)
        before = (attention.mha_bwd.launches, attention.mha_bwd.mask_launches)
        dqkv = attention.mha_bwd(None, None, None, g, 12, packed_qkv=qkv,
                                 mask=mask)
        assert (attention.mha_bwd.launches,
                attention.mha_bwd.mask_launches) == (before[0], before[1] + 1)
        ref = attention.mha_bwd_reference(qkv[..., :d], qkv[..., d : 2 * d],
                                          qkv[..., 2 * d :], g, 12, mask=mask)
        _close_grads(dqkv.split(d, dim=-1), ref[:3], tol)
    causal = causal_mask(77, "cuda")
    qkv = torch.randn(2, 77, 3 * d, device="cuda", generator=gen).to(dtype)
    g = torch.zeros(2, 77, d, device="cuda", dtype=dtype)
    g[:, :76] = torch.randn(2, 76, d, device="cuda", generator=gen).to(dtype)
    dqkv = attention.mha_bwd(None, None, None, g, 12, packed_qkv=qkv,
                             mask=causal)
    assert not dqkv[:, 76, d:].any()


def test_gradients_flow_through_the_masked_kernels(gen):
    """autograd through `mha_packed(mask=)` on the card (K1m forward, K3m
    backward) gives the plain backward's gradient."""
    qkv = torch.randn(3, 20, 3 * 768, device="cuda",
                      generator=gen).requires_grad_()
    g = torch.randn(3, 20, 768, device="cuda", generator=gen)
    mask = causal_mask(20, "cuda")
    before = attention.mha_bwd.mask_launches
    attention.mha_packed(qkv, 12, mask=mask).backward(g)
    assert attention.mha_bwd.mask_launches == before + 1
    x = qkv.detach()
    ref = attention.mha_bwd_reference(x[..., :768], x[..., 768:1536],
                                      x[..., 1536:], g, 12, mask=mask)
    assert qkv.grad[..., :768].abs().max().item() > 0
    assert (qkv.grad - torch.cat(ref[:3], -1)).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_backward_kernel_at_vit_l14(gen, dtype, tol):
    """K3 packed at ViT-L/14's shape: N = 257, D = 1024, 16 heads (the
    image tower's backward in OpenCLIP training)."""
    d = 1024
    qkv = torch.randn(2, 257, 3 * d, device="cuda", generator=gen).to(dtype)
    g = torch.randn(2, 257, d, device="cuda", generator=gen).to(dtype)
    dqkv = attention.mha_bwd(None, None, None, g, 16, packed_qkv=qkv)
    ref = attention.mha_bwd_reference(qkv[..., :d], qkv[..., d : 2 * d],
                                      qkv[..., 2 * d :], g, 16)
    _close_grads(dqkv.split(d, dim=-1), ref[:3], tol)


def test_masked_backward_rejects_a_malformed_mask(gen):
    qkv = torch.randn(2, 20, 3 * 768, device="cuda", generator=gen)
    g = torch.randn(2, 20, 768, device="cuda", generator=gen)
    mask = causal_mask(20, "cuda")
    for bad in (mask[:19, :19].contiguous(), mask.to(torch.bfloat16),
                mask.cpu(), mask.t()):
        with pytest.raises((TypeError, ValueError), match="mask"):
            attention.mha_bwd(None, None, None, g, 12, packed_qkv=qkv,
                              mask=bad)


@pytest.mark.parametrize("bq", [1, 37, 130])
def test_mm_only_kernel_matches_plain(gen, bq):
    keys = torch.randn(50_000, 768, device="cuda", generator=gen)
    keys /= keys.norm(dim=1, keepdim=True)
    q = torch.randn(bq, 768, device="cuda", generator=gen)
    q /= q.norm(dim=1, keepdim=True)
    before = topk.mm_only.launches
    for prec in ("high", "default"):
        out = topk.mm_only(q, keys, 49_001, precision=prec)
        ref = topk.mm_only_reference(q, keys, 49_001, precision=prec)
        assert out.shape == (bq, 128)
        assert (out - ref).abs().max().item() <= 1e-5
    qc, _ = topk.quantize_rows_i8_torch(q)
    kc, _ = topk.quantize_rows_i8_torch(keys)
    out = topk.mm_only(qc, kc, 49_001, int8=True)
    assert torch.equal(out, topk.mm_only_reference(qc, kc, 49_001, int8=True))
    assert topk.mm_only.launches == before + 3
    assert torch.isneginf(topk.mm_only(q, keys, 0)).all()


def test_tiny_kernel_is_exact(gen):
    x = torch.randn(8, 128, device="cuda", generator=gen)
    before = topk.tiny.launches
    assert torch.equal(topk.tiny(x), topk.tiny_reference(x))
    assert topk.tiny.launches == before + 1


def test_eot_pooling_takes_the_first_maximum_on_the_card(gen):
    """The OpenCLIP text tower pools at `argmax(token_ids)`; on the card, as
    on the CPU and in JAX, ties go to the first maximum."""
    ids = torch.randint(0, 5, (64, 77), device="cuda", generator=gen)
    ids[:, 40:] = 7
    ids[3] = 2
    assert ids.argmax(dim=-1).tolist() == [40] * 3 + [0] + [40] * 60
