"""Card-only tests of the port's CUDA kernels against their plain PyTorch
versions. They skip without a CUDA device. This file imports neither JAX nor
the JAX package, so it also runs on a machine without them:

    python3 -m pytest -q -p no:cacheprovider --noconftest -m gpu \\
        tests/test_torch_gpu.py

Tolerances: attention fp32 atol 1e-5 (fp32 sums in another order), bf16
atol 2e-2 (one bf16 ulp at |x| ~ 1 is 7.8e-3, and p is rounded to bf16
before P.V on both sides), the masked forward (K1m) as K1, K1's sm90 body
(bf16, head dim 64, 33 <= N <= 272: TMA and wgmma) as K1, with one case
where its output must equal the plain version's bit for bit; K1m on that
body (bf16, head dim 64, 1 <= N <= 160, the plan's from N = 8, the (N, N)
mask staged in shared memory) as K1 under the causal mask, a dense random
mask and a mask with whole -1e9 rows, with a bit-equal case and a refused
foreign plan; K2 and
K2d on that body (split q/k/v, 1 <= N <= 272, with and without a key
bias and dropout in both seed modes) as K1, with a bit-equal case under a
padding bias and a refused misaligned base and foreign plan, and K2d on the
mma.sync body where its plan measured that faster as K1; the attention
backward (K3, and K3m with the mask) the same, scaled by max(1, max |plain|)
per gradient; K3's sm90 body (bf16, head dim 64, 33 <= N <= 272, no mask,
no key bias: TMA and wgmma) as K3, with one case where its dqkv must equal
the plain version's bit for bit and one where its two passes' scores must;
K3m on that body (bf16, head dim 64, 1 <= N <= 144 but where its plan
measured the mma.sync body faster, no dropout, the mask's rows (pass A)
and columns (pass B) staged in shared memory) as K3 under the causal mask,
a dense random mask and a mask with whole -1e9 rows, on either side of
the plan's crossing, with its two passes' masked scores bit-equal and a
refused foreign plan.
bf16 runs the tensor-core (mma.sync) bodies (the forward above N = 32),
fp32 the FFMA ones; K2d's keep mask reads out bit for bit on the sm90 body
and on the bodies of csrc/mha_fwd.cu, and two K3
launches are bit-equal. fp32 top-k (K4) values atol 1e-5 on
unit vectors, in "high" (six bf16 products of the operands' three-way
split, fp32 sums, within fp32 rounding of the plain version's fp32) and
"default" precision (bf16 operands: exact products, fp32 sums), index sets
equal up to near-ties within 1e-5, two launches bit-equal, at every query
block of its plan and its ragged edge on both bodies (the mma.sync body
below the plan's crossing, the Hopper body of csrc/topk_sm90.cu from it
up, each launch counted on its body), k = 1, 5, 20 and 32, fewer keys
than one tile, scores rising with the key index and duplicate keys tied at
the k-th place, and on the Hopper body inputs whose answer is exact
(one-hot and integer-valued rows: values and indices equal to the plain
version's), and each body refusing a plan that is not its own; int8 top-k (K5)
bit-equal to its plain version, values and indices (exact integer dots times
two scales in the same order, the same tie rule), at every query block of
its plan and its ragged edge, k = 1, 21 and 64, widths 64 and 768, fewer
keys than one tile, scores rising with the key index and duplicate blocks
tied at the k-th place, on each body (the Hopper body of
csrc/topk_i8_sm90.cu at each query block 16, 32, 64 and 128 and ring
depth, with and without its seed, the mma.sync body of csrc/topk.cu), two
launches bit-equal, each launch counted on its body, each body refusing a
plan that is not its own; and
on both top-k kernels' Hopper bodies exactly k, k + 1 and 128 scores of
one tile tied at the k-th place (the screen's raise of a flooded tile);
the matmul-only control (K6) int8 bit-equal, fp32 atol 1e-5 on unit
vectors in both precisions (fp32 sums of 768 products in another order),
on the walk its plan chooses (counted there) and on each walk (the
row-max launch of K4's or K5's Hopper body, the mma.sync walks), at every
query block, over no key, one, fewer than a tile, and scores rising with
the key index; K7 exact: on its 16-byte and its one-float body (ragged
sizes, a base 4 bytes off), on a side stream, and captured in a CUDA graph
on a side stream and replayed on new inputs.
"""

import ctypes
import dataclasses

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

    # BERT-small (N = 20, with its padding bias) and BarcodeBERT (N = 133)
    for n, d, heads in ((20, 512, 8), (133, 768, 12)):
        q, k, v = (torch.randn(8, n, d, device="cuda",
                               generator=gen).to(dtype) for _ in range(3))
        bias = torch.zeros(8, n, device="cuda")
        bias[:, 15:] = -1e9
        for b in (None, bias):
            out = attention.mha(q, k, v, heads, bias=b)
            ref = attention.mha_reference(q, k, v, heads, bias=b)
            assert (out.float() - ref.float()).abs().max().item() <= tol


def _k1_case(gen, b, n, d, heads):
    qkv = torch.randn(b, n, 3 * d, device="cuda",
                      generator=gen).to(torch.bfloat16)
    before = (attention.mha_packed.launches,
              attention.mha_packed.sm90_launches)
    out = attention.mha_packed(qkv, heads)
    torch.cuda.synchronize()
    launched = (attention.mha_packed.launches - before[0],
                attention.mha_packed.sm90_launches - before[1])
    ref = attention.mha_reference(qkv[..., :d], qkv[..., d : 2 * d],
                                  qkv[..., 2 * d :], heads)
    return (out.float() - ref.float()).abs().max().item(), launched


@pytest.mark.parametrize("b,n,d,heads", [
    (3, 33, 768, 12), (3, 64, 768, 12), (3, 65, 768, 12), (2, 197, 768, 12),
    (3, 256, 768, 12), (2, 257, 768, 12), (3, 272, 768, 12),
    (1, 197, 768, 12), (256, 197, 768, 12), (256, 257, 1024, 16)])
def test_k1_sm90_body_matches_plain(gen, b, n, d, heads):
    """K1 on the sm90 body (bf16, head dim 64, 33 <= N <= 272) against
    the plain version at the ragged and tile-boundary N and both ViT
    shapes (ViT-B/16 at B=256, ViT-L/14), within 2e-2 (one bf16 ulp at
    |o| ~ 1 is 7.8e-3, and p is rounded to bf16 before P.V on both
    sides)."""
    err, launched = _k1_case(gen, b, n, d, heads)
    assert launched == (1, 1)
    assert err <= 2e-2


@pytest.mark.parametrize("n,hd", [(273, 64), (32, 64), (197, 32),
                                  (197, 128)])
def test_k1_outside_the_sm90_range_keeps_its_body(gen, n, hd):
    err, launched = _k1_case(gen, 2, n, 4 * hd, 4)
    assert launched == (1, 0)
    assert err <= 2e-2


def test_k1_sm90_body_rounds_p_to_bf16(gen):
    """q = 0 makes every score 0, so p = 1/197 exactly on every side;
    rounded to bf16 it is 83 * 2**-14, and o = sum over 197 keys of p * 1
    = 16351 * 2**-14 exactly in fp32, which is 0.99609375 in bf16. An
    unrounded p gives 1.0, and a key past N that took part gives another
    value: every output is 0.99609375, as the plain version's."""
    b, n, d, heads = 2, 197, 768, 12
    qkv = torch.zeros(b, n, 3 * d, device="cuda", dtype=torch.bfloat16)
    qkv[..., d : 2 * d] = torch.randn(b, n, d, device="cuda", generator=gen)
    qkv[..., 2 * d :] = 1.0
    before = attention.mha_packed.sm90_launches
    out = attention.mha_packed(qkv, heads)
    assert attention.mha_packed.sm90_launches == before + 1
    ref = attention.mha_reference(qkv[..., :d], qkv[..., d : 2 * d],
                                  qkv[..., 2 * d :], heads)
    assert torch.equal(out, ref)
    assert torch.equal(out, torch.full_like(out, 0.99609375))


def test_k1_sm90_body_refuses_a_misaligned_base(gen):
    d = 768
    flat = torch.randn(2 * 197 * 3 * d + 1, device="cuda",
                       generator=gen).to(torch.bfloat16)
    qkv = flat[1:].view(2, 197, 3 * d)  # starts 2 bytes past 16-byte
    before = attention.mha_packed.sm90_launches
    with pytest.raises(ValueError, match="16-byte"):
        attention.mha_packed(qkv, 12)
    assert attention.mha_packed.sm90_launches == before


def _seeds(gen, b):
    return torch.randint(0, 2**32, (b,), device="cuda", generator=gen,
                         dtype=torch.int64)


def _k3_inputs(gen, b, n, d, heads, packed, rate, seed):
    if packed:
        qkv = torch.randn(b, n, 3 * d, device="cuda",
                          generator=gen).to(torch.bfloat16)
        q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
    else:
        qkv = None
        q, k, v = (torch.randn(b, n, d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
    g = torch.randn(b, n, d, device="cuda", generator=gen).to(torch.bfloat16)
    if rate > 0 and seed is None:
        seed = _seeds(gen, b)
    kw = dict(dropout_rate=rate, dropout_seed=seed) if rate > 0 else {}

    def kernel():
        if packed:
            dqkv = attention.mha_bwd(None, None, None, g, heads,
                                     packed_qkv=qkv, **kw)
            return tuple(dqkv.split(d, dim=-1))
        return attention.mha_bwd(q, k, v, g, heads, **kw)[:3]

    return q, k, v, g, kw, kernel


# K3's sm90 body (bf16, head dim 64, 33 <= N <= 272, no mask, no bias):
# ViT-B/16 and BarcodeBERT (row-keyed dropout, and a scalar seed) at B=400,
# ViT-L/14 at B=64, the ragged N = 33, 65, 200 and the plan's largest N.
@pytest.mark.parametrize("b,n,d,heads,packed,rate,seed", [
    (400, 197, 768, 12, True, 0.0, None),
    (400, 133, 768, 12, False, 0.1, None),
    (8, 133, 768, 12, False, 0.1, 0x9E3779B9),
    (64, 257, 1024, 16, True, 0.0, None),
    (3, 33, 768, 12, True, 0.0, None),
    (3, 65, 768, 12, False, 0.1, None),
    (3, 200, 768, 12, True, 0.0, None),
    (3, 272, 768, 12, False, 0.1, None)])
def test_k3_sm90_body_matches_plain(gen, b, n, d, heads, packed, rate, seed):
    """Each gradient within 2e-2 * max(1, max |plain|) (one bf16 ulp at
    |x| ~ 1 is 7.8e-3; y and ds * scale are rounded to bf16 on both
    sides); one launch, on the sm90 body; a second launch bit-equal."""
    q, k, v, g, kw, kernel = _k3_inputs(gen, b, n, d, heads, packed, rate,
                                        seed)
    before = (attention.mha_bwd.launches, attention.mha_bwd.sm90_launches)
    out = kernel()
    torch.cuda.synchronize()
    assert (attention.mha_bwd.launches - before[0],
            attention.mha_bwd.sm90_launches - before[1]) == (1, 1)
    again = kernel()
    assert all(torch.equal(a, a2) for a, a2 in zip(out, again))
    del again
    ref = attention.mha_bwd_reference(q, k, v, g, heads, **kw)[:3]
    _close_grads(out, ref, 2e-2)


def test_k3_sm90_body_rounds_y_to_bf16(gen):
    """q = 0 makes every score 0, so p = 1/197 exactly on every side (keys
    past N must score -inf in pass A, else l = 208); v = 0 makes dp, ds, dq
    and dk 0; with g = 1, dv = the sum over 197 query rows of y = p rounded
    to bf16 (83 * 2**-14) = 16351 * 2**-14 exactly in fp32, 0.99609375 in
    bf16 (an unrounded y gives 1.0): dqkv equals the plain version's bit for
    bit."""
    b, n, d, heads = 2, 197, 768, 12
    qkv = torch.zeros(b, n, 3 * d, device="cuda", dtype=torch.bfloat16)
    qkv[..., d : 2 * d] = torch.randn(b, n, d, device="cuda", generator=gen)
    g = torch.ones(b, n, d, device="cuda", dtype=torch.bfloat16)
    before = attention.mha_bwd.sm90_launches
    dqkv = attention.mha_bwd(None, None, None, g, heads, packed_qkv=qkv)
    assert attention.mha_bwd.sm90_launches == before + 1
    ref = attention.mha_bwd_reference(qkv[..., :d], qkv[..., d : 2 * d],
                                      qkv[..., 2 * d :], g, heads)
    assert torch.equal(dqkv, torch.cat(ref[:3], dim=-1))
    assert not dqkv[..., : 2 * d].any()
    assert torch.equal(dqkv[..., 2 * d :],
                       torch.full_like(g, 0.99609375))


def test_k3_sm90_passes_form_the_same_scores(gen):
    """Pass B rebuilds p from pass A's m and 1 / l, so it must form each
    score as pass A did: s read out of pass A (q in wgmma's A role) and of
    pass B (k in the A role) at every (b, h, i, j), bit for bit; both
    within fp32 rounding of q . k * scale; the read-out launch's dqkv is
    the plain launch's."""
    b, n, d, heads = 4, 197, 768, 12
    qkv = torch.randn(b, n, 3 * d, device="cuda",
                      generator=gen).to(torch.bfloat16)
    g = torch.randn(b, n, d, device="cuda", generator=gen).to(torch.bfloat16)
    s_a, s_b, dqkv = attention.bwd_sm90_scores(qkv, g, heads)
    torch.cuda.synchronize()
    qh, kh = (qkv[..., i * d:(i + 1) * d].float().view(b, n, heads, 64)
              for i in range(2))
    ref = torch.einsum("bnhd,bmhd->bhnm", qh, kh) * 0.125
    assert (s_a - ref).abs().max().item() <= 1e-4 * max(
        1.0, ref.abs().max().item())
    assert torch.equal(s_a, s_b)
    assert torch.equal(dqkv, attention.mha_bwd(None, None, None, g, heads,
                                               packed_qkv=qkv))


@pytest.mark.parametrize("n,hd,bias,dtype", [
    (32, 64, False, torch.bfloat16), (273, 64, False, torch.bfloat16),
    (197, 32, False, torch.bfloat16), (133, 64, True, torch.bfloat16),
    (197, 64, False, torch.float32)])
def test_k3_outside_the_sm90_plan_keeps_its_body(gen, n, hd, bias, dtype):
    heads = 4
    d = heads * hd
    q, k, v, g = (torch.randn(2, n, d, device="cuda", generator=gen).to(dtype)
                  for _ in range(4))
    kb = None
    if bias:
        kb = torch.zeros(2, n, device="cuda")
        kb[1, n // 2:] = -1e9
    before = (attention.mha_bwd.launches, attention.mha_bwd.sm90_launches)
    out = attention.mha_bwd(q, k, v, g, heads, bias=kb, need_dbias=bias)
    assert (attention.mha_bwd.launches - before[0],
            attention.mha_bwd.sm90_launches - before[1]) == (1, 0)
    ref = attention.mha_bwd_reference(q, k, v, g, heads, bias=kb)
    _close_grads([o for o in out if o is not None],
                 [r for r in ref if r is not None],
                 2e-2 if dtype == torch.bfloat16 else 1e-5)


def test_k3_sm90_body_refuses_a_misaligned_base(gen):
    d = 768
    flat = torch.randn(2 * 197 * 3 * d + 1, device="cuda",
                       generator=gen).to(torch.bfloat16)
    qkv = flat[1:].view(2, 197, 3 * d)  # starts 2 bytes past 16-byte
    g = torch.randn(2, 197, d, device="cuda", generator=gen).to(torch.bfloat16)
    before = (attention.mha_bwd.launches, attention.mha_bwd.sm90_launches)
    with pytest.raises(ValueError, match="16-byte"):
        attention.mha_bwd(None, None, None, g, 12, packed_qkv=qkv)
    assert (attention.mha_bwd.launches,
            attention.mha_bwd.sm90_launches) == before


def _k2_inputs(gen, b, n, d):
    return tuple(torch.randn(b, n, d, device="cuda", generator=gen)
                 .to(torch.bfloat16) for _ in range(3))


def _lengths_bias(lengths, n):
    """(B, N) fp32 key-padding bias: 0 for the first lengths[b] keys of row
    b, -1e9 after them."""
    lengths = torch.as_tensor(lengths, device="cuda")
    keep = torch.arange(n, device="cuda")[None, :] < lengths[:, None]
    return torch.where(keep, 0.0, -1e9).float()


def _k2_case(gen, b, n, d, heads, bias=None, rate=0.0, seed=None):
    """K2 (K2d with a rate) through `mha` against the plain version: the
    max |error| and the (launches, sm90 launches) it counted."""
    q, k, v = _k2_inputs(gen, b, n, d)
    counter = attention.mha_dropout if rate > 0 else attention.mha
    kw = dict(bias=bias)
    if rate > 0:
        kw.update(dropout_rate=rate, dropout_seed=seed)
    before = (counter.launches, counter.sm90_launches)
    out = attention.mha(q, k, v, heads, **kw)
    torch.cuda.synchronize()
    launched = (counter.launches - before[0],
                counter.sm90_launches - before[1])
    ref = attention.mha_reference(q, k, v, heads, **kw)
    return (out.float() - ref.float()).abs().max().item(), launched


# K2 and K2d on the forward's sm90 body (split q/k/v, bf16, head dim 64,
# 1 <= N <= 272): the ragged and tile-boundary N, BERT-small's 20 and
# BarcodeBERT's 133, with and without a padding bias, without dropout, with
# row-keyed (B,) seeds and with one scalar seed (the batch index in the
# counter).
@pytest.mark.parametrize("drop", ["none", "rows", "scalar"])
@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("n", [1, 5, 16, 17, 20, 32, 33, 64, 65, 133, 197,
                               256, 272])
def test_k2_sm90_body_matches_plain(gen, n, biased, drop):
    """Within 2e-2, as K1 (one bf16 ulp at |o| ~ 1 is 7.8e-3, and p, times
    the keep factor, is rounded to bf16 before P.V on both sides); the keep
    bits themselves are read out bit for bit below."""
    b = 3
    # the last row pads one key (at N = 1, its only one: a fully padded row)
    lengths = torch.randint(min(5, n), n + 1, (b,), device="cuda",
                            generator=gen)
    lengths[-1] = n - 1
    bias = _lengths_bias(lengths, n) if biased else None
    seed = {"none": None, "rows": _seeds(gen, b), "scalar": 0x5EED1234}[drop]
    err, launched = _k2_case(gen, b, n, 768, 12, bias,
                             0.0 if drop == "none" else 0.1, seed)
    assert launched == (1, 1)
    assert err <= 2e-2


def test_k2d_takes_the_mma_body_where_the_plan_measured_it_faster(gen):
    """BarcodeBERT's K2d at B = 256, N = 133 (`SPLIT_MMA_FROM`): `mha`
    launches the mma.sync body of csrc/mha_fwd.cu, counted in
    `mha_dropout.mma_launches`, within 2e-2 of the plain version; the sm90
    body under a forced plan gives the same result on the same inputs."""
    b, n, d, heads = 256, 133, 768, 12
    assert attention.plan_split_fwd(b, n, heads, 64, dropout=True).body == (
        "mma")
    seeds = _seeds(gen, b)
    before = attention.mha_dropout.mma_launches
    err, launched = _k2_case(gen, b, n, d, heads, rate=0.1, seed=seeds)
    assert launched == (1, 0)
    assert attention.mha_dropout.mma_launches == before + 1
    assert err <= 2e-2
    q, k, v = _k2_inputs(gen, b, n, d)
    out = torch.empty_like(q)
    attention._launch_sm90((q.data_ptr(), k.data_ptr(), v.data_ptr()), out,
                           d, attention.sm90_fwd_plan(b, n, heads), 0.125,
                           None, attention._drop_args(0.1, seeds, b,
                                                      q.device))
    ref = attention.mha_reference(q, k, v, heads, dropout_rate=0.1,
                                  dropout_seed=seeds)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


def test_k2_sm90_body_rounds_p_to_bf16_under_a_bias(gen):
    """q = 0 makes every real key's p = 1 / L for a row of L unpadded keys
    (the -1e9 bias gives the others p = 0): rounded to bf16 and summed over
    v = 1 in fp32, o is 0.99609375 in bf16 at each of these L (an unrounded
    p gives 1.0, and a padded key that took part another value), bit-equal
    to the plain version's. At BarcodeBERT's N = 133."""
    lengths = [61, 75, 83, 95, 99, 109, 115, 121, 122]
    b, n, d, heads = len(lengths), 133, 768, 12
    q = torch.zeros(b, n, d, device="cuda", dtype=torch.bfloat16)
    k = torch.randn(b, n, d, device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.ones_like(q)
    bias = _lengths_bias(lengths, n)
    before = attention.mha.sm90_launches
    out = attention.mha(q, k, v, heads, bias=bias)
    assert attention.mha.sm90_launches == before + 1
    assert torch.equal(out, attention.mha_reference(q, k, v, heads,
                                                    bias=bias))
    assert torch.equal(out, torch.full_like(out, 0.99609375))


def test_k2_sm90_body_takes_a_fully_padded_row(gen):
    """-1e9 on every key of a row: every score is -1e9 (q . k * scale is
    below its fp32 ulp there), so p is uniform over the N real keys and 0
    on the padded rows of the tile, as in the plain version; other rows
    padded from 1, 5 and 100 keys."""
    for rate, seed in ((0.0, None), (0.1, _seeds(gen, 4))):
        err, launched = _k2_case(gen, 4, 133, 768, 12,
                                 _lengths_bias([0, 1, 5, 100], 133), rate,
                                 seed)
        assert launched == (1, 1)
        assert err <= 2e-2


@pytest.mark.parametrize("n,hd,dtype", [
    (273, 64, torch.bfloat16),
    (133, 32, torch.bfloat16), (133, 128, torch.bfloat16),
    (20, 32, torch.bfloat16), (133, 64, torch.float32),
    (20, 64, torch.float32)])
def test_k2_outside_the_sm90_range_keeps_its_body(gen, n, hd, dtype):
    """bf16 at N <= 32 with another head dim (the FFMA body), N > 272 and
    head dims 32 and 128 above N = 32 (the mma.sync body) and fp32 (FFMA)
    launch the bodies of csrc/mha_fwd.cu, with a bias and dropout as
    without."""
    heads, b = 4, 2
    q, k, v = (torch.randn(b, n, heads * hd, device="cuda", generator=gen)
               .to(dtype) for _ in range(3))
    bias = _lengths_bias([n, 3], n)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for counter, kw in ((attention.mha, {}),
                        (attention.mha_dropout,
                         dict(dropout_rate=0.1,
                              dropout_seed=_seeds(gen, b)))):
        before = (counter.launches, counter.sm90_launches)
        out = attention.mha(q, k, v, heads, bias=bias, **kw)
        assert (counter.launches - before[0],
                counter.sm90_launches - before[1]) == (1, 0)
        ref = attention.mha_reference(q, k, v, heads, bias=bias, **kw)
        assert (out.float() - ref.float()).abs().max().item() <= tol


def test_k2_sm90_body_refuses_a_misaligned_base_and_a_foreign_plan(gen):
    d = 768
    flat = torch.randn(2 * 133 * d + 1, device="cuda",
                       generator=gen).to(torch.bfloat16)
    q = flat[1:].view(2, 133, d)  # starts 2 bytes past 16-byte
    before = (attention.mha.launches, attention.mha.sm90_launches)
    with pytest.raises(ValueError, match="16-byte"):
        attention.mha(q, q, q, 12)
    assert (attention.mha.launches, attention.mha.sm90_launches) == before
    q, k, v = _k2_inputs(gen, 2, 133, d)
    bias = _lengths_bias([133, 50], 133)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    plan = attention.plan_split_fwd(2, 133, 12, 64, biased=True)
    out = torch.full_like(q, 7.0)
    for bad in (attention.plan_split_fwd(2, 133, 12, 64),  # unbiased smem
                dataclasses.replace(plan, items=plan.items + 1),
                dataclasses.replace(plan, kv_box=plan.kv_box // 2,
                                    kv_loads=2),
                dataclasses.replace(plan, grid=plan.items + 1)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            attention._launch_sm90(ptrs, out, d, bad, 0.125, bias)
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())  # nothing was launched
    attention._launch_sm90(ptrs, out, d, plan, 0.125, bias)
    ref = attention.mha_reference(q, k, v, 12, bias=bias)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


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
    # the bf16 bodies read rows in 16-byte pieces
    x = torch.randn(2 * 10 * 64 + 1, device="cuda",
                    generator=gen).to(torch.bfloat16)[1:].view(2, 10, 64)
    with pytest.raises(ValueError, match="aligned"):
        attention.mha(x, x, x, 1)


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


def test_topk_default_precision_matches_plain(gen):
    """K4 in "default" precision (operands rounded to bf16, fp32 sums)
    against its plain version, counted in `topk.default_launches`."""
    keys = torch.randn(100_000, 768, device="cuda", generator=gen)
    keys /= keys.norm(dim=1, keepdim=True)
    q = keys[:37] + 0.01 * torch.randn(37, 768, device="cuda", generator=gen)
    before = (topk.topk.launches, topk.topk.default_launches)
    for k in (1, 5, 20):
        v, i = topk.topk(q, keys, 99_001, k, precision="default")
        rv, ri = topk.topk_reference(q, keys, 99_001, k, precision="default")
        assert (v - rv).abs().max().item() <= 1e-5
        assert (i[:, 0] == ri[:, 0]).all()
        assert (i < 99_001).all()
    assert (topk.topk.launches, topk.topk.default_launches) == (
        before[0], before[1] + 3)
    default, _ = topk.topk(q, keys, 99_001, 5, precision="default")
    high, _ = topk.topk(q, keys, 99_001, 5)
    assert not torch.equal(high, default)
    with pytest.raises(ValueError, match="precision"):
        topk.topk(q, keys, 99_001, 5, precision="fp16")


def _unit(x):
    return x / x.norm(dim=1, keepdim=True)


def _same_f32(q, keys, n_valid, k, precision):
    """K4 against its plain version: values within 1e-5, index sets equal
    except for keys whose float64 score (over the operands as the precision
    sees them) lies within 1e-5 of the k-th value, and a second launch bit-
    equal to the first. Returns the kernel's (values, indices)."""
    counter = "launches" if precision == "high" else "default_launches"
    body = topk.plan_f32(q.shape[0], keys.shape[0], k, precision,
                         q.shape[1]).body
    on_body = "sm90_launches" if body == "sm90" else "mma_launches"
    before = getattr(topk.topk, counter), getattr(topk.topk, on_body)
    v, i = topk.topk(q, keys, n_valid, k, precision=precision)
    v2, i2 = topk.topk(q, keys, n_valid, k, precision=precision)
    assert (getattr(topk.topk, counter),
            getattr(topk.topk, on_body)) == (before[0] + 2, before[1] + 2)
    assert torch.equal(v, v2) and torch.equal(i, i2)
    rv, ri = topk.topk_reference(q, keys, n_valid, k, precision=precision)
    assert (v - rv).abs().max().item() <= 1e-5
    assert (i < n_valid).all()
    qd, kd = (x.to(torch.bfloat16) if precision == "default" else x
              for x in (q, keys))
    for r in range(q.shape[0]):
        diff = sorted(set(i[r].tolist()) ^ set(ri[r].tolist()))
        if diff:
            sc = qd[r].double() @ kd[diff].double().T
            assert (sc - rv[r, -1].double()).abs().max().item() <= 1e-5, r
    return v, i


@pytest.fixture
def keys_f32(gen):
    """20,000 random unit key rows of width 768."""
    return _unit(torch.randn(20_000, 768, device="cuda", generator=gen))


# every query block of K4's plan and its ragged edge, at k = 1, 5, 20 and
# 32 (lists of 8, 16 and 32 entries), in both precisions: the mma.sync body
# (16 rows) below the crossing, the Hopper body's 64, 128 and 256 above
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("k", [1, 5, 20, 32])
@pytest.mark.parametrize("bq", [1, 16, 17, 33, 64, 65, 128, 129, 256, 257])
def test_topk_every_query_block(gen, keys_f32, bq, k, precision):
    q = _unit(torch.randn(bq, 768, device="cuda", generator=gen))
    _same_f32(q, keys_f32, 19_937, k, precision)  # 19,937 % 128 = 97
    plan = topk.plan_f32(bq, keys_f32.shape[0], k, precision)
    if bq < topk.SM90_MIN_BQ[precision]:
        assert (plan.body, plan.qb) == ("mma", 16)
        return
    big = 256 if precision == "default" and k <= 8 else 128
    assert plan.body == "sm90"
    assert plan.qb == (64 if bq <= 64 else 128 if bq <= 128 else big)


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("bq", [17, 130, 256])
def test_topk_sm90_exact_answers(gen, bq, precision):
    """Inputs whose scores are exact in either precision, so the Hopper
    body's values and indices must equal the plain version's: one-hot keys
    (key j: (j // 768 + 1) at depth j % 768) against one-hot queries, which
    holds each query depth against the same key depth through the k-slot
    order; then integer-valued rows in -4 .. 4 (bf16 holds them, their dots
    are exact in fp32 in any order), whose many equal scores test the tie
    rule."""
    d, n = 768, 6_000
    j = torch.arange(n, device="cuda")
    keys = torch.zeros(n, d, device="cuda")
    keys[j, j % d] = (j // d + 1).float()
    q = torch.zeros(bq, d, device="cuda")
    q[torch.arange(bq, device="cuda"), (7 * torch.arange(bq, device="cuda")
                                        + 3) % d] = 1.0
    ints = torch.randint(-4, 5, (n + bq, d), device="cuda", generator=gen)
    for kk, qq in ((keys, q), (ints[:n].float(), ints[n:].float())):
        for k in (1, 5, 32):
            before = topk.topk.sm90_launches
            v, i = topk.topk(qq, kk, n - 5, k, precision=precision)
            assert topk.topk.sm90_launches == before + 1
            rv, ri = topk.topk_reference(qq, kk, n - 5, k,
                                         precision=precision)
            assert torch.equal(v, rv) and torch.equal(i, ri)


def test_topk_plans_agree_with_the_libraries(gen):
    """The Python plan's shared memory of the mma.sync body is
    csrc/topk.cu's; the sm90 body's shared memory is csrc/topk_sm90.cu's,
    and its k-slot order a permutation of each 64-deep chunk that keeps
    each 32-deep half (one TMA box of keys) whole."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kern = topk._kernel()
    for bq in (1, 16, 17, 64, 300):
        for n in (97, 19_937, 1 << 20):
            for k in (1, 20):
                for precision, terms in (("high", 3), ("default", 1)):
                    plan = topk.plan_f32(bq, n, k, precision, sms=sms,
                                         body="mma")
                    maxk = 8 if k <= 8 else 16 if k <= 16 else 32
                    assert plan.smem == kern.smem_f32(plan.qb, maxk, terms)
    sm90 = topk._sm90_kernel()
    for qb in (64, 128, 256):
        for maxk in (8, 16, 32):
            for terms in (1, 3):
                for stages in (2, 3, 4):
                    assert sm90.smem(qb, maxk, terms, stages) == (
                        topk.sm90_smem(qb, maxk, terms, stages))
    depth = [sm90.slot_depth(j) for j in range(64)]
    assert sorted(depth) == list(range(64))
    assert all(depth[j] // 32 == j // 32 for j in range(64))


def test_topk_sm90_refuses_a_plan_that_is_not_its_own(gen, keys_f32):
    q = _unit(torch.randn(40, 768, device="cuda", generator=gen))
    plan = topk.plan_f32(40, keys_f32.shape[0], 5, "high")
    kern = topk._sm90_kernel()
    for bad in (dataclasses.replace(plan, smem=plan.smem + 1024),
                dataclasses.replace(plan, qb=256),
                dataclasses.replace(plan, splits=plan.splits + 1),
                dataclasses.replace(plan, n_cand=plan.n_cand - 1),
                dataclasses.replace(plan, stages=5)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            topk._launch_sm90(kern, q, keys_f32, 19_937, 5, "high", bad)
    v, _ = topk._launch_sm90(kern, q, keys_f32, 19_937, 5, "high", plan)
    rv, _ = topk.topk_reference(q, keys_f32, 19_937, 5)
    assert (v - rv).abs().max().item() <= 1e-5


def test_topk_mma_refuses_a_plan_that_is_not_its_own(gen, keys_f32):
    q = _unit(torch.randn(40, 768, device="cuda", generator=gen))
    plan = topk.plan_f32(40, keys_f32.shape[0], 5, "high", body="mma")
    for bad in (dataclasses.replace(plan, qb=128),
                dataclasses.replace(plan, splits=plan.splits + 1),
                dataclasses.replace(plan, splits=plan.splits + 2),
                dataclasses.replace(plan, tiles_per_split=0),
                # n_cand as the splits need, but the splits miss keys
                dataclasses.replace(plan, splits=2, n_cand=40 * 5),
                dataclasses.replace(plan, n_cand=plan.n_cand - 1)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            topk._launch_mma(q, keys_f32, 19_937, 5, 0, bad)
    v, _ = topk._launch_mma(q, keys_f32, 19_937, 5, 0, plan)
    rv, _ = topk.topk_reference(q, keys_f32, 19_937, 5)
    assert (v - rv).abs().max().item() <= 1e-5


@pytest.mark.parametrize("precision", ["high", "default"])
def test_topk_fewer_keys_than_one_tile(gen, precision):
    keys = _unit(torch.randn(100, 768, device="cuda", generator=gen))
    for bq in (1, 20, 70):
        q = _unit(torch.randn(bq, 768, device="cuda", generator=gen))
        for k in (1, 5, 20, 32):
            _same_f32(q, keys, 77, k, precision)


def test_topk_high_and_default_differ(gen, keys_f32):
    q = _unit(torch.randn(33, 768, device="cuda", generator=gen))
    high, _ = _same_f32(q, keys_f32, 20_000, 5, "high")
    default, _ = _same_f32(q, keys_f32, 20_000, 5, "default")
    assert not torch.equal(high, default)
    # "high" is within fp32 rounding of float64 scores of the fp32 operands
    best = (q.double() @ keys_f32.double().T).amax(dim=1)
    assert (high[:, 0].double() - best).abs().max().item() <= 1e-6


@pytest.mark.parametrize("precision", ["high", "default"])
def test_topk_scores_rising_with_the_key_index(gen, precision):
    """Keys u * (1 + i / n): every query near u scores higher on each key
    than on the one before (near -u, lower), so every score passes the
    screen, the worst case of the running threshold."""
    n = 40_000
    u = _unit(torch.randn(1, 768, device="cuda", generator=gen))
    keys = u * (1 + torch.arange(n, device="cuda",
                                 dtype=torch.float32)[:, None] / n)
    noise = 0.1 * torch.randn(130, 768, device="cuda", generator=gen)
    q = _unit(torch.cat([u + noise[:20], -u + noise[20:40], u + noise[40:]]))
    for k in (1, 5, 20, 32):
        for bq in (1, 16, 40, 130):
            _, i = _same_f32(q[:bq].contiguous(), keys, n - 3, k, precision)
            if precision == "high":  # bf16 keys tie in runs of equal values
                assert i[0].tolist() == list(range(n - 4, n - 4 - k, -1))
                if bq >= 40:
                    assert i[39].tolist() == list(range(k))


@pytest.mark.parametrize("precision", ["high", "default"])
def test_topk_duplicate_keys_tie_at_the_threshold(gen, precision):
    """Blocks of identical keys across tiles and key splits: their equal
    scores straddle the k-th place, so the smaller indices must win."""
    keys = _unit(torch.randn(60_000, 768, device="cuda", generator=gen))
    keys[1000:1300] = keys[5]
    keys[30_017:30_100] = keys[5]
    keys[59_900:59_990] = keys[40_000]
    q = torch.cat([keys[5:6], keys[40_000:40_001],
                   _unit(torch.randn(30, 768, device="cuda", generator=gen))])
    for k in (1, 5, 20, 32):
        for bq in (2, 32):
            _, i = _same_f32(q[:bq].contiguous(), keys, 60_000, k, precision)
            assert i[0].tolist() == ([5] + list(range(1000, 1299)))[:k]
            assert i[1].tolist() == ([40_000] + list(range(59_900,
                                                           59_990)))[:k]


def _tied_tile(gen, m, k):
    """Keys whose scores against queries near w tie m times at the k-th
    place inside one tile (keys 19,211 .. 19,211 + m - 1 of tile 150, all
    0.5 w), under three higher keys in other tiles (0.9 w, 0.8 w, 0.7 w at
    39,000, 100 and 25,000) and 40,000 low random ones; the queries: w and
    129 rows near it. Each such tile floods (the raise of the screen), and
    the top k is the three, then the tied keys by index."""
    keys = 0.05 * _unit(torch.randn(40_000, 768, device="cuda",
                                    generator=gen))
    w = _unit(torch.randn(1, 768, device="cuda", generator=gen))
    start = 150 * 128 + 11 if m < 128 else 150 * 128
    keys[start:start + m] = 0.5 * w
    for i, f in ((39_000, 0.9), (100, 0.8), (25_000, 0.7)):
        keys[i] = f * w
    q = _unit(torch.cat([w, w + 0.01 * torch.randn(
        129, 768, device="cuda", generator=gen)]))
    want = [39_000, 100, 25_000] + list(range(start, start + m))
    return q, keys, want[:k]


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("tied", ["k", "k+1", "128"])
def test_topk_scores_tied_in_one_tile_at_the_threshold(gen, tied,
                                                         precision):
    """Exactly k, k + 1 and 128 scores of one tile tie at the k-th place:
    the smaller key indices win, on the raised screen."""
    for k in (5, 20):
        m = {"k": k, "k+1": k + 1, "128": 128}[tied]
        q, keys, want = _tied_tile(gen, m, k)
        for bq in (1, 130):
            _, i = _same_f32(q[:bq].contiguous(), keys, 40_000, k,
                             precision)
            assert i[0].tolist() == want


def _codes(x):
    """Per-row int8 codes and (N,) fp32 scales of a (N, D) card tensor."""
    codes, scales = topk.quantize_rows_i8(x.cpu().numpy())
    return (torch.from_numpy(codes).to(x.device),
            torch.from_numpy(scales[:, 0]).to(x.device))


def _same_i8(q, keys, n_valid, k):
    qc, qs = _codes(q)
    kc, ks = _codes(keys)
    return _same_codes(qc, qs, kc, ks, n_valid, k)


def _same_codes(qc, qs, kc, ks, n_valid, k):
    """K5 on the body its plan chooses, counted there, bit-equal to its
    plain version, and a second launch bit-equal to the first. Returns the
    kernel's (values, indices)."""
    body = topk.plan_i8(qc.shape[0], kc.shape[0], k, qc.shape[1]).body
    on_body = f"{body}_launches"
    before = topk.topk_i8.launches, getattr(topk.topk_i8, on_body)
    v, i = topk.topk_i8(qc, qs, kc, ks, n_valid, k)
    v2, i2 = topk.topk_i8(qc, qs, kc, ks, n_valid, k)
    assert (topk.topk_i8.launches,
            getattr(topk.topk_i8, on_body)) == (before[0] + 2, before[1] + 2)
    assert torch.equal(v, v2) and torch.equal(i, i2)
    rv, ri = topk.topk_i8_reference(qc, qs, kc, ks, n_valid, k)
    assert torch.equal(v, rv) and torch.equal(i, ri)
    return v, i


def _each_i8_body(qc, qs, kc, ks, n_valid, k):
    """Both bodies of K5 (and the Hopper body at each of its query blocks,
    at its fewest and most ring stages as planned, and at the most with and
    without the seed) bit-equal to the plain version."""
    bq, d = qc.shape
    n = kc.shape[0]
    rv, ri = topk.topk_i8_reference(qc, qs, kc, ks, n_valid, k)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = [topk.plan_i8(bq, n, k, d, sms, body="mma")]
    if d % 128 == 0:
        maxk = topk._maxk_i8(k)
        for qb in topk._i8_sm90_blocks(maxk):
            fit = [s for s in range(2, 9)
                   if topk.i8_sm90_smem(qb, maxk, s) <= topk.MAX_SMEM]
            plans += [topk.i8_sm90_plan(bq, n, k, sms, qb, s)
                      for s in (fit[0], fit[-1])]
            most = topk.i8_sm90_plan(bq, n, k, sms, qb, fit[-1])
            plans += [dataclasses.replace(most, seed_groups=g)
                      for g in (0, k)]
    for plan in plans:
        if plan.body == "mma":
            v, i = topk._launch_i8_mma(qc, qs, kc, ks, n_valid, k, plan)
        else:
            v, i = topk._launch_i8_sm90(topk._i8_sm90_kernel(), qc, qs, kc,
                                        ks, n_valid, k, plan)
        assert torch.equal(v, rv) and torch.equal(i, ri), plan
    return len(plans)


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


@pytest.fixture
def keys_i8(gen):
    """20,000 random int8 key rows of width 768 and their scales."""
    return _codes(torch.randn(20_000, 768, device="cuda", generator=gen))


# every query block of K5's plan and its ragged edge, at k = 1, 21 and 64
# (lists of 8, 32 and 64 entries): the Hopper body's 16, 32, 64 and 128
# rows past the crossing's key counts (`topk.I8_MMA_WINS`); and each
# body at each of its query blocks, on 20,000 keys with n_valid 19,937
# (19,937 % 128 = 97) and on 19,937 keys (a ragged last tile)
@pytest.mark.parametrize("k", [1, 21, 64])
@pytest.mark.parametrize("bq", [1, 15, 16, 17, 33, 64, 65, 129, 256, 257])
def test_int8_topk_every_query_block(gen, keys_i8, bq, k):
    kc, ks = keys_i8
    qc, qs = _codes(torch.randn(bq, 768, device="cuda", generator=gen))
    _same_codes(qc, qs, kc, ks, 19_937, k)
    plan = topk.plan_i8(bq, kc.shape[0], k)
    assert plan.body == "sm90"
    assert plan.qb == next((b for b in (16, 32, 64, 128) if b >= bq), 128)
    assert _each_i8_body(qc, qs, kc, ks, 19_937, k) >= 3
    kc, ks = kc[:19_937], ks[:19_937]
    _each_i8_body(qc, qs, kc, ks, 19_937, k)


# either side of the crossing's key counts (`topk.I8_MMA_WINS`): the
# mma.sync body up to 16 queries while each key split walks one tile (at
# most 16,896 keys on 132 SMs) and up to 32 from 12,288 keys; and the eval
# job's searches (960 queries over 1,920 keys, too few for the seed, in
# query blocks of 32; over 5,760 keys in blocks of 128)
@pytest.mark.parametrize("n,bq,body,qb", [
    (960, 16, "mma", 16), (12_288, 32, "mma", 32), (16_896, 1, "mma", 16),
    (16_384, 33, "sm90", 64), (16_897, 16, "sm90", 16),
    (1_920, 960, "sm90", 32), (5_760, 960, "sm90", 128)])
def test_int8_topk_body_by_the_crossing(gen, n, bq, body, qb):
    kc, ks = _codes(torch.randn(n, 768, device="cuda", generator=gen))
    qc, qs = _codes(torch.randn(bq, 768, device="cuda", generator=gen))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = topk.plan_i8(bq, n, 21, 768, sms)
    assert (plan.body, plan.qb) == (body, qb)
    _same_codes(qc, qs, kc, ks, n, 21)
    _same_codes(qc, qs, kc, ks, n - 97, 21)


def test_int8_topk_plans_agree_with_the_libraries(gen):
    """The Python plans' shared memory is each library's: csrc/topk.cu's
    for the mma.sync body, csrc/topk_i8_sm90.cu's (and its seed's groups)
    for the Hopper body."""
    kern = topk._kernel()
    for qb in (16, 32, 64):
        for d in (64, 768, 1024):
            for maxk in (8, 16, 32, 64):
                assert kern.smem_i8(qb, d, maxk) == topk.i8_mma_smem(qb, d,
                                                                     maxk)
    sm90 = topk._i8_sm90_kernel()
    tiles, stride = ctypes.c_int(), ctypes.c_int()
    for n_valid in (97, 2_687, 2_688, 19_937, 1 << 20, 5_000_000):
        for k in (1, 21, 64):
            sm90.seed(n_valid, k, ctypes.byref(tiles), ctypes.byref(stride))
            assert (tiles.value, stride.value) == topk.i8_seed(n_valid, k)
    for qb in (16, 32, 64, 128):
        for maxk in (8, 16, 32, 64):
            for stages in range(2, 9):
                assert sm90.smem(qb, maxk, stages) == topk.i8_sm90_smem(
                    qb, maxk, stages)


def test_int8_topk_sm90_refuses_a_plan_that_is_not_its_own(gen, keys_i8):
    kc, ks = keys_i8
    qc, qs = _codes(torch.randn(40, 768, device="cuda", generator=gen))
    plan = topk.plan_i8(40, kc.shape[0], 21, body="sm90")
    kern = topk._i8_sm90_kernel()
    for bad in (dataclasses.replace(plan, smem=plan.smem + 1024),
                dataclasses.replace(plan, qb=128),
                dataclasses.replace(plan, splits=plan.splits + 1),
                dataclasses.replace(plan, tiles_per_split=0),
                dataclasses.replace(plan, n_cand=plan.n_cand - 1),
                dataclasses.replace(plan, stages=9),
                dataclasses.replace(plan, seed_groups=5)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            topk._launch_i8_sm90(kern, qc, qs, kc, ks, 19_937, 21, bad)
    # no query block of 256 (its accumulators would spill)
    wide = topk.i8_sm90_plan(40, kc.shape[0], 21, 132, 128, 2)
    with pytest.raises(RuntimeError, match="CUDA error"):
        topk._launch_i8_sm90(kern, qc, qs, kc, ks, 19_937, 21,
                             dataclasses.replace(wide, qb=256))
    with pytest.raises(ValueError, match="sm90"):
        topk._launch_i8_sm90(kern, qc, qs, kc, ks, 19_937, 21,
                             topk.plan_i8(40, kc.shape[0], 21, body="mma"))
    v, i = topk._launch_i8_sm90(kern, qc, qs, kc, ks, 19_937, 21, plan)
    rv, ri = topk.topk_i8_reference(qc, qs, kc, ks, 19_937, 21)
    assert torch.equal(v, rv) and torch.equal(i, ri)


def test_int8_topk_mma_refuses_a_plan_that_is_not_its_own(gen, keys_i8):
    kc, ks = keys_i8
    qc, qs = _codes(torch.randn(40, 768, device="cuda", generator=gen))
    plan = topk.plan_i8(40, kc.shape[0], 21, body="mma")
    for bad in (dataclasses.replace(plan, qb=128),
                dataclasses.replace(plan, splits=plan.splits + 1),
                dataclasses.replace(plan, splits=plan.splits + 2),
                dataclasses.replace(plan, tiles_per_split=0),
                # n_cand as the splits need, but the splits miss keys
                dataclasses.replace(plan, splits=2, n_cand=40 * 21),
                dataclasses.replace(plan, n_cand=plan.n_cand - 1)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            topk._launch_i8_mma(qc, qs, kc, ks, 19_937, 21, bad)
    with pytest.raises(ValueError, match="mma"):
        topk._launch_i8_mma(qc, qs, kc, ks, 19_937, 21,
                            topk.plan_i8(40, kc.shape[0], 21, body="sm90"))
    v, i = topk._launch_i8_mma(qc, qs, kc, ks, 19_937, 21, plan)
    rv, ri = topk.topk_i8_reference(qc, qs, kc, ks, 19_937, 21)
    assert torch.equal(v, rv) and torch.equal(i, ri)


@pytest.mark.parametrize("d", [64, 768])
def test_int8_topk_fewer_keys_than_one_tile(gen, d):
    keys = torch.randn(100, d, device="cuda", generator=gen)
    for bq in (1, 20, 70):
        q = torch.randn(bq, d, device="cuda", generator=gen)
        for k in (1, 21, 64):
            _, i = _same_i8(q, keys, 77, k)
            assert (i < 77).all()


def test_int8_topk_width_64(gen):
    keys = torch.randn(30_000, 64, device="cuda", generator=gen)
    for bq in (1, 17, 100):
        q = torch.randn(bq, 64, device="cuda", generator=gen)
        _same_i8(q, keys, 29_999, 21)


def test_int8_topk_scores_rising_with_the_key_index(gen):
    """Collinear keys whose scales rise with the index: every query's
    scores rise along the key axis (u-like queries) or fall (-u), so each
    tile beats the last, the worst case of the running threshold."""
    n = 40_000
    u = torch.randn(1, 768, device="cuda", generator=gen)
    uc, us = _codes(u)
    kc = uc.expand(n, 768).contiguous()
    ks = us * (1 + torch.arange(n, device="cuda", dtype=torch.float32) / n)
    noise = 0.1 * torch.randn(40, 768, device="cuda", generator=gen)
    qc, qs = _codes(torch.cat([u + noise[:20], -u + noise[20:]]))
    for k in (1, 21, 64):
        for bq in (1, 16, 40):
            v, i = _same_codes(qc[:bq], qs[:bq], kc, ks, n - 3, k)
            assert i[0].tolist() == list(range(n - 4, n - 4 - k, -1))
            if bq == 40:
                assert i[39].tolist() == list(range(k))
        _each_i8_body(qc, qs, kc, ks, n - 3, k)


def test_int8_topk_duplicate_blocks_tie_at_the_threshold(gen):
    """Blocks of identical keys across tiles and key splits: their equal
    scores straddle the k-th place, so the smaller indices must win."""
    keys = torch.randn(60_000, 768, device="cuda", generator=gen)
    keys[1000:1300] = keys[5]
    keys[30_017:30_100] = keys[5]
    keys[59_900:59_990] = keys[40_000]
    q = torch.cat([keys[5:6], keys[40_000:40_001],
                   torch.randn(30, 768, device="cuda", generator=gen)])
    for k in (1, 21, 64):
        for bq in (2, 32):
            _, i = _same_i8(q[:bq], keys, 60_000, k)
            assert i[0].tolist() == ([5] + list(range(1000, 1299)))[:k]
            assert i[1].tolist() == ([40_000] + list(range(59_900,
                                                           59_990)))[:k]


@pytest.mark.parametrize("tied", ["k", "k+1", "128"])
def test_int8_topk_scores_tied_in_one_tile_at_the_threshold(gen, tied):
    """K5 on the same keys as K4's case: exactly k, k + 1 and 128 codes of
    one tile tie at the k-th place (identical codes and scales), bit-equal
    to the plain version on each body."""
    for k in (5, 21):
        m = {"k": k, "k+1": k + 1, "128": 128}[tied]
        q, keys, want = _tied_tile(gen, m, k)
        qc, qs = _codes(q)
        kc, ks = _codes(keys)
        for bq in (1, 40, 130):
            _, i = _same_codes(qc[:bq], qs[:bq], kc, ks, 40_000, k)
            assert i[0].tolist() == want
        _each_i8_body(qc, qs, kc, ks, 40_000, k)



@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_masked_attention_kernel_matches_plain(gen, dtype, tol):
    """K1m at the OpenCLIP text shapes (N = 77, and the service's 20) under
    the causal mask, and under an arbitrary dense fp32 mask; counted in
    `mask_launches`, apart from K1, and bf16 in `mask_sm90_launches` (the
    sm90 body), fp32 not."""
    d = 768
    for n, mask in ((77, causal_mask(77, "cuda")), (20, causal_mask(20, "cuda")),
                    (77, torch.randn(77, 77, device="cuda", generator=gen))):
        qkv = torch.randn(4, n, 3 * d, device="cuda", generator=gen).to(dtype)
        before = (attention.mha_packed.launches,
                  attention.mha_packed.mask_launches,
                  attention.mha_packed.mask_sm90_launches)
        out = attention.mha_packed(qkv, 12, mask=mask)
        assert (attention.mha_packed.launches,
                attention.mha_packed.mask_launches,
                attention.mha_packed.mask_sm90_launches) == (
                    before[0], before[1] + 1,
                    before[2] + int(dtype == torch.bfloat16))
        ref = attention.mha_reference(qkv[..., :d], qkv[..., d : 2 * d],
                                      qkv[..., 2 * d :], 12, mask=mask)
        assert (out.float() - ref.float()).abs().max().item() <= tol
    with pytest.raises(ValueError, match="mask"):
        attention.mha_packed(qkv, 12, mask=mask[:20, :20].contiguous())


def _score_mask(gen, kind, n):
    """An (N, N) fp32 score mask: "causal" (0 on and below the diagonal,
    -1e9 above), "dense" (standard normal) or "rows" (the causal mask with
    every third row -1e9 throughout)."""
    if kind == "dense":
        return torch.randn(n, n, device="cuda", generator=gen)
    mask = causal_mask(n, "cuda")
    if kind == "rows":
        mask[::3] = -1e9
    return mask


def _k1m_case(gen, b, n, d, heads, mask):
    """K1m through `mha_packed(mask=)` against the plain version: the max
    |error| and the (mask launches, sm90 mask launches, K1 launches) it
    counted."""
    qkv = torch.randn(b, n, 3 * d, device="cuda",
                      generator=gen).to(torch.bfloat16)
    counters = ("mask_launches", "mask_sm90_launches", "launches")
    before = [getattr(attention.mha_packed, a) for a in counters]
    out = attention.mha_packed(qkv, heads, mask=mask)
    torch.cuda.synchronize()
    launched = tuple(getattr(attention.mha_packed, a) - x
                     for a, x in zip(counters, before))
    ref = attention.mha_reference(qkv[..., :d], qkv[..., d : 2 * d],
                                  qkv[..., 2 * d :], heads, mask=mask)
    return (out.float() - ref.float()).abs().max().item(), launched


# K1m on the forward's sm90 body (packed qkv, bf16, head dim 64, the plan's
# 8 <= N <= 160): the plan's least N, the ragged and tile-boundary N (one,
# two and three query tiles), OpenCLIP's 20 and 77 and the range's end,
# under three masks.
@pytest.mark.parametrize("kind", ["causal", "dense", "rows"])
@pytest.mark.parametrize("n", [8, 16, 17, 20, 32, 33, 64, 65, 77, 128, 129,
                               160])
def test_k1m_sm90_body_matches_plain(gen, n, kind):
    """Within 2e-2, as K1 (one bf16 ulp at |o| ~ 1 is 7.8e-3, and p is
    rounded to bf16 before P.V on both sides). A whole -1e9 row scores
    every key -1e9 (q . k * scale is below its fp32 ulp there): p is
    uniform over the N keys on both sides."""
    assert attention.plan_packed_fwd(3, n, 12, 64, masked=True).body == (
        "sm90")
    err, launched = _k1m_case(gen, 3, n, 768, 12, _score_mask(gen, kind, n))
    assert launched == (1, 1, 0)
    assert err <= 2e-2


@pytest.mark.parametrize("n", [1, 2, 4, 7])
def test_k1m_sm90_body_below_the_plans_range(gen, n):
    """Below N = 8 the plan keeps the FFMA body (`SM90_MASK_MIN_N`); the sm90
    body under a forced plan (16 key rows, N - 16 of them past N) agrees
    with the plain version all the same."""
    b, d, heads = 3, 768, 12
    err, launched = _k1m_case(gen, b, n, d, heads, causal_mask(n, "cuda"))
    assert launched == (1, 0, 0)
    assert err <= 2e-2
    qkv = torch.randn(b, n, 3 * d, device="cuda",
                      generator=gen).to(torch.bfloat16)
    mask = torch.randn(n, n, device="cuda", generator=gen)
    p = qkv.data_ptr()
    out = torch.empty(b, n, d, device="cuda", dtype=torch.bfloat16)
    attention._launch_sm90((p, p + 2 * d, p + 4 * d), out, 3 * d,
                           attention.sm90_fwd_plan(b, n, heads, masked=True),
                           0.125, mask=mask)
    ref = attention.mha_reference(qkv[..., :d], qkv[..., d : 2 * d],
                                  qkv[..., 2 * d :], heads, mask=mask)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("b", [10, 64, 400])
def test_k1m_sm90_body_at_openclip_batches(gen, b):
    """The text tower's batches (training's 10, serving's 64, and more
    items than the grid's CTAs) at N = 77 and 20 under the causal mask."""
    for n in (77, 20):
        err, launched = _k1m_case(gen, b, n, 768, 12, causal_mask(n, "cuda"))
        assert launched == (1, 1, 0)
        assert err <= 2e-2


@pytest.mark.parametrize("n,hd,dtype", [
    (161, 64, torch.bfloat16), (7, 64, torch.bfloat16),
    (77, 32, torch.bfloat16), (77, 128, torch.bfloat16),
    (20, 32, torch.bfloat16), (77, 64, torch.float32),
    (20, 64, torch.float32)])
def test_k1m_outside_the_sm90_range_keeps_its_body(gen, n, hd, dtype):
    """N > 160, N < 8, head dims 32 and 128 and fp32 launch the bodies of
    csrc/mha_fwd.cu (mma.sync for bf16 above N = 32, FFMA otherwise)."""
    heads = 4
    d = heads * hd
    qkv = torch.randn(2, n, 3 * d, device="cuda", generator=gen).to(dtype)
    mask = causal_mask(n, "cuda")
    before = (attention.mha_packed.mask_launches,
              attention.mha_packed.mask_sm90_launches)
    out = attention.mha_packed(qkv, heads, mask=mask)
    assert (attention.mha_packed.mask_launches - before[0],
            attention.mha_packed.mask_sm90_launches - before[1]) == (1, 0)
    ref = attention.mha_reference(qkv[..., :d], qkv[..., d : 2 * d],
                                  qkv[..., 2 * d :], heads, mask=mask)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_k1m_sm90_body_rounds_p_to_bf16(gen):
    """q = 0 and the causal mask make row i's p = 1 / (i + 1) on its i + 1
    keys and exactly 0 past them on every side; rounded to bf16 and summed
    over v = 1 in fp32 (exact: i + 1 copies of an 8-bit value), o is the
    same bits in the kernel and the plain version, 1.0 in row 0. An
    unrounded p, or a masked key that took part, gives other bits. At
    N = 77 (two query tiles) and 160 (three)."""
    for n in (77, 160):
        b, d, heads = 2, 768, 12
        qkv = torch.zeros(b, n, 3 * d, device="cuda", dtype=torch.bfloat16)
        qkv[..., d : 2 * d] = torch.randn(b, n, d, device="cuda",
                                          generator=gen)
        qkv[..., 2 * d :] = 1.0
        mask = causal_mask(n, "cuda")
        before = attention.mha_packed.mask_sm90_launches
        out = attention.mha_packed(qkv, heads, mask=mask)
        assert attention.mha_packed.mask_sm90_launches == before + 1
        ref = attention.mha_reference(qkv[..., :d], qkv[..., d : 2 * d],
                                      qkv[..., 2 * d :], heads, mask=mask)
        assert torch.equal(out, ref)
        assert bool((out[:, 0] == 1.0).all())


def test_k1m_sm90_body_refuses_a_foreign_plan(gen):
    """The library refuses a masked launch under K1's plan (its shared
    memory has no mask rows), K1's launch under the masked plan, a mask
    with a key bias, a plan whose items differ and a mask past N = 160:
    nothing is launched."""
    b, n, d, heads = 2, 77, 768, 12
    qkv = torch.randn(b, n, 3 * d, device="cuda",
                      generator=gen).to(torch.bfloat16)
    mask = causal_mask(n, "cuda")
    p = qkv.data_ptr()
    ptrs = (p, p + 2 * d, p + 4 * d)
    plan = attention.sm90_fwd_plan(b, n, heads, masked=True)
    out = torch.full((b, n, d), 7.0, device="cuda", dtype=torch.bfloat16)
    bias = torch.zeros(b, n, device="cuda")
    for bad, kw in ((attention.sm90_fwd_plan(b, n, heads), dict(mask=mask)),
                    (plan, {}),
                    (plan, dict(mask=mask, bias=bias)),
                    (dataclasses.replace(plan, items=plan.items + 1),
                     dict(mask=mask))):
        with pytest.raises(RuntimeError, match="CUDA error"):
            attention._launch_sm90(ptrs, out, 3 * d, bad, 0.125, **kw)
    # N = 176 with a mask: refused whatever the plan says
    long = torch.randn(1, 176, 3 * d, device="cuda",
                       generator=gen).to(torch.bfloat16)
    lp = long.data_ptr()
    long_out = torch.full((1, 176, d), 7.0, device="cuda",
                          dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA error"):
        attention._launch_sm90((lp, lp + 2 * d, lp + 4 * d), long_out, 3 * d,
                               attention.sm90_fwd_plan(1, 176, heads), 0.125,
                               mask=causal_mask(176, "cuda"))
    torch.cuda.synchronize()
    assert bool((out == 7.0).all()) and bool((long_out == 7.0).all())
    attention._launch_sm90(ptrs, out, 3 * d, plan, 0.125, mask=mask)
    ref = attention.mha_reference(qkv[..., :d], qkv[..., d : 2 * d],
                                  qkv[..., 2 * d :], heads, mask=mask)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


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


def _k3m_case(gen, b, n, d, heads, dtype, mask, plan=None):
    """K3m through `mha_bwd(mask=)` (or, under a forced sm90 `plan`, the
    sm90 launch alone) against the plain version: (dqkv, its reference's
    dq, dk, dv, the (K3 launches, K3m launches, K3m sm90 launches) it
    counted)."""
    qkv = torch.randn(b, n, 3 * d, device="cuda", generator=gen).to(dtype)
    g = torch.randn(b, n, d, device="cuda", generator=gen).to(dtype)
    counters = ("launches", "mask_launches", "mask_sm90_launches")
    before = [getattr(attention.mha_bwd, a) for a in counters]
    if plan is None:
        dqkv = attention.mha_bwd(None, None, None, g, heads, packed_qkv=qkv,
                                 mask=mask)
    else:
        dqkv = attention._launch_bwd_sm90(plan, None, None, None, g,
                                          (d // heads) ** -0.5,
                                          attention._NO_DROP, qkv, mask=mask)
    torch.cuda.synchronize()
    launched = tuple(getattr(attention.mha_bwd, a) - x
                     for a, x in zip(counters, before))
    ref = attention.mha_bwd_reference(qkv[..., :d], qkv[..., d : 2 * d],
                                      qkv[..., 2 * d :], g, heads, mask=mask)
    return dqkv, ref[:3], launched


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_masked_backward_kernel_matches_plain(gen, dtype, tol):
    """K3m at the OpenCLIP text shapes (the train path's N = 20, CLIP-BPE's
    77), the sm90 body's least N (8), one-tile and tile-boundary N (32, 33,
    64) and its largest (BWD_SM90_MASK_MAX_N), under the causal mask, a
    dense random fp32 mask and the causal mask with whole -1e9 rows (p
    uniform over the N keys on both sides); counted in
    `mha_bwd.mask_launches` apart from K3, and bf16 in
    `mha_bwd.mask_sm90_launches` (K3's sm90 body), fp32 not (FFMA). Above
    the diagonal of the causal mask the probabilities are exactly 0, so k
    and v of the last key get gradient only from the last query row."""
    d = 768
    for n in (8, 20, 32, 33, 64, 77, attention.BWD_SM90_MASK_MAX_N):
        for kind in ("causal", "dense", "rows"):
            dqkv, ref, launched = _k3m_case(gen, 4, n, d, 12, dtype,
                                            _score_mask(gen, kind, n))
            assert launched == (0, 1, int(dtype == torch.bfloat16))
            _close_grads(dqkv.split(d, dim=-1), ref, tol)
    causal = causal_mask(77, "cuda")
    qkv = torch.randn(2, 77, 3 * d, device="cuda", generator=gen).to(dtype)
    g = torch.zeros(2, 77, d, device="cuda", dtype=dtype)
    g[:, :76] = torch.randn(2, 76, d, device="cuda", generator=gen).to(dtype)
    dqkv = attention.mha_bwd(None, None, None, g, 12, packed_qkv=qkv,
                             mask=causal)
    assert not dqkv[:, 76, d:].any()


@pytest.mark.parametrize("b", [10, 64, 400])
def test_k3m_sm90_body_at_openclip_batches(gen, b):
    """The text tower's training batch (10), serving's 64 and more items
    than the grid's CTAs, at N = 77 and 20 under the causal mask: on the
    body its plan names (the sm90 body but at N = 20 from B = 40,
    `BWD_MASK_MMA_FROM`), within 2e-2 * max(1, max |plain|) (one bf16 ulp
    at |x| ~ 1 is 7.8e-3; y and ds * scale are rounded to bf16 on both
    sides), a second launch bit-equal."""
    d = 768
    for n in (77, 20):
        mask = causal_mask(n, "cuda")
        sm90 = n == 77 or b == 10
        assert (attention.plan_bwd(b, n, 12, 64, masked=True).body
                == ("sm90" if sm90 else "mma"))
        dqkv, ref, launched = _k3m_case(gen, b, n, d, 12, torch.bfloat16,
                                        mask)
        assert launched == (0, 1, int(sm90))
        _close_grads(dqkv.split(d, dim=-1), ref, 2e-2)
        qkv = torch.randn(b, n, 3 * d, device="cuda",
                          generator=gen).to(torch.bfloat16)
        g = torch.randn(b, n, d, device="cuda",
                        generator=gen).to(torch.bfloat16)
        first, again = (attention.mha_bwd(None, None, None, g, 12,
                                          packed_qkv=qkv, mask=mask)
                        for _ in range(2))
        assert torch.equal(first, again)


@pytest.mark.parametrize("b,n,body", [
    (10, 1, "sm90"), (10, 12, "sm90"), (12, 1, "mma"), (12, 12, "mma"),
    (20, 13, "sm90"), (24, 16, "mma"), (32, 24, "sm90"), (40, 20, "mma"),
    (48, 28, "mma"), (56, 30, "mma"), (56, 31, "sm90")])
def test_k3m_body_by_the_crossing(gen, b, n, body):
    """Either side of `BWD_MASK_MMA_FROM` (the small N and large B where
    the mma.sync passes measured faster) K3m launches the body its plan
    names, within 2e-2 of the plain version; where that is mma.sync, the
    sm90 body under a forced plan (16 key rows at N <= 16) agrees all the
    same."""
    d = 768
    assert attention.plan_bwd(b, n, 12, 64, masked=True).body == body
    mask = torch.randn(n, n, device="cuda", generator=gen)
    dqkv, ref, launched = _k3m_case(gen, b, n, d, 12, torch.bfloat16, mask)
    assert launched == (0, 1, int(body == "sm90"))
    _close_grads(dqkv.split(d, dim=-1), ref, 2e-2)
    if body == "mma":
        dqkv, ref, _ = _k3m_case(gen, b, n, d, 12, torch.bfloat16, mask,
                                 attention.bwd_sm90_plan(b, n, 12,
                                                         masked=True))
        _close_grads(dqkv.split(d, dim=-1), ref, 2e-2)


@pytest.mark.parametrize("n", [20, 77])
def test_k3m_sm90_passes_form_the_same_scores(gen, n):
    """Pass B rebuilds p from pass A's m and 1 / l, so it must form each
    masked score as pass A did: s read out of pass A (q in wgmma's A role,
    the mask's rows staged) and of pass B (k in the A role, its columns
    staged) at every (b, h, i, j), bit for bit; both within fp32 rounding
    of q . k * scale + mask; the read-out launch's dqkv is the plain
    launch's. A dense random mask, so that every entry counts."""
    b, d, heads = 4, 768, 12
    qkv = torch.randn(b, n, 3 * d, device="cuda",
                      generator=gen).to(torch.bfloat16)
    g = torch.randn(b, n, d, device="cuda", generator=gen).to(torch.bfloat16)
    mask = torch.randn(n, n, device="cuda", generator=gen)
    s_a, s_b, dqkv = attention.bwd_sm90_scores(qkv, g, heads, mask=mask)
    torch.cuda.synchronize()
    qh, kh = (qkv[..., i * d:(i + 1) * d].float().view(b, n, heads, 64)
              for i in range(2))
    ref = torch.einsum("bnhd,bmhd->bhnm", qh, kh) * 0.125 + mask
    assert (s_a - ref).abs().max().item() <= 1e-4 * max(
        1.0, ref.abs().max().item())
    assert torch.equal(s_a, s_b)
    assert torch.equal(dqkv, attention.mha_bwd(None, None, None, g, heads,
                                               packed_qkv=qkv, mask=mask))


def test_k3m_sm90_body_refuses_a_foreign_plan(gen):
    """The library refuses a masked launch under K3's plan (its shared
    memory has no mask), K3's launch under the masked plan, a mask with
    dropout, a plan whose items differ and a mask past
    BWD_SM90_MASK_MAX_N: nothing is launched."""
    b, n, d, heads = 2, 77, 768, 12
    qkv = torch.randn(b, n, 3 * d, device="cuda",
                      generator=gen).to(torch.bfloat16)
    g = torch.randn(b, n, d, device="cuda", generator=gen).to(torch.bfloat16)
    mask = causal_mask(n, "cuda")
    plan = attention.bwd_sm90_plan(b, n, heads, masked=True)
    drop = attention._drop_args(0.1, 7, b, qkv.device)
    for bad, kw in ((attention.bwd_sm90_plan(b, n, heads), dict(mask=mask)),
                    (plan, {}),
                    (plan, dict(mask=mask, drop=drop)),
                    (dataclasses.replace(plan, items=plan.items + 1),
                     dict(mask=mask))):
        kw.setdefault("drop", attention._NO_DROP)
        with pytest.raises(RuntimeError, match="CUDA error"):
            attention._launch_bwd_sm90(bad, None, None, None, g, 0.125,
                                       packed_qkv=qkv, **kw)
    top = attention.BWD_SM90_MASK_MAX_N + 1
    long = torch.randn(1, top, 3 * d, device="cuda",
                       generator=gen).to(torch.bfloat16)
    lg = torch.randn(1, top, d, device="cuda",
                     generator=gen).to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA error"):
        attention._launch_bwd_sm90(attention.bwd_sm90_plan(1, top, heads),
                                   None, None, None, lg, 0.125,
                                   attention._NO_DROP, long,
                                   mask=causal_mask(top, "cuda"))
    dqkv = attention._launch_bwd_sm90(plan, None, None, None, g, 0.125,
                                      attention._NO_DROP, qkv, mask=mask)
    ref = attention.mha_bwd_reference(qkv[..., :d], qkv[..., d : 2 * d],
                                      qkv[..., 2 * d :], g, heads, mask=mask)
    _close_grads(dqkv.split(d, dim=-1), ref[:3], 2e-2)


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


def _mm_each_walk(q, keys, n_valid, int8=False, precision="high"):
    """K6 on the walk its plan chooses (counted there) and on each walk
    under its own plan, against the plain version: fp32 within 1e-5, int8
    bit for bit. Returns the planned launch's output."""
    mode = "int8" if int8 else precision
    bq, d = q.shape
    body = topk.plan_mm_only(bq, keys.shape[0], d, mode).body
    before = topk.mm_only.launches, getattr(topk.mm_only,
                                            f"{body}_launches")
    out = topk.mm_only(q, keys, n_valid, int8=int8, precision=precision)
    assert (topk.mm_only.launches,
            getattr(topk.mm_only, f"{body}_launches")) == (before[0] + 1,
                                                         before[1] + 1)
    ref = topk.mm_only_reference(q, keys, n_valid, int8=int8,
                                 precision=precision)
    assert out.shape == (bq, 128)
    outs = [out]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for walk in ("sm90", "mma"):
        plan = topk.plan_mm_only(bq, keys.shape[0], d, mode, sms, body=walk)
        launch = (topk._launch_mm_sm90 if walk == "sm90"
                  else topk._launch_mm_mma)
        outs.append(launch(q, keys, n_valid, mode, plan))
    for o in outs:
        if int8:
            assert torch.equal(o, ref)
        else:  # -inf rows (no valid key) equal
            torch.testing.assert_close(o, ref, atol=1e-5, rtol=0)
    return out


# K6 at every query block of its sm90 walk and its ragged edge (and on
# the mma.sync walk below the crossing), over no key, one, fewer than a
# tile and a ragged 49,001
@pytest.mark.parametrize("n_valid", [0, 1, 127, 49_001])
@pytest.mark.parametrize("bq", [1, 17, 130, 256, 1024])
def test_mm_only_kernel_matches_plain(gen, bq, n_valid):
    keys = _unit(torch.randn(50_000, 768, device="cuda", generator=gen))
    q = _unit(torch.randn(bq, 768, device="cuda", generator=gen))
    for prec in ("high", "default"):
        out = _mm_each_walk(q, keys, n_valid, precision=prec)
        if n_valid == 0:
            assert torch.isneginf(out).all()
    qc, _ = topk.quantize_rows_i8_torch(q)
    kc, _ = topk.quantize_rows_i8_torch(keys)
    out = _mm_each_walk(qc, kc, n_valid, int8=True)
    assert torch.isneginf(out).all() == (n_valid == 0)
    for mode in ("high", "default", "int8"):
        plan = topk.plan_mm_only(bq, 50_000, 768, mode)
        assert plan.body == ("sm90" if bq >= topk.MM_SM90_MIN_BQ[mode]
                             else "mma")


def test_mm_only_scores_rising_with_the_key_index(gen):
    """Keys u * (1 + i / n): each query near u scores highest on the last
    valid key, each near -u on the first, on both walks and in every
    mode."""
    n = 40_000
    u = _unit(torch.randn(1, 768, device="cuda", generator=gen))
    keys = (u * (1 + torch.arange(n, device="cuda",
                                  dtype=torch.float32)[:, None] / n))
    noise = 0.1 * torch.randn(256, 768, device="cuda", generator=gen)
    q = _unit(torch.cat([u + noise[:128], -u + noise[128:]]))
    for bq in (1, 130, 256):
        qq = q[-bq:].contiguous() if bq == 1 else q[:bq].contiguous()
        for prec in ("high", "default"):
            out = _mm_each_walk(qq, keys, n - 3, precision=prec)
            if prec == "high":  # the first or the last valid key's score
                want = qq.double() @ keys[[0, n - 4]].double().T
                assert ((out[:, 0].double() - want.amax(dim=1)).abs().max()
                        .item() <= 1e-5)
        uc, _ = topk.quantize_rows_i8_torch(u)
        qc, _ = topk.quantize_rows_i8_torch(qq)
        kc = uc.expand(n, 768).contiguous()
        _mm_each_walk(qc, kc, n - 3, int8=True)


def test_tiny_kernel_is_exact(gen):
    x = torch.randn(8, 128, device="cuda", generator=gen)
    before = topk.tiny.launches
    assert torch.equal(topk.tiny(x), topk.tiny_reference(x))
    assert topk.tiny.launches == before + 1


@pytest.mark.parametrize("n", [1, 3, 4, 1024, 1027, 4099, 70_001])
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_tiny_kernel_is_exact_at_ragged_sizes_and_offsets(gen, n, offset):
    """Offset 0: the 16-byte body (n % 4 left to single floats); 1 and 2:
    a base 4 or 8 bytes off a 16-byte boundary, the one-float body."""
    x = torch.randn(n + offset, device="cuda", generator=gen)[offset:]
    assert torch.equal(topk.tiny(x), x + 1.0)


def test_tiny_kernel_launches_on_the_current_side_stream(gen):
    """Under `torch.cuda.stream(s)` K7 is enqueued on s: its input is
    written on s after a long sleep, so a launch on another stream would
    read the zeros written before."""
    x = torch.randn(8, 128, device="cuda", generator=gen)
    staged = torch.zeros_like(x)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        staged.copy_(x)
        out = topk.tiny(staged)
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(out, x + 1.0)


def test_tiny_kernel_captured_in_a_graph_replays_new_inputs(gen):
    """K7 captured in a CUDA graph (its capture stream is a side stream),
    then replayed on inputs copied into the captured one: each replay's
    output is exactly its input + 1; the capture counts one launch, the
    replays none."""
    static_x = torch.zeros(8, 128, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        topk.tiny(static_x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = topk.tiny.launches
    with torch.cuda.graph(graph):
        static_out = topk.tiny(static_x)
    assert topk.tiny.launches == before + 1
    for _ in range(3):
        x = torch.randn(8, 128, device="cuda", generator=gen)
        static_x.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static_out, x + 1.0)
    assert topk.tiny.launches == before + 1


def test_eot_pooling_takes_the_first_maximum_on_the_card(gen):
    """The OpenCLIP text tower pools at `argmax(token_ids)`; on the card, as
    on the CPU and in JAX, ties go to the first maximum."""
    ids = torch.randint(0, 5, (64, 77), device="cuda", generator=gen)
    ids[:, 40:] = 7
    ids[3] = 2
    assert ids.argmax(dim=-1).tolist() == [40] * 3 + [0] + [40] * 60


@pytest.mark.parametrize("n", [20, 64, 133])
def test_dropout_mask_reads_out_bit_for_bit(gen, n):
    """K2d's keep mask, read out through the output at BERT-small width (8
    heads, hd 64), no bias, at N = 20, 64 and 133, on the body the plan
    chooses (the sm90 body) and on the bodies of csrc/mha_fwd.cu
    (`_launch_fwd`: FFMA at N <= 32, the mma.sync body above): q = k = 0 makes p = float32(1 / N) exactly, and in read-out r v's
    row j of every head is the unit vector e_(j - 64 r) of that head's 64
    dims for the keys 64 r <= j < 64 (r + 1), 0 for the others, so o[i,
    64 h + j - 64 r] = bf16(float32(1 / N) * keep(i, j)) exactly (0 or the
    rounded kept value) for those keys and 0 beyond."""
    b, heads, hd = 4, 8, 64
    q = torch.zeros(b, n, heads * hd, device="cuda", dtype=torch.bfloat16)
    p = torch.tensor(1.0, device="cuda") / n
    for seed in (_seeds(gen, b), 0x2545F491):
        keep = attention.dropout_keep_4d(seed, b, heads, n, 0.1,
                                         device="cuda")
        assert (keep == 0).any() and (keep != 0).any()
        for r in range(-(-n // hd)):
            j = torch.arange(r * hd, min(n, (r + 1) * hd), device="cuda")
            v = torch.zeros_like(q)
            for h in range(heads):
                v[:, j, h * hd + j - r * hd] = 1.0
            plan_out = attention.mha(q, q, v, heads, dropout_rate=0.1,
                                     dropout_seed=seed)
            old_out = torch.empty_like(q)
            attention._launch_fwd(
                (q.data_ptr(), q.data_ptr(), v.data_ptr()), old_out, b, n,
                heads, hd, heads * hd, hd ** -0.5, q.dtype, None, 0.1, seed)
            want = (p * keep[..., j]).to(torch.bfloat16)
            for out in (plan_out, old_out):
                got = out.view(b, n, heads, hd).permute(0, 2, 1, 3)
                assert torch.equal(got[..., : len(j)], want)
                assert not got[..., len(j):].any()


def test_backward_kernel_is_bit_deterministic(gen):
    """Two launches of K3 on the same inputs give bit-equal dq/dk/dv (and
    dbias): every output element has one writer and every sum a fixed
    order, in the tensor-core (bf16) and the FFMA (fp32) passes."""
    for dtype in (torch.bfloat16, torch.float32):
        qkv = torch.randn(4, 197, 3 * 768, device="cuda",
                          generator=gen).to(dtype)
        g = torch.randn(4, 197, 768, device="cuda", generator=gen).to(dtype)
        runs = [attention.mha_bwd(None, None, None, g, 12, packed_qkv=qkv)
                for _ in range(2)]
        assert torch.equal(runs[0], runs[1])
        q, k, v, g = (torch.randn(4, 20, 512, device="cuda",
                                  generator=gen).to(dtype) for _ in range(4))
        bias = torch.zeros(4, 20, device="cuda")
        bias[1, 9:] = -1e9
        seeds = _seeds(gen, 4)
        runs = [attention.mha_bwd(q, k, v, g, 8, bias=bias, dropout_rate=0.1,
                                  dropout_seed=seeds, need_dbias=True)
                for _ in range(2)]
        for a, b in zip(*runs):
            assert torch.equal(a, b)


@pytest.mark.parametrize("hd", [32, 128])
def test_bf16_bodies_at_the_other_head_dims(gen, hd):
    """The tensor-core forward and backward at head dims 32 and 128 (every
    main-path shape has 64), N = 70 (a ragged last 16-row tile), with a
    key bias, dropout and the bias gradient; and K1m's mask at N = 70."""
    heads, n = 4, 70
    d = heads * hd
    q, k, v, g = (torch.randn(3, n, d, device="cuda",
                              generator=gen).to(torch.bfloat16)
                  for _ in range(4))
    bias = torch.zeros(3, n, device="cuda")
    bias[0, 50:] = -1e9
    seeds = _seeds(gen, 3)
    kw = dict(bias=bias, dropout_rate=0.1, dropout_seed=seeds)
    out = attention.mha(q, k, v, heads, **kw)
    ref = attention.mha_reference(q, k, v, heads, **kw)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    out = attention.mha_bwd(q, k, v, g, heads, need_dbias=True, **kw)
    _close_grads(out, attention.mha_bwd_reference(q, k, v, g, heads, **kw),
                 2e-2)
    qkv = torch.cat([q, k, v], dim=-1)
    mask = causal_mask(n, "cuda")
    out = attention.mha_packed(qkv, heads, mask=mask)
    ref = attention.mha_reference(q, k, v, heads, mask=mask)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    dqkv = attention.mha_bwd(None, None, None, g, heads, packed_qkv=qkv,
                             mask=mask)
    _close_grads(dqkv.split(d, dim=-1),
                 attention.mha_bwd_reference(q, k, v, g, heads,
                                             mask=mask)[:3], 2e-2)


def test_train_transform_on_the_card_matches_the_cpu(gen):
    """The device train augmentation (crop-resize products in fp32, never
    TF32; flips; rotation; CLIP normalize; color jitter) on the card
    against the same parameters on the CPU, atol 1e-5 (fp32 sums of the
    crop-resize products in another order)."""
    from bioscan_clip_tpu_torch.data import transforms

    u8 = torch.randint(0, 256, (16, 256, 341, 3), dtype=torch.uint8,
                       device="cuda", generator=gen)
    aug = transforms.draw_train_aug(0x5EED, 16, (256, 341), jitter=True)
    kw = dict(normalize=True, jitter=True)
    out = transforms.train_transform(u8, aug, **kw)
    ref = transforms.train_transform(u8.cpu(), aug, **kw)
    assert out.shape == (16, 224, 224, 3)
    assert (out.cpu() - ref).abs().max().item() <= 1e-5


def test_gradcache_matches_the_plain_step_on_the_card(gen):
    """GradCache (2 microbatches, merged stage 1) against the plain
    full-batch step, fp32, the flagship's towers at full width and 2
    layers, B = 8, dropout 0.1: loss 1e-5 relative, gradients 1e-4 of each
    tensor's max |g| (cuBLAS may pick other products for other row
    counts)."""
    import dataclasses

    from bioscan_clip_tpu_torch.models.bert import (
        BARCODE_BERT_CONFIG,
        BERT_SMALL_CONFIG,
        BarcodeBertDnaEncoder,
        BertTextEncoder,
    )
    from bioscan_clip_tpu_torch.models.clip import MultiModalCLIP, init_weights
    from bioscan_clip_tpu_torch.models.vit import ViTConfig, ViTImageEncoder
    from bioscan_clip_tpu_torch.train.loop import (
        make_gradcache_train_step,
        make_train_step,
    )
    from bioscan_clip_tpu_torch.train.schedules import constant
    from bioscan_clip_tpu_torch.train.state import create_train_state

    def model(rank=4):
        two = dict(num_layers=2, lora_rank=rank)
        m = MultiModalCLIP(
            image_encoder=ViTImageEncoder(ViTConfig(**two)),
            dna_encoder=BarcodeBertDnaEncoder(
                dataclasses.replace(BARCODE_BERT_CONFIG, **two)),
            language_encoder=BertTextEncoder(
                dataclasses.replace(BERT_SMALL_CONFIG, **two)))
        m = init_weights(m.cuda(), seed=1)
        g = torch.Generator(device="cuda").manual_seed(2)
        with torch.no_grad():  # adapters off zero, so both halves train
            for n, p in m.named_parameters():
                if "linear_b" in n or ".w_b." in n:
                    p.normal_(0, 0.02, generator=g)
        return m

    b = 8
    mask = (torch.arange(20, device="cuda")[None]
            < torch.randint(6, 21, (b, 1), device="cuda", generator=gen))
    batch = {
        "image_u8": torch.randint(0, 256, (b, 256, 341, 3),
                                  dtype=torch.uint8, device="cuda",
                                  generator=gen),
        "dna": torch.randint(0, 1027, (b, 133), device="cuda",
                             generator=gen),
        "language": {
            "input_ids": torch.randint(0, 30522, (b, 20), device="cuda",
                                       generator=gen) * mask,
            "token_type_ids": torch.zeros(b, 20, dtype=torch.int64,
                                          device="cuda"),
            "attention_mask": mask.long()},
        "labels": torch.arange(b, device="cuda"),
    }
    runs = []
    for factory, kw in ((make_train_step, {}),
                        (make_gradcache_train_step,
                         {"accum_steps": 2, "merged_model": model(0)})):
        m = model()
        state = create_train_state(m, constant(1e-3))
        _, loss = factory(m, **kw)(state, batch, 0x1234)
        runs.append((loss.item(), {n: p.grad.clone() for n, p in
                                   m.named_parameters() if p.requires_grad}))
    (l0, g0), (l1, g1) = runs
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    for n, g in g0.items():
        assert (g1[n] - g).abs().max().item() <= 1e-4 * g.abs().max().item(), n


def test_selective_remat_launches_no_attention_forward_in_backward(gen):
    """Under every selective remat policy the backward launches K3 and no
    attention forward (K1, K2, K2d): the policy saves the attention ops'
    outputs (`bscan::mha*`); "full" launches them again."""
    import dataclasses

    from bioscan_clip_tpu_torch.models.bert import (
        BARCODE_BERT_CONFIG,
        BarcodeBertDnaEncoder,
    )
    from bioscan_clip_tpu_torch.models.clip import MultiModalCLIP, init_weights
    from bioscan_clip_tpu_torch.models.common import REMAT_POLICIES
    from bioscan_clip_tpu_torch.models.vit import ViTConfig, ViTImageEncoder
    from bioscan_clip_tpu_torch.train.loop import make_train_step
    from bioscan_clip_tpu_torch.train.schedules import constant
    from bioscan_clip_tpu_torch.train.state import create_train_state

    b = 8
    batch = {
        "image_u8": torch.randint(0, 256, (b, 224, 224, 3),
                                  dtype=torch.uint8, device="cuda",
                                  generator=gen),
        "dna": torch.randint(0, 1027, (b, 133), device="cuda",
                             generator=gen),
        "labels": torch.arange(b, device="cuda"),
    }
    fwd = (attention.mha_packed, attention.mha, attention.mha_dropout)
    for policy in REMAT_POLICIES:
        r = dict(num_layers=2, remat=True, remat_policy=policy)
        m = MultiModalCLIP(
            image_encoder=ViTImageEncoder(ViTConfig(**r), torch.bfloat16),
            dna_encoder=BarcodeBertDnaEncoder(
                dataclasses.replace(BARCODE_BERT_CONFIG, **r),
                dtype=torch.bfloat16))
        m = init_weights(m.cuda(), seed=1)
        create_train_state(m, constant(1e-3))
        m.train()
        loss = make_train_step(m).loss_fn(batch, 0x77)
        before = [f.launches for f in fwd]
        bwd = attention.mha_bwd.launches
        loss.backward()
        torch.cuda.synchronize()
        again = sum(f.launches for f in fwd) - sum(before)
        assert attention.mha_bwd.launches - bwd == 4, policy
        assert again == (4 if policy == "full" else 0), policy


def test_streamed_search_equals_resident_search(gen):
    """Keys streamed from the host in slabs (pinned staging, a copy
    stream) and keys sharded four ways on the one card give the resident
    search: fp32 "high" and "default" values atol 1e-5 and indices equal
    up to near-ties within 1e-5; int8 under "none" bit for bit."""
    import numpy as np

    from bioscan_clip_tpu_torch.parallel.mesh import create_mesh
    from bioscan_clip_tpu_torch.retrieval import engine

    n, d, k = 300_000, 768, 10
    keys = torch.randn(n, d, device="cuda", generator=gen)
    keys = torch.nn.functional.normalize(keys, dim=1).cpu().numpy()
    q = torch.nn.functional.normalize(
        torch.randn(37, d, device="cuda", generator=gen), dim=1).cpu().numpy()
    q[0] = keys[123]
    four = create_mesh(devices=["cuda"] * 4)
    for precision, rescore in (("high", "float32"), ("default", "float32"),
                               ("int8", "none"), ("int8", "float32")):
        ref = engine.topk_search(q, keys, k, precision=precision,
                                 rescore=rescore)
        streamed = engine.PreparedKeys(keys, precision=precision,
                                       rescore=rescore, normalized=True,
                                       max_device_keys=70_000)
        assert streamed.streaming and streamed.shards[0].slab == 70_000
        for pk in (streamed, engine.PreparedKeys(
                keys, precision=precision, rescore=rescore, normalized=True,
                mesh=four)):
            v, i = engine.topk_search(q, pk, k)
            if precision == "int8":
                np.testing.assert_array_equal(i, ref[1])
                np.testing.assert_array_equal(v, ref[0])
                continue
            np.testing.assert_allclose(v, ref[0], atol=1e-5)
            gap = np.full(v.shape, np.inf, np.float32)
            diff = np.abs(np.diff(ref[0], axis=1))
            gap[:, 1:] = diff
            gap[:, :-1] = np.minimum(gap[:, :-1], diff)
            np.testing.assert_array_equal(i[gap > 1e-5], ref[1][gap > 1e-5])
        assert i[0, 0] == 123


def test_kernels_and_sharded_search_on_cards_not_current(gen):
    """One process searching keys sharded over several cards: each launch
    goes to its tensor's card, not the current one. K7, K1 and K4 on
    tensors of the last card, with cuda:0 current, match their plain
    versions (K7 exactly, also on a side stream of that card), cuda:0
    staying current; keys
    sharded over the cards (the last card first) give the search on
    cuda:0, resident and streamed, fp32 "high" and "default" values atol
    1e-5 and indices up to near-ties within 1e-5, int8 under "none" bit
    for bit."""
    import numpy as np

    from bioscan_clip_tpu_torch.parallel.mesh import create_mesh
    from bioscan_clip_tpu_torch.retrieval import engine

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two CUDA devices")
    torch.cuda.set_device(0)
    last = torch.device("cuda", cards - 1)
    xt = torch.randn(8, 128, device="cuda", generator=gen).to(last)
    out = topk.tiny(xt)
    assert out.device == last and torch.cuda.current_device() == 0
    assert torch.equal(out, xt + 1.0)
    side = torch.cuda.Stream(device=last)
    side.wait_stream(torch.cuda.current_stream(last))
    with torch.cuda.stream(side):
        out = topk.tiny(xt)
    torch.cuda.current_stream(last).wait_stream(side)
    assert torch.equal(out, xt + 1.0)
    assert torch.cuda.current_device() == 0
    x = torch.randn(8, 197, 3 * 768, device="cuda", generator=gen).to(last)
    out = attention.mha_packed(x, 12)
    ref = attention.mha_reference(x[..., :768], x[..., 768:1536],
                                  x[..., 1536:], 12)
    assert out.device == last
    assert (out - ref).abs().max().item() <= 1e-5

    n, d, k = 200_000, 768, 10
    keys = torch.randn(n, d, device="cuda", generator=gen)
    keys = torch.nn.functional.normalize(keys, dim=1).cpu().numpy()
    q = torch.nn.functional.normalize(
        torch.randn(37, d, device="cuda", generator=gen), dim=1).cpu().numpy()
    q[0] = keys[123]
    qd, kd = torch.from_numpy(q).to(last), torch.from_numpy(keys).to(last)
    v, i = topk.topk(qd, kd, n, k)
    rv, _ = topk.topk_reference(qd, kd, n, k)
    torch.testing.assert_close(v, rv, atol=1e-5, rtol=0)
    assert v.device == last and i[0, 0].item() == 123
    del kd
    mesh = create_mesh(devices=[torch.device("cuda", (cards - 1 - j) % cards)
                                for j in range(4)])
    for precision, rescore in (("high", "float32"), ("default", "float32"),
                               ("int8", "none")):
        ref = engine.topk_search(q, keys, k, precision=precision,
                                 rescore=rescore, device="cuda:0")
        for limit in (None, 20_000):
            pk = engine.PreparedKeys(keys, mesh=mesh, precision=precision,
                                     rescore=rescore, normalized=True,
                                     max_device_keys=limit)
            assert pk.streaming == (limit is not None)
            assert {sh.device for sh in pk.shards} == set(mesh.devices)
            v, i = engine.topk_search(q, pk, k)
            assert torch.cuda.current_device() == 0
            if precision == "int8":
                np.testing.assert_array_equal(i, ref[1])
                np.testing.assert_array_equal(v, ref[0])
                continue
            np.testing.assert_allclose(v, ref[0], atol=1e-5)
            gap = np.full(v.shape, np.inf, np.float32)
            diff = np.abs(np.diff(ref[0], axis=1))
            gap[:, 1:] = diff
            gap[:, :-1] = np.minimum(gap[:, :-1], diff)
            np.testing.assert_array_equal(i[gap > 1e-5], ref[1][gap > 1e-5])
            assert i[0, 0] == 123


def _graph_model(remat=False, rank=4, seed=1):
    """The flagship's towers at full width and 2 layers, bf16 compute,
    adapters off zero; `remat`: per-layer remat "full"."""
    import dataclasses

    from bioscan_clip_tpu_torch.models.bert import (
        BARCODE_BERT_CONFIG,
        BERT_SMALL_CONFIG,
        BarcodeBertDnaEncoder,
        BertTextEncoder,
    )
    from bioscan_clip_tpu_torch.models.clip import MultiModalCLIP, init_weights
    from bioscan_clip_tpu_torch.models.vit import ViTConfig, ViTImageEncoder

    two = dict(num_layers=2, lora_rank=rank, remat=remat)
    bf16 = torch.bfloat16
    m = MultiModalCLIP(
        image_encoder=ViTImageEncoder(ViTConfig(**two), bf16),
        dna_encoder=BarcodeBertDnaEncoder(
            dataclasses.replace(BARCODE_BERT_CONFIG, **two), dtype=bf16),
        language_encoder=BertTextEncoder(
            dataclasses.replace(BERT_SMALL_CONFIG, **two), dtype=bf16))
    m = init_weights(m.cuda(), seed=seed)
    g = torch.Generator(device="cuda").manual_seed(2)
    with torch.no_grad():
        for n, p in m.named_parameters():
            if "linear_b" in n or ".w_b." in n:
                p.normal_(0, 0.02, generator=g)
    return m


def _graph_batches(gen, k, b=8):
    """k stacked batches of b rows: (64, 80) uint8 frames for the device
    augmentation, barcodes, padded text, labels."""
    mask = (torch.arange(20, device="cuda")[None]
            < torch.randint(6, 21, (k, b, 1), device="cuda", generator=gen))
    return {
        "image_u8": torch.randint(0, 256, (k, b, 64, 80, 3),
                                  dtype=torch.uint8, device="cuda",
                                  generator=gen),
        "dna": torch.randint(0, 1027, (k, b, 133), device="cuda",
                             generator=gen),
        "language": {
            "input_ids": torch.randint(0, 30522, (k, b, 20), device="cuda",
                                       generator=gen) * mask,
            "token_type_ids": torch.zeros(k, b, 20, dtype=torch.int64,
                                          device="cuda"),
            "attention_mask": mask.long()},
        "labels": torch.arange(b, device="cuda").repeat(k, 1),
    }


def _same_train_state(a, b):
    assert a.step == b.step
    for (name, p), q in zip(a.model.named_parameters(),
                            b.model.parameters()):
        assert torch.equal(p, q), name
        sa, sb = a.optimizer.state.get(p, {}), b.optimizer.state.get(q, {})
        assert sa.keys() == sb.keys(), name
        for key in sa:
            assert torch.equal(sa[key], sb[key]), (name, key)


def _graph_step(kind, model):
    from bioscan_clip_tpu_torch.train.loop import (
        make_gradcache_train_step,
        make_train_step,
    )

    if kind == "plain":
        return make_train_step(model, color_jitter=True)
    return make_gradcache_train_step(model, 2, color_jitter=True,
                                     merged_model=_graph_model(rank=0),
                                     s1_chunk=4)


@pytest.mark.parametrize("kind", ["plain", "gradcache"])
@pytest.mark.parametrize("remat", [False, True])
def test_graphed_steps_equal_the_eager_steps(gen, kind, remat):
    """Two calls of K = 3 steps per call (the first step warms up, the
    second is captured, the rest replay) against six eager steps of the
    same step: losses, parameters and both AdamW moments bit for bit; the
    kernels' launch counters grow by K times the captured step's launches
    in each call."""
    from bioscan_clip_tpu_torch.train.graphs import read_counters
    from bioscan_clip_tpu_torch.train.loop import (
        batch_rows,
        scan_train_steps,
    )
    from bioscan_clip_tpu_torch.train.state import create_train_state

    def lr(step):
        return 1e-3 * (1 + step)

    k = 3
    calls = [_graph_batches(gen, k) for _ in range(2)]
    seeds = [[11, 12, 13], [0xFFFFFFFF, 0, 7]]
    ref = create_train_state(_graph_model(remat), lr)
    step = _graph_step(kind, ref.model)
    ref_losses = []
    for batches, ss in zip(calls, seeds):
        for j, s in enumerate(ss):
            ref, loss = step(ref, batch_rows(batches, j), s)
            ref_losses.append(loss)
    torch.cuda.synchronize()

    state = create_train_state(_graph_model(remat), lr)
    scan = scan_train_steps(_graph_step(kind, state.model), k,
                            modules=(state.model,))
    losses = []
    for batches, ss in zip(calls, seeds):
        before = read_counters()
        state, out = scan(state, batches, ss)
        torch.cuda.synchronize()
        (graph,) = scan.graphs.graphs.values()
        assert {n: c - before[n] for n, c in read_counters().items()} == {
            n: k * c for n, c in graph.launches.items()}
        for name in ("mha_packed", "mha_dropout", "mha_bwd"):
            assert graph.launches[f"{name}.launches"] > 0, name
        losses.append(out)
    assert torch.equal(torch.cat(losses), torch.stack(ref_losses))
    _same_train_state(state, ref)


def test_a_restored_state_replays_no_stale_graph(gen, tmp_path):
    """After `restore_checkpoint` the optimizer's moments are new tensors:
    a call re-captures instead of replaying the graph that holds the old
    ones, and repeats the call that followed the checkpoint bit for bit,
    as a fresh state restored from it does."""
    from bioscan_clip_tpu_torch.train import checkpoint
    from bioscan_clip_tpu_torch.train.loop import make_scan_train_step
    from bioscan_clip_tpu_torch.train.schedules import constant
    from bioscan_clip_tpu_torch.train.state import create_train_state

    first, second = _graph_batches(gen, 3), _graph_batches(gen, 3)
    state = create_train_state(_graph_model(), constant(1e-3))
    scan = make_scan_train_step(state.model, 3)
    state, _ = scan(state, first, [1, 2, 3])
    checkpoint.save_checkpoint(str(tmp_path), state)
    state, want = scan(state, second, [4, 5, 6])
    params = [p.detach().clone() for p in state.model.parameters()]
    checkpoint.restore_checkpoint(str(tmp_path), state)
    state, again = scan(state, second, [4, 5, 6])
    assert torch.equal(again, want)
    assert all(torch.equal(p, q)
               for p, q in zip(state.model.parameters(), params))
    fresh = create_train_state(_graph_model(seed=9), constant(1e-3))
    checkpoint.restore_checkpoint(str(tmp_path), fresh)
    fresh, other = make_scan_train_step(fresh.model, 3)(fresh, second,
                                                        [4, 5, 6])
    assert torch.equal(other, want)
    _same_train_state(fresh, state)


def test_a_failed_capture_raises_naming_its_line(gen):
    """A step whose body copies from the host cannot be captured: the call
    raises, naming the line of the port that broke the capture, and runs
    no eager step in its place."""
    from bioscan_clip_tpu_torch.data import transforms
    from bioscan_clip_tpu_torch.train.graphs import StepGraphs
    from bioscan_clip_tpu_torch.train.schedules import constant
    from bioscan_clip_tpu_torch.train.state import create_train_state

    lin = torch.nn.Linear(4, 4).cuda()
    state = create_train_state(lin, constant(1e-3), disable_lora=True)
    angles = torch.rand(2)  # on the host: rotate_nearest copies cos, sin

    def body(st, batch, inputs):
        st.optimizer.zero_grad(set_to_none=True)
        x = transforms.rotate_nearest(batch["x"], angles)
        loss = lin(x.reshape(2, -1)[:, :4]).square().mean()
        loss.backward()
        st.optimizer.step()
        return loss.detach()

    def step(st, batch, seed):
        raise AssertionError("no eager step on the card")

    step.prelude = lambda st, batch, seed: {}
    step.body = body
    graphs = StepGraphs(step, [lin])
    x = torch.rand(2, 8, 8, 1, device="cuda", generator=gen)
    with pytest.raises(RuntimeError, match=r"capture of the train step "
                       r"failed at bioscan_clip_tpu_torch/data/transforms"):
        graphs.run(state, [{"x": x}] * 2, [0, 1])
    assert state.step == 1  # the warm-up ran; the captured step did not


def _fine_tune_towers(dropout=0.1, dtype=torch.bfloat16):
    """ViT-B/16 and BarcodeBERT at full width and 2 layers each, LoRA
    rank 4 (every weight trains all the same), seeded, on the card."""
    import dataclasses

    from bioscan_clip_tpu_torch.models.bert import (
        BARCODE_BERT_CONFIG,
        BarcodeBertDnaEncoder,
    )
    from bioscan_clip_tpu_torch.models.clip import init_weights
    from bioscan_clip_tpu_torch.models.vit import ViTConfig, ViTImageEncoder

    vit = ViTImageEncoder(ViTConfig(num_layers=2), dtype)
    dna = BarcodeBertDnaEncoder(dataclasses.replace(
        BARCODE_BERT_CONFIG, num_layers=2, hidden_dropout=dropout,
        attention_dropout=dropout), dtype=dtype)
    return (init_weights(vit.cuda(), seed=1),
            init_weights(dna.cuda(), seed=2))


def _plain_attention_calls():
    return attention.mha_reference.calls + attention.mha_bwd_reference.calls


def test_full_weight_classifier_step_launches_k1_and_k3(gen):
    """The supervised fine-tune's classifier step (every weight trainable,
    bf16, uint8 frames through the device train augmentation): K1 forward
    and K3 backward launched, no plain version, every parameter's .grad
    set and finite, the loss finite."""
    from bioscan_clip_tpu_torch.models.heads import EncoderWithHead
    from bioscan_clip_tpu_torch.train import fine_tuning as ft

    vit, _ = _fine_tune_towers()
    clf = EncoderWithHead(vit, 768, 797, dtype=torch.bfloat16).cuda()
    state = ft.create_fine_tune_state(clf)
    step = ft.make_classifier_train_step(clf)
    batch = {"input": torch.randint(0, 256, (8, 256, 341, 3),
                                    dtype=torch.uint8, device="cuda",
                                    generator=gen),
             "target": torch.randint(0, 797, (8,), device="cuda",
                                     generator=gen)}
    k1, k3 = attention.mha_packed.launches, attention.mha_bwd.launches
    plain = _plain_attention_calls()
    state, loss = step(state, batch, 0x5EED)
    assert attention.mha_packed.launches == k1 + 2  # one per layer
    assert attention.mha_bwd.launches == k3 + 2
    assert _plain_attention_calls() == plain
    assert torch.isfinite(loss).item()
    for n, p in clf.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), n


def test_joint_step_launches_k2d(gen):
    """The joint image + DNA step: BarcodeBERT's dropout forward K2d and
    the backward K3 launched in both towers, no plain version."""
    from bioscan_clip_tpu_torch.models.heads import EncoderWithHead
    from bioscan_clip_tpu_torch.train import fine_tuning as ft

    vit, dna = _fine_tune_towers()
    heads = [EncoderWithHead(t, 768, 797, dtype=torch.bfloat16).cuda()
             for t in (vit, dna)]
    step = ft.make_joint_classifier_train_step(*heads)
    state = ft.create_fine_tune_state(step.model)
    batch = {"image": torch.randint(0, 256, (8, 256, 341, 3),
                                    dtype=torch.uint8, device="cuda",
                                    generator=gen),
             "dna": torch.randint(3, 1027, (8, 133), device="cuda",
                                  generator=gen),
             "target": torch.randint(0, 797, (8,), device="cuda",
                                     generator=gen)}
    k2d, k3 = attention.mha_dropout.launches, attention.mha_bwd.launches
    plain = _plain_attention_calls()
    state, loss = step(state, batch, 0x5EED)
    assert attention.mha_dropout.launches == k2d + 2
    assert attention.mha_bwd.launches == k3 + 4
    assert _plain_attention_calls() == plain
    assert torch.isfinite(loss).item()


def test_insect_batches_evaluate_on_the_card_as_on_the_cpu(gen):
    """`evaluate_classifier` over batches in InsectLoader's uint8 eval
    contract ((B, 256, 341, 3) frames, label dicts; the card's machine has
    no h5py to read the loader's HDF5): fp32, the same accuracies on the
    card (K1, the device eval transform) as on the CPU (the plain
    versions)."""
    import copy

    from bioscan_clip_tpu_torch.models.heads import EncoderWithHead
    from bioscan_clip_tpu_torch.train import fine_tuning as ft

    vit, _ = _fine_tune_towers(dtype=torch.float32)
    card = EncoderWithHead(vit, 768, 7).cuda()
    cpu = copy.deepcopy(card).cpu()
    species = [f"species_{i}" for i in range(7)]
    batches = []
    for b in (16, 16, 9):
        batches.append({
            "image_u8": torch.randint(0, 256, (b, 256, 341, 3),
                                      dtype=torch.uint8, generator=gen,
                                      device="cuda").cpu().numpy(),
            "label_dicts": [{"species": species[i % 7]} for i in range(b)],
        })
    k1 = attention.mha_packed.launches
    got = ft.evaluate_classifier(card, batches, species)
    assert attention.mha_packed.launches > k1
    assert got == ft.evaluate_classifier(cpu, batches, species)
