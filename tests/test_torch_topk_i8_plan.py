"""K5's launch plan (`ops/topk.plan_i8`) on the CPU.

K5's bodies run only on the card; what chooses and sizes them is here:
which body a (Bq, N, k, D) gets, the query block, the ring's depth, that
the shared memory fits an H100 block, that the key splits cover every
128-key tile once, that the candidate count is what pass 2 reads, the
seed's key groups (disjoint whole tiles of valid keys), that each body's
launch refuses the other's plan, and that the plan's constants are the
kernels' (read from the sources).
"""

import re
from pathlib import Path

import pytest
import torch

from bioscan_clip_tpu_torch.ops import topk
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

CSRC = (Path(__file__).resolve().parent.parent / "bioscan_clip_tpu_torch"
        / "csrc")
SMEM_LIMIT = 232_448  # the H100's opt-in shared memory per block


def _constant(source, name):
    m = re.search(rf"constexpr (?:int|size_t) {name} = (\d+);",
                  (CSRC / source).read_text())
    assert m, f"{name} not in {source}"
    return int(m[1])


def _maxk(k):
    return 8 if k <= 8 else 16 if k <= 16 else 32 if k <= 32 else 64


def _mma_wins(bq, n, sms=132):
    """The crossing as measured: while a split walks one tile (N / 128 <=
    the SMs), mma.sync up to 16 queries, and up to 32 from 12,288 keys."""
    return -(-n // 128) <= sms and (bq <= 16 or (bq <= 32 and n >= 12_288))


@pytest.mark.parametrize("k", [1, 5, 21, 33, 64])
@pytest.mark.parametrize("n", [97, 19_937, 1_048_576, 5_000_000])
@pytest.mark.parametrize("bq", [1, 8, 16, 17, 64, 65, 128, 256, 257, 960,
                                1024])
def test_plan(bq, n, k):
    plan = topk.plan_i8(bq, n, k)
    n_tiles = -(-n // 128)
    per = plan.tiles_per_split
    tiles = [list(range(s * per, min(n_tiles, (s + 1) * per)))
             for s in range(plan.splits)]
    # every key tile once, in order
    assert [t for split in tiles for t in split] == list(range(n_tiles))
    assert plan.smem <= SMEM_LIMIT
    maxk = _maxk(k)
    q_blocks = -(-bq // plan.qb)
    assert plan.body == ("mma" if _mma_wins(bq, n) else "sm90")
    for body in ("mma", "sm90"):
        p = topk.plan_i8(bq, n, k, body=body)
        assert p.smem <= SMEM_LIMIT
        tiles = [list(range(s * p.tiles_per_split,
                            min(n_tiles, (s + 1) * p.tiles_per_split)))
                 for s in range(p.splits)]
        assert [t for split in tiles for t in split] == list(range(n_tiles))
        q_blocks = -(-bq // p.qb)
        if body == "mma":
            assert p.qb == (16 if bq <= 16 else 32 if bq <= 32 else 64)
            assert p.splits % 2 == 0  # clusters of two splits
            assert all(tiles[: len(tiles) - 1])  # only the last may be empty
            # pass 2 reads k candidates per query and cluster
            assert p.n_cand == bq * p.splits // 2 * k
            assert p.smem == topk.i8_mma_smem(p.qb, 768, maxk)
            continue
        assert all(tiles)  # no empty split: each writes k candidates
        assert p.n_cand == bq * p.splits * k  # k per query and split
        assert p.smem == topk.i8_sm90_smem(p.qb, maxk, p.stages)
        # the seed from 32 queries up
        assert p.seed_groups == (k if bq >= topk.I8_SEED_MIN_BQ else 0)
        # as many ring stages as fit, two to eight
        assert 2 <= p.stages <= 8
        if p.stages < 8:
            assert topk.i8_sm90_smem(p.qb, maxk, p.stages + 1) > SMEM_LIMIT
        # the query block: wgmma's N, the smallest of 16, 32, 64 and 128
        # that holds Bq, else 128; at most 32 without the seed's k whole
        # tiles
        cap = 128 if n // 128 >= k else 32
        assert p.qb == next((b for b in (16, 32, 64, 128)
                             if bq <= b <= cap), cap)
        # one wave of one CTA per SM, the query blocks of a key range
        # together
        assert q_blocks * p.splits <= max(132, q_blocks)
        want = min(n_tiles, max(132 // q_blocks, 1))
        assert p.tiles_per_split == -(-n_tiles // want)


@pytest.mark.parametrize("n", [97, 960, 12_287, 12_288, 16_384, 16_385,
                               16_896, 16_897, 19_937])
@pytest.mark.parametrize("bq", [1, 16, 17, 32, 33, 64])
def test_body_either_side_of_the_crossing(bq, n):
    """mma.sync where the crossing measured it faster (I8_MMA_WINS, while
    each key split walks one tile: N / 128 <= the SMs), the Hopper body
    elsewhere; a width that is not a multiple of 128 takes mma.sync
    whatever Bq and N."""
    assert topk.I8_MMA_WINS == ((1, 16), (12_288, 32))
    assert topk.plan_i8(bq, n, 21).body == (
        "mma" if _mma_wins(bq, n) else "sm90")
    # a card of 114 SMs: one tile a split up to 14,592 keys
    assert topk.plan_i8(bq, n, 21, sms=114).body == (
        "mma" if _mma_wins(bq, n, 114) else "sm90")
    assert topk.plan_i8(bq, n, 21, d=704).body == "mma"


@pytest.mark.parametrize("k", [5, 21, 64])
@pytest.mark.parametrize("n", [960, 1_920, 2_687, 2_688, 8_191, 8_192,
                               5_760])
@pytest.mark.parametrize("bq", [33, 64, 65, 128, 960])
def test_query_block_without_the_seed(bq, n, k):
    """Over fewer than k whole key tiles the seed cannot run, and the
    Hopper body's query block is at most I8_UNSEEDED_MAX_QB = 32; with
    them, the smallest of 16-128 that holds Bq."""
    plan = topk.plan_i8(bq, n, k)
    assert topk.I8_UNSEEDED_MAX_QB == 32
    seeded = topk.i8_seed(n, k)[0] > 0
    assert seeded == (n // 128 >= k)
    least = next((b for b in (64, 128) if b >= bq), 128)
    assert plan.qb == (least if seeded else 32)
    assert plan.seed_groups == k  # the plan asks; the launch skips it


@pytest.mark.parametrize("k", [1, 21, 64])
@pytest.mark.parametrize("n_valid", [97, 2_687, 2_688, 19_937, 1_048_576,
                                     5_000_000])
def test_seed_groups(n_valid, k):
    """The seed's k groups: disjoint runs of whole tiles of valid keys (so
    each group's best is a distinct key's score), spread over keys[:n_valid]
    and at most 8 tiles each; none when there are fewer than k whole
    tiles."""
    tiles, stride = topk.i8_seed(n_valid, k)
    whole = n_valid // 128
    if whole < k:
        assert tiles == 0
        return
    assert 1 <= tiles <= min(8, stride)
    groups = [range(g * stride, g * stride + tiles) for g in range(k)]
    assert groups[-1][-1] < whole  # every key of every group valid
    assert stride == whole // k  # spread over the keys


@pytest.mark.parametrize("d", [64, 192, 768, 1024])
def test_the_width_chooses_the_body(d):
    """The Hopper body takes widths that are a multiple of 128 (its ring
    chunks are 128 bytes deep); other multiples of 64 run the mma.sync
    body."""
    plan = topk.plan_i8(256, 1 << 20, 21, d)
    assert plan.body == ("sm90" if d % 128 == 0 else "mma")
    if plan.body == "mma":
        assert plan.smem == topk.i8_mma_smem(plan.qb, d, 32)
    # the sm90 body's shared memory does not grow with d: the codes stream
    assert topk.plan_i8(256, 1 << 20, 21, d, body="sm90").smem == 199_808


def test_the_main_path_shapes():
    """The engine's int8 searches at N = 1,048,576 and 5,000,000, k = 21
    (its oversampling of k = 5): two query blocks of 128 at Bq = 256, each
    over half the key splits' ranges side by side, four stages of 128-byte
    chunks; eight stages up to Bq = 64 (16 queries a block up to Bq = 16);
    the seed's 21 groups of 8 tiles."""
    n = 1 << 20
    p = topk.plan_i8(256, n, 21)
    assert (p.body, p.qb, p.stages, p.seed_groups) == ("sm90", 128, 4, 21)
    # the worked budget: 1 KB + 4 x (128 + 128) x 128 + the lists of 128
    # queries at MAXK 32 + 512 B of query scales + 128 B of barriers
    assert p.smem == 1024 + 4 * 256 * 128 + 4 * 128 * 131 + 512 + 128
    assert (p.splits, p.tiles_per_split) == (66, 125)
    p = topk.plan_i8(64, n, 21)
    assert (p.qb, p.stages) == (64, 8)
    assert (p.splits, p.tiles_per_split) == (131, 63)
    assert (topk.plan_i8(1, n, 21).qb, topk.plan_i8(17, n, 21).qb) == (16, 32)
    p = topk.plan_i8(128, n, 21)
    assert (p.qb, p.stages) == (128, 4)
    # lists of 64 entries: three stages at 128 queries
    assert topk.plan_i8(256, n, 64).stages == 3
    assert topk.plan_i8(1024, 5_000_000, 21).splits == 16
    assert topk.i8_seed(n, 21) == (8, 390)
    # a forced query block and ring (the design sweep's configurations)
    forced = topk.i8_sm90_plan(1, n, 21, 132, 128, 3)
    assert (forced.body, forced.qb, forced.stages) == ("sm90", 128, 3)
    assert forced.smem == topk.i8_sm90_smem(128, 32, 3)
    assert topk.i8_sm90_plan(128, n, 21, 132, 128, 4) == topk.plan_i8(
        128, n, 21)
    assert topk.I8_SEED_MIN_BQ == 32
    assert [topk.plan_i8(bq, n, 21).seed_groups
            for bq in (1, 16, 31, 32, 64)] == [0, 0, 0, 21, 21]


def test_each_launch_refuses_the_other_bodys_plan():
    """On a plan of the other body (or of K4), each of K5's launches raises
    before it reaches the library."""
    qc = torch.zeros(4, 768, dtype=torch.int8)
    qs = torch.ones(4)
    kc = torch.zeros(300, 768, dtype=torch.int8)
    ks = torch.ones(300)
    sm90 = topk.plan_i8(4, 300, 5, body="sm90")
    mma = topk.plan_i8(4, 300, 5, body="mma")
    with pytest.raises(ValueError, match="sm90"):
        topk._launch_i8_sm90(None, qc, qs, kc, ks, 300, 5, mma)
    with pytest.raises(ValueError, match="sm90"):
        topk._launch_i8_sm90(None, qc, qs, kc, ks, 300, 5,
                             topk.plan_f32(4, 300, 5, "default"))
    with pytest.raises(ValueError, match="mma"):
        topk._launch_i8_mma(qc, qs, kc, ks, 300, 5, sm90)


def test_the_plan_constants_are_the_kernels():
    src = (CSRC / "topk_i8_sm90.cu").read_text()
    assert _constant("topk_i8_sm90.cu", "kTileKeys") == topk._KEY_TILE
    assert _constant("topk_i8_sm90.cu", "kAlign") == topk._I8_SM90_ALIGN
    assert (_constant("topk_i8_sm90.cu", "kBarrierBytes")
            == topk._I8_SM90_BARRIER_BYTES)
    assert (_constant("topk_i8_sm90.cu", "kMinStages"),
            _constant("topk_i8_sm90.cu", "kMaxStages")) == (
                topk._I8_SM90_STAGES)
    # barriers: full[s] and empty[s], 8 bytes each, for every stage
    assert topk._I8_SM90_BARRIER_BYTES == 2 * 8 * topk._I8_SM90_STAGES[1]
    assert _constant("topk_i8_sm90.cu", "kChunk") == topk._I8_SM90_CHUNK
    assert _constant("topk_i8_sm90.cu", "kSeedTiles") == topk._I8_SEED_TILES
    assert "(nq != 16 && nq != 32 && nq != 64 && nq != 128)" in src
    assert topk._I8_SM90_BLOCKS == (16, 32, 64, 128)
    assert "d % kChunk != 0" in src
    assert "return kAlign + (long long)stages * stage_bytes(nq) +" in src
    assert "return (kTileKeys + nq) * kChunk;" in src
    assert "stride = groups > 0 ? whole / groups : 0;" in src
    assert "tiles = stride < kSeedTiles ? stride : kSeedTiles;" in src
    assert "(long long)lists_bytes(nq, maxk) + 4 * nq + kBarrierBytes;" in src
    # the mma.sync body's chunks and stages (csrc/topk.cu)
    mma = (CSRC / "topk.cu").read_text()
    assert "constexpr int i8_dc(int qb) { return qb == 64 ? 64 : 128; }" in mma
    assert ("constexpr int i8_stages(int qb) { return qb == 64 ? 3 : 4; }"
            in mma)
    assert "return (size_t)qb * (d + 16) +" in mma
    assert _constant("topk.cu", "CLUSTER") == topk._CLUSTER
    assert _constant("topk_common.cuh", "kMaxSmem") == topk.MAX_SMEM
