"""K4's launch plan (`ops/topk.plan_f32`) on the CPU.

K4's bodies run only on the card; what chooses and sizes them is here:
which body a (Bq, N, k, precision) gets on each side of the crossing, the
query block, that the shared memory fits an H100 block, that the key splits
cover every 128-key tile once, that the candidate count is what pass 2
reads, and that the plan's constants are the kernels' (read from the
sources).
"""

import re
from pathlib import Path

import pytest

from bioscan_clip_tpu_torch.ops import topk
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

CSRC = Path(__file__).resolve().parent.parent / "bioscan_clip_tpu_torch" / "csrc"
SMEM_LIMIT = 232_448  # the H100's opt-in shared memory per block


def _constant(source, name):
    m = re.search(rf"constexpr (?:int|size_t) {name} = (\d+);",
                  (CSRC / source).read_text())
    assert m, f"{name} not in {source}"
    return int(m[1])


def _split_tiles(plan, n_tiles):
    """The 128-key tiles each split walks: [s * per, min(n_tiles, (s + 1) *
    per))."""
    per = plan.tiles_per_split
    return [list(range(s * per, min(n_tiles, (s + 1) * per)))
            for s in range(plan.splits)]


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("k", [1, 5, 20, 32])
@pytest.mark.parametrize("n", [97, 1_920, 19_937, 1_048_576, 4_194_304])
@pytest.mark.parametrize("bq", [1, 16, 17, 33, 64, 65, 128, 129, 256, 257,
                                960, 1024])
def test_plan(bq, n, k, precision):
    plan = topk.plan_f32(bq, n, k, precision)
    n_tiles = -(-n // 128)
    tiles = _split_tiles(plan, n_tiles)
    # every key tile once, in order
    assert [t for split in tiles for t in split] == list(range(n_tiles))
    assert plan.smem <= SMEM_LIMIT
    terms = 3 if precision == "high" else 1
    maxk = 8 if k <= 8 else 16 if k <= 16 else 32
    q_blocks = -(-bq // plan.qb)
    if bq < topk.SM90_MIN_BQ[precision]:
        # below the crossing: the mma.sync body, 16 or 32 or 64 query rows
        assert plan.body == "mma"
        assert plan.qb == (16 if bq <= 16 else 32 if bq <= 32 else 64)
        assert plan.splits % 2 == 0  # clusters of two splits
        assert all(tiles[: len(tiles) - 1])  # only the last may be empty
        # pass 2 reads k candidates per query and cluster
        assert plan.n_cand == bq * plan.splits // 2 * k
        assert plan.stages == (3 if plan.qb == 64 else 4)
        return
    assert plan.body == "sm90"
    assert all(tiles)  # no empty split: each writes k candidates
    assert plan.n_cand == bq * plan.splits * k  # k per query and split
    assert plan.smem == topk.sm90_smem(plan.qb, maxk, terms, plan.stages)
    assert 2 <= plan.stages <= 4
    if plan.stages < 4:  # as many ring stages as fit
        assert topk.sm90_smem(plan.qb, maxk, terms,
                              plan.stages + 1) > SMEM_LIMIT
    # the query block: wgmma's N, at most 128 in "high" (a chunk's partial
    # sums beside the running scores), 256 in "default" where its lists fit
    assert plan.qb in ((64, 128) if precision == "high" else (64, 128, 256))
    fits = [b for b in ((64, 128) if precision == "high" else (64, 128, 256))
            if topk.sm90_smem(b, maxk, terms, 2) <= SMEM_LIMIT]
    assert plan.qb == next((b for b in fits if b >= bq), fits[-1])
    # one wave of one CTA per SM, the query blocks of a key range together
    assert q_blocks * plan.splits <= max(132, q_blocks)
    want = min(n_tiles, max(132 // q_blocks, 1))
    assert plan.tiles_per_split == -(-n_tiles // want)
    assert plan.splits <= want


def test_the_main_path_shapes():
    """The serving and eval shapes at N = 1,048,576, k = 5: one walk of the
    keys at Bq = 256 ("default") and Bq = 128 ("high")."""
    n = 1 << 20
    default = topk.plan_f32(256, n, 5, "default")
    assert (default.body, default.qb, default.stages) == ("sm90", 256, 2)
    assert default.smem == 1024 + 2 * (32768 + 256 * 128) + 4 * 256 * 83 + 64
    high = topk.plan_f32(256, n, 5, "high")
    assert (high.body, high.qb, high.stages) == ("sm90", 128, 2)
    # 8,192 tiles over 131 splits of 63 tiles (the last of 2)
    assert topk.plan_f32(128, n, 5, "high").splits == 131
    assert topk.plan_f32(64, n, 5).qb == 64
    # k = 20: the lists of 256 queries and two ring stages would not fit
    assert topk.plan_f32(256, n, 20, "default").qb == 128
    # below the crossing ("high" only), and at a width that is not a
    # multiple of 64
    assert topk.plan_f32(16, n, 5).body == "mma"
    assert topk.plan_f32(1, n, 5, "default").body == "sm90"
    assert topk.plan_f32(64, n, 5, d=96).body == "mma"
    # a forced query block and ring (the design sweep's configurations)
    forced = topk.sm90_plan(1, n, 5, "default", 132, 128, 3)
    assert (forced.body, forced.qb, forced.stages) == ("sm90", 128, 3)
    assert forced.smem == topk.sm90_smem(128, 8, 1, 3)
    assert topk.sm90_plan(128, n, 5, "default", 132, 128, 3) == (
        topk.plan_f32(128, n, 5, "default"))


def test_the_plan_constants_are_the_kernels():
    assert _constant("topk_sm90.cu", "kTileKeys") == 128
    assert _constant("topk_sm90.cu", "kChunk") == topk._SM90_CHUNK
    assert _constant("topk_sm90.cu", "kAlign") == topk._SM90_ALIGN
    assert (_constant("topk_sm90.cu", "kBarrierBytes")
            == topk._SM90_BARRIER_BYTES)
    assert _constant("topk_sm90.cu", "kMinStages") == min(topk._SM90_STAGES)
    assert _constant("topk_sm90.cu", "kMaxStages") == max(topk._SM90_STAGES)
    assert _constant("topk_common.cuh", "BUF") == topk._BUF
    assert _constant("topk_common.cuh", "kMaxSmem") == topk.MAX_SMEM
    assert _constant("topk.cu", "KT") == topk._KEY_TILE
    assert _constant("topk.cu", "CLUSTER") == topk._CLUSTER
