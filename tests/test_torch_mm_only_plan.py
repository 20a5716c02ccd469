"""K6's launch plan (`ops/topk.plan_mm_only`) on the CPU.

K6's walks run only on the card; what chooses and sizes them is here: the
walk a (Bq, N, D, mode) gets on each side of the crossing, the query block,
the ring's depth, that the shared memory fits an H100 block and is what
each launch check computes, that the key splits cover every 128-key tile
once, that each launch refuses the other walk's plan, and that the plan's
constants are the kernels' (read from the sources).
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
MODES = ("high", "default", "int8")


def _tiles(plan, n_tiles):
    per = plan.tiles_per_split
    return [list(range(s * per, min(n_tiles, (s + 1) * per)))
            for s in range(plan.splits)]


def _rowmax_smem(qb, mode, stages):
    """rowmax_smem_bytes of csrc/topk_sm90.cu (fp32: 1 KB of alignment,
    stages x (32 KB of keys + terms x qb x 128 B of query pieces), 64 B of
    barriers) and csrc/topk_i8_sm90.cu (int8: 1 KB, stages x (128 + qb) x
    128 B of codes, 128 B of barriers)."""
    if mode == "int8":
        return 1024 + stages * (128 + qb) * 128 + 128
    terms = 3 if mode == "high" else 1
    return 1024 + stages * (32_768 + terms * qb * 128) + 64


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [1, 127, 128, 19_937, 1_048_576])
@pytest.mark.parametrize("bq", [1, 16, 17, 64, 256, 1024])
def test_plan(bq, n, mode):
    plan = topk.plan_mm_only(bq, n, 768, mode)
    n_tiles = -(-n // 128)
    for p in (plan, topk.plan_mm_only(bq, n, 768, mode, body="sm90"),
              topk.plan_mm_only(bq, n, 768, mode, body="mma")):
        tiles = _tiles(p, n_tiles)
        # every key tile once, in order
        assert [t for split in tiles for t in split] == list(range(n_tiles))
        assert p.smem <= SMEM_LIMIT
    assert plan.body == ("sm90" if bq >= topk.MM_SM90_MIN_BQ[mode]
                         else "mma")
    sm90 = topk.plan_mm_only(bq, n, 768, mode, body="sm90")
    assert all(_tiles(sm90, n_tiles))  # no empty split
    blocks = {"high": (64, 128), "default": (64, 128, 256),
              "int8": (16, 32, 64, 128)}[mode]
    assert sm90.qb == next((b for b in blocks if b >= bq), blocks[-1])
    # as many ring stages as fit, within each kernel's 2-4 (fp32) or 2-8
    assert sm90.smem == _rowmax_smem(sm90.qb, mode, sm90.stages)
    most = 8 if mode == "int8" else 4
    assert 2 <= sm90.stages <= most
    if sm90.stages < most:
        assert _rowmax_smem(sm90.qb, mode, sm90.stages + 1) > SMEM_LIMIT
    # one wave of one CTA per SM, the query blocks of a key range together
    q_blocks = -(-bq // sm90.qb)
    want = min(n_tiles, max(132 // q_blocks, 1))
    assert sm90.tiles_per_split == -(-n_tiles // want)
    mma = topk.plan_mm_only(bq, n, 768, mode, body="mma")
    assert mma.qb == (16 if bq <= 16 else 32 if bq <= 32 else 64)
    assert mma.splits % 2 == 0  # K4's and K5's clusters of two splits
    assert (mma.splits - 2) * mma.tiles_per_split < n_tiles
    assert mma.stages == (3 if mma.qb == 64 else 4)


@pytest.mark.parametrize("mode", MODES)
def test_the_walk_either_side_of_the_crossing(mode):
    """The sm90 walk from MM_SM90_MIN_BQ[mode] queries up ("high" keeps
    mma.sync below 17 queries, as K4 does; "default" and int8 take the sm90
    walk from one query), and widths the Hopper bodies do not take on the
    mma.sync walks: fp32 not a multiple of 64, int8 not of 128."""
    assert topk.MM_SM90_MIN_BQ == {"high": 17, "default": 1, "int8": 1}
    least = topk.MM_SM90_MIN_BQ[mode]
    if least > 1:
        assert topk.plan_mm_only(least - 1, 1 << 20, 768, mode).body == "mma"
    assert topk.plan_mm_only(least, 1 << 20, 768, mode).body == "sm90"
    for d in (64, 96, 128, 192, 704, 768, 1024):
        ok = d % (128 if mode == "int8" else 64) == 0
        assert topk.plan_mm_only(256, 1 << 20, d, mode).body == (
            "sm90" if ok else "mma")
    with pytest.raises(ValueError, match="mode"):
        topk.plan_mm_only(1, 100, 768, "highest")


def test_the_main_path_shapes():
    """The probe's Bq = 256 over 1,048,576 keys at D = 768: "default" one
    block of 256 queries with three stages of 64 KB (32 KB of keys, 32 KB
    of query pieces), "high" blocks of 128 with two of 80 KB, int8 blocks
    of 128 with seven of 32 KB; the numbers each launch check computes."""
    n = 1 << 20
    got = {m: topk.plan_mm_only(256, n, 768, m) for m in MODES}
    assert got["default"] == topk.MMPlan("sm90", 256, 131, 63, 3, 197_696)
    assert got["high"] == topk.MMPlan("sm90", 128, 66, 125, 2, 164_928)
    assert got["int8"] == topk.MMPlan("sm90", 128, 66, 125, 7, 230_528)
    # Bq = 1: "high" on mma.sync (16 queries, the mma plan's 256 splits),
    # the others on the sm90 walk at their least block with the most stages
    assert topk.plan_mm_only(1, n, 768, "high") == topk.MMPlan(
        "mma", 16, 256, 32, 4, 78_080)
    assert topk.plan_mm_only(1, n, 768, "default") == topk.MMPlan(
        "sm90", 64, 131, 63, 4, 164_928)
    assert topk.plan_mm_only(1, n, 768, "int8") == topk.MMPlan(
        "sm90", 16, 131, 63, 8, 148_608)
    assert topk.plan_mm_only(64, n, 768, "high") == topk.MMPlan(
        "sm90", 64, 131, 63, 4, 230_464)
    assert topk.plan_mm_only(1024, n, 768, "default").splits == 33
    # the mma.sync walks' shared memory (csrc/topk.cu bscan_mm_only_smem):
    # int8 at 64 queries, 3 stages of 64-byte chunks
    assert topk.plan_mm_only(64, n, 768, "int8", body="mma").smem == (
        64 * (768 + 16) + 3 * 128 * (64 + 16) + 32 * 64)
    # a forced block (the probe's K6 at K4's query block)
    assert topk.mm_sm90_plan(256, n, "high", 132, 64, 4) == topk.MMPlan(
        "sm90", 64, 33, 249, 4, 230_464)


def test_each_launch_refuses_the_other_walks_plan():
    """On a plan of the other walk (or a top-k plan), each of K6's launches
    raises before it reaches a library."""
    q = torch.zeros(4, 768)
    keys = torch.zeros(300, 768)
    sm90 = topk.plan_mm_only(4, 300, 768, "default", body="sm90")
    mma = topk.plan_mm_only(4, 300, 768, "default", body="mma")
    with pytest.raises(ValueError, match="sm90"):
        topk._launch_mm_sm90(q, keys, 300, "default", mma)
    with pytest.raises(ValueError, match="sm90"):
        topk._launch_mm_sm90(q, keys, 300, "default",
                             topk.plan_f32(4, 300, 5, "default"))
    with pytest.raises(ValueError, match="mma"):
        topk._launch_mm_mma(q, keys, 300, "default", sm90)


def _source(name):
    return (CSRC / name).read_text()


def test_the_plan_constants_are_the_kernels():
    f32, i8, mma = (_source("topk_sm90.cu"), _source("topk_i8_sm90.cu"),
                    _source("topk.cu"))
    # the row-max launch's shared memory: the ring and the barriers
    assert ("return kAlign + (long long)stages * stage_bytes(nq, terms) + "
            "kBarrierBytes;" in f32)
    assert ("return kAlign + (long long)stages * stage_bytes(nq) + "
            "kBarrierBytes;" in i8)
    for src in (f32, i8):
        assert "smem != rowmax_smem_bytes(nq, " in src
        assert "(long long)(splits - 1) * tiles_per_split >= n_tiles ||" in src
    assert "(nq != 64 && nq != 128 && nq != 256) || (terms == 3 && nq > 128)" \
        in f32
    assert "(nq != 16 && nq != 32 && nq != 64 && nq != 128) ||" in i8
    for src, stages, mode in ((f32, (2, 4), "high"), (i8, (2, 8), "int8")):
        for name, want in zip(("kMinStages", "kMaxStages"), stages):
            m = re.search(rf"constexpr int {name} = (\d+);", src)
            assert m and int(m[1]) == want
        assert topk._MM_SM90_STAGES[mode] == stages
    assert topk._MM_SM90_STAGES["default"] == (2, 4)
    assert topk._MM_SM90_BLOCKS["int8"] == (16, 32, 64, 128)
    # the mma.sync walks' check and shared memory
    assert "smem != bscan_mm_only_smem(qb, d, mode)" in mma
    assert "(long long)(splits - CLUSTER) * tiles_per_split >= n_tiles ||" \
        in mma
    assert "sizeof(float) * 8 * qb);" in mma
    # pass 2 is shared by the three walks
    assert "mm_only_pass2(" in _source("topk_common.cuh")
    for src in (f32, i8, mma):
        assert "mm_only_pass2<<<bq, 128, 0, s>>>(part, splits, out);" in src
