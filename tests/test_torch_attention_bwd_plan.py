"""K3's plan (`ops/attention.plan_bwd`) on the CPU.

The sm90 body (`csrc/mha_bwd_sm90.cu`) runs only on the card; what
surrounds it is here: which body a shape, dtype, mask, bias and bias
gradient get, the padded rows and their TMA boxes, each pass's persistent
walk over (batch row, head, tile), the shared memory, and that the plan's
constants are the kernel's.
"""

import re
from pathlib import Path

import pytest
import torch

from bioscan_clip_tpu_torch.ops import attention
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SOURCE = (Path(__file__).resolve().parent.parent / "bioscan_clip_tpu_torch"
          / "csrc" / "mha_bwd_sm90.cu")
HEADS = 3
SMEM_LIMIT = 227 * 1024  # the H100's opt-in shared memory per block


def _tiles(plan, cta, grid):
    """(batch row, head, tile) of every tile CTA `cta` of a pass computes,
    as the kernel walks them: items cta, cta + grid, ..., item = (b * heads
    + h) * pairs + pair, tiles 2 * pair and 2 * pair + 1 (when there is
    one)."""
    pairs = -(-plan.tiles // 2)
    for item in range(cta, plan.items, grid):
        pair, bh = item % pairs, item // pairs
        for tile in (2 * pair, 2 * pair + 1):
            if tile < plan.tiles:
                yield bh // plan.heads, bh % plan.heads, tile


def _covers_once(plan, grid, b, heads):
    seen = [t for cta in range(grid) for t in _tiles(plan, cta, grid)]
    want = {(i, h, tile) for i in range(b) for h in range(heads)
            for tile in range(-(-plan.n // 64))}
    return len(seen) == len(want) and set(seen) == want


@pytest.mark.parametrize("b", [1, 8, 400])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("n", [20, 32, 33, 65, 133, 197, 200, 256, 257, 272,
                               273])
def test_plan_covers_every_tile_once(n, packed, b):
    plan = attention.plan_bwd(b, n, HEADS, 64, packed=packed)
    if not 33 <= n <= 272:
        # the mma.sync passes of csrc/mha_bwd.cu: N <= 32 or N > 272
        assert plan.body == "mma"
        assert (plan.grid_a, plan.grid_b, plan.items, plan.smem_a,
                plan.smem_b) == (0, 0, 0, 0, 0)
        return
    assert plan.body == "sm90"
    # rows padded to 16, within two TMA boxes of at most 256 rows
    assert n <= plan.key_rows < n + 16 and plan.key_rows % 16 == 0
    assert plan.box <= 256 and plan.loads == (1 if plan.key_rows <= 256
                                              else 2)
    assert plan.box * plan.loads == plan.key_rows
    assert plan.box % 8 == 0  # each box starts on a 1024-byte swizzle atom
    assert plan.tiles == -(-n // 64) and plan.rows == 64 * plan.tiles
    assert plan.rows >= plan.key_rows  # pass B reads stats up to key_rows
    assert plan.threads == 256
    # both passes: every (b, h, tile) exactly once, on the card's 132 SMs
    # and on a grid small enough that each CTA walks several items
    assert plan.grid_a == plan.grid_b == min(plan.items, 132)
    assert _covers_once(plan, plan.grid_a, b, HEADS)
    small = attention.plan_bwd(b, n, HEADS, 64, packed=packed, sms=7)
    assert _covers_once(small, small.grid_b, b, HEADS)


@pytest.mark.parametrize("n", list(range(33, 273)))
def test_shared_memory_fits_at_every_n(n):
    plan = attention.plan_bwd(400, n, 12, 64)
    assert plan.body == "sm90"
    assert plan.smem_a <= SMEM_LIMIT and plan.smem_b <= SMEM_LIMIT
    # the statistics planes sit 16-byte aligned for their bulk copy, and
    # every stage of pass B starts on a 1024-byte swizzle atom
    assert (plan.rows * 4) % 16 == 0
    assert (plan.smem_b - 1024 - 64) % (2 * 1024) == 0


@pytest.mark.parametrize("kw,body", [
    ({}, "sm90"),
    ({"packed": False}, "sm90"),
    ({"dtype": torch.float32}, "ffma"),
    ({"dtype": torch.float32, "masked": True}, "ffma"),
    ({"masked": True}, "mma"),
    ({"biased": True}, "mma"),
    ({"biased": True, "need_dbias": True}, "mma"),
    ({"need_dbias": True}, "mma"),
])
@pytest.mark.parametrize("n", [20, 77, 133, 197, 257])
def test_body_by_dtype_mask_and_bias(n, kw, body):
    """bf16 at head dim 64 and 33 <= N <= 272 without a mask (K3m), a key
    bias or its gradient: sm90; everything else keeps csrc/mha_bwd.cu."""
    plan = attention.plan_bwd(8, n, 12, 64, **kw)
    if body == "sm90" and n <= 32:
        body = "mma"
    assert plan.body == body


@pytest.mark.parametrize("hd", [32, 128])
def test_other_head_dims_keep_the_mma_body(hd):
    assert attention.plan_bwd(8, 197, 12, hd).body == "mma"


@pytest.mark.parametrize("n,smem_a,smem_b", [(197, 173_120, 179_264),
                                             (272, 205_888, 214_080)])
def test_shared_memory_at_the_vit_shapes(n, smem_a, smem_b):
    """Pass A: two stages of (two Q and two G tiles + K_h + V_h), pass B:
    two stages of (two K and two V tiles + Q_h + G_h + the statistics,
    rounded to 1 KB), the barriers and 1 KB of alignment slack: the numbers
    the kernel's source note gives."""
    plan = attention.plan_bwd(400, n, 12, 64)
    assert (plan.smem_a, plan.smem_b) == (smem_a, smem_b)
    text = " ".join(SOURCE.read_text().split())
    assert f"{smem_a:,} B at N = {n}" in text
    assert f"{smem_b:,} B at N = {n}" in text


def test_plan_constants_are_the_kernels():
    """The plan's twin constants equal the kernel's (`make_plan`), which
    refuses a launch whose plan differs."""
    text = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert const("kHeadDim") == attention.SM90_HEAD_DIM
    assert (const("kMinN"), const("kMaxN")) == (attention.BWD_SM90_MIN_N,
                                                attention.BWD_SM90_MAX_N)
    assert const("kTileRows") == attention._TILE_ROWS
    assert const("kConsumers") == attention._CONSUMERS
    assert const("kStages") == attention._STAGES
    assert const("kMaxBox") == attention._TMA_MAX_BOX
    assert const("kAlign") == attention._ALIGN
    assert const("kBarrierBytes") == attention._BARRIER_BYTES
    assert const("kStats") == attention._STATS
    assert re.search(r"constexpr int kThreads = 128 \* kConsumers;", text)
    assert 128 * const("kConsumers") == attention._BWD_THREADS
    # the instantiations of pass A reach the plan's largest N exactly
    kts = [int(x) for x in re.findall(r"BSCAN_KT\((\d+)\)", text)]
    assert max(kts) == -(-attention.BWD_SM90_MAX_N // 16)
    assert min(kts) == -(-attention.BWD_SM90_MIN_N // 16)


def test_cpu_tensors_take_no_plan():
    """On the CPU `mha_bwd` runs the plain version at any shape: no kernel
    launch, no sm90 launch."""
    qkv = torch.randn(2, 197, 3 * 128, dtype=torch.bfloat16)
    g = torch.randn(2, 197, 128, dtype=torch.bfloat16)
    before = (attention.mha_bwd.launches, attention.mha_bwd.sm90_launches,
              attention.mha_bwd_reference.calls)
    dqkv = attention.mha_bwd(None, None, None, g, 2, packed_qkv=qkv)
    assert dqkv.shape == qkv.shape
    assert (attention.mha_bwd.launches, attention.mha_bwd.sm90_launches,
            attention.mha_bwd_reference.calls) == (before[0], before[1],
                                                   before[2] + 1)
