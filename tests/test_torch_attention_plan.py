"""K1's tile plan (`ops/attention.plan_packed_fwd`) on the CPU.

The sm90 body (`csrc/mha_fwd_sm90.cu`) runs only on the card; what
surrounds it is here: which body a shape gets, the padded key rows and
their TMA boxes, the persistent grid's walk over (batch row, head, query
tile), the shared memory, and that the plan's constants are the kernel's.
"""

import re
from pathlib import Path

import pytest
import torch

from bioscan_clip_tpu_torch.ops import attention
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SOURCE = (Path(__file__).resolve().parent.parent / "bioscan_clip_tpu_torch"
          / "csrc" / "mha_fwd_sm90.cu")
HEADS = 3
SMEM_LIMIT = 227 * 1024  # the H100's opt-in shared memory per block


def _tiles(plan, cta):
    """(batch row, head, query tile) of every tile CTA `cta` computes, as
    the kernel walks them: items cta, cta + grid, ..., item = (b * heads +
    h) * pairs + pair, tiles 2 * pair and 2 * pair + 1 (when there is
    one)."""
    pairs = -(-plan.q_tiles // 2)
    for item in range(cta, plan.items, plan.grid):
        pair, bh = item % pairs, item // pairs
        for tile in (2 * pair, 2 * pair + 1):
            if tile < plan.q_tiles:
                yield bh // plan.heads, bh % plan.heads, tile


def _covers_once(plan, b, heads):
    seen = [t for cta in range(plan.grid) for t in _tiles(plan, cta)]
    want = {(i, h, tile) for i in range(b) for h in range(heads)
            for tile in range(plan.q_tiles)}
    return len(seen) == len(want) and set(seen) == want


@pytest.mark.parametrize("b", [1, 8, 24, 400])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("n", [33, 64, 65, 197, 256, 257, 272, 273])
def test_plan(n, hd, b):
    plan = attention.plan_packed_fwd(b, n, HEADS, hd)
    if hd != 64 or n > 272:
        # the mma.sync body of csrc/mha_fwd.cu: another head dim, or N > 272
        assert plan.body == "mma"
        assert (plan.grid, plan.items, plan.smem) == (0, 0, 0)
        return
    assert plan.body == "sm90"
    # keys padded to 16, within two TMA boxes of at most 256 rows
    assert n <= plan.key_rows < n + 16 and plan.key_rows % 16 == 0
    assert plan.kv_box <= 256 and plan.kv_loads in (1, 2)
    assert plan.kv_box * plan.kv_loads == plan.key_rows
    assert plan.kv_loads == (1 if plan.key_rows <= 256 else 2)
    assert plan.kv_box % 8 == 0  # each box starts on a 1024-byte swizzle atom
    assert plan.q_tiles == -(-n // 64)
    # every (b, h, query tile) exactly once, on the card's 132 SMs and on a
    # grid small enough that each CTA walks several items
    assert plan.grid == min(plan.items, 132)
    assert _covers_once(plan, b, HEADS)
    assert _covers_once(
        attention.plan_packed_fwd(b, n, HEADS, hd, sms=7), b, HEADS)
    assert plan.smem <= SMEM_LIMIT


@pytest.mark.parametrize("n", [20, 32, 33, 197, 257, 272, 273])
def test_body_by_dtype_and_mask(n):
    """bf16 without a mask at head dim 64 and 33 <= N <= 272: sm90; a mask
    (K1m) or fp32 stay on the bodies of csrc/mha_fwd.cu (FFMA for fp32 and
    bf16 at N <= 32)."""
    bf16 = attention.plan_packed_fwd(8, n, 12, 64)
    masked = attention.plan_packed_fwd(8, n, 12, 64, masked=True)
    fp32 = attention.plan_packed_fwd(8, n, 12, 64, dtype=torch.float32)
    small = n <= 32
    assert bf16.body == ("ffma" if small else "sm90" if n <= 272 else "mma")
    assert masked.body == ("ffma" if small else "mma")
    assert fp32.body == "ffma"


@pytest.mark.parametrize("n,smem", [(197, 156_736), (272, 189_504)])
def test_shared_memory_at_the_vit_shapes(n, smem):
    """Two stages of (two Q tiles + K_h + V_h), two O tiles, barriers and
    1 KB of alignment slack: the numbers the kernel's source note gives."""
    assert attention.plan_packed_fwd(256, n, 12, 64).smem == smem
    assert f"{smem:,} B at N = {n}" in " ".join(SOURCE.read_text().split())


def test_plan_constants_are_the_kernels():
    """The plan's twin constants equal the kernel's (`make_plan`), which
    refuses a launch whose plan differs."""
    text = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert const("kHeadDim") == attention.SM90_HEAD_DIM
    assert (const("kMinN"), const("kMaxN")) == (attention.SM90_BODY_MIN_N,
                                                attention.SM90_MAX_N)
    # the plans' range lies within the body's
    assert attention.SM90_BODY_MIN_N <= attention.SM90_MIN_N
    assert const("kTileRows") == attention._TILE_ROWS
    assert const("kConsumers") == attention._CONSUMERS
    assert const("kStages") == attention._STAGES
    assert const("kMaxBox") == attention._TMA_MAX_BOX
    assert const("kAlign") == attention._ALIGN
    assert const("kBarrierBytes") == attention._BARRIER_BYTES


def test_cpu_tensors_take_no_plan():
    """On the CPU `mha_packed` runs the plain version at any shape: no
    kernel launch, no sm90 launch."""
    qkv = torch.randn(2, 197, 3 * 128, dtype=torch.bfloat16)
    before = (attention.mha_packed.launches,
              attention.mha_packed.sm90_launches)
    out = attention.mha_packed(qkv, 2)
    assert out.shape == (2, 197, 128)
    assert (attention.mha_packed.launches,
            attention.mha_packed.sm90_launches) == before
