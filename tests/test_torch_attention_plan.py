"""K1's and K1m's tile plan (`ops/attention.plan_packed_fwd`) on the CPU.

The sm90 body (`csrc/mha_fwd_sm90.cu`) runs only on the card; what
surrounds it is here: which body a shape gets, the padded key rows and
their TMA boxes, the persistent grid's walk over (batch row, head, query
tile), the shared memory (with K1m's staged mask rows), and that the
plan's constants are the kernel's.
"""

import dataclasses
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
    """bf16 at head dim 64: without a mask (K1) sm90 at 33 <= N <= 272,
    with a mask (K1m) sm90 at 1 <= N <= 160; above that K1m keeps the
    mma.sync body, and fp32 stays on FFMA (as bf16 K1 at N <= 32)."""
    bf16 = attention.plan_packed_fwd(8, n, 12, 64)
    masked = attention.plan_packed_fwd(8, n, 12, 64, masked=True)
    fp32 = attention.plan_packed_fwd(8, n, 12, 64, dtype=torch.float32)
    small = n <= 32
    assert bf16.body == ("ffma" if small else "sm90" if n <= 272 else "mma")
    assert masked.body == ("sm90" if n <= 160 else "mma")
    assert fp32.body == "ffma"
    assert attention.plan_packed_fwd(8, n, 12, 64, dtype=torch.float32,
                                     masked=True).body == "ffma"


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


@pytest.mark.parametrize("b", [1, 10, 64, 400])
@pytest.mark.parametrize("n", [1, 4, 7, 8, 16, 17, 20, 32, 33, 64, 65, 77,
                               128, 129, 160, 161])
def test_masked_plan(n, b):
    """K1m (bf16, head dim 64) on the sm90 body from N = 8 (below, the FFMA
    body measured faster) up to the range's end (160), the mma.sync body
    one past it; on the body, the keys padded to 16 in one TMA box, every
    (b, h, query tile) once, and the shared memory K1's plus the two
    consumers' 64 mask rows of key_rows + 8 fp32, within the card's 227
    KB."""
    assert (attention.SM90_MASK_MIN_N, attention.SM90_MASK_MAX_N) == (8, 160)
    plan = attention.plan_packed_fwd(b, n, HEADS, 64, masked=True)
    if not 8 <= n <= 160:
        assert plan.body == ("mma" if n > 32 else "ffma")
        return
    assert plan.body == "sm90"
    assert n <= plan.key_rows < n + 16 and plan.key_rows % 16 == 0
    assert (plan.kv_loads, plan.kv_box) == (1, plan.key_rows)
    assert plan.q_tiles == -(-n // 64)
    assert plan.grid == min(plan.items, 132)
    assert _covers_once(plan, b, HEADS)
    assert _covers_once(
        attention.plan_packed_fwd(b, n, HEADS, 64, masked=True, sms=7), b,
        HEADS)
    k1 = attention.sm90_fwd_plan(b, n, HEADS)
    assert plan == dataclasses.replace(
        k1, smem=k1.smem + 2 * 64 * (plan.key_rows + 8) * 4)
    assert plan.smem <= SMEM_LIMIT


@pytest.mark.parametrize("n,smem", [(20, 87_104), (77, 136_256),
                                    (160, 218_176)])
def test_shared_memory_with_the_mask(n, smem):
    """The masked plan's shared memory at OpenCLIP's N = 20 and 77 and at
    the range's end: the numbers the kernel's source note gives; N = 176
    (the next key row count) would need more than a block may have, as
    the note says."""
    assert attention.plan_packed_fwd(64, n, 12, 64, masked=True).smem == smem
    note = " ".join(SOURCE.read_text().split())
    assert f"{smem:,} B at N = {n}" in note
    k1 = attention.sm90_fwd_plan(64, 176, 12)
    beyond = k1.smem + 2 * attention.mask_rows_bytes(176)
    assert beyond > SMEM_LIMIT
    assert f"N = 176 would need {beyond:,} B" in note
    with pytest.raises(ValueError, match="with a mask"):
        attention.sm90_fwd_plan(64, 161, 12, masked=True)
    with pytest.raises(ValueError, match="not both"):
        attention.sm90_fwd_plan(64, 77, 12, biased=True, masked=True)


def test_masked_instantiations_cover_the_masked_plans():
    """The kernel instantiates the mask (`MASK`) up to pad16(kMaxMaskN) key
    rows, without a bias or dropout, and refuses a mask past kMaxMaskN:
    the plan's SM90_MASK_MAX_N is that constant, every masked plan's key
    rows lie within the dispatch's chunk counts and the instantiated ones,
    and its mask rows' stride is the source's."""
    text = SOURCE.read_text()
    top = int(re.search(r"constexpr int kMaxMaskN = (\d+);", text)[1])
    assert top == attention.SM90_MASK_MAX_N
    assert "MASK && 16 * KT > bscan::pad16(kMaxMaskN)" in text
    assert "(mask && (bias || drop || n > kMaxMaskN))" in text
    assert "dispatch<false, false, true>(" in text
    assert text.count(", true>(") == 1  # the mask with no bias, no dropout
    chunks = {int(k) for k in re.findall(r"BSCAN_KT\((\d+)\)", text)}
    masked = {attention.sm90_fwd_plan(8, n, 12, masked=True).key_rows // 16
              for n in range(1, top + 1)}
    assert masked == set(range(1, -(-top // 16) + 1)) and masked <= chunks
    assert re.search(r"mask_stride\(int key_rows\) \{\s+return key_rows \+ 8;",
                     text)
    assert attention.mask_rows_bytes(80) == 64 * 88 * 4


def test_cpu_tensors_with_a_mask_take_no_plan():
    """On the CPU `mha_packed(mask=)` runs the plain version: no K1m
    launch on any body."""
    from bioscan_clip_tpu_torch.models.openclip import causal_mask

    qkv = torch.randn(2, 77, 3 * 128, dtype=torch.bfloat16)
    counters = ("launches", "mask_launches", "sm90_launches",
                "mask_sm90_launches")
    before = [getattr(attention.mha_packed, a) for a in counters]
    out = attention.mha_packed(qkv, 2, mask=causal_mask(77))
    assert out.shape == (2, 77, 128)
    assert [getattr(attention.mha_packed, a) for a in counters] == before


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
