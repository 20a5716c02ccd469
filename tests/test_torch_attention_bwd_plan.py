"""K3's plan (`ops/attention.plan_bwd`) on the CPU.

The sm90 body (`csrc/mha_bwd_sm90.cu`) runs only on the card; what
surrounds it is here: which body a shape, dtype, mask, bias, dropout and
bias gradient get, the padded rows and their TMA boxes, each pass's
persistent walk over (batch row, head, tile), the shared memory (with K3m's
staged mask too), and that the plan's constants are the kernel's.
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
    ({"masked": True}, "sm90"),
    ({"biased": True}, "mma"),
    ({"biased": True, "need_dbias": True}, "mma"),
    ({"need_dbias": True}, "mma"),
    ({"dropout": True}, "sm90"),
    ({"masked": True, "dropout": True}, "mma"),
    ({"masked": True, "biased": True}, "mma"),
])
@pytest.mark.parametrize("n", [20, 77, 133, 145, 197, 257])
def test_body_by_dtype_mask_and_bias(n, kw, body):
    """bf16 at head dim 64 without a key bias or its gradient: sm90 at
    33 <= N <= 272 without a mask (K3, with or without dropout), and with
    an (N, N) mask (K3m, without dropout) at BWD_SM90_MASK_MIN_N <= N <=
    BWD_SM90_MASK_MAX_N, OpenCLIP's N = 20 and 77 among them: past 144 the
    two consumers' staged mask no longer fits beside the stages;
    everything else keeps csrc/mha_bwd.cu."""
    plan = attention.plan_bwd(8, n, 12, 64, **kw)
    lo, hi = ((attention.BWD_SM90_MASK_MIN_N, attention.BWD_SM90_MASK_MAX_N)
              if kw.get("masked") else (33, 272))
    if body == "sm90" and not lo <= n <= hi:
        body = "mma"
    assert plan.body == body
    if kw.get("masked") and body == "sm90":
        assert plan == attention.bwd_sm90_plan(8, n, 12, masked=True)


@pytest.mark.parametrize("b", [1, 10])
@pytest.mark.parametrize("n,body", [(1, "sm90"), (7, "sm90"), (8, "sm90"),
                                    (20, "sm90"), (77, "sm90"),
                                    (144, "sm90"), (145, "mma")])
def test_masked_range_edges(n, body, b):
    """At the training path's batch (B = 10, and below) K3m's plan takes
    the sm90 body from N = 1 (16 key rows) to BWD_SM90_MASK_MAX_N (144),
    each of its tiles once; the sm90 plan itself ends at 144."""
    assert (attention.BWD_SM90_MASK_MIN_N,
            attention.BWD_SM90_MASK_MAX_N) == (1, 144)
    plan = attention.plan_bwd(b, n, 12, 64, masked=True)
    assert plan.body == body
    if body == "sm90":
        assert _covers_once(plan, plan.grid_a, b, 12)
        assert plan.grid_a == plan.grid_b == min(plan.items, 132)
    else:
        with pytest.raises(ValueError, match="with a mask"):
            attention.bwd_sm90_plan(b, n, 12, masked=True)


@pytest.mark.parametrize("n", list(range(1, 41)) + [77, 144])
@pytest.mark.parametrize("b", [10, 12, 16, 20, 24, 28, 32, 40, 48, 56, 64,
                               128, 400])
def test_masked_body_by_the_crossing(b, n):
    """`BWD_MASK_MMA_FROM`: the mma.sync passes at N <= 12 from B = 12
    (more items than the 132 SMs), N 13-16 from 24, N 17-24 from 40,
    N 25-28 from 48, N 29-30 from 56 (12 heads), where the crossing
    measured them faster; the sm90 body everywhere else, OpenCLIP
    training's B = 10 at every N and N = 77 at every B."""
    mma = (n <= 12 and b >= 12 or 13 <= n <= 16 and b >= 24
           or 17 <= n <= 24 and b >= 40 or 25 <= n <= 28 and b >= 48
           or 29 <= n <= 30 and b >= 56)
    plan = attention.plan_bwd(b, n, 12, 64, masked=True)
    assert plan.body == ("mma" if mma else "sm90")
    assert attention.plan_bwd(b, n, 12, 64).body == (
        "sm90" if n >= 33 else "mma")  # K3's plan does not read the table


@pytest.mark.parametrize("n", list(range(1, 145)))
def test_masked_shared_memory_fits_at_every_n(n):
    """Both passes' shared memory with the two consumers' staged mask (64
    rows of pad16(N) + 8 fp32 each) fits the card at every N the masked
    plan takes, 16-byte aligned after the barriers."""
    plan = attention.bwd_sm90_plan(10, n, 12, masked=True)
    bare = attention.bwd_sm90_plan(10, max(n, 33), 12)
    extra = 2 * attention.mask_rows_bytes(plan.key_rows)
    assert plan.smem_a <= SMEM_LIMIT and plan.smem_b <= SMEM_LIMIT
    if n >= 33:
        assert (plan.smem_a, plan.smem_b) == (bare.smem_a + extra,
                                              bare.smem_b + extra)
    assert extra == 2 * 64 * (plan.key_rows + 8) * 4 and extra % 16 == 0


@pytest.mark.parametrize("n,smem_a,smem_b", [(20, 103_488, 105_536),
                                             (77, 152_640, 156_736),
                                             (144, 218_176, 224_320)])
def test_shared_memory_at_the_masked_shapes(n, smem_a, smem_b):
    """K3m's shared memory at OpenCLIP's N = 20 and 77 and at
    BWD_SM90_MASK_MAX_N: K3's, and each pass's two consumers' mask rows or
    columns, 2 * 64 * (pad16(N) + 8) * 4 B: the numbers the kernel's
    source note gives. N = 160 (160 key rows) would need 234,560 B in pass
    A, past the card's 232,448."""
    plan = attention.plan_bwd(10, n, 12, 64, masked=True)
    assert (plan.smem_a, plan.smem_b) == (smem_a, smem_b)
    text = " ".join(SOURCE.read_text().split())
    assert f"{smem_a:,} B at N = {n}" in text
    assert f"{smem_b:,} B at N = {n}" in text
    over = (1024 + 2 * (4 * 8192 + 2 * 160 * 128) + 64
            + 2 * attention.mask_rows_bytes(160))
    assert over == 234_560 > SMEM_LIMIT
    assert f"pass A at N = 160 would need {over:,} B" in text


def test_masked_instantiations_cover_the_masked_plans():
    """The kernel instantiates pass A with the mask (`MASK`, without
    dropout) at 1-9 16-row key units and refuses a mask past kMaxMaskN or
    with dropout: the plan's BWD_SM90_MASK_MAX_N is that constant, every
    masked plan's key rows (down to N = 1) lie within the instantiated
    ones, and its mask stride is the source's."""
    text = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    top = const("kMaxMaskN")
    assert top == attention.BWD_SM90_MASK_MAX_N
    assert const("kMinMaskN") == 1 <= attention.BWD_SM90_MASK_MIN_N
    assert "(masked && drop))" in text
    assert "launch_a<KT, false, true, false>(m, a, grid, stream)" in text
    assert "launch_b<false, true, false>(m, a, p.smem_b, grid_b, s)" in text
    kts = {int(k) for k in re.findall(r"BSCAN_MASK_KT\((\d+)\)", text)}
    masked = {attention.bwd_sm90_plan(8, n, 12, masked=True).key_rows // 16
              for n in range(1, top + 1)}
    assert masked == kts == set(range(1, -(-top // 16) + 1))
    # the read-out's masked instantiations, at 80 and 32 key rows
    assert "launch_a<5, false, true, true>" in text
    assert "launch_a<2, false, true, true>" in text
    assert re.search(r"mask_stride\(int key_rows\) \{\s+return key_rows \+ 8;",
                     text)


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


def test_cpu_tensors_with_a_mask_take_no_plan():
    """On the CPU `mha_bwd(mask=)` runs the plain version: no K3m launch on
    any body."""
    from bioscan_clip_tpu_torch.models.openclip import causal_mask

    qkv = torch.randn(2, 20, 3 * 128, dtype=torch.bfloat16)
    g = torch.randn(2, 20, 128, dtype=torch.bfloat16)
    counters = ("launches", "mask_launches", "sm90_launches",
                "mask_sm90_launches")
    before = [getattr(attention.mha_bwd, a) for a in counters]
    calls = attention.mha_bwd_reference.calls
    dqkv = attention.mha_bwd(None, None, None, g, 2, packed_qkv=qkv,
                             mask=causal_mask(20))
    assert dqkv.shape == qkv.shape
    assert [getattr(attention.mha_bwd, a) for a in counters] == before
    assert attention.mha_bwd_reference.calls == calls + 1


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
