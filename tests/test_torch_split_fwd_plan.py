"""K2's and K2d's plan on the forward's Hopper body
(`ops/attention.plan_split_fwd`, `sm90_fwd_plan`) on the CPU.

The sm90 body (`csrc/mha_fwd_sm90.cu`) runs only on the card; what
surrounds it is here: which body each (layout, dtype, N, head dim, bias,
dropout, batch x heads) gets, either side of the crossings where the
mma.sync body was measured faster, the padded key rows and their TMA boxes, the staged bias
rows in the shared memory, the persistent grid's walk over
(batch row, head, query tile), and that the plan's constants are the
kernel's. K1's
packed layout keeps its own plan (`tests/test_torch_attention_plan.py`).
"""

import re
from pathlib import Path

import pytest
import torch

from bioscan_clip_tpu_torch.ops import attention
from test_torch_attention_plan import SMEM_LIMIT, _covers_once
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SOURCE = (Path(__file__).resolve().parent.parent / "bioscan_clip_tpu_torch"
          / "csrc" / "mha_fwd_sm90.cu")
HEADS = 3


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("n", [1, 16, 17, 20, 32, 33, 133, 272, 273])
@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 64),
                                      (torch.bfloat16, 32),
                                      (torch.bfloat16, 128),
                                      (torch.float32, 64)])
def test_body(dtype, hd, n, biased, dropout):
    """Split q/k/v at 8 x 12 (row, head) pairs, short of every crossing
    below: the sm90 body for bf16 at head dim 64 and N <= 272,
    with or without a key bias and dropout; else the bodies of
    csrc/mha_fwd.cu (mma.sync for bf16 above N = 32, FFMA for fp32 and at
    N <= 32). The packed layout (K1) starts the sm90 body at N = 33."""
    split = attention.plan_split_fwd(8, n, 12, hd, dtype, biased, dropout)
    packed = attention.plan_packed_fwd(8, n, 12, hd, dtype)
    bf16_64 = dtype == torch.bfloat16 and hd == 64
    old = "mma" if dtype == torch.bfloat16 and n > 32 else "ffma"
    assert split.body == ("sm90" if bf16_64 and n <= 272 else old)
    assert packed.body == ("sm90" if bf16_64 and 33 <= n <= 272 else old)
    if split.body != "sm90":
        assert (split.grid, split.items, split.smem) == (0, 0, 0)


# Each side of every crossing of `SPLIT_MMA_FROM` (the mma.sync body
# measured faster, tools/sweep_k2_sm90.py --crossing at 12 heads): (N, B,
# heads, biased, dropout, body). BarcodeBERT's K2d at the training batch of
# 400 and from 256 takes the mma.sync body; its GradCache chunks of 100,
# its K2, its neighbours N = 128 and 145, the biased K2d and BERT-small
# keep the sm90 body; the ties at N = 33 without a bias stay on it.
@pytest.mark.parametrize("n,b,heads,biased,dropout,body", [
    (133, 400, 12, False, True, "mma"),
    (133, 256, 12, False, True, "mma"),
    (133, 255, 12, False, True, "sm90"),
    (133, 100, 12, False, True, "sm90"),
    (129, 400, 12, False, True, "mma"),
    (144, 400, 12, False, True, "mma"),
    (128, 400, 12, False, True, "sm90"),
    (145, 400, 12, False, True, "sm90"),
    (133, 400, 12, True, True, "sm90"),
    (133, 400, 12, False, False, "sm90"),
    (133, 384, 8, False, True, "mma"),
    (133, 383, 8, False, True, "sm90"),
    (20, 400, 8, True, True, "sm90"),
    (20, 400, 8, True, False, "sm90"),
    (33, 128, 12, True, False, "mma"),
    (33, 127, 12, True, False, "sm90"),
    (40, 256, 12, True, False, "mma"),
    (34, 255, 12, True, False, "sm90"),
    (41, 512, 12, True, False, "sm90"),
    (33, 256, 12, True, True, "mma"),
    (33, 255, 12, True, True, "sm90"),
    (40, 400, 12, True, True, "mma"),
    (34, 399, 12, True, True, "sm90"),
    (33, 512, 12, False, False, "sm90"),
    (33, 512, 12, False, True, "sm90"),
    (32, 512, 12, True, True, "sm90"),
    (256, 400, 12, False, True, "sm90"),
    (272, 512, 12, False, True, "sm90"),
])
def test_body_either_side_of_the_crossing(n, b, heads, biased, dropout,
                                          body):
    plan = attention.plan_split_fwd(b, n, heads, 64, biased=biased,
                                    dropout=dropout)
    assert plan.body == body
    if body == "mma":
        assert (plan.grid, plan.items, plan.smem) == (0, 0, 0)
    # the packed layout (K1) never takes the crossing
    assert attention.plan_packed_fwd(b, n, heads, 64).body == (
        "sm90" if n >= 33 else "ffma")


@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("b", [1, 24, 400])
@pytest.mark.parametrize("n", [1, 5, 16, 17, 20, 32, 33, 64, 65, 133, 197,
                               256, 257, 272])
def test_plan(n, b, biased):
    plan = attention.plan_split_fwd(b, n, HEADS, 64, biased=biased,
                                    dropout=True)
    assert plan.body == "sm90"
    # keys padded to 16, within two TMA boxes of at most 256 rows, each
    # starting on a 1024-byte swizzle atom
    assert n <= plan.key_rows < n + 16 and plan.key_rows % 16 == 0
    assert plan.kv_box * plan.kv_loads == plan.key_rows
    assert plan.kv_loads == (1 if plan.key_rows <= 256 else 2)
    assert plan.kv_box <= 256 and plan.kv_box % 8 == 0
    assert plan.q_tiles == -(-n // 64)
    # every (b, h, query tile) exactly once, on the card's 132 SMs and on a
    # grid small enough that each CTA walks several items
    assert plan.grid == min(plan.items, 132)
    assert _covers_once(plan, b, HEADS)
    assert _covers_once(
        attention.plan_split_fwd(b, n, HEADS, 64, biased=biased, sms=7), b,
        HEADS)
    # the stages, O tiles and barriers of K1's plan, and with a bias each
    # consumer's pad16(N) fp32 bias row
    k1 = attention.sm90_fwd_plan(b, n, HEADS)
    assert plan.smem == k1.smem + (2 * 4 * plan.key_rows if biased else 0)
    assert plan.smem <= SMEM_LIMIT
    # the same launch as K1's but for the bias rows
    assert (plan.key_rows, plan.kv_box, plan.kv_loads, plan.q_tiles,
            plan.items, plan.grid) == (k1.key_rows, k1.kv_box, k1.kv_loads,
                                       k1.q_tiles, k1.items, k1.grid)


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("n,smem", [(133, 125_120), (272, 191_680)])
def test_shared_memory_with_a_bias(n, smem, dropout):
    """The numbers the kernel's source note gives for a biased launch, with
    dropout as without."""
    assert attention.plan_split_fwd(400, n, 12, 64, biased=True,
                                    dropout=dropout).smem == smem
    assert f"{smem:,} B at N = {n}" in " ".join(SOURCE.read_text().split())


@pytest.mark.parametrize("n", [0, 273])
def test_the_body_refuses_n_outside_its_instantiations(n):
    with pytest.raises(ValueError, match="1 <= N <= 272"):
        attention.sm90_fwd_plan(2, n, 4)


def test_instantiations_cover_the_plans():
    """The C entry instantiates the body for 1..17 16-key chunks (1 <= N
    <= 272) with and without a bias and dropout (and without K1m's mask,
    the third flag); the plans' least and largest N fall on its first and
    last instantiation."""
    text = SOURCE.read_text()
    kts = sorted(int(k) for k in re.findall(r"BSCAN_KT\((\d+)\)", text))
    assert kts == list(range(1, 18))
    assert min(kts) == -(-attention.SM90_BODY_MIN_N // 16)
    assert max(kts) == attention.SM90_MAX_N // 16
    for flags in ("true, true", "true, false", "false, true",
                  "false, false"):
        assert f"dispatch<{flags}, false>" in text


def test_cpu_tensors_take_no_plan():
    """On the CPU `mha` and `mha_dropout` run the plain version at any
    shape: no kernel launch, no sm90 launch."""
    q = torch.randn(2, 133, 128, dtype=torch.bfloat16)
    def counts():
        return [getattr(fn, attr) for fn in (attention.mha,
                                             attention.mha_dropout)
                for attr in ("launches", "sm90_launches", "mma_launches")]

    before = counts()
    attention.mha(q, q, q, 2)
    attention.mha(q, q, q, 2, dropout_rate=0.1, dropout_seed=7)
    assert counts() == before
