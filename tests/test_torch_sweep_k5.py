"""K5's Hopper-body design sweep (`tools/sweep_k5_sm90.py`) and bench
(`tools/bench_k4.py --kernels k5`) on the CPU: every text variant's edit
still applies to `csrc/topk_i8_sm90.cu` and changes it, the configurations
are plans that fit (the text variants' under their own shared-memory
sums), and both tools refuse to run without a CUDA device (they time
kernels on the card)."""

import pytest
import torch

from bioscan_clip_tpu_torch.ops import _build
from bioscan_clip_tpu_torch.ops import topk
from bioscan_clip_tpu_torch.tools import bench_k4, sweep_k5_sm90
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_every_variant_edits_the_source():
    source = (_build.CSRC_DIR / "topk_i8_sm90.cu").read_text()
    texts = sweep_k5_sm90.variant_sources(source)
    assert set(texts) == set(sweep_k5_sm90.VARIANTS)
    assert all(t != source for t in texts.values())
    assert len(set(texts.values())) == len(texts)
    assert "screen_scores<" not in texts["products_only"].split(
        "topk_i8_sm90(")[1]
    assert "constexpr int kChunk = 64;" in texts["chunk_64"]
    # q_once: each edit applied once, the ring holding keys alone
    q_once = texts["q_once"]
    assert q_once.count("qreg") == 4
    assert "return kTileKeys * kChunk;" in q_once
    assert "+ (long long)nq * d ||" in q_once
    # K4's shared-memory merge in place of the shuffles, in the screen and
    # after the walk
    assert "merge_buffers_shfl<" not in texts["merge_smem"]
    assert ("screen_scores<NQ, MAXK, kMergeAt, NQ == 128 ? kFloodCarry : "
            "kFloodNone,\n                    false, Sync>("
            in texts["merge_smem"])
    assert "int bscan_clocks(" in texts["clocks"]
    assert texts["clocks"].count("clock64()") == 13
    assert "g_clocks[6]" in texts["clocks"]  # the producer's slot waits
    with pytest.raises(ValueError, match="q_once"):
        sweep_k5_sm90.variant_sources(source.replace(sweep_k5_sm90.EXPECT,
                                                     ""))


@pytest.mark.parametrize("bq", [1, 256, 1024])
def test_every_configuration_is_a_plan_that_fits(monkeypatch, bq):
    monkeypatch.setattr(topk, "_i8_sm90_kernel", lambda: "own")
    libs = {"chunk_64": "c", "q_once": "q", "products_only": "p"}
    got = list(sweep_k5_sm90.configs(bq, 1 << 20, 132, libs))
    names = [name for name, _, _ in got]
    assert names[0] == names[-1] == "as_built" and "mma" in names
    assert names[1] == "no_seed" and got[1][1].seed_groups == 0
    n_tiles = (1 << 20) // 128
    for name, plan, kern in got:
        assert plan.smem <= topk.MAX_SMEM
        assert plan.body == ("mma" if name == "mma" else "sm90")
        assert (kern is None) == (name == "mma")
        per = plan.tiles_per_split
        assert plan.splits * per >= n_tiles
        if name == "mma":
            assert plan.n_cand == bq * plan.splits // 2 * 21
            continue
        assert (plan.splits - 1) * per < n_tiles
        assert plan.n_cand == bq * plan.splits * 21
        if name.startswith("chunk_64"):
            assert kern == "c"
            assert plan.smem == topk.i8_sm90_smem(plan.qb, 32, plan.stages,
                                                  64)
        elif name.startswith("q_once"):
            assert kern == "q"
            # keys alone in the ring, the block's queries once beside it
            assert plan.smem == (topk.i8_sm90_smem(plan.qb, 32, plan.stages)
                                 - plan.stages * plan.qb * 128
                                 + plan.qb * 768)
        else:
            assert plan.smem == topk.i8_sm90_smem(plan.qb, 32, plan.stages)
    grid = {(p.qb, p.stages) for n, p, _ in got if n.startswith("nq=")}
    assert grid == {(16, 2), (16, 8), (32, 2), (32, 8), (64, 2), (64, 8),
                    (128, 2), (128, 4)}


def test_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sweep_k5_sm90.main([]) == 1
    assert sweep_k5_sm90.main(["--crossing"]) == 1
    assert "CUDA" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="CUDA"):
        bench_k4.main(["--kernels", "k5"])
