"""K4's Hopper-body design sweep (`tools/sweep_k4_sm90.py`) and bench
(`tools/bench_k4.py`) on the CPU: every text variant's edit still applies to
`csrc/topk_sm90.cu` and changes it, the runtime variants are plans that
fit, and both tools refuse to run without a CUDA device (they time kernels
on the card)."""

import pytest
import torch

from bioscan_clip_tpu_torch.ops import _build
from bioscan_clip_tpu_torch.ops import topk
from bioscan_clip_tpu_torch.tools import bench_k4, sweep_k4_sm90
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_every_variant_edits_the_source():
    source = (_build.CSRC_DIR / "topk_sm90.cu").read_text()
    texts = sweep_k4_sm90.variant_sources(source)
    assert set(texts) == set(sweep_k4_sm90.VARIANTS)
    assert all(t != source for t in texts.values())
    assert len(set(texts.values())) == len(texts)
    assert "screen<NQ, MAXK>(acc" not in texts["products_only"]
    assert "__cluster_dims__(1, 2, 1)" in texts["multicast"]
    assert "tma_load_multicast(" in texts["multicast"]
    assert "prefetch(c + 4)" in texts["prefetch_4"]
    # the kernel as built has neither
    assert "cluster" not in source.replace(".release.cluster", "")
    assert "tma_prefetch" not in source
    with pytest.raises(ValueError, match="fadd_1"):
        sweep_k4_sm90.variant_sources(source.replace(sweep_k4_sm90.FADD, ""))


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("bq", [1, 256, 1024])
def test_every_configuration_is_a_plan_that_fits(monkeypatch, bq, precision):
    monkeypatch.setattr(topk, "_sm90_kernel", lambda: "own")
    got = list(sweep_k4_sm90.configs(
        bq, 1 << 20, precision, 132,
        {"fadd_1": "f1", "products_only": "p", "multicast": "m"}))
    names = [name for name, _, _ in got]
    assert names[0] == names[-1] == "plan" and "mma" in names
    assert ("fadd_1" in names) == (precision == "high")
    for name, plan, kern in got:
        assert plan.smem <= topk.MAX_SMEM
        assert plan.n_cand == bq * plan.splits * 5 or name == "mma"
        if name == "multicast":  # clusters of two splits, the last not empty
            n_tiles = (1 << 20) // 128
            assert plan.splits % 2 == 0
            assert (plan.splits - 2) * plan.tiles_per_split < n_tiles
        assert plan.body == ("mma" if name == "mma" else "sm90")
        assert (kern is None) == (name == "mma")
    grid = {(p.qb, p.stages) for n, p, _ in got if n.startswith("nq=")}
    assert (128, 2) in grid and all(s in (2, 3, 4) for _, s in grid)
    assert any(q == 256 for q, _ in grid) == (precision == "default")


def test_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sweep_k4_sm90.main([]) == 1
    assert "CUDA" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="CUDA"):
        bench_k4.main([])
