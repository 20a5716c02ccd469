"""K1's and K1m's design sweep (`tools/sweep_k1_sm90.py`) on the CPU: every
variant's edits still apply to `csrc/mha_fwd_sm90.cu` and change it where
its name says (K1m's mask rows staged by plain loads, or read from device
memory in place of its staged rows), `--variants` builds only those named,
ptxas' lines are read for K1's and K1m's instantiations alone, K1m's
crossing grid spans the masked plan's range, and the tool refuses to run
without a CUDA device (it times kernels on the card)."""

import pytest
import torch

from bioscan_clip_tpu_torch.ops import _build, attention
from bioscan_clip_tpu_torch.tools import sweep_k1_sm90
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SOURCE = (_build.CSRC_DIR / sweep_k1_sm90.SOURCE).read_text()


def test_every_variant_edits_the_source():
    texts = sweep_k1_sm90.variant_sources(SOURCE)
    assert set(texts) == set(sweep_k1_sm90.VARIANTS)
    assert texts["as_built"] == SOURCE
    others = [t for name, t in texts.items() if name != "as_built"]
    assert all(t != SOURCE for t in others)
    assert len(set(others)) == len(others)
    # as built the mask rows are staged by cp.async once a tile and read
    # from shared memory; mask_sync stages them by plain loads; mask_ldg
    # stages nothing and reads each score's mask entry
    staged = "stage_mask<KT>(mask_s, add, n, tile, tid);"
    assert SOURCE.count(staged) == 1
    assert SOURCE.count("cp.async.ca.shared.global") == 1
    assert "cp.async.ca.shared.global" not in texts["mask_sync"]
    assert staged in texts["mask_sync"]
    ldg = texts["mask_ldg"]
    assert staged not in ldg
    assert "__ldg(add + (long long)mr * n + mc)" in ldg
    assert "mask_g + ((x & 2)" not in ldg
    with pytest.raises(ValueError, match="mask_ldg"):
        sweep_k1_sm90.variant_sources(
            SOURCE.replace(sweep_k1_sm90.STAGE_MASK, ""))


def test_variants_builds_only_those_named():
    texts = sweep_k1_sm90.variant_sources(SOURCE, ("as_built", "mask_ldg"))
    assert list(texts) == ["as_built", "mask_ldg"]


def test_ptxas_lines_read_k1_and_k1m_alone():
    ns = "_ZN12_GLOBAL__N_112mha_fwd_sm90"
    log = []
    for kt, flags in ((13, "Lb0ELb0ELb0E"), (17, "Lb0ELb0ELb0E"),
                      (5, "Lb0ELb0ELb1E"), (13, "Lb0ELb1ELb0E"),
                      (5, "Lb0ELb0ELb0E")):
        log += [f"ptxas info    : Function properties for "
                f"{ns}ILi{kt}E{flags}EEvPKvS2_",
                "    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                "spill loads",
                f"ptxas info    : Used {160 + kt} registers"]
    lines = sweep_k1_sm90.ptxas_lines("\n".join(log))
    assert [ln.split(":")[0] for ln in lines] == [
        "K1 208", "K1 208", "K1 272", "K1 272", "K1m 80", "K1m 80"]
    assert lines[-1] == "K1m 80: Used 165 registers"


def test_crossing_grid_spans_the_masked_range():
    ns, bs = sweep_k1_sm90.CROSSING_N, sweep_k1_sm90.CROSSING_B
    assert min(ns) == attention.SM90_BODY_MIN_N
    assert max(ns) == attention.SM90_MASK_MAX_N
    assert {4, 5, 20, 32, 33, 77} <= set(ns) and (min(bs), max(bs)) == (1, 512)
    # the plan's least N and the N below it lie on the grid
    low = attention.SM90_MASK_MIN_N
    assert {low - 1, low} <= set(ns)


def test_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sweep_k1_sm90.main([]) == 1
    assert "CUDA" in capsys.readouterr().err
