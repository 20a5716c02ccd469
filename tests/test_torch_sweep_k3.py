"""K3's design sweep (`tools/sweep_k3_sm90.py`) on the CPU: every variant's
edits still apply to `csrc/mha_bwd_sm90.cu` and change it, the turns
variant takes and passes a turn around every product group of both passes,
the --mask crossing's grid parses, and the tool refuses to run without a
CUDA device (it times kernels on the card); `tools/bench_k3.py`'s SASS
rows pick K3's instantiations, not K3m's or the read-out's, in either
checkout's mangling."""

import pytest
import torch

from bioscan_clip_tpu_torch.ops import _build
from bioscan_clip_tpu_torch.tools import sweep_k3_sm90
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_every_variant_edits_the_source():
    source = (_build.CSRC_DIR / sweep_k3_sm90.SOURCE).read_text()
    texts = sweep_k3_sm90.variant_sources(source)
    assert set(texts) == set(sweep_k3_sm90.VARIANTS)
    assert texts["as_built"] == source
    others = [t for name, t in texts.items() if name != "as_built"]
    assert all(t != source for t in others)
    assert len(set(others)) == len(others)
    # pass A: S, the two sweeps' dP and dq, an empty tile's turns; pass B:
    # its two product groups and an empty tile's turns
    turns = texts["turns"]
    assert turns.count("turns.take();") == turns.count("turns.give();") == 8
    with pytest.raises(ValueError, match="chunks_32"):
        sweep_k3_sm90.variant_sources(
            source.replace("for_chunks<KT, J + kChunk>(f);", ""))


def test_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sweep_k3_sm90.main([]) == 1
    assert "CUDA" in capsys.readouterr().err


def test_mask_crossing_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sweep_k3_sm90.main(["--mask", "--n", "8,20", "--b", "10"]) == 1
    assert "CUDA" in capsys.readouterr().err


def test_mask_grid_parses_lists_and_ranges():
    assert sweep_k3_sm90._ints("1-3,8,77") == [1, 2, 3, 8, 77]
    assert sweep_k3_sm90._ints("1-144") == list(range(1, 145))


@pytest.mark.parametrize("symbol,want", [
    # before K3m: pass A <KT, DROP, READOUT>, pass B <DROP, READOUT>
    ("_ZN12_GLOBAL__N_119mha_bwd_sm90_pass_aILi13ELb0ELb0EEEv", ("a", "13",
                                                               "0")),
    ("_ZN12_GLOBAL__N_119mha_bwd_sm90_pass_bILb1ELb0EEEv", ("b", None,
                                                          "1")),
    ("_ZN12_GLOBAL__N_119mha_bwd_sm90_pass_aILi13ELb0ELb1EEEv", None),
    # with K3m: pass A <KT, DROP, MASK, READOUT>, pass B <DROP, MASK,
    # READOUT>
    ("_ZN12_GLOBAL__N_119mha_bwd_sm90_pass_aILi17ELb1ELb0ELb0EEEv",
     ("a", "17", "1")),
    ("_ZN12_GLOBAL__N_119mha_bwd_sm90_pass_bILb0ELb0ELb0EEEv", ("b", None,
                                                              "0")),
    ("_ZN12_GLOBAL__N_119mha_bwd_sm90_pass_aILi5ELb0ELb1ELb0EEEv", None),
    ("_ZN12_GLOBAL__N_119mha_bwd_sm90_pass_bILb0ELb1ELb0EEEv", None),
    ("_ZN12_GLOBAL__N_119mha_bwd_sm90_pass_aILi5ELb0ELb1ELb1EEEv", None),
])
def test_bench_k3_sass_rows_pick_k3(symbol, want):
    from bioscan_clip_tpu_torch.tools import bench_k3

    m = bench_k3.K3_SYMBOL.search(symbol)
    assert (m.groups() if m else None) == want
