"""K3's design sweep (`tools/sweep_k3_sm90.py`) on the CPU: every variant's
edits still apply to `csrc/mha_bwd_sm90.cu` and change it, the turns
variant takes and passes a turn around every product group of both passes,
and the tool refuses to run without a CUDA device (it times kernels on the
card)."""

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
