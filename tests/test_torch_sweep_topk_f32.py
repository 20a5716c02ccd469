"""The fp32 top-k design sweep (`tools/sweep_topk_f32.py`) on the CPU:
every variant's edit still applies to `csrc/topk.cu` and changes it, and
the tool refuses to run without a CUDA device (it times kernels on the
card)."""

import pytest
import torch

from bioscan_clip_tpu_torch.ops import _build
from bioscan_clip_tpu_torch.tools import sweep_topk_f32


def test_every_variant_edits_the_source():
    source = (_build.CSRC_DIR / "topk.cu").read_text()
    texts = sweep_topk_f32.variant_sources(source)
    assert set(texts) == set(sweep_topk_f32.VARIANTS)
    assert texts["as_built"] == source
    others = [t for name, t in texts.items() if name != "as_built"]
    assert all(t != source for t in others)
    assert len(set(others)) == len(others)
    with pytest.raises(ValueError, match="one_accumulator"):
        sweep_topk_f32.variant_sources(
            source.replace(sweep_topk_f32.FADD, ""))


def test_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sweep_topk_f32.main([]) == 1
    assert "CUDA" in capsys.readouterr().err
