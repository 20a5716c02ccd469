"""The flooded-tile screen's policy sweep (`tools/sweep_screen_sm90.py`) on
the CPU: every variant's edit still applies to csrc/topk_i8_sm90.cu or
csrc/topk_sm90.cu and changes it, the summary's ratios, and the refusal to
run without a CUDA device (it times kernels on the card)."""

import pytest
import torch

from bioscan_clip_tpu_torch.ops import _build
from bioscan_clip_tpu_torch.tools import sweep_screen_sm90 as sweep
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_every_variant_edits_the_source():
    k5 = (_build.CSRC_DIR / "topk_i8_sm90.cu").read_text()
    k4 = (_build.CSRC_DIR / "topk_sm90.cu").read_text()
    texts = sweep.variant_sources(k5, k4)
    assert set(texts) == {"k5:none", "k5:vote", "k5:carry_all", "k4:none"}
    for name, text in texts.items():
        assert text != (k5 if name.startswith("k5") else k4)
    assert sweep.K5_FLOOD not in texts["k5:none"]
    assert "NQ == 128 ? kFloodVote : kFloodNone" in texts["k5:vote"]
    assert "kFloodVote>(" not in texts["k4:none"]
    with pytest.raises(ValueError, match="k5:none"):
        sweep.variant_sources(k5.replace(sweep.K5_FLOOD, "kFloodNone"), k4)


def test_summary_against_the_parent_else_as_built():
    readings = [
        {"kernel": "k5", "case": "Bq=1", "precision": None, "variant": v,
         "ms": ms}
        for v, ms in (("k5:parent", 2.0), ("k5:parent", 4.0),
                      ("k5:as_built", 1.5), ("k5:none", 3.0))]
    readings += [{"kernel": "k4", "case": "rising", "precision": "high",
                  "variant": v, "ms": ms}
                 for v, ms in (("k4:as_built", 2.0), ("k4:none", 5.0))]
    rows = {(r["kernel"], r["variant"]): r for r in sweep.summary(readings)}
    assert rows[("k5", "k5:parent")]["median_ms"] == 3.0
    assert rows[("k5", "k5:as_built")]["to_base"] == 0.5
    assert rows[("k5", "k5:none")]["to_base"] == 1.0
    assert rows[("k4", "k4:none")]["to_base"] == 2.5


def test_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sweep.main([]) == 1
    assert "CUDA" in capsys.readouterr().err
