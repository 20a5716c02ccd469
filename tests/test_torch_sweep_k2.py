"""K2/K2d's design sweep (`tools/sweep_k2_sm90.py`) on the CPU: every
variant's edits still apply to `csrc/mha_fwd_sm90.cu` and change it where
its name says (the dropout hash's place, its shifts, its skips, or no
hash), and the tool refuses to run without a CUDA device (it times kernels
on the card)."""

import pytest
import torch

from bioscan_clip_tpu_torch.ops import _build
from bioscan_clip_tpu_torch.tools import sweep_k2_sm90
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_every_variant_edits_the_source():
    source = (_build.CSRC_DIR / sweep_k2_sm90.SOURCE).read_text()
    texts = sweep_k2_sm90.variant_sources(source)
    assert set(texts) == set(sweep_k2_sm90.VARIANTS)
    assert texts["as_built"] == source
    others = [t for name, t in texts.items() if name != "as_built"]
    assert all(t != source for t in others)
    assert len(set(others)) == len(others)
    # as built the hash runs once, before the S product's wait; late moves
    # it after the softmax; no_hash never calls it
    hashed = "keep_bits<KT>(keep"
    assert source.count(hashed) == 1
    assert source.index(hashed) < source.index("wgmma_wait();\n      "
                                               "fence_regs(sc);")
    late = texts["late"]
    assert late.count(hashed) == 1
    assert late.index(hashed) > late.index("quad_sum(l1)")
    assert "mix32_mulhi(seed ^ mix32_mulhi(ctr))" in texts["mulhi"]
    assert (texts["skip_halves"].count("continue;")
            == source.count("continue;") + 2)
    assert hashed not in texts["no_hash"]
    with pytest.raises(ValueError, match="late"):
        sweep_k2_sm90.variant_sources(source.replace(sweep_k2_sm90.HASH, ""))


def test_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sweep_k2_sm90.main([]) == 1
    assert "CUDA" in capsys.readouterr().err
