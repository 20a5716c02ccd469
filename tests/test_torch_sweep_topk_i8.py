"""The int8 top-k design sweep (`tools/sweep_topk_i8.py`) on the CPU: every
variant's edit still applies to `csrc/topk.cu` and changes it, each
variant's plan covers the keys in whole clusters of its size, and the tool
refuses to run without a CUDA device (it times kernels on the card)."""

import pytest
import torch

from bioscan_clip_tpu_torch.ops import _build
from bioscan_clip_tpu_torch.ops import topk
from bioscan_clip_tpu_torch.tools import sweep_topk_i8
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_every_variant_edits_the_source():
    source = (_build.CSRC_DIR / "topk.cu").read_text()
    texts = sweep_topk_i8.variant_sources(source)
    assert set(texts) == set(sweep_topk_i8.VARIANTS)
    assert texts["as_built"] == source
    others = [t for name, t in texts.items() if name != "as_built"]
    assert all(t != source for t in others)
    assert len(set(others)) == len(others)
    with pytest.raises(ValueError, match="cluster_1"):
        sweep_topk_i8.variant_sources(
            source.replace(sweep_topk_i8.CLUSTER, ""))


@pytest.mark.parametrize("variant,cluster", [("as_built", 2),
                                             ("cluster_1", 1),
                                             ("cluster_4", 4)])
def test_each_variant_plan_covers_the_keys(variant, cluster):
    """The mma.sync body's plan with its key splits rounded to the
    variant's cluster: every key tile on a split, no empty cluster, and the
    candidates pass 2 reads (k per query and cluster)."""
    for bq in (1, 16, 64, 256):
        for n in (97, 19_937, 1 << 20):
            plan = sweep_topk_i8.variant_plan(variant, bq, n, 132)
            n_tiles = -(-n // 128)
            assert plan.body == "mma" and plan.splits % cluster == 0
            assert plan.splits * plan.tiles_per_split >= n_tiles
            assert (plan.splits - cluster) * plan.tiles_per_split < n_tiles
            assert plan.n_cand == bq * plan.splits // cluster * 21
            if variant == "as_built":
                assert plan == topk.plan_i8(bq, n, 21, body="mma", sms=132)


def test_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sweep_topk_i8.main([]) == 1
    assert "CUDA" in capsys.readouterr().err
