"""The frozen yardstick: FLOP counts and roofline bounds against hand-worked
values, and the trace aggregation's union and gaps on a canned trace."""

import pytest

from benchmark import flops, trace_agg


def test_flop_counts():
    # the plain flagship step, as utils/flops.py counts it
    assert flops.flagship_train_flops_per_sample() == pytest.approx(
        118467084288.0)
    # ViT-L/14: a 14x14 conv over 256 patches, 24 layers at 257 tokens
    seq, d = 257, 1024
    layer = 4 * 2 * seq * d * d + 4 * seq * seq * d + 4 * seq * d * 4 * d
    want = 2 * 256 * 588 * d + 24 * layer + 2 * d * 768
    assert flops.openclip_visual_fwd() == pytest.approx(want)
    assert flops.openclip_visual_fwd() / 1e9 == pytest.approx(161.96, 1e-3)
    assert flops.search_flops(10, 4) == 80.0


def test_bounds_at_tiny_shapes():
    bw, peak = flops.HBM_BYTES_PER_S, flops.PEAK_BF16_FLOPS
    # b=2, n=4, one head of 64: q, k, v, o in bf16 vs 4*b*h*n^2*hd FLOPs
    assert flops.attention_fwd_bound_s(2, 4, 1, 64) == pytest.approx(
        max(4 * 2 * 4 * 64 * 2 / bw, 4 * 2 * 16 * 64 / peak))
    assert flops.attention_bwd_bound_s(2, 4, 1, 64, bias=True) == \
        pytest.approx(max((7 * 2 * 4 * 64 * 2 + 4 * 2 * 4) / bw,
                          8 * 2 * 16 * 64 / peak))
    # top-k: the keys and queries once, k values and indices a query
    assert flops.topk_bound_s(3, 100, 8, 5) == pytest.approx(
        max((4 * 103 * 8 + 3 * 5 * 12) / bw, 2 * 3 * 100 * 8 / peak))


@pytest.mark.parametrize("b,n,heads,hd", [(400, 197, 12, 64),
                                          (285, 257, 16, 64),
                                          (400, 20, 8, 64)])
def test_a_bound_is_no_more_than_the_work_needs(b, n, heads, hd):
    # bytes at least the inputs and output once; FLOPs exactly the products
    d = heads * hd
    fwd = flops.attention_fwd_bound_s(b, n, heads, hd)
    assert fwd <= max(4 * b * n * d * 2 / flops.HBM_BYTES_PER_S,
                      4 * b * heads * n * n * hd / flops.PEAK_BF16_FLOPS) \
        * (1 + 1e-12)
    assert flops.attention_bwd_bound_s(b, n, heads, hd) >= fwd


def test_union_and_gaps_on_a_canned_trace():
    ev = []
    span = ("user_annotation", trace_agg.TRACE_SPAN, 0, 1_000_000,
            "thread 1")
    ev.append(span)
    # two streams overlapping, a 300 us hole named by the host op in it
    ev += [("kernel", "elementwise_kernel<a>", 0, 200_000, "stream 7"),
           ("kernel", "mha_fwd_sm90<5, false, false, false>", 100_000,
            200_000, "stream 8"),
           ("kernel", "nvjet_gemm", 600_000, 400_000, "stream 7"),
           ("cpu_op", "aten::topk", 350_000, 200_000, "thread 1")]
    agg = trace_agg.aggregate_events(ev, wall_ms=1.0)
    assert agg["busy_ms"] == pytest.approx(0.7)
    assert agg["idle_ms"] == pytest.approx(0.3)
    assert agg["idle_gaps"][0]["host_op"] == "aten::topk"
    assert agg["per_category_ms"]["K1/K2 fwd sm90"] == pytest.approx(0.2)
    assert agg["per_category_ms"]["elementwise"] == pytest.approx(0.2)
    assert agg["kernel_events"] == 3
    assert trace_agg._union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    assert trace_agg._gaps([(0, 3), (5, 6)], (0, 10)) == [(3, 5), (6, 10)]


def test_the_train_cell_counts_the_flagship_s_flops():
    from benchmark.kinds.train import Cell
    from benchmark.run import cell_files
    from benchmark.tests.tiny import ROOT, TRAIN, bench

    _, cfg, tr, _ = cell_files(bench(), TRAIN, ROOT)
    assert Cell(cfg, tr, 1, "cpu").flops_per_sample() == \
        flops.flagship_train_flops_per_sample()


def test_a_vit_s_patch_comes_from_its_geometry():
    g = {"tower": "vit", "image_size": 224, "hidden": 768, "layers": 12,
         "mlp": 3072, "lora_rank": 4, "output_dim": 768}
    b16 = flops.train_flops(dict(g, patch=16), 197)
    assert b16 == flops.vit_b16().train_plain()
    # the patch embedding's products: 2 * 256 patches * 14*14*3 * 768,
    # forward and backward
    b14 = flops.train_flops(dict(g, patch=14), 197)
    assert b16 - b14 == pytest.approx(2 * 2 * 196 * (768 - 588) * 768)


@pytest.mark.parametrize("kind,role,tower", [
    ("train", "image", "openclip_visual"),
    ("train", "language", "openclip_text"),
    ("search", "image", "vit")])
def test_a_tower_a_kind_cannot_count_is_refused(kind, role, tower):
    """A cell whose geometry names a tower that the kind has no reference
    or FLOP count of raises, and computes nothing."""
    import importlib

    from benchmark.run import cell_files
    from benchmark.tests.tiny import ROOT, SEARCH, TRAIN, bench

    _, cfg, tr, _ = cell_files(bench(), TRAIN if kind == "train" else SEARCH,
                               ROOT)
    cfg = dict(cfg, geometry=dict(cfg["geometry"]))
    cfg["geometry"][role] = dict(cfg["geometry"][role], tower=tower)
    cls = importlib.import_module(f"benchmark.kinds.{kind}").Cell
    with pytest.raises(ValueError, match=tower):
        cls(cfg, tr, 1, "cpu")
