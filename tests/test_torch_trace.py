"""The port's tracer (bioscan_clip_tpu_torch/tools/trace_train_step.py,
trace_extract.py, profile_towers.py, profile_train_step.py) on the CPU:
- `_self_times` against the JAX tool's (tools/trace_train_step.py, loaded
  from its path) on 200 seeded event lists with nesting and partial
  overlap, to 1e-9 ms;
- `categorize` against JAX's on JAX's own keys and seeded XLA-style op
  names (the same category each time), and on CUDA kernel names: each
  hand-written kernel's symbol as its wrapper launches it (demangled, as
  the profiler names kernels), cuBLAS' GEMMs, PyTorch's elementwise
  kernels, NCCL, copies;
- the union busy time against a numpy bitmap of seeded intervals over 3
  streams, busy plus the gaps equal to the traced window;
- a gap's host op on a synthetic host tree over two threads;
- the check of a line against the wrappers' counters;
- each tool's `main(["--cpu", ...])` on a tiny flagship (1-layer towers,
  width 32, 768-d outputs) put in place of `models.clip.load_clip_model`:
  one JSON line, the JAX tool's keys first;
- `profile_train_step --variant fused` gives the losses of
  `train/loop.make_train_step` on the same batch and seeds.
A `gpu`-marked case (skips without CUDA): every wrapper whose counter moved
in a tiny eager step shows up in that step's trace. The file imports JAX
only inside the fixture that loads the JAX tool.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bioscan_clip_tpu_torch.tools import (
    profile_towers,
    profile_train_step,
    trace_extract,
)
from bioscan_clip_tpu_torch.tools import trace_train_step as tts
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_tool():
    """The JAX tool as a module (unedited; it imports JAX)."""
    spec = importlib.util.spec_from_file_location(
        "jax_trace_train_step", ROOT / "tools" / "trace_train_step.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _event_list(rng):
    """Seeded (name, start_ns, dur_ns) events: nested trees of spans and
    spans that only partly overlap another."""
    evs = []
    for _ in range(rng.integers(1, 6)):
        s = int(rng.integers(0, 10_000))
        stack = [(s, s + int(rng.integers(1, 5_000)))]
        while stack and len(evs) < 40:
            lo, hi = stack.pop()
            evs.append((f"op{rng.integers(0, 8)}", lo, hi - lo))
            for _ in range(rng.integers(0, 3)):
                if hi - lo < 4:
                    break
                a = int(rng.integers(lo, hi - 1))
                b = int(rng.integers(a + 1, hi + 1))
                stack.append((a, b))
    for _ in range(rng.integers(0, 4)):  # partial overlaps
        base = evs[int(rng.integers(0, len(evs)))]
        s = base[1] + int(rng.integers(0, base[2] + 1))
        evs.append((f"over{rng.integers(0, 3)}", s,
                    base[2] + int(rng.integers(1, 500))))
    return evs


def test_self_times_match_jax(jax_tool):
    rng = np.random.default_rng(0)
    for case in range(200):
        evs = _event_list(rng)
        got = sorted(tts._self_times(evs))
        want = sorted(jax_tool._self_times(evs))
        assert [n for n, _ in got] == [n for n, _ in want], case
        assert np.allclose([t for _, t in got], [t for _, t in want],
                           rtol=0, atol=1e-9), case


XLA_OPS = ("fusion", "dot", "convolution", "copy", "copy-start",
           "transpose", "reshape", "bitcast", "rng-bit-generator",
           "threefry2x32", "reduce", "reduce-window", "sort", "add",
           "multiply", "exponential", "select", "broadcast", "slice",
           "dynamic-update-slice", "all-reduce", "custom-call", "iota",
           "concatenate", "convert", "while", "tuple", "parameter",
           "loop_fusion", "input_fusion", "top-k", "philox")


def test_categorize_matches_jax_on_xla_names(jax_tool):
    names = [k for _, keys in jax_tool.CATEGORIES for k in keys]
    rng = np.random.default_rng(1)
    for _ in range(400):
        op = XLA_OPS[rng.integers(0, len(XLA_OPS))]
        name = f"{op}.{rng.integers(0, 500)}"
        if rng.random() < 0.3:
            name = f"{XLA_OPS[rng.integers(0, len(XLA_OPS))]}_{name}"
        if rng.random() < 0.3:
            name = name.upper()
        names.append(name)
    assert tts.CATEGORIES == jax_tool.CATEGORIES
    for name in names:
        assert tts.categorize(name) == jax_tool.categorize(name), name


CUDA_NAMES = [
    ("void mha_fwd_sm90<5, false, false, false>(FwdArgs)", "K1/K2 fwd sm90"),
    ("void mha_fwd_sm90<2, true, false, false>(FwdArgs)", "K1/K2 fwd sm90"),
    ("void mha_fwd_sm90<9, false, true, false>(FwdArgs)", "K2d fwd sm90"),
    ("void mha_fwd_sm90<2, true, true, false>(FwdArgs)", "K2d fwd sm90"),
    ("void mha_fwd_sm90<6, false, false, true>(FwdArgs)", "K1m fwd sm90"),
    ("void mha_fwd_mma<64, false>(MhaArgs)", "K1/K1m/K2/K2d fwd mma.sync"),
    ("void mha_fwd_kernel<float, 64, true>(MhaArgs)",
     "K1/K1m/K2/K2d fwd FFMA"),
    ("void mha_bwd_sm90_pass_a<13, false, false, false>(BwdArgs)",
     "K3 bwd sm90 pass A"),
    ("void mha_bwd_sm90_pass_a<9, true, false, false>(BwdArgs)",
     "K3 bwd sm90 pass A"),
    ("void mha_bwd_sm90_pass_a<2, false, true, false>(BwdArgs)",
     "K3m bwd sm90 pass A"),
    ("void mha_bwd_sm90_pass_b<true, false, false>(BwdArgs)",
     "K3 bwd sm90 pass B"),
    ("void mha_bwd_sm90_pass_b<false, true, false>(BwdArgs)",
     "K3m bwd sm90 pass B"),
    ("void bwd_query_rows_mma<64, false>(BwdArgs)",
     "K3/K3m bwd pass A mma.sync/FFMA"),
    ("void bwd_query_rows<float, 64, true>(BwdArgs)",
     "K3/K3m bwd pass A mma.sync/FFMA"),
    ("void bwd_key_rows_mma<64, false>(BwdArgs)",
     "K3/K3m bwd pass B+C mma.sync/FFMA"),
    ("dbias_sum_heads(float const*, float*, int, int, int)",
     "K3/K3m bwd pass B+C mma.sync/FFMA"),
    ("void topk_f32_sm90<5, 128, 3, false>(TopkArgs)", "K4 sm90"),
    ("void (anonymous namespace)::topk_f32_sm90<8, 64, 3, false>("
     "CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::Args)",
     "K4 sm90"),
    ("void topk_f32_sm90<8, 256, 1, true>(TopkArgs)", "K6 sm90"),
    ("void split_queries<3>(float const*, __nv_bfloat16*, int, int)",
     "K4/K6 sm90 query split"),
    ("void topk_f32_pass1<5, 16, 3>(TopkArgs)", "K4 mma.sync"),
    ("void topk_pass2<5>(Pass2Args)", "K4/K5 pass 2"),
    ("void topk_i8_sm90<21, 128, false, false>(I8Args)", "K5 sm90"),
    ("void topk_i8_sm90<21, 64, true, false>(I8Args)", "K5 sm90"),
    ("void topk_i8_sm90<8, 128, false, true>(I8Args)", "K6 sm90"),
    ("void topk_i8_pass1<21, 16>(I8Args)", "K5 mma.sync"),
    ("void mm_only_f32_pass1<16, 3>(MmArgs)", "K6 mma.sync"),
    ("void mm_only_i8_pass1<16>(MmArgs)", "K6 mma.sync"),
    ("mm_only_pass2(float const*, float*, int, int)", "K6 pass 2"),
    ("void tiny_kernel<true>(float const*, float*, long)", "K7"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_"
     "warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cublas", "matmul"),
    ("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NTN", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::FillFunctor<float>, std::array<char*, 1ul> >(int, "
     "at::native::FillFunctor<float>, std::array<char*, 1ul>)",
     "elementwise"),
    ("void at::native::unrolled_elementwise_kernel<at::native::"
     "direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}>",
     "elementwise"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage"
     "<4096ul>)", "collective"),
    ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "collective"),
    ("Memcpy HtoD (Pageable -> Device)", "copy"),
    ("Memset (Device)", "copy"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::MeanOps<float, float, float, float>, unsigned int, "
     "float, 4> >", "reduce"),
]


@pytest.mark.parametrize("name,group", CUDA_NAMES,
                         ids=[g + ":" + n[:40] for n, g in CUDA_NAMES])
def test_categorize_cuda_names(name, group):
    assert tts.categorize(name) == group


def test_every_kernel_symbol_has_a_group():
    """Every `__global__` function in csrc/ falls in a kernel group."""
    import re

    src = "\n".join(p.read_text() for p in sorted(
        (ROOT / "bioscan_clip_tpu_torch" / "csrc").glob("*.cu*")))
    names = set(re.findall(r"__global__\s+void\s+(?:__\w+__\([^)]*\)\s*)*"
                           r"(\w+)\s*\(", src))
    assert len(names) >= 20, names
    missing = [n for n in sorted(names) if tts.kernel_group(f"void {n}("
                                                           ") ") is None]
    assert not missing, missing


def _chrome_events(intervals, window):
    """Complete events of a Chrome trace: kernels from (start_ns, end_ns,
    stream), and the traced call's host span over `window`."""
    evs = [{"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": s / 1e3,
            "dur": (e - s) / 1e3, "pid": 0, "tid": st}
           for i, (s, e, st) in enumerate(intervals)]
    evs.append({"ph": "X", "cat": "user_annotation", "name": tts.TRACE_SPAN,
                "ts": window[0] / 1e3, "dur": (window[1] - window[0]) / 1e3,
                "pid": 1, "tid": 1})
    return {"traceEvents": evs}


@pytest.mark.parametrize("seed", range(8))
def test_union_busy_against_a_bitmap(seed):
    rng = np.random.default_rng(seed)
    span = 200_000
    window = (0, span)
    intervals = []
    for stream in (7, 13, 21):
        for _ in range(rng.integers(5, 40)):
            s = int(rng.integers(0, span - 1))
            e = min(span, s + int(rng.integers(1, 12_000)))
            intervals.append((s, e, stream))
    bitmap = np.zeros(span, bool)
    for s, e, _ in intervals:
        bitmap[s:e] = True
    merged = tts._union((s, e) for s, e, _ in intervals)
    busy = sum(e - s for s, e in merged)
    gaps = tts._gaps(merged, window)
    assert busy == bitmap.sum()
    assert busy + sum(e - s for s, e in gaps) == span
    assert all(not bitmap[s:e].any() for s, e in gaps)
    agg = tts.aggregate_events(
        tts._events(_chrome_events(intervals, window)), wall_ms=span / 1e6)
    assert agg["busy_ms"] == pytest.approx(bitmap.sum() / 1e6, abs=1e-9)
    assert agg["busy_ms"] + agg["idle_ms"] == pytest.approx(span / 1e6)
    assert agg["busy_share"] == pytest.approx(bitmap.mean(), abs=1e-4)
    assert agg["leaf_total_ms"] == pytest.approx(
        sum(e - s for s, e, _ in intervals) / 1e6, abs=0.01)
    long_gaps = sorted((e - s for s, e in gaps if e - s >= tts.MIN_GAP_NS),
                       reverse=True)
    assert [g["ms"] for g in agg["idle_gaps"]] == pytest.approx(
        [g / 1e6 for g in long_gaps[:10]], abs=1e-3)
    assert sum(agg["idle_by_host_op_ms"].values()) == pytest.approx(
        sum(long_gaps) / 1e6, abs=1e-2)
    assert set(agg["line_totals_ms"]) >= {"stream 7", "stream 13",
                                          "stream 21"}


def test_a_gaps_host_op():
    """Gaps named by the innermost host op at their middle: the latest
    started across threads, the traced span alone as host Python; a gap
    under 20 us is not reported; events before the span are left out."""
    us = 1_000

    def x(cat, name, s, e, tid):
        return {"ph": "X", "cat": cat, "name": name, "ts": s, "dur": e - s,
                "pid": 0 if cat == "kernel" else 1, "tid": tid}

    evs = [x("user_annotation", tts.TRACE_SPAN, 0, 2000, 1),
           x("cpu_op", "aten::step", 100, 1500, 1),
           x("cpu_op", "aten::mm", 200, 300, 1),
           x("cuda_runtime", "cudaLaunchKernel", 250, 260, 1),
           x("cuda_runtime", "cudaStreamSynchronize", 500, 900, 1),
           # the autograd thread starts an op after the main thread's sync
           x("cpu_op", "autograd::engine::evaluate_function: MmBackward0",
             1000, 1400, 2),
           x("cpu_op", "aten::mul", 1100, 1300, 2),
           x("kernel", "k0", 0, 150, 7),
           x("kernel", "k1", 320, 480, 7),
           x("kernel", "k2", 850, 1000, 7),
           x("kernel", "k3", 1010, 1150, 8),  # a 10 us gap before it
           x("kernel", "k4", 1350, 1800, 7),
           # before the traced span: the profiler's throwaway launches
           x("cuda_runtime", "cudaLaunchKernel", -900, -880, 1),
           x("kernel", "prime", -500, -400, 7)]
    agg = tts.aggregate_events(tts._events({"traceEvents": evs}),
                               wall_ms=2.0)
    got = {(g["at_ms"], g["ms"]): g["host_op"] for g in agg["idle_gaps"]}
    assert got == {(0.15, 0.17): "aten::mm",
                   (0.48, 0.37): "cudaStreamSynchronize",
                   (1.15, 0.2): "aten::mul",
                   (1.8, 0.2): "(host Python)"}
    assert agg["busy_ms"] == pytest.approx(
        (150 + 160 + 150 + 140 + 450) * us / 1e6)
    assert agg["idle_ms"] == pytest.approx(2.0 - agg["busy_ms"])
    assert agg["idle_by_host_op_ms"]["aten::mm"] == pytest.approx(0.17)
    assert agg["host_self_ms"]["cudaStreamSynchronize"] == pytest.approx(0.4)
    assert agg["kernel_events"] == 5 and agg["launches"] == {}
    assert agg["hand_kernels"] == {}
    assert agg["leaf_total_ms"] == pytest.approx(1.05)
    assert agg["host_self_ms"]["cudaLaunchKernel"] == pytest.approx(0.01)


def test_check_holds_groups_to_the_counters():
    agg = {"busy_ms": 5.0, "wall_ms": 6.0, "leaf_total_ms": 7.0,
           "per_category_ms": {"K3 bwd sm90 pass A": 3.0, "matmul": 4.0},
           "launches": {"K3 bwd sm90 pass A": 4, "K3 bwd sm90 pass B": 4,
                        "K1/K2 fwd sm90": 2}}
    ok = {"mha_bwd.launches": 4, "mha_bwd.sm90_launches": 4,
          "mha_packed.launches": 2, "mha_packed.sm90_launches": 2}
    assert tts.check(agg, ok) == []
    bad = tts.check(dict(agg, busy_ms=6.5, leaf_total_ms=7.2),
                    dict(ok, **{"mha_dropout.sm90_launches": 1}))
    assert len(bad) == 3, bad  # busy, categories, K2d's sm90 group
    assert tts.check(dict(agg, busy_ms=None), ok) == [
        "the profiler shows no card time"]


def tiny_flagship(width=32):
    """`load_clip_model` for a tiny flagship: 1-layer towers of `width`
    (2 heads), 768-d outputs, per-layer remat as `args` asks, seeded like
    it."""
    def factory(args, device=None, dtype=None, lora_rank=None,
                ln_dtype=None, **_):
        from bioscan_clip_tpu_torch.models.bert import (
            BarcodeBertDnaEncoder,
            BertConfig,
            BertTextEncoder,
        )
        from bioscan_clip_tpu_torch.models.clip import (
            MultiModalCLIP,
            init_weights,
            remat_of,
        )
        from bioscan_clip_tpu_torch.models.vit import (
            ViTConfig,
            ViTImageEncoder,
        )

        rank = 4 if lora_rank is None else lora_rank
        dtype = dtype or torch.float32
        ln_dtype = ln_dtype or torch.float32
        remat = remat_of(args)  # tpu.remat, tpu.remat_policy
        kw = dict(hidden_size=width, num_layers=1, num_heads=2,
                  intermediate_size=2 * width, lora_rank=rank, **remat)
        model = MultiModalCLIP(
            image_encoder=ViTImageEncoder(ViTConfig(
                image_size=224, patch_size=32, hidden_size=width,
                num_layers=1, num_heads=2, num_classes=768,
                lora_rank=rank, **remat), dtype, ln_dtype),
            dna_encoder=BarcodeBertDnaEncoder(
                BertConfig(vocab_size=1027, **kw), 768, dtype, ln_dtype),
            language_encoder=BertTextEncoder(
                BertConfig(vocab_size=30522, **kw), 768, dtype, ln_dtype))
        return init_weights(model.to(device), seed=0).eval()
    return factory


@pytest.fixture
def tiny(monkeypatch):
    import bioscan_clip_tpu_torch.models.clip as port_clip

    monkeypatch.setattr(port_clip, "load_clip_model", tiny_flagship())


JAX_TRACE_KEYS = ["batch", "scan", "remat_policy", "host_crop", "trace_dir",
                  "agg", "per_step_leaf_ms"]
JAX_EXTRACT_KEYS = ["batch", "steps", "trace_dir", "agg", "per_step_leaf_ms"]
JAX_TOWER_KEYS = ["batch", "eval_transform_ms", "vit_ms", "barcode_bert_ms",
                  "bert_small_ms", "device"]
JAX_STEP_KEYS = ["variant", "batch", "step_ms", "samples_per_s",
                 "compile_s", "device"]
JAX_AGG_KEYS = ["leaf_total_ms", "line_totals_ms", "per_category_ms",
                "top_ops_ms"]
TOOL_CASES = [
    (tts, ["--batch", "4", "--scan", "2"], JAX_TRACE_KEYS),
    (tts, ["--batch", "4", "--scan", "1", "--mode", "gradcache",
           "--remat-policy", "none"], JAX_TRACE_KEYS),
    (tts, ["--batch", "4", "--scan", "1", "--mode", "micro",
           "--host-crop"], JAX_TRACE_KEYS),
    (tts, ["--batch", "4", "--scan", "1", "--remat-policy", "full"],
     JAX_TRACE_KEYS),
    (tts, ["--batch", "4", "--step", "finetune-image"], JAX_TRACE_KEYS),
    (tts, ["--batch", "4", "--step", "finetune-joint"], JAX_TRACE_KEYS),
    (trace_extract, ["--batch", "4", "--steps", "2"], JAX_EXTRACT_KEYS),
    (trace_extract, ["--search", "--keys", "500"], JAX_EXTRACT_KEYS),
    (profile_towers, ["--batch", "2", "--steps", "2"], JAX_TOWER_KEYS),
] + [(profile_train_step, ["--batch", "4", "--steps", "1", "--variant", v],
      JAX_STEP_KEYS) for v in profile_train_step.VARIANTS]


@pytest.mark.parametrize(
    "tool,argv,keys", TOOL_CASES,
    ids=[f"{t.__name__.rsplit('.', 1)[1]}:{' '.join(a)}"
         for t, a, _ in TOOL_CASES])
def test_tool_main_on_the_cpu(tiny, tool, argv, keys):
    lines = []
    out = tool.main(["--cpu"] + argv, emit=lines.append)
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line)[:len(keys)] == keys
    assert line == json.loads(json.dumps(out))
    assert line["card"] is None
    if "agg" in line:
        agg = line["agg"]
        assert list(agg)[:len(JAX_AGG_KEYS)] == JAX_AGG_KEYS
        assert agg["leaf_total_ms"] > 0 and agg["busy_ms"] is None
        assert agg["launches"] is None and line["trace_dir"] is None
        assert agg["hand_kernels"] is None
        assert sum(agg["per_category_ms"].values()) == pytest.approx(
            agg["leaf_total_ms"], abs=0.1)
        assert line["wall_ms"] > 0 and line["untraced_wall_ms"] > 0
        assert line["untraced_busy_share"] is None
    else:
        assert line["device"] == "cpu"


def test_keep_keeps_the_chrome_trace(tiny):
    import shutil

    out = trace_extract.main(["--cpu", "--batch", "2", "--steps", "1",
                              "--keep"], emit=lambda _: None)
    try:
        with open(Path(out["trace_dir"]) / "trace.json") as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert tts.TRACE_SPAN in names
    finally:
        shutil.rmtree(out["trace_dir"])


def test_fused_variant_gives_make_train_step_losses(tiny):
    """`--variant fused` reports the loss of its last step (warm-up, then
    --steps): the same as `make_train_step` on the same batch, seeds and
    fresh model."""
    from bioscan_clip_tpu_torch.models import clip
    from bioscan_clip_tpu_torch.train.loop import device_batch, make_train_step
    from bioscan_clip_tpu_torch.train.schedules import constant
    from bioscan_clip_tpu_torch.train.state import create_train_state

    out = profile_train_step.main(["--cpu", "--batch", "4", "--steps", "2"],
                                  emit=lambda _: None)
    dev = torch.device("cpu")
    model = clip.load_clip_model(tts.flagship_args(4, dev), device=dev)
    state = create_train_state(model, constant(1e-3))
    step = make_train_step(model)
    batch = device_batch(tts.make_inputs(4), dev)
    for seed in range(profile_train_step.SEED, profile_train_step.SEED + 3):
        state, loss = step(state, batch, seed)
    assert out["loss"] == float(loss)


@pytest.mark.gpu
def test_a_traced_eager_step_shows_every_counted_wrapper(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import bioscan_clip_tpu_torch.models.clip as port_clip

    # head dim 64: the attention kernels' sm90 bodies
    monkeypatch.setattr(port_clip, "load_clip_model", tiny_flagship(128))
    res = tts.run_dispatch(8, 1, "none", True, device="cuda")
    agg, counters = res["agg"], res["counters"]
    assert counters.get("mha_packed.launches", 0) > 0
    assert counters.get("mha_bwd.launches", 0) > 0
    assert tts.check(agg, counters) == []
    assert agg["busy_share"] <= 1.0
