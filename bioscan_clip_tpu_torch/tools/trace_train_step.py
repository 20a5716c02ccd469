"""Where a train step's card time goes, from one traced call.

Counterpart of tools/trace_train_step.py. It builds the flagship
(ViT-B/16 + BarcodeBERT + BERT-small, LoRA rank 4, 768-d, random seeded
weights, bf16, frozen weights in bf16) and the train step that
`cli/train_cl.make_step` builds for the same options, runs two calls
warm, times one untraced call, then traces one call with `torch.profiler`
and aggregates the trace (`aggregate`). Only events that start within the
traced call count (a warm-up step of the profiler and a burst of
throwaway launches come before it):

- `per_category_ms`, `top_ops_ms`, `leaf_total_ms`, `line_totals_ms`: the
  JAX tool's keys, over the card's kernels, copies and fills (on the CPU:
  the host ops' self times);
- `busy_ms`: the union of the card's intervals over all streams, and
  `busy_share` = `busy_ms` / the call's wall time by CUDA events;
- `idle_gaps`: the ten longest gaps of at least 20 us in that union within
  the traced call, each with the innermost host op running at its middle,
  and `idle_by_host_op_ms` over every such gap;
- `launches`: kernel events by hand-written kernel group (`KERNEL_GROUPS`),
  printed beside the wrappers' launch counters over the traced call, and
  `hand_kernels` by instantiation.

    python -m bioscan_clip_tpu_torch.tools.trace_train_step \\
        [--batch 128] [--scan 8] [--remat-policy dots] [--host-crop] \\
        [--mode plain|gradcache|micro] \\
        [--step contrastive|finetune-image|finetune-joint] [--keep] [--cpu]

`--mode` gradcache and micro split the batch into 4 microbatches (the
flagship's 4 x 100 at B=400; GradCache's stage 1 in chunks of 200).
`--scan K` runs K steps a call, graphed on the card where train_cl graphs
them (the plain step and GradCache; micro accumulation runs one step a
call). `--step finetune-image` traces `train/fine_tuning.
make_classifier_train_step` over ViT-B/16 (every weight trained) and
`finetune-joint` `make_joint_classifier_train_step` over the image and DNA
towers, both with 797-way heads at B=200 unless --batch says otherwise.
The line gives the traced call's wall time beside an untraced call's
(`untraced_wall_ms`, after two warm calls): the profiler's host overhead
lengthens host-bound calls, so `untraced_busy_share` puts the traced
card time over the untraced wall time. `--keep` keeps the Chrome trace
(`trace.json` in `trace_dir`, for Perfetto). Runs on the card unless
`--cpu` is given; without CUDA it raises. Prints one JSON line with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import subprocess
import tempfile
import time

# JAX's op categories and their keys, so that XLA op names sort as JAX
# sorts them (tools/trace_train_step.py)
CATEGORIES = (
    ("matmul", ("dot", "conv", "fusion.*dot")),
    ("copy", ("copy", "transpose", "reshape", "bitcast")),
    ("rng", ("rng", "threefry", "philox", "iota_rbg")),
    ("reduce", ("reduce", "sort", "top-k", "topk")),
)
# CUDA kernel names, checked before JAX's keys (an NCCL all-reduce kernel
# would else be a "reduce", a copy kernel an "elementwise" one's opposite)
CUDA_CATEGORIES = (
    ("collective", ("nccl",)),
    ("matmul", ("gemm", "nvjet", "xmma", "cutlass")),
    ("copy", ("memcpy", "memset")),
    ("elementwise", ("elementwise_kernel",)),
)
# The hand-written kernels, checked before any category: (group, kernel
# symbols, {template argument index: value} or None). The sm90 bodies'
# template flags tell the forward's K1/K2 from K2d (DROP) and K1m (MASK),
# K3 from K3m (MASK), K4 and K5 from K6 (ROWMAX); the first match wins.
KERNEL_GROUPS = (
    ("K1m fwd sm90", ("mha_fwd_sm90",), {3: "true"}),
    ("K2d fwd sm90", ("mha_fwd_sm90",), {2: "true"}),
    ("K1/K2 fwd sm90", ("mha_fwd_sm90",), None),
    ("K1/K1m/K2/K2d fwd mma.sync", ("mha_fwd_mma",), None),
    ("K1/K1m/K2/K2d fwd FFMA", ("mha_fwd_kernel",), None),
    ("K3m bwd sm90 pass A", ("mha_bwd_sm90_pass_a",), {2: "true"}),
    ("K3 bwd sm90 pass A", ("mha_bwd_sm90_pass_a",), None),
    ("K3m bwd sm90 pass B", ("mha_bwd_sm90_pass_b",), {1: "true"}),
    ("K3 bwd sm90 pass B", ("mha_bwd_sm90_pass_b",), None),
    ("K3/K3m bwd pass A mma.sync/FFMA", ("bwd_query_rows",), None),
    ("K3/K3m bwd pass B+C mma.sync/FFMA",
     ("bwd_key_rows", "dbias_sum_heads"), None),
    ("K6 sm90", ("topk_f32_sm90", "topk_i8_sm90"), {3: "true"}),
    ("K4 sm90", ("topk_f32_sm90",), None),
    ("K4/K6 sm90 query split", ("split_queries",), None),
    ("K4 mma.sync", ("topk_f32_pass1",), None),
    ("K5 sm90", ("topk_i8_sm90",), None),
    ("K5 mma.sync", ("topk_i8_pass1",), None),
    ("K4/K5 pass 2", ("topk_pass2",), None),
    ("K6 mma.sync", ("mm_only_f32_pass1", "mm_only_i8_pass1"), None),
    ("K6 pass 2", ("mm_only_pass2",), None),
    ("K7", ("tiny_kernel",), None),
)
GROUPS = tuple(g for g, _, _ in KERNEL_GROUPS)
_FWD = tuple(g for g in GROUPS if " fwd " in g)
# The wrappers' launch counters (`train/graphs.read_counters`) and the
# groups their kernels land in: each counted launch makes at least one
# kernel event in those groups (K3's pass A once a launch, K5's seed and
# pass 1 both `topk_i8_sm90`).
COUNTER_GROUPS = (
    (("mha_packed.launches", "mha_packed.mask_launches", "mha.launches",
      "mha_dropout.launches"), _FWD),
    (("mha_packed.sm90_launches", "mha.sm90_launches"), ("K1/K2 fwd sm90",)),
    (("mha_dropout.sm90_launches",), ("K2d fwd sm90",)),
    (("mha_packed.mask_sm90_launches",), ("K1m fwd sm90",)),
    (("mha_bwd.launches", "mha_bwd.mask_launches"),
     ("K3 bwd sm90 pass A", "K3m bwd sm90 pass A",
      "K3/K3m bwd pass A mma.sync/FFMA")),
    (("mha_bwd.sm90_launches",), ("K3 bwd sm90 pass A",)),
    (("mha_bwd.sm90_launches",), ("K3 bwd sm90 pass B",)),
    (("mha_bwd.mask_sm90_launches",), ("K3m bwd sm90 pass A",)),
    (("mha_bwd.mask_sm90_launches",), ("K3m bwd sm90 pass B",)),
    (("topk.sm90_launches",), ("K4 sm90",)),
    (("topk.mma_launches",), ("K4 mma.sync",)),
    (("topk_i8.sm90_launches",), ("K5 sm90",)),
    (("topk_i8.mma_launches",), ("K5 mma.sync",)),
    (("mm_only.sm90_launches",), ("K6 sm90",)),
    (("mm_only.mma_launches",), ("K6 mma.sync",)),
    (("tiny.launches",), ("K7",)),
)
# Chrome-trace categories: the card's leaf work, the host's ops, and the
# host's spans (ops and annotations) that name an idle gap
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_OPS = ("cpu_op", "cuda_runtime", "cuda_driver")
HOST_CATS = HOST_OPS + ("user_annotation",)
# the host span around the traced call: the window of busy and idle time
TRACE_SPAN = "traced call"
MIN_GAP_NS = 20_000
PRIME_LAUNCHES = 256  # `_prime`'s throwaway launches
# the flagship, as model_config/lora_vit_lora_barcode_bert_lora_bert_5m
# declares it (random seeded weights: no pretrained weights ship here)
FLAGSHIP = {
    "image": {"input_type": "image", "model": "lora_vit"},
    "dna": {"input_type": "sequence", "model": "lora_barcode_bert"},
    "language": {"input_type": "sequence", "model": "lora_bert"},
    "output_dim": 768,
    "load_ckpt": False,
}
INSECT_SEEN = 797  # the INSECT fine-tunes' classes
FINETUNE_BATCH = 200  # general_fine_tune_setting.batch_size
# --remat-policy: none (no per-layer remat) or a policy of models/common.py
REMAT_POLICIES = ("none", "full", "dots", "narrow", "wide", "dots_act")
ACCUM_STEPS = 4  # --mode gradcache and micro: 4 x 100 at B=400
GC_S1_CHUNK = 200  # GradCache's stage-1 chunk, as chip_smoke's train_cl


def _template_args(name: str, symbol: str):
    """The template arguments of `symbol` in a demangled kernel name
    (`void f<5, true>(...)`, as the profiler names kernels), as strings;
    None when the name gives none."""
    rest = name[name.find(symbol) + len(symbol):]
    if not rest.startswith("<"):
        return None
    depth, args, cur = 0, [], ""
    for ch in rest[1:]:
        if ch == ">" and depth == 0:
            return args + [cur.strip()]
        if ch == "," and depth == 0:
            args.append(cur.strip())
            cur = ""
            continue
        depth += {"<": 1, ">": -1}.get(ch, 0)
        cur += ch
    return None


def kernel_group(name: str):
    """The hand-written kernel group of a kernel name, or None."""
    for group, symbols, cond in KERNEL_GROUPS:
        for sym in symbols:
            if sym not in name:
                continue
            if cond is None:
                return group
            args = _template_args(name, sym) or []
            if all(len(args) > i and args[i] == v for i, v in cond.items()):
                return group
    return None


def categorize(name: str) -> str:
    """A hand-written kernel's group, else a CUDA library category, else
    JAX's category of the name."""
    group = kernel_group(name)
    if group is not None:
        return group
    low = name.lower()
    for cat, keys in CUDA_CATEGORIES + CATEGORIES:
        for k in keys:
            if k.split(".*")[0] in low:
                return cat
    return "other"


def _self_times(events):
    """events: [(name, start_ns, dur_ns)]. Events on one xplane line NEST
    by time interval (a while/fusion parent span contains its children);
    summing raw durations double-counts every level (the round-3 B=64
    trace summed to ~3x the true device time). Attribute each event its
    SELF time: duration minus the time covered by its direct children,
    via a sweep over the interval containment stack."""
    evs = sorted(events, key=lambda e: (e[1], -e[2]))
    stack = []  # (name, start, end, child_cover)
    out = []

    def pop_to(t):
        while stack and stack[-1][2] <= t:
            name, s, e, cover = stack.pop()
            out.append((name, (e - s) - cover))
            if stack:
                stack[-1][3] += e - s  # this whole span is the parent's child time

    for name, s, d in evs:
        e = s + d
        pop_to(s)
        # close any stack frames this event does not nest into
        while stack and stack[-1][2] < e:
            n2, s2, e2, cover = stack.pop()
            out.append((n2, (e2 - s2) - cover))
            if stack:
                stack[-1][3] += e2 - s2
        stack.append([name, s, e, 0])
    pop_to(float("inf"))
    return [(n, max(0.0, t) / 1e6) for n, t in out]  # ms


def _innermost(events, times):
    """{t: (name, start_ns) of the innermost event of one line running at
    t, or None} for each time in `times`: the containment sweep of
    `_self_times`, stopped at each time."""
    evs = sorted(events, key=lambda e: (e[1], -e[2]))
    stack = []  # (name, start, end)
    out, i = {}, 0
    for t in sorted(times):
        while i < len(evs) and evs[i][1] <= t:
            name, s, d = evs[i]
            while stack and stack[-1][2] < s + d:
                stack.pop()  # ended, or not nesting this event
            stack.append((name, s, s + d))
            i += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out[t] = stack[-1][:2] if stack else None
    return out


def _union(intervals):
    """Merged [(start, end)] of half-open intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def _gaps(merged, window):
    """The [(start, end)] of `window` that no interval of `merged` (sorted,
    disjoint) covers."""
    lo, hi = window
    out, t = [], lo
    for s, e in merged:
        if e <= lo or s >= hi:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


def _events(trace: dict):
    """(cat, name, start_ns, dur_ns, line) of the complete events of a
    Chrome trace; the line is "stream S" on the card, "thread T" on the
    host."""
    out = []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        line = (f"stream {ev.get('tid')}" if cat in DEVICE_CATS
                else f"thread {ev.get('tid')}")
        out.append((cat, ev.get("name", ""), round(float(ev["ts"]) * 1e3),
                    round(float(ev["dur"]) * 1e3), line))
    return out


def _r(x, nd=6):
    return None if x is None else round(x, nd)


def aggregate_events(events, wall_ms, card: bool = True) -> dict:
    """The aggregate of `_events` (module doc) within the traced call's
    span (`TRACE_SPAN`; the whole trace without one): events that start
    outside it are left out. `card`: whether the card was traced; without
    it the leaf ops are the host ops (their self times, as
    `host_self_ms`) and every card field is None."""
    span = [(s, s + d) for c, n, s, d, _ in events
            if c == "user_annotation" and n == TRACE_SPAN]
    if span:
        window = (min(s for s, _ in span), max(e for _, e in span))
        events = [e for e in events if window[0] <= e[2] <= window[1]]
    dev = [(n, s, d, ln) for c, n, s, d, ln in events if c in DEVICE_CATS]
    host, ops = collections.defaultdict(list), collections.defaultdict(list)
    for c, n, s, d, ln in events:
        if c in HOST_CATS:
            host[ln].append((n, s, d))
        if c in HOST_OPS:
            ops[ln].append((n, s, d))
    line_totals = {ln: sum(ms for _, ms in _self_times(evs))
                   for ln, evs in sorted(host.items())}
    ops = [part for evs in ops.values() for part in _self_times(evs)]
    self_by_op = collections.Counter()
    for n, ms in ops:
        self_by_op[n] += ms
    if card:
        leaves = [(n, d / 1e6) for n, _, d, _ in dev]
        for n, _, d, ln in dev:
            line_totals[ln] = line_totals.get(ln, 0.0) + d / 1e6
    else:
        leaves = ops
    per_op, per_cat = collections.Counter(), collections.Counter()
    for name, ms in leaves:
        per_op[name[:100]] += ms
        per_cat[categorize(name)] += ms
    out = {
        "leaf_total_ms": round(sum(ms for _, ms in leaves), 2),
        "line_totals_ms": {k: round(v, 2) for k, v in line_totals.items()},
        "per_category_ms": {k: round(v, 2) for k, v in per_cat.most_common()},
        "top_ops_ms": {k: round(v, 2) for k, v in per_op.most_common(25)},
        "host_self_ms": {k: round(v, 2)
                         for k, v in self_by_op.most_common(15)},
        "wall_ms": _r(wall_ms),
        "window_ms": None, "busy_ms": None, "busy_share": None,
        "idle_ms": None, "idle_gaps": None, "idle_by_host_op_ms": None,
        "launches": None, "kernel_events": None, "hand_kernels": None,
    }
    if not (card and dev):
        return out
    merged = _union((s, s + d) for _, s, d, _ in dev)
    if not span:
        window = (merged[0][0], merged[-1][1])
    busy = sum(min(e, window[1]) - max(s, window[0]) for s, e in merged
               if e > window[0] and s < window[1])
    gaps = [g for g in _gaps(merged, window) if g[1] - g[0] >= MIN_GAP_NS]
    mids = [(s + e) // 2 for s, e in gaps]
    inner = {}  # t -> (name, start) of the latest-started innermost op
    for evs in host.values():
        for t, hit in _innermost(evs, mids).items():
            if hit and (t not in inner or hit[1] > inner[t][1]):
                inner[t] = hit

    def host_op(t):
        hit = inner.get(t)
        return "(host Python)" if hit is None or hit[0] == TRACE_SPAN \
            else hit[0][:100]

    idle_by = collections.Counter()
    for (s, e), t in zip(gaps, mids):
        idle_by[host_op(t)] += (e - s) / 1e6
    longest = sorted(zip(gaps, mids), key=lambda g: g[0][0] - g[0][1])[:10]
    kernels = [n for c, n, _, _, _ in events if c == "kernel"]
    groups = collections.Counter(kernel_group(n) for n in kernels)
    out.update({
        "window_ms": _r((window[1] - window[0]) / 1e6),
        "busy_ms": _r(busy / 1e6),
        "busy_share": (None if not wall_ms
                       else round(busy / 1e6 / wall_ms, 4)),
        "idle_ms": _r((window[1] - window[0] - busy) / 1e6),
        "idle_gaps": [{"ms": _r((e - s) / 1e6),
                       "at_ms": _r((s - window[0]) / 1e6),
                       "host_op": host_op(t)} for (s, e), t in longest],
        "idle_by_host_op_ms": {k: _r(v) for k, v in idle_by.most_common(10)},
        "launches": {g: groups[g] for g in GROUPS if groups[g]},
        "kernel_events": len(kernels),
        "hand_kernels": dict(collections.Counter(
            n[:120] for n in kernels if kernel_group(n))),
    })
    return out


def aggregate(prof, wall_ms, trace_path=None) -> dict:
    """The aggregate of a `torch.profiler` profile (module doc). The
    profile is read through its Chrome trace, written to `trace_path`
    (kept) or to a temporary file (removed)."""
    from torch.profiler import ProfilerActivity

    tmp = None
    if trace_path is None:
        tmp = tempfile.mkdtemp(prefix="bscan_trace_")
        trace_path = os.path.join(tmp, "trace.json")
    try:
        prof.export_chrome_trace(trace_path)
        with open(trace_path) as f:
            trace = json.load(f)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    card = ProfilerActivity.CUDA in set(prof.activities)
    return aggregate_events(_events(trace), wall_ms, card=card)


def check(agg: dict, counters: dict) -> list:
    """What a traced call's line violates, as messages: the union busy time
    above the wall time, the categories not summing to the leaf total
    within 0.1 ms, a group with fewer kernel events than the wrappers'
    counters (`counters`: their growth over the call) launched there."""
    bad = []
    if agg.get("busy_ms") is None:
        return ["the profiler shows no card time"]
    if agg["busy_ms"] > agg["wall_ms"]:
        bad.append(f"busy {agg['busy_ms']} ms > wall {agg['wall_ms']} ms")
    cats = sum(agg["per_category_ms"].values())
    if abs(cats - agg["leaf_total_ms"]) > 0.1:
        bad.append(f"categories sum to {cats:.2f} ms, leaves "
                   f"{agg['leaf_total_ms']} ms")
    for names, groups in COUNTER_GROUPS:
        want = sum(counters.get(n, 0) for n in names)
        seen = sum(agg["launches"].get(g, 0) for g in groups)
        if want > seen:
            bad.append(f"{'+'.join(names)} = {want} launches, but "
                       f"{seen} kernel events in {list(groups)}")
    return bad


def card_line(dev):
    """The card's name and power limit as nvidia-smi gives them (None when
    `dev` is the CPU)."""
    if dev.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_call(fn, dev):
    """fn() once -> (its result, wall ms: CUDA events on the card, the
    host clock on the CPU)."""
    import torch

    sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, 1e3 * (time.perf_counter() - t0)
    ev = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
    ev[0].record()
    out = fn()
    ev[1].record()
    ev[1].synchronize()
    return out, ev[0].elapsed_time(ev[1])


def _prime(dev):
    """Throwaway launches and a pause at the start of a recording, outside
    the traced span. Late in a long process (after every other phase of
    chip_smoke.py) the profiler lost the first ~30 kernel records of a
    session, and with them a traced call's first launches; a fresh
    process lost none."""
    import torch

    if dev.type != "cuda":
        return
    z = torch.zeros(1, device=dev)
    for _ in range(PRIME_LAUNCHES):
        z.add_(1)
    torch.cuda.synchronize(dev)
    time.sleep(0.02)


def traced_call(fn, dev, trace_path=None):
    """fn() once under torch.profiler (the host, and the card when `dev`
    is one) -> (its result, wall ms as `timed_call`, `aggregate`)."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(dev)
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        prof.step()
        _prime(dev)
        with record_function(TRACE_SPAN):
            out, wall = timed_call(fn, dev)
    return out, wall, aggregate(prof, wall, trace_path)


def untraced_share(agg: dict, untraced_ms: float):
    """The traced call's card busy time over an untraced call's wall time:
    the busy share without the profiler's host overhead (the card's work
    taken as the profiler measured it)."""
    if agg["busy_ms"] is None:
        return None
    return round(agg["busy_ms"] / untraced_ms, 4)


def counter_growth(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def flagship_args(batch: int, device, **tpu):
    """The flagship's config at `batch`, frozen weights in bf16, with the
    `tpu` options train_cl reads."""
    from bioscan_clip_tpu_torch.config.core import ConfigNode

    return ConfigNode({
        "model_config": dict(FLAGSHIP, batch_size=batch),
        "device": str(device),
        "tpu": dict({"frozen_dtype": "bfloat16"}, **tpu)})


def make_inputs(batch: int, host_crop: bool = False, seed: int = 0) -> dict:
    """The JAX tool's batch (tools/trace_train_step.py:46-59), from numpy's
    seeded generator: uint8 (256, 384) frames, or (224, 224) host crops;
    133 DNA tokens; 20 text tokens; instance labels."""
    import numpy as np

    rng = np.random.default_rng(seed)
    img_hw = (224, 224) if host_crop else (256, 384)
    return {
        "image_u8": rng.integers(0, 256, size=(batch,) + img_hw + (3,))
        .astype(np.uint8),
        "dna": rng.integers(0, 1027, size=(batch, 133)),
        "language": {
            "input_ids": rng.integers(0, 30522, size=(batch, 20)),
            "token_type_ids": np.zeros((batch, 20), np.int64),
            "attention_mask": np.ones((batch, 20), np.int64),
        },
        "labels": np.arange(batch),
    }


def build_model(args, dev, frozen_bf16: bool = True):
    """The flagship as train_cl builds it (`models.clip.load_clip_model`),
    frozen weights in bf16 under bf16 compute (`frozen_bf16`; the eval
    job and serving keep them in fp32)."""
    import torch

    from bioscan_clip_tpu_torch.cli.train_cl import ln_dtype_of
    from bioscan_clip_tpu_torch.device import compute_dtype
    from bioscan_clip_tpu_torch.models.clip import load_clip_model
    from bioscan_clip_tpu_torch.train.state import cast_frozen_params

    dtype = compute_dtype(dev)
    model = load_clip_model(args, device=dev, dtype=dtype,
                            ln_dtype=ln_dtype_of(args))
    if dtype == torch.bfloat16 and frozen_bf16:
        cast_frozen_params(model)
    return model, dtype


def _contrastive(batch, scan, remat_policy, host_crop, mode, dev):
    """(call, steps a call) of the contrastive step train_cl builds."""
    from bioscan_clip_tpu_torch.cli.train_cl import (
        make_step,
        steps_per_call_of,
    )
    from bioscan_clip_tpu_torch.train.loop import device_batch, stack_batches
    from bioscan_clip_tpu_torch.train.schedules import constant
    from bioscan_clip_tpu_torch.train.state import create_train_state

    tpu = {"steps_per_call": scan}
    if remat_policy != "none":
        tpu.update(remat=True, remat_policy=remat_policy)
    if mode != "plain":
        tpu.update(accum_steps=ACCUM_STEPS, accum_mode=mode)
    if mode == "gradcache":
        tpu.update(gc_s1_chunk=GC_S1_CHUNK)
    args = flagship_args(batch, dev, **tpu)
    model, dtype = build_model(args, dev)
    state = create_train_state(model, constant(1e-3))
    step = make_step(args, model, dtype, out=lambda *_: None)
    k = steps_per_call_of(args)
    host = make_inputs(batch, host_crop)
    holder = {"state": state, "seed": 7}
    if k > 1:
        stacked = device_batch(stack_batches([host] * k), dev)

        def call():
            seeds = [holder["seed"] + i for i in range(k)]
            holder["seed"] += k
            holder["state"], losses = step(holder["state"], stacked, seeds)
            return losses[-1]
    else:
        one = device_batch(host, dev)

        def call():
            holder["seed"] += 1
            holder["state"], loss = step(holder["state"], one,
                                         holder["seed"])
            return loss
    return call, k


def _finetune(batch, host_crop, joint, dev):
    """(call, 1) of the INSECT fine-tune step: ViT-B/16 with every weight
    trained (`lora_rank=0`, as `cli/fine_tune_vitb_on_insect.
    build_classifier`), or the flagship's image and DNA towers (`joint`,
    as `cli/supervised_fine_tune_bioscan_clip_model_on_insect`), each
    with a 797-way head."""
    import numpy as np

    from bioscan_clip_tpu_torch.device import compute_dtype
    from bioscan_clip_tpu_torch.models.clip import (
        init_weights,
        load_clip_model,
    )
    from bioscan_clip_tpu_torch.models.heads import EncoderWithHead
    from bioscan_clip_tpu_torch.train.fine_tuning import (
        create_fine_tune_state,
        make_classifier_train_step,
        make_joint_classifier_train_step,
    )
    from bioscan_clip_tpu_torch.train.loop import _to_device

    args = flagship_args(batch, dev)
    host = make_inputs(batch, host_crop)
    target = np.random.default_rng(1).integers(0, INSECT_SEEN, size=batch)
    dtype = compute_dtype(dev)

    def head(tower, seed):
        clf = EncoderWithHead(tower, FLAGSHIP["output_dim"], INSECT_SEEN,
                              dtype=dtype)
        init_weights(clf.new_linear_layer.to(dev), seed=seed)
        return clf

    b = {"target": _to_device(target, dev)}
    if joint:
        clip = load_clip_model(args, device=dev, dtype=dtype)
        step = make_joint_classifier_train_step(
            head(clip.image_encoder, 1), head(clip.dna_encoder, 2))
        b.update(image=_to_device(host["image_u8"], dev),
                 dna=_to_device(host["dna"], dev))
    else:
        clip = load_clip_model(args, device=dev, dtype=dtype, lora_rank=0)
        step = make_classifier_train_step(
            head(clip.image_encoder.lora_vit, 1), modality="image")
        b["input"] = _to_device(host["image_u8"], dev)
    holder = {"state": create_fine_tune_state(step.model), "seed": 7}

    def call():
        holder["seed"] += 1
        holder["state"], loss = step(holder["state"], b, holder["seed"])
        return loss
    return call, 1


def run_dispatch(batch, scan, remat_policy, host_crop, mode="plain",
                 device=None, step="contrastive", trace_path=None) -> dict:
    """Warm one call, time one untraced call, trace one call (module doc)
    -> the port's fields of the tool's line, `agg` among them. `device`:
    cuda (default) or cpu."""
    from bioscan_clip_tpu_torch.device import resolve_device
    from bioscan_clip_tpu_torch.train.graphs import read_counters

    dev = resolve_device(device)
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat policy {remat_policy!r}, expected one of "
                         f"{REMAT_POLICIES}")
    if step == "contrastive":
        call, k = _contrastive(batch, scan, remat_policy, host_crop, mode,
                               dev)
    elif step in ("finetune-image", "finetune-joint"):
        call, k = _finetune(batch, host_crop, step == "finetune-joint", dev)
    else:
        raise ValueError(f"step {step!r}: expected contrastive, "
                         "finetune-image or finetune-joint")
    t0 = time.perf_counter()
    for _ in range(2):  # builds the kernels, warms up, captures graphs
        timed_call(call, dev)
    warm_s = time.perf_counter() - t0
    _, untraced = timed_call(call, dev)
    before = read_counters()
    loss, wall, agg = traced_call(call, dev, trace_path)
    return {"agg": agg, "steps_in_call": k, "wall_ms": _r(wall),
            "untraced_wall_ms": _r(untraced),
            "untraced_busy_share": untraced_share(agg, untraced),
            "warm_s": _r(warm_s), "loss": float(loss),
            "counters": counter_growth(before, read_counters())}


def main(argv=None, emit=print) -> dict:
    from bioscan_clip_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="\n".join(__doc__.splitlines()[1:]))
    ap.add_argument("--batch", type=int, default=None,
                    help="rows a step (default 128; 200 for the fine-tunes)")
    ap.add_argument("--scan", type=int, default=8,
                    help="train steps a call (tpu.steps_per_call)")
    ap.add_argument("--remat-policy", default="dots", choices=REMAT_POLICIES,
                    help="per-layer remat (tpu.remat_policy); none: off")
    ap.add_argument("--host-crop", action="store_true",
                    help="(224, 224) frames in place of (256, 384)")
    ap.add_argument("--mode", default="plain",
                    choices=("plain", "gradcache", "micro"),
                    help="tpu.accum_mode (4 microbatches)")
    ap.add_argument("--step", default="contrastive",
                    choices=("contrastive", "finetune-image",
                             "finetune-joint"))
    ap.add_argument("--keep", action="store_true",
                    help="keep the Chrome trace for Perfetto")
    ap.add_argument("--cpu", action="store_true",
                    help="run and trace on the CPU (no card fields)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    batch = args.batch or (FINETUNE_BATCH if args.step != "contrastive"
                           else 128)
    trace_dir = tempfile.mkdtemp(prefix="bscan_trace_")
    try:
        res = run_dispatch(batch, args.scan, args.remat_policy,
                           args.host_crop, args.mode, dev, args.step,
                           os.path.join(trace_dir, "trace.json"))
    finally:
        if not args.keep:
            shutil.rmtree(trace_dir, ignore_errors=True)
    agg = res.pop("agg")
    out = {"batch": batch, "scan": args.scan,
           "remat_policy": args.remat_policy, "host_crop": args.host_crop,
           "trace_dir": trace_dir if args.keep else None, "agg": agg,
           "per_step_leaf_ms": round(agg["leaf_total_ms"]
                                     / res["steps_in_call"], 2),
           "mode": args.mode, "step": args.step, "device": dev.type,
           "card": card_line(dev),
           **res}
    emit(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
