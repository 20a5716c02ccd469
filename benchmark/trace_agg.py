"""Where the card's time goes in a traced span: a frozen copy of the port's
tracer aggregation (`bioscan_clip_tpu_torch/tools/trace_train_step.py`,
the constants, `kernel_group`, `categorize`, `_self_times`, `_innermost`,
`_union`, `_gaps`, `_events`, `aggregate_events`, `aggregate`,
`card_line`, `timed_call`, `_prime` and `traced_call`), kept here so that
a change to the program cannot change the yardstick.

Busy time is the union of the card's intervals over all streams within the
traced span; each idle gap of at least 20 us is named by the innermost
host op running at its middle. A traced span is preceded by a warm-up
step of the profiler's schedule and 256 throwaway launches: without them
the profiler's start-up fell inside the span, and late in a long process
it lost a session's first kernel records.
"""

from __future__ import annotations

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
# Chrome-trace categories: the card's leaf work, the host's ops, and the
# host's spans (ops and annotations) that name an idle gap
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_OPS = ("cpu_op", "cuda_runtime", "cuda_driver")
HOST_CATS = HOST_OPS + ("user_annotation",)
# the host span around the traced call: the window of busy and idle time
TRACE_SPAN = "traced call"
MIN_GAP_NS = 20_000
PRIME_LAUNCHES = 256  # `_prime`'s throwaway launches


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

