"""Run one cell of the benchmark once and print one JSON line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything is found by name from BENCHMARK.json at the root of the
checkout: the cell's configuration file (`configs/<config>.json`), its
traffic mix (`traffic/<traffic>.json`, whose "kind" names its module in
`kinds/`), its limits (`limits/<workload>.json`) and, with --trace 1, one
reader per per-layer metric (`metrics/<metric>.py`). Adding a cell of an
existing kind takes data files and entries only.

A run: set-up (build or load the kernels, weights from the seed, warm-up
of the cell's own shapes) -> the window of --seconds (the end-to-end
metrics) -> with --trace 1 a traced span of whole steps or requests (the
per-layer metrics) -> the device's peak memory -> the program freed -> the
check against the plain reference. It exits with an error, printing no
result, without CUDA or with fewer cards than the cell asks for, or when
JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

START = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "bioscan_clip_tpu")


def cache_env(root: Path = ROOT):
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's nvcc builds already go to build/torch_kernels/ there).
    Before torch is imported. The host's thread pools stay as the machine
    sets them, as a deployment runs."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, workload: str, root: Path = ROOT):
    """(cell, configuration, traffic, limits) of `workload`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load_json(root / conf["file"])
    traffic = load_json(root / "benchmark" / "traffic" /
                        f"{cell['traffic']}.json")
    limits = load_json(root / "benchmark" / "limits" / f"{workload}.json")
    return cell, cfg, traffic, limits


def kind_module(traffic: dict):
    return importlib.import_module(f"benchmark.kinds.{traffic['kind']}")


def reader(name: str, root: Path = ROOT):
    """The `read` function of metrics/<name>.py."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reports(metric: dict, workload: str) -> bool:
    """Whether a cell reports this metric: by its "workloads" list, which
    every per-layer metric has; an end-to-end metric without one
    (`setup_s`) in every cell."""
    return workload in metric.get("workloads", [workload])


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def per_layer(bench, workload, agg, wall_ms, work, root: Path = ROOT):
    """{metric: {"value", "unit"}} of the cell's per-layer metrics whose
    readers find something to read in the traced span."""
    out = {}
    m = {"aggregate": agg, "wall_ms": wall_ms, "work": work}
    for metric in bench["per_layer"]:
        if workload not in metric["workloads"]:
            continue
        value = reader(metric["name"], root)(m)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def breakdown(agg: dict) -> dict:
    ops = list((agg.get("top_ops_ms") or {}).items())[:10]
    gaps = list((agg.get("idle_by_host_op_ms") or {}).items())[:10]
    return {"device_ops": [[n, ms / 1e3] for n, ms in ops],
            "idle_gaps": [[n, ms / 1e3] for n, ms in gaps]}


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device="cuda", root: Path = ROOT,
             start: float | None = None, files=None) -> dict:
    """One run of `workload` on `device` -> the result's dict (its
    "checks" hold each number compared beside its limit). `files`: the
    (cell, configuration, traffic, limits) to use in place of the
    checkout's (the CPU tests' small sizes)."""
    import torch

    cell, cfg, traffic, limits = files or cell_files(bench, workload, root)
    dev = torch.device(device)
    run = kind_module(traffic).Cell(cfg, traffic, seed, dev)
    run.setup()
    setup_s = time.time() - (START if start is None else start)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    stamps = {"setup_s": setup_s}
    t = time.time()
    win = run.window(seconds)
    stamps["window_s"] = time.time() - t
    e2e = [m for m in bench["end_to_end"] if reports(m, workload)]
    metrics, device_info = {}, {}
    card = None
    if trace:
        t = time.time()
        agg, wall_ms, work = run.traced()
        stamps["traced_s"] = time.time() - t
        stamps["card_ms_by_category"] = agg.get("per_category_ms")
        from benchmark.trace_agg import card_line

        card = card_line(dev)
        metrics = per_layer(bench, workload, agg, wall_ms, work, root)
        device_info = {"busy_s": (agg.get("busy_ms") or 0.0) / 1e3,
                       "window_s": (agg.get("window_ms") or wall_ms) / 1e3}
    else:
        values = dict(win["metrics"], setup_s=setup_s)
        units = {m["name"]: m["unit"] for m in e2e}
        metrics = {n: {"value": values[n], "unit": units[n]}
                   for n in units if n in values}
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        name, count = torch.cuda.get_device_name(dev), 1
    else:
        peak, name, count = 0, "cpu", 1
    run.free()
    t = time.time()
    numbers = run.check()
    stamps["check_s"] = time.time() - t
    found = forbidden_modules()
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in numbers.items()}
    correct = (win["failed"] == 0 and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values()))
    out = {"correct": bool(correct), "attempted": win["attempted"],
           "failed": win["failed"], "metrics": metrics,
           "device": dict({"platform": "gpu" if dev.type == "cuda"
                           else "cpu", "kind": name, "count": count,
                           "memory_peak_bytes": int(peak)}, **device_info)}
    if trace:
        out["breakdown"] = breakdown(agg)
    out["checks"] = checks
    out["_forbidden"] = found
    out["_window"] = dict({k: v for k, v in win.items() if k != "metrics"},
                          **stamps, card=card)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == a.workload),
                None)
    if cell is None:
        sys.exit(f"unknown workload {a.workload!r}")
    cache_env()
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this benchmark measures the card")
    if torch.cuda.device_count() < cell["chips"]:
        sys.exit(f"{a.workload} needs {cell['chips']} cards, "
                 f"{torch.cuda.device_count()} present")
    sys.path.insert(0, str(ROOT))
    out = run_cell(bench, a.workload, a.seed, a.seconds, bool(a.trace))
    found = out.pop("_forbidden")
    window = out.pop("_window")
    if found:
        sys.exit(f"loaded in this process once the window closed: {found}")
    print(f"window: {json.dumps(window)}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
