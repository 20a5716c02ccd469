"""The readings that a cell's correctness limits are set from, on the
card, several seeds in one process (the benchmark's own runs never run
this):

    python3 benchmark/readings.py --workload <name> --seeds 1,2,3 \\
        --what program|control|half|answer [--seconds 3]

- program: the program as a run drives it (train: set-up and the checked
  steps, which need no window; search: set-up and a window of --seconds),
  then the run's check;
- control: the reference, computed in the lower precision, in the
  program's place (train: every product's operands in fp8, forward and
  backward; search: the tower's in fp8 and the search's in bfloat16);
- half: half of each batch or request left out in the program's place
  (train: the reference trained on the first half of each batch's rows,
  the mean over them; search: the second half of each request answered
  with the first half's answers);
- answer: an answer altered where it is produced (search: one served
  species label of each request changed to another species).
A train state left unchanged reads 1 in change_gap by its definition and
needs no run. Prints one JSON line a seed, and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(workload, seed, what, seconds, device="cuda", files=None,
             detail=None):
    """The numbers of one reading; `detail` (a dict) gets the cell's
    worst leaves or requests where it records them."""
    import torch

    from benchmark import run as brun

    bench = brun.load_json(ROOT / "BENCHMARK.json")
    cell, cfg, traffic, limits = files or brun.cell_files(bench, workload,
                                                          ROOT)
    c = brun.kind_module(traffic).Cell(cfg, traffic, seed,
                                       torch.device(device))
    try:
        return _readings(c, traffic, cfg, what, seconds)
    finally:
        if detail is not None:
            detail.update(getattr(c, "worst", {}))


def _readings(c, traffic, cfg, what, seconds):
    kind = traffic["kind"]
    if what == "program":
        c.setup()
        if kind == "search":
            c.window(seconds)
        c.free()
        return c.check()
    if kind == "train":
        want = c.reference_run()
        if what == "control":
            return c.compare(c.reference_run("fp8"), want)
        if what == "half":
            b = traffic["batch"]
            return c.compare(c.reference_run(rows=list(range(b // 2))), want)
        raise SystemExit(f"{what}: no such reading of a train cell")
    c.make_requests()
    reqs = c.sample() if c.scheduled_records(traffic["schedule_requests"]) \
        else []
    want = c.reference_answers(reqs)
    if what == "control":
        return c.compare(c.control_answers(reqs), want)
    got = {k: (v[0].clone(), v[1].clone()) for k, v in want.items()}
    for sims, sps in got.values():
        n = sims.shape[0]
        if what == "half":
            sims[n - n // 2:] = sims[:n // 2]
            sps[n - n // 2:] = sps[:n // 2]
        elif what == "answer":
            sps[0, 0] = (sps[0, 0] + 1) % cfg["serve_keys"]["species"]
        else:
            raise SystemExit(f"{what}: no such reading of a search cell")
    return c.compare(got, want)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", required=True,
                   choices=("program", "control", "half", "answer"))
    p.add_argument("--seconds", type=float, default=3.0)
    a = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.run import cache_env
    from benchmark.trace_agg import card_line

    cache_env()
    import torch

    print(f"card: {card_line(torch.device('cuda'))}", flush=True)
    for seed in (int(s) for s in a.seeds.split(",")):
        t, detail = time.time(), {}
        out = readings(a.workload, seed, a.what, a.seconds, detail=detail)
        print(json.dumps({"workload": a.workload, "what": a.what,
                          "seed": seed, "numbers": out,
                          "seconds": round(time.time() - t, 1),
                          "detail": detail}), flush=True)


if __name__ == "__main__":
    main()
