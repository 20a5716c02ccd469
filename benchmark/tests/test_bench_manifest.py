"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re

import pytest

from benchmark.tests.tiny import ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    b = bench()
    assert set(b) == TOP
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in b["paths"])
    assert 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits in 43,200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_keys():
    b = bench()
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "bound" not in m and "\n" not in m["layer"]
    names += [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)


def test_the_metrics_and_cells():
    b = bench()
    assert {m["name"] for m in b["end_to_end"]} == {
        "setup_s", "train_samples_per_s", "search_queries_per_s",
        "search_p95_ms"}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    assert cells == {"flagship_5m.train_b400",
                     "openclip_vitl14.classify_image_plates"}
    for m in b["per_layer"]:
        moved = e2e[m["moves"]]
        # each cell that lists it reports the metric it moves
        assert m["workloads"] and set(m["workloads"]) <= set(
            moved.get("workloads", cells))
    for w in cells:
        reported = [m for m in b["per_layer"] if w in m["workloads"]]
        assert reported and any(w in m.get("workloads", cells) and
                                m["name"] != "setup_s"
                                for m in b["end_to_end"])


@pytest.mark.parametrize("kind", ["configs", "traffic", "limits",
                                  "metrics"])
def test_every_file_is_found_by_name(kind):
    b = bench()
    if kind == "configs":
        for c in b["configs"]:
            cfg = json.loads((ROOT / c["file"]).read_text())
            assert cfg["source"] == c["source"]
            assert cfg["reduced"] == c["reduced"]
    elif kind == "traffic":
        for w in b["workloads"]:
            tr = json.loads((ROOT / "benchmark" / "traffic" /
                             f"{w['traffic']}.json").read_text())
            assert (ROOT / "benchmark" / "kinds" /
                    f"{tr['kind']}.py").is_file()
    elif kind == "limits":
        for w in b["workloads"]:
            lim = json.loads((ROOT / "benchmark" / "limits" /
                              f"{w['name']}.json").read_text())
            assert lim and all(v is not None and v > 0
                               for v in lim.values())
    else:
        from benchmark.run import reader

        for m in b["per_layer"]:
            assert callable(reader(m["name"]))
