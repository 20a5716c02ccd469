"""A whole run of each cell at small sizes on the CPU (the harness's look
for a card skipped): the result line's keys, a sound run correct, the
control and each planted fault not correct, and a cell added by files
alone."""

import json
import shutil

import pytest
import torch

from benchmark.tests import tiny

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


def result_keys(out):
    return [k for k in out if not k.startswith("_")]


@pytest.mark.parametrize("workload", [tiny.TRAIN, tiny.SEARCH])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(small_towers, workload, trace):
    out = tiny.run(workload, seed=2**31 + 17, seconds=0.2, trace=trace)
    keys = result_keys(out)
    assert keys == REQUIRED + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"], name
    bench = tiny.bench()
    want = {m["name"] for m in (bench["per_layer"] if trace
                                else bench["end_to_end"])
            if workload in m.get("workloads", [workload])}
    got = set(out["metrics"])
    if trace:  # the CPU has no card time: only the rates' shares remain
        assert got <= want and any(n.startswith("mfu") for n in got)
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert got == want
    json.dumps({k: out[k] for k in keys})


def _numbers(workload, what, seed=5):
    from benchmark.readings import readings

    return readings(workload, seed, what, 0.2, device="cpu",
                    files=tiny.files(workload))


def _fails(workload, numbers):
    lim = tiny.files(workload)[3]
    return [k for k, v in numbers.items() if v > lim[k]]


@pytest.mark.parametrize("workload", [tiny.TRAIN, tiny.SEARCH])
def test_the_control_is_not_correct(small_towers, workload):
    assert _fails(workload, _numbers(workload, "control"))


@pytest.mark.parametrize("workload,what", [(tiny.TRAIN, "half"),
                                           (tiny.SEARCH, "half"),
                                           (tiny.SEARCH, "answer")])
def test_a_fault_in_the_reference_s_place_is_not_correct(small_towers,
                                                         workload, what):
    assert _fails(workload, _numbers(workload, what))


def _unchanged_state(monkeypatch):
    from bioscan_clip_tpu_torch.train import state

    real = state.create_train_state

    def frozen_state(*a, **kw):
        st = real(*a, **kw)
        st.optimizer.step = lambda closure=None: None
        return st

    monkeypatch.setattr(state, "create_train_state", frozen_state)


def _half_batch_loss(monkeypatch):
    from bioscan_clip_tpu_torch.train import loop

    real = loop.multimodal_contrastive_loss

    def half(embs, labels, scale):
        h = labels.shape[0] // 2
        return real({k: None if v is None else v[:h]
                     for k, v in embs.items()}, labels[:h], scale)

    monkeypatch.setattr(loop, "multimodal_contrastive_loss", half)


def _altered_answer(monkeypatch):
    from bioscan_clip_tpu_torch.retrieval import service

    real = service.make_prediction

    def altered(*a, **kw):
        preds, *rest = real(*a, **kw)
        p = preds[0]
        p["species"][0] = "species1" if p["species"][0] != "species1" \
            else "species2"
        return [preds, *rest]

    monkeypatch.setattr(service, "make_prediction", altered)


def _half_request(monkeypatch):
    from bioscan_clip_tpu_torch.retrieval.service import RetrievalService

    real = RetrievalService._run_bucketed

    def half(self, name, x, n):
        emb = real(self, name, x, n)
        emb[n - n // 2:] = emb[:n // 2]
        return emb

    monkeypatch.setattr(RetrievalService, "_run_bucketed", half)


@pytest.mark.parametrize("workload,plant", [
    (tiny.TRAIN, _unchanged_state), (tiny.TRAIN, _half_batch_loss),
    (tiny.SEARCH, _altered_answer), (tiny.SEARCH, _half_request)])
def test_a_fault_in_the_timed_path_is_not_correct(small_towers, monkeypatch,
                                                  workload, plant):
    plant(monkeypatch)
    out = tiny.run(workload, seed=11, seconds=0.2)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_a_cell_added_by_files_alone(small_towers, tmp_path):
    """A copy of the checkout's benchmark with one more traffic mix, its
    limits, one more per-layer reader and one more cell: no file that is
    there changes, and the run finds the new ones by name."""
    from benchmark.run import cell_files, run_cell

    shutil.copytree(tiny.ROOT / "benchmark", tmp_path / "benchmark")
    bench = tiny.bench()
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    b = tmp_path / "benchmark"
    tr = json.loads((b / "traffic" / "train_b400.json").read_text())
    (b / "traffic" / "train_b200.json").write_text(json.dumps(
        dict(tr, batch=200)))
    (b / "limits" / "flagship_5m.train_b200.json").write_text(
        (b / "limits" / "flagship_5m.train_b400.json").read_text())
    (b / "metrics" / "steps.train.py").write_text(
        "def read(m):\n    return float(m['work']['steps'])\n")
    bench["workloads"].append({"name": "flagship_5m.train_b200",
                               "config": "flagship_5m",
                               "traffic": "train_b200", "chips": 1,
                               "why": "a smaller batch"})
    bench["per_layer"].append({"name": "steps.train", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "device",
                               "moves": "train_samples_per_s",
                               "workloads": ["flagship_5m.train_b200"]})
    # the cell joins the metrics of its kind by entries of the manifest
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "flagship_5m.train_b400" in m.get("workloads", []):
            m["workloads"].append("flagship_5m.train_b200")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for path, data in before.items():
        assert (tmp_path / path).read_bytes() == data
    cell, cfg, traffic, limits = cell_files(bench, "flagship_5m.train_b200",
                                            tmp_path)
    assert traffic["batch"] == 200
    files = tiny.files("flagship_5m.train_b400")
    out = run_cell(bench, "flagship_5m.train_b200", 3, 0.1, True,
                   device="cpu", root=tmp_path,
                   files=(cell, files[1], dict(files[2], batch=6), limits))
    assert out["metrics"]["steps.train"]["value"] == 3.0
    assert "mfu.train" in out["metrics"]
    assert out["correct"] is True
