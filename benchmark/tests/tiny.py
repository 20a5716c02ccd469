"""Small sizes of the benchmark's cells for the CPU tests: the
configurations' geometry cut to width 64, two layers, and the port's
towers built to the same geometry (its tower configs patched)."""

from __future__ import annotations

import copy
import dataclasses
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TRAIN = "flagship_5m.train_b400"
SEARCH = "openclip_vitl14.classify_image_plates"
WIDTH, LAYERS, HEADS, OUT = 64, 2, 2, 64
# at width 64 and two layers, weights of the full size's spread (0.02) map
# every frame to nearly one embedding, and a planted fault hides in it
WEIGHT_STD = 0.3


def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _tower(g):
    g = dict(g, hidden=WIDTH, layers=LAYERS, heads=HEADS, output_dim=OUT)
    if "mlp" in g:
        g["mlp"] = 4 * WIDTH
    if "intermediate" in g:
        g["intermediate"] = 2 * WIDTH
    if g["tower"] in ("vit", "openclip_visual"):
        g["patch"] = 56
    return g


def files(workload: str, limits=None):
    """(cell, configuration, traffic, limits) of `workload` at small
    sizes; `limits` replaces the limits file's."""
    from benchmark.run import cell_files

    cell, cfg, tr, lim = cell_files(bench(), workload, ROOT)
    cfg = copy.deepcopy(cfg)
    cfg["geometry"] = {k: _tower(v) for k, v in cfg["geometry"].items()}
    cfg["model_config"]["output_dim"] = OUT
    tr = dict(tr)
    if tr["kind"] == "train":
        tr.update(batch=8, pool=4, reference_block=4)
    else:
        tr.update(plate_size=3, frame_pool=24, schedule_requests=30,
                  check_queries=12)
        cfg["serve_keys"] = {"count": 4096, "species": 64, "genus_count": 32,
                             "family_count": 8, "order_count": 2}
    return cell, cfg, tr, dict(lim if limits is None else limits)


def patch_towers(monkeypatch):
    """The port's towers at the small geometry, and the benchmark's weights
    at the small size's spread."""
    from benchmark import weights
    from bioscan_clip_tpu_torch.models import bert, clip, openclip, vit

    monkeypatch.setattr(weights, "WEIGHT_STD", WEIGHT_STD)

    def small(cfg_cls, **extra):
        def make(**kw):
            return dataclasses.replace(cfg_cls(**kw), **extra)
        return make

    monkeypatch.setattr(clip, "ViTConfig", small(
        vit.ViTConfig, hidden_size=WIDTH, num_layers=LAYERS,
        num_heads=HEADS, mlp_ratio=4, patch_size=56))
    for name in ("BARCODE_BERT_CONFIG", "BERT_SMALL_CONFIG"):
        monkeypatch.setattr(clip, name, dataclasses.replace(
            getattr(bert, name), hidden_size=WIDTH, num_layers=LAYERS,
            num_heads=HEADS, intermediate_size=2 * WIDTH))
    monkeypatch.setattr(clip, "OpenClipVisionConfig", small(
        openclip.OpenClipVisionConfig, width=WIDTH, layers=LAYERS,
        heads=HEADS, patch_size=56))
    monkeypatch.setattr(clip, "OpenClipTextConfig", small(
        openclip.OpenClipTextConfig, width=WIDTH, layers=LAYERS,
        heads=HEADS))


def run(workload: str, seed: int = 7, limits=None, seconds: float = 0.0,
        trace: bool = False):
    from benchmark.run import run_cell

    return run_cell(bench(), workload, seed, seconds, trace, device="cpu",
                    root=ROOT, files=files(workload, limits))
