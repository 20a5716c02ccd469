"""Run logging and profiling.

Counterpart of bioscan_clip_tpu/utils/logging.py:
- `WandbRun` (:22-55): Weights & Biases when the run activates it (the
  reference's `activate_wandb`, off by default), `wandb` imported only
  then; where it is missing or its init fails, metrics go to a JSONL file
  (`<fallback_dir>/metrics_<name>.jsonl`), so a run is always observable.
- `profile_trace` (:58-71): a `torch.profiler` trace of the block (host and,
  on the card, CUDA activity) exported as a Chrome trace to
  `<log_dir>/trace.json`; nothing when `log_dir` is empty.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional


class WandbRun:
    """wandb if activated and importable, a JSONL file otherwise."""

    def __init__(self, project: str, name: str, activate: bool = False,
                 fallback_dir: str = "logs"):
        self._wandb = None
        self._file = None
        if not activate:
            return
        try:
            import wandb

            self._wandb = wandb.init(project=project, name=name)
        except Exception:  # no wandb, or no service: keep the metrics
            os.makedirs(fallback_dir, exist_ok=True)
            self._file = open(
                os.path.join(fallback_dir, f"metrics_{name}.jsonl"), "a")

    def log(self, metrics: dict, commit: bool = True):
        if self._wandb is not None:
            self._wandb.log(metrics, commit=commit)
        elif self._file is not None:
            rec = dict(metrics)
            rec["_t"] = time.time()
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
        if self._file is not None:
            self._file.close()
            self._file = None


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """`torch.profiler` over the block, written to `log_dir/trace.json`."""
    if not log_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
