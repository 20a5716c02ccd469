"""Multi-process execution: one process per card, joined by
`torch.distributed`.

Counterpart of bioscan_clip_tpu/parallel/distributed.py:27-78. The
reference launches one process per GPU (`mp.spawn` + NCCL, reference
scripts/train_cl.py:42-46, 249-252); so does the port: NCCL between cards,
gloo between CPU processes (the tests). `parallel/mesh.create_mesh` then
puts the ranks on one `data` axis.

Triggers, first match wins:
- `args.tpu.distributed` as a dict {coordinator, num_processes,
  process_id}, or the `BSCAN_COORDINATOR` / `BSCAN_NUM_PROCESSES` /
  `BSCAN_PROCESS_ID` variables (each dict key may come from its
  variable): `init_process_group(init_method="tcp://<coordinator>")`;
- `args.tpu.distributed: auto` or `BSCAN_DISTRIBUTED=auto`: `torchrun`'s
  `env://` (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`);
- otherwise one process, no group.
A process's card is `cuda:<LOCAL_RANK>` (torchrun sets it; else the rank
modulo the cards this host has). A second call is a no-op. A failed
initialization raises: it never falls back to one process.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def _say(log, msg):
    if log:
        log(msg)


def local_rank(rank: Optional[int] = None) -> int:
    """This process's card index on its host: `LOCAL_RANK`, else the rank
    (default this process's, 0 without a group) modulo the host's cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return rank % max(torch.cuda.device_count(), 1)


def process_device(device) -> torch.device:
    """The device this process runs on: `cuda:<local rank>` for a cuda
    device under a process group, else `device` as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        return torch.device("cuda", local_rank())
    return dev


def maybe_initialize_distributed(args=None, log=None,
                                 device="cuda") -> Tuple[int, int]:
    """Join the process group `args` or the environment asks for ->
    (rank, world size); (0, 1) when none is asked for. `device` picks the
    backend: NCCL for cuda (this process's card set as current first),
    gloo for cpu."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    tpu_cfg = getattr(args, "tpu", None) if args is not None else None
    cfg = tpu_cfg.get("distributed", None) if tpu_cfg else None
    env = os.environ
    kw: dict = {}
    if isinstance(cfg, dict) or (cfg is None and env.get("BSCAN_COORDINATOR")):
        cfg = dict(cfg or {})
        coordinator: Optional[str] = (cfg.get("coordinator")
                                      or env.get("BSCAN_COORDINATOR"))
        nproc = cfg.get("num_processes", env.get("BSCAN_NUM_PROCESSES"))
        pid = cfg.get("process_id", env.get("BSCAN_PROCESS_ID"))
        if not coordinator or nproc is None or pid is None:
            raise ValueError(
                "a distributed run needs a coordinator, num_processes and "
                "process_id (tpu.distributed or BSCAN_COORDINATOR, "
                "BSCAN_NUM_PROCESSES, BSCAN_PROCESS_ID)")
        kw = dict(init_method=f"tcp://{coordinator}",
                  world_size=int(nproc), rank=int(pid))
    elif cfg == "auto" or env.get("BSCAN_DISTRIBUTED") == "auto":
        kw = dict(init_method="env://")
    elif cfg is not None:
        raise ValueError(f"tpu.distributed={cfg!r}: expected a dict, "
                         "'auto' or null")
    else:
        return 0, 1
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank(kw.get("rank",
                                                int(env.get("RANK", 0)))))
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend=backend, **kw)
    rank, world = dist.get_rank(), dist.get_world_size()
    _say(log, f"torch.distributed ({backend}) initialized: process "
         f"{rank}/{world} via {kw['init_method']}")
    return rank, world
