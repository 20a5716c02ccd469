"""The data axis the port shards over, in one of two forms.

Counterpart of bioscan_clip_tpu/parallel/mesh.py. JAX puts every device on
one `data` axis of a `jax.sharding.Mesh` and lets XLA place the
collectives. The port has the two forms a card program has:
- under a process group (`parallel/distributed.py`, one process per card)
  the axis is the ranks, in rank order, each holding one device; the
  collectives are `torch.distributed`'s (NCCL between cards, gloo between
  CPU processes);
- otherwise the axis is the devices this process is given (the
  single-controller form of JAX's `serve` and `inference_and_eval`, which
  shard the keys of a search over the devices of one process). Entries may
  repeat a device: four shards on one card run the sharded search on a
  machine with one card.

Only the `data` axis exists: no step of the JAX package shards over
another. `shard_batch` gives each of this process's devices its rows; under
a process group the rows handed in are the process's own, and the global
batch is the rank-ordered concatenation of every process's rows, as JAX's
`make_array_from_process_local_data` assembles it (mesh.py:64-99).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """One `data` axis. `devices`: this process's devices on the axis, in
    axis order (one under a process group); `group`: the process group the
    axis spans, or None; `size`: the axis length; `index`: the axis
    position of this process's first device."""

    devices: Tuple[torch.device, ...]
    size: int
    index: int = 0
    group: Optional[object] = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.size}


def _axis_size(mesh_shape, n: int, what: str) -> int:
    if not mesh_shape:
        return n
    extra = sorted(set(mesh_shape) - {DATA_AXIS})
    if extra:
        raise ValueError(
            f"mesh axes {extra}: the port shards over the {DATA_AXIS!r} "
            "axis only (no step of the JAX package shards over another)")
    size = int(mesh_shape.get(DATA_AXIS, -1))
    if size == -1:
        return n
    if size != n:
        raise ValueError(f"mesh {{{DATA_AXIS!r}: {size}}} != {n} {what}")
    return size


def create_mesh(mesh_shape: Optional[dict] = None, devices=None) -> Mesh:
    """The `data` axis (`mesh_shape`: None, {data: N} or {data: -1}).

    Under a process group: the ranks, each on its device (`devices`: this
    process's one device, default its card from `LOCAL_RANK` under NCCL,
    the CPU under gloo). Otherwise: `devices` (default every card of the
    host)."""
    if dist.is_initialized():
        world = dist.get_world_size()
        if devices is None:
            if dist.get_backend() == "nccl":
                from bioscan_clip_tpu_torch.parallel.distributed import (
                    local_rank,
                )

                devices = [torch.device("cuda", local_rank())]
            else:
                devices = [torch.device("cpu")]
        devices = tuple(torch.device(d) for d in devices)
        if len(devices) != 1:
            raise ValueError(
                f"under a process group each process holds one device of "
                f"the axis, not {len(devices)}")
        size = _axis_size(mesh_shape, world, "processes")
        return Mesh(devices, size, dist.get_rank(), dist.group.WORLD)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass the devices "
                               "(e.g. devices=['cpu'] * 4) for a CPU mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    size = _axis_size(mesh_shape, len(devices), "devices")
    return Mesh(devices, size)


def _rows(batch) -> int:
    leaf = batch
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def _map(fn, batch):
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    return fn(batch)


def _to(x, device):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x
                           ).to(device)


def shard_batch(batch, mesh: Mesh) -> list:
    """A host batch (dict of arrays, nested dicts allowed) -> one dict per
    device of this process, each that device's rows as tensors on it.

    Under a process group `batch` is this process's rows (the loader's
    process-strided shard) and goes whole to its device. Otherwise the rows
    are cut into `mesh.size` equal parts, in axis order."""
    n = len(mesh.devices)
    rows = _rows(batch)
    if rows % n:
        raise ValueError(
            f"batch size {rows} must be divisible by the mesh's {n} "
            "devices (training batches shard evenly; for uneven eval tails "
            "use shard_batch_padded)")
    per = rows // n
    return [_map(lambda x, i=i, d=d: _to(x[i * per:(i + 1) * per], d),
                 batch) for i, d in enumerate(mesh.devices)]


def shard_batch_padded(batch, mesh: Mesh):
    """`shard_batch` after padding the rows to a multiple of this process's
    devices by repeating the last row -> (shards, original rows); callers
    trim outputs back to that many."""
    n = len(mesh.devices)
    rows = _rows(batch)
    pad = (-rows) % n
    if pad:
        def _pad(x):
            x = np.asarray(x)
            return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])

        batch = _map(_pad, batch)
    return shard_batch(batch, mesh), rows


def replicate_module(module: torch.nn.Module, mesh: Optional[Mesh]):
    """Make every process's parameters and buffers rank 0's (JAX
    `replicate_for_mesh`; DDP's broadcast at construction). A no-op
    without a process group."""
    if mesh is None or mesh.group is None:
        return module
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0, group=mesh.group)
    return module


def gather_rows(x, mesh: Mesh, counts=None):
    """all_gather of every process's (b, ...) rows -> (size * b, ...) in
    rank order, without gradient (cached embeddings, labels, top-k
    candidates). `counts`: the rows each process holds, in rank order, when
    they differ (`x` holds counts[mesh.index], 0 for a process with none):
    every part is padded to the most and the padding dropped."""
    counts = counts or (x.shape[0],) * mesh.size
    pad = max(counts) - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat([p[:c] for p, c in zip(parts, counts)])


class _GatherRows(torch.autograd.Function):
    """`gather_rows` with a gradient. Every process computes the same loss
    from the gathered rows, so the gradient of its own rows is already the
    whole loss's: the backward takes this process's rows of the incoming
    gradient and sums nothing across processes."""

    @staticmethod
    def forward(ctx, x, mesh, counts):
        counts = counts or (x.shape[0],) * mesh.size
        start = sum(counts[:mesh.index])
        ctx.rows = slice(start, start + counts[mesh.index])
        return gather_rows(x, mesh, counts)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rows], None, None


def gather_rows_grad(x, mesh: Mesh, counts=None):
    """The ClipLoss all_gather of the reference (loss_func.py:58-91):
    `gather_rows`, differentiable in this process's rows."""
    return _GatherRows.apply(x, mesh, counts)


def all_reduce_sum(tensors, mesh: Mesh):
    """Sum `tensors` over the processes in place, one all_reduce per dtype
    over a flat buffer."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, group=mesh.group)
        off = 0
        for t in group:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def mesh_from_config(args, device) -> Optional[Mesh]:
    """The mesh `tpu.mesh_shape` asks one process for: its `data` axis
    over this host's cards ({data: -1}: all of them); None when the key is
    unset. The CPU is one device: {data: 1} and {data: -1} give None there,
    a larger axis raises."""
    tpu_cfg = getattr(args, "tpu", None)
    shape = tpu_cfg.get("mesh_shape", None) if tpu_cfg else None
    if not shape:
        return None
    if torch.device(device).type == "cuda":
        return create_mesh(shape)
    if int(dict(shape).get(DATA_AXIS, -1)) not in (-1, 1):
        raise ValueError(
            f"tpu.mesh_shape {dict(shape)} on the CPU, which is one device: "
            "a mesh spans cards (one process per card to train, the "
            "process's cards to search)")
    _axis_size(shape, 1, "device")  # names any other axis
    return None
