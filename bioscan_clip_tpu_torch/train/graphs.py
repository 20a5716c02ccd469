"""Several train steps per call, each step on the card the replay of a
captured CUDA graph.

The port's counterpart of JAX's `jax.jit` over `lax.scan`
(bioscan_clip_tpu/train/loop.py:150-257, :755-778: K steps in one
dispatch); JAX has no module of its own for it. A train step of
`train.loop` is a host prelude (the learning rate, the step seed, the
augmentation draws) and a device body (the forward to AdamW) that reads
what the prelude decided from tensors on the card only. `StepGraphs`
captures the body once per batch shape and replays it:

- the first step of a shape runs the body eagerly on the capture's side
  stream, as a real step: it creates the optimizer's state, cuBLAS'
  workspace and NCCL's communicators outside the graph;
- the next step of that shape captures the body (after
  `torch.cuda.empty_cache()`, so the eager step's blocks and the graph's
  pool do not add up), then replays it; every later step copies its batch
  and its prelude's tensors into the graph's buffers and replays;
- the graphs hold the addresses of the parameters, the optimizer's state
  and the learning-rate tensor. A call that finds any of them replaced
  (`train.checkpoint.restore_checkpoint`, `optimizer.load_state_dict`, a
  parameter's `.data` set) drops every graph and warms up again, so no
  stale graph is replayed;
- the kernels' launch counters (`ops.attention`) grow only while the body
  is captured: the growth is taken back and added again on every replay,
  so `.launches` counts what ran on the card;
- a capture that fails raises, naming the line of the port where it
  broke. No path runs the step eagerly in its place.

On the CPU every step runs eagerly: that is the plain version the tests
hold the card against.
"""

from __future__ import annotations

import os
import traceback

import torch

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launch_counters():
    """Every kernel launch counter of the port: (wrapper, attribute)."""
    from bioscan_clip_tpu_torch.ops import attention, topk

    return [(fn, attr)
            for fn in (attention.mha_packed, attention.mha,
                       attention.mha_dropout, attention.mha_bwd, topk.topk,
                       topk.topk_i8, topk.mm_only, topk.tiny)
            for attr in ("launches", "mask_launches", "sm90_launches",
                         "mask_sm90_launches",
                         "bias_launches", "default_launches", "mma_launches")
            if hasattr(fn, attr)]


def read_counters() -> dict:
    """{"<wrapper>.<attribute>": count} of every launch counter."""
    return {f"{fn.__name__}.{attr}": getattr(fn, attr)
            for fn, attr in _launch_counters()}


def _add_counters(counts: dict, sign: int = 1):
    for fn, attr in _launch_counters():
        setattr(fn, attr, getattr(fn, attr)
                + sign * counts[f"{fn.__name__}.{attr}"])


def _leaves(tree, path=()):
    """(path, tensor) of every tensor in nested dicts, tuples and lists."""
    if torch.is_tensor(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))


def _clone(tree):
    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def _shape_key(*trees):
    return tuple((path, tuple(t.shape), t.dtype, t.device)
                 for tree in trees for path, t in _leaves(tree))


def _fingerprint(state, modules):
    """The addresses a captured step reads and writes outside its pool:
    every parameter and buffer, the optimizer's state, the learning-rate
    tensor."""
    ptrs = [t.data_ptr() for m in modules
            for t in (*m.parameters(), *m.buffers())]
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            ptrs.extend(t.data_ptr() for t in
                        state.optimizer.state.get(p, {}).values()
                        if torch.is_tensor(t))
    ptrs.append(None if state.lr is None else state.lr.data_ptr())
    return tuple(ptrs)


def _where(exc: BaseException) -> str:
    """The innermost line of the port (outside this module) in the
    tracebacks of `exc` and of the exception it arose from."""
    here = os.path.abspath(__file__)
    found = "an unknown line"
    for e in (exc.__context__, exc):
        if e is None or e.__traceback__ is None:
            continue
        for frame in traceback.extract_tb(e.__traceback__):
            f = os.path.abspath(frame.filename)
            if f.startswith(_PACKAGE) and f != here:
                found = (f"{os.path.relpath(f, os.path.dirname(_PACKAGE))}"
                         f":{frame.lineno} ({frame.name}: {frame.line})")
    return found


class _Graph:
    """One captured step: the graph, its input buffers, its loss and the
    kernel launches one replay makes (`launches`, as `read_counters`)."""

    def __init__(self, graph, batch, inputs, loss, launches):
        self.graph, self.batch, self.inputs = graph, batch, inputs
        self.loss, self.launches = loss, launches

    def load(self, batch, inputs):
        for (_, dst), (_, src) in zip(_leaves((self.batch, self.inputs)),
                                      _leaves((batch, inputs))):
            dst.copy_(src, non_blocking=True)

    def replay(self):
        self.graph.replay()
        _add_counters(self.launches)


class StepGraphs:
    """The CUDA graphs of one train step (a `train.loop` step with
    `.prelude` and `.body`), one per batch shape, and the loop that runs
    K steps with them (module doc). `modules`: the modules whose tensors
    the body reads."""

    def __init__(self, train_step, modules):
        self.train_step = train_step
        self.modules = list(modules)
        self.graphs: dict = {}
        self.warm: set = set()
        self.stream = None
        self._seen = None  # the state's fingerprint the graphs were made for

    def clear(self):
        """Drop every graph (and its memory pool once unreferenced)."""
        self.graphs.clear()
        self.warm.clear()

    def run(self, state, batches, seeds):
        """`len(seeds)` steps, step k on `batches[k]` with seed `seeds[k]`
        -> (state, (k,) losses on the state's device)."""
        step = self.train_step
        dev = state.device
        if dev.type != "cuda":
            losses = []
            for batch, seed in zip(batches, seeds):
                state, loss = step(state, batch, seed)
                losses.append(loss)
            return state, torch.stack(losses)
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        fp = _fingerprint(state, self.modules)
        if fp != self._seen:
            self.clear()
            self._seen = fp
        losses = torch.empty(len(seeds), device=dev)
        for k, (batch, seed) in enumerate(zip(batches, seeds)):
            inputs = step.prelude(state, batch, seed)
            key = _shape_key(batch, inputs)
            graph = self.graphs.get(key)
            if graph is None and key not in self.warm:
                loss = self._warm_up(state, batch, inputs)
                self.warm.add(key)
                self._seen = _fingerprint(state, self.modules)
            else:
                if graph is None:
                    graph = self.graphs[key] = self._capture(state, batch,
                                                             inputs)
                else:
                    graph.load(batch, inputs)
                graph.replay()
                loss = graph.loss
            losses[k].copy_(loss)
            state.step += 1
        return state, losses

    def _warm_up(self, state, batch, inputs):
        cur = torch.cuda.current_stream(state.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            loss = self.train_step.body(state, batch, inputs)
        cur.wait_stream(self.stream)
        return loss

    def _capture(self, state, batch, inputs) -> _Graph:
        torch.cuda.synchronize(state.device)
        torch.cuda.empty_cache()
        batch, inputs = _clone(batch), _clone(inputs)
        graph = torch.cuda.CUDAGraph()
        before = read_counters()
        try:
            with torch.cuda.graph(graph, stream=self.stream):
                loss = self.train_step.body(state, batch, inputs)
        except RuntimeError as exc:
            raise RuntimeError(
                "CUDA graph capture of the train step failed at "
                f"{_where(exc)}: {exc}") from exc
        finally:
            grown = {k: v - before[k] for k, v in read_counters().items()}
            _add_counters(grown, -1)  # nothing ran while capturing
        return _Graph(graph, batch, inputs, loss, grown)
