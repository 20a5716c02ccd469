"""K7, the launch floor, on the card: what one call through the port's
kernel library costs the host and the card, beside `torch.add(x, 1.0)`.

K7 (`ops.topk.tiny`) is x + 1 on an (8, 128) fp32 array: 8 KB, a few
nanoseconds at the card's bytes rate, so every figure here is the cost of a
call, not of the work. One JSON object a line (ms unless named `_us`):

  header        the imported package's file, the card's name and power
                limit (nvidia-smi)
  k7, torch.add, k7 unaligned (x and its output 4 bytes past a 16-byte
  boundary: K7's one-float body in place of its 16-byte one), each with
    pipelined_ms  CUDA events over --iters back-to-back calls: the card's
                  time per launch while the host keeps ahead, else the
                  host's enqueue rate
    enqueue_us    the host clock over the same run, to its last enqueue
    call_sync_ms  median of --iters calls, each with a synchronize (host
                  clock)
    graph_ms      per node of a CUDA graph of --nodes captured calls,
                  replayed: the card's own cost of a launch, with no host
                  between the launches (the device-side floor)
  host_us       microseconds of host clock per call of each piece of a K7
                call, over --iters calls (the loop and a lambda call
                included: "nothing" is that alone): the wrapper, its
                output's allocation, the stream and device reads the
                launch path takes and those it no longer takes, the ctypes
                call without a launch (n = 0 returns before any CUDA call)
                and with one, and `ops/_launch.launch` where the package
                has it

Every measurement is taken --rounds times, in turns; each value is
[median, min, max]. The package is the one on the import path, so one
checkout's script times another checkout's package: run it from that
checkout's root with `PYTHONPATH=.`:

    PYTHONPATH=. python3 path/to/bench_k7.py [--iters 2000] [--rounds 5]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time


def _spread(values):
    return [statistics.median(values), min(values), max(values)]


def pipelined(fn, iters: int):
    """(card ms per call by CUDA events, host us per call to the last
    enqueue) over `iters` back-to-back calls after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    enqueue = time.perf_counter() - t0
    end.synchronize()
    return start.elapsed_time(end) / iters, 1e6 * enqueue / iters


def call_sync_ms(fn, iters: int) -> float:
    """Median host ms of one call plus a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def graph_ms(fn, nodes: int, replays: int = 10) -> float:
    """Card ms per node of a CUDA graph of `nodes` captured calls of `fn`,
    replayed `replays` times (a warm-up call on a side stream first, as
    `torch.cuda.graph` asks)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(nodes):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * nodes)


def host_us(fn, iters: int) -> float:
    """Host microseconds per call over `iters` calls (a synchronize before
    and after, outside the timing)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / iters


def _card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as e:
        return f"nvidia-smi failed: {e}"


def host_pieces(topk, x, out):
    """{piece: fn} of a K7 call on `x` (its output `out`), each a host-only
    step or one launch."""
    import torch

    dev = x.device
    index = dev.index
    kern = topk._kernel()
    xp, op, n = x.data_ptr(), out.data_ptr(), x.numel()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def guard():
        with torch.cuda.device(dev):
            pass

    pieces = {
        "nothing": lambda: None,
        "wrapper (ops.topk.tiny)": lambda: topk.tiny(x),
        "torch.add(x, 1.0)": lambda: torch.add(x, 1.0),
        "torch.empty_like": lambda: torch.empty_like(x),
        "tensor.device": lambda: x.device,
        "Tensor.get_device": lambda: x.get_device(),
        "two data_ptr()": lambda: (x.data_ptr(), out.data_ptr()),
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch._C._cuda_getCurrentRawStream":
            lambda: torch._C._cuda_getCurrentRawStream(index),
        "with torch.cuda.device(dev)": guard,
        "torch.cuda.current_device": lambda: torch.cuda.current_device(),
        "torch._C._cuda_getDevice": lambda: torch._C._cuda_getDevice(),
        "ctypes call, no launch (n = 0)":
            lambda: kern.tiny(xp, op, 0, stream),
        "ctypes call and launch": lambda: kern.tiny(xp, op, n, stream),
    }
    try:
        from bioscan_clip_tpu_torch.ops import _launch
    except ImportError:  # a checkout from before the launch path
        return pieces
    pieces["ops._launch.launch"] = lambda: _launch.launch(
        kern.lib, kern.tiny, "tiny launch", x, xp, op, n)
    return pieces


def main(argv=None, emit=print):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--nodes", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from bioscan_clip_tpu_torch.ops import topk

    if not torch.cuda.is_available():
        raise SystemExit("bench_k7: needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    x = torch.randn(8, 128, device="cuda", generator=gen)
    # the same 1024 floats 4 bytes past a 16-byte boundary
    x_off = torch.empty(1025, device="cuda")[1:].view(8, 128)
    x_off.copy_(x)
    for t in (x, x_off):
        if not torch.equal(topk.tiny(t), t + 1.0):
            raise AssertionError("bench_k7: K7 is not x + 1")
    emit(json.dumps({"package": topk.__file__,
                     "device": torch.cuda.get_device_name(0),
                     "card": _card_line()}))
    calls = {"k7": lambda: topk.tiny(x),
             "torch.add": lambda: torch.add(x, 1.0),
             "k7 unaligned": lambda: topk.tiny(x_off)}
    got = {name: {"pipelined_ms": [], "enqueue_us": [], "call_sync_ms": [],
                  "graph_ms": []} for name in calls}
    for _ in range(args.rounds):
        for name, fn in calls.items():
            card, enqueue = pipelined(fn, args.iters)
            got[name]["pipelined_ms"].append(card)
            got[name]["enqueue_us"].append(enqueue)
            got[name]["call_sync_ms"].append(call_sync_ms(fn, args.iters))
            got[name]["graph_ms"].append(graph_ms(fn, args.nodes))
    for name, row in got.items():
        emit(json.dumps({"row": name, **{k: _spread(v)
                                         for k, v in row.items()}}))
    out = torch.empty_like(x)
    pieces = host_pieces(topk, x, out)
    times = {name: [] for name in pieces}
    for _ in range(args.rounds):
        for name, fn in pieces.items():
            times[name].append(host_us(fn, args.iters))
    emit(json.dumps({"row": "host_us",
                     **{k: _spread(v) for k, v in times.items()}}))


if __name__ == "__main__":
    main()
