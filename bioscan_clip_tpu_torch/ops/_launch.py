"""The one launch path of the port's kernels.

Every kernel wrapper in `ops/attention.py` and `ops/topk.py` launches through
`launch`: the C entry point of a `csrc/*.cu` library (`ops/_build.py`),
called through ctypes with the raw handle of its card's current stream as
its last argument, and its returned `cudaError_t` checked. It costs the host
what the card needs and no more:

- the stream is read as an int with `torch._C._cuda_getCurrentRawStream`
  (what Triton's launcher reads), not built as a `torch.cuda.Stream`
  object. Under `torch.cuda.stream(s)` and inside a `torch.cuda.graph`
  capture the current stream is that side or capture stream, so the kernel
  is enqueued (or captured) there;
- the tensor's card is read with `Tensor.get_device` (one call, where
  `tensor.device.type` builds a string), the current card with
  `torch._C._cuda_getDevice`, and the current card switched only when it
  is not the tensor's (a search sharded over several cards from one
  process), then put back;
- a non-zero code raises with the runtime's message.

There is no plain version here and nothing to fall back to: a wrapper
takes its plain version for a CPU tensor before it gets here, and
`launch` raises on any device that is not a CUDA card.

The `torch._C._cuda_*` functions exist only in a CUDA build of torch, so
they are looked up at the first launch, never at import.
"""

from __future__ import annotations

import torch

from . import _build

# (current raw stream of a card, current card, set the current card), bound
# at the first launch
_runtime = None


def _bind():
    global _runtime
    c = torch._C
    _runtime = (c._cuda_getCurrentRawStream, c._cuda_getDevice,
                c._cuda_setDevice)
    return _runtime


def launch(lib, entry, what: str, on: torch.Tensor, *args) -> None:
    """Call `entry(*args, stream)` for a kernel on the CUDA card that tensor
    `on` lies on: `stream` the raw handle of that card's current stream,
    with the card made current for the call if it is not. `lib` is the
    library `entry` comes from (its `bscan_error_string` names a code);
    `what` names the launch in the error. Raises for a tensor that is not on
    a CUDA card, and on a non-zero returned code."""
    index = on.get_device()  # -1 off the card
    if index < 0:
        raise ValueError(f"{what}: the kernel launches on a CUDA card, not "
                         f"on {on.device}")
    stream, current, set_current = _runtime or _bind()
    card = current()
    if index == card:
        err = entry(*args, stream(index))
    else:
        set_current(index)
        try:
            err = entry(*args, stream(index))
        finally:  # put the caller's card back; nothing falls back
            set_current(card)
    if err:
        _build.check(lib, err, what)
