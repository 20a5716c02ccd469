"""The port's one launch path (`ops/_launch.py`) on the CPU.

A kernel runs only on the card; what is checked here is that every wrapper
takes the one path, and what that path does around the ctypes call: it
raises for a tensor that is not on a card, binds `torch._C._cuda_*` at the
first launch and not at import (the CPU build of torch has none of them),
reads the current stream of the tensor's card, makes that card current only
when it is not and puts the caller's back, and turns a non-zero code into
the runtime's message. The card's side of those functions is stood in for
by recorders. And every `cudaFuncSetAttribute` of `csrc/` sits in the
once-per-card helper.
"""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bioscan_clip_tpu_torch.ops import _launch, attention, topk
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

PKG = Path(__file__).resolve().parent.parent / "bioscan_clip_tpu_torch"
OPS = sorted((PKG / "ops").glob("*.py"))
CSRC = sorted((PKG / "csrc").glob("*.cu")) + sorted(
    (PKG / "csrc").glob("*.cuh"))
# what only ops/_launch.py may call
LAUNCH_ONLY = ("torch.cuda.current_stream(", "torch.cuda.device(",
               "_build.check(")


@pytest.mark.parametrize("path", OPS, ids=lambda p: p.name)
def test_only_the_launch_path_reads_streams_guards_and_checks(path):
    text = path.read_text()
    if path.name == "_launch.py":
        assert "_build.check(" in text
        return
    for call in LAUNCH_ONLY:
        assert call not in text, f"{path.name} calls {call}"


@pytest.mark.parametrize("module,sites", [(attention, 4), (topk, 8)],
                         ids=["attention", "topk"])
def test_every_launch_site_calls_the_launch_path(module, sites):
    """`_launch_sm90`, `_launch_bwd_sm90`, `_launch_bwd`, `_launch_fwd` in
    ops/attention.py; `_launch_mma`, `_launch_sm90`, `_launch_i8_mma`,
    `_launch_i8_sm90`, `_launch_mm_mma`, `_launch_mm_sm90` (two entries)
    and `tiny` in ops/topk.py; no ctypes entry is called outside it."""
    text = Path(module.__file__).read_text()
    assert (module.launch.__module__, module.launch.__name__) == (
        _launch.__name__, "launch")
    assert len(re.findall(r"^\s+launch\(", text, re.M)) == sites
    assert not re.search(r"err = \w+\.?\w*\(", text)


@pytest.mark.parametrize("path", CSRC, ids=lambda p: p.name)
def test_shared_memory_attributes_are_set_only_by_the_helper(path):
    """No launch function sets a kernel attribute itself: every
    `cudaFuncSetAttribute` is in `bscan::allow_smem`
    (csrc/attention_common.cuh), which sets it once per card."""
    text = path.read_text()
    n = text.count("cudaFuncSetAttribute(")
    if path.name == "attention_common.cuh":
        helper = text[text.index("inline cudaError_t allow_smem("):]
        assert n == helper.count("cudaFuncSetAttribute(") == 2
    else:
        assert n == 0


@pytest.mark.parametrize("path", [p for p in CSRC if p.suffix == ".cu"],
                         ids=lambda p: p.name)
def test_each_allow_smem_call_has_its_own_flags(path):
    """Every `allow_smem(ready...` call names flags declared `static` in
    the same launch function, so each instantiation sets its kernel's
    attributes once per card."""
    text = path.read_text()
    calls = re.findall(r"allow_smem\(\s*(ready\w*)", text)
    statics = re.findall(r"static bool (ready\w*)\[", text)
    if path.name == "mha_bwd.cu":  # both passes through set_smem
        assert len(re.findall(r"set_smem\(ready,", text)) == len(statics)
        return
    assert len(calls) == len(statics)


def test_import_touches_no_cuda_binding(monkeypatch):
    """A CPU build of torch has no `torch._C._cuda_*`: re-importing the
    module must not look any of them up."""
    assert not hasattr(torch._C, "_cuda_getCurrentRawStream")

    class Spy:
        def __init__(self, real):
            self.real, self.seen = real, []

        def __getattr__(self, name):
            if name.startswith("_cuda"):
                self.seen.append(name)
            return getattr(self.real, name)

    spy = Spy(torch._C)
    monkeypatch.setattr(torch, "_C", spy)
    importlib.reload(_launch)
    assert _launch._runtime is None
    with pytest.raises(ValueError, match="CUDA card"):
        _launch.launch(None, None, "tiny launch", torch.zeros(1))
    assert spy.seen == [] and _launch._runtime is None


class Card:
    """Stands in for the card's side of the launch path: the current card,
    the stream handle of each card, every device switch, every entry
    call."""

    def __init__(self, current=0, err=0):
        self.current, self.err = current, err
        self.switches, self.calls = [], []

    def stream(self, index):
        return 0x1000 + index

    def get(self):
        return self.current

    def set(self, index):
        self.switches.append(index)
        self.current = index

    def entry(self, *args):
        self.calls.append((self.current, args))
        return self.err


class OnCard:
    """A tensor on card `index`, as far as the launch path reads it."""

    def __init__(self, index):
        self.index = index

    def get_device(self):
        return self.index


class Lib:
    def __init__(self):
        self.asked = []

    def bscan_error_string(self, err):
        self.asked.append(err)
        return b"invalid argument"


@pytest.fixture
def card(monkeypatch):
    c = Card()
    monkeypatch.setattr(_launch, "_runtime", (c.stream, c.get, c.set))
    return c


def test_launch_on_the_current_card_switches_nothing(card):
    lib = Lib()
    assert _launch.launch(lib, card.entry, "k", OnCard(0), 11, None,
                          2.5) is None
    assert card.calls == [(0, (11, None, 2.5, 0x1000))]
    assert card.switches == [] and lib.asked == []


@pytest.mark.parametrize("index", [1, 3])
def test_launch_on_another_card_runs_there_and_puts_the_current_back(
        card, index):
    _launch.launch(Lib(), card.entry, "k", OnCard(index), 7)
    assert card.calls == [(index, (7, 0x1000 + index))]
    assert card.switches == [index, 0] and card.current == 0


def test_a_failed_call_on_another_card_still_puts_the_current_back(card):
    def bad_entry(*args):
        raise TypeError("an argument ctypes cannot convert")

    with pytest.raises(TypeError):
        _launch.launch(Lib(), bad_entry, "k", OnCard(2), 1)
    assert card.switches == [2, 0] and card.current == 0


def test_a_launch_from_another_current_card_takes_the_tensors(card):
    card.current = 2
    _launch.launch(Lib(), card.entry, "k", OnCard(0), 5)
    assert card.calls == [(0, (5, 0x1000))] and card.switches == [0, 2]


@pytest.mark.parametrize("err", [1, 209])
def test_a_nonzero_code_raises_with_the_runtime_message(card, err):
    card.err = err
    lib = Lib()
    with pytest.raises(RuntimeError,
                       match=f"tiny launch: CUDA error {err} "
                             r"\(invalid argument\)"):
        _launch.launch(lib, card.entry, "tiny launch", OnCard(0), 1)
    assert lib.asked == [err]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_launch_raises_off_the_card_and_calls_nothing(card, device):
    with pytest.raises(ValueError, match="on a CUDA card"):
        _launch.launch(Lib(), card.entry, "tiny launch",
                       torch.zeros(1, device=device), 1)
    assert card.calls == [] and card.switches == []


def test_wrappers_take_their_plain_versions_on_the_cpu(monkeypatch):
    """A CPU tensor never reaches the launch path: K7, K1 and K4 on CPU
    tensors give their plain versions' answers with `launch` made to
    fail."""
    def no_launch(*args):
        raise AssertionError("a CPU tensor reached the launch path")

    monkeypatch.setattr(topk, "launch", no_launch)
    monkeypatch.setattr(attention, "launch", no_launch)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 128), np.float32))
    before = topk.tiny.launches
    assert torch.equal(topk.tiny(x), x + 1.0)
    assert topk.tiny.launches == before
    qkv = torch.from_numpy(rng.standard_normal((2, 5, 96), np.float32))
    out = attention.mha_packed(qkv, 2)
    assert out.shape == (2, 5, 32) and torch.isfinite(out).all()
    keys = torch.from_numpy(rng.standard_normal((40, 32), np.float32))
    v, i = topk.topk(x[:3, :32].contiguous(), keys, 40, 4)
    assert v.shape == (3, 4) and i.shape == (3, 4)
