"""The launch floor's bench (`tools/bench_k7.py`) and the device-code
comparison (`tools/sass_diff.py`) on the CPU: the bench refuses to run
without a card, and the comparison's parsers read ptxas' and cuobjdump's
reports, taking the same kernel built from two directories as one."""

import json
from types import SimpleNamespace

import pytest
import torch

from bioscan_clip_tpu_torch.ops import _launch
from bioscan_clip_tpu_torch.tools import bench_k7, sass_diff
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# one kernel as nvcc names it in two build directories: the anonymous
# namespace's name holds a hash and the file's name
TINY = {"this": ("_ZN38_GLOBAL__N__1a2b3c4d_6_src_cu_5e6f7081"
                 "11tiny_kernelILb1EEEvPKfPfi"),
        "other": ("_ZN39_GLOBAL__N__99aa88bb_7_topk_cu_00112233"
                  "11tiny_kernelILb1EEEvPKfPfi")}
PASS2 = ("_ZN38_GLOBAL__N__1a2b3c4d_6_src_cu_5e6f7081"
         "13mm_only_pass2EPKfiPf")

PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{tiny}' for 'sm_90a'
ptxas info    : Function properties for {tiny}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used {regs} registers, used 0 barriers, 364 bytes cmem[0]
ptxas info    : Compiling entry function '{pass2}' for 'sm_90a'
ptxas info    : Function properties for {pass2}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 12 registers, used 1 barriers, 16 bytes smem
"""

SASS = """
	code for sm_90a
		Function : {tiny}
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R0, SR_TID.X ;            /* 0x0000000000007919 */
        /*0020*/                   {last} ;                         /* 0x000000000000794d */
		..........

		Function : {pass2}
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
        /*0010*/                   EXIT ;                        /* 0x000000000000794d */
"""


def test_bench_refuses_to_run_without_a_card():
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        bench_k7.main(["--iters", "1"])


def test_the_launch_piece_calls_the_launch_path_as_the_wrapper_does(
        monkeypatch):
    """The bench's `ops._launch.launch` piece hands the launch path the
    input tensor and K7's three arguments; the stream comes last (the
    card's side stood in for by recorders)."""
    calls = []

    class Tensor:  # a tensor on card 0, as far as the pieces read it
        device = torch.device("cuda", 0)

        def get_device(self):
            return 0

        def data_ptr(self):
            return 4096

        def numel(self):
            return 1024

    kern = SimpleNamespace(lib=None, tiny=lambda *a: calls.append(a) or 0)
    topk = SimpleNamespace(_kernel=lambda: kern)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(_launch, "_runtime",
                        (lambda index: 0x1000 + index, lambda: 0, None))
    pieces = bench_k7.host_pieces(topk, Tensor(), Tensor())
    assert pieces["ops._launch.launch"]() is None
    assert calls == [(4096, 4096, 1024, 0x1000)]
    pieces["ctypes call, no launch (n = 0)"]()
    assert calls[-1] == (4096, 4096, 0, 7)


@pytest.mark.parametrize("mangled", sorted(TINY.values()) + [PASS2])
def test_kernel_names_drop_the_anonymous_namespace_tag(mangled):
    name = sass_diff.kernel_name(mangled)
    assert "GLOBAL__N__" not in name and name.startswith("_ZN_GLOBAL__N_")
    tail = "11tiny_kernel" if "tiny" in mangled else "13mm_only_pass2"
    assert name.endswith(mangled[mangled.index(tail):])


def test_the_same_kernel_from_two_directories_has_one_name():
    assert (sass_diff.kernel_name(TINY["this"])
            == sass_diff.kernel_name(TINY["other"]))


def _reports(side, regs=10, last="EXIT"):
    log = PTXAS.format(tiny=TINY[side], pass2=PASS2, regs=regs)
    sass = SASS.format(tiny=TINY[side], pass2=PASS2, last=last)
    return sass_diff.ptxas_report(log), sass_diff.sass_report(sass)


def test_ptxas_and_sass_reports_read_each_kernel():
    ptxas, sass = _reports("this")
    tiny = sass_diff.kernel_name(TINY["this"])
    assert set(ptxas) == set(sass) == {tiny, sass_diff.kernel_name(PASS2)}
    assert ptxas[tiny] == ("0 bytes stack frame, 0 bytes spill stores, 0 "
                           "bytes spill loads Used 10 registers, used 0 "
                           "barriers, 364 bytes cmem[0]")
    assert sass[tiny][0] == 3 and sass[sass_diff.kernel_name(PASS2)][0] == 2


@pytest.mark.parametrize("regs,last,same", [(10, "EXIT", 2),
                                            (12, "EXIT", 1),
                                            (10, "BRA 0x20", 1)])
def test_compare_counts_the_same_and_lists_what_differs(regs, last, same):
    row = sass_diff.compare(*_reports("this"),
                            *_reports("other", regs=regs, last=last),
                            source="topk")
    assert row["kernels"] == 2 and row["same"] == same
    assert len(row["differ"]) == 2 - same
    assert row["only_this"] == row["only_other"] == []
    json.dumps(row)
    if row["differ"]:
        d = row["differ"][0]
        assert d["kernel"] == sass_diff.kernel_name(TINY["this"])
        assert (d["this"]["sha1"] == d["other"]["sha1"]) == (last == "EXIT")
