"""K1's bench tool (`tools/bench_k1.py`) on the CPU: `--sass` reads K1's
instantiations, and only those, out of cuobjdump's `-res-usage` and
`-sass` listings, under the old template (`mha_fwd_sm90<KT>`), the one
that also serves K2 and K2d (`mha_fwd_sm90<KT, false, false>`) and the one
that also serves K1m (`mha_fwd_sm90<KT, false, false, false>`, not K1m's
`<KT, false, false, true>`); K1m's shapes and every row's bound."""

import hashlib

import pytest
import torch

from bioscan_clip_tpu_torch.ops import attention
from bioscan_clip_tpu_torch.tools import bench_k1
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

NS = "_ZN12_GLOBAL__N_112mha_fwd_sm90"


def _listing(k1_args):
    """cuobjdump's two listings of a library holding K1 at 13 and 17
    16-key chunks (template arguments `k1_args`), a biased dropout
    instantiation and an unrelated kernel."""
    names = {13: f"{NS}ILi13E{k1_args}EEvPKvS2_", 17:
             f"{NS}ILi17E{k1_args}EEvPKvS2_",
             "k2d": f"{NS}ILi13ELb1ELb1EEEvPKvS2_",
             "k1m": f"{NS}ILi13ELb0ELb0ELb1EEEvPKvS2_",
             "other": "_Z10mha_fwd_mmaILi64EEvPKv"}
    usage = ["Resource usage:", " Common:", "  GLOBAL:0"]
    sass = ["\tcode for sm_90a"]
    for key, name in names.items():
        usage += [f" Function {name}:",
                  f"  REG:{168 if key != 17 else 166} STACK:0 SHARED:0 "
                  f"LOCAL:{4 if key == 17 else 0} CONSTANT[0]:1024"]
        sass += [f"\t\tFunction : {name}",
                 '\t.headerflags\t@"EF_CUDA_SM90"',
                 "        /*0000*/                   LDC R1, c[0x0][0x28] ;"
                 "          /* 0x00000a00ff017b82 */",
                 "                                                        "
                 "          /* 0x000fe20000000800 */",
                 "        /*0010*/              @!P0 BRA 0xb80 ;",
                 "        /*0020*/                   IMAD.MOV.U32 R2, RZ, "
                 "RZ, c[0x0][0x210] ;",
                 "        /*0030*/                   IMAD.IADD R3, R2, 0x1,"
                 " R4 ;"]
        if key == 17:
            sass.append("        /*0040*/                   HGMMA.64x256x16."
                        "F32.BF16 R24, gdesc[UR4], RZ, !UPT ;")
    return {"-res-usage": "\n".join(usage), "-sass": "\n".join(sass)}


@pytest.mark.parametrize("k1_args", ["", "Lb0ELb0E", "Lb0ELb0ELb0E"])
def test_sass_rows_read_k1_alone(monkeypatch, k1_args):
    listing = _listing(k1_args)
    monkeypatch.setattr(bench_k1, "_cuobjdump",
                        lambda flag, path: listing[flag])
    rows = bench_k1.sass_rows("lib.so", {13, 17})
    assert [r["key_rows"] for r in rows] == [208, 272]
    assert [(r["registers"], r["stack"], r["local"]) for r in rows] == [
        (168, 0, 0), (166, 0, 4)]
    assert [r["instructions"] for r in rows] == [4, 5]
    assert rows[0]["opcodes"] == {"IMAD": 2, "LDC": 1, "BRA": 1}
    assert rows[1]["opcodes"]["HGMMA"] == 1
    # the hash of the instructions' text, whatever the function's name
    text = "LDC R1, c[0x0][0x28]\n@!P0 BRA 0xb80\nIMAD.MOV.U32 R2, RZ, RZ, " \
        "c[0x0][0x210]\nIMAD.IADD R3, R2, 0x1, R4\n"
    assert rows[0]["sha1"] == hashlib.sha1(text.encode()).hexdigest()[:16]
    assert rows[1]["sha1"] != rows[0]["sha1"]  # one more instruction
    # a chunk count the shapes do not run is left out
    assert [r["key_rows"] for r in bench_k1.sass_rows("lib.so", {17})] == [
        272]


def test_k1m_shapes_are_the_text_towers_on_the_masked_plan():
    """K1m's shapes: OpenCLIP's text tower (D = 768, 12 heads) at serving's
    B = 64 (N = 77 and 20) and training's B = 10 (N = 20), all within the
    masked plan's sm90 range."""
    assert bench_k1.MASK_SHAPES == ((64, 77, 768, 12), (64, 20, 768, 12),
                                    (10, 20, 768, 12))
    for b, n, d, heads in bench_k1.MASK_SHAPES:
        assert attention.plan_packed_fwd(b, n, heads, d // heads,
                                         masked=True).body == "sm90"


@pytest.mark.parametrize("b,n,d,heads,masked,want", [
    # bytes: q, k, v read and o written in bf16 (+ the fp32 mask)
    (64, 77, 768, 12, True, (4 * 64 * 77 * 768 * 2 + 4 * 77 * 77) / 3.35e9),
    (10, 20, 768, 12, True, (4 * 10 * 20 * 768 * 2 + 4 * 20 * 20) / 3.35e9),
    (256, 197, 768, 12, False, 4 * 256 * 197 * 768 * 2 / 3.35e9)])
def test_bound_is_the_larger_of_bytes_and_operations(b, n, d, heads, masked,
                                                     want):
    assert bench_k1.bound_ms(b, n, d, heads, masked) == pytest.approx(want)
    ops = 4 * b * heads * n * n * (d // heads) / 989e9
    assert bench_k1.bound_ms(b, n, d, heads, masked) >= ops


def test_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        bench_k1.main([])
