"""K1's bench tool (`tools/bench_k1.py`) on the CPU: `--sass` reads K1's
instantiations, and only those, out of cuobjdump's `-res-usage` and
`-sass` listings, under the old template (`mha_fwd_sm90<KT>`) and the one
that also serves K2 and K2d (`mha_fwd_sm90<KT, false, false>`)."""

import pytest

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


@pytest.mark.parametrize("k1_args", ["", "Lb0ELb0E"])
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
    # a chunk count the shapes do not run is left out
    assert [r["key_rows"] for r in bench_k1.sass_rows("lib.so", {17})] == [
        272]
