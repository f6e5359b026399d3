"""tools/sass_issue_model.py (the issue model of K1 and K2) on a
synthetic ``cuobjdump -sass`` dump: instance names, the counting twins
left out, the head / loop trip / after counts along the common path, and
the model's time against a chip_ab.py result."""
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import sass_issue_model as sim  # noqa: E402

K1_FUSED = ("_ZN41_GLOBAL__N__bbb37fe7_9_escape_cu_66b2f21e13escape_kernel"
            "ILi0ELb1ELb{}EEEvNS_6ParamsENS_10ColorTableEiiiiiiiNS_7Outputs"
            "EPi")
K2 = ("_ZN45_GLOBAL__N__a20cd08e_12_dd_escape_cu_4672cfea16dd_escape_kernel"
      "ILb{}EEEvNS_8DDParamsEiiiiPiPfS3_S2_")

# head 0x00-0x20 (3), loop 0x30-0x70 (5), then a guarded slow path (a
# CALL, skipped), the palette's pow block (taken), a block the walk falls
# into, and the last store
BODY = """\
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   IMAD R2, R0, 0x4, RZ ;
        /*0030*/                   FMUL R3, R2, R2 ;
        /*0040*/                   FADD R4, R3, R3 ;
        /*0050*/                   IADD3 R5, R5, 0x1, RZ ;
        /*0060*/                   FSETP.GTU.AND P0, PT, R4, 4, PT ;
        /*0070*/              @!P0 BRA 0x30 ;
        /*0080*/                   FCHK P1, R4, R3 ;
        /*0090*/               @P1 BRA 0xb0 ;
        /*00a0*/                   CALL.REL.NOINC 0x400 ;
        /*00b0*/                   ISETP.NE.AND P2, PT, R7, 0x1, PT ;
        /*00c0*/              @!P2 BRA 0xf0 ;
        /*00d0*/                   MUFU.LG2 R8, R4 ;
        /*00e0*/                   MUFU.EX2 R8, R8 ;
        /*00f0*/                   FADD R9, R8, R8 ;
        /*0100*/                   STG.E [R10.64], R9 ;
        /*0110*/                   EXIT ;
"""


def _dump(tmp_path):
    text = ""
    for name in (K1_FUSED.format(0), K1_FUSED.format(1), K2.format(0)):
        text += f"\t\tFunction : {name}\n" + BODY
    path = tmp_path / "sass.txt"
    path.write_text(text)
    return str(path)


def test_functions_name_the_instances_and_drop_the_twins(tmp_path):
    fns = sim.functions(_dump(tmp_path))
    assert sorted(fns) == ["dd_escape_mandelbrot", "escape_mandelbrot_fused"]
    assert len(fns["escape_mandelbrot_fused"]) == 18
    assert sim.loops(fns["dd_escape_mandelbrot"]) == [(0x30, 0x70)]


@pytest.mark.parametrize("name", ["escape_mandelbrot_fused",
                                  "dd_escape_mandelbrot"])
def test_counts_follow_the_common_path(tmp_path, name):
    body = sim.functions(_dump(tmp_path))[name]
    # head: 0x00-0x20; trip: 0x30-0x70; after: 0x80, 0x90 (the slow path's
    # CALL skipped), 0xb0, 0xc0 (the pow block taken), 0xf0, 0x100
    assert sim.counts(body, name) == (3, 5, 6)


def test_main_prints_the_model_against_the_kernel_time(tmp_path, capsys,
                                                        monkeypatch):
    trips, warps, clock = 1000, 100, 1000
    ab = tmp_path / "ab.json"
    ab.write_text(json.dumps({"cases": [dict(
        name="escape_mandelbrot_fused", this_kernel_ms=1e-5,
        other_kernel_ms=2e-5, counters={"this": dict(
            trips=trips, warps=warps, sm_clock_mhz=clock)})]}))
    monkeypatch.setattr(sys, "argv", ["sass_issue_model.py",
                                      _dump(tmp_path), str(ab),
                                      "--side", "other"])
    assert sim.main() == 0
    out = capsys.readouterr().out
    # (1000 x 5 + 100 x (3 + 6)) warp instructions / (528 x 1e9) s
    model_ms = (trips * 5 + warps * 9) / (sim.SCHEDULERS * clock * 1e6) * 1e3
    assert "head 3, trip 5, after 6; 1000 trips, 100 warps" in out
    assert f"issue efficiency {model_ms / 2e-5:.3f}" in out
