"""tools/sass_chain_model.py (the dependent-chain model of one K4a lane)
on synthetic ``cuobjdump -sass`` bodies: operand parsing, the shortest
walk past slow paths, in-order issue at given latencies and branch
delays, the loops of a cone kernel, the probe's links, and the lines it
reads from chip_smoke.py's output."""
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import sass_chain_model as scm  # noqa: E402

LAT = {"fp32": 4.0, "imad": 4.0, "alu": 4.0, "convert": 19.0,
       "fchk": 4.0, "mufu": 17.0, "mufu_rsq": 17.0, "mufu_rcp": 17.0}
BR = {"taken": 10.0, "not_taken": 2.0, "pred_wait": 0.0}


def _body(text):
    out = []
    for line in text.strip().splitlines():
        addr, ins = line.split(None, 1)
        out.append((int(addr, 16), ins.rstrip(" ;")))
    return out


@pytest.mark.parametrize("ins,op,dsts,srcs", [
    ("FFMA R11, R2, -R11, 0.5", "FFMA", ["R11"], ["R2", "R11"]),
    ("FADD R12, R17.reuse, -R0.reuse", "FADD", ["R12"], ["R17", "R0"]),
    ("FSETP.GEU.AND P0, PT, |R11|, +INF , PT", "FSETP.GEU.AND", ["P0"],
     ["R11"]),
    ("@!P2 FMNMX R11, R24, 1e-12, !PT", "FMNMX", ["R11"], ["P2", "R24"]),
    ("@!P1 BRA P2, 0x2430", "BRA", [], ["P1", "P2"]),
    ("LOP3.LUT P1, RZ, R5, 0xff, RZ, 0xc0, !PT", "LOP3.LUT", ["P1"],
     ["R5"]),
    ("IADD3 R6, P0, -R6, R8, RZ", "IADD3", ["R6", "P0"], ["R6", "R8"]),
    ("IMAD.WIDE R14, R3, UR6, R14", "IMAD.WIDE", ["R14", "R15"],
     ["R3", "UR6", "R14"]),
    ("STG.E desc[UR4][R2.64], R13", "STG.E", [], ["UR4", "R2", "R3",
                                                  "R13"]),
    ("FCHK P1, R0, R11", "FCHK", ["P1"], ["R0", "R11"]),
])
def test_operands(ins, op, dsts, srcs):
    assert scm.operands(ins) == (op, dsts, srcs)


# a loop whose body guards a slow path (CALL) with a branch over it, then
# a short if (two instructions skipped when taken)
LOOP = """\
0000 FMUL R1, R1, R1
0010 MUFU.RSQ R2, R1
0020 ISETP.GT.U32.AND P0, PT, R1, 0x7, PT
0030 @!P0 BRA 0x60
0040 CALL.REL.NOINC 0x200
0050 BRA 0x70
0060 FMUL R2, R2, R1
0070 FSETP.GT.AND P1, PT, R2, 1, PT
0080 @P1 BRA 0xb0
0090 FADD R2, R2, 1
00a0 FADD R2, R2, 1
00b0 FADD R1, R2, R1
00c0 BRA 0x0
00d0 EXIT
"""


def test_shortest_path_skips_the_slow_path_and_the_longer_side():
    body = _body(LOOP)
    path = [body[i][0] for i in scm.shortest_path(body, 0x0, 0xc0)]
    assert path == [0x0, 0x10, 0x20, 0x30, 0x60, 0x70, 0x80, 0xb0, 0xc0]
    # the common walk jumps over the slow path only: it runs the if
    path = [body[i][0] for i in scm.shortest_path(body, 0x0, 0xc0,
                                                  common=True)]
    assert path == [0x0, 0x10, 0x20, 0x30, 0x60, 0x70, 0x80, 0x90, 0xa0,
                    0xb0, 0xc0]


def test_warp_issues_in_order_at_the_latencies():
    body = _body(LOOP)
    path = scm.shortest_path(body, 0x0, 0xc0)
    w = scm.Warp(LAT, BR)
    last = w.run(body, path, last_taken=True)
    # FMUL 0; MUFU 4 (R1); ISETP 5; BRA 9 (P0, taken: next at 19); FMUL
    # 21 (R2 from the MUFU); FSETP 25; BRA 29 (taken: 39); FADD 39; BRA 40
    assert last == 40
    assert w.t == 50
    # a trip in steady state: the next FMUL waits for R1 (39 + 4 = 43 <
    # 50), so each trip ends 50 cycles after the last
    assert scm.trip_cycles(body, path, LAT, BR) == 50
    # a predicate that reaches a branch 3 cycles late: the first branch's
    # delay hides behind the MUFU but for a cycle, the second's shows
    assert scm.trip_cycles(body, path, LAT, dict(BR, pred_wait=3)) == 54


CONE = """\
0000 S2R R0, SR_TID.X
0010 @P0 EXIT
0020 MOV R4, RZ
0030 BSSY B1, 0x90
0040 FSETP.GTU.AND P0, PT, R4, 2, PT
0050 @P0 BRA 0x90
0060 FMUL R4, R4, R4
0070 FADD R4, R4, R5
0080 BRA 0x40
0090 BSYNC B1
00a0 FADD R6, R6, R4
00b0 FSETP.GT.AND P1, PT, R6, 10, PT
00c0 @P1 BRA 0xf0
00d0 MOV R4, R6
00e0 BRA 0x30
00f0 STG.E desc[UR4][R2.64], R6
0100 EXIT
0110 BRA 0x110
"""


def test_cone_loops_and_stretches():
    body = _body(CONE)
    assert scm.main_body_loops(body) == ((0x30, 0xe0), (0x40, 0x80))
    m = scm.cone_model(body, LAT, BR)
    assert (m["n_head"], m["n_step"], m["n_event"], m["n_tail"]) == \
        (3, 5, 9, 2)
    # one DE step: FSETP, BRA (not taken), FMUL (R4), FADD, BRA taken
    assert m["step"] == scm.trip_cycles(
        body, scm.shortest_path(body, 0x40, 0x80), LAT, BR)
    assert m["step"] > 10 and m["event"] > m["step"]


def test_probe_names_and_links():
    assert scm.probe_name("_Z7sqrt_rnILi512EEvPfPx") == "sqrt_rn_512"
    assert scm.probe_name("_Z5iadd3ILi256EEvPiPx") == "iadd3_256"
    assert scm.cone_name("_ZN39_GLOBAL__N__af_7_bulb_cu_d16bulb_cone_kernel"
                         "ILi0EEEvNS_10ConeParamsEiiiiPf") == "bulb_cone_trig"
    assert scm.cone_name("_ZN39_GLOBAL__N__16bulb_cone_kernelILi9EEEvNS_"
                         "10ConeParamsEiiiiPf") is None

    def chain(n):
        lines = ["0000 CS2R R6, SR_CLOCKLO"]
        lines += [f"{(i + 1) * 16:04x} IADD3 R4, R4, R5, R5"
                  for i in range(n)]
        lines.append(f"{(n + 1) * 16:04x} CS2R R8, SR_CLOCKLO")
        return _body("\n".join(lines))

    # two add links per IADD3, 2 cycles a link: 4 cycles an IADD3
    fns = {"iadd3_256": chain(128), "iadd3_512": chain(256)}
    probe = {"iadd3": 2.0}
    assert scm.per_instruction(fns, probe, "iadd3", "IADD3") == 4.0
    assert scm.probe_link(fns, "iadd3", LAT, BR) == pytest.approx(2.0)


def test_smoke_records_read_chip_smokes_k4a_lines(tmp_path):
    log = tmp_path / "smoke.log"
    log.write_text(
        "K4a p8 config 6 (power 8, time 0): kernel 0.02111 ms by its "
        "records; the heaviest lane alone (17, 142: 48 evaluations + 39 DE "
        "iterations) 0.01893 ms, the schedule floor; the lightest alone "
        "(0, 0: 13 + 0) 0.00468 ms, the launch's fixed floor; kernel / "
        "schedule floor 1.12x\n"
        "K4a trig time 1.0 (dynamic power 8.32, trig step): kernel 0.04681 "
        "ms by its records; the heaviest lane alone (84, 162: 51 "
        "evaluations + 43 DE iterations) 0.04185 ms, the schedule floor; "
        "the lightest alone (0, 0: 11 + 0) 0.00410 ms, the launch's fixed "
        "floor; kernel / schedule floor 1.12x\n")
    assert scm.smoke_records(str(log)) == {
        "bulb_cone_p8": (0.02111, 0.01893, 0.00468),
        "bulb_cone_trig": (0.04681, 0.04185, 0.00410)}


def test_looped_probe_link_is_a_steady_trip_over_its_links():
    # sqrt_rn's loop: 0x20-0x60, four FMULs in a chain of R4 and the back
    # edge; the FMULs issue at 0, 4, 8, 12, the branch at 13 and the next
    # trip 10 cycles later, at 23 (R4 was ready at 16): 23 / 4 a link
    body = _body("""\
0000 CS2R R6, SR_CLOCKLO
0010 MOV R4, R4
0020 FMUL R4, R4, R5
0030 FMUL R4, R4, R5
0040 FMUL R4, R4, R5
0050 FMUL R4, R4, R5
0060 BRA 0x20
0070 CS2R R8, SR_CLOCKLO
""")
    fns = {"sqrt_rn_256": body}
    assert scm.probe_link(fns, "sqrt_rn", LAT, BR) == pytest.approx(
        (12 + 1 + 10) / 4)
