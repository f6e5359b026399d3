#!/usr/bin/env python3
"""A dependent-chain model of one lane of K4a, the Mandelbulb's cone
prepass, from its SASS and instruction latencies measured on the card.

    python3 tools/sass_chain_model.py DIR [--collect] [--smoke-log LOG]

DIR holds ``cone.sass`` (``cuobjdump -sass`` of the built kernel library,
its ``bulb_cone_kernel`` functions), ``probe.sass`` (``cuobjdump -sass``
of tools/latency_probe.cu, built with the kernels' flags) and
``latency.json`` (what the probe printed).  ``--collect`` makes the three
on the card first: it builds the library and the probe with ops/_cuda.py's
nvcc and flags, dumps both and runs the probe.

The model is one warp issuing in order, one instruction a cycle at most:
an instruction issues when its source registers and predicates are
ready, and its destinations are ready its latency later.  The latencies
are the probe's: FP32 and IMAD links, the integer ALU, each MUFU
function, the F2I/I2FP pair.  Opcodes the probe has no link for (FCHK,
the uniform datapath's) take the integer ALU's latency, the least the
card has, so the model stays a lower bound.  A branch holds the next
issue for a taken or a not-taken delay, and waits for its predicate a
few cycles beyond the predicate's latency: each of the three is the
largest whole number of cycles at which the model of the probe's loops,
the shapes the kernels' code has (IEEE sqrtf and division, which jump
over their slow paths' CALL; a branch over a division and one into it;
a loop of one FFMA), stays at or under what the card measured for every
one of them.  The model is printed beside every probe.  The walk through a stretch of code takes, at every forward branch,
the side with the fewer instructions to the stretch's end (a slow path's
CALL or local-memory access counts 1000), so it is the shortest path the
data could take: the lane's chain, not the common path's.

For each of the slice's K4a instances (power 8, the trig step, power 16)
the script finds the march loop (the widest backward branch of the main
body) and the DE loop (the widest inside it) and models four stretches:
the head (the kernel's start to the march loop), one DE step (a trip of
the DE loop), one march event of an orbit that takes no DE step (a trip
of the march loop that leaves the DE loop at once) and the tail (the
march loop's exit to the store).  The DE step and the event are each
walked three times in a row, the registers carried over, and the third
trip is the steady cost.  The lane with the most evaluations + DE
iterations of the instance's 1080p coarse grid (the plain version's
stats, on the CPU) and the lightest one then cost

    head + events x event + DE iterations x step + tail

cycles, at the card's top SM clock, 1980 MHz (the least time).  The
heaviest lane's figure bounds the whole launch from below: no schedule of
lanes finishes before its longest lane.  With ``--smoke-log`` (the output
of chip_smoke.py) the script prints each instance's kernel record and its
heaviest and lightest lanes' records beside the model.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

from sass_issue_model import Body, functions, opcode  # noqa: E402

SLOW = 1000  # the walk's weight of a CALL or a local-memory access
MAX_SM_MHZ = 1980  # the H100's top SM clock (nvidia-smi clocks.max.sm)
NO_DST = ("ST", "RED", "BRA", "EXIT", "CALL", "RET", "BSSY", "BSYNC",
          "WARPSYNC", "BAR", "NOP", "YIELD", "MEMBAR", "DEPBAR", "ERRBAR",
          "BPT", "KILL")
PRED_DST = ("ISETP", "FSETP", "DSETP", "HSETP2", "PSETP", "PLOP3", "FCHK",
            "UISETP", "UPLOP3")
CONE_TAGS = {8: "p8", 0: "trig", 16: "p16"}


def cone_name(mangled: str) -> Optional[str]:
    m = re.search(r"bulb_cone_kernelILi(\d+)E", mangled)
    if m and int(m.group(1)) in CONE_TAGS:
        return f"bulb_cone_{CONE_TAGS[int(m.group(1))]}"
    return None


def probe_name(mangled: str) -> Optional[str]:
    m = re.match(r"_Z\d+(\w+?)ILi(\d+)EEvP", mangled)
    return f"{m.group(1)}_{m.group(2)}" if m else None


def _regs(tok: str) -> List[str]:
    """The registers an operand names (a .64 register or address is a
    pair); RZ, URZ, PT and UPT name none."""
    out = []
    for m in re.finditer(r"\b(U?R|U?P)(\d+)(\.64)?", tok):
        kind, n = m.group(1), int(m.group(2))
        out.append(f"{kind}{n}")
        if m.group(3):
            out.append(f"{kind}{n + 1}")
    return out


def operands(ins: str) -> Tuple[str, List[str], List[str]]:
    """(opcode, destination registers, source registers) of one SASS
    instruction; a guard predicate is a source."""
    srcs: List[str] = []
    g = re.match(r"@!?(U?P\d+|U?PT)\s+", ins)
    if g:
        srcs += _regs(g.group(1))
        ins = ins[g.end():]
    parts = ins.split(None, 1)
    op = parts[0]
    ops = [o.strip() for o in parts[1].split(",")] if len(parts) > 1 else []
    base = op.split(".")[0]
    wide = ".64" in op or ".WIDE" in op
    dsts: List[str] = []
    if base.startswith(NO_DST) or base in ("BRA",):
        srcs += [r for o in ops for r in _regs(o)]
        return op, dsts, srcs
    i = 0
    if base in PRED_DST:
        while i < len(ops) and re.fullmatch(r"U?P(\d+|T)", ops[i]):
            dsts += _regs(ops[i])
            i += 1
    else:
        while i < len(ops) and re.fullmatch(r"U?P(\d+|T)", ops[i]):
            dsts += _regs(ops[i])  # a predicate written first (LOP3.LUT P1)
            i += 1
        if i < len(ops):
            d = _regs(ops[i])
            if wide and d and not d[0].startswith(("P", "UP")):
                d.append(re.sub(r"\d+", lambda m: str(int(m.group()) + 1),
                                d[0]))
            dsts += d
            i += 1
        while i < len(ops) and re.fullmatch(r"U?P(\d+|T)", ops[i]):
            dsts += _regs(ops[i])  # a carry out (IADD3 R6, P0, ...)
            i += 1
    srcs += [r for o in ops[i:] for r in _regs(o)]
    return op, dsts, srcs


def latency(op: str, lat: Dict[str, float]) -> float:
    """An opcode's latency from the probe's links (``lat``: see
    link_latencies)."""
    base = op.split(".")[0]
    if base == "MUFU":
        fn = op.split(".")[1]
        return lat.get(f"mufu_{fn.lower()}", lat["mufu"])
    if base in ("FFMA", "FADD", "FMUL", "FMNMX", "FSEL", "FSETP", "FSET",
                "HFMA2", "HADD2", "HMUL2", "FSWZADD"):
        return lat["fp32"]
    if base in ("IMAD", "IMUL"):
        return lat["imad"]
    if base in ("F2I", "F2F", "FRND", "I2F"):
        return lat["convert"]
    if base == "FCHK":
        return lat["fchk"]
    return lat["alu"]


def per_instruction(fns: Dict[str, Body], probe: Dict[str, float],
                    name: str, op: str) -> float:
    """Cycles per ``op`` instruction of probe ``name``'s chain: its link
    cycles over the ``op`` instructions a link adds (ptxas may fold two
    add links into one IADD3)."""
    n = [sum(opcode(ins).split(".")[0] == op for _, ins in fns[f"{name}_{k}"])
         for k in (256, 512)]
    return probe[name] * 256 / (n[1] - n[0])


def link_latencies(fns: Dict[str, Body], probe: Dict[str, float]
                   ) -> Dict[str, float]:
    """Each class's latency from the probe's per-link cycles."""
    alu = per_instruction(fns, probe, "iadd3", "IADD3")
    lat = {"fp32": per_instruction(fns, probe, "ffma", "FFMA"),
           "imad": per_instruction(fns, probe, "imad", "IMAD"), "alu": alu,
           "mufu_rcp": probe["mufu_rcp_fadd"] - probe["ffma"],
           "convert": probe["f2i_i2f"] - alu}
    for fn in ("rsq", "lg2", "ex2", "sqrt"):
        lat[f"mufu_{fn}"] = per_instruction(fns, probe, f"mufu_{fn}",
                                            "MUFU")
    # the functions the probe has no link for (SIN, COS) take its least
    lat["mufu"] = min(v for k, v in lat.items() if k.startswith("mufu_"))
    return lat


def branch_target(ins: str) -> Optional[int]:
    m = re.search(r"(0x[0-9a-f]+)\s*$", ins)
    return int(m.group(1), 16) if m else None


def shortest_path(body: Body, start: int, stop: int, common: bool = False
                  ) -> List[int]:
    """Indices of the instructions from ``start`` to ``stop`` (addresses,
    both walked) along the fewest instructions, a CALL or a local-memory
    access counting SLOW; only forward branches inside the stretch are
    followed, a guarded EXIT falls through.  ``common``: a conditional
    branch is followed only over a slow path (at most 6 instructions,
    one a CALL), so the walk runs the code a branch guards."""
    idx = {a: i for i, (a, _) in enumerate(body)}
    i0, i1 = idx[start], idx[stop]
    inf = float("inf")
    dist = [inf] * len(body)
    step: List[Optional[int]] = [None] * len(body)
    dist[i1] = 1
    for i in range(i1 - 1, i0 - 1, -1):
        a, ins = body[i]
        op = opcode(ins)
        guarded = ins.startswith("@")
        w = SLOW if (op.startswith("CALL")
                     or re.match(r"(STL|LDL)\b", op)) else 1
        succ = []
        if op.startswith("BRA"):
            t = branch_target(ins)
            over = [x for y, x in body if a < y < (t or 0)]
            if (t is not None and t > a and t in idx and idx[t] <= i1
                    and (not common or not guarded
                         or (len(over) <= 6
                             and any("CALL" in x for x in over)))):
                succ.append(idx[t])
            if guarded or re.search(r"BRA\s+!?U?P\d", ins):
                succ.append(i + 1)
        elif op.startswith(("EXIT", "RET")) and not guarded:
            pass
        else:
            succ.append(i + 1)
        best = min(succ, key=lambda j: dist[j], default=None)
        if best is not None and dist[best] < inf:
            dist[i], step[i] = w + dist[best], best
    if dist[i0] == inf:
        raise RuntimeError(f"no path from {start:#x} to {stop:#x}")
    path, i = [], i0
    while i != i1:
        path.append(i)
        i = step[i]
    return path + [i1]


class Warp:
    """One warp issuing in order: ``t`` is the earliest cycle the next
    instruction may issue, ``ready`` each register's cycle.  ``br`` holds
    the branch costs: ``taken`` and ``not_taken``, the cycles from a
    branch's issue to the next, and ``pred_wait``, the cycles a branch
    waits for a predicate beyond the predicate's latency."""

    def __init__(self, lat: Dict[str, float], br: Dict[str, float]):
        self.lat, self.br = lat, br
        self.t = 0.0
        self.ready: Dict[str, float] = {}

    def run(self, body: Body, path: List[int], last_taken: bool = False
            ) -> float:
        """Issue ``path``; a branch is taken where the path does not go
        on to the next instruction (the last one: ``last_taken``).
        Returns the cycle the last instruction issued."""
        at = 0.0
        for k, i in enumerate(path):
            op, dsts, srcs = operands(body[i][1])
            bra = op.startswith("BRA")
            at = max([self.t] + [
                self.ready.get(r, 0.0) + (self.br["pred_wait"] if bra and
                                          r.startswith(("P", "UP")) else 0)
                for r in srcs])
            for d in dsts:
                self.ready[d] = at + latency(op, self.lat)
            self.t = at + 1
            if bra:
                nxt = path[k + 1] if k + 1 < len(path) else None
                went = last_taken if nxt is None else nxt != i + 1
                self.t = at + self.br["taken" if went else "not_taken"]
        return at


def trip_cycles(body, path, lat, br, trips: int = 3) -> float:
    """The steady cycles of one trip of ``path`` (a loop trip that ends in
    its taken back edge): the last of ``trips`` issued in a row."""
    w = Warp(lat, br)
    ends = [w.run(body, path, last_taken=True) for _ in range(trips)]
    return ends[-1] - ends[-2]


def clock_reads(body: Body) -> Tuple[int, int]:
    reads = [a for a, ins in body if "SR_CLOCKLO" in ins]
    return reads[0], reads[-1]


# links a trip of each looped probe runs (tools/latency_probe.cu)
LOOP_LINKS = {"sqrt_rn": 4, "div_rn": 4, "skip": 4, "guard": 4,
              "loop_trip": 1}
# the probe whose common path runs the code its branch guards (the branch
# not taken); the others' walks skip what their branches guard
NOT_TAKEN_PROBE = "guard"


def probe_link(fns: Dict[str, Body], name: str, lat, br) -> float:
    """The model's cycles of one link of probe ``name``: for a looped
    probe a steady trip of its loop over the links a trip runs, else the
    stretch between its clock reads at N = 512 less that at N = 256, over
    256."""
    if name in LOOP_LINKS:
        body = fns[f"{name}_256"]
        a, b = clock_reads(body)
        head, back = next(
            (branch_target(ins), x) for x, ins in body
            if a < x < b and opcode(ins).startswith("BRA")
            and (branch_target(ins) or b) < x)
        path = shortest_path(body, head, back,
                             common=name == NOT_TAKEN_PROBE)
        return trip_cycles(body, path, lat, br) / LOOP_LINKS[name]
    out = []
    for n in (256, 512):
        body = fns[f"{name}_{n}"]
        a, b = clock_reads(body)
        out.append(Warp(lat, br).run(body, shortest_path(body, a, b)))
    return (out[1] - out[0]) / 256


def fit(fns, probe) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(latencies, branch costs): FCHK takes the ALU's latency; then, one
    after the other, the largest whole taken delay, predicate wait and
    not-taken delay at which the model of every looped probe stays at or
    under what the card measured (the not-taken delay is 1 while the
    first two are fitted).  The model then never asks more of a branch
    than the card showed it costs."""
    lat = link_latencies(fns, probe)
    lat["fchk"] = lat["alu"]
    br = {"taken": 1.0, "not_taken": 1.0, "pred_wait": 0.0}
    for key in ("taken", "pred_wait", "not_taken"):
        while br[key] < 200 and all(
                probe_link(fns, n, lat, dict(br, **{key: br[key] + 1}))
                <= probe[n] for n in LOOP_LINKS):
            br[key] += 1
    return lat, br


def main_body_loops(body: Body) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((head, back edge) of the march loop, of the DE loop): the widest
    backward branch before the main body's EXIT, and the widest inside
    it."""
    end = min(a for a, ins in body if opcode(ins) == "EXIT"
              and not ins.startswith("@"))
    found = [(branch_target(ins), a) for a, ins in body
             if a < end and opcode(ins).startswith("BRA")
             and branch_target(ins) is not None and branch_target(ins) < a]
    outer = max(found, key=lambda l: l[1] - l[0])
    inner = max((l for l in found if l != outer and outer[0] <= l[0]
                 and l[1] < outer[1]), key=lambda l: l[1] - l[0])
    return outer, inner


def cone_model(body: Body, lat, br) -> Dict[str, float]:
    """Cycles of the head, one DE step, one event of an orbit that takes
    no step, and the tail, with each stretch's instruction count."""
    (oh, ob), (ih, ib) = main_body_loops(body)
    step = shortest_path(body, ih, ib)
    event = shortest_path(body, oh, ob)
    head = shortest_path(body, body[0][0], oh)[:-1]
    # the tail: from the march loop's exit (a forward branch past its back
    # edge) to the store and EXIT
    exits = [branch_target(ins) for a, ins in body
             if oh <= a < ob and opcode(ins).startswith("BRA")
             and (branch_target(ins) or 0) > ob]
    stop = min(a for a, ins in body if a > ob and opcode(ins) == "EXIT"
               and not ins.startswith("@"))
    tail = shortest_path(body, min(exits), stop)
    head_c = Warp(lat, br).run(body, head) + 1
    tail_c = Warp(lat, br).run(body, tail) + 1
    return dict(head=head_c, step=trip_cycles(body, step, lat, br),
                event=trip_cycles(body, event, lat, br),
                tail=tail_c, n_head=len(head), n_step=len(step),
                n_event=len(event), n_tail=len(tail))


def lane_loads() -> Dict[str, dict]:
    """Each instance's heaviest and lightest coarse lanes of its 1080p
    grid (most and least evaluations + DE iterations), by the plain
    version's stats on the CPU (chip_ab.py's set-up of chip_smoke.py's
    cases): {instance: {which: (evaluations, DE iterations)}}."""
    import importlib.util

    sys.path.insert(0, ROOT)
    import torch

    from fractalrenderer_tpu_torch.ops import bulb_kernel as bk

    spec = importlib.util.spec_from_file_location(
        "chip_ab", os.path.join(ROOT, "chip_ab.py"))
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    cs = ab.chip_smoke()
    out = {}
    for tag, _, kw in cs.BULB_CASES:
        _, cparams, ckw, _ = ab.bulb_frame(cs, "cpu", kw)
        _, evals, work = bk.cone_fields_plain(cparams, stats=True, **ckw)
        load = (evals + work).flatten()
        ev, wk = evals.flatten(), work.flatten()
        out[f"bulb_cone_{tag}"] = {
            which: (int(ev[i]), int(wk[i]))
            for which, i in (("heaviest", int(torch.argmax(load))),
                             ("lightest", int(torch.argmin(load))))}
    return out


def smoke_records(path: str) -> Dict[str, Tuple[float, float, float]]:
    """{instance: (kernel, heaviest lane, lightest lane) ms} from
    chip_smoke.py's K4a lines."""
    out = {}
    for line in open(path):
        m = re.match(r"K4a (\w+) .*?: kernel ([\d.]+) ms by its records; "
                     r"the heaviest lane alone .*?\) ([\d.]+) ms.*?the "
                     r"lightest alone .*?\) ([\d.]+) ms", line)
        if m:
            out[f"bulb_cone_{m.group(1)}"] = tuple(
                float(m.group(k)) for k in (2, 3, 4))
    return out


def collect(d: str) -> None:
    """cone.sass, probe.sass and latency.json into ``d``, on the card."""
    sys.path.insert(0, ROOT)
    from fractalrenderer_tpu_torch.ops import _cuda

    os.makedirs(d, exist_ok=True)
    cuobjdump = os.path.join(os.path.dirname(_cuda.find_nvcc()),
                             "cuobjdump")
    _cuda.load_library()
    with open(os.path.join(d, "cone.sass"), "w") as f:
        subprocess.run([cuobjdump, "-sass", _cuda.library_path()],
                       stdout=f, check=True)
    flags = [x for x in _cuda.NVCC_FLAGS if x not in ("-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        exe = os.path.join(tmp, "probe")
        built = subprocess.run([_cuda.find_nvcc(), *flags, "-o", exe,
                                os.path.join(HERE, "latency_probe.cu")],
                               capture_output=True, text=True)
        if built.returncode:
            raise RuntimeError(f"nvcc failed (latency probe):\n"
                               f"{built.stderr[-4000:]}")
        with open(os.path.join(d, "probe.sass"), "w") as f:
            subprocess.run([cuobjdump, "-sass", exe], stdout=f, check=True)
        out = subprocess.run([exe], check=True, capture_output=True,
                             text=True).stdout
    with open(os.path.join(d, "latency.json"), "w") as f:
        f.write(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dir")
    ap.add_argument("--collect", action="store_true")
    ap.add_argument("--smoke-log")
    args = ap.parse_args()
    if args.collect:
        collect(args.dir)
    with open(os.path.join(args.dir, "latency.json")) as f:
        probe = json.loads(f.read().strip().splitlines()[-1])
    pfns = functions(os.path.join(args.dir, "probe.sass"), probe_name)
    lat, br = fit(pfns, probe)
    print("latencies (cycles, the probe's): " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(lat.items()))
        + f"; a branch's next issue {br['taken']:.0f} cycles on when "
        f"taken, {br['not_taken']:.0f} when not, its predicate "
        f"{br['pred_wait']:.0f} cycles late (the largest the looped "
        f"probes allow)", flush=True)
    checks = list(LOOP_LINKS) + ["ffma", "fmnmx", "fsetp_fsel", "isetp_sel",
                                 "lop3_iadd3", "mufu_rsq", "mufu_rcp_fadd",
                                 "f2i_i2f"]
    print("probe link, measured / model cycles: "
          + ", ".join(f"{n} {probe[n]:.2f} / "
                      f"{probe_link(pfns, n, lat, br):.2f}"
                      for n in checks), flush=True)
    cfns = functions(os.path.join(args.dir, "cone.sass"), cone_name)
    loads = lane_loads()
    recs = smoke_records(args.smoke_log) if args.smoke_log else {}
    per_ms = 1e3 / (MAX_SM_MHZ * 1e6)
    for name in sorted(cfns):
        m = cone_model(cfns[name], lat, br)
        lanes = {}
        for which, (ev, wk) in loads[name].items():
            cyc = m["head"] + ev * m["event"] + wk * m["step"] + m["tail"]
            lanes[which] = (ev, wk, cyc, cyc * per_ms)
        h, lt = lanes["heaviest"], lanes["lightest"]
        line = (f"{name}: head {m['head']:.0f} cycles ({m['n_head']} "
                f"instructions), DE step {m['step']:.0f} ({m['n_step']}), "
                f"event {m['event']:.0f} ({m['n_event']}), tail "
                f"{m['tail']:.0f} ({m['n_tail']}); heaviest lane ({h[0]} "
                f"evaluations + {h[1]} DE iterations) {h[2]:.0f} cycles = "
                f"{h[3]:.5f} ms at {MAX_SM_MHZ} MHz, the chain bound; "
                f"lightest ({lt[0]} + {lt[1]}) {lt[3]:.5f} ms")
        if name in recs:
            k, hr, lr = recs[name]
            line += (f"; records: kernel {k:.5f} ms = {k / h[3]:.2f}x the "
                     f"chain bound ("
                     + ("at most 2x: left alone" if k <= 2 * h[3]
                        else "above 2x: redesign")
                     + f"); heaviest lane alone {hr:.5f} ms, "
                     f"lightest alone {lr:.5f} ms, their difference "
                     f"{hr - lr:.5f} against the model's {h[3] - lt[3]:.5f}"
                     f" ({(hr - lr) / (h[3] - lt[3]):.2f}x)")
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
