#!/usr/bin/env python3
"""An issue model of the port's escape kernels K1 and K2 from their SASS,
against their time on the card.

    python3 tools/sass_issue_model.py SASS_DUMP AB_JSON [AB_JSON ...]
        [--side this|other]

SASS_DUMP is ``cuobjdump -sass`` of a built kernel library (the
``escape_kernel`` and ``dd_escape_kernel`` functions; the counting twins
are left out); AB_JSON is what ``chip_ab.py --only escape_`` or ``--only
dd_escape`` wrote with ``--out``.  For each instance the script walks the
common path of an exterior pixel through the SASS: the instructions from
the kernel's start to its first loop (head), one trip of the escape loop
(trip) and from the loop's exit to the last store (after).  The walk
falls through a conditional forward branch, except where that branch
skips a slow path (a short block holding a CALL, or the stack traffic
of sinf's reduction), the palette's pow block (kind 1, the default
palette), the first segment's bound test, the clamp of the enhance
values (F_CLAMP, off for Mandelbrot's fused frame only) and the
Burning Ship's interior block.  The warp instructions issued are then

    warps x (head + after) + trips x trip

with the trips and warps of the frame from the case's decoded per-warp
counters (the ``this`` side's: the loop trips depend on the frame's n
plane, which is the same on both sides, and on the 32 x 8 grid, which K1
and K2 keep).  At one warp instruction per scheduler per clock on 528
schedulers (132 SMs x 4) at the SM clock the counters read under load,
they take the model's time; the model's time over the ``--side`` kernel
time is the issue efficiency.
"""
from __future__ import annotations

import argparse
import json
import re
from typing import Callable, Dict, List, Optional, Tuple

SCHEDULERS = 528  # 132 SMs x 4 warp schedulers (H100 SXM)
FAMILIES = ("mandelbrot", "julia", "burning_ship", "phoenix")

Body = List[Tuple[int, str]]


def functions(path: str, namer: Optional[Callable] = None
              ) -> Dict[str, Body]:
    """The dump's functions that ``namer`` names (by default the K1 and K2
    instances, by chip_smoke's instance names; the counting twins are left
    out), as (address, instruction) lists."""
    namer = namer or instance_name
    fns: Dict[str, Body] = {}
    body: Optional[Body] = None
    for line in open(path):
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = namer(m.group(1))
            body = fns.setdefault(name, []) if name else None
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and body is not None:
            body.append((int(m.group(1), 16), m.group(2)))
    return fns


def instance_name(mangled: str) -> Optional[str]:
    k = re.search(r"escape_kernelILi(\d)ELb([01])E(?:Lb([01])E)?", mangled)
    d = re.search(r"dd_escape_kernel(?:ILb([01])E)?", mangled)
    if d:
        return None if d.group(1) == "1" else "dd_escape_mandelbrot"
    if k and k.group(3) != "1":
        return (f"escape_{FAMILIES[int(k.group(1))]}_"
                + ("fused" if k.group(2) == "1" else "fields"))
    return None


def opcode(ins: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]


def loops(body: Body) -> List[Tuple[int, int]]:
    """(head, backward branch) of each loop of more than three
    instructions."""
    out = []
    for a, ins in body:
        m = re.search(r"BRA\s+(?:!?U?P\d,\s*)?`?\(?\.?L?_?x?(0x[0-9a-f]+)",
                      ins)
        if m and opcode(ins).startswith("BRA"):
            t = int(m.group(1), 16)
            if t <= a and (a - t) // 16 + 1 > 3:
                out.append((t, a))
    return out


def taken(body: Body, clamp: bool) -> Callable:
    """Whether the common path takes the conditional forward branch at
    address ``a`` (None: only if it skips a slow path)."""
    idx = {a: i for i, (a, _) in enumerate(body)}

    def take(a: int, ins: str, prev: List[str]) -> Optional[bool]:
        p = prev[-1] if prev else ""
        if ins.startswith("@!P") and re.search(
                r"ISETP\.NE\.AND P\d, PT, R\d+, 0x1, PT", p):
            return True  # palette kind 1 (pow)
        if ins.startswith("@!P") and re.search(
                r"FSETP\.GEU\.AND P\d, PT, R\d+, UR\d+, PT", p):
            return True  # the first segment bound: t < hi[0]
        if re.search(r"LOP3\.LUT P\d, RZ, R\d+, 0x40", p):
            return not clamp  # F_CLAMP
        if any(re.search(r"ISETP\.NE\.AND P\d, PT, R\d+, 0x3, PT", x)
               for _, x in body[idx[a] + 1:idx[a] + 7]):
            return True  # the Burning Ship's interior block (style 3)
        return None

    return take


def walk(body: Body, start: int, stop: int, take: Callable) -> int:
    """Instructions along the common path from ``start`` to ``stop``,
    both counted."""
    idx = {a: i for i, (a, _) in enumerate(body)}
    i, n, prev = idx[start], 0, []
    while n < 20000:
        a, ins = body[i]
        n += 1
        if a == stop:
            return n
        o = opcode(ins)
        m = re.search(r"(0x[0-9a-f]+)\s*$", ins)
        t = int(m.group(1), 16) if m else None
        if o.startswith("BRA") and not ins.startswith("@"):
            i = idx[t]
            prev.append(ins)
            continue
        if o.startswith("BRA") and t is not None and t > a:
            d = take(a, ins, prev)
            if d is None:
                skipped = [x for y, x in body if a < y < t]
                d = ((len(skipped) <= 6 and any("CALL" in x
                                                for x in skipped))
                     or (len(skipped) <= 80 and any(
                         re.search(r"\b(STL|LDL)\b", x) for x in skipped)))
            if d:
                i = idx[t]
                prev.append(ins)
                continue
        prev.append(ins)
        i += 1
    raise RuntimeError(f"no path from {start:#x} to {stop:#x}")


def counts(body: Body, name: str) -> Tuple[int, int, int]:
    """(head, trip, after) of the instance ``name``: the escape loop is
    the first loop, or the longest for the tracked Mandelbrot and Burning
    Ship fields (the trap, derivative and stripe copy)."""
    found = loops(body)
    tracked = name in ("escape_mandelbrot_fields",
                       "escape_burning_ship_fields")
    head_at, back = (max(found, key=lambda l: l[1] - l[0]) if tracked
                     else min(found))
    take = taken(body, clamp=name != "escape_mandelbrot_fused")
    last = max(a for a, ins in body if ins.startswith("STG"))
    head = walk(body, body[0][0], min(found)[0], take) - 1
    trip = walk(body, head_at, back, take)
    after = walk(body, back + 0x10, last, take)
    return head, trip, after


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sass")
    ap.add_argument("ab", nargs="+")
    ap.add_argument("--side", choices=("this", "other"), default="this")
    args = ap.parse_args()
    fns = functions(args.sass)
    for path in args.ab:
        for case in json.load(open(path))["cases"]:
            name, c = case["name"], case["counters"].get("this")
            if name not in fns or not c:
                continue
            head, trip, after = counts(fns[name], name)
            clock = c["sm_clock_mhz"] * 1e6
            loop_ms = c["trips"] * trip / (SCHEDULERS * clock) * 1e3
            rest_ms = (c["warps"] * (head + after)
                       / (SCHEDULERS * clock) * 1e3)
            ms = case[f"{args.side}_kernel_ms"]
            print(f"{name}: head {head}, trip {trip}, after {after}; "
                  f"{c['trips']} trips, {c['warps']} warps at "
                  f"{c['sm_clock_mhz']} MHz: model {loop_ms:.4f} + "
                  f"{rest_ms:.4f} = {loop_ms + rest_ms:.4f} ms, kernel "
                  f"({args.side}) {ms:.4f} ms, issue efficiency "
                  f"{(loop_ms + rest_ms) / ms:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
