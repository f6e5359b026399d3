"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison with the plain reference, the metrics and the result line.

The window renders the cell's pass of frames over and over, unit after
unit (a unit is what the driver hands the program in one call: a chunk of
frames or one frame), each waited on where the renderer would fetch it,
until ``seconds`` have passed.  With ``trace`` the first pass that starts
after half the window runs under torch.profiler (the traced stretch); its
trace feeds the per-layer metrics and the breakdown.
"""
from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from . import spec, tracing
from .spec import Cell, quantity
from .traffic import generate

# The traced stretch is taken again with the longer pad when its trace lost
# device records (a short session late in a process can come back without
# its kernels; sessions padded by 1.5 s on each side keep them)
TRACE_PADS_S = (1.5, 3.0)
FORBIDDEN = ("jax", "jaxlib", "flax", "fractalrenderer_tpu")


def process_age() -> float:
    """Seconds since this process started (/proc), or since the harness
    was imported where /proc is missing."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


@dataclass
class Window:
    frames: int = 0
    seconds: float = 0.0
    latency_s: List[float] = field(default_factory=list)   # per frame
    dispatch_s: float = 0.0          # host seconds in the program's calls
    dispatch_frames: int = 0         # frames of those calls
    kept: Dict[int, object] = field(default_factory=dict)
    stretch: Optional[dict] = None
    per_second: List[int] = field(default_factory=list)  # frames finished


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _traced_pass(drv, units, device, win: Window, sample: set) -> dict:
    """One pass under torch.profiler; returns the parsed trace, the frames
    in dispatch order and the stretch's clock span."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    last_err = None
    for pad in TRACE_PADS_S:
        frames = []
        _sync(device)
        with profile(activities=acts) as prof:
            time.sleep(pad if cuda else 0.0)
            with record_function("stretch"):
                for unit in units:
                    with record_function("unit"):
                        with record_function("dispatch"):
                            h = drv.submit(unit)
                        with record_function("wait"):
                            drv.wait(h)
                    for f, img in drv.outputs(unit, h):
                        if f in sample:
                            win.kept[f] = img
                    frames += list(unit)
                    win.frames += len(unit)
            _sync(device)
            time.sleep(pad if cuda else 0.0)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)
        if not cuda:
            return {"trace": None, "frames": frames, "lost": None}
        try:
            tr = tracing.parse_trace(raw)
        except tracing.LostRecords as e:
            last_err = str(e)
            continue
        span = next(s for s in tr.spans if s[0] == "stretch")
        last = max(e[2] + e[3] for e in tr.events)
        return {"trace": tr, "frames": frames, "lost": None,
                "span": (span[1], max(span[2], last))}
    return {"trace": None, "frames": [], "lost": last_err}


def measure(drv, units, seconds: float, trace: bool, device,
            sample: set) -> Window:
    """The measured window: whole passes of ``units`` until ``seconds``
    have passed, the traced pass among them when ``trace``."""
    win = Window()
    pending = trace
    k = 0
    t0 = time.perf_counter()
    end = t0
    while True:
        if pending and k % len(units) == 0 and end - t0 >= seconds / 2:
            win.stretch = _traced_pass(drv, units, device, win, sample)
            pending = False
            end = time.perf_counter()
            if end - t0 >= seconds:
                break
        unit = units[k % len(units)]
        a = time.perf_counter()
        h = drv.submit(unit)
        b = time.perf_counter()
        drv.wait(h)
        end = time.perf_counter()
        for f, img in drv.outputs(unit, h):
            if f in sample:
                win.kept[f] = img
        win.dispatch_s += b - a
        win.dispatch_frames += len(unit)
        win.latency_s += [end - a] * len(unit)
        win.frames += len(unit)
        sec = int(end - t0)
        win.per_second += [0] * (sec + 1 - len(win.per_second))
        win.per_second[sec] += len(unit)
        k += 1
        if end - t0 >= seconds and not pending:
            break
    win.seconds = end - t0
    # a sampled frame the window did not reach is still due: render on
    # (outside the window's numbers) until every one has come
    while not sample <= set(win.kept):
        unit = units[k % len(units)]
        h = drv.submit(unit)
        drv.wait(h)
        for f, img in drv.outputs(unit, h):
            if f in sample:
                win.kept[f] = img
        k += 1
    return win


def power_limit_w():
    """The card's power limit (W) as nvidia-smi reads it, or None."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _p95(xs) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), 95))


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device="cuda") -> dict:
    """Run ``cell`` and return the result line's object; the numbers
    compared go under ``checks``, last."""
    import torch

    tr = generate(cell.traffic, cell.config, cell.checks, seed,
                  cell.bench_dir)
    drv = cell.module("drivers", cell.traffic["driver"]).Driver(
        cell.config, cell.traffic, cell.checks, tr, seed, device)
    drv.setup()
    _sync(device)
    setup_s = process_age()

    sample = set(tr.sample)
    win = measure(drv, drv.units, seconds, trace, device, sample)
    _sync(device)
    cuda = torch.device(device).type == "cuda"
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    drv.release()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    checks, work = drv.check(win.kept)
    check_s = time.perf_counter() - t_check
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    correct = correct and set(win.kept) == sample

    device_row = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(device) if cuda
                  else "cpu", "count": cell.chips,
                  "memory_peak_bytes": peak}
    # a frame either renders or the run stops; the answers that never
    # came are sampled frames the window did not produce
    result = {"correct": bool(correct), "attempted": win.frames,
              "failed": len(sample - set(win.kept))}
    if not trace:
        values = {"setup_s": setup_s,
                  "frames_per_s": win.frames / win.seconds,
                  "frame_p95_ms": _p95(win.latency_s) * 1e3}
        metrics = {m["name"]: {"value": values[quantity(m["name"])],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    else:
        st = win.stretch or {}
        tr_ = st.get("trace")
        ctx = {"trace": tr_, "span": st.get("span"),
               "stretch_frames": st.get("frames", []),
               "dispatch_s": win.dispatch_s,
               "dispatch_frames": win.dispatch_frames,
               "work": work}
        metrics = {}
        for m in cell.per_layer:
            v = cell.module("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if tr_ is not None:
            lo, hi = st["span"]
            ev = [e for e in tr_.events if lo <= e[2] <= hi]
            busy, _ = tracing.busy_and_window(ev)
            device_row.update(busy_s=busy, window_s=hi - lo)
            result["breakdown"] = {
                "device_ops": [list(x) for x in
                               tracing.seconds_by_name(ev)[:10]],
                "idle_gaps": [list(x) for x in tracing.idle_gaps(
                    ev, tr_.spans, lo, hi)[:10]]}
        elif st.get("lost"):
            result["trace_lost"] = st["lost"]
    if cuda:
        device_row["power_limit_w"] = power_limit_w()
    result["metrics"] = metrics
    result["device"] = device_row
    result["phases_s"] = {"setup": setup_s, "window": win.seconds,
                          "check": check_s}
    result["frames_by_second"] = win.per_second
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.load_cell(args.workload)
    import torch

    torch_s = process_age()

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace),
                 device="cuda:0")
    result["phases_s"]["torch_imported"] = torch_s
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark may not "
              "load JAX or the JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
