"""Where the card idles in one traced pass of a benchmark cell, by the
program's stage spans, and what a span costs on this host.

    python3 tools/span_coverage.py --workload <cell> [--seed N]

Runs the cell's set-up and one warm pass through its driver, then one
pass as the benchmark's traced stretch takes it (``benchmark/harness/
core.py``: the same profiler session, pads and harness annotations), and
prints one JSON line:

- ``idle_in_dispatch_s``: the card's idle seconds inside the harness's
  ``dispatch`` annotations; ``stage_share`` the part of them that a
  program stage span covers (any span but the harness's and the frame
  spans ``batch.frame``/``deep.frame``/``bulb.frame``),
  ``frame_only_share`` the part under a frame span alone,
  ``idle_by_stage_s`` the idle seconds under each stage,
  ``idle_outside_frames_s`` those under no frame span by the innermost
  span open, ``longest_idle_gaps`` as the harness labels them;
- ``per_frame_ms``: per frame of the pass, each span's self time, the
  frame span's duration and the harness's dispatch;
- ``frame_self``: the host's operator and runtime calls in the frame
  spans' self time (outside every stage span);
- ``gc``: the garbage collector's runs inside the stretch;
- ``metrics``: the benchmark's per-layer readers on this trace;
- ``span_cost_us``: a span's cost with no session (``off``, the flag test
  alone ``flag``) and inside a session of the card (``on``), and whether
  the profiler's flag flips with ``torch.profiler.profile``.

Needs a card; reads and writes nothing outside the checkout.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["FRACTAL_TORCH_BUILD_DIR"] = os.path.join(
    ROOT, "fractalrenderer_tpu_torch", "_build")
sys.path.insert(0, ROOT)

HARNESS = {"stretch", "unit", "dispatch", "wait"}
FRAMES = {"batch.frame", "deep.frame", "bulb.frame"}


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _intersect(xs, ys):
    """The intersection of two sorted unions of intervals."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append([a, b])
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _subtract(xs, ys):
    """The parts of the sorted union ``xs`` outside the sorted union
    ``ys``."""
    out = []
    for a, b in xs:
        pos = a
        for c, d in ys:
            if d <= pos or c >= b:
                continue
            if c > pos:
                out.append([pos, c])
            pos = max(pos, d)
        if pos < b:
            out.append([pos, b])
    return out


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def idle_intervals(events, lo, hi):
    gaps, end = [], lo
    for _, _, start, dur in sorted(events, key=lambda e: e[2]):
        if start > end:
            gaps.append([end, start])
        end = max(end, start + dur)
    if hi > end:
        gaps.append([end, hi])
    return gaps


def coverage(tr, lo, hi, frames) -> dict:
    from benchmark.harness import spans as spanlib
    from benchmark.harness import tracing

    ev = [e for e in tr.events if lo <= e[2] <= hi]
    sp = sorted((s for s in tr.spans if lo <= s[1] <= hi),
                key=lambda s: (s[1], -s[2]))
    of = lambda pred: _union([(s[1], s[2]) for s in sp  # noqa: E731
                              if pred(s[0])])
    idle = _intersect(_union(idle_intervals(ev, lo, hi)),
                      of(lambda n: n == "dispatch"))
    staged = _intersect(idle, of(lambda n: n not in HARNESS | FRAMES))
    framed = _intersect(idle, of(lambda n: n in FRAMES))
    names = sorted({s[0] for s in sp} - HARNESS)
    total = _length(idle)
    unframed = {}  # idle in dispatch outside every frame span, by the
    # innermost span open at each piece's middle
    for a, b in _subtract(idle, of(lambda n: n in FRAMES)):
        mid = 0.5 * (a + b)
        label = min((s for s in sp if s[1] <= mid <= s[2]),
                    key=lambda s: s[2] - s[1])[0]
        unframed[label] = unframed.get(label, 0.0) + (b - a)
    return {
        "frames": len(frames),
        "idle_in_dispatch_s": total,
        "stage_share": _length(staged) / total if total else None,
        "frame_only_share": ((_length(framed) - _length(staged)) / total
                             if total else None),
        "idle_outside_frames_s": unframed,
        "longest_idle_gaps": [list(g) for g in tracing.idle_gaps(
            ev, sp, lo, hi)[:6]],
        "idle_by_stage_s": {n: _length(_intersect(idle, of(
            lambda m, n=n: m == n))) for n in names if n not in FRAMES},
        "per_frame_ms": dict(
            {f"{n}.self": 1e3 * spanlib.self_seconds(sp, [n]) / len(frames)
             for n in names},
            **{f"{n}.duration": 1e3 * sum(s[2] - s[1] for s in sp
                                          if s[0] == n) / len(frames)
               for n in sorted(FRAMES & set(names))},
            dispatch=1e3 * sum(s[2] - s[1] for s in sp
                               if s[0] == "dispatch") / len(frames)),
        "spans_per_frame": sum(s[0] not in HARNESS for s in sp)
        / len(frames)}


def traced_pass(drv, device) -> tuple:
    """One pass as the harness's traced stretch (the same annotations and
    pads): the parsed trace, the raw chrome trace, the frames, and the
    garbage collector's runs inside the stretch, (generation, host
    seconds) each."""
    import gc
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.harness import core, tracing

    for pad in core.TRACE_PADS_S:
        frames, gcs, t0, bounds = [], [], [0.0], []

        def timed(phase, info):
            if phase == "start":
                t0[0] = time.perf_counter()
            elif bounds and len(bounds) < 2:  # inside the stretch
                gcs.append((info["generation"], time.perf_counter() - t0[0]))

        torch.cuda.synchronize(device)
        gc.callbacks.append(timed)
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                time.sleep(pad)
                bounds.append(time.perf_counter())
                with record_function("stretch"):
                    for unit in drv.units:
                        with record_function("unit"):
                            with record_function("dispatch"):
                                h = drv.submit(unit)
                            with record_function("wait"):
                                drv.wait(h)
                        drv.outputs(unit, h)
                        frames += list(unit)
                bounds.append(time.perf_counter())
                torch.cuda.synchronize(device)
                time.sleep(pad)
        finally:
            gc.callbacks.remove(timed)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)
        try:
            tr = tracing.parse_trace(raw)
        except tracing.LostRecords as e:
            print(f"lost records with pad {pad}: {e}", file=sys.stderr)
            continue
        return tr, raw, frames, gcs
    raise RuntimeError("every traced pass lost device records")


def uncovered_host_calls(raw, sp, top: int = 12) -> dict:
    """The host's operator and runtime calls that start inside a frame span
    but outside every stage span, by name: [count, seconds summed] (nested
    operators each counted), largest first."""
    frames = _union([(s[1], s[2]) for s in sp if s[0] in FRAMES])
    stages = _union([(s[1], s[2]) for s in sp
                     if s[0] not in HARNESS | FRAMES])
    cut = _subtract(frames, stages)
    starts = [a for a, _ in cut]
    out = {}
    for e in raw.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("cat") not in ("cpu_op",
                                                        "cuda_runtime",
                                                        "cuda_driver"):
            continue
        t = e.get("ts", 0) / 1e6
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t < cut[k][1]:
            c = out.setdefault(e["name"], [0, 0.0])
            c[0] += 1
            c[1] += e.get("dur", 0) / 1e6
    return {"self_s": _length(cut),
            "calls": sorted(out.items(), key=lambda kv: -kv[1][1])[:top]}


def span_cost_us(device) -> dict:
    import torch
    from torch.autograd import profiler as ap
    from torch.profiler import ProfilerActivity, profile

    from fractalrenderer_tpu_torch.utils.diag import span

    def spans(n):
        for _ in range(n):
            with span("cost.probe"):
                pass

    def flags(n):
        for _ in range(n):
            ap._is_profiler_enabled

    def empty(n):
        for _ in range(n):
            pass

    def per(fn, n):
        t = time.perf_counter()
        fn(n)
        return (time.perf_counter() - t) / n * 1e6

    n = 200_000
    base = min(per(empty, n) for _ in range(3))
    out = {"off": min(per(spans, n) for _ in range(3)) - base,
           "flag": min(per(flags, n) for _ in range(3)) - base,
           "flag_before": [ap._is_profiler_enabled,
                           torch._C._autograd._profiler_enabled()]}
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out["flag_inside"] = [ap._is_profiler_enabled,
                              torch._C._autograd._profiler_enabled()]
        out["on"] = min(per(spans, 20_000) for _ in range(3)) - base
    out["flag_after"] = [ap._is_profiler_enabled,
                         torch._C._autograd._profiler_enabled()]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=20260417)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import spec
    from benchmark.harness.traffic import generate

    if not torch.cuda.is_available():
        print("needs a card", file=sys.stderr)
        return 2
    device = "cuda:0"
    cell = spec.load_cell(args.workload)
    tr = generate(cell.traffic, cell.config, cell.checks, args.seed,
                  cell.bench_dir)
    drv = cell.module("drivers", cell.traffic["driver"]).Driver(
        cell.config, cell.traffic, cell.checks, tr, args.seed, device)
    drv.setup()
    for unit in drv.units:  # one warm pass
        drv.wait(drv.submit(unit))
    trace, raw, frames, gcs = traced_pass(drv, device)
    stretch = next(s for s in trace.spans if s[0] == "stretch")
    lo = stretch[1]
    hi = max(stretch[2], max(e[2] + e[3] for e in trace.events))
    ctx = {"trace": trace, "span": (lo, hi), "stretch_frames": frames,
           "dispatch_s": 0.0, "dispatch_frames": 0, "work": {}}
    sp = sorted((s for s in trace.spans if lo <= s[1] <= hi),
                key=lambda s: (s[1], -s[2]))
    metrics = {}
    for m in cell.per_layer:
        if m["source"] in ("program_span", "program_counter") \
                or m["name"].startswith("device_idle_share"):
            metrics[m["name"]] = cell.module("metrics", m["name"]).read(ctx)
    out = {"workload": cell.name, "seed": args.seed,
           "device": torch.cuda.get_device_name(0),
           "window_s": hi - lo,
           **coverage(trace, lo, hi, frames),
           "frame_self": uncovered_host_calls(raw, sp),
           "gc": {"collections": len(gcs),
                  "seconds": sum(t for _, t in gcs),
                  "by_generation": [sum(g == k for g, _ in gcs)
                                    for k in range(3)]},
           "metrics": metrics, "span_cost_us": span_cost_us(device)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
