#!/usr/bin/env python3
"""Time the port's K1, K2, K3, K4a and K4b kernels of this checkout against
those of another commit, in turns, on one card.

    python3 chip_ab.py OTHER_ROOT [--reps 3] [--only PREFIX] [--out FILE]

OTHER_ROOT holds the other commit's ``fractalrenderer_tpu_torch/`` package,
for example from ``git archive <commit> fractalrenderer_tpu_torch | tar -x
-C _parent/`` (``_parent/`` is git-ignored).  Each side runs in processes
of its own, which import that side's package (its wrappers, its C
interface, its kernels, built into its own ``_build/``), in the order
other, this, this, other.  A process packs the operands of every case
whose instance name starts with ``--only`` (the cases, views and sizes
are this checkout's chip_smoke.py's: K1's eight instances at their 1080p
x 256 frames, each family's main-path fused frame and its tracked fields
frame, and the variants that split their time (``_nopost``: fused without
the post chain; ``_noskip``: the Mandelbrot fused frame without the
interior skip; ``_untracked``: fields with no trap, stripe or
derivative), K2 at the Seahorse 1e-9 view, every K3 instance at its main
frame, config 4 series off and on and its stacked spp-2 launch, the
families, the ledger and the single pass, K4a's 1080p coarse grids and
K4b's 1080p frames, shaded, from their own K4a grids, of power 8, the
trig step and power 16), then
launches each case once to warm up and ``--reps`` times, each launch
timed by CUDA events, then ``--reps`` times more under the profiler,
whose kernel records give the kernel's own device time per launch (the
events also hold the wrapper's host work and its glue kernels).  A K1
case is compared on every plane it writes, K2 on n, zx and zy, a K4a case
on its t0 grid, a K4b case on all 10 planes (stats on).  Where the side's
kernel takes a trips buffer, its per-warp counters are decoded (K1's and
K2's lane iterations held equal to the frame's loop updates from its n
plane, K4b's lane steps to the frame's sum of work), K4b's launch shape
printed, the SM clock
read under load and, for the instances (not the variants), the kernel's
time without and with the buffer taken in turns.  A case's line gives
each side's kernel time (the mean of its two processes' means, each
beside it), its event median and runs, the ratio this / other of the
kernel times, and whether the two sides' output planes are bit-identical.
The card's name and power limit come first, then the two builds' ptxas
reports (registers / stack frame bytes / spill bytes per instance) side
by side; a spill in this checkout's build fails the run.  With ``--out``
everything is also written as one JSON object.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
TURNS = ("other", "this", "this", "other")


def chip_smoke():
    """This checkout's chip_smoke.py (its cases and helpers), whichever
    package the process imports."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_cases", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def takes_trips(fn) -> bool:
    import inspect

    return "trips" in inspect.signature(fn).parameters


def buffer_turns(diag, dev, launch, buf, reps: int, out: dict) -> dict:
    """``out`` with the kernel's time without and with the trips buffer
    ``buf``, in turns (without, with, with, without)."""
    times = {"without": [], "with": []}
    for side in ("without", "with", "with", "without"):
        extra = {"trips": buf} if side == "with" else {}
        times[side].append(kernel_ms(diag, dev, lambda: launch(**extra),
                                     reps))
    out["ms_without_buffer"] = statistics.mean(times["without"])
    out["ms_with_buffer"] = statistics.mean(times["with"])
    out["buffer_runs"] = times
    return out


def escape_case(cs, dev, family, variant):
    """A K1 case's set-up: ``family``'s 1080p frame in ``variant``
    (chip_smoke.k1_frame); its counters, where the side's K1 takes a trips
    buffer, with their lane iterations held equal to the frame's loop
    updates."""
    from fractalrenderer_tpu_torch.ops import escape

    params, kw = cs.k1_frame(family, variant)

    def launch(**extra):
        return escape.escape_fields_cuda(params, device=dev, **kw, **extra)

    def counters(diag, reps):
        if not takes_trips(escape.escape_fields_cuda):
            return {}
        buf = escape.trips_buffer(cs.W, cs.H, dev)
        launch(trips=buf)
        out = dict(escape.decode_trips(buf))
        want = cs.k1_lane_iters(params, kw, dev)
        assert out["lane_iters"] == want, (out["lane_iters"], want)
        if variant in ("fused", "fields"):
            buffer_turns(diag, dev, launch, buf, reps, out)
        out["sm_clock_mhz"] = cs.sm_clock_mhz(launch)
        return out

    return launch, launch, counters


def bulb_frame(cs, dev, kw):
    """An instance's 1080p bulb operands: (march params, cone params, K4a's
    launch keywords, the integer power)."""
    from fractalrenderer_tpu_torch.ops import bulb_kernel as bk
    from fractalrenderer_tpu_torch.ops import bulb_math as bm

    bp = bm.BulbParams(**kw).clamped()
    ro, dyn = bm.camera_setup(bp)
    ip = bk.resolve_int_power(dyn)
    params = bk.pack_march_params(ro=ro, fov=bp.fov, power=dyn,
                                  max_iter=bp.max_iterations)
    ckw = dict(coarse_w=-(-cs.W // cs.CONE), coarse_h=-(-cs.H // cs.CONE) + 1,
               width=cs.W, map_height=cs.H, int_power=ip, device=dev)
    return params, bk.pack_cone_params(params, cs.CONE, cs.H), ckw, ip


def bulb_cone_case(cs, dev, kw):
    """A K4a case's set-up: the instance's 1080p coarse grid."""
    from fractalrenderer_tpu_torch.ops import bulb_kernel as bk

    _, cparams, ckw, _ = bulb_frame(cs, dev, kw)

    def launch():
        return (bk.cone_fields_cuda(cparams, **ckw),)

    return launch, launch, None


def bulb_case(cs, dev, kw):
    """A K4b case's set-up: the instance's 1080p frame, shaded, from its
    own K4a grid (made once); the timed launch is the main path's (no
    stats), the compared one has all 10 planes."""
    from fractalrenderer_tpu_torch.ops import bulb_kernel as bk

    params, cparams, ckw, ip = bulb_frame(cs, dev, kw)
    tc = bk.cone_fields_cuda(cparams, **ckw)
    mkw = dict(width=cs.W, height=cs.H, map_height=cs.H, cone=cs.CONE,
               shade=True, int_power=ip, device=dev)

    def launch(stats=False, **extra):
        return bk.march_fields_cuda(params, tc, stats=stats, **mkw, **extra)

    return (launch, lambda: launch(stats=True),
            lambda diag, reps: bulb_counters(dev, diag, launch, ip, reps))


def cases(cs, dev):
    """(instance, label, set-up) of every case.  The set-up puts the
    case's operands on the card and returns (the launch as a function of
    nothing, the launch whose output planes are compared, and None or a
    function of (diag, reps) that returns the side's decoded counters,
    {} where it has none)."""
    import torch

    from fractalrenderer_tpu_torch.ops import dd, dd_escape, perturbation

    for family in cs.FAMILIES:
        for variant in cs.K1_VARIANTS:
            if variant == "fused_noskip" and family != "mandelbrot":
                continue
            yield (f"escape_{family}_{variant}",
                   f"{family} {variant} {cs.W}x{cs.H}x{cs.ITERS}",
                   lambda f=family, v=variant: escape_case(cs, dev, f, v))

    def dd_setup():
        v = cs.DD_VIEW
        params = dd_escape.pack_dd_params(
            center_x_dd=dd.dd_from_string(v["cx"]),
            center_y_dd=dd.dd_from_string(v["cy"]),
            zoom_dd=dd.dd_from_string(v["zoom"]), iter_limit=v["iters"])

        def fn(**extra):
            return dd_escape.dd_escape_fields_cuda(
                params, width=cs.W, height=cs.H, map_height=cs.H, row0=0,
                device=dev, **extra)

        def counters(diag, reps):
            if not takes_trips(dd_escape.dd_escape_fields_cuda):
                return {}
            buf = dd_escape.trips_buffer(cs.W, cs.H, dev)
            n = fn(trips=buf)[0]
            out = dict(dd_escape.decode_trips(buf))
            want = int(n.clamp(max=v["iters"] - 1).double().sum())
            assert out["lane_iters"] == want, (out["lane_iters"], want)
            buffer_turns(diag, dev, fn, buf, reps, out)
            out["sm_clock_mhz"] = cs.sm_clock_mhz(fn)
            return out

        return fn, fn, counters

    v = cs.DD_VIEW
    yield ("dd_escape_mandelbrot", f"Seahorse {v['zoom']} x{v['iters']}",
           dd_setup)

    def pert(view, width, height, series=False, **extra):
        def setup():
            orb, kw, _ = cs.pert_setup(
                view, width, height, series,
                exact_dust=extra.get("track_err", False))
            params, streams, launch = perturbation.pack_pert_operands(
                orb, width, height, **kw, **extra)
            streams = [torch.from_numpy(a).to(dev) for a in streams]
            fn = lambda: perturbation.perturbation_fields_cuda(  # noqa: E731
                params, streams, max_passes=256, device=dev, **launch)
            return fn, fn, None
        return setup

    for name, label, view, w, h, series in cs.PERT_CASES:
        yield name, label, pert(view, w, h, series)
    yield (cs.STACKED, "config 4 (1e-12 x10000), 4 segments in one launch",
           pert("config4", cs.W, cs.H, aa_spp=2))
    for name, label, view, w, h, extra in cs.FORM_CASES:
        yield name, label, pert(view, w, h, **extra)
    for tag, label, kw in cs.BULB_CASES:
        yield (f"bulb_cone_{tag}", f"{label}, {cs.W}x{cs.H} coarse grid",
               lambda kw=kw: bulb_cone_case(cs, dev, kw))
        yield (f"bulb_march_{tag}", f"{label}, {cs.W}x{cs.H} shaded, from "
               "its K4a grid", lambda kw=kw: bulb_case(cs, dev, kw))


KERNELS = ("escape_kernel", "pert_kernel", "bulb_cone_kernel",
           "bulb_march_kernel")


def kernel_ms(diag, dev, launch, reps: int) -> float:
    """Mean device ms per launch of ``launch``'s kernel over ``reps``
    launches, from the profiler's kernel records."""
    with tempfile.TemporaryDirectory() as d:
        diag.measure_device_seconds(lambda: [launch() for _ in range(reps)],
                                    d, dev)
        recs = diag.kernel_seconds_from_trace(d)
    ours = [v for k, v in recs.items() if any(n in k for n in KERNELS)]
    assert sum(v[0] for v in ours) == reps, recs
    return sum(v[1] for v in ours) / reps * 1e3


def bulb_counters(dev, diag, launch, ip, reps: int) -> dict:
    """K4b's per-warp counters (decoded) and launch shape, and the kernel's
    time without and with the trips buffer, in turns (without, with, with,
    without), where the package has the buffer; {} where it has not."""
    from fractalrenderer_tpu_torch.ops import bulb_kernel as bk

    if not takes_trips(bk.march_fields_cuda):
        return {}
    cs = chip_smoke()
    buf = bk.trips_buffer(ip, cs.W, cs.H, dev)
    work = launch(stats=True, trips=buf)[-1]
    out = dict(bk.decode_trips(buf))
    # every DE step of the frame is one stepping lane of one trip
    assert out["lane_steps"] == int(work.double().sum()), \
        (out["lane_steps"], float(work.double().sum()))
    out["blocks"], out["blocks_per_sm"] = bk.march_grid(ip, cs.W, cs.H, dev)
    buffer_turns(diag, dev, launch, buf, reps, out)
    out["sm_clock_mhz"] = cs.sm_clock_mhz(launch)
    return out


def worker(root: str, reps: int, only: str) -> dict:
    """One side's process: build and load ``root``'s kernels, then time
    every case whose instance starts with ``only``; returns its ptxas
    report and, per case, its event runs, its kernel's mean device ms per
    launch, the sha256 of its output planes and, for K4b, its counters."""
    sys.path.insert(0, root)
    import torch

    import fractalrenderer_tpu_torch as pkg
    from fractalrenderer_tpu_torch.ops import _cuda
    from fractalrenderer_tpu_torch.utils import diag

    assert os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__))) \
        == os.path.abspath(root), (pkg.__file__, root)
    cs = chip_smoke()
    dev = torch.device("cuda", 0)
    _cuda.load_library()
    with open(_cuda.library_path()[:-3] + ".log") as f:
        report = cs.ptxas_report(f.read())
    rows = []
    for name, label, setup in cases(cs, dev):
        if not name.startswith(only):
            continue
        launch, planes, counters = setup()
        launch()
        outs = planes()
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for o in outs:
            digest.update(o.cpu().numpy().tobytes())
        runs = [cs.cuda_event_ms(launch)[1] for _ in range(reps)]
        rows.append(dict(name=name, label=label, runs=runs,
                         kernel_ms=kernel_ms(diag, dev, launch, reps),
                         planes=len(outs), sha256=digest.hexdigest(),
                         counters=counters(diag, reps) if counters else {}))
    return dict(root=root, ptxas=report, cases=rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_root")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out")
    ap.add_argument("--only", default="",
                    help="time only the instances whose name starts so "
                    "(e.g. bulb_march)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)  # a side's process
    args = ap.parse_args()
    if args.worker:
        result = worker(args.other_root, args.reps, args.only)
        with open(args.worker, "w") as f:
            json.dump(result, f)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    other = os.path.abspath(args.other_root)
    if not os.path.isdir(os.path.join(other, "fractalrenderer_tpu_torch")):
        print(f"error: {other} holds no fractalrenderer_tpu_torch/",
              file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0], flush=True)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for k, side in enumerate(TURNS):
            path = os.path.join(tmp, f"{k}.json")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            other if side == "other" else HERE,
                            "--reps", str(args.reps), "--only", args.only,
                            "--worker", path],
                           check=True)
            with open(path) as f:
                results.append(json.load(f))
    cs = chip_smoke()
    reports = {side: r["ptxas"] for side, r in zip(TURNS, results)}
    names = sorted(n for n in reports["this"]
                   if n.startswith(("escape_", "pert_", "dd_escape"))
                   or n in {f"bulb_{k}_{tag}" for k in ("cone", "march")
                            for tag, *_ in cs.BULB_CASES})
    print("ptxas registers/stack frame bytes/spill bytes, other -> this: "
          + ", ".join(
              f"{n} " + " -> ".join(
                  "{regs}/{stack}/{spill}".format(**r[n]) if n in r else "-"
                  for r in (reports["other"], reports["this"]))
              for n in names), flush=True)
    rows = []
    for i, case in enumerate(results[0]["cases"]):
        turns = [r["cases"][i] for r in results]
        assert len({t["name"] for t in turns}) == 1, turns
        runs = {side: [] for side in ("other", "this")}
        kernel = {side: [] for side in ("other", "this")}
        for side, t in zip(TURNS, turns):
            runs[side] += t["runs"]
            kernel[side].append(t["kernel_ms"])
        med = {k: statistics.median(v) for k, v in runs.items()}
        kms = {k: statistics.mean(v) for k, v in kernel.items()}
        same = len({t["sha256"] for t in turns}) == 1
        rows.append(dict(name=case["name"], label=case["label"],
                         other_kernel_ms=kms["other"],
                         this_kernel_ms=kms["this"],
                         ratio=kms["this"] / kms["other"],
                         other_kernel_runs=kernel["other"],
                         this_kernel_runs=kernel["this"],
                         other_event_ms=med["other"],
                         this_event_ms=med["this"],
                         other_event_runs=runs["other"],
                         this_event_runs=runs["this"],
                         outputs_identical=same,
                         counters={side: t["counters"] for side, t
                                   in zip(TURNS, turns) if t["counters"]}))
        print(f"{case['name']} {case['label']}: kernel other "
              f"{kms['other']:.3f} ms {[round(t, 3) for t in kernel['other']]}"
              f", this {kms['this']:.3f} ms "
              f"{[round(t, 3) for t in kernel['this']]}, this / other "
              f"{kms['this'] / kms['other']:.3f}; CUDA events other "
              f"{med['other']:.3f} ms (runs "
              f"{[round(t, 3) for t in runs['other']]}), this "
              f"{med['this']:.3f} ms (runs "
              f"{[round(t, 3) for t in runs['this']]}); output planes "
              + ("bit-identical" if same else "DIFFER") + " between the "
              "two sides", flush=True)
        for side, t in zip(TURNS, turns):
            c = t["counters"]
            if c and "lane_iters" in c:
                print(f"  {side} {case['name']} counters: "
                      f"{cs.escape_trips_line(c)}"
                      + (f"; kernel without / with the buffer "
                         f"{c['ms_without_buffer']:.4f} / "
                         f"{c['ms_with_buffer']:.4f} ms {c['buffer_runs']}"
                         if "buffer_runs" in c else "")
                      + f"; SM clock {c['sm_clock_mhz']} MHz", flush=True)
            elif c:
                print(f"  {side} {case['name']} counters: grid "
                      f"{c['blocks']} blocks of 256 ({c['blocks_per_sm']} "
                      f"per SM), {c['warps']} warps on {c['sms']} SMs; "
                      f"trips {c['trips']}, step trips {c['step_trips']}, "
                      f"event trips {c['event_trips']} (share "
                      f"{c['event_share']:.3f}), lane steps "
                      f"{c['lane_steps']} (utilisation "
                      f"{c['lane_util']:.3f}), span {c['span_ns'] / 1e6:.4f}"
                      f" ms, tail share {c['tail_share']:.3f}; kernel "
                      f"without / with the buffer {c['ms_without_buffer']:.4f}"
                      f" / {c['ms_with_buffer']:.4f} ms "
                      f"{c['buffer_runs']}; SM clock {c['sm_clock_mhz']} MHz",
                      flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(ptxas=reports, cases=rows), f, indent=1)
    spills = {n: r for n, r in reports["this"].items() if r["spill"]}
    assert not spills, f"local-memory spills in this checkout: {spills}"
    return 0


if __name__ == "__main__":
    sys.exit(main())
