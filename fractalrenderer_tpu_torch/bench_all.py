"""Benchmark suite of the PyTorch + CUDA port: the counterpart of the
repository root's ``bench_all.py`` (the JAX package's), config for config.

    python -m fractalrenderer_tpu_torch.bench_all [--skip 0,4]
        [--device cuda|cpu] [--out PATH] [--quick]

Prints one JSON line per config, ``{"configN": {...}}``, each row with the
card's name and power limit (``nvidia-smi``), or ``"cpu"``; then a row for
the device-to-host link probe.  It writes a file only to ``--out``.

Ported configs (keys as in the JAX rows wherever the meaning holds):

0. fresh-process 1080p ``cli render``, cold (a new build directory: the
   first process builds every kernel) then warm, with the fresh-compile
   probe K6;
1. Mandelbrot 1080p / 256 iterations, 64 frames of the main path, with the
   roofline against the FP32 peak that K5 measures;
2. Julia c-sweep, 16 frames per batch at 1080p;
3. a 300-frame zoom animation at 1080p (256 -> 1024 iterations), each frame
   quantized to planar uint8 and summed into an accumulator, with K1's
   per-frame kernel records and the device lane's idle share;
4. deep zoom 1e-12 / 10000 iterations at 1080p (spp 1 and 2, series skip,
   the per-pixel rebase-round histogram);
5. the giant still: a 16384x16384 16-bit PNG in 1024-row bands
   (parallel.render_giant_still), with K1's device time per band, the link
   probe, the host time blocked on fetches and the workers' deflate time;
6. the Mandelbulb at 1080p;
7. deep zoom 1e-50 / 2000 iterations at 960x540;
8. the live session's keypress-to-frame latency: the sixel and kitty-PNG
   encodes of an 800x624 frame, then ``cli interactive --live`` on a pty
   (100x40 cells, sixel), 16 ``e`` keys on the default Mandelbrot and 6 on
   the deep zoom 1e-12 / 10000, p50 and p95 from the key's write to the
   complete sixel frame on the pty.

``--quick`` runs config 3 at 60 frames and config 5 at 4096x4096, as the
root bench's ``--quick`` does.  Device
times are the device lane of torch.profiler traces
(utils/diag.measure_device_seconds, ``timing_method`` "torch_profiler"):
host gaps between launches, such as a deep zoom's orbit on the host, are
not counted.  A config that raises is recorded as ``{"error": ...}`` and
the run goes on; the exit code is 1 when any ported config failed.  Each
config function takes the frame size and iterations (the JAX values by
default) and a device, so the CPU tests run them small.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from .scene import FractalType, Scene
from .utils.diag import (busy_and_window, device_events_from_trace,
                         measure_device_seconds, measure_link_bandwidth,
                         measure_vpu_peak)

W, H = 1920, 1080
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DZ4 = dict(hp_center_x="-0.74364388703715158",
           hp_center_y="0.13182590420531198", hp_zoom="1e-12")
# K1's fused Mandelbrot loop: 8 f32 operations per iteration as counted
# from csrc/escape.cu (the JAX rows' 14 and 10 are the TPU's vector ops)
K1_OPS_PER_ITER = 8
K1_WARP = 32  # csrc/escape.cu's 32x8 blocks: a warp is 32 pixels of a row


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device (a CUDA one with its index); raises for
    CUDA where there is none."""
    dev = torch.device(device)
    if dev.type == "cuda":
        from .ops._cuda import cuda_device

        dev = cuda_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


TIMING = "torch_profiler"  # the rows' timing_method


def device_seconds(run, dev: torch.device, rounds: int = 2) -> float:
    """The best over ``rounds`` traces of the device seconds of ``run()``
    on ``dev`` (on the CPU: its top-level operators' seconds)."""
    return min(measure_device_seconds(run, device=dev)
               for _ in range(rounds))


def main_path_seconds(scene: Scene, width: int, height: int, frames: int,
                      dev: torch.device, rounds: int = 2):
    """Device seconds per frame of the main path (models.render, fused K1 +
    quantize) over ``frames`` frames on one stream, each at a zoom offset
    by k x 1e-6 and consumed by a wrapping uint8 accumulate (no frame is
    fetched)."""
    from . import models

    scenes = [scene.with_(zoom=scene.zoom + k * 1e-6) for k in range(frames)]
    models.render(scenes[0], width, height, device=dev, quantize=8)  # warm

    def run():
        acc = torch.zeros((height, width, 3), dtype=torch.uint8, device=dev)
        for s in scenes:
            acc.add_(models.render(s, width, height, device=dev, quantize=8))
        int(acc[0, 0, 0])

    return device_seconds(run, dev, rounds) / frames


def _poll_png(p: subprocess.Popen, out_png: str, t0: float,
              timeout: float) -> float:
    """Wait for ``p``; return when ``out_png`` first ended in a PNG IEND
    chunk (seconds since ``t0``), or None."""
    first = None
    while p.poll() is None:
        if first is None and os.path.exists(out_png):
            try:
                with open(out_png, "rb") as fh:
                    fh.seek(-8, 2)
                    if fh.read(8) == b"IEND\xaeB`\x82":
                        first = time.perf_counter() - t0
            except OSError:
                pass
        if time.perf_counter() - t0 > timeout:
            raise RuntimeError("cold-start probe timed out")
        time.sleep(0.02)
    return first


def bench_cold_start(width: int = W, height: int = H, iters: int = 256,
                     device="cuda") -> dict:
    """Config 0: the real CLI's 1080p render in two fresh processes that
    share one new build directory (``FRACTAL_TORCH_BUILD_DIR``): the first
    builds every kernel (cold), the second loads the library (warm).  The
    parent polls the PNG for its IEND chunk; the port has no CPU preview,
    so the first visible frame is the render's own PNG.  Then the
    fresh-compile probe K6 (on a card)."""
    from .ops import _cuda

    dev = resolve_device(device)

    def probe(build: str):
        with tempfile.TemporaryDirectory() as d:
            out_png = os.path.join(d, "cold.png")
            env = dict(os.environ, FRACTAL_TORCH_BUILD_DIR=build,
                       PYTHONPATH=os.pathsep.join(
                           [REPO, *filter(None, [os.environ.get(
                               "PYTHONPATH")])]))
            # the child's output goes to files, not pipes: an undrained
            # pipe fills and stalls a chatty child
            with open(os.path.join(d, "stdout.txt"), "w") as so, \
                    open(os.path.join(d, "stderr.txt"), "w") as se:
                t0 = time.perf_counter()
                p = subprocess.Popen(
                    [sys.executable, "-m", "fractalrenderer_tpu_torch.cli",
                     "render", "--width", str(width), "--height",
                     str(height), "--iters", str(iters), "--device",
                     str(dev), "--out", out_png],
                    stdout=so, stderr=se, env=env, cwd=d)
                try:
                    visible = _poll_png(p, out_png, t0, timeout=600.0)
                finally:
                    if p.poll() is None:
                        p.kill()
                    p.wait()
                wall = time.perf_counter() - t0
            if p.returncode != 0:
                with open(os.path.join(d, "stderr.txt")) as f:
                    raise RuntimeError("cold-start probe failed: "
                                       + f.read()[-300:])
            return wall, (wall if visible is None else visible)

    with tempfile.TemporaryDirectory() as build:
        first, first_vis = probe(build)
        built = sorted(f for f in os.listdir(build)
                       if f.startswith("libfr_kernels_"))
        second, second_vis = probe(build)
    if dev.type == "cuda" and not built:
        raise RuntimeError("the cold process built no kernel library")
    row = {"config": "fresh_process_1080p_render",
           "first_process_s": first, "first_visible_frame_s": first_vis,
           "preview_served_first": False,
           "cached_process_s": second, "cached_visible_frame_s": second_vis,
           "first_visible_note": "no CPU preview in the port: the first "
                                 "visible frame is the render's own PNG",
           "cache_dir": build, "kernels_built_cold": built}
    if dev.type == "cuda":
        cp = _cuda.compile_probe(dev)
        row.update(compile_service_fresh_trivial_s=cp["seconds"],
                   compile_probe_build_s=cp["build_seconds"])
    else:
        row.update(compile_service_fresh_trivial_s=None, reason="cpu")
    return row


def issued_iterations(n: torch.Tensor, skipped: torch.Tensor) -> float:
    """Loop iterations K1 issues for the counts ``n``, modelled from the n
    plane: each warp (32 pixels of one row) runs as long as its slowest
    lane; skipped lanes never enter the loop.  Sum over warps of 32 x max
    n.  K1 runs this schedule (one thread per pixel); its trips buffer
    counts the same trips on the card."""
    h, w = n.shape
    lanes = torch.where(skipped, torch.zeros_like(n), n).double()
    pad = -w % K1_WARP
    lanes = torch.nn.functional.pad(lanes, (0, pad))
    return float(lanes.view(h, -1, K1_WARP).amax(-1).sum() * K1_WARP)


def bench_mandelbrot_1080p(width: int = W, height: int = H,
                           iters: int = 256, frames: int = 64,
                           device="cuda") -> dict:
    """Config 1: the main path's frame time over ``frames`` frames, then
    the roofline: useful iterations from the plain K1's n plane, issued
    iterations from per-warp maxima (the model of issued_iterations),
    against the FP32 peak K5 measures (on a card)."""
    from .ops import escape

    dev = resolve_device(device)
    vpu = measure_vpu_peak(device=dev) if dev.type == "cuda" else None
    scene = Scene(max_iterations=iters)
    per = main_path_seconds(scene, width, height, frames, dev)
    row = {"config": "mandelbrot_1080p_256iter", "ms_per_frame": per * 1e3,
           "mpix_s": width * height / per / 1e6, "timing_method": TIMING}

    frame = dict(width=width, height=height, map_height=height, row0=0)
    params = escape.pack_params(center_x=scene.center_x,
                                center_y=scene.center_y, zoom=scene.zoom,
                                iter_limit=iters)
    n = escape.escape_fields_plain(
        params, max_iter_cap=iters, interior_skip=True, fused_color=None,
        device=dev, **frame)[0]
    skipped = escape.interior_skip_mask(params, device=dev, **frame)
    # the skipped lanes report n = limit but run no iteration: neither
    # count holds them
    useful = float(n.double()[~skipped].sum())
    issued = issued_iterations(n, skipped)
    row.update(useful_iters_per_s=useful / per / 1e9,
               issued_iters_per_s=issued / per / 1e9,
               issued_over_useful=issued / useful)
    if vpu is None:
        row.update(vpu_peak_gflops_f32=None, reason="cpu")
        return row
    peak = vpu["gflops_f32"] * 1e9
    row.update(vpu_peak_gflops_f32=vpu["gflops_f32"],
               vpu_peak_ms=vpu["seconds"] * 1e3)
    for ops in (14, 10, K1_OPS_PER_ITER):
        row[f"pct_peak_at_{ops}_ops"] = 100 * issued / per * ops / peak
    return row


def bench_julia_sweep(width: int = W, height: int = H, iters: int = 256,
                      batches: int = 4, device="cuda") -> dict:
    """Config 2: batches of 16 fused Julia frames (one K1 launch each) at
    the JAX sweep's c values, consumed by a uint8 accumulate."""
    from . import models

    dev = resolve_device(device)
    b = 16
    s = Scene(fractal_type=FractalType.JULIA, max_iterations=iters,
              zoom=3.0)
    c_re = np.linspace(-0.9, -0.6, b, dtype=np.float32)
    c_im = np.linspace(0.1, 0.3, b, dtype=np.float32)
    models.render(s, width, height, device=dev, quantize=8)  # warm

    def run():
        acc = torch.zeros((height, width, 3), dtype=torch.uint8, device=dev)
        for k in range(batches):
            for i in range(b):
                acc.add_(models.render(
                    s.with_(julia_c_real=float(c_re[i]) + k * 1e-6,
                            julia_c_imag=float(c_im[i])),
                    width, height, device=dev, quantize=8))
        int(acc[0, 0, 0])

    per_batch = device_seconds(run, dev) / batches
    return {"config": "julia_c_sweep_16x1080p",
            "ms_per_batch": per_batch * 1e3,
            "mpix_s": b * width * height / per_batch / 1e6,
            "timing_method": TIMING}


def _stats(xs) -> dict:
    a = np.asarray(xs, np.float64)
    return {"sum": float(a.sum()), "mean": float(a.mean()),
            "p50": float(np.percentile(a, 50)), "min": float(a.min()),
            "max": float(a.max())}


def animation_frames(frames: int = 300):
    """Config 3's frames: the root bench's two keyframes (the default view
    at 256 iterations to Seahorse Valley at zoom 0.008 and 1024), linear,
    at 30 fps, interpolated as the animation renderer does."""
    from .anim.keyframes import Animation, InterpolationType, Keyframe

    anim = Animation(duration=frames / 30.0, target_fps=30)
    anim.keyframes.append(Keyframe(0.0, Scene(zoom=2.5, max_iterations=256),
                                   InterpolationType.LINEAR))
    anim.keyframes.append(Keyframe(anim.duration,
                                   Scene(center_x=-0.743643887037151,
                                         center_y=0.13182590420533,
                                         zoom=0.008, max_iterations=1024),
                                   InterpolationType.LINEAR))
    return [anim.interpolate(anim.frame_time(f)) for f in range(frames)]


def animation_work(scenes, width: int, height: int, device) -> tuple:
    """(useful iterations, wholly interior) of each Mandelbrot frame of
    ``scenes``: the loop updates K1's n plane counts over the pixels the
    analytic interior skip leaves in the loop (K1's own fields launch on
    a card, the plain version on the CPU), and whether the skip covers
    every pixel.  The cap is the frames' largest limit, as in an
    animation's batch."""
    from .ops import escape

    frame = dict(width=width, height=height, map_height=height, row0=0)
    cap = max(s.max_iterations for s in scenes)
    useful, interior = [], []
    for s in scenes:
        params = escape.pack_params(center_x=s.center_x, center_y=s.center_y,
                                    zoom=s.zoom, iter_limit=s.max_iterations)
        skipped = escape.interior_skip_mask(params, device=device, **frame)
        n = escape.escape_fields("mandelbrot", width, height,
                                 center_x=s.center_x, center_y=s.center_y,
                                 zoom=s.zoom, max_iter=cap,
                                 iter_limit=s.max_iterations,
                                 interior_skip=True, device=device)["n"]
        useful.append(float(n.double()[~skipped].sum()))
        interior.append(bool(skipped.all()))
    return useful, interior


def bench_animation(width: int = W, height: int = H, frames: int = 300,
                    device="cuda") -> dict:
    """Config 3: the 300-frame zoom animation of the batch path — every
    frame the fused K1 under the animation's iteration cap, its planes
    quantized to planar uint8 on the device and summed into one uint8
    accumulator (no frame is fetched).  ``seconds`` and ``fps`` read the
    profiler's device lane (best of 2 sessions).  On a card also: K1's
    kernel record of each frame (sum, mean, p50, min, max, in ms), the
    frames whose record is under twice the run's least (the launch's fixed
    floor), and the lane's idle share, 1 - busy / window (the window runs
    from the first device event to the last), over the run and over the
    frames wholly inside the analytic interior skip and the rest (a
    frame's span runs from its K1 record's start to the next's).  The
    frames' loop work: useful iterations from K1's n plane (the kernel's
    own fields launch on a card), against the main path's frame."""
    from .models import common

    dev = resolve_device(device)
    scenes = animation_frames(frames)
    cap = max(s.max_iterations for s in scenes)
    cfg = dataclasses.replace(common.scene_static_cfg(
        scenes[0], width, height, "mandelbrot", "centered", False,
        device=str(dev)), max_iter=cap)
    dyns = [common.scene_dyn_params(s) for s in scenes]
    band = common.band_render_fn(cfg, height, height, planar_quantize=8)

    def run():
        acc = torch.zeros((3, height, width), dtype=torch.uint8, device=dev)
        for d in dyns:
            acc.add_(band(d, 0))
        int(acc[0, 0, 0])

    run()  # warm
    best = None
    for _ in range(2):
        with tempfile.TemporaryDirectory() as d:
            secs = measure_device_seconds(run, d, dev)
            events = (device_events_from_trace(d) if dev.type == "cuda"
                      else None)
        if best is None or secs < best[0]:
            best = (secs, events)
    secs, events = best
    row = {"config": f"zoom_animation_{frames}f_1080p", "frames": frames,
           "seconds": secs, "fps": frames / secs, "timing_method": TIMING,
           "iteration_cap": cap}

    main = animation_work([Scene()], width, height, dev)[0][0]
    useful, interior = animation_work(scenes, width, height, dev)
    row.update(useful_iters=_stats(useful), main_path_useful_iters=main,
               useful_over_main_path=float(np.mean(useful)) / main,
               frames_all_interior=int(sum(interior)))
    if events is None:
        row.update(k1_records_ms=None, idle_share=None, reason="cpu")
        return row
    row.update(animation_lane(events, interior))
    return row


def animation_lane(events, interior) -> dict:
    """Config 3's device lane from its trace's device ``events`` (as
    diag.device_events_from_trace gives them) and whether each frame lies
    wholly inside the interior skip: K1's record of each frame, in ms (its
    statistics, the least record as the launch's fixed floor, the frames
    under twice it), and the idle share, 1 - busy / window, over the run
    and over the all-interior frames and the rest (a frame's span runs from
    its K1 record's start to the next one's, the last to the lane's
    end)."""
    frames = len(interior)
    k1 = [(start, dur) for name, cat, start, dur in events
          if cat == "kernel" and "escape_kernel<" in name]
    if len(k1) != frames:
        raise RuntimeError(f"{len(k1)} K1 records for {frames} frames")
    ms = [dur * 1e3 for _, dur in k1]
    floor = min(ms)
    busy, window = busy_and_window(events)
    bounds = [start for start, _ in k1] + [max(e[2] + e[3] for e in events)]
    spans = {True: [0.0, 0.0], False: [0.0, 0.0]}  # busy, span
    for f in range(frames):
        lo, hi = bounds[f], bounds[f + 1]
        part = [e for e in events if lo <= e[2] < hi]
        spans[interior[f]][0] += busy_and_window(part)[0]
        spans[interior[f]][1] += hi - lo

    def idle(kind):
        b, span = spans[kind]
        return 1 - b / span if span else None

    return {"k1_records_ms": _stats(ms), "k1_floor_ms": floor,
            "frames_under_2x_floor": sum(m < 2 * floor for m in ms),
            "busy_s": busy, "window_s": window,
            "idle_share": 1 - busy / window, "window_fps": frames / window,
            "idle_share_all_interior": idle(True),
            "idle_share_other": idle(False),
            "device_events_per_frame": len(events) / frames}


def _wall(dev, fn):
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return time.perf_counter() - t0, out


def bench_deep_zoom(width: int = W, height: int = H, iters: int = 10000,
                    device="cuda") -> dict:
    """Config 4: the deep zoom at 1e-12 (K3's dd tier, in-kernel rebasing,
    device colouring) — wall seconds of a warm frame with and without the
    series skip and with stacked spp 2; the rebase rounds of each pixel
    (the port's rounds plane is per pixel: a GPU thread restarts its own
    lane); device seconds with the series off and on."""
    from .models import deep_zoom

    dev = resolve_device(device)
    s = Scene(fractal_type=FractalType.DEEP_ZOOM, **DZ4,
              max_iterations=iters, use_perturbation=True)
    s2 = s.with_(use_series_approximation=True)
    s_aa = s.with_(samples_per_pixel=2)

    def render(scene, **kw):
        return lambda: deep_zoom.render(scene, width, height, device=dev,
                                        **kw)

    cold, _ = _wall(dev, render(s))
    dt, (_, info) = _wall(dev, render(s, return_info=True))
    _wall(dev, render(s2))
    dt2, (_, info2) = _wall(dev, render(s2, return_info=True))
    _wall(dev, render(s_aa))
    dt_aa, _ = _wall(dev, render(s_aa))
    row = {"config": "deep_zoom_1e-12_10k_1080p", "seconds": dt,
           "cold_seconds_incl_compile": cold,
           "algorithm": info.get("algorithm"),
           "rebase_passes": info.get("rebase_passes"),
           "seconds_with_series_skip": dt2,
           "series_skip_iterations": info2.get("series_skip"),
           "seconds_spp2_stacked": dt_aa,
           "spp2_vs_spp1_ratio": dt_aa / max(dt, 1e-9),
           **{k: info[k] for k in ("references_used",
                                   "glitched_pixels_initial",
                                   "glitched_pixels_remaining")}}

    *_, dinfo = deep_zoom.render_fields(s, width, height, keep_device=True,
                                        debug_rounds=True, device=dev)
    rounds = dinfo["rounds_plane"].double().cpu().numpy().ravel()
    top = float(rounds.max())
    row["rounds_per_pixel"] = {
        "mean": float(rounds.mean()),
        "p50": float(np.percentile(rounds, 50)),
        "p95": float(np.percentile(rounds, 95)),
        "max": top, "pixels_over_half_max": int((rounds > top / 2).sum()),
        "pixels": int(rounds.size)}

    def timed(scene):
        def r():
            int(deep_zoom.render(scene, width, height, device=dev)[0, 0, 0])
        return device_seconds(r, dev)

    row.update(device_s_series_off=timed(s), device_s_series_on=timed(s2),
               timing_method=TIMING)
    return row


def bench_giant(width: int = 16384, height: int = 16384,
                band_rows: int = 1024, device="cuda",
                out_path: str = None) -> dict:
    """Config 5: the giant still of the default Mandelbrot view at 256
    iterations, 16-bit, through render_giant_still (no resume), written to
    ``out_path`` (default: a temporary directory, removed).

    The end-to-end seconds are dominated by the device-to-host link and the
    PNG deflate by design (the exporter exists to stream what cannot be
    held), so the device side is timed apart: one band's render (fused K1,
    f32) by the profiler's device lane at rows 0, H/4 and H/2 - band/2
    (bands differ a lot in iteration load), its mean and spread.  Then the
    link probe (on a card), the export's wall seconds and Mpix/s, the host
    seconds blocked on fetches, the workers' seconds deflating the final
    IDAT chunks and writing the tiles, the bytes over the link (the 16-bit
    image) and the PNG's size."""
    from .models import common
    from .parallel import render_giant_still

    dev = resolve_device(device)
    scene = Scene(max_iterations=256)
    cfg = common.scene_static_cfg(scene, width, height, "mandelbrot",
                                  "centered", False, device=str(dev))
    band_fn = common.band_render_fn(cfg, band_rows, height)
    dyn = common.scene_dyn_params(scene)
    float(band_fn(dyn, 0)[0, 0, 0])  # warm
    secs = [measure_device_seconds(
        lambda r=r: float(band_fn(dyn, r)[0, 0, 0]), device=dev)
        for r in (0, height // 4, height // 2 - band_rows // 2)]
    mean_s = sum(secs) / len(secs)
    bytes_moved = width * height * 3 * 2
    row = {"config": f"giant_{width}x{height}_16bit",
           "band_rows": band_rows, "bands": -(-height // band_rows),
           "device_band_seconds_mean": mean_s,
           "device_band_seconds_spread": secs,
           "device_render_mpix_s": width * band_rows / mean_s / 1e6,
           "timing_method": TIMING}
    link = bench_link(dev) if dev.type == "cuda" else None

    with tempfile.TemporaryDirectory() as td:
        out = out_path or os.path.join(td, "giant.png")
        t0 = time.perf_counter()
        info = render_giant_still(scene, width, height, out,
                                  band_rows=band_rows, bit_depth=16,
                                  resume=False, device=dev)
        dt = time.perf_counter() - t0
        size = os.path.getsize(out)
    row.update(seconds=dt, mpix_s_end_to_end=width * height / dt / 1e6,
               rows_per_second=height / dt,
               fetch_blocked_seconds=info["fetch_seconds"],
               deflate_seconds=info["deflate_seconds"],
               tile_seconds=info["tile_seconds"],
               bytes_over_link=bytes_moved, png_bytes=size)
    if link:
        row["link_probe_mb_s"] = link
        row["predicted_link_seconds"] = bytes_moved / (link["best_mb_s"]
                                                       * 1e6)
        row["predicted_pinned_link_seconds"] = bytes_moved / (
            link["pinned_best_mb_s"] * 1e6)
    return row


def bench_mandelbulb(width: int = W, height: int = H, iters: int = 256,
                     device="cuda") -> dict:
    """Config 6: the Mandelbulb's default scene (K4a + K4b + the shading
    glue), best of 3 by device seconds."""
    from .models import mandelbulb

    dev = resolve_device(device)
    s = Scene(fractal_type=FractalType.MANDELBULB, max_iterations=iters)

    def r():
        float(mandelbulb.render(s, width, height, device=dev)[0, 0, 0])

    r()  # warm
    best = device_seconds(r, dev, rounds=3)
    return {"config": "mandelbulb_1080p_kernel_shaded", "seconds": best,
            "mpix_s": width * height / best / 1e6, "timing_method": TIMING}


def bench_scaled_deep_zoom(width: int = 960, height: int = 540,
                           iters: int = 2000, device="cuda") -> dict:
    """Config 7: floatexp deltas at zoom 1e-50 (c = i), the fields fetched
    to the host."""
    from .models import deep_zoom

    dev = resolve_device(device)
    s = Scene(fractal_type=FractalType.DEEP_ZOOM, hp_center_x="0",
              hp_center_y="1", hp_zoom="1e-50", max_iterations=iters,
              use_perturbation=True)
    deep_zoom.render_fields(s, width, height, device=dev)  # warm
    dt, (*_, info) = _wall(dev, lambda: deep_zoom.render_fields(
        s, width, height, device=dev))
    return {"config": "scaled_deep_zoom_1e-50_2k_960x540", "seconds": dt,
            "precision_mode": info["precision_mode"],
            "rebase_passes": info.get("rebase_passes"),
            "glitched_pixels_remaining": info["glitched_pixels_remaining"]}


def _percentiles(lats) -> dict:
    """n, p50 and p95 (ms) of latencies in seconds, as the JAX row takes
    them (the sorted list's middle and its 95% index)."""
    arr = sorted(lats)
    return {"n": len(arr), "p50_ms": arr[len(arr) // 2] * 1e3,
            "p95_ms": arr[min(len(arr) - 1, int(len(arr) * 0.95))] * 1e3}


SIXEL_START, SIXEL_END = b"\x1bP0;1;0q", b"\x1b\\"
# config 8's bounds: the first frame (process start, the kernel library's
# load or build, the first render), each key's frame, and the quiet spell
# before each key: past the key's tap window (live._TAP_S) and any frame
# still in flight, so that the next key's frame is its own
FIRST_FRAME_S, KEY_FRAME_S, QUIET_S = 120.0, 60.0, 0.3


def pty_latency(dev: torch.device, scene_json, keys: int, iters: int,
                cols: int = 100, lines: int = 40) -> dict:
    """Keypress -> complete sixel frame on a pty, through the real
    ``cli interactive --live --fresh`` process on ``dev``: wait for the
    first frame, then ``keys`` times write one ``e`` and time until a
    whole sixel image (its DCS start to its string terminator) has arrived
    after it, the output drained for QUIET_S before each key.  Returns n,
    p50 and p95 ms, the first frame's seconds and the key frames' mean
    sixel bytes.  Raises when no frame lands."""
    import pty
    import select
    import signal

    # PYTHONFAULTHANDLER: a child that does not quit when asked gets
    # SIGABRT, and its stacks go to the stderr this function reports
    env = dict(os.environ, COLUMNS=str(cols), LINES=str(lines),
               FRACTAL_TPU_GFX="sixel", FRACTAL_TPU_SESSION_FILE=os.devnull,
               PYTHONFAULTHANDLER="1", PYTHONPATH=os.pathsep.join(
                   [REPO, *filter(None, [os.environ.get("PYTHONPATH")])]))
    with tempfile.TemporaryDirectory() as td:
        cmd = [sys.executable, "-m", "fractalrenderer_tpu_torch.cli",
               "interactive", "--live", "--fresh", "--iters", str(iters),
               "--device", str(dev)]
        if scene_json is not None:
            sp = os.path.join(td, "scene.json")
            with open(sp, "w") as f:
                json.dump(scene_json, f)
            cmd += ["--scene", sp]
        m, sl = pty.openpty()
        err_path = os.path.join(td, "err.txt")
        with open(err_path, "wb") as err:
            p = subprocess.Popen(cmd, stdin=sl, stdout=sl, stderr=err,
                                 env=env, cwd=td)
        os.close(sl)
        buf = b""
        sizes = []

        def read(timeout: float) -> bool:
            nonlocal buf
            r, _, _ = select.select([m], [], [], timeout)
            if r:
                try:
                    buf += os.read(m, 1 << 20)
                except OSError:
                    return False
            return True

        def wait_frame(timeout: float):
            """Seconds until a complete sixel image is in ``buf``, or
            None."""
            nonlocal buf
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < timeout:
                if not read(0.005):
                    return None
                i = buf.rfind(SIXEL_START)
                j = buf.find(SIXEL_END, i) if i >= 0 else -1
                if j >= 0:
                    sizes.append(j + len(SIXEL_END) - i)
                    buf = b""
                    return time.perf_counter() - t0
                if p.poll() is not None:
                    return None
            return None

        def drain(seconds: float) -> None:
            end = time.perf_counter() + seconds
            while time.perf_counter() < end and read(0.01):
                pass

        lats = []
        try:
            first = wait_frame(FIRST_FRAME_S)
            if first is not None:
                for _ in range(keys):
                    drain(QUIET_S)
                    buf = b""
                    os.write(m, b"e")
                    dt = wait_frame(KEY_FRAME_S)
                    if dt is not None:
                        lats.append(dt)
        finally:
            try:
                os.write(m, b"\x1b")
            except OSError:
                pass
            for _ in range(100):
                if p.poll() is not None:
                    break
                # drain so the child never blocks on a full pty
                read(0.1)
            if p.poll() is None:
                p.send_signal(signal.SIGABRT)
                drain(2.0)
            if p.poll() is None:
                p.kill()
            p.wait()
            os.close(m)
        if first is None or not lats:
            with open(err_path, "rb") as f:
                tail = f.read()[-3000:].decode("utf-8", "replace")
            raise RuntimeError(
                f"cli interactive on {dev}: "
                + ("no first frame" if first is None else "no key's frame")
                + f" on the pty (exit {p.returncode}); stderr: {tail}")
        return dict(_percentiles(lats), first_frame_s=first,
                    frame_bytes=float(np.mean(sizes[1:])))


def pty_throughput(text: str) -> float:
    """MB/s of ``text`` through a pty: written by the session's
    live.TermUI.write on the slave side, read whole on the master side."""
    import io
    import pty
    import select
    import threading

    from .live import TermUI

    data = text.encode()
    m, sl = pty.openpty()
    try:
        with open(sl, "w", closefd=False) as fout:
            ui = TermUI(infile=io.BytesIO(), outfile=fout)
            writer = threading.Thread(target=ui.write, args=(text,))
            t0 = time.perf_counter()
            writer.start()
            got = b""
            while len(got) < len(data):
                if not select.select([m], [], [], KEY_FRAME_S)[0]:
                    raise RuntimeError("the pty probe stalled")
                got += os.read(m, 1 << 20)
            dt = time.perf_counter() - t0
            writer.join(KEY_FRAME_S)
    finally:
        os.close(m)
        os.close(sl)
    if got != data:
        raise RuntimeError("the pty probe lost bytes")
    return len(data) / dt / 1e6


def bench_live_latency(cols: int = 100, lines: int = 40, iters: int = 256,
                       keys: int = 16, deep_iters: int = 10000,
                       deep_keys: int = 6, device="cuda") -> dict:
    """Config 8: the live session's latency (the counterpart of the root
    bench's ``bench_live_latency``).  The sixel and kitty-PNG encodes of a
    frame of the pty's pixel size (``cols`` x ``lines - 1`` cells at the
    default 8x16 cell: 800x624), best of 3; then ``pty_latency`` on the
    default Mandelbrot (``keys`` presses, starting at ``iters``) and on the
    deep zoom 1e-12 (``deep_keys`` presses at ``deep_iters``); with the
    pty's throughput for the sixel of that frame (``pty_throughput``), by
    which a frame's bytes cost their time on the pty."""
    from . import gfx as gfx_mod
    from .utils.png import encode_png

    dev = resolve_device(device)
    w_px, h_px = gfx_mod.pick_render_size(gfx_mod.GfxInfo("sixel", None),
                                          cols, lines, lines - 1)
    img8 = np.random.default_rng(0).integers(0, 256, (h_px, w_px, 3),
                                             dtype=np.uint8)
    enc = {}
    for key, fn in (("sixel_encode_ms", gfx_mod.sixel_frame),
                    ("kitty_png_encode_ms", encode_png)):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            fn(img8)
            best = min(best, time.perf_counter() - t0)
        enc[key] = best * 1e3
    enc["pty_mb_s"] = pty_throughput(gfx_mod.sixel_frame(img8))
    f32 = pty_latency(dev, None, keys, iters, cols, lines)
    deep = pty_latency(dev, dict(fractal_type="deep_zoom",
                                 use_perturbation=True, **DZ4,
                                 max_iterations=deep_iters),
                       deep_keys, deep_iters, cols, lines)
    return {"config": f"live_latency_{cols}x{lines}_sixel",
            "frame_px": [w_px, h_px], **enc, "f32_mandelbrot": f32,
            "deep_zoom_1e-12": deep,
            "sixel_native": gfx_mod._load_sixel_native() is not None}


def bench_link(device="cuda") -> dict:
    """The device-to-host link probe: 96 MiB, best and mean of 3, pageable
    and pinned (a fetched 1080p frame crosses this link)."""
    return measure_link_bandwidth(mb=96, reps=3, device=device)


CONFIGS = {0: bench_cold_start, 1: bench_mandelbrot_1080p,
           2: bench_julia_sweep, 3: bench_animation, 4: bench_deep_zoom,
           5: bench_giant, 6: bench_mandelbulb, 7: bench_scaled_deep_zoom,
           8: bench_live_latency}
# --quick: the root bench's quick sizes
QUICK = {3: dict(frames=60), 5: dict(width=4096, height=4096)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fractalrenderer_tpu_torch.bench_all",
        description="the port's benchmark configs, one JSON line each")
    ap.add_argument("--skip", default="",
                    help="comma list of config numbers")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (their plain "
                         "versions)")
    ap.add_argument("--out", default=None, help="also write the rows here")
    ap.add_argument("--quick", action="store_true",
                    help="config 3 at 60 frames, config 5 at 4096x4096")
    args = ap.parse_args(argv)
    skip = {int(x) for x in args.skip.split(",") if x}
    dev = resolve_device(args.device)
    who = card(dev)
    results = {"device": str(dev), "card": who}
    rows = [(f"config{num}", CONFIGS.get(num)) for num in range(9)
            if num not in skip]
    sizes = QUICK if args.quick else {}
    rows.append(("link_probe", bench_link))
    failed = []
    for key, fn in rows:
        num = int(key[6:]) if key.startswith("config") else None
        if fn is bench_link and dev.type != "cuda":
            row = {"skipped": "cpu: no device-to-host link"}
        else:
            t0 = time.perf_counter()
            try:
                row = fn(device=dev, **sizes.get(num, {}))
            except Exception as e:  # record, keep going
                traceback.print_exc()
                row = {"error": f"{type(e).__name__}: {e}"[:300]}
                failed.append(key)
            row.update(wall_incl_compile_s=time.perf_counter() - t0,
                       card=who)
        results[key] = row
        print(json.dumps({key: row}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
