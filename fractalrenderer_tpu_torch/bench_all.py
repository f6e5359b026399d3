"""Benchmark suite of the PyTorch + CUDA port: the counterpart of the
repository root's ``bench_all.py`` (the JAX package's), config for config.

    python -m fractalrenderer_tpu_torch.bench_all [--skip 0,4]
        [--device cuda|cpu] [--out PATH]

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
4. deep zoom 1e-12 / 10000 iterations at 1080p (spp 1 and 2, series skip,
   the per-pixel rebase-round histogram);
6. the Mandelbulb at 1080p;
7. deep zoom 1e-50 / 2000 iterations at 960x540.

Configs 3, 5 and 8 print ``not_ported`` with their ROADMAP item.  Device
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
from .utils.diag import (measure_device_seconds, measure_link_bandwidth,
                         measure_vpu_peak)

W, H = 1920, 1080
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOT_PORTED = {3: 3, 5: 8, 8: 9}  # config -> ROADMAP Queue 1 item
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


def bench_link(device="cuda") -> dict:
    """The device-to-host link probe: 96 MiB, best and mean of 3, pageable
    and pinned (a fetched 1080p frame crosses this link)."""
    return measure_link_bandwidth(mb=96, reps=3, device=device)


CONFIGS = {0: bench_cold_start, 1: bench_mandelbrot_1080p,
           2: bench_julia_sweep, 4: bench_deep_zoom, 6: bench_mandelbulb,
           7: bench_scaled_deep_zoom}


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
    args = ap.parse_args(argv)
    skip = {int(x) for x in args.skip.split(",") if x}
    dev = resolve_device(args.device)
    who = card(dev)
    results = {"device": str(dev), "card": who}
    rows = [(f"config{num}", CONFIGS.get(num)) for num in range(9)
            if num not in skip]
    rows.append(("link_probe", bench_link))
    failed = []
    for key, fn in rows:
        num = int(key[6:]) if key.startswith("config") else None
        if num in NOT_PORTED:
            row = {"not_ported": f"ROADMAP Queue 1 item {NOT_PORTED[num]}"}
        elif fn is bench_link and dev.type != "cuda":
            row = {"skipped": "cpu: no device-to-host link"}
        else:
            t0 = time.perf_counter()
            try:
                row = fn(device=dev)
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
