"""Headline benchmark of the PyTorch + CUDA port: the counterpart of the
repository root's ``bench.py`` (BASELINE config #1, Mandelbrot 1920x1080,
default viewport, 256 iterations, smooth colour, quantized to uint8 on the
device: the main path's frame without the PNG write).

    python -m fractalrenderer_tpu_torch.bench [--device cuda|cpu]

Prints ONE JSON line with the JAX record's keys: ``metric``, ``value``
(Mpix/s), ``unit``, ``vs_baseline`` (value / 1000, the >= 1 Gpix/s/chip
target of BASELINE.md), ``iters_per_sec``, ``mean_iters_per_pixel``,
``timing_method``; the Mandelbulb at 100 iterations, the Julia c-sweep and
the 1e-12 deep zoom; and ``card`` (the card's name and power limit).

Timing: 64 frames on one stream (distinct zooms, each consumed by a uint8
accumulate) and the device seconds of a torch.profiler trace, best of 2
(bench_all.main_path_seconds).  A failure raises: there is no zero record.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import bench_all
from .scene import FractalType, Scene

W, H, ITERS = 1920, 1080, 256


def headline(width: int = W, height: int = H, iters: int = ITERS,
             frames: int = 64, bulb_iters: int = 100,
             dz_iters: int = 10000, device="cuda") -> dict:
    """The one-line record (sizes and iterations cut only by tests)."""
    from .models import deep_zoom, mandelbulb
    from .ops.escape import escape_fields

    dev = bench_all.resolve_device(device)
    scene = Scene(max_iterations=iters)
    per_frame = bench_all.main_path_seconds(scene, width, height, frames,
                                            dev)
    mpix_s = width * height / per_frame / 1e6
    # iterations/s (BASELINE.json's second metric): the escape loop's
    # iterations over this viewport times the pixel rate
    n = escape_fields("mandelbrot", width, height, center_x=scene.center_x,
                      center_y=scene.center_y, zoom=scene.zoom,
                      max_iter=iters, device=dev)["n"]
    mean_iters = float(n.double().mean())
    out = {"metric": "mandelbrot_1080p_256iter_render", "value": mpix_s,
           "unit": "Mpix/s/chip", "vs_baseline": mpix_s / 1000.0,
           "iters_per_sec": mpix_s * 1e6 * mean_iters,
           "mean_iters_per_pixel": mean_iters,
           "timing_method": bench_all.TIMING}

    # the bulb at 100 iterations (the whole render: K4a, K4b and the
    # shading glue; bench_all config 6 is the heavier default scene)
    bulb = Scene(fractal_type=FractalType.MANDELBULB,
                 max_iterations=bulb_iters)

    def brun():
        float(mandelbulb.render(bulb, width, height, device=dev)[0, 0, 0])

    brun()  # warm
    bulb_s = bench_all.device_seconds(brun, dev)
    out.update(mandelbulb_1080p_ms=bulb_s * 1e3,
               mandelbulb_mpix_s=width * height / bulb_s / 1e6)

    julia = bench_all.bench_julia_sweep(width, height, iters, device=dev)
    out.update(julia_sweep16_ms_per_batch=julia["ms_per_batch"],
               julia_sweep16_mpix_s=julia["mpix_s"],
               julia_timing_method=julia["timing_method"])

    sdz = Scene(fractal_type=FractalType.DEEP_ZOOM, **bench_all.DZ4,
                max_iterations=dz_iters, use_perturbation=True)
    cache = {}
    _, dzinfo = deep_zoom.render(sdz, width, height, return_info=True,
                                 orbit_cache=cache, device=dev)  # warm
    dzs = bench_all.device_seconds(
        lambda: deep_zoom.render(sdz, width, height, orbit_cache=cache,
                                 device=dev), dev)
    out.update(deepzoom_1e12_10k_1080p_s=dzs,
               deepzoom_rebase_passes=dzinfo.get("rebase_passes"),
               deepzoom_glitched_remaining=dzinfo.get(
                   "glitched_pixels_remaining"),
               deepzoom_timing_method=bench_all.TIMING,
               card=bench_all.card(dev))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fractalrenderer_tpu_torch.bench",
        description="the port's headline record, one JSON line")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)
    print(json.dumps(headline(device=args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
