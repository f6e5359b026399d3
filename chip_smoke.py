#!/usr/bin/env python3
"""One-GPU smoke run of the PyTorch + CUDA port (fractalrenderer_tpu_torch).

Run from the repository root on a machine with an NVIDIA GPU and the CUDA
toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (K1, the escape kernel of the
four 2D families; K2, the double-double Mandelbrot kernel; K3, the
perturbation deep-zoom kernel of the Mandelbrot, Julia, Burning Ship and
Phoenix families in their f32, dd and floatexp tiers, with stacked spp²
supersampling, the Burning Ship's exact-dust error ledger and the
Mandelbrot single pass of the legacy pipeline; K4a and K4b, the
Mandelbulb's cone prepass and march + shading kernels; K5, the FP32 peak
probe, and K6, the fresh-compile probe, built apart with a random salt),
holds every kernel instance against its plain PyTorch version on the card
(K5 at the JAX probe's 2048x1024 x 8 chains x 2000 steps, bit-equal; K6
twice, two salts; K1 and K2 at
1920x1080; K3 and K4b on the whole frame against a 64-row band of it run
on the plain version, which is launch-bound; K3's stacked spp-2 launch
segment by segment against sequential launches and on a band of every
segment against the stacked plain version, with and without the ledger;
K4a on the whole 1080p coarse grid; the bulb's other integer powers at
64x48), drives each ported path through ``cli render`` (the default
Mandelbrot frame, Julia, Burning Ship with traps and stripes, Phoenix, AA
2, ``--precision dd``, ``--type deep-zoom`` at configs 4 and 7, with
``--deep-julia``, ``--deep-ship`` (and ``--exact-dust``), ``--deep-phoenix``
and ``--spp 2``, and ``--type mandelbulb`` at config 6, with AA 2, ``--time
1.0`` and ``--power 16``) and the distance field and the deep-zoom fields
of every K3 instance through their library calls (the exact-dust tier on a
band of each Ship view, with its HP fallback, and on the JAX tests' 12x8
windows against the HP oracle; the legacy ``rebasing=False`` pipeline with
its secondary references on Seahorse and configs 4 and 7), and
``export-print --supersample --downsample`` at 1920x1080, ``render
--golden`` at 160x90 and a 4-frame ``zoom-path`` at 480x270,
checks that each path launched its kernels and that each PNG is within 1
LSB of the same pipeline run on the plain versions; then the batch path
(the animation phase): ``cli sweep`` of 16 c values at 1920x1080 (16 K1
launches, each entry of render_c_sweep equal to models.render of its c,
one entry's K1 fields bit-equal to the plain version), ``cli animate`` of
a 12-frame zoom at 1920x1080 in chunks of 8 (12 launches, every PNG equal
to models.render of its interpolated scene) with ``--encode --codec
qtpng`` (12 samples) and ``--resume`` (no launch), the fetch of one chunk,
a mixed .franim at 320x180 through the per-frame branch (Mandelbrot, bulb
and deep-zoom frames: their K1, K4a/K4b and K3 launches, one reference
orbit, each frame within 1 LSB of its scene rendered alone) and
bench_all's config 3 (300 frames: fps, K1's record of each frame, the
device lane's idle share); then the bands phase (parallel/, over grids
that repeat the one card): the main-path frame through render_sharded
over 4 and 7 bands and ``cli render --sharded``, the bulb and config 4's
deep zoom over 4 bands (one reference orbit), ``cli animate --sharded``
(12 frames at 1080p, the PNGs of ``cli animate``), bench_all's config 5
(the 16384x16384 16-bit giant still in 1024-row bands, read back with
utils/png.read_png and held row for row against the whole render on the
card), a resume at 4096x4096 (3 tiles deleted, then one corrupted), the
banded ``export-print --supersample --downsample`` at 8192x8192 (equal to
downsample2x of the monolithic 2x render) and deep-zoom and bulb giants at
1080p in 256-row bands, each bit-equal to its whole frame; then the live
phase (live.py's LiveSession in this process, a forced-sixel pixel session
at the reference's 1700x900 window, driven by a scripted event stream: a
held ``e`` through the iteration ladder's rungs 256-2048, the ``z``
Seahorse preset and ``+``, Tab to the bulb and ``o`` with a tick; each
frame popped by its CUDA event, fetched and composed to sixel; its
launches per frame and each frame bit-equal to the plain versions, the
deep and bulb frames on their middle 64 rows; each rung's first render
against a warm one at scales 1 and 2).  It times kernel
against plain version (K1 and K2, K3, K4a and K4b by the profiler's
kernel records; the CUDA-event time of queued wrapper calls (K1, K2) or
of one wrapper call (K3, K4) printed beside them as "call ms"; K4a also by
the records
of its heaviest and lightest coarse lanes launched alone, its schedule
floor and its fixed floor, each lane's t0 bit-equal to the full
launch's), and prints each phase's seconds.  For each instance it prints the
DE or escape iterations the timed frame needs and the bound: the larger of
their f32 operations over the card's FP32 peak (the data sheet's 67
TFLOP/s, or the rate K5 measured in this run where that is higher; the
measured rate is printed beside it) and the frame's bytes over 3.35 TB/s.
K1's eight 1080p frames and K2's Seahorse frame fill their per-warp
counters in one more launch each (escape.trips_buffer and
dd_escape.trips_buffer: loop trips, lane iterations, pixels looped, each
warp's SM, its loop and epilogue cycles and its span), whose lane
iterations must equal the frame's loop updates from its n plane (n, or
limit - 1 where n is the limit, over the pixels the skip leaves in the
loop); the timing phase prints them decoded.
K4b's 1080p frames also fill its per-warp counters (the trips buffer:
trips, step and event trips, lane steps, pixels, each warp's SM and
span), whose lane steps must equal the frame's sum of work; the phase
prints them with the launch's grid and resident blocks per SM, and the
timing phase the issue slots the card had per warp trip at the SM clock
nvidia-smi reads under load.
Before those phases: the diagnostics (the parameter-layout selfcheck
against the CUDA sources; the profiler's device lane of the frames the
bench times, each against the CUDA-event times of its kernels' launches
in the same run; the link probe), the bench path (bench_all's configs 0,
1, 2, 4, 6, 7 and 8, which launch K6 and K5 -- config 1 measures the FP32
rate once, with measure_vpu_peak, and it must exceed half the data sheet's
67 TFLOP/s; config 8 runs ``cli interactive --live`` twice on a pty for
the keypress-to-frame latency -- with their launch counts reset before and
read after, and
``python -m fractalrenderer_tpu_torch.bench``), and ``cli info`` and ``cli
presets``.
Each phase prints one line; any failure raises, so the exit code is
non-zero and no result line is printed.  On success the last three lines
are the card's name and power limit, a JSON line describing each kernel
instance, and ``{"ok": true, "device": {...}}``.  Imports no JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
W, H, ITERS = 1920, 1080, 256
SEAHORSE = dict(center_x=-0.743643887037151, center_y=0.13182590420533,
                zoom=0.008, max_iter=1024)
DD_VIEW = dict(cx="-0.743643887037151", cy="0.13182590420533", zoom="1e-9",
               iters=1500)
COLOR_ATOL = 1e-5  # the colour contract of the reference's own tests
ESCAPE_SRC = "fractalrenderer_tpu_torch/csrc/escape.cu"
DD_SRC = "fractalrenderer_tpu_torch/csrc/dd_escape.cu"
PERT_SRC = "fractalrenderer_tpu_torch/csrc/perturbation.cu"
# each K3 family's translation unit (the kernel body: csrc/pert_kernel.cuh)
PERT_SOURCES = {"mandelbrot": PERT_SRC,
                "julia": "fractalrenderer_tpu_torch/csrc/pert_julia.cu",
                "ship": "fractalrenderer_tpu_torch/csrc/pert_ship.cu",
                "phoenix": "fractalrenderer_tpu_torch/csrc/pert_phoenix.cu"}
BULB_SRC = "fractalrenderer_tpu_torch/csrc/bulb.cu"
PEAK_SRC = "fractalrenderer_tpu_torch/csrc/peak.cu"
PROBE_SRC = "fractalrenderer_tpu_torch/csrc/probe/compile_probe.cu"
K1_TPU = "fractalrenderer_tpu/ops/escape.py:155"
K2_TPU = "fractalrenderer_tpu/ops/dd_escape.py:35"
K3_TPU = "fractalrenderer_tpu/ops/perturbation.py:245"
K4A_TPU = "fractalrenderer_tpu/ops/bulb_kernel.py:210"
K4B_TPU = "fractalrenderer_tpu/ops/bulb_kernel.py:637"
K5_TPU = "fractalrenderer_tpu/utils/diag.py:199"
K6_TPU = "bench_all.py:144"

# The bound of an instance: the
# larger of its f32 operations over the card's FP32 peak (each counted
# operation against the FMA rate; the kernels build with -fmad=false, so
# they issue at most half of it) and the bytes it must move (inputs read
# once, outputs written once) over 3.35 TB/s.  The peak is the H100's
# data-sheet 67 TFLOP/s, or K5's measured rate where that is higher: a
# bound never takes a rate below what the card can issue.
# Operations per iteration of each inner loop, counted from the sources:
# every f32 add, subtract, multiply, divide, square root, compare result
# used as a value (min/max/abs), and math-library call counts one, a fused
# multiply-add two.  A dd product's error term is one exact fmaf
# (csrc/dd.cuh two_prod): dd_mul counts 10, dd_mul_float 8.  A bound is the
# least work on this card, and the TPU's Dekker splits (dd_mul 24,
# dd_mul_float 22, the counts before the fmaf) are not that.
SPEC_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
PEAK_K, PEAK_CHAINS = 2000, 8  # K5 at the JAX probe's defaults
OPS_PER_ITER = {
    # csrc/escape.cu loop body: |z|^2, the update, the squares; the fields
    # instances add what they track (Mandelbrot: trap 14 + dz 9; Burning
    # Ship: trap 4 + stripe 3; the Julia and Phoenix traps are constant)
    "escape_mandelbrot_fused": 8, "escape_mandelbrot_fields": 31,
    "escape_julia_fused": 8, "escape_julia_fields": 8,
    "escape_burning_ship_fused": 9, "escape_burning_ship_fields": 16,
    "escape_phoenix_fused": 16, "escape_phoenix_fields": 16,
    # csrc/dd_escape.cu dd_step: the two squares of 7 (dd_mul's 10 less
    # the head product and the two cross products, which |z|^2 computed;
    # their sum is one add of a product to itself), dd_mul 10, 3 dd_add of
    # 11, the exact doubling 2, |z|^2 8
    "dd_escape_mandelbrot": 67,
    # csrc/pert_kernel.cuh, one delta step, with dd_mul 10, dd_add 11,
    # dd_mul_float 8 (csrc/dd.cuh) and the floatexp ops of csrc/floatexp.cuh
    # (rfe_add 18, rfe_mul 13, cfe_mul 70, cfe_add 38, a renormalisation
    # 3-8): Mandelbrot f32; dd (7 dd_mul, 6 dd_add, the rebase test);
    # floatexp (the dd step + alignment)
    "pert_mandelbrot_f32": 29, "pert_mandelbrot_dd": 169,
    "pert_mandelbrot_fx": 193,
    # Julia: Z = Z0 + D (f32 2, dd 2 dd_add), no dc; floatexp: two cfe_mul,
    # a cfe_add and the rfe composition of Z and of rel = D + d
    "pert_julia_f32": 31, "pert_julia_dd": 173, "pert_julia_fx": 307,
    # Burning Ship: two diffabs and the dx'/dy' products (dd: 5 dd_mul, 7
    # dd_add; floatexp: 6 rfe_mul, 9 rfe_add, the sign tests' 4 rfe_add)
    "pert_ship_f32": 37, "pert_ship_dd": 194, "pert_ship_fx": 314,
    # Phoenix: the Mandelbrot step + p d + r d_prev (dd: 4 dd_mul_float and
    # 4 dd_add more)
    "pert_phoenix_f32": 39, "pert_phoenix_dd": 245, "pert_phoenix_fx": 281,
    # the Burning Ship's error ledger: two log2f, the |2z| and |d'|
    # squares, the floor and the max (dd 18 more, floatexp 16 more)
    "pert_ship_dd_err": 212, "pert_ship_fx_err": 330,
    # the single pass: the Mandelbrot step without the rebase test (f32
    # and dd 4 fewer, floatexp 6 fewer) and with the Pauldelbrot test
    # (|z|^2, |Z|^2, the product and the compare: 8)
    "pert_mandelbrot_f32_single": 33, "pert_mandelbrot_dd_single": 173,
    "pert_mandelbrot_fx_single": 195,
}
# one step of the single pass's f32 float continuation: z^2 + c and |z|^2
OPS_CONT = 10
# per pixel outside the loop: the mapping (K2 and K3: two dd_mul_float),
# and the fused colour + post chain
OPS_PER_PIXEL = {"fused": 90, "fields": 12, "dd": 32, "pert": 52}
# csrc/bulb.cu: one DE step (de_step_int<p>: 10 + 2 square-and-multiply
# chains + r^(p-1) + 14; the trig step 79), one march evaluation's update
# (de_finish, threshold, relaxation, the next position: 30) and a hit
# lane's esc recovery + 11 shading-tap events (12 x 20)
OPS_BULB_EVAL, OPS_BULB_HIT = 30, 240


def bulb_ops_per_iter(p) -> int:
    """Operations of one DE step of the bulb's instance ``p`` (0 = trig)."""
    if not p:
        return 79

    def rpow(k):
        return 0 if k <= 2 else rpow(k // 2) + 1 + (k & 1)

    chains = 5 * (p.bit_length() - 1) + 6 * (bin(p).count("1") - 1)
    return 10 + 2 * chains + rpow(p - 1) + 14


# Mandelbulb views: config 6 of BASELINE.md (the default bulb, power 8,
# 256 iterations, kernel-shaded) and the two other DE-step instances the
# slice runs: a non-integer dynamic power (time 1.0: power 8.32, the trig
# step) and power 16 (the "Extreme (16)" preset's, dr frozen at inf).
BULB_CASES = [
    ("p8", "config 6 (power 8, time 0)", {}),
    ("trig", "time 1.0 (dynamic power 8.32, trig step)", dict(time=1.0)),
    ("p16", "power 16", dict(power=16.0)),
]
BULB_BAND = (508, 64)  # rows 508-571 of 1080: through the bulb's middle
CONE = 8

# Deep-zoom views (decimal strings, as the CLI's --hp-* flags take them):
# one per K3 family and delta tier.  Config 4 and config 7 are the
# benchmark configs of BASELINE.md (1e-12 x 10000 at 1080p; 1e-50 at
# 960x540); the family views are the JAX package's tests' and gallery's
# (examples/render_gallery.py): the Julia set of c = -0.7+0.27015i at its
# repelling fixed point, the Burning Ship's armada dust and antenna tip,
# and a Phoenix escape-set boundary point (p = 0, r = -0.5 or -0.51).
JC = ("-0.7", "0.27015")
JZSTAR = (
    "1.484292748140190509759902440314769152069911011656749053313607708428926366189",
    "-0.137230514250178732651450854196740117783619435441039716507673181503075677979")
PHOENIX = "0.5334632772339566"
# the boundary at r = -0.51 bisected to 1e-54 (tests/test_deepzoom.py
# test_deep_phoenix_floatexp_nondyadic_r_matches_exact_oracle)
PHOENIX_R051 = ("0.5363685622288939118213416621494880258143653450622962128"
                "740227946683769")
DZ_VIEWS = {
    "seahorse": dict(cx="-0.743643887037151", cy="0.13182590420533",
                     zoom="1e-6", iters=2000),
    "config4": dict(cx="-0.74364388703715158", cy="0.13182590420531198",
                    zoom="1e-12", iters=10000),
    "config7": dict(cx="0", cy="1", zoom="1e-50", iters=2000),
    "julia_f32": dict(cx=JZSTAR[0], cy=JZSTAR[1], zoom="1e-6", iters=1000,
                      family="julia"),
    "julia_dd": dict(cx=JZSTAR[0], cy=JZSTAR[1], zoom="1e-12", iters=2000,
                     family="julia"),
    "julia_fx": dict(cx=JZSTAR[0], cy=JZSTAR[1], zoom="1e-50", iters=1000,
                     family="julia"),
    "julia_spp2": dict(cx=JZSTAR[0], cy=JZSTAR[1], zoom="1e-10", iters=200,
                       family="julia"),
    # the model takes the dd tier for every ship view (the armada dust
    # flips f32 counts); this instance runs through perturbation_fields
    "ship_f32": dict(cx="-1.7623025", cy="-0.028000625", zoom="1e-5",
                     iters=1500, family="ship", dd=False),
    "ship_dd": dict(cx="-1.7623025", cy="-0.028000625", zoom="1e-10",
                    iters=1500, family="ship"),
    "ship_fx": dict(cx="-2", cy="0", zoom="1e-40", iters=600, family="ship"),
    "phoenix_f32": dict(cx=PHOENIX, cy="0.05", zoom="1e-6", iters=400,
                        family="phoenix", r=-0.5),
    "phoenix_dd": dict(cx=PHOENIX, cy="0.05", zoom="1e-10", iters=400,
                       family="phoenix", r=-0.5),
    "phoenix_fx": dict(cx=PHOENIX_R051, cy="0.05", zoom="1e-50", iters=400,
                       family="phoenix", r=-0.51),
    # the CLI paths' views, shallower so the plain pipeline stays cheap
    "julia_cli": dict(cx=JZSTAR[0], cy=JZSTAR[1], zoom="1e-12", iters=500,
                      family="julia"),
    "ship_cli": dict(cx="-1.7623025", cy="-0.028000625", zoom="1e-10",
                     iters=400, family="ship"),
    "phoenix_cli": dict(cx=PHOENIX, cy="0.05", zoom="1e-10", iters=400,
                        family="phoenix", r=-0.5),
}
# (instance, label, view, width, height, series skip)
PERT_CASES = [
    ("pert_mandelbrot_f32", "Seahorse 1e-6 x2000", "seahorse", 1920, 1080,
     False),
    ("pert_mandelbrot_dd", "config 4 (1e-12 x10000), series off", "config4",
     1920, 1080, False),
    ("pert_mandelbrot_dd", "config 4, series on", "config4", 1920, 1080,
     True),
    ("pert_mandelbrot_fx", "config 7 (c = i, 1e-50 x2000)", "config7", 960,
     540, False),
    ("pert_mandelbrot_fx", "c = i, 1e-50 x2000", "config7", 1920, 1080,
     False),
    ("pert_julia_f32", "Julia at z*, 1e-6 x1000", "julia_f32", 1920, 1080,
     False),
    ("pert_julia_dd", "deep_julia_1e12 (z*, 1e-12 x2000)", "julia_dd", 1920,
     1080, False),
    ("pert_julia_fx", "Julia at z*, 1e-50 x1000, floatexp drift",
     "julia_fx", 1920, 1080, False),
    ("pert_ship_f32", "armada 1e-5 x1500", "ship_f32", 1920, 1080, False),
    ("pert_ship_dd", "deep_ship_1e10 (armada, 1e-10 x1500)", "ship_dd",
     1920, 1080, False),
    ("pert_ship_fx", "antenna tip -2, 1e-40 x600", "ship_fx", 1920, 1080,
     False),
    ("pert_phoenix_f32", "Phoenix r -0.5, 1e-6 x400", "phoenix_f32", 1920,
     1080, False),
    ("pert_phoenix_dd", "Phoenix r -0.5, 1e-10 x400", "phoenix_dd", 1920,
     1080, False),
    ("pert_phoenix_fx", "Phoenix boundary, r -0.51, 1e-50 x400",
     "phoenix_fx", 1920, 1080, False),
]
# The Burning Ship's exact-dust ledger instances and the legacy pipeline's
# single-pass instances (Mandelbrot): (instance, label, view, width,
# height, packing options)
FORM_CASES = [
    ("pert_ship_dd_err", "deep_ship_1e10 (armada, 1e-10 x1500), ledger",
     "ship_dd", 1920, 1080, dict(track_err=True)),
    ("pert_ship_fx_err", "antenna tip -2, 1e-40 x600, ledger", "ship_fx",
     1920, 1080, dict(track_err=True)),
    ("pert_mandelbrot_f32_single", "Seahorse 1e-6 x2000, single pass, "
     "float continuation", "seahorse", 1920, 1080,
     dict(rebase=False, float_continuation=True)),
    ("pert_mandelbrot_f32_single", "Seahorse 1e-6 x2000, single pass, no "
     "continuation", "seahorse", 1920, 1080, dict(rebase=False)),
    ("pert_mandelbrot_dd_single", "config 4 (1e-12 x10000), single pass, "
     "starving reference", "config4", 1920, 1080, dict(rebase=False)),
    ("pert_mandelbrot_fx_single", "config 7 (c = i, 1e-50 x2000), single "
     "pass", "config7", 960, 540, dict(rebase=False)),
]
# Row bands of the frame whose exact-dust suspects and legacy-pipeline
# survivors go through the host HP fallback, sized from a CPU sample of
# their share at 192x108 (armada at 1500 iterations: 12.9% suspect, 0.12
# ms per fallback pixel; antenna: 0.46%; Seahorse: no survivor after 3
# references)
DUST_ROWS = {"ship_dd": 512, "ship_fx": 1080}
LEGACY_ROWS = {"seahorse": 1080, "config4": 1080, "config7": 540}
PERT_FAMILIES = ("mandelbrot", "julia", "ship", "phoenix")
STACKED = "pert_mandelbrot_dd_spp2"  # config 4's stacked spp-2 launch
STACK_ROWS = 16  # rows of each segment the stacked plain version runs
BAND_ROWS = 64  # rows of the frame's middle the plain version runs
PERT_TIERS = ("f32", "dd", "fx")

# The families' views at full width (the JAX package's defaults for the
# view each family is shown at) and the outputs their fields mode tracks.
FAMILIES = {
    "mandelbrot": dict(view=dict(center_x=-0.5, center_y=0.0, zoom=3.0),
                       track=dict(track_trap=True, track_deriv=True)),
    "julia": dict(view=dict(center_x=0.0, center_y=0.0, zoom=3.0,
                            julia_c=(-0.7, 0.27015)),
                  track=dict(track_trap=True, track_stripe=True)),
    "burning_ship": dict(view=dict(center_x=-0.5, center_y=-0.6, zoom=2.0,
                                   trap_radius=0.5, stripe_density=10.0),
                         track=dict(track_trap=True, track_stripe=True)),
    "phoenix": dict(view=dict(center_x=0.0, center_y=0.0, zoom=3.0,
                              julia_c=(0.5667, 0.0), phoenix_p=0.0,
                              phoenix_r=-0.5, stripe_density=10.0),
                    track=dict(track_trap=True, track_stripe=True)),
}


# the bands phase's sizes: bench config 5's giant (side, band rows), the
# resumed giant's, the banded export-print's output side (rendered at 2x
# in export-print's default 512-row bands) and the 1080p giants' band rows
GIANT = (16384, 1024)
RESUME = (4096, 512)
PRINT_SIDE = 8192
GIANT_1080_BAND = 256

# cli animate's 12-frame 1080p zoom (the animation phase's)
ANIMATE = ["animate", "--width", str(W), "--height", str(H), "--center",
           "-0.7453", "0.1127", "--zoom", "0.05", "--zoom-to", "0.002",
           "--iters", "600", "--duration", "0.4", "--fps", "30",
           "--batch-size", "8"]


def bands_phase(dev, kernels, verb, reset_counts, counts,
                orbit_log) -> None:
    """Row bands and giant stills on the card (parallel/), over grids that
    repeat ``dev`` (the machine has one card): the main-path frame through
    render_sharded over 4 and 7 bands and ``cli render --sharded``; the
    bulb and config 4's deep zoom over 4 bands; ``cli animate --sharded``;
    bench config 5 (the 16384^2 16-bit giant, held row for row against the
    whole render); a resume at 4096^2; the banded ``export-print
    --supersample --downsample`` at 8192^2; and deep-zoom and bulb giants
    at 1080p.  Every result is bit-equal to its whole frame.  ``verb``,
    ``reset_counts`` and ``counts`` are main()'s; ``orbit_log`` grows by
    each reference orbit."""
    import numpy as np
    import torch

    from fractalrenderer_tpu_torch import (FractalType, Scene, bench_all,
                                           cli, models)
    from fractalrenderer_tpu_torch.models import common, deep_zoom, mandelbulb
    from fractalrenderer_tpu_torch.parallel import (make_render_mesh,
                                                    render_giant_still,
                                                    render_sharded)
    from fractalrenderer_tpu_torch.parallel.mesh import row_bands
    from fractalrenderer_tpu_torch.utils import png
    from fractalrenderer_tpu_torch.utils.image import (downsample2x,
                                                       to_export_orientation)

    esc_w, pert_w = "escape_fields_cuda", "perturbation_fields_cuda"
    cone_w, march_w = "cone_fields_cuda", "march_fields_cuda"

    def add(launches, **want):
        """Hold a path's launches to ``want`` (wrapper -> (instance, n))
        and add them to the instances' counts."""
        got = {w_: n for w_, n in launches.items() if n}
        assert got == {w_: n for w_, (_, n) in want.items()}, (got, want)
        for w_, (inst, n) in want.items():
            kernels[inst]["launches"] += n

    def export16(img):
        """The 16-bit PNG pixels of a device image (f32 or uint16)."""
        if img.dtype == torch.float32:
            img = common.quantize_image(img, bit_depth=16)
        return to_export_orientation(img).cpu().numpy()

    def bands(height, rows):
        return -(-height // rows)

    main = Scene()
    whole8 = models.render(main, W, H, device=dev, quantize=8).cpu()
    whole32 = models.render(main, W, H, device=dev).cpu()
    for n, q, whole in ((4, 8, whole8), (7, 0, whole32)):
        reset_counts()
        out = render_sharded(main, W, H, quantize=q,
                             mesh=make_render_mesh(devices=[dev] * n))
        add(counts(), escape_fields_cuda=("escape_mandelbrot_fused", n))
        assert torch.equal(out, whole), f"render_sharded over {n} bands"
    with tempfile.TemporaryDirectory() as tmp:
        a, b = os.path.join(tmp, "a.png"), os.path.join(tmp, "b.png")
        rc, _, _, launches = verb(["render", "--sharded", "--out", a])
        assert rc == 0
        add(launches, escape_fields_cuda=("escape_mandelbrot_fused", 1))
        assert verb(["render", "--out", b])[0] == 0
        assert np.array_equal(read_png_rgb(a), read_png_rgb(b)), \
            "cli render --sharded != cli render"
    split = {n: row_bands(H, n) for n in (4, 7)}
    print(f"path parallel.render_sharded {W}x{H} over cuda:0 x4 (uint8, "
          f"bands of {split[4][0][1]} rows) and x7 (f32, {split[7][0][1]} "
          f"rows, the last {split[7][-1][1]}): 4 and 7 launches of "
          f"escape_mandelbrot_fused, each bit-equal to "
          f"models.render; cli render --sharded (one band per visible "
          f"card: 1 launch) gives cli render's pixels", flush=True)

    mesh4 = make_render_mesh(devices=[dev] * 4)
    bulb = Scene(fractal_type=FractalType.MANDELBULB)
    whole = mandelbulb.render(bulb, W, H, device=dev)
    reset_counts()
    out = mandelbulb.render_sharded(bulb, W, H, mesh=mesh4)
    add(counts(), cone_fields_cuda=("bulb_cone_p8", 4),
        march_fields_cuda=("bulb_march_p8", 4))
    assert torch.equal(out, whole.cpu()), "bulb render_sharded != render"
    dz = dz_scene("config4")
    whole, info1 = deep_zoom.render(dz, W, H, device=dev, quantize=16,
                                    return_info=True)
    reset_counts()
    n_orb = len(orbit_log)
    t0 = time.perf_counter()
    out, info = deep_zoom.render(dz, W, H, device=dev, quantize=16,
                                 mesh=mesh4, return_info=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    add(counts(), perturbation_fields_cuda=("pert_mandelbrot_dd", 4))
    assert len(orbit_log) == n_orb + 1, "config 4 bands: not one orbit"
    assert info["fields_on_device"] and info["fallback_pixels"] == 0, info
    assert info["rebase_passes"] == info1["rebase_passes"], (info, info1)
    assert torch.equal(out, whole), "config 4 over 4 bands != whole frame"
    print(f"path mandelbulb.render_sharded {W}x{H} power 8 over cuda:0 x4: "
          f"4 launches each of bulb_cone_p8 and bulb_march_p8, bit-equal to "
          f"mandelbulb.render; deep_zoom.render(mesh=) config 4 over x4: 4 "
          f"launches of pert_mandelbrot_dd, one reference orbit, rebase "
          f"passes {info['rebase_passes']} (the whole frame's), uint16 "
          f"bit-equal to the whole frame, fields kept on the card; "
          f"{wall:.2f} s wall", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        one, sh = os.path.join(tmp, "one"), os.path.join(tmp, "sh")
        rc, _, _, launches = verb([*ANIMATE, "--out-dir", one])
        assert rc == 0
        add(launches, escape_fields_cuda=("escape_mandelbrot_fused", 12))
        rc, _, wall, launches = verb([*ANIMATE, "--sharded", "--out-dir",
                                      sh])
        assert rc == 0
        # the last chunk of 4 is padded to the batch of 8, as in JAX
        add(launches, escape_fields_cuda=("escape_mandelbrot_fused", 16))
        files = sorted(os.listdir(one))
        assert files == sorted(os.listdir(sh)) and len(files) == 12, files
        for f in files:
            assert np.array_equal(read_png_rgb(os.path.join(one, f)),
                                  read_png_rgb(os.path.join(sh, f))), f
    print(f"path cli animate --sharded 12 frames at {W}x{H} (one frame "
          f"group per visible card, chunks of 8, the last padded): 16 "
          f"launches of escape_mandelbrot_fused, every PNG equal to cli "
          f"animate's; {wall:.2f} s wall", flush=True)

    # bench config 5: the 16384^2 16-bit giant, 1024-row bands
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "giant.png")
        reset_counts()
        t0 = time.monotonic()
        side, band = GIANT
        row = bench_all.bench_giant(side, side, band, device=dev,
                                    out_path=out)
        k1 = counts()[esc_w]
        assert k1 >= bands(side, band) + 4, k1
        kernels["escape_mandelbrot_fused"]["launches"] += k1
        print(f"bench_all config5 ({time.monotonic() - t0:.1f} s, {k1} K1 "
              f"launches: {bands(side, band)} bands, the warm-up and the "
              f"timed bands): " + json.dumps(row), flush=True)
        t0 = time.perf_counter()
        got = png.read_png(out)
        read_s = time.perf_counter() - t0
        engine = ("native (native/pngfilter.cpp)"
                  if png._load_pngfilter() is not None else "NumPy")
        ref = export16(models.render(Scene(max_iterations=256), side, side,
                                     device=dev, quantize=16))
        assert got.shape == ref.shape == (side, side, 3), got.shape
        bad = np.nonzero((got != ref).any(axis=(1, 2)))[0]
        assert bad.size == 0, f"config 5: rows {bad[:8]} differ from the " \
            "whole render"
        assert 0 < got.mean() < 65535
        del got, ref
    spread = row["device_band_seconds_spread"]
    print(f"config 5 giant {side}x{side} 16-bit: {row['seconds']:.3f} s end "
          f"to end, {row['mpix_s_end_to_end']:.2f} Mpix/s, "
          f"{row['rows_per_second']:.1f} rows/s; K1 per {band}-row band "
          f"(device lane) mean {row['device_band_seconds_mean'] * 1e3:.4f} "
          f"ms, at rows 0, H/4, H/2-{band // 2}: "
          f"{[round(t * 1e3, 4) for t in spread]} ms; fetch-blocked "
          f"{row['fetch_blocked_seconds']:.3f} s; deflate "
          f"{row['deflate_seconds']:.3f} worker-s, tiles "
          f"{row['tile_seconds']:.3f} worker-s; {row['bytes_over_link']} "
          f"bytes over the link, PNG {row['png_bytes']} bytes; link probe "
          f"{row['link_probe_mb_s']['best_mb_s']:.0f} MB/s pageable, "
          f"{row['link_probe_mb_s']['pinned_best_mb_s']:.0f} MB/s pinned; "
          f"read back by png.read_png in {read_s:.2f} s (unfilter: "
          f"{engine}), every row equal to models.render of the scene "
          "quantized and flipped", flush=True)

    # a resume: 3 tiles deleted, then one corrupted
    side, band = RESUME
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "r.png")
        reset_counts()
        info = render_giant_still(main, side, side, out, band_rows=band,
                                  device=dev)
        assert info["rendered"] == bands(side, band) == 8, info
        first = png.read_png(out)
        tiles = info["tile_dir"]
        for b in (0, 3, 7):
            os.remove(os.path.join(tiles, f"band_{b:05d}.png"))
        info = render_giant_still(main, side, side, out, band_rows=band,
                                  device=dev)
        assert (info["rendered"], info["skipped"]) == (3, 5), info
        assert np.array_equal(png.read_png(out), first), "resume changed"
        with open(os.path.join(tiles, "band_00005.png"), "wb") as f:
            f.write(b"\x89PNG\r\n\x1a\nnot a tile")
        info = render_giant_still(main, side, side, out, band_rows=band,
                                  device=dev)
        assert (info["rendered"], info["skipped"]) == (1, 7), info
        assert np.array_equal(png.read_png(out), first), "re-render changed"
        add(counts(), escape_fields_cuda=("escape_mandelbrot_fused", 12))
        assert np.array_equal(first, export16(models.render(
            main, side, side, device=dev, quantize=16)))
    print(f"path render_giant_still {side}x{side} band {band} (8 bands): 3 "
          f"tiles deleted -> 3 rendered, 5 resumed; 1 tile corrupted -> 1 "
          f"rendered; the PNG unchanged and equal to the whole render; 12 "
          f"launches of escape_mandelbrot_fused", flush=True)

    # banded export-print: 8192^2 supersampled renders 16384^2 > 2^27
    side = PRINT_SIDE
    n_print = bands(side, 512)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "print.png")
        argv = ["export-print", "--width", str(side), "--height", str(side),
                "--supersample", "--downsample"]
        rc, said, wall, launches = verb([*argv, "--out", out])
        assert rc == 0 and "streaming in bands" in said, said
        add(launches, escape_fields_cuda=("escape_mandelbrot_fused",
                                          n_print))
        assert not os.path.exists(out + ".tiles"), "tiles left behind"
        scene = cli.scene_from_args(cli.build_parser().parse_args(argv))
        ref = export16(downsample2x(models.render(scene, 2 * side, 2 * side,
                                                  device=dev)))
        got = png.read_png(out)
        assert np.array_equal(got, ref), \
            "banded export-print != downsample2x of the 2x render"
        del got, ref
    print(f"path cli export-print --supersample --downsample {side}x{side} "
          f"(a {2 * side}x{2 * side} render, banded): {n_print} launches of "
          f"escape_mandelbrot_fused, pixels equal to downsample2x of the "
          f"monolithic 2x render, quantized; tiles removed; {wall:.2f} s "
          "wall", flush=True)

    # deep-zoom and bulb giants at 1080p, 256-row bands (the last 56)
    n_1080 = bands(H, GIANT_1080_BAND)
    with tempfile.TemporaryDirectory() as tmp:
        for label, scene, w_, inst, whole in (
                ("config 4 deep zoom", dz, (pert_w,), ("pert_mandelbrot_dd",),
                 deep_zoom.render(dz, W, H, device=dev, quantize=16)),
                ("bulb power 8", bulb, (cone_w, march_w),
                 ("bulb_cone_p8", "bulb_march_p8"),
                 mandelbulb.render(bulb, W, H, device=dev, quantize=16))):
            out = os.path.join(tmp, "g.png")
            reset_counts()
            t0 = time.perf_counter()
            info = render_giant_still(scene, W, H, out,
                                      band_rows=GIANT_1080_BAND,
                                      resume=False, device=dev)
            wall = time.perf_counter() - t0
            add(counts(), **{x: (i, n_1080) for x, i in zip(w_, inst)})
            assert info["rendered"] == n_1080, info
            assert np.array_equal(png.read_png(out), export16(whole)), label
            print(f"path render_giant_still {label} {W}x{H} band "
                  f"{GIANT_1080_BAND}: {n_1080} bands, {n_1080} launches of "
                  f"{' and '.join(inst)}, equal to the whole frame; "
                  f"{wall:.2f} s wall", flush=True)


# the live phase: the reference's 1700x900 window as a sixel session (the
# window report's height over LINES rows leaves 900 pixel rows above the
# status line), the held-e autorepeat interval, the plain band's rows
LIVE_WINDOW = (1700, 920)
LIVE_TERM = ("200", "46")
LIVE_SIZE = (1700, 900)
LIVE_DT = 0.05
LIVE_BAND = 64


def live_phase(dev, kernels, plain_kernels, reset_counts, counts) -> None:
    """The live session (live.py) in-process on ``dev``, driven by a
    scripted event stream in a forced-sixel pixel session at 1700x900: a
    held ``e`` on the default Mandelbrot through the iteration ladder's
    rungs 256 -> 2048, the ``z`` Seahorse preset and ``+``, then ``r`` and
    Tab to the bulb and ``o`` with a tick.  Each frame is dispatched,
    popped by its CUDA event (live.pop_ready), fetched and composed to a
    sixel escape, as the session's loop does; the launch counts are reset
    before the drive and read after it, per frame and in all.  Afterwards
    every frame is held bit-equal to the same scene through the plain
    versions (the 2D frames whole; the deep and bulb frames on the
    frame's middle 64 rows), and each rung is rendered again at scales 1
    and 2 to set its first render's time against a warm one."""
    from collections import deque

    import torch

    from fractalrenderer_tpu_torch import Scene, gfx, live
    from fractalrenderer_tpu_torch.models import deep_zoom, mandelbulb

    saved_env = {k: os.environ.get(k) for k in ("COLUMNS", "LINES")}
    os.environ["COLUMNS"], os.environ["LINES"] = LIVE_TERM
    try:
        sess = live.LiveSession(Scene().with_(zoom=2.5), device=dev)
        sess.enable_gfx(gfx.GfxInfo("sixel", LIVE_WINDOW))
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert (sess.width, sess.height) == LIVE_SIZE, (sess.width, sess.height)
    sixel_head = '"1;1;{};{}'.format(*LIVE_SIZE)
    wrappers = list(counts())
    frames = []  # (path, scene, scale, host frame, launches, ms)

    def ready_ms(scene=None, scale=None):
        """Dispatch (the session's frame, or ``scene`` at ``scale``) and
        poll the frame's event until it completes, as the loop does: (ms,
        frame)."""
        t0 = time.perf_counter()
        f = (sess.dispatch() if scene is None
             else sess._render_async(scene, scale=scale))
        q = deque([(t0, f, live.frame_event(f))])
        while live.pop_ready(q) is None:
            pass
        return (time.perf_counter() - t0) * 1e3, f

    def frame(path):
        """One turn of the session's loop: dispatch, poll the frame's
        event, fetch, compose."""
        before = counts()
        t0 = time.perf_counter()
        f = ready_ms()[1]
        t_ready = time.perf_counter()
        host = live.fetch(f)
        t_fetch = time.perf_counter()
        out = live.compose_frame(sess, host)
        t_enc = time.perf_counter()
        assert out.count("\x1bP0;1;0q") == 1 and sixel_head in out
        got = counts()
        frames.append((path, sess.scene, sess._last_scale, host,
                       {w: got[w] - before[w] for w in wrappers},
                       ((t_ready - t0) * 1e3, (t_fetch - t_ready) * 1e3,
                        (t_enc - t_fetch) * 1e3)))

    reset_counts()
    with k3_tiers() as tiers:
        now = 0.0
        frame("planar")                    # the first frame, 256 iterations
        rung_first = {256: frames[-1]}
        while sess.scene.max_iterations < 2048 or \
                sess.scene.max_iterations not in rung_first:
            now += LIVE_DT
            sess.handle_event(("key", "e"), now)  # autorepeat of a held e
            sess.tick(now, LIVE_DT)
            frame("planar")
            rung_first.setdefault(sess.scene.max_iterations, frames[-1])
        sess.held.clear()
        for key in ("z", "+"):
            sess.handle_event(("key", key), now)
            frame("deep")
        for key in ("r", "tab", "tab", "tab", "tab"):  # one burst of input
            sess.handle_event(("key", key), now)
        assert sess.scene.fractal_type.name == "MANDELBULB"
        frame("bulb")
        sess.handle_event(("key", "o"), now)
        now += 0.1
        sess.tick(now, 0.1)
        frame("bulb")
        total = counts()  # K3's count is on its stand-in while it stands
    assert sorted(rung_first) == [256, 512, 1024, 1536, 2048], rung_first
    assert sess._orbit_cache and len(set(tiers)) == 1, tiers
    inst = {"planar": {"escape_fields_cuda": "escape_mandelbrot_fused"},
            "deep": {"perturbation_fields_cuda":
                     f"pert_mandelbrot_{tiers[0]}"},
            "bulb": {"cone_fields_cuda": "bulb_cone_p8",
                     "march_fields_cuda": "bulb_march_p8"}}
    per_path = {}
    for path, _, _, _, launches, _ in frames:
        got = {w: n for w, n in launches.items() if n}
        assert set(got) == set(inst[path]), (path, got)
        per_path.setdefault(path, []).append(got)
    for path, wmap in inst.items():
        for w, name in wmap.items():
            n = sum(g[w] for g in per_path[path])
            assert n >= 1, f"the live {path} path launched no {name}"
            kernels[name]["launches"] += n
    assert sum(total.values()) == sum(
        sum(g.values()) for gs in per_path.values() for g in gs), total
    for path, gs in per_path.items():
        ms = [f[5] for f in frames if f[0] == path]
        print(f"live {path}: {len(gs)} frames, launches per frame "
              + ", ".join(f"{inst[path][w]} "
                          + "/".join(str(g[w]) for g in gs)
                          for w in inst[path])
              + "; dispatch to event ms " + ", ".join(f"{m[0]:.3f}"
                                                     for m in ms)
              + "; fetch ms median "
              f"{statistics.median(m[1] for m in ms):.3f}, sixel encode ms "
              f"median {statistics.median(m[2] for m in ms):.3f}",
              flush=True)

    # -- every frame against the plain versions (not counted) --------------
    h, w = sess.height, sess.width
    r0 = h // 2 - LIVE_BAND // 2
    with plain_kernels():
        for k, (path, scene, scale, host, _, _) in enumerate(frames):
            if path == "planar":
                want = sess._render_async(scene, scale=scale).cpu().numpy()
                got = host
            elif path == "deep":
                want = deep_zoom.render(
                    scene, w, h, orbit_cache=sess._orbit_cache, quantize=8,
                    device=dev, row_band=(r0, LIVE_BAND)).cpu().numpy()
                got = host[r0:r0 + LIVE_BAND]
            else:
                want = mandelbulb.band_render_fn(
                    scene, w, LIVE_BAND, h, device=dev)(
                        mandelbulb.dyn_params(scene), r0).cpu().numpy()
                got = host[r0:r0 + LIVE_BAND]
            assert got.shape == want.shape and got.dtype == want.dtype, \
                (path, got.shape, want.shape)
            assert same_bits(torch.from_numpy(got), torch.from_numpy(want)), \
                f"live frame {k} ({path}) differs from the plain versions"
    bulb_px = frames[-1][3]
    assert 0.05 < bulb_px.mean() < 0.95 and not (
        frames[-1][1].rotation_y == frames[-2][1].rotation_y), \
        "the spin tick did not move the bulb"
    print(f"live frames against the plain versions: {len(frames)} "
          f"bit-equal ({len(per_path['planar'])} planar uint8 {w}x{h} "
          f"whole, {len(per_path['deep'])} deep and "
          f"{len(per_path['bulb'])} bulb on rows {r0}-{r0 + LIVE_BAND - 1})",
          flush=True)

    # -- each rung's first render against a warm one, scales 1 and 2 -------
    parts = []
    for rung, f in sorted(rung_first.items()):
        scene = f[1]
        row = []
        for scale in (1, 2):
            first = f[5][0] if scale == 1 else ready_ms(scene, 2)[0]
            warm = statistics.median(ready_ms(scene, scale)[0]
                                     for _ in range(3))
            row.append(f"scale {scale}: first {first:.3f} / warm "
                       f"{warm:.3f}")
        parts.append(f"{rung} ({'; '.join(row)})")
    print("live ladder, host ms from dispatch to the frame's event (first "
          "render at the rung / median of 3 warm; scale 1's first is the "
          "session's own frame): " + ", ".join(parts), flush=True)


def read_png_rgb(path: str):
    """Decode the port's own PNGs (8- or 16-bit RGB, filter type 0 on every
    row) to uint8 or uint16 (H, W, 3)."""
    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos, idat, width = 8, b"", None
    while pos < len(data):
        (length,), tag = struct.unpack(">I", data[pos:pos + 4]), \
            data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            width, height, depth, ctype = struct.unpack(">IIBB",
                                                        payload[:10])
            assert depth in (8, 16) and ctype == 2, (depth, ctype)
        elif tag == b"IDAT":
            idat += payload
    nbytes = depth // 8
    rows = np.frombuffer(zlib.decompress(idat), np.uint8)
    rows = rows.reshape(height, 1 + width * 3 * nbytes)
    assert (rows[:, 0] == 0).all(), "unexpected PNG row filter"
    px = np.ascontiguousarray(rows[:, 1:])
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    return px.reshape(height, width, 3)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, by CUDA
    events on the current stream (after one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cuda_event_ms(fn):
    """(``fn()``, the milliseconds of that one call by CUDA events on the
    current stream)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def records_ms(dev, cases, prefixes) -> dict:
    """The kernel's own device ms per launch of each case, from the
    profiler's kernel records: one session runs each case's ``(key, launch,
    reps)`` ``reps`` times, case after case on one stream, and the records
    whose name holds one of ``prefixes`` (the port's kernels, not the
    wrappers' glue) fall to the cases in that order.  Returns {key: (mean
    ms per launch, the kernel's name)}."""
    from fractalrenderer_tpu_torch.utils import diag

    def run():
        for _, launch, reps in cases:
            for _ in range(reps):
                launch()

    with tempfile.TemporaryDirectory() as d:
        diag.measure_device_seconds(run, d, dev)
        recs = [r for r in diag.kernel_records_from_trace(d)
                if any(p in r[0] for p in prefixes)]
    assert len(recs) == sum(c[2] for c in cases), (len(recs), cases)
    out, i = {}, 0
    for key, _, reps in cases:
        group = recs[i:i + reps]
        i += reps
        names = {n for n, _ in group}
        assert len(names) == 1, (key, names)
        out[key] = (sum(t for _, t in group) / reps * 1e3, names.pop())
    return out


def sm_clock_mhz(launch, n: int = 30) -> int:
    """The SM clock (MHz) nvidia-smi reads while ``n`` launches of
    ``launch`` run."""
    import torch

    for _ in range(n):
        launch()
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]
    torch.cuda.synchronize()
    return int(mhz)


def trips_line(c: dict) -> str:
    """K4b's decoded per-warp counters (bulb_kernel.decode_trips), one
    line."""
    return (f"trips {c['trips']}, step trips {c['step_trips']}, event trips "
            f"{c['event_trips']} (share {c['event_share']:.3f}), lane steps "
            f"{c['lane_steps']} (utilisation {c['lane_util']:.3f}), "
            f"{c['warps']} warps on {c['sms']} SMs, span "
            f"{c['span_ns'] / 1e6:.4f} ms, tail share {c['tail_share']:.3f}")


# K1's frames at 1080p x ITERS, each family's view: its main path's fused
# frame and its tracked fields frame (no skip), and the Step 1 variants
# that split an instance's time into loop, colour and post chain
K1_VARIANTS = ("fused", "fused_nopost", "fused_noskip", "fields",
               "fields_untracked")


def k1_frame(family: str, variant: str = "fused"):
    """(params, keyword arguments of escape_fields_cuda without the device)
    of ``family``'s 1080p frame in ``variant``: fused, as the main path
    colours it (the interior skip on for the Mandelbrot family), without
    the post chain or without the skip; fields with the family's tracked
    outputs or none, the skip off."""
    from fractalrenderer_tpu_torch.ops import escape

    spec = FAMILIES[family]
    params = escape.pack_params(family=family, iter_limit=ITERS,
                                **spec["view"])
    kw = dict(width=W, height=H, map_height=H, row0=0, max_iter_cap=ITERS,
              family=family)
    if variant.startswith("fused"):
        kw.update(interior_skip=(family == "mandelbrot"
                                 and variant != "fused_noskip"),
                  fused_color=(0, 0, family != "mandelbrot",
                               variant != "fused_nopost"))
    else:
        kw.update(interior_skip=False, fused_color=None,
                  **(spec["track"] if variant == "fields" else {}))
    return params, kw


def k1_lane_iters(params, kw, dev) -> int:
    """The loop updates K1's frame ``(params, kw)`` applies: over the
    pixels the skip leaves in the loop, n, or limit - 1 where n is the
    limit (the interior pixels run limit - 1 updates after the peeled
    update 0).  From the kernel's own fields launch of the same view."""
    import torch

    from fractalrenderer_tpu_torch.ops import escape

    fields = dict(kw, fused_color=None, track_trap=False,
                  track_stripe=False, track_deriv=False)
    n = escape.escape_fields_cuda(params, device=dev, **fields)[0]
    limit = int(min(float(params[escape.P_LIMIT]), kw["max_iter_cap"]))
    loop = ~escape.interior_skip_mask(
        params, width=kw["width"], height=kw["height"],
        map_height=kw["map_height"], row0=kw["row0"], device=dev) \
        if kw["interior_skip"] else torch.ones_like(n, dtype=torch.bool)
    return int(n.clamp(max=limit - 1)[loop].double().sum())


def escape_trips_line(c: dict) -> str:
    """K1's or K2's decoded per-warp counters (escape.decode_trips), one
    line."""
    return (f"trips {c['trips']}, lane iterations {c['lane_iters']} "
            f"(utilisation {c['lane_util']:.4f}; issued / useful "
            f"{1 / max(c['lane_util'], 1e-12):.4f}), "
            f"pixels {c['pixels']} ({c['looped']} looped), {c['warps']} "
            f"warps on {c['sms']} SMs (resident per SM: mean "
            f"{c['warps_per_sm_mean']:.1f}, peak {c['warps_per_sm_peak']}), "
            f"loop share {c['loop_share']:.4f} by SM cycles "
            f"({c['loop_share_ns']:.4f} by the global timer; "
            f"{c['loop_clk'] / c['warps']:.0f} + "
            f"{c['epi_clk'] / c['warps']:.0f} cycles per warp), span "
            f"{c['span_ns'] / 1e6:.4f} ms, tail share {c['tail_share']:.4f}")


def ptxas_report(log: str) -> dict:
    """Registers, stack frame and spill bytes of each kernel instance from
    the ``-Xptxas=-v`` build log, by instance name."""
    families = list(FAMILIES)
    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            # K1 and K2: a third (K1) or only (K2) flag is the counting
            # twin (older builds have none)
            k = re.search(r"escape_kernelILi(\d)ELb([01])E(?:Lb([01])E)?",
                          m.group(1))
            d = re.search(r"dd_escape_kernelILb([01])E", m.group(1))
            t = re.search(r"pert_kernelILi(\d)ELi(\d)ELi(\d)E",
                          m.group(1))
            b = re.search(r"bulb_(cone|march)_kernelILi(\d+)E", m.group(1))
            c = re.search(r"peak_kernelILi(\d+)E", m.group(1))
            if c:
                name = f"fma_peak_c{c.group(1)}"
            elif b:
                p = int(b.group(2))
                name = f"bulb_{b.group(1)}_" + (f"p{p}" if p else "trig")
            elif d:
                # the twin that keeps the per-warp counters: "_counting"
                name = "dd_escape_mandelbrot" + ("", "_counting")[
                    int(d.group(1))]
            elif k:
                name = (f"escape_{families[int(k.group(1))]}_"
                        + ("fused" if k.group(2) == "1" else "fields")
                        + ("", "_counting")[int(k.group(3) or 0)])
            elif t:
                name = (f"pert_{PERT_FAMILIES[int(t.group(1))]}_"
                        + PERT_TIERS[int(t.group(2))]
                        + ("", "_err", "_single")[int(t.group(3))])
            else:
                name = ("dd_escape_mandelbrot" if "dd_escape_kernel"
                        in m.group(1) else m.group(1))
            report[name] = dict(regs=None, stack=None, spill=None)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            report[name].update(stack=int(m.group(1)),
                                spill=int(m.group(2)) + int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name]["regs"] = int(m.group(1))
    return report


def dz_flags(view: str) -> list:
    v = DZ_VIEWS[view]
    family = {"julia": ["--deep-julia", "--julia-cr", JC[0], "--julia-ci",
                        JC[1]],
              "ship": ["--deep-ship"],
              "phoenix": ["--deep-phoenix", "--phoenix-p", "0",
                          "--phoenix-r", str(v.get("r"))]}
    return ["--type", "deep-zoom", "--hp-center-x", v["cx"], "--hp-center-y",
            v["cy"], "--hp-zoom", v["zoom"], "--iters", str(v["iters"]),
            *family.get(v.get("family"), [])]


def dz_scene(view: str, **kw):
    """The deep-zoom Scene of a view of DZ_VIEWS (the CLI's scene for
    ``dz_flags(view)``)."""
    from fractalrenderer_tpu_torch import FractalType, Scene

    v = DZ_VIEWS[view]
    fam = {"julia": dict(deep_zoom_julia=True, julia_c_real=float(JC[0]),
                         julia_c_imag=float(JC[1])),
           "ship": dict(deep_zoom_ship=True),
           "phoenix": dict(deep_zoom_phoenix=True, phoenix_p=0.0,
                           phoenix_r=v.get("r"))}.get(v.get("family"), {})
    return Scene(fractal_type=FractalType.DEEP_ZOOM, hp_center_x=v["cx"],
                 hp_center_y=v["cy"], hp_zoom=v["zoom"],
                 max_iterations=v["iters"], use_perturbation=True, **fam,
                 **kw)


def pert_setup(view, width, height, series, exact_dust=False):
    """The orbit, series and packing options the deep-zoom model
    derives for ``view`` at width x height
    (models/deep_zoom.render_fields): the family's recurrence, the Julia
    drift (floatexp-emitted in the ARBITRARY tier) and start Z0, and
    the exact-dust tier's raised orbit precision.  The orbit comes from
    ``orbit.compute_orbit`` as it is at the call."""
    from fractions import Fraction

    from fractalrenderer_tpu_torch.deepzoom import orbit as orbit_mod
    from fractalrenderer_tpu_torch.deepzoom import series as series_mod
    from fractalrenderer_tpu_torch.deepzoom.hp import (
        precision_mode_for_zoom_frac)
    from fractalrenderer_tpu_torch.ops import dd

    v = DZ_VIEWS[view]
    family = v.get("family", "mandelbrot")
    zoom_fr = Fraction(v["zoom"])
    mode, bits = precision_mode_for_zoom_frac(zoom_fr)
    bits = -(-bits // 64) * 64
    if exact_dust:
        bits = max(bits + 96, 160)
    scaled = mode.name == "ARBITRARY"
    fam = {}
    if family == "julia":
        orb = orbit_mod.compute_orbit(*JC, bits, v["iters"] + 1,
                                      z0x=v["cx"], z0y=v["cy"],
                                      emit_rel=True, emit_fx=scaled)
        fam = dict(julia=True, julia_z0=(float(Fraction(v["cx"])),
                                         float(Fraction(v["cy"]))))
        if scaled:
            orb, fam["orbit_exp"] = orb
    else:
        kind = {"mandelbrot": 0, "ship": 1, "phoenix": 2}[family]
        orb = orbit_mod.compute_orbit(v["cx"], v["cy"], bits,
                                      v["iters"] + 1, kind=kind,
                                      pp=0.0, rr=v.get("r", 0.0))
        if family == "ship":
            fam = dict(ship=True)
        elif family == "phoenix":
            fam = dict(phoenix=True, phoenix_p=0.0, phoenix_r=v["r"])
    dd_delta = float(zoom_fr) <= 1e-7 and not scaled
    if family == "ship":
        dd_delta = not scaled
    skip = None
    if series:
        corner = math.hypot(0.5 * width / height + 1.0 / height,
                            0.5 + 1.0 / height)
        skip = (series_mod.compute_series_skip_fx(
            orb, zoom_fr * 4 * Fraction(corner) / height) if scaled
            else series_mod.compute_series_skip(
                orb, float(zoom_fr) * 4.0 / height * corner))
    kw = dict(center_x_dd=dd.dd_from_string(v["cx"]),
              center_y_dd=dd.dd_from_string(v["cy"]),
              zoom_dd=dd.dd_from_string(v["zoom"]), max_iter=v["iters"],
              series=skip, scaled_delta=scaled, zoom_frac=v["zoom"],
              dd_delta=v.get("dd", dd_delta), **fam)
    return orb, kw, skip


def same_bits(a, b) -> bool:
    """Equal values (NaN at the same places: dz overflows in some interior
    pixels outside the skipped bulbs)."""
    import torch

    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(nan_a, nan_b)
                and torch.equal(a[~nan_a], b[~nan_b]))


def k5_phase(dev, entry) -> None:
    """K5 at the JAX probe's shape and depth, bit-equal to the plain
    version at full size (the plain version timed by CUDA events).  Its
    rate is measured once, by bench config 1 (measure_vpu_peak)."""
    import torch

    from fractalrenderer_tpu_torch.utils import diag

    x = torch.ones(diag.PEAK_SHAPE, dtype=torch.float32, device=dev)
    got = diag.fma_chains_cuda(x, PEAK_CHAINS, PEAK_K)
    want, plain_ms = cuda_event_ms(
        lambda: diag.fma_chains_plain(x, PEAK_CHAINS, PEAK_K))
    assert torch.equal(got, want), "K5 not bit-equal to fma_chains_plain"
    entry("fma_peak", PEAK_SRC, K5_TPU, 0.0)["plain_ms"] = plain_ms
    print(f"K5 {PEAK_CHAINS} chains x {PEAK_K} fmaf steps over "
          f"{x.shape[0]}x{x.shape[1]}: bit-equal to the plain version "
          f"(plain {plain_ms:.1f} ms by CUDA events)", flush=True)


def host_us_per_call(fn, calls: int = 1000) -> float:
    """Host microseconds per call of ``fn``: the mean of ``calls`` calls
    ended by one synchronise (after a warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def device_us_per_launch(dev, fn, launches: int = 100) -> tuple:
    """(device microseconds per kernel launch, kernels per call) of
    ``launches`` calls of ``fn``, from their kernels' profiler records
    (diag.kernel_seconds_from_trace)."""
    from fractalrenderer_tpu_torch.utils import diag

    with tempfile.TemporaryDirectory() as d:
        diag.measure_device_seconds(
            lambda: [fn() for _ in range(launches)], d, dev)
        recs = diag.kernel_seconds_from_trace(d)
    n = sum(v[0] for v in recs.values())
    assert n % launches == 0, recs
    return sum(v[1] for v in recs.values()) / n * 1e6, n // launches


def k6_phase(dev, entry) -> None:
    """K6 built twice with two salts, each output checked, the main
    library's path unchanged; the kernel, its plain version and the one
    PyTorch call of the same function (``torch.add(one, x, alpha=salt)``,
    ``one`` made beforehand: one launch) timed in turns: host microseconds
    per call (the mean of 1000 calls ended by a synchronise; five runs,
    before any profiler session of the process), then device microseconds
    per call from the kernels' profiler records (two runs)."""
    import torch

    from fractalrenderer_tpu_torch.ops import _cuda

    lib_path = _cuda.library_path()
    probes = [_cuda.compile_probe(dev) for _ in range(2)]
    assert probes[0]["salt"] != probes[1]["salt"], "one salt drawn twice"
    assert _cuda.library_path() == lib_path, "a probe moved the library"
    x = torch.ones((16, 128), dtype=torch.float32, device=dev)
    lib, salt = probes[1]["lib"], probes[1]["salt"]
    got = _cuda.compile_probe_cuda(lib, x)
    assert torch.equal(got, _cuda.compile_probe_plain(x, salt))
    one = x.new_ones(())
    assert torch.equal(torch.add(one, x, alpha=salt), got)
    fns = {"kernel": lambda: _cuda.compile_probe_cuda(lib, x),
           "plain": lambda: _cuda.compile_probe_plain(x, salt),
           "torch.add": lambda: torch.add(one, x, alpha=salt)}
    order = list(fns)
    host_us, dev_us, kernels = {}, {}, {}
    for r in range(5):
        for label in order[r % 3:] + order[:r % 3]:
            host_us.setdefault(label, []).append(host_us_per_call(fns[label]))
    for label in order + order[::-1]:
        us, kernels[label] = device_us_per_launch(dev, fns[label])
        dev_us.setdefault(label, []).append(us * kernels[label])
    assert kernels["kernel"] == kernels["torch.add"] == 1, kernels
    dev_med = {k: statistics.median(v) for k, v in dev_us.items()}
    host_med = {k: statistics.median(v) for k, v in host_us.items()}
    e = entry("compile_probe", PROBE_SRC, K6_TPU, 0.0)
    e.update(ms=dev_med["kernel"] / 1e3, plain_ms=dev_med["plain"] / 1e3,
             library_ms=dev_med["torch.add"] / 1e3)
    print("K6 compile probe: " + "; ".join(
        f"salt {p['salt']:.0f}: nvcc + load {p['build_seconds']:.3f} s, "
        f"call to fetched scalar {p['seconds']:.3f} s, out = x * salt + 1 "
        "bit-equal" for p in probes)
        + "; the library path unchanged; host us per call (mean of 1000 "
        "calls ended by a synchronise, median of 5 runs in turns): "
        + ", ".join(f"{k} {host_med[k]:.2f} (runs "
                    f"{[round(t, 2) for t in host_us[k]]})" for k in fns)
        + "; kernel - torch.add "
        f"{host_med['kernel'] - host_med['torch.add']:+.2f} us; device us "
        "per call (profiler records, mean of 100 calls, median of 2 runs "
        "in turns): " + ", ".join(
            f"{k} {dev_med[k]:.3f} ({kernels[k]} launch(es); runs "
            f"{[round(t, 3) for t in dev_us[k]]})" for k in fns), flush=True)


@contextlib.contextmanager
def bracketed(module, name: str, spans: list):
    """While open, every call of ``module.name`` (a kernel wrapper that
    its dispatcher looks up at call time) is bracketed by a pair of CUDA
    events on the current stream, appended to ``spans``.  The wrapper
    counts its launches through its module's name, so the stand-in carries
    the count while it is in place and hands it back."""
    import torch

    real = getattr(module, name)

    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kw)
        end.record()
        spans.append((start, end))
        return out

    timed.launches = real.launches
    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, real)
        real.launches = timed.launches


def lane_against_events(dev, label, run, wrappers, prefixes) -> tuple:
    """The profiler's device lane of ``run()`` against the CUDA events
    bracketing each launch of the port's kernels in that same run (the
    ``(module, name)`` wrappers): every launch has its kernel record
    (counted by the kernel-name ``prefixes``), each record fits in its
    launch's events, and the lane holds at least their sum.  Returns (lane
    ms, the events' ms, the ms of every kernel record of the trace, the
    port's and the glue's)."""
    import torch

    from fractalrenderer_tpu_torch.utils import diag

    spans = []

    def traced():
        spans.clear()  # a trace taken again keeps only its own launches
        run()

    with contextlib.ExitStack() as stack:
        for module, name in wrappers:
            stack.enter_context(bracketed(module, name, spans))
        d = stack.enter_context(tempfile.TemporaryDirectory())
        lane = diag.measure_device_seconds(traced, d, dev) * 1e3
        recs = diag.kernel_seconds_from_trace(d)
    torch.cuda.synchronize(dev)
    events = sum(a.elapsed_time(b) for a, b in spans)
    ours = [(k, v) for k, v in recs.items()
            if any(p in k for p in prefixes)]
    launches = sum(v[0] for _, v in ours)
    rec_ms = sum(v[1] for _, v in ours) * 1e3
    kernels_ms = sum(v[1] for v in recs.values()) * 1e3
    print(f"device lane of {label}: {lane:.4f} ms; its {launches} launch(es) "
          f"of the port's kernels: {rec_ms:.4f} ms by their profiler "
          f"records, {events:.4f} ms by CUDA events around the same "
          f"launches; other device work {lane - rec_ms:.4f} ms; every "
          f"kernel record of the trace {kernels_ms:.4f} ms", flush=True)
    assert launches == len(spans) > 0, (label, launches, len(spans))
    assert rec_ms <= events, (label, rec_ms, events)
    assert lane >= rec_ms, (label, lane, rec_ms)
    return lane, events, kernels_ms


def diagnostics_phase(dev) -> None:
    """The parameter-layout selfcheck; the device lane of the frames the
    bench times (the main path, a Julia frame, config 4, config 6) against
    the CUDA events of their kernels' launches in the same run; the main
    path's lane against K1's CUDA-event time (mean of 50 queued launches:
    at least it) and the kernel records of its own trace (the port's and
    the glue's: at most 1.2x their sum, which a lane that counted a
    kernel twice exceeds); the link probe, pageable and pinned."""
    from fractalrenderer_tpu_torch import FractalType, Scene, bench_all, models
    from fractalrenderer_tpu_torch.models import deep_zoom, mandelbulb
    from fractalrenderer_tpu_torch.ops import bulb_kernel, escape, perturbation
    from fractalrenderer_tpu_torch.utils import diag

    assert diag.params_layout_selfcheck()
    print("params_layout_selfcheck: the packers' P_*/D_*/Q_* equal the CUDA "
          "sources' constants", flush=True)

    k1 = [(escape, "escape_fields_cuda")]
    julia = Scene(fractal_type=FractalType.JULIA, zoom=3.0,
                  julia_c_real=-0.75, julia_c_imag=0.2)
    dz = Scene(fractal_type=FractalType.DEEP_ZOOM, **bench_all.DZ4,
               max_iterations=10000, use_perturbation=True)
    cache = {}
    bulb = Scene(fractal_type=FractalType.MANDELBULB)
    frames = [
        ("the main-path frame (bench config 1)", lambda: models.render(
            Scene(), W, H, device=dev, quantize=8), k1, ("escape_kernel<",)),
        ("a Julia frame (bench config 2)", lambda: models.render(
            julia, W, H, device=dev, quantize=8), k1, ("escape_kernel<",)),
        ("the config-4 frame (bench config 4, series off)",
         lambda: deep_zoom.render(dz, W, H, orbit_cache=cache, device=dev),
         [(perturbation, "perturbation_fields_cuda")], ("pert_kernel<",)),
        ("the config-6 frame (bench config 6)", lambda: mandelbulb.render(
            bulb, W, H, device=dev),
         [(bulb_kernel, "cone_fields_cuda"), (bulb_kernel,
                                              "march_fields_cuda")],
         ("bulb_cone_kernel<", "bulb_march_kernel<")),
    ]
    lanes = []
    for label, run, wrappers, prefixes in frames:
        run()  # warm
        lanes.append(lane_against_events(dev, label, run, wrappers,
                                         prefixes))
    lane, _, kernels_ms = lanes[0]
    params = escape.pack_params(center_x=-0.5, center_y=0.0, zoom=3.0,
                                iter_limit=ITERS)
    k1_ms = cuda_ms(lambda: escape.escape_fields_cuda(
        params, width=W, height=H, map_height=H, row0=0, max_iter_cap=ITERS,
        interior_skip=True, fused_color=(0, 0, False, True), device=dev), 50)
    print(f"the main-path frame's device lane {lane:.4f} ms against K1 "
          f"by CUDA events (mean of 50 queued launches) {k1_ms:.4f} ms "
          f"({lane / k1_ms:.2f}x) and the frame's kernel records "
          f"{kernels_ms:.4f} ms ({lane / kernels_ms:.3f}x)", flush=True)
    # the lane holds the frame's K1 launch, and its kernels once each
    assert k1_ms <= lane <= 1.2 * kernels_ms, (lane, k1_ms, kernels_ms)
    link = diag.measure_link_bandwidth(mb=96, reps=3, device=dev)
    assert link["best_mb_s"] > 0 and link["pinned_best_mb_s"] > 0, link
    print(f"measure_link_bandwidth 96 MiB: pageable best "
          f"{link['best_mb_s']:.1f} MB/s (mean {link['mean_mb_s']:.1f}), "
          f"pinned best {link['pinned_best_mb_s']:.1f} MB/s (mean "
          f"{link['pinned_mean_mb_s']:.1f}); a 1080p RGB8 frame "
          f"({3 * W * H} B) at the pageable best: "
          f"{3 * W * H / link['best_mb_s'] / 1e3:.3f} ms", flush=True)


def bench_phase(dev, kernels) -> float:
    """bench_all's configs 0, 1, 2, 4, 6, 7 and 8 (K6 runs in config 0, K5
    in config 1: their launch counts are reset before and read after; config
    8 is the live session's keypress latency, in two processes of its
    own), each row printed; then ``python -m fractalrenderer_tpu_torch.bench``.
    Returns the FP32 rate K5 measured in config 1 (measure_vpu_peak, best
    of 3 by the profiler's device lane), which is also K5's time."""
    from fractalrenderer_tpu_torch import bench_all
    from fractalrenderer_tpu_torch.ops import _cuda
    from fractalrenderer_tpu_torch.utils import diag

    wrappers = {"fma_peak": diag.fma_chains_cuda,
                "compile_probe": _cuda.compile_probe_cuda}
    for w in wrappers.values():
        w.launches = 0
    rows = {}
    for num in (0, 1, 2, 4, 6, 7, 8):
        t0 = time.monotonic()
        rows[num] = bench_all.CONFIGS[num](device=dev)
        print(f"bench_all config{num} ({time.monotonic() - t0:.1f} s): "
              + json.dumps(rows[num]), flush=True)
    # config 8: two `cli interactive --live` processes on a pty, sixel at
    # 800x624; keypress -> complete frame on the pty
    live = rows[8]
    assert live["f32_mandelbrot"]["n"] == 16, live
    assert live["deep_zoom_1e-12"]["n"] == 6, live
    print(f"config 8 on {bench_all.card(dev)}: sixel encode "
          f"{live['sixel_encode_ms']:.3f} ms, kitty PNG encode "
          f"{live['kitty_png_encode_ms']:.3f} ms (800x624, best of 3), the "
          f"pty {live['pty_mb_s']:.2f} MB/s; keypress -> sixel frame p50 / "
          "p95: f32 Mandelbrot "
          f"{live['f32_mandelbrot']['p50_ms']:.3f} / "
          f"{live['f32_mandelbrot']['p95_ms']:.3f} ms "
          f"({live['f32_mandelbrot']['frame_bytes']:.0f} B a frame), deep "
          f"zoom 1e-12 x 10000 {live['deep_zoom_1e-12']['p50_ms']:.3f} / "
          f"{live['deep_zoom_1e-12']['p95_ms']:.3f} ms "
          f"({live['deep_zoom_1e-12']['frame_bytes']:.0f} B a frame)",
          flush=True)
    for name, w in wrappers.items():
        kernels[name]["launches"] = w.launches
    for num in (1, 2, 4, 6):
        assert rows[num]["timing_method"] == "torch_profiler", rows[num]
    assert rows[0]["kernels_built_cold"], rows[0]
    rate = rows[1]["vpu_peak_gflops_f32"] * 1e9
    kernels["fma_peak"]["ms"] = rows[1]["vpu_peak_ms"]
    print(f"K5 by bench config 1 (measure_vpu_peak, best of 3 by the "
          f"profiler): {rows[1]['vpu_peak_ms']:.4f} ms = {rate / 1e9:.1f} "
          f"GFLOP/s, {rate / SPEC_F32_OPS:.1%} of the data sheet's 67 "
          "TFLOP/s", flush=True)
    assert rate > 0.5 * SPEC_F32_OPS, \
        "K5 below half the FP32 peak: was the FMA split by -fmad=false?"
    assert rows[4]["glitched_pixels_remaining"] == 0, rows[4]
    assert rows[7]["glitched_pixels_remaining"] == 0, rows[7]
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-m",
                          "fractalrenderer_tpu_torch.bench"], cwd=HERE,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    head = json.loads(out.stdout.strip().splitlines()[-1])
    assert head["timing_method"] == "torch_profiler" and head["value"] > 0
    print(f"python -m fractalrenderer_tpu_torch.bench "
          f"({time.monotonic() - t0:.1f} s): {json.dumps(head)}", flush=True)
    return rate


def verbs_phase() -> None:
    """``cli info`` and ``cli presets`` exit 0 (info finds nvcc and the
    built library)."""
    from fractalrenderer_tpu_torch import cli

    for verb in ("info", "presets"):
        with contextlib.redirect_stdout(io.StringIO()) as said:
            rc = cli.main([verb])
        assert rc == 0, f"cli {verb} exited {rc}"
        said = said.getvalue()
        if verb == "info":
            assert "kernel library: built" in said and "nvcc: /" in said, \
                said
            print("cli info: exit 0; " + "; ".join(said.strip().splitlines()),
                  flush=True)
        else:
            assert "Seahorse Valley" in said, said
            print(f"cli presets: exit 0, {len(said.splitlines())} lines",
                  flush=True)


@contextlib.contextmanager
def k3_tiers():
    """Record the delta tier of each K3 launch the enclosed work makes; the
    wrapper's launch count goes on as before."""
    from fractalrenderer_tpu_torch.ops import perturbation

    tiers, real = [], perturbation.perturbation_fields_cuda

    def tier_of(*a, **kw):
        tiers.append(kw["tier"])
        return real(*a, **kw)

    # the wrapper counts on the name it launches under: this one while it
    # stands in
    tier_of.launches = 0
    perturbation.perturbation_fields_cuda = tier_of
    try:
        yield tiers
    finally:
        perturbation.perturbation_fields_cuda = real


def animation_phase(dev, kernels, entry, verb, orbit_log,
                    fallback_log) -> None:
    """The batch path at full width: ``cli sweep`` (16 c values at 1080p),
    ``cli animate`` (12 frames at 1080p in chunks of 8, ``--encode --codec
    qtpng``, ``--resume``), the fetch of one chunk, a mixed
    .franim through the per-frame branch at 320x180, and bench config 3.
    ``verb(argv)`` runs a CLI verb with the launch counts reset: (exit
    code, stdout, host seconds, the wrappers' launches); ``orbit_log`` and
    ``fallback_log`` grow by the reference and HP-fallback orbits."""
    import numpy as np
    import torch

    from fractalrenderer_tpu_torch import (FractalType, Scene, bench_all,
                                           cli, models)
    from fractalrenderer_tpu_torch.anim import franim, qtpng
    from fractalrenderer_tpu_torch.anim.keyframes import Animation, Keyframe
    from fractalrenderer_tpu_torch.models import common
    from fractalrenderer_tpu_torch.models.julia import render_c_sweep
    from fractalrenderer_tpu_torch.ops import escape
    from fractalrenderer_tpu_torch.utils.image import to_export_orientation

    esc_w, pert_w = "escape_fields_cuda", "perturbation_fields_cuda"
    cone_w, march_w = "cone_fields_cuda", "march_fields_cuda"

    def flipped8(img):
        """The uint8 PNG pixels of a device image (f32 or uint8)."""
        if img.dtype == torch.float32:
            img = common.quantize_image(img, bit_depth=8)
        return to_export_orientation(img).cpu().numpy()

    with tempfile.TemporaryDirectory() as tmp:
        # cli sweep: 16 c values at 1080p, one K1 launch each; each entry of
        # render_c_sweep is models.render of its c, bit for bit
        sw_dir = os.path.join(tmp, "sweep")
        sw = ["sweep", "--width", str(W), "--height", str(H), "--count",
              "16", "--out-dir", sw_dir]
        rc, said, wall, launches = verb(sw)
        assert rc == 0, f"cli sweep exited {rc}"
        assert launches.pop(esc_w) == 16 and not any(launches.values()), \
            launches
        kernels["escape_julia_fused"]["launches"] += 16
        files = sorted(os.listdir(sw_dir))
        assert files == [f"sweep_{k:03d}.png" for k in range(16)], files
        args = cli.build_parser().parse_args(sw)
        sc = cli.scene_from_args(args).with_(fractal_type=FractalType.JULIA)
        c0 = [float(v) for v in args.c_start.split(",")]
        c1 = [float(v) for v in args.c_end.split(",")]
        cs = [(c0[0] + (c1[0] - c0[0]) * k / 15,
               c0[1] + (c1[1] - c0[1]) * k / 15) for k in range(16)]
        frames = render_c_sweep(sc, cs, W, H, device=dev)
        for k, (cr, ci) in enumerate(cs):
            one = models.render(sc.with_(julia_c_real=cr, julia_c_imag=ci),
                                W, H, device=dev)
            assert torch.equal(frames[k], one), f"sweep entry {k} != render"
            png_k = read_png_rgb(os.path.join(sw_dir, files[k]))
            assert np.array_equal(png_k, flipped8(frames[k])), \
                f"sweep PNG {k} is not its frame"
        # one entry's K1 planes against the plain version: the fields
        # bit-equal, the fused colour within the colour contract
        k = 5
        dyn = common.scene_dyn_params(sc.with_(julia_c_real=cs[k][0],
                                               julia_c_imag=cs[k][1]))
        params = escape.pack_params(
            family="julia", center_x=dyn["center_x"],
            center_y=dyn["center_y"], zoom=dyn["zoom"],
            iter_limit=dyn["iter_limit"], bailout=dyn["bailout"],
            julia_c=cs[k], color_offset=dyn["color_offset"],
            color_scale=dyn["color_scale"], brightness=dyn["brightness"],
            saturation=dyn["saturation"], contrast=dyn["contrast"])
        kw = dict(width=W, height=H, map_height=H, row0=0,
                  max_iter_cap=common._iter_bucket(sc.max_iterations),
                  interior_skip=False, device=dev, family="julia")
        fields_k = escape.escape_fields_cuda(params, fused_color=None, **kw)
        fields_p = escape.escape_fields_plain(params, fused_color=None, **kw)
        fused = (sc.palette_mode, sc.interior_style, True, True)
        rgb_k = escape.escape_fields_cuda(params, fused_color=fused, **kw)
        rgb_p = escape.escape_fields_plain(params, fused_color=fused, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(fields_k, fields_p)), \
            "sweep entry: K1 fields differ from the plain version"
        assert torch.equal(torch.stack(rgb_k, -1), frames[k])
        err = max((a - b).abs().max().item() for a, b in zip(rgb_k, rgb_p))
        assert err <= COLOR_ATOL, f"sweep entry: colour |diff| {err}"
        entry("escape_julia_fused", ESCAPE_SRC, K1_TPU, err)
        print(f"path cli sweep 16 c values at {W}x{H}: 16 launches of "
              f"escape_julia_fused, 16 PNGs equal to their frames; every "
              f"entry of render_c_sweep equal to models.render of its c; "
              f"entry {k}'s n/zx/zy bit-equal to the plain version, colour "
              f"max |diff| {err:.3g} (bit-equal: "
              f"{all(torch.equal(a, b) for a, b in zip(rgb_k, rgb_p))}); "
              f"{wall * 1e3:.1f} ms wall ({said.strip().splitlines()[-1]})",
              flush=True)

        # cli animate: a two-keyframe zoom, off-axis, 12 frames at 1080p in
        # a chunk of 8 and one of 4, under a cap (600) no single render's
        # bucket (1024) equals; then qtpng and --resume
        an_dir, mov = os.path.join(tmp, "anim"), os.path.join(tmp, "a.mov")
        fpath = os.path.join(tmp, "a.franim")
        an = [*ANIMATE, "--out-dir", an_dir]
        rc, said, wall, launches = verb([*an, "--save-franim", fpath,
                                         "--encode", "--codec", "qtpng",
                                         "--video-out", mov])
        assert rc == 0, f"cli animate exited {rc}: {said[-300:]}"
        assert launches.pop(esc_w) == 12 and not any(launches.values()), \
            launches
        kernels["escape_mandelbrot_fused"]["launches"] += 12
        anim = franim.load(fpath)
        assert anim.total_frames == 12
        files = sorted(f for f in os.listdir(an_dir) if f.endswith(".png"))
        assert files == [f"frame_{f:06d}.png" for f in range(12)], files
        means = []
        for f in range(12):
            scene_f = anim.interpolate(anim.frame_time(f))
            want = flipped8(models.render(scene_f, W, H, device=dev,
                                          quantize=8))
            got = read_png_rgb(os.path.join(an_dir, files[f]))
            assert np.array_equal(got, want), f"animate frame {f} != render"
            means.append(float(got.mean()))
        assert 0 < min(means) and max(means) < 255, means
        dec = qtpng.read_mov(mov)
        assert len(dec["frames"]) == 12 and (dec["width"], dec["height"]) \
            == (W, H), (len(dec["frames"]), dec["width"], dec["height"])
        with open(os.path.join(an_dir, files[0]), "rb") as fh:
            assert dec["frames"][0] == fh.read()
        print(f"path cli animate 12 frames at {W}x{H} (--batch-size 8; "
              f"the cap 600, a single render's 1024): 12 launches of "
              f"escape_mandelbrot_fused, every PNG equal to models.render "
              f"of its interpolated scene (means {min(means):.1f}-"
              f"{max(means):.1f}); --encode --codec qtpng: a {W}x{H} .mov "
              f"of {len(dec['frames'])} samples, {os.path.getsize(mov)} B; "
              f"{wall:.2f} s wall", flush=True)
        rc, said, wall, launches = verb([*an, "--resume"])
        assert rc == 0 and not any(launches.values()), (rc, launches)
        print(f"path cli animate --resume: 0 launches, {wall:.2f} s wall",
              flush=True)

        # the fetch of one chunk: 8 planar uint8 1080p frames
        cfg = dataclasses.replace(common.scene_static_cfg(
            anim.interpolate(0.0), W, H, "mandelbrot", "centered", False,
            device=str(dev)), max_iter=600)
        dyns = [common.scene_dyn_params(anim.interpolate(anim.frame_time(f)))
                for f in range(8)]
        chunk = common.batch_render_fn(cfg, quantize=8, planar=True)(
            {k: np.asarray([d[k] for d in dyns], np.float32)
             for k in dyns[0]})
        torch.cuda.synchronize()
        fetch = []
        for _ in range(3):
            t0 = time.perf_counter()
            host = chunk.cpu()
            fetch.append(time.perf_counter() - t0)
        for f in range(8):
            assert np.array_equal(host[f].permute(1, 2, 0).flip(0).numpy(),
                                  read_png_rgb(os.path.join(an_dir,
                                                            files[f])))
        mb = chunk.numel() / 1e6
        print(f"batch fetch: a chunk of 8 planar uint8 {W}x{H} frames "
              f"({mb:.1f} MB) to pageable memory in "
              f"{statistics.median(fetch) * 1e3:.2f} ms (median of 3: "
              f"{mb / statistics.median(fetch) / 1e3:.2f} GB/s)", flush=True)

        # a mixed .franim at 320x180: Mandelbrot, then the bulb, then deep
        # zoom frames, through the per-frame branch; one reference orbit for
        # every deep-zoom frame; each frame the scene rendered alone
        mixed = Animation(duration=3.0, target_fps=4, export_width=320,
                          export_height=180)
        dz = Scene(fractal_type=FractalType.DEEP_ZOOM, use_perturbation=True,
                   hp_center_x="-0.743643887037151",
                   hp_center_y="0.13182590420533", hp_zoom="3e-5",
                   max_iterations=1000)
        mixed.keyframes += [
            Keyframe(0.0, Scene(center_x=-0.7453, center_y=0.1127,
                                zoom=0.05, max_iterations=400)),
            Keyframe(0.75, Scene(fractal_type=FractalType.MANDELBULB,
                                 rotation_y=0.4)),
            Keyframe(1.75, dz), Keyframe(3.0, dz.with_(hp_zoom="1e-5"))]
        mpath, m_dir = os.path.join(tmp, "m.franim"), os.path.join(tmp, "m")
        franim.save(mixed, mpath)
        n_orb, n_fb = len(orbit_log), len(fallback_log)
        with k3_tiers() as tiers:
            rc, said, wall, launches = verb(["animate", "--franim", mpath,
                                             "--out-dir", m_dir])
        assert rc == 0, f"cli animate (mixed) exited {rc}"
        launches = {w_: n for w_, n in launches.items() if n}
        assert launches == {esc_w: 4, cone_w: 4, march_w: 4, pert_w: 4}, \
            launches
        assert tiers == ["f32"] * 4, tiers
        assert len(orbit_log) == n_orb + 1 and len(fallback_log) == n_fb, \
            "mixed .franim: not one reference orbit, or an HP fallback"
        for inst, w_ in (("escape_mandelbrot_fused", esc_w),
                         ("bulb_cone_trig", cone_w),
                         ("bulb_march_trig", march_w),
                         ("pert_mandelbrot_f32", pert_w)):
            kernels[inst]["launches"] += launches[w_]
        lsbs = []
        for f in range(12):
            scene_f = mixed.interpolate(mixed.frame_time(f))
            if scene_f.fractal_type == FractalType.MANDELBULB:
                scene_f = scene_f.with_(time=mixed.frame_time(f))
            want = flipped8(models.render(scene_f, 320, 180, device=dev,
                                          quantize=8))
            got = read_png_rgb(os.path.join(m_dir, f"frame_{f:06d}.png"))
            lsbs.append(int(np.abs(got.astype(np.int32)
                                   - want.astype(np.int32)).max()))
            assert lsbs[-1] <= 1 and 0 < got.mean() < 255, (f, lsbs)
        print(f"path cli animate .franim at 320x180 (Mandelbrot, bulb, "
              f"deep zoom: 4 frames each): the per-frame branch, launches "
              + ", ".join(f"{w_} {n}" for w_, n in launches.items())
              + f"; one reference orbit; each frame within {max(lsbs)} LSB "
              f"of its scene rendered alone (per frame {lsbs}); {wall:.2f} s "
              "wall", flush=True)

    # bench config 3: 300 frames at 1080p, 256 -> 1024 iterations, planar
    # uint8 summed into an accumulator; K1's kernel record of each frame and
    # the device lane's idle share
    t0 = time.monotonic()
    before = escape.escape_fields_cuda.launches
    row = bench_all.bench_animation(device=dev)
    k1_runs = escape.escape_fields_cuda.launches - before
    print(f"bench_all config3 ({time.monotonic() - t0:.1f} s, {k1_runs} K1 "
          f"launches: 300 per run of the frames): " + json.dumps(row),
          flush=True)
    rec = row["k1_records_ms"]
    assert row["frames"] == 300 and row["timing_method"] == "torch_profiler"
    assert 0 <= row["idle_share"] < 1 and row["fps"] > 0, row
    print(f"config 3: {row['fps']:.1f} fps on the device lane "
          f"({row['seconds'] * 1e3:.3f} ms for 300 frames), "
          f"{row['window_fps']:.1f} fps over the lane's window "
          f"({row['window_s'] * 1e3:.3f} ms); K1 per frame by its records: "
          f"sum {rec['sum']:.3f} ms, mean {rec['mean']:.5f}, p50 "
          f"{rec['p50']:.5f}, min {rec['min']:.5f}, max {rec['max']:.4f}; "
          f"{row['frames_under_2x_floor']} of 300 frames under 2x the "
          f"least record ({row['frames_under_2x_floor'] / 300:.1%}), "
          f"{row['frames_all_interior']} wholly inside the interior skip; "
          f"idle share {row['idle_share']:.4f} (all-interior frames "
          f"{row['idle_share_all_interior']:.4f}, the rest "
          f"{row['idle_share_other']:.4f}); useful iterations "
          f"{row['useful_over_main_path']:.3f}x the main path's per frame",
          flush=True)



def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "fractalrenderer_tpu_torch")):
        print("error: run chip_smoke.py from a checkout of the repository "
              "(fractalrenderer_tpu_torch/ is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from fractions import Fraction

    from fractalrenderer_tpu_torch import FractalType, Scene, cli, models
    # the bench entry points too: the JAX-import check below covers them
    from fractalrenderer_tpu_torch import bench, bench_all  # noqa: F401
    from fractalrenderer_tpu_torch.deepzoom import orbit as orbit_mod
    from fractalrenderer_tpu_torch.deepzoom.hp import HPFloat
    from fractalrenderer_tpu_torch.models import common, deep_zoom
    from fractalrenderer_tpu_torch.models.mandelbrot import (distance_field,
                                                             render_dd)
    from fractalrenderer_tpu_torch.models import mandelbulb
    from fractalrenderer_tpu_torch.ops import (_cuda, bulb_kernel, bulb_math,
                                               dd, dd_escape, escape,
                                               perturbation)
    from fractalrenderer_tpu_torch.utils import diag, png
    from fractalrenderer_tpu_torch.utils.image import to_export_orientation

    assert not any(m == "jax" or m.startswith(("jax.", "fractalrenderer_tpu."))
                   or m == "fractalrenderer_tpu" for m in sys.modules), \
        "the port imported JAX or the JAX package"
    t_start = time.monotonic()
    dev = torch.device("cuda", 0)
    card = bench_all.card(dev)
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    t_lap = [t_start, 0]

    def lap(label):
        """Print the seconds since the previous phase ended, and the
        profiler sessions the phase took again for want of device
        events."""
        now, retakes = time.monotonic(), diag.measure_device_seconds.retries
        print(f"phase {label}: {now - t_lap[0]:.1f} s, "
              f"{retakes - t_lap[1]} profiler session(s) taken again",
              flush=True)
        t_lap[:] = [now, retakes]

    # -- build ---------------------------------------------------------------
    t0 = time.monotonic()
    _cuda.load_library()
    build_s = time.monotonic() - t0
    log = _cuda.library_path()[:-3] + ".log"
    with open(log) as f:
        report = ptxas_report(f.read())
    assert report, "the build log has no ptxas report"
    assert all(r["spill"] == 0 for r in report.values()), \
        f"local-memory spills: {report}"
    # the bulb's 32 instances: the three the slice runs, then the range
    shown = {k: r for k, r in report.items()
             if not k.startswith("bulb_")
             or k.rsplit("_", 1)[1] in ("p8", "trig", "p16")}
    rest = [r["regs"] for k, r in report.items() if k not in shown]
    print(f"build: {build_s:.2f} s, one nvcc per source in parallel; "
          "ptxas (registers/stack frame bytes/spill bytes): " + ", ".join(
              f"{k} {r['regs']}/{r['stack']}/{r['spill']}"
              for k, r in sorted(shown.items()))
          + f"; the other {len(rest)} bulb instances {min(rest)}-"
          f"{max(rest)} registers, no spills", flush=True)

    lap("build")

    def launch(impl, width, height, family="mandelbrot", fused=None,
               skip=None, row0=0, map_height=None, max_iter=ITERS,
               track=None, use_julia=False, **view):
        view = dict(FAMILIES[family]["view"], **view)
        params = escape.pack_params(family=family, iter_limit=max_iter,
                                    row0=row0, **view)
        outs = impl(params, width=width, height=height,
                    map_height=map_height or height, row0=row0,
                    max_iter_cap=max_iter,
                    interior_skip=(family == "mandelbrot" if skip is None
                                   else skip),
                    fused_color=fused, device=dev, family=family,
                    use_julia=use_julia, **(track or {}))
        torch.cuda.synchronize()
        return outs

    kernels = {}  # instance name -> its entry of the kernels JSON line

    def entry(name, source, replaces, err):
        e = kernels.setdefault(name, {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
            "ms": None, "plain_ms": None, "bound_ms": None,
            "bound_by": None,
            # no single PyTorch call computes an escape loop, a
            # perturbation loop or a raymarch
            "library_ms": None})
        e["max_abs_err"] = max(e["max_abs_err"], float(err))
        return e

    def set_bound(name, iters, ops_per_iter, pixel_ops, nbytes, extra=""):
        """The instance's bound for its timed frame: ``iters`` loop
        iterations of ``ops_per_iter`` operations, plus ``pixel_ops``, over
        the card's FP32 peak, or ``nbytes`` bytes moved."""
        ops = float(iters) * ops_per_iter + pixel_ops
        t_ops, t_bytes = ops / peak_f32 * 1e3, nbytes / PEAK_BYTES * 1e3
        e = kernels[name]
        e["bound_ms"] = max(t_ops, t_bytes)
        e["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        print(f"bound {name}: {float(iters):.6g} iterations{extra} x "
              f"{ops_per_iter} ops + {pixel_ops:.4g} = {ops:.4g} ops -> "
              f"{t_ops:.5f} ms at {peak_f32 / 1e12:.3f} TFLOP/s (at K5's "
              f"measured {k5_rate / 1e12:.3f}: {ops / k5_rate * 1e3:.5f} "
              f"ms); {nbytes:.4g} bytes -> {t_bytes:.5f} ms; bound "
              f"{e['bound_ms']:.5f} ms by {e['bound_by']}, "
              f"{e['bound_ms'] / e['ms']:.1%} of the kernel's "
              f"{e['ms']:.4f} ms", flush=True)

    # -- K5 and K6 against their plain versions, the diagnostics, the bench
    # -- path (K5 and K6 launched there; config 1 measures the FP32 rate),
    # -- the two trivial verbs: first, while the process is young (late in
    # -- a process the profiler keeps the card's events only in padded
    # -- sessions, diag.TRACE_PADS_S, which take seconds).  The CLI phases'
    # -- first calls below follow these.
    k5_phase(dev, entry)
    lap("K5")
    k6_phase(dev, entry)
    lap("K6")
    diagnostics_phase(dev)
    lap("diagnostics")
    k5_rate = bench_phase(dev, kernels)
    lap("bench")
    peak_f32 = max(k5_rate, SPEC_F32_OPS)  # the card's FP32 peak
    set_bound("fma_peak", PEAK_K * diag.PEAK_SHAPE[0] * diag.PEAK_SHAPE[1],
              2 * PEAK_CHAINS, 0, 2 * 4 * diag.PEAK_SHAPE[0]
              * diag.PEAK_SHAPE[1], extra=f" (k x N, {PEAK_CHAINS} chains)")
    verbs_phase()
    lap("info and presets")

    # -- Mandelbrot fields: counts and z bit-exact against the plain version --
    cases = [
        (f"{W}x{H}x{ITERS} default", dict(width=W, height=H)),
        (f"{W}x{H} seahorse x{SEAHORSE['max_iter']}",
         dict(width=W, height=H, **SEAHORSE)),
        ("1000x563x256 no skip", dict(width=1000, height=563, skip=False)),
    ]
    for name, kw in cases:
        n_k, zx_k, zy_k = launch(escape.escape_fields_cuda, **kw)
        n_p, zx_p, zy_p = launch(escape.escape_fields_plain, **kw)
        mism = int((n_k != n_p).sum())
        assert mism == 0, f"{name}: {mism} iteration-count mismatches"
        assert torch.equal(zx_k, zx_p) and torch.equal(zy_k, zy_p), \
            f"{name}: zx/zy not bit-equal"
        print(f"fields mandelbrot {name}: 0 count mismatches, zx/zy "
              f"bit-equal (n mean {n_k.float().mean().item():.2f})",
              flush=True)
    r0, r1 = H // 4, H // 2
    full = launch(escape.escape_fields_cuda, W, H)
    band = launch(escape.escape_fields_cuda, W, r1 - r0, row0=r0,
                  map_height=H)
    for a, b in zip(band, full):
        assert torch.equal(a, b[r0:r1]), "row band != whole-frame rows"
    print(f"fields band rows {r0}-{r1} of {H}: equal to the whole frame",
          flush=True)

    lap("K1 Mandelbrot fields")

    # -- every family's fields with its tracked outputs ----------------------
    stripe_err = 0.0
    for family, spec in FAMILIES.items():
        for use_julia in ((False, True) if family == "phoenix" else (False,)):
            kw = dict(width=W, height=H, family=family, skip=False,
                      track=spec["track"], use_julia=use_julia)
            got = launch(escape.escape_fields_cuda, **kw)
            want = launch(escape.escape_fields_plain, **kw)
            names = escape.output_names(family, False, **spec["track"])
            err = 0.0
            for nm, g, w in zip(names, got, want):
                if nm == "stripe":
                    d = (g - w).abs().max().item()
                    bound = (1e-3 * w.abs() + 2e-4 * ITERS)
                    assert bool(((g - w).abs() <= bound).all()), \
                        f"{family}: stripe outside rtol 1e-3, atol 2e-4*iters"
                    stripe_err = max(stripe_err, d)
                    err = max(err, d)
                else:
                    assert same_bits(g, w), f"{family}: {nm} not bit-equal"
            label = family + (" julia-mode" if use_julia else "")
            entry(f"escape_{family}_fields", ESCAPE_SRC, K1_TPU, err)
            print(f"fields {label} {W}x{H}x{ITERS} with {'/'.join(names)}: "
                  f"{'/'.join(n for n in names if n != 'stripe')} bit-equal"
                  + (f", stripe max |diff| {err:.3g}" if "stripe" in names
                     else "") + f" (n mean {got[0].float().mean():.2f})",
                  flush=True)

    lap("K1 families' fields")

    # -- every family's fused colour against the plain version ---------------
    fused_cases = [
        ("mandelbrot", "default", (0, 0, False, True), {}),
        ("mandelbrot", "palette 3, interior 1, offset .25, scale 2",
         (3, 1, False, True), dict(color_offset=0.25, color_scale=2.0)),
        ("mandelbrot", "palette 2, no post chain", (2, 1, False, False), {}),
        ("julia", "default", (0, 0, True, True), {}),
        ("julia", "palette 7, floors, no post chain", (7, 0, True, False),
         dict(brightness=0.05, saturation=-0.5)),
        ("burning_ship", "default", (0, 0, True, True), {}),
        ("burning_ship", "palette 5, interior 3", (5, 3, True, True),
         dict(color_offset=0.1, color_scale=1.5)),
        ("phoenix", "default", (0, 0, True, True), {}),
        ("phoenix", "palette 2, p 0.1, r -0.4, stripes 8, no post chain",
         (2, 0, True, False), dict(phoenix_p=0.1, phoenix_r=-0.4,
                                   stripe_density=8.0)),
    ]
    for family, name, fused, extra in fused_cases:
        rgb_k = torch.stack(launch(escape.escape_fields_cuda, W, H,
                                   family=family, fused=fused, **extra))
        rgb_p = torch.stack(launch(escape.escape_fields_plain, W, H,
                                   family=family, fused=fused, **extra))
        assert torch.isfinite(rgb_k).all(), f"fused {name}: non-finite"
        err = (rgb_k - rgb_p).abs().max().item()
        q_k = common.quantize_image(rgb_k, bit_depth=8).int()
        q_p = common.quantize_image(rgb_p, bit_depth=8).int()
        lsb = (q_k - q_p).abs().max().item()
        assert err <= COLOR_ATOL, f"fused {family} {name}: max |diff| {err}"
        assert lsb <= 1, f"fused {family} {name}: uint8 differs by {lsb} LSB"
        entry(f"escape_{family}_fused", ESCAPE_SRC, K1_TPU, err)
        print(f"fused {family} {name}: max |diff| {err:.3g}, uint8 max "
              f"{lsb} LSB", flush=True)

    lap("K1 fused colour")

    # -- K2: the double-double kernel at the Seahorse view, 1e-9 -------------
    dd_params = dd_escape.pack_dd_params(
        center_x_dd=dd.dd_from_string(DD_VIEW["cx"]),
        center_y_dd=dd.dd_from_string(DD_VIEW["cy"]),
        zoom_dd=dd.dd_from_string(DD_VIEW["zoom"]),
        iter_limit=DD_VIEW["iters"])
    dd_frame = dict(width=W, height=H, map_height=H, row0=0, device=dev)
    got = dd_escape.dd_escape_fields_cuda(dd_params, **dd_frame)
    want = dd_escape.dd_escape_fields_plain(dd_params, **dd_frame)
    torch.cuda.synchronize()
    for nm, g, w in zip(("n", "zx", "zy"), got, want):
        assert torch.equal(g, w), f"dd: {nm} not bit-equal"
    entry("dd_escape_mandelbrot", DD_SRC, K2_TPU, 0.0)
    dd_work = (float(got[0].double().sum()),
               sum(t.numel() * t.element_size() for t in got))
    dd_n = got[0]
    print(f"dd fields {W}x{H} seahorse at {DD_VIEW['zoom']} x"
          f"{DD_VIEW['iters']}: n/zx/zy bit-equal (n mean "
          f"{got[0].float().mean():.1f}, {int((got[0] < DD_VIEW['iters']).sum())}"
          " escaped)", flush=True)

    lap("K2")

    # -- K3: each delta tier, the kernel's frame against a plain band --------
    # Every reference orbit the run computes is logged with its engine and
    # host time (the model computes its own through the same function); the
    # per-pixel orbits of the HP fallback (and of the HP oracle), which stop
    # at the escape radius, go to their own log.
    orbit_log, fallback_log = [], []
    compute_orbit = orbit_mod.compute_orbit

    def logged_orbit(*a, **kw):
        t0 = time.perf_counter()
        o = compute_orbit(*a, **kw)
        (fallback_log if "escape_mag_sq" in kw else orbit_log).append(
            (len(o[0] if isinstance(o, tuple) else o),
             time.perf_counter() - t0))
        return o

    orbit_mod.compute_orbit = logged_orbit

    def orbit_engine() -> str:
        return ("native C++ (native/orbit.cpp)"
                if orbit_mod._load_native() is not None else "Python bignum")

    # (case index, params, device streams, launch geometry, plain band ms)
    pert_frames = []
    # instance -> (sum(n - n_skip), n_skip, pixels, bytes) of its first frame
    pert_work = {}
    for ci, (name, label, view, pw, ph, series) in enumerate(PERT_CASES):
        orb, kw, skip = pert_setup(view, pw, ph, series)
        nlen, orbit_s = orbit_log[-1]
        params, streams, launch = perturbation.pack_pert_operands(
            orb, pw, ph, **kw)
        r0 = ph // 2 - BAND_ROWS // 2
        bparams, _, blaunch = perturbation.pack_pert_operands(
            orb, pw, BAND_ROWS, row0=float(r0), map_height=ph, **kw)
        tier = launch["tier"]
        assert name == f"pert_{launch['family']}_{tier}", (name, launch)
        dstreams = [torch.from_numpy(a).to(dev) for a in streams]
        got = perturbation.perturbation_fields_cuda(
            params, dstreams, max_passes=256, device=dev, **launch)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = perturbation.perturbation_fields_plain(
            bparams, dstreams, max_passes=256, device=dev, **blaunch)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        for nm, g, w in zip(("n", "zx", "zy", "glitch", "want", "rounds"),
                            got, want):
            assert torch.equal(g[r0:r0 + BAND_ROWS], w), \
                f"K3 {label}: {nm} not bit-equal over rows {r0}-" \
                f"{r0 + BAND_ROWS - 1}"
        n_k, zx_k, zy_k, _, want_k, rounds_k = got
        assert int(want_k.sum()) == 0, f"K3 {label}: lanes left wanting"
        # a warp is 32 pixels of one row (32x8 blocks) and runs as long as
        # its slowest lane: sum over warps of 32 x max(n) against sum(n)
        waste = float(n_k.view(ph, -1, 32).amax(-1).double().sum() * 32
                      / n_k.double().sum())
        assert torch.isfinite(zx_k).all() and torch.isfinite(zy_k).all()
        e = entry(name, PERT_SOURCES[launch["family"]], K3_TPU, 0.0)
        if e["plain_ms"] is None:  # the instance's first (main) frame
            e["plain_ms"] = plain_ms
            n_skip = skip.n_skip if skip else 0
            pert_work[name] = (
                float(torch.clamp_min(n_k.double() - n_skip, 0).sum()),
                n_skip, pw * ph,
                sum(t.numel() * t.element_size() for t in got[:5])
                + sum(t.numel() * t.element_size() for t in dstreams))
        pert_frames.append((ci, params, dstreams, launch, plain_ms))
        print(f"K3 {tier} {label} {pw}x{ph}: n/zx/zy/want/rounds bit-equal "
              f"to the plain version over rows {r0}-{r0 + BAND_ROWS - 1} "
              f"(plain band {plain_ms / 1e3:.2f} s); n mean "
              f"{n_k.float().mean():.1f}, max {int(n_k.max())}, interior "
              f"{float((n_k >= kw['max_iter']).float().mean()):.4f}; rounds "
              f"max {int(rounds_k.max())}, mean {rounds_k.mean():.2f}; "
              f"warp-max waste {waste:.3f}; series skip "
              f"{skip.n_skip if skip else 0}; orbit {nlen} "
              f"entries by {orbit_engine()} in {orbit_s * 1e3:.1f} ms",
              flush=True)

    lap("K3 rebasing instances")

    # -- K3 stacked spp-2: config 4's four subpixel segments in one launch --
    # each segment equal to a sequential launch at its offset over the whole
    # frame, and a band of every segment equal to the stacked plain version
    def pack(view, width, height, **extra):
        orb, kw, _ = pert_setup(view, width, height, False,
                                exact_dust=extra.get("track_err", False))
        params, streams, launch = perturbation.pack_pert_operands(
            orb, width, height, **kw, **extra)
        return params, [torch.from_numpy(a).to(dev) for a in streams], launch

    def k3(params, streams, launch, plain=False):
        fn = (perturbation.perturbation_fields_plain if plain
              else perturbation.perturbation_fields_cuda)
        return fn(params, streams, max_passes=256, device=dev, **launch)

    def stacked_check(view, label, name=None):
        params, dstreams, launch = pack(view, W, H, aa_spp=2)
        got = k3(params, dstreams, launch)
        torch.cuda.synchronize()
        nseg = 4
        assert got[0].shape == (nseg, H, W)
        if name:
            for s in range(nseg):
                off = ((s % 2) / 2, (s // 2) / 2)
                seq = k3(*pack(view, W, H, offset=off))
                for nm, g, q in zip(("n", "zx", "zy", "want", "rounds"),
                                    (got[i] for i in (0, 1, 2, 4, 5)),
                                    (seq[i] for i in (0, 1, 2, 4, 5))):
                    assert torch.equal(g[s], q), \
                        f"{label}: segment {s} {nm} != its sequential launch"
        r0 = H // 2 - STACK_ROWS // 2
        bp, bs, bl = pack(view, W, STACK_ROWS, aa_spp=2, row0=float(r0),
                          map_height=H)
        want, plain_ms = cuda_event_ms(lambda: k3(bp, bs, bl, plain=True))
        for nm, g, w in zip(("n", "zx", "zy", "glitch", "want", "rounds"),
                            got, want):
            assert torch.equal(g[:, r0:r0 + STACK_ROWS], w), \
                f"{label}: {nm} not bit-equal to the stacked plain version"
        assert int(got[4].sum()) == 0, f"{label}: lanes left wanting"
        n = got[0]
        print(f"K3 stacked spp 2, {label}, {W}x{H}: one launch of {nseg} "
              "segments" + (", each equal to a sequential launch at its "
                            "offset" if name else "")
              + f"; rows {r0}-{r0 + STACK_ROWS - 1} of every segment "
              f"bit-equal to the stacked plain version (plain "
              f"{plain_ms / 1e3:.2f} s); n mean {n.float().mean():.1f}, "
              f"rounds max {int(got[5].max())}", flush=True)
        if name:
            e = entry(name, PERT_SRC, K3_TPU, 0.0)
            e["plain_ms"] = plain_ms
            pert_work[name] = (float(n.double().sum()), 0, nseg * W * H,
                               sum(t.numel() * t.element_size()
                                   for t in got[:5])
                               + sum(t.numel() * t.element_size()
                                     for t in dstreams))
        return params, dstreams, launch

    stacked_frame = stacked_check("config4", "config 4 (1e-12 x10000), "
                                  "series off", STACKED)
    stacked_check("julia_spp2", "Julia at z*, 1e-10 x200")

    lap("K3 stacked")

    # -- K3's other forms: the error ledger and the single pass --------------
    # each frame against the plain version on a full-width band (every plane
    # the form writes: errx for the ledger, glitch for the single pass)
    form_frames = []  # (case index, params, device streams, launch)
    for ci, (name, label, view, pw, ph, extra) in enumerate(FORM_CASES):
        params, dstreams, launch = pack(view, pw, ph, **extra)
        form = launch["form"]
        assert name == f"pert_{launch['family']}_{launch['tier']}" + {
            "ledger": "_err", "single": "_single"}[form], (name, launch)
        r0 = ph // 2 - BAND_ROWS // 2
        bp, bs, bl = pack(view, pw, BAND_ROWS, row0=float(r0),
                          map_height=ph, **extra)
        got = k3(params, dstreams, launch)
        torch.cuda.synchronize()
        want, plain_ms = cuda_event_ms(lambda: k3(bp, bs, bl, plain=True))
        names = (("n", "zx", "zy", "glitch") if form == "single"
                 else ("n", "zx", "zy", "glitch", "want", "rounds", "errx"))
        assert len(got) == len(want) == len(names)
        for nm, g, w in zip(names, got, want):
            assert same_bits(g[r0:r0 + BAND_ROWS], w), \
                f"K3 {label}: {nm} not bit-equal over rows {r0}-" \
                f"{r0 + BAND_ROWS - 1}"
        n_k = got[0]
        limit = DZ_VIEWS[view]["iters"]
        pert_end = min(limit, int(params[perturbation.Q_REFLEN]) - 1)
        if form == "ledger":
            assert int(got[4].sum()) == 0, f"K3 {label}: lanes left wanting"
            errx = got[6]
            note = (f"errx bit-equal; suspects (errx > -8) "
                    f"{int((errx > -8.0).sum())} of {pw * ph} "
                    f"({float((errx > -8.0).float().mean()):.4f}), errx "
                    f"max {float(errx.max()):.2f}; rounds max "
                    f"{int(got[5].max())}")
            work, cont, what = float(n_k.double().sum()), 0.0, "sum(n)"
        else:
            glitch = got[3] > 0.5
            # steps the pass ran: to the escape, or to the orbit's end;
            # continuation steps past it run the f32 z^2 + c loop
            steps = torch.clamp(n_k.double(), max=pert_end - 1)
            work = float(steps.sum())
            cont = (float((n_k.double() - steps).sum())
                    if launch["float_cont"] else 0.0)
            what = "sum(min(n, orbit end - 1))"
            note = (f"glitch bit-equal; {int(glitch.sum())} flagged "
                    f"({float(glitch.float().mean()):.4f}), orbit end "
                    f"{pert_end} of limit {limit}, lanes past it "
                    f"{int((n_k > pert_end).sum())}")
        assert torch.isfinite(got[1]).all() and torch.isfinite(got[2]).all()
        e = entry(name, PERT_SOURCES[launch["family"]], K3_TPU, 0.0)
        if e["plain_ms"] is None:  # the instance's first (main) frame
            e["plain_ms"] = plain_ms
            pert_work[name] = (
                work, 0, pw * ph,
                sum(t.numel() * t.element_size() for t in got)
                + sum(t.numel() * t.element_size() for t in dstreams),
                cont, what)
        form_frames.append((ci, params, dstreams, launch))
        print(f"K3 {launch['tier']} {label} {pw}x{ph}: "
              f"{'/'.join(names)} bit-equal to the plain version over rows "
              f"{r0}-{r0 + BAND_ROWS - 1} (plain band {plain_ms / 1e3:.2f} "
              f"s); n mean {n_k.float().mean():.1f}, max {int(n_k.max())}, "
              f"interior {float((n_k >= limit).float().mean()):.4f}; "
              f"{note}", flush=True)

    # the ledger in a stacked spp-2 launch: a band of every segment against
    # the stacked plain version
    r0 = H // 2 - STACK_ROWS // 2
    got = k3(*pack("ship_dd", W, H, aa_spp=2, track_err=True))
    want, plain_ms = cuda_event_ms(lambda: k3(*pack(
        "ship_dd", W, STACK_ROWS, aa_spp=2, track_err=True, row0=float(r0),
        map_height=H), plain=True))
    for nm, g, w in zip(("n", "zx", "zy", "glitch", "want", "rounds",
                         "errx"), got, want, strict=True):
        assert same_bits(g[:, r0:r0 + STACK_ROWS], w), \
            f"K3 stacked ledger: {nm} not bit-equal"
    print(f"K3 stacked spp 2 with the ledger, armada 1e-10 x1500, {W}x{H}: "
          f"rows {r0}-{r0 + STACK_ROWS - 1} of every segment bit-equal to "
          f"the stacked plain version, errx included (plain "
          f"{plain_ms / 1e3:.2f} s); suspects "
          f"{int((got[6] > -8.0).sum())} of {4 * W * H}", flush=True)

    lap("K3 ledger and single pass")

    # -- K4a / K4b: the Mandelbulb kernels, config 6 and two more instances --
    # K4a over the whole 1080p coarse grid against its plain version; K4b
    # over the whole frame (with its stats planes), and on the band of rows
    # 508-571 (t0 from the band's own K4a grid, as march_fields computes
    # it) against the plain version, and the band's rows against the frame
    bulb_frames = {}
    names = ["hit", "t", "d", "esc", "nx", "ny", "nz", "ao", "msteps",
             "work"]
    r0, bh = BULB_BAND

    for tag, label, kw in BULB_CASES:
        bp = bulb_math.BulbParams(**kw).clamped()
        ro, dyn = bulb_math.camera_setup(bp)
        ip = bulb_kernel.resolve_int_power(dyn)
        params = bulb_kernel.pack_march_params(
            ro=ro, fov=bp.fov, power=dyn, max_iter=bp.max_iterations)
        cparams = bulb_kernel.pack_cone_params(params, CONE, H)
        ckw = dict(coarse_w=-(-W // CONE), coarse_h=-(-H // CONE) + 1,
                   width=W, map_height=H, int_power=ip, device=dev)
        tc = bulb_kernel.cone_fields_cuda(cparams, **ckw)
        (tc_p, c_evals, c_work), cone_plain_ms = cuda_event_ms(
            lambda: bulb_kernel.cone_fields_plain(cparams, stats=True,
                                                  **ckw))
        assert torch.equal(tc, tc_p), f"K4a {label}: not bit-equal"
        # K4a's schedule floor: the lane with the most evaluations + DE
        # iterations, launched alone (a 1x1 grid whose offsets put its
        # f32 pixel coordinates at the full grid's), and the lightest lane,
        # the launch's fixed floor; each must give the full launch's t0
        load = (c_evals + c_work).flatten()
        lanes = {}
        for which, idx in (("heaviest", int(torch.argmax(load))),
                           ("lightest", int(torch.argmin(load)))):
            crow, ccol = divmod(idx, ckw["coarse_w"])
            lp = cparams.copy()
            lp[bulb_kernel.B_OFFX] += np.float32(ccol * CONE)
            lp[bulb_kernel.B_ROW0] += np.float32(crow)
            lkw = dict(ckw, coarse_w=1, coarse_h=1)
            one = bulb_kernel.cone_fields_cuda(lp, **lkw)
            assert torch.equal(one[0, 0], tc[crow, ccol]), \
                f"K4a {label}: the {which} lane alone != the full launch"
            lanes[which] = (crow, ccol, int(c_evals[crow, ccol]),
                            int(c_work[crow, ccol]), lp, lkw)
        mkw = dict(width=W, height=H, map_height=H, cone=CONE, shade=True,
                   int_power=ip, device=dev)
        trips = bulb_kernel.trips_buffer(ip, W, H, dev)
        full = bulb_kernel.march_fields_cuda(params, tc, stats=True,
                                             trips=trips, **mkw)
        blocks, per_sm = bulb_kernel.march_grid(ip, W, H, dev)
        tr = bulb_kernel.decode_trips(trips)
        # every DE step of the frame is one stepping lane of one trip
        assert tr["lane_steps"] == int(full[9].double().sum()), \
            f"K4b {label}: lane steps {tr['lane_steps']} != sum(work)"
        assert tr["pixels"] == W * H, tr
        bparams = bulb_kernel.pack_march_params(
            ro=ro, fov=bp.fov, power=dyn, max_iter=bp.max_iterations,
            row0=r0)
        bcparams = bulb_kernel.pack_cone_params(bparams, CONE, H)
        bckw = dict(ckw, coarse_h=-(-bh // CONE) + 1)
        btc = bulb_kernel.cone_fields_cuda(bcparams, **bckw)
        assert torch.equal(btc, bulb_kernel.cone_fields_plain(bcparams,
                                                              **bckw))
        bkw = dict(mkw, height=bh, stats=True)
        got = bulb_kernel.march_fields_cuda(bparams, btc, **bkw)
        want, band_plain_ms = cuda_event_ms(
            lambda: bulb_kernel.march_fields_plain(bparams, btc, **bkw))
        for nm, g, w, f in zip(names, got, want, full):
            assert torch.equal(g, w), f"K4b {label}: {nm} not bit-equal " \
                f"to the plain version over rows {r0}-{r0 + bh - 1}"
            assert torch.equal(g, f[r0:r0 + bh]), \
                f"K4b {label}: band {nm} != the whole frame's rows"
        hit, msteps, work = full[0], full[8], full[9]
        warp = bulb_kernel.warp_max(work)
        st = dict(hits=int(hit.sum()), cap=int((msteps >= 200).sum()),
                  evals=float(msteps.double().sum()),
                  work=float(work.double().sum()),
                  warp=float(warp.double().sum()),
                  c_evals=float(c_evals.double().sum()),
                  c_work=float(c_work.double().sum()))
        assert torch.isfinite(torch.stack(full[1:8])).all()
        assert 0.05 < st["hits"] / (W * H) < 0.95, "no bulb in the frame"
        e = entry(f"bulb_cone_{tag}", BULB_SRC, K4A_TPU, 0.0)
        e["plain_ms"] = cone_plain_ms
        e = entry(f"bulb_march_{tag}", BULB_SRC, K4B_TPU, 0.0)
        e["plain_ms"] = band_plain_ms
        bulb_frames[tag] = (params, cparams, ckw, mkw, ip, st, tr, lanes)
        print(f"K4 {tag} {label} {W}x{H}: K4a grid {ckw['coarse_h']}x"
              f"{ckw['coarse_w']} bit-equal to the plain version (plain "
              f"{cone_plain_ms:.1f} ms; {st['c_evals']:.0f} evaluations, "
              f"{st['c_work']:.0f} DE iterations; per lane max "
              f"{int(c_evals.max())} evaluations, {int(c_work.max())} DE "
              f"iterations; " + "; ".join(
                  f"the {k} lane ({v[0]}, {v[1]}: {v[2]} evaluations + "
                  f"{v[3]} DE iterations) launched alone gives its t0 "
                  "bit-equal" for k, v in lanes.items())
              + f"); K4b hit/t/d/esc/nx/ny/"
              f"nz/ao/msteps/work bit-equal to the plain version over rows "
              f"{r0}-{r0 + bh - 1} (plain band {band_plain_ms / 1e3:.2f} "
              f"s) and equal to the whole frame's rows; hit fraction "
              f"{st['hits'] / (W * H):.4f}, lanes at the 200-step cap "
              f"{st['cap']}, msteps max {int(msteps.max())}, sum(work) "
              f"{st['work']:.6g} DE iterations ({st['work'] / (W * H):.2f} "
              f"per pixel, max {int(work.max())}), static 8x4-patch model's "
              f"warp-max waste sum(warp max)/sum(work) "
              f"{st['warp'] / st['work']:.3f}; K4b's launch: {blocks} "
              f"blocks of 256 ({per_sm} resident per SM), counters: "
              f"{trips_line(tr)}; sum(lane steps) == sum(work)", flush=True)

    # every other integer-power instance (`--power N`, time 0) at 64x48,
    # 64 iterations: K4a and K4b with shading and stats against the plain
    # versions, each unrolling its own exponent chains
    swept = sorted(set(range(2, 17)) - {8, 16})
    for p in swept:
        bp = bulb_math.BulbParams(power=float(p), max_iterations=64).clamped()
        ro, dyn = bulb_math.camera_setup(bp)
        assert bulb_kernel.resolve_int_power(dyn) == p
        sparams = bulb_kernel.pack_march_params(
            ro=ro, fov=bp.fov, power=dyn, max_iter=bp.max_iterations)
        scp = bulb_kernel.pack_cone_params(sparams, CONE, 48)
        skw = dict(coarse_w=64 // CONE, coarse_h=48 // CONE + 1, width=64,
                   map_height=48, int_power=p, device=dev)
        stc = bulb_kernel.cone_fields_cuda(scp, **skw)
        assert torch.equal(stc, bulb_kernel.cone_fields_plain(scp, **skw)), \
            f"K4a power {p}: not bit-equal"
        smkw = dict(width=64, height=48, map_height=48, cone=CONE, shade=True,
                    int_power=p, stats=True, device=dev)
        got = bulb_kernel.march_fields_cuda(sparams, stc, **smkw)
        want = bulb_kernel.march_fields_plain(sparams, stc, **smkw)
        for nm, g, w in zip(names, got, want, strict=True):
            assert torch.equal(g, w), f"K4b power {p}: {nm} not bit-equal"
        assert 0.0 < float(got[0].mean()) < 1.0, f"power {p}: no bulb"
    print(f"K4 integer powers {swept} at 64x48: K4a and K4b (all "
          f"{len(names)} planes) bit-equal to the plain versions", flush=True)

    lap("K4")

    # -- the paths, through the entry points a user calls --------------------
    # the kernel wrappers, each with its plain version, source and TPU kernel
    wrappers = [
        (escape, "escape_fields_cuda", "escape_fields_plain", ESCAPE_SRC,
         K1_TPU),
        (dd_escape, "dd_escape_fields_cuda", "dd_escape_fields_plain",
         DD_SRC, K2_TPU),
        (perturbation, "perturbation_fields_cuda",
         "perturbation_fields_plain", PERT_SRC, K3_TPU),
        (bulb_kernel, "cone_fields_cuda", "cone_fields_plain", BULB_SRC,
         K4A_TPU),
        (bulb_kernel, "march_fields_cuda", "march_fields_plain", BULB_SRC,
         K4B_TPU),
    ]
    source_of = {w[1]: (w[3], w[4]) for w in wrappers}

    @contextlib.contextmanager
    def plain_kernels():
        """Run the same pipeline with the plain versions on the card."""
        saved = [(m, c, getattr(m, c)) for m, c, *_ in wrappers]
        for m, c, plain, _, _ in wrappers:
            setattr(m, c, getattr(m, plain))
        try:
            yield
        finally:
            for m, c, fn in saved:
                setattr(m, c, fn)

    def reset_counts():
        for m, c, *_ in wrappers:
            getattr(m, c).launches = 0

    def counts():
        return {c: getattr(m, c).launches for m, c, *_ in wrappers}

    esc_w, dd_w = "escape_fields_cuda", "dd_escape_fields_cuda"
    pert_w = "perturbation_fields_cuda"
    cone_w, march_w = "cone_fields_cuda", "march_fields_cuda"

    def bulb(tag, n=1):
        """A bulb path's launches: n of each of K4a and K4b (instance
        ``tag``)."""
        return {cone_w: (f"bulb_cone_{tag}", n),
                march_w: (f"bulb_march_{tag}", n)}

    bulb_flags = ["--type", "mandelbulb"]
    paths = [
        # (label, cli flags, {wrapper: (instance it runs, exact launches or
        #  None for at least one)}, size, whether to hold the PNG against
        #  the plain pipeline)
        ("default", [], {esc_w: ("escape_mandelbrot_fused", None)}, (W, H),
         True),
        ("--type julia", ["--type", "julia"],
         {esc_w: ("escape_julia_fused", None)}, (W, H), True),
        ("--type burning-ship --orbit-trap --stripes --interior-style 2",
         ["--type", "burning-ship", "--orbit-trap", "--stripes",
          "--interior-style", "2"],
         {esc_w: ("escape_burning_ship_fields", None)}, (W, H), True),
        ("--type burning-ship", ["--type", "burning-ship"],
         {esc_w: ("escape_burning_ship_fused", None)}, (W, H), True),
        ("--type phoenix", ["--type", "phoenix"],
         {esc_w: ("escape_phoenix_fused", None)}, (W, H), True),
        ("--aa 2", ["--aa", "2"], {esc_w: ("escape_mandelbrot_fused", None)},
         (W, H), True),
        ("--orbit-trap --interior-style 2",
         ["--orbit-trap", "--interior-style", "2"],
         {esc_w: ("escape_mandelbrot_fields", None)}, (W, H), True),
        ("--precision dd --hp-zoom 1e-9 --iters 1500",
         ["--precision", "dd", "--hp-zoom", "1e-9", "--iters", "1500",
          "--preset", "Seahorse Valley"],
         {dd_w: ("dd_escape_mandelbrot", None)}, (W, H), True),
        # the deep zoom: config 4 at full size (its plain pipeline takes
        # minutes at 1080p), then at 480x270 against the plain pipeline
        ("--type deep-zoom, config 4 (1e-12 x10000)", dz_flags("config4"),
         {pert_w: ("pert_mandelbrot_dd", None)}, (W, H), False),
        ("--type deep-zoom, config 4 (1e-12 x10000)", dz_flags("config4"),
         {pert_w: ("pert_mandelbrot_dd", None)}, (480, 270), True),
        ("--type deep-zoom, Seahorse 1e-6 x2000", dz_flags("seahorse"),
         {pert_w: ("pert_mandelbrot_f32", None)}, (W, H), True),
        ("--type deep-zoom, config 7 (c = i, 1e-50 x2000)",
         dz_flags("config7"), {pert_w: ("pert_mandelbrot_fx", None)},
         (960, 540), True),
        # the families (one K3 launch per frame) and config 4 with --spp 2
        # (one stacked launch), each against the plain pipeline
        ("--type deep-zoom --deep-julia, z* 1e-12 x500",
         dz_flags("julia_cli"), {pert_w: ("pert_julia_dd", 1)}, (320, 180),
         True),
        ("--type deep-zoom --deep-ship, armada 1e-10 x400",
         dz_flags("ship_cli"), {pert_w: ("pert_ship_dd", 1)}, (320, 180),
         True),
        # the exact-dust tier: the ledger launch, its suspects through the
        # HP fallback (~13% of the armada dust)
        ("--type deep-zoom --deep-ship --exact-dust, armada 1e-10 x400",
         [*dz_flags("ship_cli"), "--exact-dust"],
         {pert_w: ("pert_ship_dd_err", 1)}, (480, 270), True),
        ("--type deep-zoom --deep-phoenix, r -0.5, 1e-10 x400",
         dz_flags("phoenix_cli"), {pert_w: ("pert_phoenix_dd", 1)},
         (320, 180), True),
        ("--type deep-zoom --spp 2, config 4", [*dz_flags("config4"),
                                               "--spp", "2"],
         {pert_w: (STACKED, 1)}, (W, H), False),
        ("--type deep-zoom --spp 2, config 4", [*dz_flags("config4"),
                                               "--spp", "2"],
         {pert_w: (STACKED, 1)}, (240, 136), True),
        # the bulb: config 6, AA 2 and the trig step at full size (the
        # plain pipeline is launch-bound), each also smaller against the
        # plain pipeline, and power 16
        ("--type mandelbulb, config 6", bulb_flags, bulb("p8"), (W, H),
         False),
        ("--type mandelbulb, config 6", bulb_flags, bulb("p8"), (480, 270),
         True),
        ("--type mandelbulb --aa 2", [*bulb_flags, "--aa", "2"],
         bulb("p8", 4), (W, H), False),
        ("--type mandelbulb --aa 2", [*bulb_flags, "--aa", "2"],
         bulb("p8", 4), (320, 180), True),
        ("--type mandelbulb --time 1.0", [*bulb_flags, "--time", "1.0"],
         bulb("trig"), (W, H), False),
        ("--type mandelbulb --time 1.0", [*bulb_flags, "--time", "1.0"],
         bulb("trig"), (480, 270), True),
        ("--type mandelbulb --power 16", [*bulb_flags, "--power", "16"],
         bulb("p16"), (480, 270), True),
    ]
    main_wall = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, flags, runs, (pw, ph), compare in paths:
            out = os.path.join(tmp, "frame.png")
            argv = ["render", "--width", str(pw), "--height", str(ph),
                    *flags, "--out", out]
            reset_counts()
            t0 = time.monotonic()
            with contextlib.redirect_stdout(io.StringIO()) as said:
                rc = cli.main(argv)
            wall = time.monotonic() - t0
            launches = counts()
            assert rc == 0, f"cli render {label} exited {rc}"
            ran = {}
            for w, (instance, n) in runs.items():
                ran[instance] = launches.pop(w)
                assert ran[instance] > 0 if n is None \
                    else ran[instance] == n, \
                    f"{label}: {ran[instance]} launches of {w}, expected " \
                    f"{n or 'some'}"
                entry(instance, *source_of[w], 0.0)["launches"] += \
                    ran[instance]
            assert not any(launches.values()), \
                f"{label}: launched another kernel: {launches}"
            img = read_png_rgb(out)
            assert img.shape == (ph, pw, 3), img.shape
            assert 0 < img.mean() < 255, f"{label}: degenerate image"
            note = "not compared (see the smaller run)"
            if compare:
                scene = cli.scene_from_args(
                    cli.build_parser().parse_args(argv))
                with plain_kernels():
                    if "dd" in flags:
                        ref = common.quantize_image(
                            render_dd(scene, pw, ph, device=dev), bit_depth=8)
                    else:
                        ref = models.render(
                            scene, pw, ph, device=dev, quantize=8,
                            **({"exact_dust": True} if "--exact-dust" in flags
                               else {}))
                ref = to_export_orientation(ref).cpu().numpy()
                lsb = int(np.abs(img.astype(np.int32)
                                 - ref.astype(np.int32)).max())
                # K3 is bit-equal to its plain version: deep zooms 0 LSB
                assert lsb <= (0 if pert_w in runs else 1), \
                    f"{label}: PNG differs from the plain pipeline by {lsb} " \
                    "LSB"
                note = f"max {lsb} LSB from the plain pipeline"
            if pert_w in runs:
                info = said.getvalue().strip().splitlines()[-1].strip()
                assert info.endswith(" 0 remaining"), info
                # only the exact-dust suspects go through the HP fallback
                assert ("--exact-dust" in flags) != (" 0 HP-fallback" in info)
                note += f"; {info}"
            main_wall[(label, pw, ph)] = wall
            print(f"path cli render {label}: {pw}x{ph} PNG, " + ", ".join(
                f"{n} launch(es) of {i}" for i, n in ran.items())
                + f", {wall * 1e3:.1f} ms wall (first call), {note}",
                flush=True)

    # --exact-dust outside the Burning Ship deep zoom: the JAX CLI's guard
    with contextlib.redirect_stderr(io.StringIO()) as err:
        rc = cli.main(["render", *dz_flags("config4"), "--exact-dust",
                       "--out", "unused.png"])
    err = err.getvalue().strip()
    assert rc == 2 and "Burning Ship dust tier" in err, (rc, err)
    assert not os.path.exists("unused.png")
    print(f"path cli render --type deep-zoom --exact-dust (Mandelbrot): exit "
          f"2, {err!r}", flush=True)

    lap("cli render paths")

    # -- export-print, zoom-path and render --golden -------------------------
    # each verb's files against the same verb run on the plain versions
    # (render --golden, which runs no kernel, against the kernel's render)
    def verb(argv, plain=False):
        """Run the CLI verb ``argv`` (stdout kept): (exit code, stdout,
        host seconds, the kernels' launches)."""
        reset_counts()
        t0 = time.monotonic()
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(plain_kernels())
            said = stack.enter_context(contextlib.redirect_stdout(
                io.StringIO()))
            rc = cli.main(argv)
        return rc, said.getvalue(), time.monotonic() - t0, counts()

    def png_lsb(a, b):
        a, b = read_png_rgb(a), read_png_rgb(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
        return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max()), a

    with tempfile.TemporaryDirectory() as tmp:
        out, ref = (os.path.join(tmp, f) for f in ("print.png", "plain.png"))
        argv = ["export-print", "--width", str(W), "--height", str(H),
                "--supersample", "--downsample"]
        rc, said, wall, launches = verb([*argv, "--out", out])
        assert rc == 0, f"cli export-print exited {rc}"
        assert launches.pop(esc_w) == 1 and not any(launches.values()), \
            launches
        kernels["escape_mandelbrot_fused"]["launches"] += 1
        assert verb([*argv, "--out", ref], plain=True)[0] == 0
        lsb, img = png_lsb(out, ref)
        assert img.dtype == np.uint16 and img.shape == (H, W, 3)
        assert 0 < img.mean() < 65535, "export-print: degenerate image"
        assert lsb <= 1, f"export-print: {lsb} LSB from the plain pipeline"
        raw = open(out, "rb").read()
        assert b"pHYs" in raw and b"Print Size (inches)" in raw
        print(f"path cli export-print --supersample --downsample {W}x{H}: "
              f"1 launch of escape_mandelbrot_fused at {2 * W}x{2 * H}, a "
              f"16-bit {W}x{H} PNG with pHYs and the print size, max {lsb} "
              f"LSB (of 65535) from the plain pipeline; {wall * 1e3:.1f} ms "
              f"wall ({said.strip().splitlines()[-1]})", flush=True)

        out, ref = (os.path.join(tmp, f) for f in ("golden.png",
                                                    "kernel.png"))
        rc, said, wall, launches = verb(["render", "--golden", "--width",
                                         "160", "--height", "90", "--out",
                                         out])
        assert rc == 0 and not any(launches.values()), (rc, launches)
        assert verb(["render", "--width", "160", "--height", "90", "--out",
                     ref])[0] == 0
        lsb, img = png_lsb(out, ref)
        assert lsb <= 1, f"render --golden: {lsb} LSB from the kernel's"
        print(f"path cli render --golden 160x90: no launch, max {lsb} LSB "
              f"from the kernel's render; {wall * 1e3:.1f} ms wall",
              flush=True)

        # a zoom from the Seahorse view at 1e-4 to config 4's centre at
        # 1e-9: four frames against one reference orbit at the end, two in
        # the f32 tier, two in the dd tier (zoom <= 1e-7)
        zp = ["zoom-path", "--center", "-0.743643887037151",
              "0.13182590420533", "--zoom", "1e-4", "--target-x",
              "-0.74364388703715158", "--target-y", "0.13182590420531198",
              "--target-zoom", "1e-9", "--iters", "1500", "--frames", "4",
              "--width", "480", "--height", "270"]
        n_orb, n_fb = len(orbit_log), len(fallback_log)
        with k3_tiers() as tiers:
            rc, said, wall, launches = verb([*zp, "--out-dir",
                                             os.path.join(tmp, "k")])
        assert rc == 0, f"cli zoom-path exited {rc}"
        assert launches.pop(pert_w) == 4 and not any(launches.values())
        assert tiers == ["f32", "f32", "dd", "dd"], tiers
        assert len(orbit_log) == n_orb + 1 and len(fallback_log) == n_fb, \
            "zoom-path: not one reference orbit, or an HP fallback"
        for t in set(tiers):
            kernels[f"pert_mandelbrot_{t}"]["launches"] += tiers.count(t)
        rc, _, plain_wall, _ = verb([*zp, "--out-dir",
                                     os.path.join(tmp, "p")], plain=True)
        assert rc == 0
        frames = sorted(os.listdir(os.path.join(tmp, "k")))
        assert frames == [f"frame_{f:06d}.png" for f in range(4)], frames
        notes = []
        for f in frames:
            lsb, img = png_lsb(os.path.join(tmp, "k", f),
                               os.path.join(tmp, "p", f))
            # K3 is bit-equal to its plain version: 0 LSB
            assert lsb == 0, f"zoom-path {f}: {lsb} LSB from the plain one"
            assert img.shape == (270, 480, 3) and 0 < img.mean() < 255, f
            notes.append(f"{img.mean():.1f}")
        print(f"path cli zoom-path 4 frames at 480x270 (1e-4 -> 1e-9 x1500): "
              f"4 launches ({', '.join(tiers)}), one reference orbit; "
              f"frames 0 LSB from the plain pipeline (means "
              f"{', '.join(notes)}); {wall:.2f} s wall, the plain pipeline "
              f"{plain_wall:.2f} s", flush=True)

    lap("export-print, render --golden, zoom-path")

    animation_phase(dev, kernels, entry, verb, orbit_log, fallback_log)
    lap("animation")

    bands_phase(dev, kernels, verb, reset_counts, counts, orbit_log)
    lap("bands")

    live_phase(dev, kernels, plain_kernels, reset_counts, counts)
    lap("live session")

    # the distance field (library entry point: K1 with the derivative)
    scene = Scene()
    reset_counts()
    dist = distance_field(scene, W, H, device=dev)
    torch.cuda.synchronize()
    launches = escape.escape_fields_cuda.launches
    assert launches == 1, "distance_field did not launch K1"
    with plain_kernels():
        ref = distance_field(scene, W, H, device=dev)
    assert same_bits(dist, ref), "distance field differs from plain"
    kernels["escape_mandelbrot_fields"]["launches"] += launches
    print(f"path models.mandelbrot.distance_field {W}x{H}: 1 launch, equal "
          f"to the plain pipeline ({int((dist > 0).sum())} exterior pixels)",
          flush=True)
    # the Julia and Phoenix fields instances: no render path tracks their
    # (constant) traps, so their entry point is escape_fields itself
    for family in ("julia", "phoenix"):
        v = dict(FAMILIES[family]["view"])
        reset_counts()
        f = escape.escape_fields(family, W, H, max_iter=ITERS, device=dev,
                                 **v, **FAMILIES[family]["track"])
        torch.cuda.synchronize()
        assert escape.escape_fields_cuda.launches == 1
        kernels[f"escape_{family}_fields"]["launches"] += 1
        assert f["n"].shape == (H, W) and (f["trap"] == 0).all()
    print("path ops.escape.escape_fields julia/phoenix with trap+stripe: "
          "1 launch each", flush=True)

    # the deep-zoom fields of configs 4 and 7 through the model: one K3
    # launch, no HP fallback, equal to the K3 phase's frame of that view;
    # configs 4 and 7 and each family instance's first frame (the ship f32
    # instance, which the model never picks, through perturbation_fields)
    lib_cases = [(case[2], ci) for ci, case in enumerate(PERT_CASES)
                 if ci in (1, 3) or case[2] in DZ_VIEWS
                 and DZ_VIEWS[case[2]].get("family")]
    for view, ci in lib_cases:
        _, params, dstreams, launch, _ = pert_frames[ci]
        pw, ph = launch["width"], launch["height"]
        scene = dz_scene(view)
        reset_counts()
        n_orbits = len(orbit_log)
        t0 = time.perf_counter()
        if view == "ship_f32":
            orb, kw, _ = pert_setup(view, pw, ph, False)
            f = perturbation.perturbation_fields(
                orb, pw, ph, rebase=True, float_continuation=False,
                device=dev, **kw)
            n_f, zx_f = f["n"], f["zx"]
            info = dict(precision_mode="through perturbation_fields",
                        precision_bits=None, dd_delta=False,
                        scaled_delta=False, rebase_passes=int(f["passes"]),
                        fallback_pixels=int((f["want"] > 0.5).sum()),
                        glitched_pixels_remaining=0, fields_on_device=True)
        else:
            n_f, zx_f, zy_f, _, info = deep_zoom.render_fields(
                scene, pw, ph, keep_device=True, debug_rounds=True,
                device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
        assert launches.pop(pert_w) == 1, "render_fields: not 1 K3 launch"
        assert not any(launches.values()), "render_fields: other kernels"
        assert info["fallback_pixels"] == 0, info
        assert info["glitched_pixels_remaining"] == 0, info
        assert info["fields_on_device"], info
        kernels[PERT_CASES[ci][0]]["launches"] += 1
        ref = perturbation.perturbation_fields_cuda(
            params, dstreams, max_passes=256, device=dev, **launch)
        assert torch.equal(n_f, ref[0]) and torch.equal(zx_f, ref[1]), \
            f"{view}: the model's fields differ from the K3 phase's frame"
        (nlen, orbit_s), = orbit_log[n_orbits:]
        iters = DZ_VIEWS[view]["iters"]
        print(f"path models.deep_zoom.render_fields {view} {pw}x{ph}: 1 "
              f"launch, {info['precision_mode']} ({info['precision_bits']} "
              f"bits), dd_delta {info['dd_delta']}, scaled "
              f"{info['scaled_delta']}, rebase_passes "
              f"{info['rebase_passes']}, 0 fallback, 0 remaining; n min "
              f"{int(n_f.min())}, mean {n_f.float().mean():.2f}, max "
              f"{int(n_f.max())}, interior "
              f"{float((n_f >= iters).float().mean()):.4f}; orbit {nlen} "
              f"entries by {orbit_engine()} in {orbit_s * 1e3:.2f} ms; "
              f"{wall * 1e3:.1f} ms wall", flush=True)

    lap("library paths")

    # -- the exact-dust tier through the model --------------------------------
    # a row band of each Ship view at 1080p geometry: one ledger launch, its
    # suspects (errx > -8) through the HP fallback; outside them the fields
    # are the ledger frame's rows
    def form_frame(view):
        return next(f for f in form_frames if FORM_CASES[f[0]][2] == view)

    for view, name in (("ship_dd", "pert_ship_dd_err"),
                       ("ship_fx", "pert_ship_fx_err")):
        rows = DUST_ROWS[view]
        r0 = (H - rows) // 2
        reset_counts()
        n_fb = len(fallback_log)
        t0 = time.perf_counter()
        n_f, zx_f, zy_f, g, info = deep_zoom.render_fields(
            dz_scene(view), W, H, row_band=(r0, rows), exact_dust=True,
            keep_device=True, device=dev)
        wall = time.perf_counter() - t0
        launches = counts()
        assert launches.pop(pert_w) == 1, "exact dust: not 1 K3 launch"
        assert not any(launches.values()), "exact dust: other kernels"
        kernels[name]["launches"] += 1
        assert info["glitched_pixels_remaining"] == 0 and not g.any(), info
        assert info["fallback_pixels"] == info["dust_suspect_pixels"], info
        fb = fallback_log[n_fb:]
        assert len(fb) == info["fallback_pixels"]
        fb_s = sum(t for _, t in fb)
        _, params, dstreams, launch = form_frame(view)
        ref = k3(params, dstreams, launch)
        sus = (ref[6][r0:r0 + rows] > -8.0).cpu().numpy()
        assert int(sus.sum()) == info["dust_suspect_pixels"]
        assert (n_f[~sus] == ref[0][r0:r0 + rows].cpu().numpy()[~sus]).all()
        moved = int((n_f[sus] != ref[0][r0:r0 + rows].cpu().numpy()[sus])
                    .sum())
        print(f"path models.deep_zoom.render_fields exact_dust {view} rows "
              f"{r0}-{r0 + rows - 1} of {W}x{H}: 1 launch of {name}, "
              f"{info['precision_bits']} bits, suspects "
              f"{info['dust_suspect_pixels']} of {W * rows} "
              f"({info['dust_suspect_pixels'] / (W * rows):.4f}), HP fallback "
              f"{info['fallback_pixels']} pixels in {fb_s:.2f} s "
              f"({info['fallback_pixels'] / max(fb_s, 1e-9):.0f} px/s, engine "
              f"{orbit_engine()}), {moved} counts changed by it, 0 "
              f"remaining; other pixels equal to the ledger frame; "
              f"{wall:.2f} s wall", flush=True)

    # the JAX tests' 12x8 exact-dust windows, equal to the HP oracle
    def ship_oracle(cx, cy, zoom, w, h, mi, bits):
        step = Fraction(zoom) * 4 / (h * h)
        cxh, cyh = HPFloat(cx, bits), HPFloat(cy, bits)
        n = np.zeros((h, w), np.int64)
        for py in range(h):
            for px in range(w):
                o = orbit_mod.compute_orbit(
                    cxh + HPFloat(step * (Fraction(px) - Fraction(w, 2)),
                                  bits),
                    cyh + HPFloat(step * (Fraction(py) - Fraction(h, 2)),
                                  bits), bits, mi + 1, escape_mag_sq=16.0,
                    kind=1)
                zfx, zfy = o[-1]
                n[py, px] = (len(o) - 2) if zfx * zfx + zfy * zfy > 16.0 \
                    else mi
        return n

    for cx, cy, zoom, mi, bits, name in (
            ("-1.7623025", "-0.028000625", "1e-10", 400, 192,
             "pert_ship_dd_err"),
            ("-2", "0", "1e-40", 1500, 400, "pert_ship_fx_err")):
        scene = Scene(fractal_type=FractalType.DEEP_ZOOM, deep_zoom_ship=True,
                      hp_center_x=cx, hp_center_y=cy, hp_zoom=zoom,
                      max_iterations=mi, use_perturbation=True)
        reset_counts()
        n_w, _, _, g, info = deep_zoom.render_fields(scene, 12, 8,
                                                     exact_dust=True,
                                                     device=dev)
        launches = counts()
        assert launches.pop(pert_w) == 1 and not any(launches.values())
        kernels[name]["launches"] += 1
        nref = ship_oracle(cx, cy, zoom, 12, 8, mi, bits)
        assert not g.any() and info["glitched_pixels_remaining"] == 0
        assert info["dust_suspect_pixels"] <= int(0.4 * 96), info
        mism = int((np.asarray(n_w) != nref).sum())
        assert mism == 0, f"exact dust {cx} {zoom}: {mism} counts differ " \
            f"from the {bits}-bit oracle"
        print(f"path models.deep_zoom.render_fields exact_dust 12x8 at "
              f"({cx}, {cy}) {zoom} x{mi}: 96 of 96 counts equal to the "
              f"{bits}-bit HP oracle ({len(np.unique(nref))} distinct), "
              f"suspects {info['dust_suspect_pixels']}", flush=True)

    lap("exact dust")

    # -- the legacy pipeline through the model (rebasing=False) ---------------
    # one single-pass launch, then one per secondary reference; lanes no
    # reference fixes go through the HP fallback.  Each launch is timed
    # with a synchronize around it; the probes' and the fallback's orbits
    # by the orbit logs.
    kernel_s = []
    cuda_k3 = perturbation.perturbation_fields_cuda

    def timed_k3(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cuda_k3(*a, **kw)  # counts its launch on timed_k3.launches
        torch.cuda.synchronize()
        kernel_s.append(time.perf_counter() - t0)
        return out

    for view, name in (("seahorse", "pert_mandelbrot_f32_single"),
                       ("config4", "pert_mandelbrot_dd_single"),
                       ("config7", "pert_mandelbrot_fx_single")):
        _, params, dstreams, launch = form_frame(view)
        pw, ph = launch["width"], launch["height"]
        rows = LEGACY_ROWS[view]
        r0 = (ph - rows) // 2
        reset_counts()
        timed_k3.launches = 0
        kernel_s.clear()
        n_orb, n_fb = len(orbit_log), len(fallback_log)
        perturbation.perturbation_fields_cuda = timed_k3
        t0 = time.perf_counter()
        try:
            n_f, zx_f, zy_f, g, info = deep_zoom.render_fields(
                dz_scene(view), pw, ph, rebasing=False,
                row_band=None if rows == ph else (r0, rows), device=dev)
        finally:
            perturbation.perturbation_fields_cuda = cuda_k3
        wall = time.perf_counter() - t0
        k = timed_k3.launches
        launches = counts()
        launches.pop(pert_w)
        assert not any(launches.values()), "legacy pipeline: other kernels"
        assert k == len(kernel_s) == info["references_used"], (k, info)
        kernels[name]["launches"] += k
        assert info["algorithm"] == "secondary_refs", info
        assert info["glitched_pixels_remaining"] == 0 and not g.any(), info
        assert np.isfinite(zx_f).all() and np.isfinite(zy_f).all()
        # the first launch is the single-pass frame: its unflagged lanes
        # keep their counts
        ref = k3(params, dstreams, launch)
        ok = (ref[3][r0:r0 + rows] < 0.5).cpu().numpy()
        assert (n_f[ok] == ref[0][r0:r0 + rows].cpu().numpy()[ok]).all()
        probes = orbit_log[n_orb + 1:]  # past the scene's own reference
        fb_s = sum(t for _, t in fallback_log[n_fb:])
        print(f"path models.deep_zoom.render_fields rebasing=False {view} "
              f"rows {r0}-{r0 + rows - 1} of {pw}x{ph}: {k} launch(es) of "
              f"{name} (1 + {k - 1} secondary references), "
              f"{info['glitched_pixels_initial']} pixels flagged "
              f"({info['glitched_pixels_initial'] / (pw * rows):.4f}), "
              f"{info['fallback_pixels']} HP fallback, 0 remaining; "
              f"seconds: K3 launches {sum(kernel_s):.3f} "
              f"({', '.join(f'{t * 1e3:.1f} ms' for t in kernel_s)}), "
              f"{len(probes)} orbit probes {sum(t for _, t in probes):.3f}, "
              f"HP fallback {fb_s:.3f}; {wall:.2f} s wall", flush=True)

    lap("legacy pipeline")

    # -- where a warm frame's host time goes: the main path and config 6 ----
    for label, scene, flags in (
            ("main path", Scene(), []),
            ("config 6 bulb frame (1920x1080, power 8)",
             Scene(fractal_type=FractalType.MANDELBULB), bulb_flags)):
        stages = {"render+quantize": [], "flip+fetch": [], "png write": [],
                  "cli render": []}
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "frame.png")
            for _ in range(3):
                t0 = time.perf_counter()
                img = models.render(scene, W, H, device=dev, quantize=8)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                host = to_export_orientation(img).cpu().numpy()
                t2 = time.perf_counter()
                png.write_png(out, host)
                t3 = time.perf_counter()
                stages["render+quantize"].append(t1 - t0)
                stages["flip+fetch"].append(t2 - t1)
                stages["png write"].append(t3 - t2)
            for _ in range(2):
                with contextlib.redirect_stdout(io.StringIO()):
                    t0 = time.perf_counter()
                    assert cli.main(["render", *flags, "--out", out]) == 0
                    stages["cli render"].append(time.perf_counter() - t0)
        print(f"{label}, warm, host clock, median ms: " + ", ".join(
            f"{k} {statistics.median(v) * 1e3:.2f}"
            for k, v in stages.items()), flush=True)

    # -- where a warm config-4 frame's time goes -----------------------------
    scene = dz_scene("config4")
    p = deep_zoom.ColorParams(
        max_iterations=scene.max_iterations, bailout=scene.bailout,
        palette_mode=scene.palette_mode, color_offset=scene.color_offset,
        color_scale=scene.color_scale)
    stages = {"orbit (host)": [], "render_fields (orbit+series+pack+K3)": [],
              "colour+quantize": [], "flip+fetch": [], "png write": [],
              "cli render": []}
    argv = ["render", "--width", str(W), "--height", str(H),
            *dz_flags("config4")]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "frame.png")
        for _ in range(3):
            n_orbits = len(orbit_log)
            t0 = time.perf_counter()
            n_f, zx_f, zy_f, _, _ = deep_zoom.render_fields(
                scene, W, H, keep_device=True, device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            img = common.quantize_image(
                deep_zoom.color_fields_device(n_f, zx_f, zy_f, p),
                bit_depth=8)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host = to_export_orientation(img).cpu().numpy()
            t3 = time.perf_counter()
            png.write_png(out, host)
            t4 = time.perf_counter()
            stages["orbit (host)"].append(orbit_log[n_orbits][1])
            stages["render_fields (orbit+series+pack+K3)"].append(t1 - t0)
            stages["colour+quantize"].append(t2 - t1)
            stages["flip+fetch"].append(t3 - t2)
            stages["png write"].append(t4 - t3)
        for _ in range(2):
            with contextlib.redirect_stdout(io.StringIO()):
                t0 = time.perf_counter()
                assert cli.main([*argv, "--out", out]) == 0
                stages["cli render"].append(time.perf_counter() - t0)
    print(f"config 4 frame ({W}x{H}, 1e-12 x10000), warm, host clock, median "
          "ms: " + ", ".join(f"{k} {statistics.median(v) * 1e3:.2f}"
                              for k, v in stages.items()), flush=True)

    lap("warm breakdowns")

    # -- time per 1080p frame, each instance against its plain version -------
    # K1 and K2 by their kernel records: one profiler session runs every
    # instance's 1080p frame in turn (records_ms); beside them the call ms,
    # CUDA events over the same number of queued wrapper calls (the figure
    # these lines gave before), and the plain version by CUDA events
    k12_fns = {}
    for family in FAMILIES:
        for kind in ("fused", "fields"):
            params, kw = k1_frame(family, kind)
            k12_fns[f"escape_{family}_{kind}"] = [
                lambda impl=impl, params=params, kw=kw, **extra: impl(
                    params, device=dev, **kw, **extra)
                for impl in (escape.escape_fields_cuda,
                             escape.escape_fields_plain)]
    dd_fn = (lambda **extra: dd_escape.dd_escape_fields_cuda(
        dd_params, **dd_frame, **extra))
    k12_fns["dd_escape_mandelbrot"] = [
        dd_fn, lambda: dd_escape.dd_escape_fields_plain(dd_params,
                                                        **dd_frame)]
    k12_reps = {name: (50 if name == "escape_mandelbrot_fused" else
                       5 if name.startswith("dd_") else 20)
                for name in k12_fns}
    k12_rec = records_ms(dev, [(name, fns[0], k12_reps[name])
                               for name, fns in k12_fns.items()],
                         ("escape_kernel<",))

    def timed(name, kernel_fn, plain_fn, plain_reps=1):
        reps = k12_reps[name]
        ms = {}
        for label, fn, n in (("plain", plain_fn, plain_reps),
                             ("call", kernel_fn, reps),
                             ("call", kernel_fn, reps),
                             ("plain", plain_fn, plain_reps)):
            ms.setdefault(label, []).append(cuda_ms(fn, n))
        e = kernels[name]
        e["ms"], kname = k12_rec[name]
        e["plain_ms"] = statistics.median(ms["plain"])
        print(f"time per {W}x{H} frame, {name}: kernel {e['ms']:.4f} ms by "
              f"its records (mean of {reps} launches of {kname}); call ms "
              f"{statistics.median(ms['call']):.4f} (CUDA events over "
              f"{reps} queued wrapper calls, runs "
              f"{[round(t, 4) for t in ms['call']]}), plain "
              f"{e['plain_ms']:.3f} ms (runs "
              f"{[round(t, 3) for t in ms['plain']]}); "
              f"{W * H / e['ms'] / 1e3:.0f} Mpix/s", flush=True)

    def counters(name, launch, buf, want):
        """Fill ``buf`` with the instance's per-warp counters in one more
        launch, hold their lane iterations to the frame's loop updates
        ``want`` and print them."""
        launch(trips=buf)
        c = escape.decode_trips(buf)
        assert c["lane_iters"] == want, (name, c["lane_iters"], want)
        print(f"counters {name}: {escape_trips_line(c)}", flush=True)

    for family in FAMILIES:
        outs = {}
        for kind in ("fused", "fields"):
            name = f"escape_{family}_{kind}"
            params, kw = k1_frame(family, kind)
            fns = k12_fns[name]
            timed(name, *fns)
            outs[kind] = fns[0]()
            counters(name, fns[0], escape.trips_buffer(W, H, dev),
                     k1_lane_iters(params, kw, dev))
        # the iterations each frame needs: sum(n), less the pixels the
        # fused Mandelbrot frame skips as provably interior
        torch.cuda.synchronize()
        n = outs["fields"][0].double()
        skipped = (escape.interior_skip_mask(
            params, width=W, height=H, map_height=H, row0=0, device=dev)
            if family == "mandelbrot"
            else torch.zeros_like(n, dtype=torch.bool))
        for kind, iters in (("fused", float(n[~skipped].sum())),
                            ("fields", float(n.sum()))):
            name = f"escape_{family}_{kind}"
            set_bound(name, iters, OPS_PER_ITER[name],
                      W * H * OPS_PER_PIXEL[kind],
                      sum(t.numel() * t.element_size() for t in outs[kind]),
                      extra=f" (sum n; {int(skipped.sum())} skipped pixels "
                      "excluded)" if kind == "fused" and skipped.any()
                      else " (sum n)")
    timed("dd_escape_mandelbrot", *k12_fns["dd_escape_mandelbrot"])
    counters("dd_escape_mandelbrot", dd_fn, dd_escape.trips_buffer(W, H, dev),
             int(dd_n.clamp(max=DD_VIEW["iters"] - 1).double().sum()))
    set_bound("dd_escape_mandelbrot", dd_work[0],
              OPS_PER_ITER["dd_escape_mandelbrot"], W * H * OPS_PER_PIXEL["dd"],
              dd_work[1], extra=" (sum n)")

    # K3: each case's full frame by its kernel records, the mean of a run
    # of launches (one profiler session for every case, in turn); the call
    # ms (CUDA events around one wrapper call, which also hold its host
    # work: packing, the orbit table, zeroed planes) beside it, median of
    # 3; the plain version's time is its 64-row band's in the K3 phase
    k3_cases = []
    for ci, params, dstreams, launch, *_ in pert_frames:
        k3_cases.append((("pert", ci),
                         lambda p=params, d=dstreams, l=launch: k3(p, d, l),
                         5))
    for ci, params, dstreams, launch in form_frames:
        k3_cases.append((("form", ci),
                         lambda p=params, d=dstreams, l=launch: k3(p, d, l),
                         5))
    k3_cases.append((("stacked", 0), lambda: k3(*stacked_frame), 3))
    k3_rec = records_ms(dev, k3_cases, ("pert_kernel<",))
    plain_band = {ci: pm for ci, *_, pm in pert_frames}
    for (kind, ci), fn, reps in k3_cases:
        name, label = ((STACKED, "config 4, 4 segments in one launch")
                       if kind == "stacked" else
                       (PERT_CASES if kind == "pert" else FORM_CASES)[ci][:2])
        ms, kname = k3_rec[(kind, ci)]
        pw, ph = ((W, H) if kind == "stacked"
                  else (PERT_CASES if kind == "pert" else FORM_CASES)[ci][3:5])
        calls = [cuda_event_ms(fn)[1] for _ in range(3)]
        e = kernels[name]
        if e["ms"] is None:  # the instance's first (main) frame
            e["ms"] = ms
        print(f"time per {pw}x{ph} frame, {name} {label}: kernel {ms:.4f} ms "
              f"by its records (mean of {reps} launches of {kname}); call "
              f"ms {statistics.median(calls):.4f} (CUDA events around one "
              f"wrapper call, runs {[round(t, 4) for t in calls]}); "
              f"{pw * ph / ms / 1e3:.2f} Mpix/s"
              + (f"; plain version on its {pw}x{BAND_ROWS} band: "
                 f"{plain_band[ci]:.1f} ms" if kind == "pert" else ""),
              flush=True)
    one, two = k3_rec[("pert", 1)][0], k3_rec[("stacked", 0)][0]
    print(f"{STACKED} against the spp-1 config-4 launch by kernel records: "
          f"{two:.4f} / {one:.4f} ms = {two / one:.3f} (4 samples per "
          "pixel)", flush=True)
    for name, (iters, n_skip, pixels, nbytes, *form) in pert_work.items():
        cont, what = form if form else (0.0, f"sum(n - n_skip), n_skip "
                                              f"{n_skip}")
        set_bound(name, iters, OPS_PER_ITER[name.replace("_spp2", "")],
                  pixels * OPS_PER_PIXEL["pert"] + cont * OPS_CONT, nbytes,
                  extra=f" ({what}" + (
                      f"; {cont:.6g} continuation steps x {OPS_CONT}"
                      if cont else "") + ")")

    # K4a and K4b: each instance's 1080p frame by its kernel records (one
    # session, the mean of a run of launches each), with K4a's one-lane
    # launches (the schedule floor and the fixed floor); the call ms beside
    # them (CUDA events around one wrapper call, median of 3); the plain
    # versions' times are the K4 phase's (K4a's whole coarse grid, K4b's
    # 64-row band)
    k4_cases = []
    for tag, _, _ in BULB_CASES:
        params, cparams, ckw, mkw, ip, st, tr, lanes = bulb_frames[tag]
        tc = bulb_kernel.cone_fields_cuda(cparams, **ckw)
        k4_cases += [
            (f"bulb_cone_{tag}", lambda c=cparams, k=ckw:
             bulb_kernel.cone_fields_cuda(c, **k), 50),
            (f"bulb_march_{tag}", lambda p=params, t=tc, k=mkw:
             bulb_kernel.march_fields_cuda(p, t, stats=False, **k), 10),
            *((f"bulb_cone_{tag} {which}", lambda c=v[4], k=v[5]:
               bulb_kernel.cone_fields_cuda(c, **k), 50)
              for which, v in lanes.items())]
    k4_rec = records_ms(dev, k4_cases,
                        ("bulb_cone_kernel<", "bulb_march_kernel<"))
    for key, fn, reps in k4_cases:
        ms, kname = k4_rec[key]
        if key in kernels:
            calls = [cuda_event_ms(fn)[1] for _ in range(3)]
            kernels[key]["ms"] = ms
            print(f"time per {W}x{H} frame, {key}: kernel {ms:.5f} ms by its "
                  f"records (mean of {reps} launches of {kname}); call ms "
                  f"{statistics.median(calls):.4f} (CUDA events around one "
                  f"wrapper call, runs {[round(t, 4) for t in calls]}); plain "
                  f"version {kernels[key]['plain_ms']:.1f} ms on "
                  + ("the whole coarse grid" if "cone" in key else
                     f"its {W}x{bh} band"), flush=True)
    for tag, label, _ in BULB_CASES:
        params, cparams, ckw, mkw, ip, st, tr, lanes = bulb_frames[tag]
        # the issue slots the card had per warp trip of the frame: the
        # kernel's time x the SM clock x 4 schedulers per SM, over the trips
        tc = bulb_kernel.cone_fields_cuda(cparams, **ckw)
        mhz = sm_clock_mhz(lambda: bulb_kernel.march_fields_cuda(
            params, tc, stats=False, **mkw))
        slots = (kernels[f"bulb_march_{tag}"]["ms"] * 1e-3 * mhz * 1e6 * 4
                 * torch.cuda.get_device_properties(dev).multi_processor_count)
        print(f"K4b {tag}: SM clock {mhz} MHz under load; "
              f"{slots:.4g} issue slots in the kernel's time, "
              f"{slots / tr['trips']:.1f} per warp trip ({tr['step_trips']} "
              f"step trips, {tr['event_trips']} event trips)", flush=True)
        ops_de = bulb_ops_per_iter(ip)
        cone = f"bulb_cone_{tag}"
        set_bound(cone, st["c_work"], ops_de,
                  st["c_evals"] * OPS_BULB_EVAL,
                  4 * ckw["coarse_w"] * ckw["coarse_h"] + 4 * len(cparams),
                  extra=f" (sum(work) of the plain version; "
                  f"{st['c_evals']:.0f} evaluations x {OPS_BULB_EVAL})")
        # K4a's one-lane records: the heaviest lane alone is the launch's
        # schedule floor (one wave of 136 blocks, so the launch cannot end
        # before its longest lane), not a bound: it is the kernel under
        # test.  Its bound from outside the kernel is the heaviest lane's
        # dependent chain in the SASS at measured latencies
        # (tools/sass_chain_model.py, which reads these lines).
        floor = k4_rec[f"{cone} heaviest"][0]
        fixed = k4_rec[f"{cone} lightest"][0]
        e = kernels[cone]
        h, lt = lanes["heaviest"], lanes["lightest"]
        print(f"K4a {tag} {label}: kernel {e['ms']:.5f} ms by its records; "
              f"the heaviest lane alone ({h[0]}, {h[1]}: {h[2]} evaluations "
              f"+ {h[3]} DE iterations) {floor:.5f} ms, the schedule floor; "
              f"the lightest alone ({lt[0]}, {lt[1]}: {lt[2]} + {lt[3]}) "
              f"{fixed:.5f} ms, the launch's fixed floor; kernel / schedule "
              f"floor {e['ms'] / floor:.2f}x", flush=True)
        set_bound(f"bulb_march_{tag}", st["work"], ops_de,
                  st["evals"] * OPS_BULB_EVAL + st["hits"] * OPS_BULB_HIT,
                  8 * 4 * W * H + 4 * tc.numel() + 4 * len(params),
                  extra=f" (sum(work); {st['evals']:.0f} evaluations x "
                  f"{OPS_BULB_EVAL}, {st['hits']} hits x {OPS_BULB_HIT})")

    set_bound("compile_probe", 0, 0, 0, 2 * 16 * 128 * 4,
              extra=" (16 x 128 f32 in and out)")

    lap("timing")

    missing = [k for k, e in kernels.items() if e["launches"] == 0]
    assert not missing, f"instances no path launched: {missing}"
    print(f"profiler sessions taken again for want of device events: "
          f"{diag.measure_device_seconds.retries}", flush=True)
    assert len(kernels) == 35, \
        f"expected K1 x8, K2, K3 x12 + its stacked spp-2 launch + the two " \
        f"ledger and three single-pass instances, K4a x3, K4b x3, K5 and " \
        f"K6: {list(kernels)}"
    assert all(e["bound_ms"] and e["ms"] and e["plain_ms"]
               for e in kernels.values()), kernels
    print(f"smoke wall time {time.monotonic() - t_start:.1f} s (build "
          f"included)", flush=True)
    print(bench_all.card(dev))
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
