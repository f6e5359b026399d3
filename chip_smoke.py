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
its secondary references on Seahorse and configs 4 and 7),
checks that each path launched its kernels and that each PNG is within 1
LSB of the same pipeline run on the plain versions, and times kernel
against plain version with CUDA events.  For each instance it prints the
DE or escape iterations the timed frame needs and the bound: the larger of
their f32 operations over the card's FP32 peak (the data sheet's 67
TFLOP/s, or the rate K5 measured in this run where that is higher; the
measured rate is printed beside it) and the frame's bytes over 3.35 TB/s.
Before those phases: the diagnostics (the parameter-layout selfcheck
against the CUDA sources; the profiler's device lane of the frames the
bench times, each against the CUDA-event times of its kernels' launches
in the same run; the link probe), the bench path (bench_all's configs 0,
1, 2, 4, 6 and 7, which launch K6 and K5 -- config 1 measures the FP32
rate once, with measure_vpu_peak, and it must exceed half the data sheet's
67 TFLOP/s -- with their launch counts reset before and read after, and
``python -m fractalrenderer_tpu_torch.bench``), and ``cli info`` and ``cli
presets``.
Each phase prints one line; any failure raises, so the exit code is
non-zero and no result line is printed.  On success the last three lines
are the card's name and power limit, a JSON line describing each kernel
instance, and ``{"ok": true, "device": {...}}``.  Imports no JAX.
"""
from __future__ import annotations

import contextlib
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
# used as a value (min/max/abs), and math-library call counts one.
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
    # csrc/dd_escape.cu: ddc_square_add (3 dd_mul of 24, 3 dd_add of 11,
    # 2) + ddc_mag2 (8)
    "dd_escape_mandelbrot": 115,
    # csrc/pert_kernel.cuh, one delta step, with dd_mul 24, dd_add 11,
    # dd_mul_float 22 (csrc/dd.cuh) and the floatexp ops of csrc/floatexp.cuh
    # (rfe_add 18, rfe_mul 27, cfe_mul 126, cfe_add 38, a renormalisation
    # 3-8): Mandelbrot f32; dd (7 dd_mul, 6 dd_add, the rebase test);
    # floatexp (the dd step + alignment)
    "pert_mandelbrot_f32": 29, "pert_mandelbrot_dd": 267,
    "pert_mandelbrot_fx": 291,
    # Julia: Z = Z0 + D (f32 2, dd 2 dd_add), no dc; floatexp: two cfe_mul,
    # a cfe_add and the rfe composition of Z and of rel = D + d
    "pert_julia_f32": 31, "pert_julia_dd": 271, "pert_julia_fx": 419,
    # Burning Ship: two diffabs and the dx'/dy' products (dd: 5 dd_mul, 7
    # dd_add; floatexp: 6 rfe_mul, 9 rfe_add, the sign tests' 4 rfe_add)
    "pert_ship_f32": 37, "pert_ship_dd": 264, "pert_ship_fx": 398,
    # Phoenix: the Mandelbrot step + p d + r d_prev (dd: 4 dd_mul_float and
    # 4 dd_add more)
    "pert_phoenix_f32": 39, "pert_phoenix_dd": 399, "pert_phoenix_fx": 435,
    # the Burning Ship's error ledger: two log2f, the |2z| and |d'|
    # squares, the floor and the max (dd 18 more, floatexp 16 more)
    "pert_ship_dd_err": 282, "pert_ship_fx_err": 414,
    # the single pass: the Mandelbrot step without the rebase test (f32
    # and dd 4 fewer, floatexp 6 fewer) and with the Pauldelbrot test
    # (|z|^2, |Z|^2, the product and the compare: 8)
    "pert_mandelbrot_f32_single": 33, "pert_mandelbrot_dd_single": 271,
    "pert_mandelbrot_fx_single": 293,
}
# one step of the single pass's f32 float continuation: z^2 + c and |z|^2
OPS_CONT = 10
# per pixel outside the loop: the mapping, and the fused colour + post chain
OPS_PER_PIXEL = {"fused": 90, "fields": 12, "dd": 60, "pert": 80}
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


def read_png_rgb8(path: str):
    """Decode the port's own PNGs (8-bit RGB, filter type 0 on every row)."""
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
            assert (depth, ctype) == (8, 2), (depth, ctype)
        elif tag == b"IDAT":
            idat += payload
    rows = np.frombuffer(zlib.decompress(idat), np.uint8)
    rows = rows.reshape(height, 1 + width * 3)
    assert (rows[:, 0] == 0).all(), "unexpected PNG row filter"
    return rows[:, 1:].reshape(height, width, 3)


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


def ptxas_report(log: str) -> dict:
    """Registers, stack frame and spill bytes of each kernel instance from
    the ``-Xptxas=-v`` build log, by instance name."""
    families = list(FAMILIES)
    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"escape_kernelILi(\d)ELb([01])E", m.group(1))
            t = re.search(r"pert_kernelILi(\d)ELi(\d)ELi(\d)E",
                          m.group(1))
            b = re.search(r"bulb_(cone|march)_kernelILi(\d+)E", m.group(1))
            c = re.search(r"peak_kernelILi(\d+)E", m.group(1))
            if c:
                name = f"fma_peak_c{c.group(1)}"
            elif b:
                p = int(b.group(2))
                name = f"bulb_{b.group(1)}_" + (f"p{p}" if p else "trig")
            elif k:
                name = (f"escape_{families[int(k.group(1))]}_"
                        + ("fused" if k.group(2) == "1" else "fields"))
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


def k6_phase(dev, entry) -> None:
    """K6 built twice with two salts, each output checked, the main
    library's path unchanged; the kernel, its plain version and the one
    PyTorch call of the same function timed (mean of 100 launches)."""
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
    e = entry("compile_probe", PROBE_SRC, K6_TPU, 0.0)
    e.update(ms=cuda_ms(lambda: _cuda.compile_probe_cuda(lib, x), 100),
             plain_ms=cuda_ms(lambda: _cuda.compile_probe_plain(x, salt),
                              100),
             library_ms=cuda_ms(lambda: torch.add(x.new_ones(()), x,
                                                  alpha=salt), 100))
    print("K6 compile probe: " + "; ".join(
        f"salt {p['salt']:.0f}: nvcc + load {p['build_seconds']:.3f} s, "
        f"call to fetched scalar {p['seconds']:.3f} s, out = x * salt + 1 "
        "bit-equal" for p in probes)
        + f"; the library path unchanged; kernel {e['ms'] * 1e3:.2f} us, "
        f"plain {e['plain_ms'] * 1e3:.2f} us, torch.add(1, x, alpha=salt) "
        f"{e['library_ms'] * 1e3:.2f} us per launch (mean of 100)",
        flush=True)


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
    ms, the events' ms)."""
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
    print(f"device lane of {label}: {lane:.4f} ms; its {launches} launch(es) "
          f"of the port's kernels: {rec_ms:.4f} ms by their profiler "
          f"records, {events:.4f} ms by CUDA events around the same "
          f"launches; other device work {lane - rec_ms:.4f} ms", flush=True)
    assert launches == len(spans) > 0, (label, launches, len(spans))
    assert rec_ms <= events, (label, rec_ms, events)
    assert lane >= rec_ms, (label, lane, rec_ms)
    return lane, events


def diagnostics_phase(dev) -> None:
    """The parameter-layout selfcheck; the device lane of the frames the
    bench times (the main path, a Julia frame, config 4, config 6) against
    the CUDA events of their kernels' launches in the same run; the main
    path's lane against K1's CUDA-event time (mean of 50 queued launches:
    at least it, within 2x of it); the link probe, pageable and pinned."""
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
                                         prefixes)[0])
    params = escape.pack_params(center_x=-0.5, center_y=0.0, zoom=3.0,
                                iter_limit=ITERS)
    k1_ms = cuda_ms(lambda: escape.escape_fields_cuda(
        params, width=W, height=H, map_height=H, row0=0, max_iter_cap=ITERS,
        interior_skip=True, fused_color=(0, 0, False, True), device=dev), 50)
    print(f"the main-path frame's device lane {lanes[0]:.4f} ms against K1 "
          f"by CUDA events (mean of 50 queued launches) {k1_ms:.4f} ms "
          f"({lanes[0] / k1_ms:.2f}x)", flush=True)
    assert k1_ms <= lanes[0] <= 2 * k1_ms, (lanes[0], k1_ms)
    link = diag.measure_link_bandwidth(mb=96, reps=3, device=dev)
    assert link["best_mb_s"] > 0 and link["pinned_best_mb_s"] > 0, link
    print(f"measure_link_bandwidth 96 MiB: pageable best "
          f"{link['best_mb_s']:.1f} MB/s (mean {link['mean_mb_s']:.1f}), "
          f"pinned best {link['pinned_best_mb_s']:.1f} MB/s (mean "
          f"{link['pinned_mean_mb_s']:.1f}); a 1080p RGB8 frame "
          f"({3 * W * H} B) at the pageable best: "
          f"{3 * W * H / link['best_mb_s'] / 1e3:.3f} ms", flush=True)


def bench_phase(dev, kernels) -> float:
    """bench_all's configs 0, 1, 2, 4, 6 and 7 (K6 runs in config 0, K5 in
    config 1: their launch counts are reset before and read after), each
    row printed; then ``python -m fractalrenderer_tpu_torch.bench``.
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
    for num in (0, 1, 2, 4, 6, 7):
        t0 = time.monotonic()
        rows[num] = bench_all.CONFIGS[num](device=dev)
        print(f"bench_all config{num} ({time.monotonic() - t0:.1f} s): "
              + json.dumps(rows[num]), flush=True)
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
    from fractalrenderer_tpu_torch.deepzoom import series as series_mod
    from fractalrenderer_tpu_torch.deepzoom.hp import (
        HPFloat, precision_mode_for_zoom_frac)
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
    k6_phase(dev, entry)
    diagnostics_phase(dev)
    k5_rate = bench_phase(dev, kernels)
    peak_f32 = max(k5_rate, SPEC_F32_OPS)  # the card's FP32 peak
    set_bound("fma_peak", PEAK_K * diag.PEAK_SHAPE[0] * diag.PEAK_SHAPE[1],
              2 * PEAK_CHAINS, 0, 2 * 4 * diag.PEAK_SHAPE[0]
              * diag.PEAK_SHAPE[1], extra=f" (k x N, {PEAK_CHAINS} chains)")
    verbs_phase()

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
    print(f"dd fields {W}x{H} seahorse at {DD_VIEW['zoom']} x"
          f"{DD_VIEW['iters']}: n/zx/zy bit-equal (n mean "
          f"{got[0].float().mean():.1f}, {int((got[0] < DD_VIEW['iters']).sum())}"
          " escaped)", flush=True)

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

    def pert_setup(view, width, height, series, exact_dust=False):
        """The orbit, series and packing options the deep-zoom model
        derives for ``view`` at width x height
        (models/deep_zoom.render_fields): the family's recurrence, the Julia
        drift (floatexp-emitted in the ARBITRARY tier) and start Z0, and
        the exact-dust tier's raised orbit precision."""
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
        mkw = dict(width=W, height=H, map_height=H, cone=CONE, shade=True,
                   int_power=ip, device=dev)
        full = bulb_kernel.march_fields_cuda(params, tc, stats=True, **mkw)
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
        bulb_frames[tag] = (params, cparams, ckw, mkw, ip, st)
        print(f"K4 {tag} {label} {W}x{H}: K4a grid {ckw['coarse_h']}x"
              f"{ckw['coarse_w']} bit-equal to the plain version (plain "
              f"{cone_plain_ms:.1f} ms; {st['c_evals']:.0f} evaluations, "
              f"{st['c_work']:.0f} DE iterations); K4b hit/t/d/esc/nx/ny/"
              f"nz/ao/msteps/work bit-equal to the plain version over rows "
              f"{r0}-{r0 + bh - 1} (plain band {band_plain_ms / 1e3:.2f} "
              f"s) and equal to the whole frame's rows; hit fraction "
              f"{st['hits'] / (W * H):.4f}, lanes at the 200-step cap "
              f"{st['cap']}, msteps max {int(msteps.max())}, sum(work) "
              f"{st['work']:.6g} DE iterations ({st['work'] / (W * H):.2f} "
              f"per pixel, max {int(work.max())}), warp-max waste "
              f"sum(warp max)/sum(work) {st['warp'] / st['work']:.3f}",
              flush=True)

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
            img = read_png_rgb8(out)
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

    # -- time per 1080p frame, each instance against its plain version -------
    def timed(name, kernel_fn, plain_fn, kernel_reps=20, plain_reps=1):
        ms = {}
        for label, fn, reps in (("plain", plain_fn, plain_reps),
                                ("kernel", kernel_fn, kernel_reps),
                                ("kernel", kernel_fn, kernel_reps),
                                ("plain", plain_fn, plain_reps)):
            ms.setdefault(label, []).append(cuda_ms(fn, reps))
        e = kernels[name]
        e["ms"] = statistics.median(ms["kernel"])
        e["plain_ms"] = statistics.median(ms["plain"])
        print(f"time per {W}x{H} frame, {name}: kernel {e['ms']:.4f} ms "
              f"(runs {[round(t, 4) for t in ms['kernel']]}), plain "
              f"{e['plain_ms']:.3f} ms (runs "
              f"{[round(t, 3) for t in ms['plain']]}); "
              f"{W * H / e['ms'] / 1e3:.0f} Mpix/s", flush=True)

    for family, spec in FAMILIES.items():
        params = escape.pack_params(family=family, iter_limit=ITERS,
                                    **spec["view"])
        frame = dict(width=W, height=H, map_height=H, row0=0,
                     max_iter_cap=ITERS, interior_skip=family == "mandelbrot",
                     device=dev, family=family)
        fused = (0, 0, family != "mandelbrot", True)
        timed(f"escape_{family}_fused",
              lambda: escape.escape_fields_cuda(params, fused_color=fused,
                                                **frame),
              lambda: escape.escape_fields_plain(params, fused_color=fused,
                                                 **frame),
              kernel_reps=50 if family == "mandelbrot" else 20)
        rgb = escape.escape_fields_cuda(params, fused_color=fused, **frame)
        frame.update(interior_skip=False, **spec["track"])
        timed(f"escape_{family}_fields",
              lambda: escape.escape_fields_cuda(params, fused_color=None,
                                                **frame),
              lambda: escape.escape_fields_plain(params, fused_color=None,
                                                 **frame))
        # the iterations each frame needs: sum(n), less the pixels the
        # fused Mandelbrot frame skips as provably interior
        fields = escape.escape_fields_cuda(params, fused_color=None, **frame)
        torch.cuda.synchronize()
        n = fields[0].double()
        skipped = (escape.interior_skip_mask(
            params, width=W, height=H, map_height=H, row0=0, device=dev)
            if family == "mandelbrot"
            else torch.zeros_like(n, dtype=torch.bool))
        for kind, iters, outs in (
                ("fused", float(n[~skipped].sum()), rgb),
                ("fields", float(n.sum()), fields)):
            name = f"escape_{family}_{kind}"
            set_bound(name, iters, OPS_PER_ITER[name],
                      W * H * OPS_PER_PIXEL[kind],
                      sum(t.numel() * t.element_size() for t in outs),
                      extra=f" (sum n; {int(skipped.sum())} skipped pixels "
                      "excluded)" if kind == "fused" and skipped.any()
                      else " (sum n)")
    timed("dd_escape_mandelbrot",
          lambda: dd_escape.dd_escape_fields_cuda(dd_params, **dd_frame),
          lambda: dd_escape.dd_escape_fields_plain(dd_params, **dd_frame),
          kernel_reps=5)
    set_bound("dd_escape_mandelbrot", dd_work[0],
              OPS_PER_ITER["dd_escape_mandelbrot"], W * H * OPS_PER_PIXEL["dd"],
              dd_work[1], extra=" (sum n)")

    # K3: each case's full frame, one CUDA-event pair per launch, median of
    # 7; the plain version's time is its 64-row band's in the K3 phase
    for ci, params, dstreams, launch, plain_ms in pert_frames:
        name, label = PERT_CASES[ci][:2]
        pw, ph = launch["width"], launch["height"]
        runs = [cuda_event_ms(lambda: k3(params, dstreams, launch))[1]
                for _ in range(7)]
        ms = statistics.median(runs)
        e = kernels[name]
        if e["ms"] is None:  # the instance's first (main) frame
            e["ms"] = ms
        print(f"time per {pw}x{ph} frame, {name} {label}: kernel {ms:.3f} ms "
              f"(runs {[round(t, 3) for t in runs]}); {pw * ph / ms / 1e3:.2f}"
              f" Mpix/s; plain version on its {pw}x{BAND_ROWS} band: "
              f"{plain_ms:.1f} ms", flush=True)
    for ci, params, dstreams, launch in form_frames:
        name, label = FORM_CASES[ci][:2]
        pw, ph = launch["width"], launch["height"]
        runs = [cuda_event_ms(lambda: k3(params, dstreams, launch))[1]
                for _ in range(7)]
        ms = statistics.median(runs)
        e = kernels[name]
        if e["ms"] is None:  # the instance's first (main) frame
            e["ms"] = ms
        print(f"time per {pw}x{ph} frame, {name} {label}: kernel {ms:.3f} ms "
              f"(runs {[round(t, 3) for t in runs]}); {pw * ph / ms / 1e3:.2f}"
              f" Mpix/s", flush=True)
    # config 4's stacked spp-2 launch against its spp-1 launch, in turns
    one, two = [], []
    c4 = pert_frames[1]
    for _ in range(7):
        one.append(cuda_event_ms(lambda: k3(c4[1], c4[2], c4[3]))[1])
        two.append(cuda_event_ms(lambda: k3(*stacked_frame))[1])
    kernels[STACKED]["ms"] = statistics.median(two)
    ratio = statistics.median(two) / statistics.median(one)
    print(f"time per {W}x{H} frame, {STACKED} config 4, 4 segments in one "
          f"launch: kernel {statistics.median(two):.3f} ms (runs "
          f"{[round(t, 3) for t in two]}); the spp-1 launch in turn "
          f"{statistics.median(one):.3f} ms (runs "
          f"{[round(t, 3) for t in one]}); spp 2 / spp 1 = {ratio:.3f} (4 "
          "samples per pixel)", flush=True)
    for name, (iters, n_skip, pixels, nbytes, *form) in pert_work.items():
        cont, what = form if form else (0.0, f"sum(n - n_skip), n_skip "
                                              f"{n_skip}")
        set_bound(name, iters, OPS_PER_ITER[name.replace("_spp2", "")],
                  pixels * OPS_PER_PIXEL["pert"] + cont * OPS_CONT, nbytes,
                  extra=f" ({what}" + (
                      f"; {cont:.6g} continuation steps x {OPS_CONT}"
                      if cont else "") + ")")

    # K4a and K4b: each instance's 1080p frame, one CUDA-event pair per
    # launch, median of 7; the plain versions' times are the K4 phase's
    # (K4a's whole coarse grid, K4b's 64-row band)
    for tag, label, _ in BULB_CASES:
        params, cparams, ckw, mkw, ip, st = bulb_frames[tag]
        tc = bulb_kernel.cone_fields_cuda(cparams, **ckw)
        for name, fn in (
                (f"bulb_cone_{tag}",
                 lambda: bulb_kernel.cone_fields_cuda(cparams, **ckw)),
                (f"bulb_march_{tag}",
                 lambda: bulb_kernel.march_fields_cuda(params, tc,
                                                       stats=False, **mkw))):
            fn()
            runs = [cuda_event_ms(fn)[1] for _ in range(7)]
            kernels[name]["ms"] = statistics.median(runs)
            print(f"time per {W}x{H} frame, {name} {label}: kernel "
                  f"{kernels[name]['ms']:.4f} ms (runs "
                  f"{[round(t, 4) for t in runs]}); plain version "
                  f"{kernels[name]['plain_ms']:.1f} ms on "
                  + ("the whole coarse grid" if "cone" in name else
                     f"its {W}x{bh} band"), flush=True)
        ops_de = bulb_ops_per_iter(ip)
        set_bound(f"bulb_cone_{tag}", st["c_work"], ops_de,
                  st["c_evals"] * OPS_BULB_EVAL,
                  4 * ckw["coarse_w"] * ckw["coarse_h"] + 4 * len(cparams),
                  extra=f" (sum(work) of the plain version; "
                  f"{st['c_evals']:.0f} evaluations x {OPS_BULB_EVAL})")
        set_bound(f"bulb_march_{tag}", st["work"], ops_de,
                  st["evals"] * OPS_BULB_EVAL + st["hits"] * OPS_BULB_HIT,
                  8 * 4 * W * H + 4 * tc.numel() + 4 * len(params),
                  extra=f" (sum(work); {st['evals']:.0f} evaluations x "
                  f"{OPS_BULB_EVAL}, {st['hits']} hits x {OPS_BULB_HIT})")

    set_bound("compile_probe", 0, 0, 0, 2 * 16 * 128 * 4,
              extra=" (16 x 128 f32 in and out)")

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
