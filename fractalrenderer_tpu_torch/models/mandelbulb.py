"""Mandelbulb renderer — the distance-estimator raymarcher of
shaders/mandelbulb.comp on the CUDA kernels K4a, K4b and K4c (counterpart
of ``fractalrenderer_tpu/models/mandelbulb.py``, its kernel-shaded Pallas
path).

Per AA sample: the cone prepass and the march + shading kernel
(``ops/bulb_kernel.march_fields`` with ``shade``) give hit, t, d, esc,
normals and the AO sum; ``ops/bulb_shade.shade_fields`` colours them, sums
the N×N samples at offsets (sx/aa, sy/aa) and, after the last, runs
enhance → ACES → gamma and the store (f32, or quantized to uint8/uint16).
On the card that is K4c, one launch a sample; on the CPU it is the plain
torch glue.

Every scalar is rounded to f32 first, as the JAX render casts its traced
values: the camera and dynamic power on the host; the kernels take them,
and K4c the colour fields, by value.  So a warm frame on the card makes no
copy and builds no constant: the host computes the camera and issues K4a,
K4b and K4c.  The CPU glue reads the same scalars as 0-dim tensors from
one vector per frame (``bulb_shade.upload_scalars``), and its constants
from ``ops/consts.f32``.

A frame's stages are spans (``utils.diag.span``): ``bulb.prepare`` (the
camera and the sample vector; on the CPU also the glue's vector and each
sample's ray grid), ``k4a.launch`` and ``k4b.launch`` (in
``ops/bulb_kernel.march_fields``), ``bulb.shade`` (K4c, or the CPU's
``shade_hit``, ``sky_color`` and select) and, on the CPU, ``bulb.post``
(the AA sum, the post chain, the quantize), all inside ``render``'s
``bulb.frame``.
"""
from __future__ import annotations

import math
from dataclasses import replace

import numpy as np
import torch

from ..ops import bulb_math as bm
from ..ops import bulb_shade as bs
from ..ops import consts
from ..ops.bulb_kernel import march_fields
from ..scene import Scene
from ..utils.diag import span

# The camera/power/colour fields the JAX render traces (one compile serves
# a whole animation there); here they are the f32 scalars of a frame.
_DYN_FIELDS = ("camera_distance", "rotation_y", "power", "time", "fov",
               "rotation_speed", "color_offset", "color_scale",
               "brightness", "saturation", "contrast")


def _bulb_params(scene: Scene) -> bm.BulbParams:
    return bm.BulbParams(
        camera_distance=scene.camera_distance,
        rotation_y=scene.rotation_y,
        power=scene.mandelbulb_power,
        max_iterations=scene.max_iterations,
        color_offset=scene.color_offset,
        color_scale=scene.color_scale,
        palette_mode=scene.palette_mode,
        time=scene.time,
        fov=scene.fov,
        brightness=scene.color_brightness,
        saturation=scene.color_saturation,
        contrast=scene.color_contrast,
        aa_samples=max(scene.antialiasing_samples, 1),
    ).clamped()


def _static_int_power(p: bm.BulbParams):
    """The host-side trig-free-DE gate: the kernel specializes on an
    integer DYNAMIC power (power + 0.5·sin(0.7·time)), decided from host
    floats."""
    dyn_power = p.power + 0.5 * math.sin(p.time * 0.7)
    return int(dyn_power) if float(dyn_power).is_integer() \
        and 2.0 <= dyn_power <= 16.0 else None


def dyn_params(scene: Scene) -> dict:
    """The per-frame parameter dict consumed by :func:`band_render_fn`
    (host floats)."""
    p = _bulb_params(scene)
    return {k: float(getattr(p, k)) for k in _DYN_FIELDS}


def band_render_fn(scene: Scene, width: int, band_h: int, full_h: int,
                   device="cuda", quantize: int = 0):
    """Build ``fn(dyn, row0)`` rendering ``band_h`` rows whose global first
    row is ``row0`` of a ``full_h``-row image — the signature of
    models.common.band_render_fn; ``dyn`` is :func:`dyn_params`'s dict.
    Returns f32 (band_h, W, 3) on ``device``, or with ``quantize`` 8/16 the
    band quantized to uint8/uint16."""
    base = _bulb_params(scene)
    int_power = _static_int_power(base)
    # the CPU glue reads its scalars and rays as tensors; K4c takes the
    # scalars by value and recomputes each ray
    plain = torch.device(device).type != "cuda"
    if not plain:
        from ..ops._cuda import cuda_device

        cuda_device(device)  # raises before any tensor is made

    def fn(dyn, row0: int):
        row0 = int(row0)
        builds = consts.f32.builds
        with span("bulb.prepare"):
            # the frame's scalars as f32 (the JAX render's traced values)
            p = replace(base, **{k: np.float32(dyn[k]) for k in _DYN_FIELDS})
            ro, dyn_power = bm.camera_setup(p)
            aa = p.aa_samples
            offsets = [(sx / aa, sy / aa) for sy in range(aa)
                       for sx in range(aa)]
            params = [bs.pack_shade_params(p, ro, dyn_power, off)
                      for off in offsets]
            scalars = None
            if plain:
                scalars = bs.upload_scalars(params[0], device)
                render.param_uploads += 1
        out = None
        for i, off in enumerate(offsets):
            rays = None
            if plain:
                with span("bulb.prepare"):
                    rays = bs.sample_rays(scalars, params[i], width, band_h,
                                          row0, full_h)
            f = march_fields(width, band_h, ro=ro, fov=p.fov,
                             power=dyn_power, max_iter=p.max_iterations,
                             offset=off, row0=row0, map_height=full_h,
                             shade=True, int_power=int_power, device=device)
            out = bs.shade_fields(f, out, params[i], aa=aa,
                                  last=i == len(offsets) - 1, row0=row0,
                                  map_height=full_h,
                                  palette_mode=p.palette_mode,
                                  quantize=quantize, scalars=scalars,
                                  rays=rays)
        render.const_builds += consts.f32.builds - builds
        return out

    return fn


def band_renderer(scene: Scene, width: int, height: int, *, device="cuda",
                  orbit_cache=None):
    """The bulb's ``models.band_renderer`` (``orbit_cache`` unused), through
    :func:`band_render_fn`: K4a's cone blocks are aligned to the image, not
    to the band, so every band equals the same rows of the whole frame."""
    dyn = dyn_params(scene)
    return lambda row0, rows: band_render_fn(scene, width, rows, height,
                                             device=device)(dyn, row0)


def render(scene: Scene, width: int, height: int, device="cuda",
           quantize: int = 0) -> torch.Tensor:
    """Render the bulb on ``device``: f32 (H, W, 3) in [0, 1], or with
    ``quantize`` 8/16 the image quantized on the device (on the card by
    K4c's store).  The default scene (power 8, time 0) takes the trig-free
    integer DE step; a non-integer dynamic power (time != 0) the
    polynomial-trig step.

    The call runs in the span ``bulb.frame``; ``render.frames`` counts the
    frames finished.  On the CPU every frame or band
    (``band_render_fn``'s, ``band_renderer``'s too) adds one to
    ``render.param_uploads``, its copy of the glue's vector; every bulb
    frame or band adds to ``render.const_builds`` the constant tensors it
    built (``ops/consts.f32``'s misses): a warm frame builds none, and a
    frame on the card uploads nothing."""
    with span("bulb.frame"):
        img = band_render_fn(scene, width, height, height, device=device,
                             quantize=quantize)(dyn_params(scene), 0)
    render.frames += 1
    return img


render.frames = 0
render.param_uploads = 0
render.const_builds = 0
