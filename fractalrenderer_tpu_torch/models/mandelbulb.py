"""Mandelbulb renderer — the distance-estimator raymarcher of
shaders/mandelbulb.comp on the CUDA kernels K4a and K4b (counterpart of
``fractalrenderer_tpu/models/mandelbulb.py``, its kernel-shaded Pallas
path).

Per AA sample: the cone prepass and the march + shading kernel
(``ops/bulb_kernel.march_fields`` with ``shade``) give hit, t, d, esc,
normals and the AO sum; ``bulb_math.shade_hit``/``sky_color`` colour them
as tensor glue.  The N×N samples at offsets (sx/aa, sy/aa) are summed,
divided by a device tensor, and run through enhance → ACES → gamma.

Every scalar is rounded to f32 first, as the JAX render casts its traced
values: the camera and dynamic power on the host (the kernels take them
by value), the colour parameters, dynamic power and camera origin also as
f32 tensors on the device for the glue.  Those 15 values reach the card
as one vector, copied from a fresh pinned host tensor without waiting for
the stream; the glue's constants come from ``ops/consts.f32``, built once
per device.  So a warm frame makes no synchronising copy, and the host
queues the shading behind K4b.

A frame's stages are spans (``utils.diag.span``): ``bulb.prepare`` (the
camera, the frame's vector, the ray grid and its directions), ``k4a.launch``
and ``k4b.launch`` (in ``ops/bulb_kernel.march_fields``), ``bulb.shade``
(``shade_hit``, ``sky_color`` and the select) and ``bulb.post`` (the AA
sum and divide, the post chain and the quantize), all inside
``render``'s ``bulb.frame``.
"""
from __future__ import annotations

import math
from dataclasses import replace

import numpy as np
import torch

from ..ops import bulb_math as bm
from ..ops import coloring, consts
from ..ops.bulb_kernel import march_fields
from ..scene import Scene
from ..utils.diag import span

# The camera/power/colour fields the JAX render traces (one compile serves
# a whole animation there); here they are the f32 scalars of a frame.
_DYN_FIELDS = ("camera_distance", "rotation_y", "power", "time", "fov",
               "rotation_speed", "color_offset", "color_scale",
               "brightness", "saturation", "contrast")
_RO_KEYS = ("ro_x", "ro_y", "ro_z")
# the frame's vector on the device: the fields, the dynamic power and the
# camera origin
_VEC_KEYS = (*_DYN_FIELDS, "dyn_power", *_RO_KEYS)


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


def _upload(values, device) -> torch.Tensor:
    """``values`` as one f32 vector on ``device``.  On a CUDA device the
    copy leaves from a fresh pinned host tensor without waiting for the
    stream; the caching host allocator keeps that tensor's block until the
    copy has run, so frames in flight never share a buffer."""
    if torch.device(device).type != "cuda":
        return torch.tensor(values, dtype=torch.float32, device=device)
    host = torch.tensor(values, dtype=torch.float32, pin_memory=True)
    return host.to(device, non_blocking=True)


def _render_sample(p: bm.BulbParams, ro, dyn_power, dyn_t: dict, width: int,
                   height: int, off, row0: int, map_height: int, int_power,
                   device):
    """One AA sample of a band of ``height`` rows from global row ``row0``
    (kernel-shaded path of the JAX ``_render_sample``).  ``p`` holds the
    frame's f32 scalars and ``ro``/``dyn_power`` its camera (numpy);
    ``dyn_t`` the same scalars and the camera origin as device tensors."""
    dev = dyn_t["fov"].device
    with span("bulb.prepare"):
        ro_t = tuple(dyn_t[k] for k in _RO_KEYS)
        f32 = torch.float32
        pyg = torch.arange(height, dtype=f32, device=dev)[:, None] \
            .expand(height, width)
        pxg = torch.arange(width, dtype=f32, device=dev)[None, :] \
            .expand(height, width)
        pxg = pxg + float(np.float32(off[0]))
        pyg = pyg + float(np.float32(off[1]))
        if row0:
            pyg = pyg + float(row0)
        rd = bm.ray_dirs(pxg, pyg, width, map_height, ro_t, dyn_t["fov"])

    f = march_fields(width, height, ro=ro, fov=p.fov, power=dyn_power,
                     max_iter=p.max_iterations, offset=off, row0=row0,
                     map_height=map_height, shade=True, int_power=int_power,
                     device=device)
    with span("bulb.shade"):
        hit = f["hit"] > 0.5
        t = f["t"]
        pos = tuple(o + r * t for o, r in zip(ro_t, rd))
        pt = replace(p, **{k: dyn_t[k] for k in ("color_offset",
                                                 "color_scale", "time")})
        hit_color = bm.shade_hit(pos, (f["nx"], f["ny"], f["nz"]), rd,
                                 f["d"], f["esc"], t, pt,
                                 dyn_t["dyn_power"], ao_sum=f["ao"])
        return torch.where(hit[..., None], hit_color, bm.sky_color(rd))


def band_render_fn(scene: Scene, width: int, band_h: int, full_h: int,
                   device="cuda"):
    """Build ``fn(dyn, row0)`` rendering ``band_h`` rows whose global first
    row is ``row0`` of a ``full_h``-row image — the signature of
    models.common.band_render_fn; ``dyn`` is :func:`dyn_params`'s dict.
    Returns f32 (band_h, W, 3) on ``device``."""
    base = _bulb_params(scene)
    int_power = _static_int_power(base)
    if torch.device(device).type == "cuda":
        from ..ops._cuda import cuda_device

        cuda_device(device)  # raises before any tensor is made

    def fn(dyn, row0: int):
        builds = consts.f32.builds
        with span("bulb.prepare"):
            # the frame's scalars as f32 (the JAX render's traced values),
            # on the host for the camera and on the device for the colour
            # glue
            p = replace(base, **{k: np.float32(dyn[k]) for k in _DYN_FIELDS})
            ro, dyn_power = bm.camera_setup(p)
            vals = _upload([float(getattr(p, k)) for k in _DYN_FIELDS]
                           + [float(dyn_power)] + [float(v) for v in ro],
                           device)
            render.param_uploads += 1
            dyn_t = {k: vals[i] for i, k in enumerate(_VEC_KEYS)}
            aa = p.aa_samples
            acc = torch.zeros((band_h, width, 3), dtype=torch.float32,
                              device=device)
        for sy in range(aa):
            for sx in range(aa):
                sample = _render_sample(p, ro, dyn_power, dyn_t, width,
                                        band_h, (sx / aa, sy / aa),
                                        int(row0), full_h, int_power, device)
                with span("bulb.post"):
                    acc = acc + sample
        with span("bulb.post"):
            color = acc / consts.f32(aa * aa, acc.device)
            color = coloring.enhance_color(color, dyn_t["brightness"],
                                           dyn_t["saturation"],
                                           dyn_t["contrast"])
            color = coloring.gamma_correct(coloring.aces_tonemap(color))
        render.const_builds += consts.f32.builds - builds
        return color

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
    ``quantize`` 8/16 the image quantized on the device.  The default
    scene (power 8, time 0) takes the trig-free integer DE step; a
    non-integer dynamic power (time != 0) the polynomial-trig step.

    The call runs in the span ``bulb.frame``, its quantize in
    ``bulb.post``; ``render.frames`` counts the frames finished.  Every
    frame or band (``band_render_fn``'s, ``band_renderer``'s too) adds
    one to ``render.param_uploads``, its copy of the frame's vector, and
    to ``render.const_builds`` the constant tensors it built
    (``ops/consts.f32``'s misses): a warm frame builds none."""
    with span("bulb.frame"):
        img = band_render_fn(scene, width, height, height,
                             device=device)(dyn_params(scene), 0)
        if quantize:
            with span("bulb.post"):
                img = coloring.quantize_image(img, bit_depth=quantize)
    render.frames += 1
    return img


render.frames = 0
render.param_uploads = 0
render.const_builds = 0
