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
by value), the colour parameters as f32 tensors on the device.
"""
from __future__ import annotations

import math
from dataclasses import replace

import numpy as np
import torch

from ..ops import bulb_math as bm
from ..ops import coloring
from ..ops.bulb_kernel import march_fields
from ..scene import Scene
from .common import quantize_image

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


def _render_sample(p: bm.BulbParams, ro, dyn_power, dyn_t: dict, width: int,
                   height: int, off, row0: int, map_height: int, int_power,
                   device):
    """One AA sample of a band of ``height`` rows from global row ``row0``
    (kernel-shaded path of the JAX ``_render_sample``).  ``p`` holds the
    frame's f32 scalars and ``ro``/``dyn_power`` its camera (numpy);
    ``dyn_t`` the same scalars as device tensors."""
    dev = dyn_t["fov"].device
    ro_t = tuple(torch.tensor(float(v), dtype=torch.float32, device=dev)
                 for v in ro)
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
    hit = f["hit"] > 0.5
    t = f["t"]
    pos = tuple(o + r * t for o, r in zip(ro_t, rd))
    pt = replace(p, **{k: dyn_t[k] for k in ("color_offset", "color_scale",
                                             "time")})
    hit_color = bm.shade_hit(pos, (f["nx"], f["ny"], f["nz"]), rd, f["d"],
                             f["esc"], t, pt, dyn_t["dyn_power"],
                             ao_sum=f["ao"])
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
        # the frame's scalars as f32 (the JAX render's traced values), on
        # the host for the camera and on the device for the colour glue
        p = replace(base, **{k: np.float32(dyn[k]) for k in _DYN_FIELDS})
        ro, dyn_power = bm.camera_setup(p)
        keys = (*_DYN_FIELDS, "dyn_power")
        vals = torch.tensor([float(getattr(p, k)) for k in _DYN_FIELDS]
                            + [float(dyn_power)], dtype=torch.float32,
                            device=device)
        dyn_t = {k: vals[i] for i, k in enumerate(keys)}
        aa = p.aa_samples
        acc = torch.zeros((band_h, width, 3), dtype=torch.float32,
                          device=device)
        for sy in range(aa):
            for sx in range(aa):
                acc = acc + _render_sample(p, ro, dyn_power, dyn_t, width,
                                           band_h,
                                           (sx / aa, sy / aa), int(row0),
                                           full_h, int_power, device)
        color = acc / torch.tensor(float(aa * aa), dtype=torch.float32,
                                   device=acc.device)
        color = coloring.enhance_color(color, dyn_t["brightness"],
                                       dyn_t["saturation"],
                                       dyn_t["contrast"])
        return coloring.gamma_correct(coloring.aces_tonemap(color))

    return fn


def render(scene: Scene, width: int, height: int, device="cuda",
           quantize: int = 0) -> torch.Tensor:
    """Render the bulb on ``device``: f32 (H, W, 3) in [0, 1], or with
    ``quantize`` 8/16 the image quantized on the device.  The default
    scene (power 8, time 0) takes the trig-free integer DE step; a
    non-integer dynamic power (time != 0) the polynomial-trig step."""
    img = band_render_fn(scene, width, height, height,
                         device=device)(dyn_params(scene), 0)
    return quantize_image(img, bit_depth=quantize) if quantize else img


def render_sharded(scene: Scene, width: int, height: int,
                   mesh=None) -> torch.Tensor:
    """Row-band bulb render (gather-free, the decomposition of the 2D
    families in parallel/tiled.py): each device raymarches and shades its
    own contiguous band, every band dispatched before the first fetch, and
    the bands are joined on the host as an f32 (H, W, 3) tensor.  K4a's
    cone blocks are aligned to the image, not to the band, so every band
    equals the same rows of the whole frame."""
    from ..parallel.mesh import make_render_mesh, row_bands
    from ..utils.diag import validate_scene

    scene = validate_scene(scene)  # parity with models.render dispatch
    if mesh is None:
        mesh = make_render_mesh()
    devs = mesh.devices[0]
    dyn = dyn_params(scene)
    bands = [band_render_fn(scene, width, rows, height, device=dev)(dyn, row0)
             for dev, (row0, rows) in zip(devs, row_bands(height, len(devs)))]
    return torch.cat([b.cpu() for b in bands])
