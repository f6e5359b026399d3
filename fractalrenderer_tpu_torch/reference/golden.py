"""CPU golden reference of the port: the numpy float32 escape-time loops
of ``fractalrenderer_tpu/reference/golden.py``, with the reference
shaders' exact operation order, coloured through the port's own
``ops/coloring.py`` on CPU tensors.

It backs ``render --golden`` and ``export-print --golden``: an explicit CPU
reference that runs no kernel.  Loop structure mirrors the shaders:

- mandelbrot.comp:147-207 — update z, track traps on the NEW z, then check
  ``|z|^2 > bailout^2``; the loop index at break is the iteration count.
- julia.comp:222-249 — same counting, interior black.
- burning_ship.comp:217-308 — traps/stripes on the PRE-update z, then
  ``z = abs(z)``, update, check.
- phoenix.comp:63-84 — two-term recurrence with fixed bailout 4.

Vectorized over pixels with an alive mask; escaped pixels freeze their
(n, z, aux) fields, matching per-thread early exit on the GPU.  The pixel
mapping is the port's ``ops/mapping.py`` on CPU tensors, whose f32
arithmetic is the reference's.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops import coloring, mapping
from ..ops.coloring import ColorParams

F32 = np.float32


def _alive_loop_mandelbrot(cr, ci, max_iter: int, bailout: float):
    """Returns (n, zx, zy, min_trap)."""
    shape = cr.shape
    zx = np.zeros(shape, F32)
    zy = np.zeros(shape, F32)
    n = np.zeros(shape, np.int32)
    min_trap = np.full(shape, 1e20, F32)
    alive = np.ones(shape, bool)
    bail2 = F32(bailout) * F32(bailout)
    for _ in range(max_iter):
        if not alive.any():
            break
        x = zx * zx - zy * zy + cr
        y = (F32(2.0) * zx) * zy + ci
        zx = np.where(alive, x, zx)
        zy = np.where(alive, y, zy)
        # Combined orbit trap on the updated z (mandelbrot.comp:162-166)
        dist_origin = np.sqrt(zx * zx + zy * zy)
        dist_axes = np.minimum(np.abs(zx), np.abs(zy))
        dist_c = np.sqrt((zx - cr) ** 2 + (zy - ci) ** 2)
        trap = np.minimum(dist_origin, np.minimum(dist_axes, dist_c))
        min_trap = np.where(alive, np.minimum(min_trap, trap), min_trap)
        escaped = alive & (zx * zx + zy * zy > bail2)
        n = np.where(alive & ~escaped, n + 1, n)
        alive &= ~escaped
    return n, zx, zy, min_trap


def _alive_loop_julia(zx0, zy0, c_re: float, c_im: float, max_iter: int,
                      bailout: float):
    zx = np.asarray(zx0, F32)
    zy = np.asarray(zy0, F32)
    shape = zx.shape
    n = np.zeros(shape, np.int32)
    alive = np.ones(shape, bool)
    bail2 = F32(bailout) * F32(bailout)
    cr = F32(c_re)
    ci = F32(c_im)
    for _ in range(max_iter):
        if not alive.any():
            break
        x = zx * zx - zy * zy + cr
        y = (F32(2.0) * zx) * zy + ci
        zx = np.where(alive, x, zx)
        zy = np.where(alive, y, zy)
        escaped = alive & (zx * zx + zy * zy > bail2)
        n = np.where(alive & ~escaped, n + 1, n)
        alive &= ~escaped
    return n, zx, zy


def _alive_loop_burning_ship(cr, ci, max_iter: int, bailout: float,
                             orbit_trap: bool, trap_radius: float,
                             stripe: bool, stripe_density: float,
                             interior_style: int):
    shape = cr.shape
    zx = np.zeros(shape, F32)
    zy = np.zeros(shape, F32)
    n = np.zeros(shape, np.int32)
    min_trap = np.full(shape, 1e10, F32)
    stripe_acc = np.zeros(shape, F32)
    alive = np.ones(shape, bool)
    bail2 = F32(bailout) * F32(bailout)
    track_stripe = stripe and interior_style == 2
    for _ in range(max_iter):
        if not alive.any():
            break
        if orbit_trap:  # pre-abs z (burning_ship.comp:230-233)
            dist = np.sqrt(zx * zx + zy * zy)
            min_trap = np.where(
                alive, np.minimum(min_trap, np.abs(dist - F32(trap_radius))),
                min_trap)
        if track_stripe:  # burning_ship.comp:236-238
            stripe_acc = np.where(
                alive, stripe_acc + np.sin(zy * F32(stripe_density)),
                stripe_acc)
        ax = np.abs(zx)
        ay = np.abs(zy)
        x = ax * ax - ay * ay + cr
        y = (F32(2.0) * ax) * ay + ci
        zx = np.where(alive, x, zx)
        zy = np.where(alive, y, zy)
        escaped = alive & (zx * zx + zy * zy > bail2)
        n = np.where(alive & ~escaped, n + 1, n)
        alive &= ~escaped
    return n, zx, zy, min_trap, stripe_acc


def _alive_loop_phoenix(cr, ci, max_iter: int, julia_c: Tuple[float, float],
                        use_julia: bool, p: float, r: float):
    shape = cr.shape
    zx = np.zeros(shape, F32)
    zy = np.zeros(shape, F32)
    px_ = np.zeros(shape, F32)
    py_ = np.zeros(shape, F32)
    n = np.zeros(shape, np.int32)
    alive = np.ones(shape, bool)
    add_re = F32(julia_c[0]) if use_julia else cr
    add_im = F32(julia_c[1]) if use_julia else ci
    pf = F32(p)
    rf = F32(r)
    for _ in range(max_iter):
        if not alive.any():
            break
        x = zx * zx - zy * zy + add_re + rf * px_ + pf * zx
        y = (F32(2.0) * zx) * zy + add_im + rf * py_ + pf * zy
        px_ = np.where(alive, zx, px_)
        py_ = np.where(alive, zy, py_)
        zx = np.where(alive, x, zx)
        zy = np.where(alive, y, zy)
        escaped = alive & (zx * zx + zy * zy > F32(4.0))
        n = np.where(alive & ~escaped, n + 1, n)
        alive &= ~escaped
    return n, zx, zy


def _pixel_coords(width: int, height: int):
    py, px = np.mgrid[0:height, 0:width]
    return px.astype(F32), py.astype(F32)


def _coords(width, height, cx, cy, zoom, off):
    """The f32 complex coordinates of every pixel (both conventions share
    one mapping; they differ only in their AA offsets)."""
    px, py = _pixel_coords(width, height)
    re, im = mapping.map_centered(torch.from_numpy(px), torch.from_numpy(py),
                                  width, height, cx, cy, zoom, off[0],
                                  off[1])
    return re.numpy(), im.numpy()


# ---------------------------------------------------------------------------
# Field renderers (one AA sample)
# ---------------------------------------------------------------------------

def mandelbrot_fields(width, height, cx, cy, zoom, max_iter, bailout,
                      off=(0.0, 0.0)):
    cr, ci = _coords(width, height, cx, cy, zoom, off)
    return _alive_loop_mandelbrot(cr, ci, max_iter, bailout)


def julia_fields(width, height, cx, cy, zoom, c_re, c_im, max_iter, bailout,
                 off=(0.0, 0.0)):
    zr, zi = _coords(width, height, cx, cy, zoom, off)
    return _alive_loop_julia(zr, zi, c_re, c_im, max_iter, bailout)


def burning_ship_fields(width, height, cx, cy, zoom, max_iter, bailout,
                        orbit_trap, trap_radius, stripe, stripe_density,
                        interior_style, off=(0.0, 0.0)):
    cr, ci = _coords(width, height, cx, cy, zoom, off)
    return _alive_loop_burning_ship(cr, ci, max_iter, bailout, orbit_trap,
                                    trap_radius, stripe, stripe_density,
                                    interior_style)


def phoenix_fields(width, height, cx, cy, zoom, max_iter, julia_c, use_julia,
                   p, r, off=(0.0, 0.0)):
    cr, ci = _coords(width, height, cx, cy, zoom, off)
    return _alive_loop_phoenix(cr, ci, max_iter, julia_c, use_julia, p, r)


# ---------------------------------------------------------------------------
# Full renders (AA + coloring + post chain)
# ---------------------------------------------------------------------------

def render_scene(scene, width: int, height: int) -> torch.Tensor:
    """Render a Scene to an f32 RGB [0,1] CPU tensor (H, W, 3) exactly as
    the reference would."""
    from ..scene import FractalType

    p = ColorParams(
        max_iterations=scene.max_iterations,
        bailout=scene.bailout,
        palette_mode=scene.palette_mode,
        color_offset=scene.color_offset,
        color_scale=scene.color_scale,
        interior_style=scene.interior_style,
        orbit_trap_enabled=scene.orbit_trap_enabled,
        orbit_trap_radius=scene.orbit_trap_radius,
        stripe_enabled=scene.stripe_enabled,
        stripe_density=scene.stripe_density,
        # Phoenix receives stripe_density unconditionally
        # (compute_effect_manager.h:227-231 packs it regardless of the
        # stripe_enabled flag; phoenix.comp:97 gates on density > 0.01 only).
        phoenix_stripe_control=scene.stripe_density,
    )
    aa = max(scene.antialiasing_samples, 1)
    ft = scene.fractal_type
    view = (width, height, scene.center_x, scene.center_y, scene.zoom)
    if ft == FractalType.MANDELBROT:
        def sample(off):
            return coloring.color_mandelbrot(*_tensors(mandelbrot_fields(
                *view, scene.max_iterations, scene.bailout, off)), p)
        offsets, clamp_mins = mapping.aa_offsets_centered(aa), False
    elif ft == FractalType.JULIA:
        def sample(off):
            return coloring.color_julia(*_tensors(julia_fields(
                *view, scene.julia_c_real, scene.julia_c_imag,
                scene.max_iterations, scene.bailout, off)), p)
        offsets, clamp_mins = mapping.aa_offsets_uv(aa, width), True
    elif ft == FractalType.BURNING_SHIP:
        def sample(off):
            return coloring.color_burning_ship(*_tensors(burning_ship_fields(
                *view, scene.max_iterations, scene.bailout,
                scene.orbit_trap_enabled, scene.orbit_trap_radius,
                scene.stripe_enabled, scene.stripe_density,
                scene.interior_style, off)), p)
        offsets, clamp_mins = mapping.aa_offsets_uv(aa, width), True
    elif ft == FractalType.PHOENIX:
        def sample(off):
            return coloring.color_phoenix(*_tensors(phoenix_fields(
                *view, scene.max_iterations,
                (scene.julia_c_real, scene.julia_c_imag),
                scene.use_julia_set, scene.phoenix_p, scene.phoenix_r,
                off)), p, atan2=torch.atan2)
        offsets, clamp_mins = mapping.aa_offsets_uv(aa, width), True
    else:
        raise NotImplementedError(f"golden render for {ft}")
    acc = torch.zeros((height, width, 3), dtype=torch.float32)
    for off in offsets:
        acc += sample(off)
    color = acc / torch.tensor(float(aa * aa), dtype=torch.float32)
    return coloring.post_chain(color, scene.color_brightness,
                               scene.color_saturation, scene.color_contrast,
                               clamp_mins=clamp_mins)


def _tensors(fields):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in fields)
