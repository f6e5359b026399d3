"""Mandelbrot renderer — the port of shaders/mandelbrot.comp on the CUDA
escape kernels (counterpart of ``fractalrenderer_tpu/models/mandelbrot.py``).

z <- z^2 + c escape loop with combined orbit trap, smooth log-log colouring,
6 classic palettes, interior styles, stripes, NxN supersampling and the
enhance/ACES/gamma post chain; the derivative distance field; and the
double-double precision tier (kernel K2).
"""
from __future__ import annotations

import torch

from ..scene import Scene
# band_renderer: this family's models.band_renderer
from .common import band_renderer, render_scene  # noqa: F401


def render(scene: Scene, width: int, height: int, **kw):
    return render_scene(scene, width, height, family="mandelbrot",
                        aa_convention="centered", clamp_mins=False, **kw)


def distance_field(scene: Scene, width: int, height: int,
                   device="cuda") -> torch.Tensor:
    """Exterior distance-estimate field (pixels → distance to the set) via
    derivative tracking (mandelbrot_debug.comp): K1 with ``track_deriv``,
    then ``coloring.distance_estimate``."""
    from ..ops.coloring import distance_estimate
    from ..ops.escape import escape_fields

    f = escape_fields(
        "mandelbrot", width, height, center_x=scene.center_x,
        center_y=scene.center_y, zoom=scene.zoom,
        max_iter=scene.max_iterations, bailout=scene.bailout,
        track_deriv=True, device=device)
    return distance_estimate(f["n"], f["zx"], f["zy"], f["dzx"], f["dzy"],
                             scene.max_iterations)


def render_dd(scene: Scene, width: int, height: int,
              device="cuda") -> torch.Tensor:
    """Double-double precision variant (precision tier 2, kernel K2): the
    viewport and colour semantics of render() with ~2^-48 coordinate
    precision, from the scene's hp_* strings when present.  Returns f32
    (H, W, 3) in [0, 1] on ``device``.

    The JAX ``render_dd``'s behaviour is kept as it is: the scene is not
    validated, ``max_iterations`` is neither bucketed nor clamped, orbit
    traps and stripes are ignored, and interior style 2 sees the
    placeholder trap 1e20.  Its colouring takes Python-float scalars."""
    from ..ops import coloring
    from ..ops.coloring import ColorParams
    from ..ops.dd import dd_from_string
    from ..ops.dd_escape import dd_escape_fields

    def dd_of(hp, plain):
        return dd_from_string(str(hp) if hp is not None else repr(plain))

    f = dd_escape_fields(
        width, height,
        center_x_dd=dd_of(scene.hp_center_x, scene.center_x),
        center_y_dd=dd_of(scene.hp_center_y, scene.center_y),
        zoom_dd=dd_of(scene.hp_zoom, scene.zoom),
        max_iter=scene.max_iterations, bailout=scene.bailout, device=device)
    p = ColorParams(
        max_iterations=scene.max_iterations, bailout=scene.bailout,
        palette_mode=scene.palette_mode, color_offset=scene.color_offset,
        color_scale=scene.color_scale, interior_style=scene.interior_style)
    color = coloring.color_mandelbrot(
        f["n"], f["zx"], f["zy"], torch.full_like(f["zx"], 1e20), p)
    return coloring.post_chain(color, scene.color_brightness,
                               scene.color_saturation, scene.color_contrast)
