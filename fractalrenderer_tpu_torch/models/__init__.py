"""Fractal family renderers (the port's counterpart of
``fractalrenderer_tpu/models/__init__.py``).

``render(scene, width, height, device=...)`` returns an f32 RGB tensor
(H, W, 3) in [0, 1] on ``device`` for every family: the four 2D
escape-time families, the Mandelbulb and the deep zoom (the Mandelbrot,
Julia, Burning Ship and Phoenix perturbation paths with stacked spp²
supersampling, the Burning Ship's ``exact_dust`` tier, and Mandelbrot's
legacy ``rebasing=False`` pipeline of secondary references).
"""
from __future__ import annotations

import importlib

from ..scene import FractalType, Scene

_MODULES = {
    FractalType.MANDELBROT: "mandelbrot",
    FractalType.JULIA: "julia",
    FractalType.BURNING_SHIP: "burning_ship",
    FractalType.PHOENIX: "phoenix",
    FractalType.MANDELBULB: "mandelbulb",
    FractalType.DEEP_ZOOM: "deep_zoom",
}


def render(scene: Scene, width: int, height: int, **kw):
    from ..utils.diag import validate_scene

    scene = validate_scene(scene)  # compute_effect_manager.h:335-345 repairs
    module = importlib.import_module(f".{_MODULES[scene.fractal_type]}",
                                     __name__)
    return module.render(scene, width, height, **kw)
