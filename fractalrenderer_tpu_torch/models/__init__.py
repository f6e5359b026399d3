"""Fractal family renderers (the port's counterpart of
``fractalrenderer_tpu/models/__init__.py``).

``render(scene, width, height, device=...)`` returns an f32 RGB tensor
(H, W, 3) in [0, 1] on ``device`` for every family: the four 2D
escape-time families, the Mandelbulb and the deep zoom (the Mandelbrot,
Julia, Burning Ship and Phoenix perturbation paths with stacked spp²
supersampling, the Burning Ship's ``exact_dust`` tier, and Mandelbrot's
legacy ``rebasing=False`` pipeline of secondary references).

``band_renderer(scene, width, height, device=...)`` is the band seam that
``parallel/`` renders every kind through: ``fn(row0, rows)`` gives rows
[row0, row0 + rows) of ``render``'s image, bit for bit, as f32 (rows, W,
3) on ``device``.  Each model module gives its own.
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


def _module(scene: Scene):
    """The scene repaired as compute_effect_manager.h:335-345 repairs it,
    and the model module of its kind."""
    from ..utils.diag import validate_scene

    scene = validate_scene(scene)
    return scene, importlib.import_module(
        f".{_MODULES[scene.fractal_type]}", __name__)


def render(scene: Scene, width: int, height: int, **kw):
    scene, module = _module(scene)
    return module.render(scene, width, height, **kw)


def band_renderer(scene: Scene, width: int, height: int, *, device="cuda",
                  orbit_cache=None):
    """``fn(row0, rows)``: rows [row0, row0 + rows) of the ``width`` ×
    ``height`` image on ``device``, equal to those rows of ``render``.
    ``orbit_cache`` (the deep zoom's reference orbits, shared by every
    band) is ignored by the kinds that keep no orbit."""
    scene, module = _module(scene)
    return module.band_renderer(scene, width, height, device=device,
                                orbit_cache=orbit_cache)
