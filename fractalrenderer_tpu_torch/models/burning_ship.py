"""Burning Ship renderer — the port of shaders/burning_ship.comp on the CUDA
escape kernel (counterpart of ``fractalrenderer_tpu/models/burning_ship.py``).

z <- (|Re z| + i|Im z|)^2 + c; |dist - r| orbit trap and sin-stripe
accumulation on the pre-abs z; 4 interior styles; enhanced palettes.
"""
from __future__ import annotations

from ..scene import Scene
# band_renderer: this family's models.band_renderer
from .common import band_renderer, render_scene  # noqa: F401


def render(scene: Scene, width: int, height: int, **kw):
    return render_scene(scene, width, height, family="burning_ship",
                        aa_convention="uv", clamp_mins=True, **kw)
