"""Julia-set renderer — the port of shaders/julia.comp on the CUDA escape
kernel (counterpart of ``fractalrenderer_tpu/models/julia.py``).

z0 = pixel, constant c; smooth bailout-relative colouring; 10 enhanced
palettes; black interior; supersampling with the reference's uv-space
offsets; clamped post chain (julia.comp:319-322).
"""
from __future__ import annotations

from ..scene import Scene
from .common import render_scene


def render(scene: Scene, width: int, height: int, **kw):
    return render_scene(scene, width, height, family="julia",
                        aa_convention="uv", clamp_mins=True, **kw)
