"""Mandelbrot renderer — the port of shaders/mandelbrot.comp on the CUDA
escape kernel (counterpart of ``fractalrenderer_tpu/models/mandelbrot.py``).
"""
from __future__ import annotations

from ..scene import Scene
from .common import render_scene


def render(scene: Scene, width: int, height: int, **kw):
    return render_scene(scene, width, height, family="mandelbrot",
                        aa_convention="centered", clamp_mins=False, **kw)
