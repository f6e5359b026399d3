"""Phoenix renderer — the port of shaders/phoenix.comp on the CUDA escape
kernel (counterpart of ``fractalrenderer_tpu/models/phoenix.py``).

Two-term recurrence z_{n+1} = z^2 + c + r*z_{n-1} + p*z_n with fixed
bailout 4, pow(t, 0.8) gradient and adaptive flow stripes.
"""
from __future__ import annotations

from ..scene import Scene
# band_renderer: this family's models.band_renderer
from .common import band_renderer, render_scene  # noqa: F401


def render(scene: Scene, width: int, height: int, **kw):
    return render_scene(scene, width, height, family="phoenix",
                        aa_convention="uv", clamp_mins=True, **kw)
