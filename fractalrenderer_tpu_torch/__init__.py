"""fractalrenderer_tpu_torch — the PyTorch + CUDA port of fractalrenderer_tpu.

The JAX package ``fractalrenderer_tpu`` stays the reference; this package
imports neither it nor jax.  Per-pixel work runs in hand-written CUDA
kernels (``csrc/``, built with nvcc at first use); on a CPU device the same
functions run their plain PyTorch versions.
"""

from .scene import FractalType, InteriorStyle, Scene
from . import presets

__version__ = "0.1.0"

__all__ = ["Scene", "FractalType", "InteriorStyle", "presets", "render"]


def render(scene, width, height, device="cuda", **kw):
    """Render a Scene on ``device`` → f32 RGB tensor (H, W, 3) in [0, 1]."""
    from .models import render as _render

    return _render(scene, width, height, device=device, **kw)
