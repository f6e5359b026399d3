"""Julia-set renderer — the port of shaders/julia.comp on the CUDA escape
kernel (counterpart of ``fractalrenderer_tpu/models/julia.py``).

z0 = pixel, constant c; smooth bailout-relative colouring; 10 enhanced
palettes; black interior; supersampling with the reference's uv-space
offsets; clamped post chain (julia.comp:319-322); and the batched c
sweep.
"""
from __future__ import annotations

from ..scene import Scene
# band_renderer: this family's models.band_renderer
from .common import band_renderer, render_scene  # noqa: F401


def render(scene: Scene, width: int, height: int, **kw):
    return render_scene(scene, width, height, family="julia",
                        aa_convention="uv", clamp_mins=True, **kw)


def render_c_sweep(scene: Scene, c_values, width: int, height: int,
                   device="cuda"):
    """Batched c-parameter sweep (BASELINE config #2): render the same
    viewport for a batch of Julia c constants on one stream, one K1
    launch per c and AA sample (aa² launches per c; with more than one
    sample the frame's average and post chain follow as tensor glue).

    ``c_values``: sequence of (re, im) pairs → (N, H, W, 3) f32 tensor on
    ``device``.  The reference's equivalent is interactively dragging the c
    sliders (ui_manager.cpp Julia panel) one frame at a time.
    """
    import numpy as np

    from .common import batch_render_fn, scene_dyn_params, scene_static_cfg

    cfg = scene_static_cfg(scene, width, height, "julia", "uv", True,
                           device=str(device))
    fn = batch_render_fn(cfg)
    base = scene_dyn_params(scene)
    batch = {k: np.full(len(c_values), v, np.float32)
             for k, v in base.items()}
    batch["julia_c_real"] = np.asarray([c[0] for c in c_values], np.float32)
    batch["julia_c_imag"] = np.asarray([c[1] for c in c_values], np.float32)
    return fn(batch)
