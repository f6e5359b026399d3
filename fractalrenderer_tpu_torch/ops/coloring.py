"""Field → RGB colouring and the post chain on tensors (the port's
counterpart of the Mandelbrot planar path of
``fractalrenderer_tpu/ops/coloring.py``).

Sources:
- mandelbrot coloring: shaders/mandelbrot.comp:172-207
- post chain:          shaders/mandelbrot.comp:233-235 (enhance → ACES → gamma)

Scalars may be Python floats or 0-dim f32 tensors (the escape kernel's
packed parameters); every divisor is made a tensor on the operands' device
so CUDA divides exactly rather than by a rounded reciprocal.  The CUDA
kernel's fused epilogue (csrc/escape.cu) mirrors these functions operation
for operation.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import palettes as pal

_LOG2 = math.log(2.0)
GAMMA = 2.2


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _clip01(x):
    return torch.clamp(x, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Smooth iteration counts
# ---------------------------------------------------------------------------

def smooth_nu_loglog(n, zx, zy, max_iter):
    """mandelbrot.comp:172-177 / phoenix.comp:80-83: nu = n + 1 -
    log2(log2(|z|)) with |z| from the final (escaped) z; interior keeps n."""
    dev = zx.device
    log2 = _f32(_LOG2, dev)
    nf = n.to(torch.float32)
    mag2 = zx * zx + zy * zy
    log_zn = torch.log(torch.clamp_min(mag2, 1e-38)) / _f32(2.0, dev)
    mu = torch.log(torch.clamp_min(log_zn, 1e-38) / log2) / log2
    return torch.where(nf < max_iter, nf + 1.0 - mu, nf)


# ---------------------------------------------------------------------------
# Post-processing chain
# ---------------------------------------------------------------------------

def enhance_color_planar(r, g, b, brightness, saturation, contrast):
    """mandelbrot.comp:48-54 — brightness, then contrast, then saturation,
    per plane."""
    rgb = [(ch * brightness - 0.5) * contrast + 0.5 for ch in (r, g, b)]
    gray = rgb[0] * 0.299 + rgb[1] * 0.587 + rgb[2] * 0.114
    return tuple(_clip01(gray * (1.0 - saturation) + ch * saturation)
                 for ch in rgb)


def aces_tonemap(color):
    """mandelbrot.comp:38-45."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return _clip01((color * (a * color + b)) / (color * (c * color + d) + e))


def gamma_correct(color, gamma: float = GAMMA):
    return torch.pow(torch.clamp_min(color, 0.0),
                     float(np.float32(1.0 / gamma)))


def post_chain_planar(r, g, b, brightness, saturation, contrast,
                      clamp_mins: bool = False):
    """Planar enhance → ACES → gamma.  ``clamp_mins`` applies the
    julia/burning-ship floors (julia.comp:319-322)."""
    dev = r.device
    brightness = _f32(brightness, dev)
    saturation = _f32(saturation, dev)
    contrast = _f32(contrast, dev)
    if clamp_mins:
        brightness = torch.clamp_min(brightness, 0.1)
        saturation = torch.clamp_min(saturation, 0.0)
        contrast = torch.clamp_min(contrast, 0.1)
    r, g, b = enhance_color_planar(r, g, b, brightness, saturation, contrast)
    return tuple(gamma_correct(aces_tonemap(ch)) for ch in (r, g, b))


# ---------------------------------------------------------------------------
# Mandelbrot sample colouring (pre-post-chain)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ColorParams:
    max_iterations: float
    palette_mode: int
    color_offset: float
    color_scale: float
    interior_style: int = 0


def color_mandelbrot_planar(n, zx, zy, p: ColorParams):
    """Planar mandelbrot.comp:172-207 for interior styles 0 (palette at t)
    and 1 (black) — returns (r, g, b) planes.  Style 2 (trap glow), orbit
    traps and stripes read tracked fields the port does not produce yet."""
    if p.interior_style not in (0, 1):
        raise NotImplementedError(
            f"mandelbrot interior_style {p.interior_style} is not ported "
            "yet (ROADMAP Queue 1 item 2)")
    dev = zx.device
    max_iter = _f32(p.max_iterations, dev)
    nu = smooth_nu_loglog(n, zx, zy, max_iter)
    t = _clip01(nu / max_iter * _f32(p.color_scale, dev))
    rgb = pal.palette_color_planar(t + _f32(p.color_offset, dev),
                                   p.palette_mode, "classic")
    if p.interior_style == 1:
        interior = n.to(torch.float32) >= max_iter
        rgb = tuple(torch.where(interior, torch.zeros_like(c), c)
                    for c in rgb)
    return tuple(rgb)
