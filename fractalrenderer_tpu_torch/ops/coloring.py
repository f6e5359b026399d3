"""Field → RGB colouring and the post chain on tensors (the port's
counterpart of ``fractalrenderer_tpu/ops/coloring.py``, static palette
modes).

Sources:
- mandelbrot coloring: shaders/mandelbrot.comp:172-207
- julia coloring:      shaders/julia.comp:238-249
- burning-ship:        shaders/burning_ship.comp:250-308
- phoenix:             shaders/phoenix.comp:69-146
- post chain:          shaders/mandelbrot.comp:233-235 (enhance → ACES → gamma)

Scalars may be Python floats or 0-dim f32 tensors.  Each function follows
the JAX one expression for expression: where the JAX package makes a scalar
f32 (``_f32``) the port makes it an f32 tensor on the operands' device, and
where the JAX package lets Python fold a constant in double the port does
too.  Every divisor is a tensor on the operands' device, so CUDA divides
exactly rather than by a rounded reciprocal.  The render pipeline passes
f32 tensors (the JAX pipeline's traced scalars); ``render_dd`` passes
Python floats, as its JAX counterpart does.

The CUDA kernel's fused epilogue (csrc/escape.cu) mirrors the planar
colourers operation for operation.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from . import palettes as pal
from . import trig

_LOG2 = math.log(2.0)
GAMMA = 2.2
PHOENIX_POW = float(np.float32(0.8))  # phoenix.comp pow(t, 0.8)


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _clip01(x):
    return torch.clamp(x, 0.0, 1.0)


def _mix_scalar(a: float, b: float, t):
    return a * (1.0 - t) + b * t


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


def smooth_nu_bailout(n, zx, zy, max_iter, bailout):
    """julia.comp:238 / burning_ship.comp:252: smooth = n + 1 -
    log(log(|z|^2)/log(bailout))/log(2); interior keeps n."""
    dev = zx.device
    nf = n.to(torch.float32)
    len_sq = zx * zx + zy * zy
    quot = torch.log(torch.clamp_min(len_sq, 1e-38)) \
        / torch.log(_f32(bailout, dev))
    smooth = nf + 1.0 - torch.log(torch.clamp_min(quot, 1e-38)) \
        / _f32(_LOG2, dev)
    return torch.where(nf < max_iter, smooth, nf)


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


def enhance_color(color, brightness, saturation, contrast):
    """Stacked (..., 3) enhance — the same channel math as the planar
    form."""
    color = color * brightness
    color = (color - 0.5) * contrast + 0.5
    gray = (color[..., 0] * 0.299 + color[..., 1] * 0.587
            + color[..., 2] * 0.114)[..., None]
    color = gray * (1.0 - saturation) + color * saturation
    return _clip01(color)


def aces_tonemap(color):
    """mandelbrot.comp:38-45.  Works on stacked colours and single planes."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return _clip01((color * (a * color + b)) / (color * (c * color + d) + e))


def gamma_correct(color, gamma: float = GAMMA):
    return torch.pow(torch.clamp_min(color, 0.0),
                     float(np.float32(1.0 / gamma)))


def _clamp_floors(brightness, saturation, contrast, device):
    """julia.comp:319-322 floors on f32 scalars."""
    return (torch.clamp_min(_f32(brightness, device), 0.1),
            torch.clamp_min(_f32(saturation, device), 0.0),
            torch.clamp_min(_f32(contrast, device), 0.1))


def post_chain_traced(color, brightness, saturation, contrast,
                      clamp_mins: bool = False):
    """Stacked enhance → ACES → gamma with f32 enhance scalars — the post
    chain of both render branches after the sample average."""
    if clamp_mins:
        brightness, saturation, contrast = _clamp_floors(
            brightness, saturation, contrast, color.device)
    color = enhance_color(color, brightness, saturation, contrast)
    return gamma_correct(aces_tonemap(color))


def post_chain_planar(r, g, b, brightness, saturation, contrast,
                      clamp_mins: bool = False):
    """Planar enhance → ACES → gamma with f32 enhance scalars.
    ``clamp_mins`` applies the julia/burning-ship floors."""
    dev = r.device
    brightness = _f32(brightness, dev)
    saturation = _f32(saturation, dev)
    contrast = _f32(contrast, dev)
    if clamp_mins:
        brightness, saturation, contrast = _clamp_floors(
            brightness, saturation, contrast, dev)
    r, g, b = enhance_color_planar(r, g, b, brightness, saturation, contrast)
    return tuple(gamma_correct(aces_tonemap(ch)) for ch in (r, g, b))


def post_chain(color, brightness: float, saturation: float, contrast: float,
               clamp_mins: bool = False):
    """enhance → ACES → gamma with Python-float scalars, as the JAX
    ``post_chain`` takes them (render_dd's chain): Python folds
    ``1.0 - saturation`` in double before it meets the f32 image."""
    if clamp_mins:
        brightness = max(float(brightness), 0.1)
        saturation = max(float(saturation), 0.0)
        contrast = max(float(contrast), 0.1)
    color = enhance_color(color, brightness, saturation, contrast)
    return gamma_correct(aces_tonemap(color))


def quantize_image(img: torch.Tensor, *, bit_depth: int,
                   out=None) -> torch.Tensor:
    """Clip/scale/round an f32 [0,1] image to uint8/uint16 on its device —
    the exact utils.png._prepare_rows expression, so a device-quantized
    frame produces byte-identical PNGs.  ``out``, a uint8/uint16 tensor of
    the image's shape, receives the result (the same cast as ``.to``)."""
    img = torch.clamp(img, 0.0, 1.0)
    img = img * (255.0 if bit_depth == 8 else 65535.0) + 0.5
    if out is not None:
        return out.copy_(img)
    return img.to(torch.uint8 if bit_depth == 8 else torch.uint16)


# ---------------------------------------------------------------------------
# Per-family sample colouring (pre-post-chain; applied per AA sample)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ColorParams:
    """The JAX ColorParams; the float fields are Python floats or 0-dim f32
    tensors, ``palette_mode`` is always a static int in the port."""
    max_iterations: Any
    bailout: Any
    palette_mode: int
    color_offset: Any
    color_scale: Any
    interior_style: int = 0
    orbit_trap_enabled: bool = False
    orbit_trap_radius: Any = 0.5
    stripe_enabled: bool = False
    stripe_density: Any = 10.0
    phoenix_stripe_control: Any = 0.0


def _interior(n, max_iter):
    return n.to(torch.float32) >= max_iter


def color_mandelbrot_planar(n, zx, zy, min_trap, p: ColorParams):
    """Planar mandelbrot.comp:172-207 — returns (r, g, b) planes.  The
    stripes use the true atan2, as the JAX package does (this colouring
    never runs inside the kernel)."""
    dev = zx.device
    max_iter = _f32(p.max_iterations, dev)
    nu = smooth_nu_loglog(n, zx, zy, max_iter)
    t = _clip01(nu / max_iter * p.color_scale)
    rgb = list(pal.palette_color_planar(t + p.color_offset, p.palette_mode,
                                        "classic"))

    interior = _interior(n, max_iter)
    if p.interior_style == 1:
        interior_rgb = [torch.zeros_like(c) for c in rgb]
    elif p.interior_style == 2:
        r2 = torch.clamp_min(_f32(p.orbit_trap_radius, dev), 1e-6)
        trap_factor = torch.exp(-min_trap * 6.0 / r2)
        interior_rgb = list(pal.palette_color_planar(
            p.color_offset + trap_factor * 0.3, p.palette_mode, "classic"))
    else:
        interior_rgb = None  # style 0 falls through to the exterior path

    if p.orbit_trap_enabled:
        r = torch.clamp_min(_f32(p.orbit_trap_radius, dev), 1e-6)
        trap_factor = torch.exp(-min_trap * 4.0 / r)
        w = _clip01(trap_factor * 0.8)
        for ch, tc in enumerate((1.0, 0.8, 0.4)):
            rgb[ch] = rgb[ch] * (1.0 - w) + _f32(tc, dev) * w

    if p.stripe_enabled:
        angle = torch.atan2(zy, zx)
        stripes = 0.5 + 0.5 * torch.sin(angle * p.stripe_density + nu * 0.3)
        m = _mix_scalar(0.7, 1.3, stripes)
        rgb = [c * m for c in rgb]

    if interior_rgb is not None:
        rgb = [torch.where(interior, ic, c)
               for ic, c in zip(interior_rgb, rgb)]
    return tuple(rgb)


def color_julia_planar(n, zx, zy, p: ColorParams):
    """Planar julia.comp:238-249: interior black; t = offset + smooth/max *
    scale on the enhanced palettes."""
    max_iter = _f32(p.max_iterations, zx.device)
    smooth = smooth_nu_bailout(n, zx, zy, max_iter, p.bailout)
    t = p.color_offset + (smooth / max_iter) * p.color_scale
    rgb = pal.palette_color_planar(t, p.palette_mode, "enhanced")
    interior = _interior(n, max_iter)
    return tuple(torch.where(interior, torch.zeros_like(c), c) for c in rgb)


def color_burning_ship_planar(n, zx, zy, min_trap, stripe_acc,
                              p: ColorParams):
    """Planar burning_ship.comp:250-308: four interior styles and the
    orbit-trap blend."""
    max_iter = _f32(p.max_iterations, zx.device)
    smooth = smooth_nu_bailout(n, zx, zy, max_iter, p.bailout)
    t = p.color_offset + (smooth / max_iter) * p.color_scale
    rgb = list(pal.palette_color_planar(t, p.palette_mode, "enhanced"))

    if p.orbit_trap_enabled:
        trap_influence = 1.0 - _clip01(min_trap * 2.0)
        trap_rgb = pal.palette_color_planar(trap_influence, p.palette_mode,
                                            "enhanced")
        w = trap_influence * 0.3
        rgb = [c * (1.0 - w) + tc * w for c, tc in zip(rgb, trap_rgb)]

    # Interior styles (burning_ship.comp:259-292)
    if p.interior_style == 1 and p.orbit_trap_enabled:
        ti = 1.0 - _clip01(min_trap * 5.0)
        interior_rgb = [c * 0.5 for c in pal.palette_color_planar(
            ti, p.palette_mode, "enhanced")]
    elif p.interior_style == 2 and p.stripe_enabled:
        sv = stripe_acc / max_iter
        ti = (sv + 1.0) * 0.5
        interior_rgb = [c * 0.3 for c in pal.palette_color_planar(
            ti, p.palette_mode, "enhanced")]
    elif p.interior_style == 3:
        dist = torch.sqrt(zx * zx + zy * zy)
        ti = _clip01(dist * 0.5)
        interior_rgb = [c * 0.4 for c in pal.palette_color_planar(
            ti, p.palette_mode, "enhanced")]
    else:
        interior_rgb = [torch.zeros_like(c) for c in rgb]

    interior = _interior(n, max_iter)
    return tuple(torch.where(interior, ic, c)
                 for ic, c in zip(interior_rgb, rgb))


def color_phoenix_planar(n, zx, zy, p: ColorParams, atan2=trig.atan2):
    """Planar phoenix.comp:89-146: pow(t, 0.8) gradient and adaptive flow
    stripes with the polynomial atan2 (ops/trig.py), the kernel's; the
    golden reference passes ``torch.atan2``, the true atan2 of the JAX
    golden's numpy colouring.

    The stripe gate ``control > 0.01`` is always folded into the blend
    weight (the JAX render path's form, where the control is traced), so
    the kernel and this version compute one expression; with the gate shut
    the weight is 0 and the result is the base colour exactly."""
    dev = zx.device
    max_iter = _f32(p.max_iterations, dev)
    smooth = smooth_nu_loglog(n, zx, zy, max_iter)
    t = torch.pow(torch.clamp_min(smooth / max_iter, 0.0), PHOENIX_POW)
    base = pal.palette_color_planar(t, p.palette_mode, "classic")

    control = torch.clamp_min(_f32(p.phoenix_stripe_control, dev), 0.0)
    stripe_amplitude = _clip01(control * 0.05)
    angle = atan2(zy, zx)
    stripe_mod = 0.5 + 0.5 * torch.sin(angle * control + smooth * 0.25)
    adaptive = stripe_amplitude * (1.0 - torch.exp(-0.004 * smooth * smooth))
    t2 = pal._fract(t + 0.1 * stripe_mod)
    stripe = pal.palette_color_planar(t2, p.palette_mode, "classic")
    w = adaptive * stripe_mod * (control > 0.01)
    return tuple(b * (1.0 - w) + s * w for b, s in zip(base, stripe))


# Stacked (..., 3) wrappers: the unfused render branch's colourers.

def color_mandelbrot(n, zx, zy, min_trap, p: ColorParams):
    return torch.stack(color_mandelbrot_planar(n, zx, zy, min_trap, p), -1)


def color_julia(n, zx, zy, p: ColorParams):
    return torch.stack(color_julia_planar(n, zx, zy, p), -1)


def color_burning_ship(n, zx, zy, min_trap, stripe_acc, p: ColorParams):
    return torch.stack(color_burning_ship_planar(n, zx, zy, min_trap,
                                                 stripe_acc, p), -1)


def color_phoenix(n, zx, zy, p: ColorParams, atan2=trig.atan2):
    return torch.stack(color_phoenix_planar(n, zx, zy, p, atan2), -1)


def color_deep_zoom(n, zx, zy, p: ColorParams):
    """test_deep_zoom.comp:73-103, stacked (..., 3).  No post chain (the
    reference's deep-zoom shader writes raw palette colours)."""
    dev = zx.device
    max_iter = _f32(p.max_iterations, dev)
    log2 = _f32(_LOG2, dev)
    nf = n.to(torch.float32)
    lenz = torch.clamp_min(torch.sqrt(zx * zx + zy * zy), 1e-12)
    log_zn = torch.log(lenz)
    nu = torch.log(torch.clamp_min(log_zn, 1e-38) / log2) / log2
    smooth = nf + 1.0 - nu
    t = smooth * p.color_scale + p.color_offset
    color = pal.deepzoom_color(t, int(p.palette_mode))
    inside = (nf >= max_iter - 0.5)[..., None]
    return torch.where(inside, torch.zeros_like(color), color)


def distance_estimate(n, zx, zy, dzx, dzy, max_iterations):
    """Exterior distance estimate d = |z|·ln|z| / |dz| from the derivative
    field (mandelbrot_debug.comp:114-137).  Interior pixels report 0."""
    max_iter = _f32(max_iterations, zx.device)
    zmag = torch.sqrt(zx * zx + zy * zy)
    dmag = torch.clamp_min(torch.sqrt(dzx * dzx + dzy * dzy), 1e-30)
    d = zmag * torch.log(torch.clamp_min(zmag, 1e-30)) / dmag
    return torch.where(_interior(n, max_iter), torch.zeros_like(d),
                       torch.clamp_min(d, 0.0))
