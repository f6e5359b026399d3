"""Colour palettes on tensors (the port's counterpart of the static-mode
planar half of ``fractalrenderer_tpu/ops/palettes.py``).

- ``classic``  (6): shaders/mandelbrot.comp:60-141 — fire, electric,
  grayscale, nebula, solar, ocean.
- ``enhanced`` (10): shaders/julia.comp:20-181 == shaders/burning_ship.comp —
  ultra_fire, electric, ocean_enhanced, sunset, cosmic, gold, vaporwave,
  forest, lava, grayscale.

- ``deepzoom_color`` (4): shaders/test_deep_zoom.comp:86-100, stacked
  (..., 3) — deep-zoom colouring is tensor glue, in no kernel.
- ``bulb_color`` (6): shaders/mandelbulb.comp:34-75 — procedural dynamic /
  fire_and_ice / lava / neon with hash noise, stacked (..., 3); the
  Mandelbulb's shading is tensor glue after its kernels.

``palette_table``
flattens one spec into the f32 constant table the CUDA escape kernel reads,
so the kernel and the plain path use the same rounded constants (Python
folds ``hi - lo`` in double before it reaches f32; the kernel must not
recompute it in f32).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _fract(t):
    return t - torch.floor(t)


def _clamp(t, lo, hi):
    return torch.minimum(torch.maximum(t, _f32(lo, t.device)),
                         _f32(hi, t.device))


def _smoothstep(t):
    t = _clamp(t, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _piecewise5_planar(t, cols: Sequence[Tuple[float, float, float]],
                       bounds: Sequence[float]):
    """Planar 5-stop gradient: segment i spans [bounds[i], bounds[i+1])
    mixing cols[i]→cols[i+1]; t >= bounds[-1] returns cols[-1].  Returns
    (r, g, b) planes shaped like ``t``."""
    out = [torch.full_like(t, float(np.float32(cols[-1][ch])))
           for ch in range(3)]
    # Build from the last segment backwards so earlier segments win.
    for i in reversed(range(len(bounds) - 1)):
        lo, hi = bounds[i], bounds[i + 1]
        f = (t - lo) / _f32(hi - lo, t.device)
        sel = t < hi
        for ch in range(3):
            seg = (1.0 - f) * float(np.float32(cols[i][ch])) \
                + f * float(np.float32(cols[i + 1][ch]))
            out[ch] = torch.where(sel, seg, out[ch])
    return tuple(out)


# Gradient specs: (pre-transform tag, stops, bounds).  Pre-transforms: a
# (kind, value) tag interpreted by _pre (pow / smoothstep / fract /
# fract-then-pow).
_CLASSIC_SPECS = (
    # mandelbrot.comp:60-72
    (("pow", 0.7),
     [(0.0, 0.0, 0.1), (0.8, 0.0, 0.0), (1.0, 0.3, 0.0),
      (1.0, 0.9, 0.0), (1.0, 1.0, 0.95)],
     [0.0, 0.2, 0.4, 0.6, 0.8]),
    # mandelbrot.comp:74-85
    (("smoothstep", None),
     [(0.0, 0.0, 0.05), (0.0, 0.1, 0.4), (0.0, 0.5, 1.0),
      (0.3, 0.8, 1.0), (0.8, 1.0, 1.0)],
     [0.0, 0.25, 0.5, 0.75, 1.0]),
    # mandelbrot.comp:87-89 — grayscale, no gradient
    (("gray", None), None, None),
    # mandelbrot.comp:91-102
    (("fract", None),
     [(0.02, 0.00, 0.05), (0.15, 0.00, 0.25), (0.00, 0.40, 0.60),
      (0.00, 0.90, 1.00), (0.90, 0.95, 1.00)],
     [0.0, 0.25, 0.5, 0.75, 1.0]),
    # mandelbrot.comp:104-115
    (("fract_pow", 0.9),
     [(0.1, 0.0, 0.1), (0.5, 0.0, 0.2), (0.9, 0.3, 0.0),
      (1.0, 0.8, 0.3), (1.0, 1.0, 0.9)],
     [0.0, 0.25, 0.5, 0.75, 1.0]),
    # mandelbrot.comp:117-128
    (("fract_pow", 0.85),
     [(0.0, 0.05, 0.08), (0.0, 0.3, 0.5), (0.0, 0.7, 0.9),
      (0.2, 0.9, 1.0), (0.9, 1.0, 1.0)],
     [0.0, 0.25, 0.5, 0.75, 1.0]),
)
CLASSIC_NAMES = ("fire", "electric", "grayscale", "nebula", "solar", "ocean")

_ENHANCED_SPECS = (
    # julia.comp:20-34 — ultra_fire
    (("pow", 0.7),
     [(0.0, 0.0, 0.1), (0.8, 0.0, 0.0), (1.0, 0.3, 0.0),
      (1.0, 0.9, 0.0), (1.0, 1.0, 0.95)],
     [0.0, 0.2, 0.4, 0.6, 0.8]),
    # julia.comp:37-50 — electric (same as classic)
    _CLASSIC_SPECS[1],
    # julia.comp:53-66 — ocean
    (("smoothstep", None),
     [(0.0, 0.0, 0.1), (0.0, 0.1, 0.3), (0.0, 0.4, 0.7),
      (0.0, 0.7, 1.0), (0.5, 1.0, 1.0)],
     [0.0, 0.25, 0.5, 0.75, 1.0]),
    # julia.comp:69-81 — sunset
    (("id", None),
     [(0.1, 0.0, 0.2), (0.5, 0.1, 0.3), (1.0, 0.3, 0.2),
      (1.0, 0.7, 0.3), (1.0, 0.95, 0.7)],
     [0.0, 0.2, 0.4, 0.6, 0.8]),
    # julia.comp:84-97 — cosmic, non-uniform breakpoints
    (("pow", 0.8),
     [(0.0, 0.0, 0.0), (0.2, 0.0, 0.4), (0.4, 0.0, 0.6),
      (0.8, 0.3, 0.9), (1.0, 0.7, 1.0)],
     [0.0, 0.3, 0.5, 0.7, 1.0]),
    # julia.comp:100-113 — gold
    (("smoothstep", None),
     [(0.1, 0.05, 0.0), (0.4, 0.2, 0.0), (0.8, 0.5, 0.1),
      (1.0, 0.8, 0.3), (1.0, 1.0, 0.9)],
     [0.0, 0.25, 0.5, 0.75, 1.0]),
    # julia.comp:116-127 — vaporwave
    (("id", None),
     [(0.1, 0.0, 0.2), (0.5, 0.0, 0.5), (1.0, 0.0, 0.8),
      (0.0, 0.8, 1.0), (1.0, 0.5, 1.0)],
     [0.0, 0.25, 0.5, 0.75, 1.0]),
    # julia.comp:130-141 — forest
    (("id", None),
     [(0.0, 0.05, 0.0), (0.0, 0.2, 0.1), (0.1, 0.5, 0.2),
      (0.3, 0.8, 0.4), (0.8, 1.0, 0.6)],
     [0.0, 0.25, 0.5, 0.75, 1.0]),
    # julia.comp:144-157 — lava, segment spans 0.2/0.2/0.3/0.3
    (("pow", 0.6),
     [(0.1, 0.0, 0.0), (0.6, 0.0, 0.0), (1.0, 0.2, 0.0),
      (1.0, 0.6, 0.0), (1.0, 1.0, 0.5)],
     [0.0, 0.2, 0.4, 0.7, 1.0]),
    # julia.comp:160-162 — grayscale
    _CLASSIC_SPECS[2],
)
ENHANCED_NAMES = ("ultra_fire", "electric", "ocean", "sunset", "cosmic",
                  "gold", "vaporwave", "forest", "lava", "grayscale")


def _pre(t, tag):
    kind, val = tag
    if kind == "pow":
        return torch.pow(t, float(np.float32(val)))
    if kind == "smoothstep":
        return _smoothstep(t)
    if kind == "fract":
        return _fract(t)
    if kind == "fract_pow":
        return torch.pow(_fract(t), float(np.float32(val)))
    return t  # "gray" / identity


def _spec_planar(t, spec):
    tag, cols, bounds = spec
    t = _pre(t, tag)
    if cols is None:  # grayscale
        return t, t, t
    return _piecewise5_planar(t, cols, bounds)


def _spec(mode: int, family: str):
    specs = {"classic": _CLASSIC_SPECS, "enhanced": _ENHANCED_SPECS}[family]
    idx = int(mode)
    return specs[idx] if 0 <= idx < len(specs) else specs[0]


def _vec3(r, g, b, device) -> torch.Tensor:
    return torch.tensor([r, g, b], dtype=torch.float32, device=device)


def _mix(a, b, t):
    """GLSL mix(a, b, t) with ``t`` broadcast onto the colour axis."""
    t = t[..., None]
    return a * (1.0 - t) + b * t


def hsv2rgb(h, s, v):
    """test_deep_zoom.comp:65-69 (the vec4-K formulation), stacked."""
    kx, ky, kz, kw = 1.0, 2.0 / 3.0, 1.0 / 3.0, 3.0
    px = torch.abs(_fract(h + kx) * 6.0 - kw)
    py = torch.abs(_fract(h + ky) * 6.0 - kw)
    pz = torch.abs(_fract(h + kz) * 6.0 - kw)
    p = torch.stack([px, py, pz], dim=-1)
    rgb = torch.ones_like(p) * (1.0 - s[..., None]) \
        + _clamp(p - 1.0, 0.0, 1.0) * s[..., None]
    return v[..., None] * rgb


def deepzoom_color(t: torch.Tensor, mode: int) -> torch.Tensor:
    """Palette switch of test_deep_zoom.comp:86-100 for a static mode:
    (..., 3) f32."""
    if mode == 0:
        hue = _fract(t * 0.05)
        return hsv2rgb(hue, torch.full_like(hue, 0.8),
                       torch.full_like(hue, 0.9))
    if mode == 1:
        s = _fract(t * 0.03)
        return _mix(_vec3(0.0, 0.1, 0.3, t.device),
                    _vec3(1.0, 1.0, 1.0, t.device), s)
    if mode == 2:
        s = _fract(t * 0.04)
        return _mix(_vec3(0.1, 0.0, 0.0, t.device),
                    _vec3(1.0, 0.8, 0.0, t.device), s)
    s = _fract(t * 0.02)
    return s[..., None].expand(s.shape + (3,)).contiguous()


def _piecewise5(t, cols, bounds):
    """The stacked (..., 3) form of _piecewise5_planar."""
    return torch.stack(_piecewise5_planar(t, cols, bounds), dim=-1)


def _bulb_hsv2rgb(h, s, v):
    """mandelbulb.comp:17-20 (the mod-based formulation), stacked."""
    base = torch.stack([h * 6.0 + 0.0, h * 6.0 + 4.0, h * 6.0 + 2.0], dim=-1)
    rgb = _clamp(torch.abs(torch.remainder(base, 6.0) - 3.0) - 1.0, 0.0, 1.0)
    one = torch.ones_like(rgb)
    return v[..., None] * (one * (1.0 - s[..., None]) + rgb * s[..., None])


def _hash(px, py):
    """mandelbulb.comp:25."""
    return _fract(torch.sin(px * 127.1 + py * 311.7) * 43758.5453123)


def _noise(px, py):
    """mandelbulb.comp:26-32: value noise from four corner hashes."""
    ix, iy = torch.floor(px), torch.floor(py)
    fx, fy = px - ix, py - iy
    a = _hash(ix, iy)
    b = _hash(ix + 1.0, iy)
    c = _hash(ix, iy + 1.0)
    d = _hash(ix + 1.0, iy + 1.0)
    ux = fx * fx * (3.0 - 2.0 * fx)
    uy = fy * fy * (3.0 - 2.0 * fy)
    return (a * (1.0 - ux) + b * ux) + (c - a) * uy * (1.0 - ux) \
        + (d - b) * ux * uy


def bulb_dynamic(t):
    """mandelbulb.comp:34-39."""
    hue = _fract(t + 0.3 * torch.sin(t * 12.0))
    sat = 0.6 + 0.4 * torch.sin(t * 7.0)
    val = torch.pow(t, float(np.float32(0.4)))
    return _bulb_hsv2rgb(hue, sat, val)


def bulb_fire_and_ice(t):
    """mandelbulb.comp:41-46."""
    blend = _smoothstep(t)
    zeros, ones = torch.zeros_like(blend), torch.ones_like(blend)
    fire = torch.stack([torch.pow(blend, 2.0), blend * 0.5, zeros], dim=-1)
    ice = torch.stack([zeros, 0.5 + 0.5 * blend, ones], dim=-1)
    return _mix(fire * 1.0, ice * 1.0, _fract(t * 3.0))


def bulb_lava(t):
    """mandelbulb.comp:48-55."""
    return _piecewise5(
        t, [(0.1, 0.0, 0.0), (0.8, 0.1, 0.0), (1.0, 0.5, 0.0),
            (1.0, 0.9, 0.3), (1.0, 1.0, 0.8)],
        [0.0, 0.25, 0.5, 0.75, 1.0])


def bulb_neon(t):
    """mandelbulb.comp:57-61."""
    dev = t.device
    lo = _mix(_vec3(0.0, 0.0, 0.1, dev), _vec3(0.0, 0.2, 0.6, dev), t)
    hi = _mix(_vec3(0.0, 0.8, 1.0, dev), _vec3(0.5, 1.0, 1.0, dev), t)
    return _mix(lo, hi, torch.pow(t, 2.0))


def bulb_color(t: torch.Tensor, mode: int) -> torch.Tensor:
    """mandelbulb.comp:63-75 — fract, add hash noise, dispatch on a static
    mode: (..., 3) f32."""
    t = _fract(t)
    n = _noise(t * 100.0, t * 57.0) * 0.02
    if mode == 1:
        return bulb_fire_and_ice(t + n)
    if mode == 2:
        return bulb_lava(t + n)
    if mode == 3:
        return bulb_neon(t + n)
    if mode == 4:
        return bulb_dynamic(torch.pow(t, float(np.float32(0.5))) + n)
    if mode == 5:
        return bulb_fire_and_ice(torch.pow(t, float(np.float32(0.6))) + n)
    return bulb_dynamic(t + n)


def num_palettes(family: str) -> int:
    return {"classic": 6, "enhanced": 10, "deepzoom": 4, "bulb": 6}[family]


def palette_color_planar(t: torch.Tensor, mode: int,
                         family: str = "classic"):
    """GLSL get_palette_color for a static mode: fract(t), then the
    palette's planar gradient — returns (r, g, b) planes."""
    return _spec_planar(_fract(t), _spec(mode, family))


# Flat table layout read by csrc/escape.cu (keep the two in sync).
T_KIND, T_EXPO, T_GRAY, T_LO, T_SPAN, T_HI, T_COL = 0, 1, 2, 3, 7, 11, 15
TABLE_LEN = 30
_KIND_CODES = {"id": 0, "gray": 0, "pow": 1, "smoothstep": 2, "fract": 3,
               "fract_pow": 4}


def palette_table(mode: int, family: str = "classic") -> np.ndarray:
    """One palette spec as f32 constants: pre-transform kind and exponent,
    a grayscale flag, the segments' lower bounds, spans (``hi - lo`` folded
    in double, as _piecewise5_planar does) and upper bounds, and the five
    RGB stops."""
    (kind, val), cols, bounds = _spec(mode, family)
    tab = np.zeros(TABLE_LEN, np.float32)
    tab[T_KIND] = _KIND_CODES[kind]
    tab[T_EXPO] = val if val is not None else 0.0
    if cols is None:
        tab[T_GRAY] = 1.0
        return tab
    for i in range(4):
        tab[T_LO + i] = bounds[i]
        tab[T_SPAN + i] = bounds[i + 1] - bounds[i]
        tab[T_HI + i] = bounds[i + 1]
    tab[T_COL:T_COL + 15] = np.asarray(cols, np.float32).reshape(-1)
    return tab
