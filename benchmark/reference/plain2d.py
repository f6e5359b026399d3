"""Plain reference of the 2D Mandelbrot export frame: the escape loop with
the analytic interior skip, the fused colouring (smooth count, classic
palettes), the enhance → ACES → gamma post chain and the uint8 quantize.

Frozen copies, at commit f3d0ace5ea09, of the plain versions in
``fractalrenderer_tpu_torch``: ``ops/escape.py`` (``pack_params``'s f32
rounding, ``_cardioid_or_bulb``, the Mandelbrot branch of
``escape_fields_plain``), ``ops/mapping.py`` (``map_centered``),
``ops/coloring.py`` (``smooth_nu_loglog``, ``color_mandelbrot_planar`` for
interior style 0 without trap or stripes, ``post_chain_planar``),
``ops/palettes.py`` (the classic specs and ``palette_color_planar``) and
``models/common.py`` (``quantize_image``).  Each follows its source
operation for operation; every divisor is a tensor on the pixels' device,
as there.  Plain PyTorch only: nothing of the program is imported.

``dtype`` runs the mapping and the escape loop in another precision (the
lower-precision control); colour and post chain stay f32.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

_LOG2 = math.log(2.0)
GAMMA = 2.2
_EARLY_EXIT_EVERY = 16
_MAX_LIMIT = (1 << 24) - 1

# mandelbrot.comp:60-128 — (pre-transform, stops, bounds)
CLASSIC_SPECS = (
    (("pow", 0.7),
     [(0.0, 0.0, 0.1), (0.8, 0.0, 0.0), (1.0, 0.3, 0.0),
      (1.0, 0.9, 0.0), (1.0, 1.0, 0.95)],
     [0.0, 0.2, 0.4, 0.6, 0.8]),
    (("smoothstep", None),
     [(0.0, 0.0, 0.05), (0.0, 0.1, 0.4), (0.0, 0.5, 1.0),
      (0.3, 0.8, 1.0), (0.8, 1.0, 1.0)],
     [0.0, 0.25, 0.5, 0.75, 1.0]),
    (("gray", None), None, None),
    (("fract", None),
     [(0.02, 0.00, 0.05), (0.15, 0.00, 0.25), (0.00, 0.40, 0.60),
      (0.00, 0.90, 1.00), (0.90, 0.95, 1.00)],
     [0.0, 0.25, 0.5, 0.75, 1.0]),
    (("fract_pow", 0.9),
     [(0.1, 0.0, 0.1), (0.5, 0.0, 0.2), (0.9, 0.3, 0.0),
      (1.0, 0.8, 0.3), (1.0, 1.0, 0.9)],
     [0.0, 0.25, 0.5, 0.75, 1.0]),
    (("fract_pow", 0.85),
     [(0.0, 0.05, 0.08), (0.0, 0.3, 0.5), (0.0, 0.7, 0.9),
      (0.2, 0.9, 1.0), (0.9, 1.0, 1.0)],
     [0.0, 0.25, 0.5, 0.75, 1.0]),
)


def _t(v, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(v, dtype=dtype, device=device)


def _clip01(x):
    return torch.clamp(x, 0.0, 1.0)


def _fract(t):
    return t - torch.floor(t)


# ---- palettes (ops/palettes.py) --------------------------------------------

def _piecewise5_planar(t, cols, bounds):
    out = [torch.full_like(t, float(np.float32(cols[-1][ch])))
           for ch in range(3)]
    for i in reversed(range(len(bounds) - 1)):
        lo, hi = bounds[i], bounds[i + 1]
        f = (t - lo) / _t(hi - lo, t.device)
        sel = t < hi
        for ch in range(3):
            seg = (1.0 - f) * float(np.float32(cols[i][ch])) \
                + f * float(np.float32(cols[i + 1][ch]))
            out[ch] = torch.where(sel, seg, out[ch])
    return tuple(out)


def _pre(t, tag):
    kind, val = tag
    if kind == "pow":
        return torch.pow(t, float(np.float32(val)))
    if kind == "smoothstep":
        t = torch.minimum(torch.maximum(t, _t(0.0, t.device)),
                          _t(1.0, t.device))
        return t * t * (3.0 - 2.0 * t)
    if kind == "fract":
        return _fract(t)
    if kind == "fract_pow":
        return torch.pow(_fract(t), float(np.float32(val)))
    return t


def palette_classic(t, mode: int):
    """get_palette_color for a static classic mode: (r, g, b) planes."""
    spec = CLASSIC_SPECS[mode] if 0 <= mode < len(CLASSIC_SPECS) \
        else CLASSIC_SPECS[0]
    tag, cols, bounds = spec
    t = _pre(_fract(t), tag)
    if cols is None:
        return t, t, t
    return _piecewise5_planar(t, cols, bounds)


# ---- the frame --------------------------------------------------------------

def f32_params(scene: dict) -> dict:
    """The scene's scalars rounded to f32 as the kernel's parameter vector
    holds them (pack_params)."""
    f = np.float32
    return {k: float(f(v)) for k, v in scene.items()} | {
        "iter_limit": float(np.maximum(f(scene["iter_limit"]), f(1.0)))}


def _cardioid_or_bulb(cr, ci):
    xq = cr - 0.25
    y2 = ci * ci
    q = xq * xq + y2
    in_cardioid = q * (q + xq) <= 0.25 * y2
    xb = cr + 1.0
    in_bulb = xb * xb + y2 <= 0.0625
    return in_cardioid | in_bulb


def map_centered(width: int, height: int, rows: Sequence[int], cx, cy, zoom,
                 device, dtype=torch.float32):
    """mandelbrot.comp mapping of the pixels of ``rows`` (global rows of a
    ``height``-tall frame), no AA offset."""
    r = torch.as_tensor(list(rows), dtype=torch.int32, device=device)
    c = torch.arange(width, dtype=torch.int32, device=device)
    shape = (len(rows), width)
    py = r.to(dtype)[:, None].expand(shape)
    px = c.to(dtype)[None, :].expand(shape)
    w, h = _t(float(width), device, dtype), _t(float(height), device, dtype)
    off = _t(0.0, device, dtype)
    ux = (px + off - 0.5 * w) / h
    uy = (py + off - 0.5 * h) / h
    return (_t(cx, device, dtype) + ux * _t(zoom, device, dtype),
            _t(cy, device, dtype) + uy * _t(zoom, device, dtype))


def escape_counts(width: int, height: int, rows, scene: dict, cap: int,
                  device, dtype=torch.float32):
    """K1's fields for the Mandelbrot family with the interior skip: (n,
    zx, zy, skipped) on ``rows``; ``cap`` is the batch's static iteration
    cap.  Returns the limit the colouring reads too."""
    p = f32_params(scene)
    limit_f = float(np.minimum(np.float32(p["iter_limit"]),
                               np.float32(min(cap, _MAX_LIMIT))))
    limit = int(limit_f)
    cr, ci = map_centered(width, height, rows, p["center_x"],
                          p["center_y"], p["zoom"], device, dtype)
    shape = cr.shape
    bail2 = _t(p["bailout"], device, dtype) * _t(p["bailout"], device, dtype)
    # update 0, peeled, from z0 = 0
    z0 = torch.zeros(shape, dtype=dtype, device=device)
    sq0 = z0 * z0
    x1 = sq0 - sq0 + cr
    y1 = (2.0 * z0) * z0 + ci
    skip = _cardioid_or_bulb(cr, ci)
    big = _t(3.4e38 if dtype == torch.float32 else 1e38, device, dtype)
    zero = _t(0.0, device, dtype)
    zx = torch.where(skip, big, x1)
    zy = torch.where(skip, zero, y1)
    sqx = torch.where(skip, big, x1 * x1)
    sqy = torch.where(skip, big, y1 * y1)
    n = torch.zeros(shape, dtype=torch.int32, device=device)
    for i in range(1, limit):
        alive = sqx + sqy <= bail2
        if (i - 1) % _EARLY_EXIT_EVERY == 0 and not bool(alive.any()):
            break
        n += alive
        x = sqx - sqy + cr
        y = (2.0 * zx) * zy + ci
        zx = torch.where(alive, x, zx)
        zy = torch.where(alive, y, zy)
        sqx = zx * zx
        sqy = zy * zy
    lim = torch.tensor(limit, dtype=torch.int32, device=device)
    n = torch.where(sqx + sqy <= bail2, lim, n)
    n = torch.where(skip, lim, n)
    zx = torch.where(skip, zero, zx)
    zy = torch.where(skip, zero, zy)
    return n, zx.float(), zy.float(), skip, limit_f


def color_post(n, zx, zy, limit_f: float, scene: dict, palette_mode: int,
               interior_style: int) -> Tuple[torch.Tensor, ...]:
    """The fused epilogue: smooth count, palette, interior style, then the
    post chain (f32 scalars, no clamp floors)."""
    p = f32_params(scene)
    dev = zx.device
    max_iter = _t(limit_f, dev)
    log2 = _t(_LOG2, dev)
    nf = n.to(torch.float32)
    mag2 = zx * zx + zy * zy
    log_zn = torch.log(torch.clamp_min(mag2, 1e-38)) / _t(2.0, dev)
    mu = torch.log(torch.clamp_min(log_zn, 1e-38) / log2) / log2
    nu = torch.where(nf < max_iter, nf + 1.0 - mu, nf)
    t = _clip01(nu / max_iter * _t(p["color_scale"], dev))
    if interior_style != 0:
        raise ValueError(f"interior style {interior_style} is not in the "
                         "reference")
    # style 0: interior pixels take the exterior colour at t = 1
    rgb = list(palette_classic(t + _t(p["color_offset"], dev), palette_mode))
    b, s, c = (_t(p[k], dev) for k in ("brightness", "saturation",
                                       "contrast"))
    rgb = [(ch * b - 0.5) * c + 0.5 for ch in rgb]
    gray = rgb[0] * 0.299 + rgb[1] * 0.587 + rgb[2] * 0.114
    rgb = [_clip01(gray * (1.0 - s) + ch * s) for ch in rgb]
    a_, b_, c_, d_, e_ = 2.51, 0.03, 2.43, 0.59, 0.14
    rgb = [_clip01((ch * (a_ * ch + b_)) / (ch * (c_ * ch + d_) + e_))
           for ch in rgb]
    return tuple(torch.pow(torch.clamp_min(ch, 0.0),
                           float(np.float32(1.0 / GAMMA))) for ch in rgb)


def quantize8(img: torch.Tensor) -> torch.Tensor:
    img = torch.clamp(img, 0.0, 1.0)
    return (img * 255.0 + 0.5).to(torch.uint8)


def frame_planar(width: int, height: int, rows, scene: dict, cap: int,
                 palette_mode: int, interior_style: int, device,
                 dtype=torch.float32):
    """The planar uint8 (3, len(rows), width) rows of one export frame, and
    the count plane with the skip mask (for the work counts)."""
    n, zx, zy, skip, limit_f = escape_counts(width, height, rows, scene,
                                             cap, device, dtype)
    rgb = color_post(n, zx, zy, limit_f, scene, palette_mode,
                     interior_style)
    return quantize8(torch.stack(rgb, dim=0)), n, skip
