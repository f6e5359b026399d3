"""Plain reference of the Julia c-sweep frame: julia.comp's uv mapping with
its supersampling offsets, the f32 escape loop (z0 = pixel, c constant),
the bailout-relative smooth count and the enhanced palette 0 with a black
interior for each sample, the sample sum in offset order, the divide, the
clamped enhance → ACES → gamma post chain and the PNG writer's uint8
quantize.

Frozen copies, at commit 674962154162, of the plain versions in
``fractalrenderer_tpu_torch``: ``ops/mapping.py`` (``aa_offsets_uv``,
julia.comp:250-293; ``map_uv``, which is ``map_centered``'s arithmetic),
``ops/escape.py`` (``pack_params``' f32 rounding for the Julia family and
the Julia branch of ``escape_fields_plain``, julia.comp:222-249, with no
interior skip), ``ops/coloring.py`` (``smooth_nu_bailout`` and
``color_julia_planar``, julia.comp:165-181 and :238-249;
``post_chain_traced`` with the clamp floors of julia.comp:319-322),
``ops/palettes.py`` (the enhanced palette 0, ultra_fire, julia.comp:20-34)
and ``models/common.py`` (``_iter_bucket``, the sample sum and
``_average_then_post``, julia.comp:319-337; ``quantize_image``).  Each
follows its source operation for operation, every divisor a tensor on the
pixels' device.  The palette and the quantize are
``reference/plain2d.py``'s: julia.comp's ultra_fire (the enhanced palette
0) is mandelbrot.comp's fire (the classic palette 0) stop for stop.
Plain PyTorch only: nothing of the program is imported.

The supersampling offsets are the shader's raw uv units, 1/(aa·width),
added to the pixel coordinate as the port adds them: the samples of one
pixel lie a small fraction of a pixel apart, as in the upstream shader.

Departures from the program, none of which changes a value:

- the aa² samples of a frame run through one escape loop on a stacked
  (aa², rows, width) tensor, the offsets and c as broadcast tensors (the
  loop's operations are exact IEEE adds, multiplies, compares and
  selects, so a lane's result does not depend on its neighbours); the
  colour runs per sample on (rows, width) planes, as the program's;
- the loop tests for live pixels every 16 updates over all samples at
  once: an update with no live lane changes nothing.

``dtype`` runs the mapping and the escape loop in another precision (the
lower-precision control); colour and post chain stay f32.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .plain2d import _clip01, _t, palette_classic, quantize8

_LOG2 = math.log(2.0)
GAMMA = 2.2
_EARLY_EXIT_EVERY = 16
_MAX_LIMIT = (1 << 24) - 1

# the enhanced palettes the reference has: ultra_fire (julia.comp:20-34)
PALETTES = (0,)


def iter_bucket(max_iter: int) -> int:
    """The static cap of a frame's configuration: the iteration count
    rounded up to a power of two (at least 256), below the f32 counter
    ceiling."""
    b = 256
    while b < max_iter:
        b *= 2
    return min(b, _MAX_LIMIT)


def aa_offsets_uv(aa: int, width: int) -> Tuple[Tuple[float, float], ...]:
    """julia.comp:253-259: each sample's offset in the shader's raw units,
    x outer, y inner."""
    aa = max(aa, 1)
    if aa <= 1:
        return ((0.0, 0.0),)
    so = (1.0 / width) / aa
    return tuple((sx * so - so * (aa - 1) * 0.5,
                  sy * so - so * (aa - 1) * 0.5)
                 for sx in range(aa) for sy in range(aa))


def f32_params(view: dict) -> dict:
    """The frame's scalars rounded to f32 as the kernel's parameter vector
    holds them (pack_params, the Julia family)."""
    f = np.float32
    p = {k: float(f(v)) for k, v in view.items()}
    p["iter_limit"] = float(np.maximum(f(view["iter_limit"]), f(1.0)))
    p["bail2"] = float(f(view["bailout"]) * f(view["bailout"]))
    return p


def escape_counts(width: int, height: int, rows: Sequence[int], view: dict,
                  cap: int, offsets, device, dtype=torch.float32):
    """The escape loop of every sample: (n, zx, zy) stacked over the
    samples, each (len(offsets), len(rows), width), and the limit the
    colouring reads.  ``view`` holds the frame's centre, zoom, bailout,
    ``iter_limit`` and its c (``c_real``, ``c_imag``); ``cap`` is the
    configuration's static cap."""
    p = f32_params(view)
    limit_f = float(np.minimum(np.float32(p["iter_limit"]),
                               np.float32(min(cap, _MAX_LIMIT))))
    limit = int(limit_f)
    s = len(offsets)
    # the pixel mapping (map_centered): uv = (p + off - 0.5 size) / h
    r = torch.as_tensor(list(rows), dtype=torch.int32, device=device)
    col = torch.arange(width, dtype=torch.int32, device=device)
    shape = (s, len(rows), width)
    py = r.to(dtype)[None, :, None].expand(shape)
    px = col.to(dtype)[None, None, :].expand(shape)
    offx = torch.tensor([float(np.float32(o[0])) for o in offsets],
                        dtype=torch.float32, device=device).to(dtype)
    offy = torch.tensor([float(np.float32(o[1])) for o in offsets],
                        dtype=torch.float32, device=device).to(dtype)
    w = _t(float(width), device, dtype)
    h = _t(float(height), device, dtype)
    ux = (px + offx[:, None, None] - 0.5 * w) / h
    uy = (py + offy[:, None, None] - 0.5 * h) / h
    zx0 = _t(p["center_x"], device, dtype) + ux * _t(p["zoom"], device, dtype)
    zy0 = _t(p["center_y"], device, dtype) + uy * _t(p["zoom"], device, dtype)
    cr = _t(p["c_real"], device, dtype)
    ci = _t(p["c_imag"], device, dtype)
    bail2 = _t(p["bail2"], device, dtype)
    # update 0, peeled, from z0 = the pixel
    sqx0 = zx0 * zx0
    sqy0 = zy0 * zy0
    zx = sqx0 - sqy0 + cr
    zy = (2.0 * zx0) * zy0 + ci
    sqx = zx * zx
    sqy = zy * zy
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
    return n, zx.float(), zy.float(), limit_f


def color_sample(n, zx, zy, limit_f: float, view: dict) -> List[torch.Tensor]:
    """color_julia_planar on one sample's planes: the bailout-relative
    smooth count, t = offset + smooth / max · scale, the palette (fract,
    the pre-transform, the gradient) and a black interior."""
    p = f32_params(view)
    dev = zx.device
    max_iter = _t(limit_f, dev)
    nf = n.to(torch.float32)
    len_sq = zx * zx + zy * zy
    quot = torch.log(torch.clamp_min(len_sq, 1e-38)) \
        / torch.log(_t(p["bailout"], dev))
    smooth = nf + 1.0 - torch.log(torch.clamp_min(quot, 1e-38)) \
        / _t(_LOG2, dev)
    smooth = torch.where(nf < max_iter, smooth, nf)
    t = _t(p["color_offset"], dev) + (smooth / max_iter) \
        * _t(p["color_scale"], dev)
    rgb = palette_classic(t, 0)
    interior = nf >= max_iter
    return [torch.where(interior, torch.zeros_like(c), c) for c in rgb]


def average_then_post(acc: torch.Tensor, count: int,
                      view: dict) -> torch.Tensor:
    """The sample average, divided by a device tensor, then the stacked
    post chain with the Julia clamp floors on the f32 enhance scalars."""
    p = f32_params(view)
    dev = acc.device
    color = acc / _t(float(count), dev)
    b = torch.clamp_min(_t(p["brightness"], dev), 0.1)
    s = torch.clamp_min(_t(p["saturation"], dev), 0.0)
    c = torch.clamp_min(_t(p["contrast"], dev), 0.1)
    color = color * b
    color = (color - 0.5) * c + 0.5
    gray = (color[..., 0] * 0.299 + color[..., 1] * 0.587
            + color[..., 2] * 0.114)[..., None]
    color = _clip01(gray * (1.0 - s) + color * s)
    a_, b_, c_, d_, e_ = 2.51, 0.03, 2.43, 0.59, 0.14
    color = _clip01((color * (a_ * color + b_))
                    / (color * (c_ * color + d_) + e_))
    return torch.pow(torch.clamp_min(color, 0.0),
                     float(np.float32(1.0 / GAMMA)))


def frame(width: int, height: int, rows: Sequence[int], view: dict, aa: int,
          cap: int, device, dtype=torch.float32):
    """The uint8 planes (3, len(rows), width) of one sweep frame's rows,
    its f32 (len(rows), width, 3) image and each sample's count plane
    (aa², len(rows), width) with the limit, for the work count."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    offsets = aa_offsets_uv(aa, width)
    n, zx, zy, limit_f = escape_counts(width, height, rows, view, cap,
                                       offsets, device, dtype)
    acc = torch.zeros((len(rows), width, 3), dtype=torch.float32,
                      device=device)
    for k in range(len(offsets)):
        rgb = color_sample(n[k], zx[k], zy[k], limit_f, view)
        acc = acc + torch.stack(rgb, dim=-1)
    img = average_then_post(acc, len(offsets), view)
    return quantize8(img).permute(2, 0, 1), img, n, limit_f
