"""Escape-time fields for one AA sample (the port's counterpart of
``fractalrenderer_tpu/ops/escape.py``), Mandelbrot family.

Two implementations of kernel K1 sit side by side:

- ``escape_fields_cuda`` launches the hand-written CUDA kernel
  (csrc/escape.cu) on the current stream;
- ``escape_fields_plain`` is the same computation as plain PyTorch
  elementwise ops, one op per op of the JAX kernel and in its order, in f32.

``escape_fields`` takes the plain version for a CPU device only; for a CUDA
device it launches the kernel or raises.

Outputs per pixel (fields mode):
  n  (int32) — index of the escaping update, or the limit if never escaped
  zx, zy (f32) — z after the escaping update (or after ``limit`` updates);
      pixels skipped by the analytic interior test report z = 0
With ``fused_color`` the colour planes r, g, b (f32) come out instead.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import coloring, mapping
from . import palettes as pal

# Scalar-parameter vector layout, identical to the JAX package's
# (fractalrenderer_tpu/ops/escape.py:46-52).
P_CX, P_CY, P_ZOOM, P_OFFX, P_OFFY, P_BAIL2, P_LIMIT = range(7)
P_A0, P_A1, P_A2, P_A3 = 7, 8, 9, 10
P_ROW0 = 11  # global row of this band's first output row
P_COFF, P_CSCALE, P_BRIGHT, P_SAT, P_CONTRAST, P_BAILOUT = range(12, 18)
P_STRIPE = 18
NPARAMS = 19

# Colour table: the palette spec (palettes.palette_table) plus the two
# constants Python folds in double before they reach f32.
T_INV_GAMMA = pal.TABLE_LEN
T_LOG2 = pal.TABLE_LEN + 1
COLOR_TABLE_LEN = pal.TABLE_LEN + 2

_MAX_LIMIT = (1 << 24) - 1  # the f32 counter ceiling of the JAX kernel
_EARLY_EXIT_EVERY = 16  # plain path: test for live pixels this often
# CUDA grid limits for the (32, 8) blocks: grid.y <= 65535
_MAX_HEIGHT = 65535 * 8

FusedColor = Tuple[int, int, bool, bool]


def pack_params(*, center_x, center_y, zoom, iter_limit, bailout=4.0,
                offset=(0.0, 0.0), row0=0.0, color_offset=0.0,
                color_scale=1.0, brightness=1.0, saturation=1.2,
                contrast=1.1, stripe_density=10.0) -> np.ndarray:
    """The 19 f32 parameters of a Mandelbrot launch, slot for slot as the
    JAX ``escape_fields`` packs them (escape.py:515-528)."""
    f = np.float32
    params = np.zeros(NPARAMS, np.float32)
    params[P_CX] = f(center_x)
    params[P_CY] = f(center_y)
    params[P_ZOOM] = f(zoom)
    params[P_OFFX] = f(offset[0])
    params[P_OFFY] = f(offset[1])
    params[P_BAIL2] = f(bailout) * f(bailout)
    # update 0 is always applied, so a limit below 1 is meaningless
    params[P_LIMIT] = np.maximum(f(iter_limit), f(1.0))
    params[P_ROW0] = f(row0)
    params[P_COFF] = f(color_offset)
    params[P_CSCALE] = f(color_scale)
    params[P_BRIGHT] = f(brightness)
    params[P_SAT] = f(saturation)
    params[P_CONTRAST] = f(contrast)
    params[P_BAILOUT] = f(bailout)
    params[P_STRIPE] = f(stripe_density)
    return params


def color_table(palette_mode: int) -> np.ndarray:
    """The f32 constants the fused epilogue reads (see csrc/escape.cu)."""
    tab = np.zeros(COLOR_TABLE_LEN, np.float32)
    tab[:pal.TABLE_LEN] = pal.palette_table(palette_mode, "classic")
    tab[T_INV_GAMMA] = 1.0 / coloring.GAMMA
    tab[T_LOG2] = coloring._LOG2
    return tab


def _cardioid_or_bulb(cr, ci):
    """Analytic main-cardioid / period-2-bulb membership (exact interior).
    q = (x-1/4)^2 + y^2; cardioid: q*(q + (x-1/4)) <= y^2/4; bulb:
    (x+1)^2 + y^2 <= 1/16."""
    xq = cr - 0.25
    y2 = ci * ci
    q = xq * xq + y2
    in_cardioid = q * (q + xq) <= 0.25 * y2
    xb = cr + 1.0
    in_bulb = xb * xb + y2 <= 0.0625
    return in_cardioid | in_bulb


def _check_launch(params: np.ndarray, width: int, height: int,
                  map_height: int, row0: int, max_iter_cap: int) -> None:
    if params.dtype != np.float32 or params.shape != (NPARAMS,):
        raise ValueError(f"params must be float32 of shape ({NPARAMS},), "
                         f"got {params.dtype} {params.shape}")
    if width < 1 or height < 1:
        raise ValueError(f"bad field size {width}x{height}")
    if height > _MAX_HEIGHT or width * height >= 1 << 31:
        raise ValueError(f"field size {width}x{height} is too large")
    if row0 < 0 or row0 + height > map_height:
        raise ValueError(f"band rows [{row0}, {row0 + height}) fall outside "
                         f"the image height {map_height}")
    if not 1 <= max_iter_cap < 1 << 24:
        raise ValueError("max_iter must be in [1, 2^24) (f32 counter "
                         "precision)")


def escape_fields_plain(params: np.ndarray, *, width: int, height: int,
                        map_height: int, row0: int, max_iter_cap: int,
                        interior_skip: bool,
                        fused_color: Optional[FusedColor],
                        device) -> Tuple[torch.Tensor, ...]:
    """K1 as plain PyTorch ops on ``device``: returns (n, zx, zy), or
    (r, g, b) with ``fused_color``.  The CPU path of escape_fields, and the
    comparator of the CUDA kernel on the card."""
    _check_launch(params, width, height, map_height, row0, max_iter_cap)
    dev = torch.device(device)
    p = torch.from_numpy(params).to(dev)
    # the static cap is real: the limit is clamped to it and to the f32
    # counter ceiling (JAX escape.py:185-188)
    limit_f = np.minimum(params[P_LIMIT],
                         np.float32(min(max_iter_cap, _MAX_LIMIT)))
    limit = int(limit_f)
    f32 = torch.float32

    rows = torch.arange(row0, row0 + height, dtype=torch.int32, device=dev)
    cols = torch.arange(width, dtype=torch.int32, device=dev)
    pyf = rows.to(f32)[:, None].expand(height, width)
    pxf = cols.to(f32)[None, :].expand(height, width)
    cr, ci = mapping.map_centered(pxf, pyf, width, map_height, p[P_CX],
                                  p[P_CY], p[P_ZOOM], p[P_OFFX], p[P_OFFY])
    bail2 = p[P_BAIL2]

    # Peel update 0 (always applied, as in the shaders).
    zx0 = torch.zeros((height, width), dtype=f32, device=dev)
    zy0 = torch.zeros((height, width), dtype=f32, device=dev)
    x1 = zx0 * zx0 - zy0 * zy0 + cr
    y1 = (2.0 * zx0) * zy0 + ci

    # Skipped pixels are poisoned through z itself so the escape latch is
    # false from the first step; they are restored as n = limit, z = 0.
    skip = _cardioid_or_bulb(cr, ci) if interior_skip else None
    big = torch.tensor(3.4e38, dtype=f32, device=dev)
    zero = torch.tensor(0.0, dtype=f32, device=dev)
    if skip is None:
        zx, zy, sqx, sqy = x1, y1, x1 * x1, y1 * y1
    else:
        zx = torch.where(skip, big, x1)
        zy = torch.where(skip, zero, y1)
        sqx = torch.where(skip, big, x1 * x1)
        sqy = torch.where(skip, big, y1 * y1)

    n = torch.zeros((height, width), dtype=torch.int32, device=dev)
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

    # Interior pixels (never escaped) report n = limit.
    interior = sqx + sqy <= bail2
    n = torch.where(interior, torch.tensor(limit, dtype=torch.int32,
                                           device=dev), n)
    if skip is not None:
        n = torch.where(skip, torch.tensor(limit, dtype=torch.int32,
                                           device=dev), n)
        zx = torch.where(skip, zero, zx)
        zy = torch.where(skip, zero, zy)
    if fused_color is None:
        return n, zx, zy

    palette_mode, interior_style, clamp_mins, with_post = fused_color
    cp = coloring.ColorParams(
        max_iterations=torch.tensor(limit_f, dtype=f32, device=dev),
        palette_mode=palette_mode,
        color_offset=p[P_COFF], color_scale=p[P_CSCALE],
        interior_style=interior_style)
    r, g, b = coloring.color_mandelbrot_planar(n, zx, zy, cp)
    if with_post:
        r, g, b = coloring.post_chain_planar(
            r, g, b, p[P_BRIGHT], p[P_SAT], p[P_CONTRAST],
            clamp_mins=clamp_mins)
    return r, g, b


def escape_fields_cuda(params: np.ndarray, *, width: int, height: int,
                       map_height: int, row0: int, max_iter_cap: int,
                       interior_skip: bool,
                       fused_color: Optional[FusedColor],
                       device) -> Tuple[torch.Tensor, ...]:
    """Launch the CUDA kernel K1 on ``device`` (same signature and results
    as escape_fields_plain).  Counts its launches in
    ``escape_fields_cuda.launches``."""
    from . import _cuda

    _check_launch(params, width, height, map_height, row0, max_iter_cap)
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA device, got {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available (use device='cpu' for the plain "
                           "PyTorch path)")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    params = np.ascontiguousarray(params)
    if fused_color is None:
        table = np.zeros(COLOR_TABLE_LEN, np.float32)
        dtypes = (torch.int32, torch.float32, torch.float32)
        palette_mode, interior_style, clamp_mins, with_post = 0, 0, False, \
            False
    else:
        palette_mode, interior_style, clamp_mins, with_post = fused_color
        if interior_style not in (0, 1):
            raise NotImplementedError(
                f"mandelbrot interior_style {interior_style} is not ported "
                "yet (ROADMAP Queue 1 item 2)")
        table = color_table(palette_mode)
        dtypes = (torch.float32,) * 3
    lib = _cuda.load_library()
    with torch.cuda.device(dev):
        outs = tuple(torch.empty((height, width), dtype=dt, device=dev)
                     for dt in dtypes)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fr_escape_mandelbrot(
            params.ctypes.data, table.ctypes.data, width, height, map_height,
            row0, max_iter_cap, int(interior_skip),
            int(fused_color is not None), interior_style, int(clamp_mins),
            int(with_post), outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("escape kernel launch failed: "
                           + lib.fr_cuda_error_string(rc).decode())
    escape_fields_cuda.launches += 1
    return outs


escape_fields_cuda.launches = 0


def escape_fields(family: str, width: int, height: int, *,
                  center_x, center_y, zoom, max_iter: int,
                  bailout=4.0, offset=(0.0, 0.0), iter_limit=None,
                  row0: int = 0, map_height: Optional[int] = None,
                  interior_skip: bool = False, fused_color=None,
                  color_offset=0.0, color_scale=1.0, brightness=1.0,
                  saturation=1.2, contrast=1.1,
                  device="cpu") -> Dict[str, torch.Tensor]:
    """Compute escape-time fields for one AA sample on ``device``.

    ``max_iter`` is the static cap; ``iter_limit`` (defaults to max_iter)
    is clamped to it.  For a row band pass the band's global first row as
    ``row0`` and the full image height as ``map_height``.

    ``fused_color``: a ``(palette_mode, interior_style, clamp_mins[,
    with_post])`` tuple — the result is then the colour planes
    {"r", "g", "b"}; ``with_post`` (default True) also applies
    enhance/ACES/gamma, which is right only for single-sample renders.
    """
    if family != "mandelbrot":
        raise NotImplementedError(
            f"escape family {family!r} is not ported yet (ROADMAP Queue 1 "
            "item 2)")
    if fused_color is not None:
        fused_color = (int(fused_color[0]), int(fused_color[1]),
                       bool(fused_color[2]),
                       bool(fused_color[3]) if len(fused_color) > 3
                       else True)
    params = pack_params(
        center_x=center_x, center_y=center_y, zoom=zoom,
        iter_limit=max_iter if iter_limit is None else iter_limit,
        bailout=bailout, offset=offset, row0=row0,
        color_offset=color_offset, color_scale=color_scale,
        brightness=brightness, saturation=saturation, contrast=contrast)
    dev = torch.device(device)
    if dev.type == "cpu":
        impl = escape_fields_plain
    elif dev.type == "cuda":
        impl = escape_fields_cuda
    else:
        raise ValueError(f"unsupported device {dev}")
    outs = impl(params, width=width, height=height,
                map_height=int(height if map_height is None else map_height),
                row0=int(row0), max_iter_cap=int(max_iter),
                interior_skip=bool(interior_skip), fused_color=fused_color,
                device=dev)
    names = ("n", "zx", "zy") if fused_color is None else ("r", "g", "b")
    return dict(zip(names, outs))
