"""Escape-time fields for one AA sample (the port's counterpart of
``fractalrenderer_tpu/ops/escape.py``): the Mandelbrot, Julia, Burning Ship
and Phoenix families.

Two implementations of kernel K1 sit side by side:

- ``escape_fields_cuda`` launches the hand-written CUDA kernel
  (csrc/escape.cu) on the current stream;
- ``escape_fields_plain`` is the same computation as plain PyTorch
  elementwise ops, one op per op of the JAX kernel and in its order, in f32.

``escape_fields`` takes the plain version for a CPU device only; for a CUDA
device it launches the kernel or raises.

Outputs per pixel (fields mode), in this order:
  n  (int32) — index of the escaping update, or the limit if never escaped
  zx, zy (f32) — z after the escaping update (or after ``limit`` updates);
      pixels skipped by the analytic interior test report z = 0
  trap (f32, ``track_trap``) — orbit-trap minimum: Mandelbrot's combined
      trap on the new z, Burning Ship's |‖z‖ - r| on the pre-update z; the
      other families report the constant initial trap (0), as the JAX
      kernel does
  stripe (f32, ``track_stripe``) — Burning Ship's sum of sin(zy·d) on the
      pre-update z (0 for the other families)
  dzx, dzy (f32, ``track_deriv``, Mandelbrot only) — dz/dc, dz ← 2·z·dz + 1
      on the pre-update z
With ``fused_color`` the colour planes r, g, b (f32) come out instead.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import coloring, mapping, trig
from . import palettes as pal

# Scalar-parameter vector layout, identical to the JAX package's
# (fractalrenderer_tpu/ops/escape.py:46-52).
P_CX, P_CY, P_ZOOM, P_OFFX, P_OFFY, P_BAIL2, P_LIMIT = range(7)
P_A0, P_A1, P_A2, P_A3 = 7, 8, 9, 10
P_ROW0 = 11  # global row of this band's first output row
P_COFF, P_CSCALE, P_BRIGHT, P_SAT, P_CONTRAST, P_BAILOUT = range(12, 18)
P_STRIPE = 18
NPARAMS = 19

FAMILIES = ("mandelbrot", "julia", "burning_ship", "phoenix")
# palette family each escape family colours with in the fused epilogue
PALETTE_FAMILY = {"mandelbrot": "classic", "julia": "enhanced",
                  "burning_ship": "enhanced", "phoenix": "classic"}

# Colour table: the palette spec (palettes.palette_table) plus the two
# constants Python folds in double before they reach f32.
T_INV_GAMMA = pal.TABLE_LEN
T_LOG2 = pal.TABLE_LEN + 1
COLOR_TABLE_LEN = pal.TABLE_LEN + 2

# Launch flags of fr_escape (csrc/escape.cu, keep the two in sync).
F_FUSED, F_SKIP, F_JULIA, F_TRAP, F_STRIPE, F_DERIV, F_CLAMP, F_POST = (
    1 << i for i in range(8))
# fr_escape's output slot of each field (fused mode: r, g, b in 0-2)
OUTPUT_SLOTS = {"n": 0, "zx": 1, "zy": 2, "trap": 3, "stripe": 4, "dzx": 5,
                "dzy": 6}

_MAX_LIMIT = (1 << 24) - 1  # the f32 counter ceiling of the JAX kernel
_EARLY_EXIT_EVERY = 16  # plain path: test for live pixels this often
_sqrt = trig.sqrt  # the IEEE root on both devices
# CUDA grid limits for the (32, 8) blocks: grid.y <= 65535
_MAX_HEIGHT = 65535 * 8

FusedColor = Tuple[int, int, bool, bool]


def pack_params(*, center_x, center_y, zoom, iter_limit, family="mandelbrot",
                bailout=4.0, offset=(0.0, 0.0), julia_c=(0.0, 0.0),
                phoenix_p=0.0, phoenix_r=0.0, trap_radius=0.5,
                stripe_density=10.0, row0=0.0, color_offset=0.0,
                color_scale=1.0, brightness=1.0, saturation=1.2,
                contrast=1.1) -> np.ndarray:
    """The 19 f32 parameters of a launch, slot for slot as the JAX
    ``escape_fields`` packs them (escape.py:502-528)."""
    f = np.float32
    if family == "phoenix":
        bail2 = f(4.0)  # fixed bailout (phoenix.comp:77)
        a = (julia_c[0], julia_c[1], phoenix_p, phoenix_r)
    elif family == "julia":
        bail2 = f(bailout) * f(bailout)
        a = (julia_c[0], julia_c[1], 0.0, 0.0)
    elif family == "burning_ship":
        bail2 = f(bailout) * f(bailout)
        a = (trap_radius, stripe_density, 0.0, 0.0)
    elif family == "mandelbrot":
        bail2 = f(bailout) * f(bailout)
        a = (0.0, 0.0, 0.0, 0.0)
    else:
        raise ValueError(f"unknown family {family!r}")
    params = np.zeros(NPARAMS, np.float32)
    params[P_CX] = f(center_x)
    params[P_CY] = f(center_y)
    params[P_ZOOM] = f(zoom)
    params[P_OFFX] = f(offset[0])
    params[P_OFFY] = f(offset[1])
    params[P_BAIL2] = bail2
    # update 0 is always applied, so a limit below 1 is meaningless
    params[P_LIMIT] = np.maximum(f(iter_limit), f(1.0))
    params[P_A0:P_A3 + 1] = [f(v) for v in a]
    params[P_ROW0] = f(row0)
    params[P_COFF] = f(color_offset)
    params[P_CSCALE] = f(color_scale)
    params[P_BRIGHT] = f(brightness)
    params[P_SAT] = f(saturation)
    params[P_CONTRAST] = f(contrast)
    params[P_BAILOUT] = f(bailout)
    params[P_STRIPE] = f(stripe_density)
    return params


def color_table(palette_mode: int, palette_family: str = "classic"
                ) -> np.ndarray:
    """The f32 constants the fused epilogue reads (see csrc/escape.cu)."""
    tab = np.zeros(COLOR_TABLE_LEN, np.float32)
    tab[:pal.TABLE_LEN] = pal.palette_table(palette_mode, palette_family)
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


def interior_skip_mask(params: np.ndarray, *, width: int, height: int,
                       map_height: int, row0: int, device) -> torch.Tensor:
    """The pixels of a Mandelbrot launch that the analytic interior skip
    leaves out (they never enter the loop): the plain K1's own mapping and
    interior predicate, as a (height, width) bool tensor on ``device``."""
    p = torch.from_numpy(params).to(device)
    rows = torch.arange(row0, row0 + height, dtype=torch.float32,
                        device=p.device)
    cols = torch.arange(width, dtype=torch.float32, device=p.device)
    cr, ci = mapping.map_centered(
        cols[None, :].expand(height, width),
        rows[:, None].expand(height, width), width, map_height, p[P_CX],
        p[P_CY], p[P_ZOOM], p[P_OFFX], p[P_OFFY])
    return _cardioid_or_bulb(cr, ci)


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


def _check_options(family: str, fused_color: Optional[FusedColor],
                   interior_skip: bool, track_trap: bool,
                   track_stripe: bool, track_deriv: bool) -> None:
    """The JAX kernel's static preconditions (escape.py:473-486, 536-537)."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}")
    if (interior_skip or track_deriv) and family != "mandelbrot":
        raise ValueError("the interior skip and the derivative are "
                         "Mandelbrot-only")
    if fused_color is not None:
        if track_trap or track_stripe or track_deriv:
            raise ValueError("fused coloring needs a plain (no "
                             "trap/stripe/deriv) render")
        if family == "mandelbrot" and fused_color[1] == 2:
            raise ValueError("mandelbrot interior_style 2 (trap glow) reads "
                             "the tracked trap field; use the unfused "
                             "pipeline")


def output_names(family: str, fused: bool, track_trap: bool = False,
                 track_stripe: bool = False,
                 track_deriv: bool = False) -> Tuple[str, ...]:
    """The names of a launch's outputs, in the order they come out."""
    if fused:
        return ("r", "g", "b")
    names = ["n", "zx", "zy"]
    if track_trap:
        names.append("trap")
    if track_stripe:
        names.append("stripe")
    if track_deriv and family == "mandelbrot":
        names += ["dzx", "dzy"]
    return tuple(names)


def escape_fields_plain(params: np.ndarray, *, width: int, height: int,
                        map_height: int, row0: int, max_iter_cap: int,
                        interior_skip: bool,
                        fused_color: Optional[FusedColor],
                        device, family: str = "mandelbrot",
                        use_julia: bool = False, track_trap: bool = False,
                        track_stripe: bool = False,
                        track_deriv: bool = False) -> Tuple[torch.Tensor, ...]:
    """K1 as plain PyTorch ops on ``device``: returns the fields named by
    ``output_names``, or (r, g, b) with ``fused_color``.  The CPU path of
    escape_fields, and the comparator of the CUDA kernel on the card."""
    _check_launch(params, width, height, map_height, row0, max_iter_cap)
    _check_options(family, fused_color, interior_skip, track_trap,
                   track_stripe, track_deriv)
    dev = torch.device(device)
    p = torch.from_numpy(params).to(dev)
    # the static cap is real: the limit is clamped to it and to the f32
    # counter ceiling (JAX escape.py:185-188)
    limit_f = np.minimum(params[P_LIMIT],
                         np.float32(min(max_iter_cap, _MAX_LIMIT)))
    limit = int(limit_f)
    f32 = torch.float32
    shape = (height, width)

    rows = torch.arange(row0, row0 + height, dtype=torch.int32, device=dev)
    cols = torch.arange(width, dtype=torch.int32, device=dev)
    pyf = rows.to(f32)[:, None].expand(shape)
    pxf = cols.to(f32)[None, :].expand(shape)
    # map_uv is the same arithmetic as map_centered (mapping.py)
    mx, my = mapping.map_centered(pxf, pyf, width, map_height, p[P_CX],
                                  p[P_CY], p[P_ZOOM], p[P_OFFX], p[P_OFFY])
    zeros = torch.zeros(shape, dtype=f32, device=dev)
    if family == "julia":
        zx0, zy0 = mx, my
        cr, ci = p[P_A0], p[P_A1]
    else:
        zx0, zy0 = zeros, zeros
        cr, ci = mx, my
    add_re, add_im = (p[P_A0], p[P_A1]) if use_julia else (cr, ci)
    pp, rr = p[P_A2], p[P_A3]
    trap_r = p[P_A0] if family == "burning_ship" else p.new_zeros(())
    stripe_d = p[P_A1]
    bail2 = p[P_BAIL2]

    # Peel update 0 (always applied, as in the shaders).
    sqx0 = zx0 * zx0
    sqy0 = zy0 * zy0
    if family == "burning_ship":
        x1 = sqx0 - sqy0 + cr
        y1 = torch.abs((2.0 * zx0) * zy0) + ci
    elif family == "phoenix":
        x1 = sqx0 - sqy0 + add_re + rr * 0.0 + pp * zx0
        y1 = (2.0 * zx0) * zy0 + add_im + rr * 0.0 + pp * zy0
    else:
        x1 = sqx0 - sqy0 + cr
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
    px, py = zx0, zy0

    if track_trap:
        if family == "mandelbrot":
            # trap of update 0 (on z1), mandelbrot.comp:162-166
            trap = torch.minimum(torch.full(shape, 1e20, dtype=f32,
                                            device=dev),
                                 _combined_trap(x1, y1, cr, ci))
        else:
            # pre-update-0 trap on z0 = 0: min(1e10, |0 - r|)
            trap = torch.ones(shape, dtype=f32, device=dev) * torch.minimum(
                torch.tensor(1e10, dtype=f32, device=dev),
                torch.abs(0.0 - trap_r))
    if track_stripe:
        stripe = zeros  # pre-update-0 term sin(0 * d) = 0
    if track_deriv:
        # after update 0: dz_1 = 2*z0*dz0 + 1 = 1
        dzx = torch.ones(shape, dtype=f32, device=dev)
        dzy = zeros

    n = torch.zeros(shape, dtype=torch.int32, device=dev)
    for i in range(1, limit):
        mag2 = sqx + sqy
        alive = mag2 <= bail2
        if (i - 1) % _EARLY_EXIT_EVERY == 0 and not bool(alive.any()):
            break
        n += alive
        if family == "burning_ship":
            # traps/stripes use the PRE-update z (burning_ship.comp:228-238)
            if track_trap:
                t = torch.abs(_sqrt(mag2) - trap_r)
                trap = torch.where(alive, torch.minimum(trap, t), trap)
            if track_stripe:
                stripe = torch.where(alive,
                                     stripe + torch.sin(zy * stripe_d),
                                     stripe)
            x = sqx - sqy + cr
            y = torch.abs((2.0 * zx) * zy) + ci
        elif family == "phoenix":
            # phoenix.comp:63-67 — two-term recurrence
            x = sqx - sqy + add_re + rr * px + pp * zx
            y = (2.0 * zx) * zy + add_im + rr * py + pp * zy
            px = torch.where(alive, zx, px)
            py = torch.where(alive, zy, py)
        else:
            x = sqx - sqy + cr
            y = (2.0 * zx) * zy + ci
        if track_deriv:
            ndx = 2.0 * (zx * dzx - zy * dzy) + 1.0
            ndy = 2.0 * (zx * dzy + zy * dzx)
            dzx = torch.where(alive, ndx, dzx)
            dzy = torch.where(alive, ndy, dzy)
        zx = torch.where(alive, x, zx)
        zy = torch.where(alive, y, zy)
        sqx = zx * zx
        sqy = zy * zy
        if family == "mandelbrot" and track_trap:
            # combined trap on the updated z (mandelbrot.comp:162-166)
            trap = torch.where(alive, torch.minimum(
                trap, _combined_trap(zx, zy, cr, ci, sqx, sqy)), trap)

    # Interior pixels (never escaped) report n = limit.
    lim = torch.tensor(limit, dtype=torch.int32, device=dev)
    n = torch.where(sqx + sqy <= bail2, lim, n)
    if skip is not None:
        n = torch.where(skip, lim, n)
        zx = torch.where(skip, zero, zx)
        zy = torch.where(skip, zero, zy)
    if fused_color is None:
        outs = [n, zx, zy]
        if track_trap:
            outs.append(trap)
        if track_stripe:
            outs.append(stripe)
        if track_deriv:
            outs += [dzx, dzy]
        return tuple(outs)

    palette_mode, interior_style, clamp_mins, with_post = fused_color
    cp = coloring.ColorParams(
        max_iterations=torch.tensor(limit_f, dtype=f32, device=dev),
        bailout=p[P_BAILOUT], palette_mode=palette_mode,
        color_offset=p[P_COFF], color_scale=p[P_CSCALE],
        interior_style=interior_style, phoenix_stripe_control=p[P_STRIPE])
    if family == "mandelbrot":
        rgb = coloring.color_mandelbrot_planar(
            n, zx, zy, torch.full(shape, 1e20, dtype=f32, device=dev), cp)
    elif family == "burning_ship":
        rgb = coloring.color_burning_ship_planar(
            n, zx, zy, torch.full(shape, 1e10, dtype=f32, device=dev),
            zeros, cp)
    elif family == "phoenix":
        rgb = coloring.color_phoenix_planar(n, zx, zy, cp)
    else:
        rgb = coloring.color_julia_planar(n, zx, zy, cp)
    if with_post:
        rgb = coloring.post_chain_planar(*rgb, p[P_BRIGHT], p[P_SAT],
                                         p[P_CONTRAST], clamp_mins=clamp_mins)
    return tuple(rgb)


def _combined_trap(zx, zy, cr, ci, sqx=None, sqy=None):
    """Mandelbrot's combined orbit trap: min(|z|, distance to the axes,
    |z - c|)."""
    if sqx is None:
        sqx, sqy = zx * zx, zy * zy
    mag = _sqrt(sqx + sqy)
    d_axes = torch.minimum(torch.abs(zx), torch.abs(zy))
    dxc = zx - cr
    dyc = zy - ci
    d_c = _sqrt(dxc * dxc + dyc * dyc)
    return torch.minimum(mag, torch.minimum(d_axes, d_c))


def escape_fields_cuda(params: np.ndarray, *, width: int, height: int,
                       map_height: int, row0: int, max_iter_cap: int,
                       interior_skip: bool,
                       fused_color: Optional[FusedColor],
                       device, family: str = "mandelbrot",
                       use_julia: bool = False, track_trap: bool = False,
                       track_stripe: bool = False,
                       track_deriv: bool = False) -> Tuple[torch.Tensor, ...]:
    """Launch the CUDA kernel K1 on ``device`` (same signature and results
    as escape_fields_plain).  Counts its launches in
    ``escape_fields_cuda.launches``."""
    from . import _cuda

    _check_launch(params, width, height, map_height, row0, max_iter_cap)
    _check_options(family, fused_color, interior_skip, track_trap,
                   track_stripe, track_deriv)
    dev = _cuda.cuda_device(device)
    params = np.ascontiguousarray(params)
    flags = ((F_SKIP if interior_skip else 0) | (F_JULIA if use_julia else 0)
             | (F_TRAP if track_trap else 0)
             | (F_STRIPE if track_stripe else 0)
             | (F_DERIV if track_deriv else 0))
    names = output_names(family, fused_color is not None, track_trap,
                         track_stripe, track_deriv)
    if fused_color is None:
        table = np.zeros(COLOR_TABLE_LEN, np.float32)
        interior_style = 0
        slots = [OUTPUT_SLOTS[name] for name in names]
    else:
        palette_mode, interior_style, clamp_mins, with_post = fused_color
        flags |= (F_FUSED | (F_CLAMP if clamp_mins else 0)
                  | (F_POST if with_post else 0))
        table = color_table(palette_mode, PALETTE_FAMILY[family])
        slots = [0, 1, 2]
    lib = _cuda.load_library()
    with torch.cuda.device(dev):
        outs = tuple(torch.empty((height, width), device=dev,
                                 dtype=torch.int32 if name == "n"
                                 else torch.float32) for name in names)
        ptrs = [None] * len(OUTPUT_SLOTS)
        for slot, o in zip(slots, outs):
            ptrs[slot] = o.data_ptr()
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fr_escape(FAMILIES.index(family), params.ctypes.data,
                           table.ctypes.data, width, height, map_height,
                           row0, max_iter_cap, flags, int(interior_style),
                           *ptrs, stream)
    _cuda.check(lib, rc, "escape")
    escape_fields_cuda.launches += 1
    return outs


escape_fields_cuda.launches = 0


def escape_fields(family: str, width: int, height: int, *,
                  center_x, center_y, zoom, max_iter: int,
                  bailout=4.0, offset=(0.0, 0.0),
                  julia_c=(0.0, 0.0), phoenix_p=0.0, phoenix_r=0.0,
                  use_julia: bool = False,
                  trap_radius=0.5, stripe_density=10.0,
                  track_trap: bool = False, track_stripe: bool = False,
                  iter_limit=None, row0: int = 0,
                  map_height: Optional[int] = None,
                  interior_skip: bool = False, track_deriv: bool = False,
                  fused_color=None, color_offset=0.0, color_scale=1.0,
                  brightness=1.0, saturation=1.2, contrast=1.1,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """Compute escape-time fields for one AA sample on ``device`` (the JAX
    ``escape_fields`` signature, with ``device`` for ``interpret``).

    ``max_iter`` is the static cap; ``iter_limit`` (defaults to max_iter)
    is clamped to it.  For a row band pass the band's global first row as
    ``row0`` and the full image height as ``map_height``.

    ``fused_color``: a ``(palette_mode, interior_style, clamp_mins[,
    with_post])`` tuple (no trap/stripe/deriv tracking) — the result is
    then the colour planes {"r", "g", "b"}; ``with_post`` (default True)
    also applies enhance/ACES/gamma, which is right only for single-sample
    renders.  As in the JAX package, ``interior_skip`` and ``track_deriv``
    act only for the Mandelbrot family.
    """
    if fused_color is not None:
        fused_color = (int(fused_color[0]), int(fused_color[1]),
                       bool(fused_color[2]),
                       bool(fused_color[3]) if len(fused_color) > 3
                       else True)
    interior_skip = bool(interior_skip and family == "mandelbrot")
    track_deriv = bool(track_deriv and family == "mandelbrot")
    params = pack_params(
        family=family, center_x=center_x, center_y=center_y, zoom=zoom,
        iter_limit=max_iter if iter_limit is None else iter_limit,
        bailout=bailout, offset=offset, julia_c=julia_c,
        phoenix_p=phoenix_p, phoenix_r=phoenix_r, trap_radius=trap_radius,
        stripe_density=stripe_density, row0=row0,
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
                interior_skip=interior_skip, fused_color=fused_color,
                device=dev, family=family, use_julia=bool(use_julia),
                track_trap=bool(track_trap),
                track_stripe=bool(track_stripe), track_deriv=track_deriv)
    names = output_names(family, fused_color is not None, track_trap,
                         track_stripe, track_deriv)
    return dict(zip(names, outs))
