"""Double-double Mandelbrot escape fields, precision tier 2 (the port's
counterpart of ``fractalrenderer_tpu/ops/dd_escape.py``).

Every pixel iterates z ← z² + c entirely in double-double (two f32s,
~2^-48 relative precision), covering zooms ~1e-6 … 1e-12 without a
reference orbit.  The mapping is the centered convention evaluated in dd:
c = center_dd + zoom_dd · uv.  Counting follows K1: update 0 (z1 = c) is
peeled, survivors are counted, pixels that never escape report the limit.

Two implementations of kernel K2 sit side by side:

- ``dd_escape_fields_cuda`` launches the hand-written CUDA kernel
  (csrc/dd_escape.cu) on the current stream; an optional trips buffer
  (``trips_buffer``) receives its per-warp counters, which
  ``decode_trips`` reads (K1's layout, ops/escape.py TRIP_FIELDS);
- ``dd_escape_fields_plain`` is the same computation as plain PyTorch
  elementwise ops in the JAX kernel's order (ops/dd.py).

``dd_escape_fields`` takes the plain version for a CPU device only; for a
CUDA device it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import dd
# K2's per-warp counters share K1's layout, buffer and decoder
from .escape import (TRIP_FIELDS, check_trips, decode_trips,  # noqa: F401
                     launch_warps, trips_buffer)

# Scalar-parameter vector layout, identical to the JAX package's
# (fractalrenderer_tpu/ops/dd_escape.py:30-32).
(D_CXH, D_CXL, D_CYH, D_CYL, D_ZH, D_ZL, D_LIMIT, D_BAIL2, D_OFFX,
 D_OFFY, D_ROW0) = range(11)
ND = 11

_EARLY_EXIT_EVERY = 16  # plain path: test for live pixels this often
_MAX_HEIGHT = 65535 * 8  # CUDA grid.y limit for the (32, 8) blocks

DD = Tuple[float, float]


def pack_dd_params(*, center_x_dd: DD, center_y_dd: DD, zoom_dd: DD,
                   iter_limit, bailout: float = 4.0,
                   offset: Tuple[float, float] = (0.0, 0.0),
                   row0=0.0) -> np.ndarray:
    """The 11 f32 parameters of a K2 launch, packed as the JAX
    ``dd_escape_fields`` packs them (dd_escape.py:162-169).  Unlike K1's,
    the limit is not clamped to a cap, and bail2 is ``bailout**2`` folded
    in double, then rounded once to f32."""
    params = np.zeros(ND, np.float32)
    params[D_CXH], params[D_CXL] = center_x_dd
    params[D_CYH], params[D_CYL] = center_y_dd
    params[D_ZH], params[D_ZL] = zoom_dd
    params[D_LIMIT] = max(1, int(iter_limit))
    params[D_BAIL2] = float(bailout) * float(bailout)
    params[D_OFFX], params[D_OFFY] = offset
    params[D_ROW0] = row0
    return params


def _check_launch(params: np.ndarray, width: int, height: int,
                  map_height: int, row0: int) -> int:
    """Validate a launch; returns the iteration limit."""
    if params.dtype != np.float32 or params.shape != (ND,):
        raise ValueError(f"params must be float32 of shape ({ND},), got "
                         f"{params.dtype} {params.shape}")
    if width < 1 or height < 1:
        raise ValueError(f"bad field size {width}x{height}")
    if height > _MAX_HEIGHT or width * height >= 1 << 31:
        raise ValueError(f"field size {width}x{height} is too large")
    if row0 < 0 or row0 + height > map_height:
        raise ValueError(f"band rows [{row0}, {row0 + height}) fall outside "
                         f"the image height {map_height}")
    limit = int(params[D_LIMIT])
    if not 1 <= limit < 1 << 24:
        raise ValueError("the iteration limit must be in [1, 2^24)")
    return limit


def dd_escape_fields_plain(params: np.ndarray, *, width: int, height: int,
                           map_height: int, row0: int,
                           device) -> Tuple[torch.Tensor, ...]:
    """K2 as plain PyTorch ops on ``device``: returns (n, zx, zy).  The
    CPU path of dd_escape_fields, and the comparator of the CUDA kernel on
    the card."""
    limit = _check_launch(params, width, height, map_height, row0)
    dev = torch.device(device)
    p = torch.from_numpy(params).to(dev)
    f32 = torch.float32
    shape = (height, width)

    rows = torch.arange(row0, row0 + height, dtype=torch.int32, device=dev)
    cols = torch.arange(width, dtype=torch.int32, device=dev)
    pyf = rows.to(f32)[:, None].expand(shape)
    pxf = cols.to(f32)[None, :].expand(shape)
    # centered mapping in dd: uv = (pix + off - 0.5*size)/size.y
    wf = torch.tensor(float(width), dtype=f32, device=dev)
    hf = torch.tensor(float(map_height), dtype=f32, device=dev)
    ux = (pxf + p[D_OFFX] - 0.5 * wf) / hf
    uy = (pyf + p[D_OFFY] - 0.5 * hf) / hf
    zoom = (p[D_ZH], p[D_ZL])
    cr = dd.dd_add((p[D_CXH], p[D_CXL]), dd.dd_mul_float(zoom, ux))
    ci = dd.dd_add((p[D_CYH], p[D_CYL]), dd.dd_mul_float(zoom, uy))
    bail2 = p[D_BAIL2]

    # peel update 0: z1 = c
    zr, zi = cr, ci
    mag = dd.ddc_mag2(cr, ci)
    n = torch.zeros(shape, dtype=torch.int32, device=dev)
    for i in range(1, limit):
        alive = mag <= bail2
        if (i - 1) % _EARLY_EXIT_EVERY == 0 and not bool(alive.any()):
            break
        n += alive
        nzr, nzi = dd.ddc_square_add(zr, zi, cr, ci)
        zr = tuple(torch.where(alive, a, b) for a, b in zip(nzr, zr))
        zi = tuple(torch.where(alive, a, b) for a, b in zip(nzi, zi))
        mag = torch.where(alive, dd.ddc_mag2(zr, zi), mag)

    lim = torch.tensor(limit, dtype=torch.int32, device=dev)
    n = torch.where(mag <= bail2, lim, n)
    return n, zr[0] + zr[1], zi[0] + zi[1]


def dd_escape_fields_cuda(params: np.ndarray, *, width: int, height: int,
                          map_height: int, row0: int, device,
                          trips: Optional[torch.Tensor] = None,
                          ) -> Tuple[torch.Tensor, ...]:
    """Launch the CUDA kernel K2 on ``device`` (same signature and results
    as dd_escape_fields_plain).  ``trips``, a buffer from trips_buffer, is
    zeroed and filled with the launch's per-warp counters (decode_trips
    reads it).  Counts its launches in ``dd_escape_fields_cuda.launches``."""
    from . import _cuda

    _check_launch(params, width, height, map_height, row0)
    dev = _cuda.cuda_device(device)
    check_trips(trips, launch_warps(width, height), dev)
    params = np.ascontiguousarray(params)
    lib = _cuda.load_library()
    with torch.cuda.device(dev):
        outs = (torch.empty((height, width), dtype=torch.int32, device=dev),
                torch.empty((height, width), dtype=torch.float32, device=dev),
                torch.empty((height, width), dtype=torch.float32, device=dev))
        if trips is not None:
            trips.zero_()
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fr_dd_escape(params.ctypes.data, width, height, map_height,
                              row0, *(o.data_ptr() for o in outs), stream,
                              None if trips is None else trips.data_ptr())
    _cuda.check(lib, rc, "dd escape")
    dd_escape_fields_cuda.launches += 1
    return outs


dd_escape_fields_cuda.launches = 0


def dd_escape_fields(width: int, height: int, *, center_x_dd: DD,
                     center_y_dd: DD, zoom_dd: DD, max_iter: int,
                     bailout: float = 4.0,
                     offset: Tuple[float, float] = (0.0, 0.0),
                     iter_limit=None, row0: int = 0,
                     map_height: Optional[int] = None,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """Double-double escape fields {"n", "zx", "zy"} on ``device`` (the JAX
    ``dd_escape_fields`` signature, with ``device`` for ``interpret``);
    zx/zy are the hi + lo sums of the final z."""
    if max_iter >= 1 << 24:
        raise ValueError("max_iter must be < 2^24 (f32 counter precision)")
    params = pack_dd_params(
        center_x_dd=center_x_dd, center_y_dd=center_y_dd, zoom_dd=zoom_dd,
        iter_limit=max_iter if iter_limit is None else iter_limit,
        bailout=bailout, offset=offset, row0=row0)
    dev = torch.device(device)
    if dev.type == "cpu":
        impl = dd_escape_fields_plain
    elif dev.type == "cuda":
        impl = dd_escape_fields_cuda
    else:
        raise ValueError(f"unsupported device {dev}")
    outs = impl(params, width=width, height=height,
                map_height=int(height if map_height is None else map_height),
                row0=int(row0), device=dev)
    return dict(zip(("n", "zx", "zy"), outs))
