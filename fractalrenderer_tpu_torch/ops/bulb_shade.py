"""The bulb frame's colour, kernel K4c: after K4b, one AA sample's hit and
sky shading, the AA sum and, on the frame's last sample, the post chain
and the store.

K4c replaces no TPU kernel: the JAX package leaves this shading to XLA
(``fractalrenderer_tpu/models/mandelbulb.py`` ``_render_sample``,
``shade_hit``/``sky_color`` at :189-237).  One thread per pixel of a band
recomputes the pixel's ray as K4b does (``bulb_math.ray_dirs`` operation
for operation), reads K4b's eight planes, shades a hit
(``bulb_math.shade_hit`` with the hash-noise palettes of the palette mode
and the next) or the sky, and adds the sample into an f32 accumulator; the
last sample divides by aa², runs enhance → ACES → gamma and stores the band
as f32, uint8 or uint16 (``quantize_image``'s expression).  The kernel is
bound by bytes (the planes in, the band out) and keeps every intermediate
in registers.

- ``pack_shade_params`` builds the sample's 14 f32 scalars (slots ``S_*``),
  the by-value struct of the launch;
- ``shade_fields_plain`` is the torch glue the bulb frame ran after K4b
  before K4c (``sample_rays``, ``shade_sample``, the AA sum, the post chain,
  ``quantize_image``), one sample per call: the CPU path, and the
  comparator of the kernel on the card;
- ``shade_fields_cuda`` launches K4c (``csrc/bulb.cu``) on the current
  stream;
- ``shade_fields`` takes the plain version for CPU planes; for CUDA planes
  it launches the kernel or raises.

Each takes K4b's planes (``march_fields``' dict), the accumulator returned
by the frame's previous sample (None on its first) and the sample's
vector, and returns the accumulator, or on the last sample the finished
band.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..utils.diag import span
from . import bulb_math as bm
from . import coloring, consts

(S_ROX, S_ROY, S_ROZ, S_FOV, S_POWER, S_TIME, S_COFF, S_CSCALE, S_BRIGHT,
 S_SAT, S_CONTRAST, S_MAXIT, S_OFFX, S_OFFY) = range(14)
NS = 14
# K4b's planes that K4c reads, in the C entry's order
PLANES = ("hit", "t", "d", "esc", "nx", "ny", "nz", "ao")
_STORES = {0: torch.float32, 8: torch.uint8, 16: torch.uint16}


def pack_shade_params(p: bm.BulbParams, ro, dyn_power,
                      offset=(0.0, 0.0)) -> np.ndarray:
    """The sample's f32 scalars: the camera origin, the field of view, the
    dynamic power, the time, the colour fields, the iteration limit and
    the sample's offset (each rounded to f32 as the frame's are)."""
    f = np.float32
    return np.array([f(ro[0]), f(ro[1]), f(ro[2]), f(p.fov), f(dyn_power),
                     f(p.time), f(p.color_offset), f(p.color_scale),
                     f(p.brightness), f(p.saturation), f(p.contrast),
                     f(p.max_iterations), f(offset[0]), f(offset[1])],
                    np.float32)


def _check(params, fields, acc, aa, row0, map_height, palette_mode,
           quantize):
    """The band's (rows, width); raises on a bad argument."""
    if params.dtype != np.float32 or params.shape != (NS,):
        raise ValueError(f"params must be float32 of shape ({NS},), got "
                         f"{params.dtype} {params.shape}")
    hit = fields["hit"]
    if hit.dim() != 2:
        raise ValueError(f"K4b's planes are (rows, width), got "
                         f"{tuple(hit.shape)}")
    rows, width = hit.shape
    if width < 1 or rows < 1 or width * rows * 3 >= 1 << 31:
        raise ValueError(f"bad band size {width}x{rows}")
    if row0 < 0 or row0 + rows > map_height:
        raise ValueError(f"band rows [{row0}, {row0 + rows}) are not rows "
                         f"of the image height {map_height}")
    if aa < 1 or not 0 <= palette_mode <= 5 or quantize not in _STORES:
        raise ValueError(f"bad aa {aa}, palette mode {palette_mode} or "
                         f"quantize {quantize}")
    for name in PLANES:
        f = fields[name]
        if (f.dtype != torch.float32 or tuple(f.shape) != (rows, width)
                or f.device != hit.device or not f.is_contiguous()):
            raise ValueError(f"plane {name} must be a contiguous float32 "
                             f"{(rows, width)} tensor on {hit.device}, got "
                             f"{f.dtype} {tuple(f.shape)} on {f.device}")
    if acc is not None and (acc.dtype != torch.float32
                            or tuple(acc.shape) != (rows, width, 3)
                            or acc.device != hit.device
                            or not acc.is_contiguous()):
        raise ValueError(f"the accumulator must be a contiguous float32 "
                         f"{(rows, width, 3)} tensor on {hit.device}")
    return rows, width


# ---------------------------------------------------------------------------
# The plain version: the bulb frame's torch glue
# ---------------------------------------------------------------------------

def upload_scalars(params: np.ndarray, device) -> torch.Tensor:
    """``params`` as one f32 vector on ``device``, whose elements are the
    glue's 0-dim scalars."""
    return torch.tensor(params, dtype=torch.float32, device=device)


def sample_rays(scalars: torch.Tensor, params: np.ndarray, width: int,
                rows: int, row0: int, map_height: int):
    """The sample's ray directions over the band: the pixel grid (x + ox,
    y + oy + row0) through ``bulb_math.ray_dirs``, with the camera from
    ``scalars`` (:func:`upload_scalars`)."""
    dev = scalars.device
    ro_t = (scalars[S_ROX], scalars[S_ROY], scalars[S_ROZ])
    f32 = torch.float32
    pyg = torch.arange(rows, dtype=f32, device=dev)[:, None] \
        .expand(rows, width)
    pxg = torch.arange(width, dtype=f32, device=dev)[None, :] \
        .expand(rows, width)
    pxg = pxg + float(params[S_OFFX])
    pyg = pyg + float(params[S_OFFY])
    if row0:
        pyg = pyg + float(row0)
    return bm.ray_dirs(pxg, pyg, width, map_height, ro_t, scalars[S_FOV])


def shade_sample(fields: Dict[str, torch.Tensor], rays, scalars, *,
                 palette_mode: int, max_iterations: int) -> torch.Tensor:
    """One sample's colour, (rows, width, 3): ``bulb_math.shade_hit`` at
    the hits, ``sky_color`` elsewhere."""
    hit = fields["hit"] > 0.5
    t = fields["t"]
    ro_t = (scalars[S_ROX], scalars[S_ROY], scalars[S_ROZ])
    pos = tuple(o + r * t for o, r in zip(ro_t, rays))
    pt = bm.BulbParams(max_iterations=max_iterations,
                       palette_mode=palette_mode,
                       color_offset=scalars[S_COFF],
                       color_scale=scalars[S_CSCALE], time=scalars[S_TIME])
    hit_color = bm.shade_hit(pos, (fields["nx"], fields["ny"], fields["nz"]),
                             rays, fields["d"], fields["esc"], t, pt,
                             scalars[S_POWER], ao_sum=fields["ao"])
    return torch.where(hit[..., None], hit_color, bm.sky_color(rays))


def shade_fields_plain(fields: Dict[str, torch.Tensor],
                       acc: Optional[torch.Tensor], params: np.ndarray, *,
                       aa: int, last: bool, row0: int, map_height: int,
                       palette_mode: int, quantize: int = 0, scalars=None,
                       rays=None) -> torch.Tensor:
    """K4c as plain PyTorch ops (same signature and result as
    shade_fields_cuda).  ``scalars`` (:func:`upload_scalars` of the frame)
    and ``rays`` (:func:`sample_rays` of the sample) may come from the
    caller, which a CPU frame computes before its march; otherwise they are
    computed here.  Runs the shading in the span ``bulb.shade``, the AA sum,
    the post chain and the quantize each in ``bulb.post``."""
    rows, width = _check(params, fields, acc, aa, row0, map_height,
                         palette_mode, quantize)
    dev = fields["hit"].device
    if scalars is None:
        scalars = upload_scalars(params, dev)
    if rays is None:
        rays = sample_rays(scalars, params, width, rows, row0, map_height)
    with span("bulb.shade"):
        sample = shade_sample(fields, rays, scalars,
                              palette_mode=palette_mode,
                              max_iterations=int(params[S_MAXIT]))
    with span("bulb.post"):
        if acc is None:
            acc = torch.zeros((rows, width, 3), dtype=torch.float32,
                              device=dev)
        acc = acc + sample
    if not last:
        return acc
    with span("bulb.post"):
        color = acc / consts.f32(aa * aa, dev)
        color = coloring.enhance_color(color, scalars[S_BRIGHT],
                                       scalars[S_SAT], scalars[S_CONTRAST])
        color = coloring.gamma_correct(coloring.aces_tonemap(color))
    if quantize:
        with span("bulb.post"):
            color = coloring.quantize_image(color, bit_depth=quantize)
    return color


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

def shade_fields_cuda(fields: Dict[str, torch.Tensor],
                      acc: Optional[torch.Tensor], params: np.ndarray, *,
                      aa: int, last: bool, row0: int, map_height: int,
                      palette_mode: int, quantize: int = 0) -> torch.Tensor:
    """Launch K4c (csrc/bulb.cu) on the planes' device (the signature and
    result of shade_fields_plain, whose ``scalars`` and ``rays`` the kernel
    does without: it takes ``params`` by value and recomputes each ray).
    The accumulator and the band are new ``torch.empty`` tensors.  Counts
    its launches in ``shade_fields_cuda.launches``."""
    from . import _cuda

    rows, width = _check(params, fields, acc, aa, row0, map_height,
                         palette_mode, quantize)
    dev = _cuda.cuda_device(fields["hit"].device)
    params = np.ascontiguousarray(params)
    lib = _cuda.load_library()
    first = acc is None
    with torch.cuda.device(dev):
        if first and not last:
            acc = torch.empty((rows, width, 3), dtype=torch.float32,
                              device=dev)
        out = torch.empty((rows, width, 3), dtype=_STORES[quantize],
                          device=dev) if last else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fr_bulb_shade(
            params.ctypes.data, width, rows, int(row0), int(map_height),
            int(aa), int(first), int(bool(last)), int(palette_mode),
            int(quantize), *(fields[k].data_ptr() for k in PLANES),
            None if acc is None else acc.data_ptr(),
            None if out is None else out.data_ptr(), stream)
    _cuda.check(lib, rc, "bulb shade")
    shade_fields_cuda.launches += 1
    return out if last else acc


shade_fields_cuda.launches = 0


def shade_fields(fields: Dict[str, torch.Tensor],
                 acc: Optional[torch.Tensor], params: np.ndarray, *,
                 aa: int, last: bool, row0: int, map_height: int,
                 palette_mode: int, quantize: int = 0, scalars=None,
                 rays=None) -> torch.Tensor:
    """One sample's colour on the planes' device: the plain version (with
    the caller's ``scalars`` and ``rays``) for CPU planes, K4c (in the span
    ``bulb.shade``) for CUDA planes."""
    kw = dict(aa=aa, last=last, row0=row0, map_height=map_height,
              palette_mode=palette_mode, quantize=quantize)
    dev = fields["hit"].device
    if dev.type == "cpu":
        return shade_fields_plain(fields, acc, params, scalars=scalars,
                                  rays=rays, **kw)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    with span("bulb.shade"):
        return shade_fields_cuda(fields, acc, params, **kw)
