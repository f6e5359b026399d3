"""Pixel → complex-plane mapping on tensors (the port's counterpart of
``fractalrenderer_tpu/ops/mapping.py``), with the reference's f32 operation
order so the plain path, the CUDA kernel (csrc/escape.cu) and the numpy
golden reference see bit-identical coordinates.

Two conventions exist in the reference shaders:

- *centered*: mandelbrot.comp:149-151 — ``uv = (pixel_pos - 0.5*res)/res.y``,
  ``c = center + uv*zoom`` (pixel_pos carries the AA offset, offsets are
  ``(sx, sy)/aa``, mandelbrot.comp:222-226).
- *uv*: julia.comp:222-264 / burning_ship.comp:318-343 / phoenix.comp:101-110
  — ``uv = texel/size (+ aa offset)``, ``x = cx + (uv.x-0.5)*zoom*aspect``,
  ``y = cy + (uv.y-0.5)*zoom``.

Every divisor is a tensor on the pixels' device: PyTorch's CUDA division by
a host scalar multiplies by the rounded reciprocal instead, which is not the
IEEE quotient the reference (and the kernel) computes.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def map_centered(px: torch.Tensor, py: torch.Tensor, width: int, height: int,
                 cx, cy, zoom, off_x, off_y):
    """mandelbrot.comp mapping.  px/py are f32 integer pixel coordinates;
    the scalars may be Python floats or 0-dim f32 tensors."""
    dev = px.device
    w = _f32(float(width), dev)
    h = _f32(float(height), dev)
    ux = (px + _f32(off_x, dev) - 0.5 * w) / h
    uy = (py + _f32(off_y, dev) - 0.5 * h) / h
    re = _f32(cx, dev) + ux * _f32(zoom, dev)
    im = _f32(cy, dev) + uy * _f32(zoom, dev)
    return re, im


def map_uv(px: torch.Tensor, py: torch.Tensor, width: int, height: int,
           cx, cy, zoom, off_x, off_y):
    """julia/burning-ship/phoenix mapping, factored as
    ``(px - 0.5*w)/h * zoom`` (aspect/w == 1/h), which makes it the same
    arithmetic as map_centered; the conventions differ only in their AA
    offsets (aa_offsets_uv vs aa_offsets_centered)."""
    return map_centered(px, py, width, height, cx, cy, zoom, off_x, off_y)


def aa_offsets_centered(aa: int) -> Tuple[Tuple[float, float], ...]:
    """mandelbrot.comp:222-226: offset = (sx, sy)/aa in pixel units."""
    aa = max(aa, 1)
    return tuple((sx / aa, sy / aa) for sy in range(aa) for sx in range(aa))


def aa_offsets_uv(aa: int, width: int) -> Tuple[Tuple[float, float], ...]:
    """julia.comp:253-259 — offsets in the shader's raw units (they get
    divided by size when applied; that division is folded into map_uv)."""
    aa = max(aa, 1)
    if aa <= 1:
        return ((0.0, 0.0),)
    pixel_size = 1.0 / width
    so = pixel_size / aa
    return tuple(
        (sx * so - so * (aa - 1) * 0.5, sy * so - so * (aa - 1) * 0.5)
        for sx in range(aa) for sy in range(aa)
    )
