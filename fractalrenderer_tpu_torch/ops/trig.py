"""Polynomial inverse trig on tensors (the port's counterpart of
``fractalrenderer_tpu/ops/trig.py``).

The JAX package uses these polynomials where Mosaic has no atan2 lowering;
its Phoenix flow stripes read ``atan2`` on both the fused and the unfused
path, so the port keeps the same expression.  ``csrc/escape.cu`` has the
same polynomial as a device function (``poly_atan2``); the Mandelbulb's
non-integer-power DE step reads ``acos`` and ``atan2`` (``csrc/bulb.cu``
``poly_acos``).

Constants Python would fold in double (π, π/2) are written as the f32
values the JAX package's weak-typed arithmetic rounds them to, and the one
division is by a tensor on the operands' device, so CUDA divides exactly
(IEEE) instead of multiplying by a rounded reciprocal.
"""
from __future__ import annotations

import math

import numpy as np
import torch

PI = float(np.float32(math.pi))
PI_2 = float(np.float32(math.pi / 2.0))
# Remez coefficients for atan(t)/t on [0, 1], highest power first
ATAN_COEFFS = (-0.0117212, 0.05265332, -0.11643287, 0.19354346,
               -0.33262348, 0.99997726)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The IEEE (correctly rounded) f32 square root.  CUDA's is; PyTorch's
    vectorised CPU sqrt is not, but the f64 root of an f32 value rounded
    once to f32 is."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def atan(x: torch.Tensor) -> torch.Tensor:
    """arctan via the 11-term odd polynomial on [-1, 1] with the reciprocal
    range reduction atan(x) = π/2·sign(x) − atan(1/x)."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    ax = torch.abs(x)
    inv = ax > 1.0
    t = torch.where(inv, one / torch.clamp_min(ax, 1e-38), ax)
    s = t * t
    p = torch.full_like(x, ATAN_COEFFS[0])
    for c in ATAN_COEFFS[1:]:
        p = p * s + c
    r = t * p
    r = torch.where(inv, PI_2 - r, r)
    return torch.where(x < 0, -r, r)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Quadrant-correct arctan(y/x) with numpy.arctan2's conventions at
    x == 0 and y == 0 (to within the polynomial's ~2e-7)."""
    # keep x's sign when clamping tiny x: a negative x flushed to +1e-38
    # would land in the wrong quadrant
    tiny = torch.where(x < 0, torch.full_like(x, -1e-38),
                       torch.full_like(x, 1e-38))
    safe_x = torch.where(torch.abs(x) < 1e-38, tiny, x)
    base = atan(y / safe_x)
    add = torch.where(y >= 0, torch.full_like(base, PI),
                      torch.full_like(base, -PI))
    r = torch.where(x < 0, base + add, base)
    x_zero = x == 0
    r = torch.where(x_zero & (y > 0), torch.full_like(r, PI_2), r)
    r = torch.where(x_zero & (y < 0), torch.full_like(r, -PI_2), r)
    return torch.where(x_zero & (y == 0), torch.zeros_like(r), r)


def acos(x: torch.Tensor) -> torch.Tensor:
    """arccos(x) = atan2(sqrt(1 - x²), x) for x in [-1, 1]."""
    xc = torch.clamp(x, -1.0, 1.0)
    return atan2(sqrt(torch.clamp_min(1.0 - xc * xc, 0.0)), xc)
