"""Mandelbulb math on tensors — distance estimator, camera, shading (the
port's counterpart of ``fractalrenderer_tpu/ops/bulb_math.py``).

Ports shaders/mandelbulb.comp:
- DE: power-θφ triplex formula with derivative tracking (:96-108), and the
  trig-free step for static integer powers (complex squaring chains)
- camera: y-rotated orbit with animated distance/power (:192-198)
- shading: Phong + rim + glow + filament + AO + depth fog (:133-167)

Each function follows the JAX one expression for expression, in f32.  The
DE steps use only +, −, ×, ÷ and the IEEE square root (``trig.sqrt``) on
the integer path, so they are bit-equal to the numpy reference there; the
trig path reads ``trig.acos``/``trig.atan2`` and torch's ``pow``/``sin``/
``cos``.  Every divisor is a tensor on the operands' device, so CUDA
divides exactly rather than by a rounded reciprocal; the constant ones and
the fixed colours come from ``consts.f32``, built once per device, so the
glue makes no copy that waits for the stream.  ``csrc/bulb.cu``
repeats the DE steps, ``ray_dirs`` and ``de_finish`` operation for
operation in K4a and K4b, and ``ray_dirs``, ``shade_hit`` and
``sky_color`` in K4c, the kernel that colours the frame after K4b
(``ops/bulb_shade.py``, whose plain version calls these functions).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np
import torch

from . import consts
from . import palettes as pal
from . import trig

MAX_STEPS = 200
MAX_DIST = 10.0

_f32 = np.float32


@dataclass(frozen=True)
class BulbParams:
    camera_distance: float = 3.0
    rotation_y: float = 0.0
    power: float = 8.0
    max_iterations: int = 256
    color_offset: float = 0.0
    color_scale: float = 1.0
    palette_mode: int = 0
    time: float = 0.0
    fov: float = 1.0
    rotation_speed: float = 0.3
    brightness: float = 1.0
    saturation: float = 1.0
    contrast: float = 1.0
    aa_samples: int = 1

    def clamped(self) -> "BulbParams":
        """Input clamps from mandelbulb.comp:177-190."""
        return replace(
            self,
            camera_distance=max(self.camera_distance, 0.1),
            power=min(max(self.power, 2.0), 16.0),
            max_iterations=min(max(self.max_iterations, 1), 1024),
            color_scale=max(self.color_scale, 0.1),
            palette_mode=min(max(self.palette_mode, 0), 5),
            fov=min(max(self.fov, 0.1), 3.0),
            rotation_speed=self.rotation_speed if self.rotation_speed != 0.0
            else 0.3,
            brightness=max(self.brightness, 0.1),
            saturation=max(self.saturation, 0.0),
            contrast=max(self.contrast, 0.1),
        )


def camera_setup(p: BulbParams):
    """Animated camera origin + dynamic power (mandelbulb.comp:192-198) as
    f32 scalars on the host: the JAX render computes them from its f32
    parameters, and the kernels take them by value.  Returns (ro, dyn_power)
    with ro a tuple of three numpy float32."""
    time = _f32(p.time)
    rotation = _f32(p.rotation_y) + _f32(p.rotation_speed) * time
    dyn_dist = _f32(p.camera_distance) * (
        _f32(1.0) + _f32(0.3) * np.sin(time * _f32(0.5)))
    # ro = rot_y(rotation) @ (0, 0, dyn_dist); the GLSL mat3 is column-major,
    # so ro.x is -s*d (the JAX package's sign)
    c, s = np.cos(rotation), np.sin(rotation)
    ro = (-s * dyn_dist, _f32(0.0), c * dyn_dist)
    dyn_power = _f32(p.power) + _f32(0.5) * np.sin(time * _f32(0.7))
    return ro, dyn_power


def ray_dirs(px, py, width: int, height: int, ro, fov):
    """Per-pixel ray directions (mandelbulb.comp:204-209).  ``ro`` is three
    0-dim f32 tensors and ``fov`` one, on the device of ``px``; the
    degenerate camera-overhead case clamps the basis length."""
    h = consts.f32(height, px.device)
    ux = (px - width * 0.5) / h
    uy = (py - height * 0.5) / h
    rox, roy, roz = ro
    rlen = trig.sqrt(rox * rox + roy * roy + roz * roz)
    fwd = (-rox / rlen, -roy / rlen, -roz / rlen)
    # right = normalize(cross((0,1,0), forward)); up = cross(forward, right)
    rx, rz = fwd[2], -fwd[0]
    rl = torch.clamp_min(trig.sqrt(rx * rx + rz * rz), 1e-12)
    right = (rx / rl, 0.0, rz / rl)
    up = (fwd[1] * right[2] - fwd[2] * right[1],
          fwd[2] * right[0] - fwd[0] * right[2],
          fwd[0] * right[1] - fwd[1] * right[0])
    dx = fwd[0] + right[0] * ux * fov + up[0] * uy * fov
    dy = fwd[1] + right[1] * ux * fov + up[1] * uy * fov
    dz = fwd[2] + right[2] * ux * fov + up[2] * uy * fov
    one = torch.ones((), dtype=torch.float32, device=px.device)
    inv = one / trig.sqrt(dx * dx + dy * dy + dz * dz)
    return dx * inv, dy * inv, dz * inv


def de_step(zx, zy, zz, dr, px, py, pz, power, active, r=None):
    """One DE iteration (mandelbulb.comp:98-104) with the polynomial
    inverse trig, masked by ``active``; ``power`` is an f32 tensor.  ``r``
    optionally supplies the carried |z|."""
    if r is None:
        r = trig.sqrt(zx * zx + zy * zy + zz * zz)
    rs = torch.clamp_min(r, 1e-12)
    theta = trig.acos(torch.clamp(zz / rs, -1.0, 1.0))
    phi = trig.atan2(zy, zx)
    r_pow = torch.pow(rs, power - 1.0)
    ndr = r_pow * power * dr + 1.0
    zr = torch.pow(rs, power)
    th = theta * power
    ph = phi * power
    st = torch.sin(th)
    nzx = zr * (st * torch.cos(ph)) + px
    nzy = zr * (torch.sin(ph) * st) + py
    nzz = zr * torch.cos(th) + pz
    return (torch.where(active, nzx, zx), torch.where(active, nzy, zy),
            torch.where(active, nzz, zz), torch.where(active, ndr, dr), r)


def _cpow_int(cr, ci, p: int):
    """(cr + i·ci)^p for a static integer p >= 1, square-and-multiply from
    the lowest bit up (the JAX ``_cpow_int``'s order)."""
    rr = ri = None
    br, bi = cr, ci
    while p:
        if p & 1:
            if rr is None:
                rr, ri = br, bi
            else:
                rr, ri = rr * br - ri * bi, rr * bi + ri * br
        p >>= 1
        if p:
            # (a-b)(a+b) avoids the a²-b² cancellation near |a| == |b|
            br, bi = (br - bi) * (br + bi), 2.0 * br * bi
    return rr, ri


def _rpow_int(r, r2, k: int):
    """r^k from r and r² by the JAX ``_rpow_int``'s top-down recursion."""
    if k == 1:
        return r
    if k == 2:
        return r2
    h = _rpow_int(r, r2, k // 2)
    h = h * h
    return h * r if k & 1 else h


def de_step_int(zx, zy, zz, dr, px, py, pz, p: int, active, r=None):
    """One DE iteration for a static integer power p: the same function as
    de_step, trig-free (u = zz + i·m with m = |(zx, zy)|, then u^p and
    ((zx + i·zy)/m)^p by complex squaring).  ``r`` optionally supplies the
    carried |z|."""
    m2 = zx * zx + zy * zy
    r2 = m2 + zz * zz
    if r is None:
        r = trig.sqrt(r2)
    one = torch.ones((), dtype=zx.dtype, device=zx.device)
    # unit e^{iφ}; φ = 0 on the axis m = 0 (the atan2(0, 0) convention)
    zero_m = m2 <= 0.0
    inv_m = one / trig.sqrt(torch.where(zero_m, one, m2))
    cph = torch.where(zero_m, one, zx * inv_m)
    sph = torch.where(zero_m, torch.zeros_like(zy), zy * inv_m)
    m = torch.where(zero_m, torch.zeros_like(m2), m2 * inv_m)
    upr, upi = _cpow_int(zz, m, p)
    cpp, spp = _cpow_int(cph, sph, p)
    r_pow = _rpow_int(r, r2, p - 1)
    ndr = r_pow * float(p) * dr + 1.0
    nzx = upi * cpp + px
    nzy = spp * upi + py
    nzz = upr + pz
    return (torch.where(active, nzx, zx), torch.where(active, nzy, zy),
            torch.where(active, nzz, zz), torch.where(active, ndr, dr), r)


def de_finish(r, dr):
    """DE return value (mandelbulb.comp:106-107)."""
    de = 0.5 * torch.log(torch.clamp_min(r, 1e-12)) * r \
        / torch.clamp_min(dr, 1e-12)
    return torch.where((r < 1e-4) | (dr < 1e-4), torch.zeros_like(de), de)


def shade_hit(pos, normal, rd, d_at_hit, escape_iter, t, p: BulbParams,
              dyn_power, ao_sum) -> torch.Tensor:
    """Hit shading (mandelbulb.comp:141-160) from the kernel's normals and
    AO sum Σ exp(-10·DE_k).  ``p``'s colour and time fields and
    ``dyn_power`` are f32 tensors on the device; ``max_iterations`` and
    ``palette_mode`` are ints.  Returns (..., 3)."""
    dev = d_at_hit.device
    nx, ny, nz = normal
    ll = math.sqrt(1.0 + 1.0 + 0.8 * 0.8)
    lx, ly, lz = 1.0 / ll, 1.0 / ll, 0.8 / ll
    diffuse = torch.clamp_min(nx * lx + ny * ly + nz * lz, 0.0)
    ambient = 0.15
    vx, vy, vz = -rd[0], -rd[1], -rd[2]
    # reflect(-light, normal) = -l + 2(n·l)n
    ndl = nx * lx + ny * ly + nz * lz
    rx = -lx + 2.0 * ndl * nx
    ry = -ly + 2.0 * ndl * ny
    rz = -lz + 2.0 * ndl * nz
    spec = torch.pow(torch.clamp_min(vx * rx + vy * ry + vz * rz, 0.0), 64.0)
    rim = torch.pow(1.0 - torch.clamp_min(nx * vx + ny * vy + nz * vz, 0.0),
                    2.0)
    glow = torch.exp(-8.0 * d_at_hit)
    filament = torch.exp(-30.0 * d_at_hit)

    pr = trig.sqrt(pos[0] ** 2 + pos[1] ** 2 + pos[2] ** 2)
    log_pr = torch.log(torch.clamp_min(pr, 1e-12))
    it = escape_iter + 1.0 - torch.log(torch.clamp_min(log_pr, 1e-12)) \
        / torch.log(dyn_power + 1e-4)
    it = it / consts.f32(p.max_iterations, dev)
    it = pal._fract(p.color_offset + torch.pow(
        torch.clamp_min(it, 0.0), float(_f32(0.6))) * p.color_scale)
    base = pal.bulb_color(it, p.palette_mode)
    alt = pal.bulb_color(pal._fract(it + 0.33), (p.palette_mode + 1) % 6)
    mixw = 0.3 + 0.3 * torch.sin(p.time * 0.5)
    color = base * (1.0 - mixw) + alt * mixw

    shade = (ambient + diffuse * 0.9)[..., None]
    color = color * shade
    color = color + spec[..., None] * 0.5
    color = color + rim[..., None] * 0.25
    color = color + glow[..., None] * 0.5
    fil = filament[..., None]
    color = color + torch.stack([torch.ones_like(filament),
                                 torch.full_like(filament, 0.8),
                                 torch.full_like(filament, 0.5)],
                                dim=-1) * fil * 0.5
    ao = 1.0 - ao_sum / consts.f32(8.0, dev)
    color = color * (ao * 0.8 + 0.2)[..., None]
    dist_factor = torch.clamp(t / consts.f32(MAX_DIST, dev), 0.0, 1.0)
    fog = (dist_factor * 0.6)[..., None]
    return color * (1.0 - fog) + consts.f32((0.0, 0.0, 0.1), dev) * fog


def sky_color(rd: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """Miss shading (mandelbulb.comp:165-166)."""
    dev = rd[1].device
    sky = torch.clamp(rd[1] * 0.5 + 0.5, 0.0, 1.0)[..., None]
    return consts.f32((0.02, 0.02, 0.05), dev) * (1.0 - sky) \
        + consts.f32((0.5, 0.6, 0.8), dev) * sky
