"""Plain reference of the Mandelbulb export frame: the cone prepass, the
over-relaxed sphere-traced march with its escape-index recovery and its
normal and AO taps, the hit and sky shading, the AA sum, the enhance →
ACES → gamma post chain and the uint8 quantize.

Frozen copies, at commit 589f0370435b, of the plain versions in
``fractalrenderer_tpu_torch``: ``ops/bulb_math.py`` (``BulbParams.clamped``,
``camera_setup``, ``ray_dirs``, ``de_step``, ``de_step_int`` with
``_cpow_int`` and ``_rpow_int``, ``de_finish``, ``shade_hit``,
``sky_color``), ``ops/bulb_kernel.py`` (the f32 camera, field of view and
power of ``pack_march_params``, ``pack_cone_params``' half-angle,
``resolve_int_power``, ``_Orbits``,
``cone_fields_plain``, ``_dead_lane_constants``, ``march_fields_plain``),
``ops/trig.py`` (``sqrt``, ``atan``, ``atan2``, ``acos``),
``ops/palettes.py`` (``bulb_color`` for the modes 0 and 1 that palette 0
reads: ``_noise``, ``bulb_dynamic``, ``bulb_fire_and_ice``),
``ops/coloring.py`` (``enhance_color``, ``aces_tonemap``,
``gamma_correct``), ``models/mandelbulb.py`` (``_render_sample`` and
``band_render_fn``'s frame) and ``models/common.py`` (``quantize_image``).
Each follows its source operation for operation; every divisor is a
tensor on the pixels' device, as there.  Plain PyTorch only: nothing of
the program is imported, no kernel, no batching of frames in the program's
sense.

Where it departs from the program's plain versions (none changes a value):

- the march runs over chosen rows of several frames at once: the lanes are
  the (rows, width) pixels of every frame's sampled rows, and each lane
  reads its frame's camera, field of view and dynamic power as per-row
  tensors (the program's are one frame's 0-dim tensors); the cone prepass
  runs only the image-aligned cone blocks those rows lie in.  Every
  operation is elementwise, so a lane computes what it computes in a whole
  frame;
- frames whose dynamic power takes different DE instances (the integer
  power's trig-free step or the polynomial-trig step) march in separate
  calls, one per instance;
- ``dtype`` runs the march and the shading in another precision (the
  lower-precision control); the AA sum, the post chain and the quantize
  stay f32.

Where the program departs from the shader (mandelbulb.comp), so this file
does too: the camera and the dynamic power are f32 host scalars; inverse
trig is the port's polynomial (``acos``, ``atan2``); the march is
over-relaxed (ω = 1.6) with a cone prepass of 8×8 blocks, and caps every
lane at MAX_STEPS evaluations; the escape index comes from one full-length
orbit at the hit; the AO loop's offsets are the shader's accumulated f32
values.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

MAX_STEPS = 200
MAX_DIST = 10.0
OMEGA = 1.6
RELAX_CUTOFF = 8.0
CONE = 8
_EARLY_EXIT_EVERY = 8
PI = float(np.float32(math.pi))
PI_2 = float(np.float32(math.pi / 2.0))
ATAN_COEFFS = (-0.0117212, 0.05265332, -0.11643287, 0.19354346,
               -0.33262348, 0.99997726)
GAMMA = 2.2
_f32 = np.float32


def _ao_offsets() -> Tuple[float, ...]:
    ks, k = [], np.float32(0.01)
    while k < np.float32(0.15):
        ks.append(float(k))
        k = np.float32(k + np.float32(0.02))
    return tuple(ks)


AO_KS = _ao_offsets()
MARCH, ESC, TAP0 = 0, 1, 2
N_TAPS = 3 + len(AO_KS)
DONE = TAP0 + N_TAPS


# ---- the frame's parameters (host, f32) -------------------------------------

def clamped(c: dict) -> dict:
    """The shader's input clamps (mandelbulb.comp:177-190) on the frame's
    parameters: camera_distance, rotation_y, power, max_iterations, fov,
    rotation_speed, time, palette_mode and the colour fields."""
    return dict(
        c,
        camera_distance=max(c["camera_distance"], 0.1),
        power=min(max(c["power"], 2.0), 16.0),
        max_iterations=min(max(int(c["max_iterations"]), 1), 1024),
        color_scale=max(c["color_scale"], 0.1),
        palette_mode=min(max(int(c["palette_mode"]), 0), 5),
        fov=min(max(c["fov"], 0.1), 3.0),
        rotation_speed=c["rotation_speed"] if c["rotation_speed"] != 0.0
        else 0.3,
        brightness=max(c["brightness"], 0.1),
        saturation=max(c["saturation"], 0.0),
        contrast=max(c["contrast"], 0.1))


def camera_setup(p: dict):
    """(ro, dyn_power) as numpy f32 (mandelbulb.comp:192-198); every field
    of ``p`` already rounded to f32."""
    time = _f32(p["time"])
    rotation = _f32(p["rotation_y"]) + _f32(p["rotation_speed"]) * time
    dyn_dist = _f32(p["camera_distance"]) * (
        _f32(1.0) + _f32(0.3) * np.sin(time * _f32(0.5)))
    c, s = np.cos(rotation), np.sin(rotation)
    ro = (-s * dyn_dist, _f32(0.0), c * dyn_dist)
    dyn_power = _f32(p["power"]) + _f32(0.5) * np.sin(time * _f32(0.7))
    return ro, dyn_power


def int_power_of(dyn_power) -> object:
    """The DE instance of a dynamic power: an integer 2..16 takes the
    trig-free step, anything else (None) the polynomial-trig step."""
    pw = float(dyn_power)
    return int(pw) if pw.is_integer() and 2.0 <= pw <= 16.0 else None


def cone_beta(fov, map_height: int) -> np.float32:
    """``pack_cone_params``' cone half-angle."""
    return np.float32(fov) * np.float32((0.75 * CONE + 1.0) / map_height)


# ---- trig (ops/trig.py) -----------------------------------------------------

def _sqrt(x):
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def _atan(x):
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


def _atan2(y, x):
    tiny = torch.where(x < 0, torch.full_like(x, -1e-38),
                       torch.full_like(x, 1e-38))
    safe_x = torch.where(torch.abs(x) < 1e-38, tiny, x)
    base = _atan(y / safe_x)
    add = torch.where(y >= 0, torch.full_like(base, PI),
                      torch.full_like(base, -PI))
    r = torch.where(x < 0, base + add, base)
    x_zero = x == 0
    r = torch.where(x_zero & (y > 0), torch.full_like(r, PI_2), r)
    r = torch.where(x_zero & (y < 0), torch.full_like(r, -PI_2), r)
    return torch.where(x_zero & (y == 0), torch.zeros_like(r), r)


def _acos(x):
    xc = torch.clamp(x, -1.0, 1.0)
    return _atan2(_sqrt(torch.clamp_min(1.0 - xc * xc, 0.0)), xc)


# ---- camera and DE (ops/bulb_math.py) ---------------------------------------

def ray_dirs(px, py, width: int, height: int, ro, fov):
    """Per-pixel ray directions (mandelbulb.comp:204-209); ``ro`` three
    tensors and ``fov`` one, each 0-dim or one per row of ``px``."""
    h = torch.tensor(float(height), dtype=px.dtype, device=px.device)
    ux = (px - width * 0.5) / h
    uy = (py - height * 0.5) / h
    rox, roy, roz = ro
    rlen = _sqrt(rox * rox + roy * roy + roz * roz)
    fwd = (-rox / rlen, -roy / rlen, -roz / rlen)
    rx, rz = fwd[2], -fwd[0]
    rl = torch.clamp_min(_sqrt(rx * rx + rz * rz), 1e-12)
    right = (rx / rl, 0.0, rz / rl)
    up = (fwd[1] * right[2] - fwd[2] * right[1],
          fwd[2] * right[0] - fwd[0] * right[2],
          fwd[0] * right[1] - fwd[1] * right[0])
    dx = fwd[0] + right[0] * ux * fov + up[0] * uy * fov
    dy = fwd[1] + right[1] * ux * fov + up[1] * uy * fov
    dz = fwd[2] + right[2] * ux * fov + up[2] * uy * fov
    one = torch.ones((), dtype=px.dtype, device=px.device)
    inv = one / _sqrt(dx * dx + dy * dy + dz * dz)
    return dx * inv, dy * inv, dz * inv


def de_step(zx, zy, zz, dr, px, py, pz, power, active, r):
    """One polynomial-trig DE iteration (mandelbulb.comp:98-104), masked
    by ``active``, from the carried |z| ``r``."""
    rs = torch.clamp_min(r, 1e-12)
    theta = _acos(torch.clamp(zz / rs, -1.0, 1.0))
    phi = _atan2(zy, zx)
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
            torch.where(active, nzz, zz), torch.where(active, ndr, dr))


def _cpow_int(cr, ci, p: int):
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
            br, bi = (br - bi) * (br + bi), 2.0 * br * bi
    return rr, ri


def _rpow_int(r, r2, k: int):
    if k == 1:
        return r
    if k == 2:
        return r2
    h = _rpow_int(r, r2, k // 2)
    h = h * h
    return h * r if k & 1 else h


def de_step_int(zx, zy, zz, dr, px, py, pz, p: int, active, r):
    """One trig-free DE iteration for the integer power ``p``."""
    m2 = zx * zx + zy * zy
    r2 = m2 + zz * zz
    one = torch.ones((), dtype=zx.dtype, device=zx.device)
    zero_m = m2 <= 0.0
    inv_m = one / _sqrt(torch.where(zero_m, one, m2))
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
            torch.where(active, nzz, zz), torch.where(active, ndr, dr))


def de_finish(r, dr):
    de = 0.5 * torch.log(torch.clamp_min(r, 1e-12)) * r \
        / torch.clamp_min(dr, 1e-12)
    return torch.where((r < 1e-4) | (dr < 1e-4), torch.zeros_like(de), de)


# ---- the march (ops/bulb_kernel.py's plain K4a and K4b) ---------------------

class _Orbits:
    """Every lane's current DE orbit: its start p, z, dr, the carried |z|,
    its iteration count and the escape index."""

    def __init__(self, x, y, z):
        self.px, self.py, self.pz = x, y, z
        self.zx, self.zy, self.zz = x, y, z
        self.dr = torch.ones_like(x)
        self.r = _sqrt(x * x + y * y + z * z)
        self.oi = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
        self.esc = self._esc0(self.r)

    @staticmethod
    def _esc0(r):
        return torch.where(r > 2.0, 0, -1).to(torch.int32)

    def restart(self, sel, x, y, z):
        self.px = torch.where(sel, x, self.px)
        self.py = torch.where(sel, y, self.py)
        self.pz = torch.where(sel, z, self.pz)
        self.zx = torch.where(sel, x, self.zx)
        self.zy = torch.where(sel, y, self.zy)
        self.zz = torch.where(sel, z, self.zz)
        self.dr = torch.where(sel, torch.ones_like(self.dr), self.dr)
        r0 = _sqrt(self.px * self.px + self.py * self.py
                   + self.pz * self.pz)
        self.r = torch.where(sel, r0, self.r)
        self.oi = torch.where(sel, 0, self.oi)
        self.esc = torch.where(sel, self._esc0(r0), self.esc)

    def live(self, limit: int, full_length):
        return (self.r <= 2.0) & (self.r >= 1e-4) & (self.oi < limit) \
            & (full_length | (self.dr < float("inf")))

    def step(self, act, power, limit: int, int_power):
        if int_power is not None:
            zx, zy, zz, dr = de_step_int(
                self.zx, self.zy, self.zz, self.dr, self.px, self.py,
                self.pz, int_power, act, self.r)
        else:
            zx, zy, zz, dr = de_step(
                self.zx, self.zy, self.zz, self.dr, self.px, self.py,
                self.pz, power, act, self.r)
        rn = _sqrt(zx * zx + zy * zy + zz * zz)
        self.esc = torch.where((self.esc < 0) & act & (rn > 2.0)
                               & (self.oi + 1 < limit), self.oi + 1,
                               self.esc)
        self.zx, self.zy, self.zz, self.dr, self.r = zx, zy, zz, dr, rn
        self.oi = self.oi + act.to(torch.int32)


def _per_row(values, dtype, device):
    """A (rows, 1) tensor of one value per lane row."""
    return torch.tensor(np.asarray(values, np.float32),
                        device=device).to(dtype)[:, None]


def cone(lanes: "Lanes", width: int, map_height: int, limit: int,
         int_power, dtype):
    """K4a over the cone blocks of ``lanes.block_rows``: the start depth of
    each (block row, block column) lane."""
    dev = lanes.device
    shape = (len(lanes.block_rows), -(-width // CONE))
    cs = torch.tensor(float(CONE), dtype=dtype, device=dev)
    cols = torch.arange(shape[1], dtype=torch.int32, device=dev).to(dtype)
    rows = torch.tensor(lanes.block_rows, dtype=torch.int32,
                        device=dev).to(dtype)
    zero = torch.zeros((), dtype=dtype, device=dev)
    pxf = (cols * cs + zero + (cs - 1.0) * 0.5)[None, :].expand(shape)
    pyf = ((rows + zero) * cs + zero + (cs - 1.0) * 0.5)[:, None] \
        .expand(shape)
    ro, fov, power, beta = lanes.block_params(dtype)
    rdx, rdy, rdz = ray_dirs(pxf, pyf, width, map_height, ro, fov)

    t = torch.full(shape, 0.001, dtype=dtype, device=dev)
    mstep = torch.zeros(shape, dtype=torch.int32, device=dev)
    done = torch.zeros(shape, dtype=torch.bool, device=dev)
    bad_f = torch.zeros_like(done)
    orb = _Orbits(ro[0] + rdx * t, ro[1] + rdy * t, ro[2] + rdz * t)
    trip = 0
    while True:
        if trip % _EARLY_EXIT_EVERY == 0 and bool(done.all()):
            break
        trip += 1
        act = ~done & orb.live(limit, False)
        orb.step(act, power, limit, int_power)
        ended = ~done & ~orb.live(limit, False)
        d = de_finish(orb.r, orb.dr)
        bad = ~torch.isfinite(d)
        thr = torch.maximum(torch.clamp_min(1e-3 * t, 1e-4), 3.0 * beta * t)
        stop = ended & (bad | (d < thr) | (t > MAX_DIST) | (d > MAX_DIST))
        bad_f = bad_f | (ended & bad)
        mstep = mstep + ended.to(torch.int32)
        t = torch.where(ended & ~stop,
                        t + torch.clamp_min(d * 0.5, 0.0005), t)
        done = done | stop | (ended & (mstep >= MAX_STEPS))
        orb.restart(ended & ~done, ro[0] + rdx * t, ro[1] + rdy * t,
                    ro[2] + rdz * t)
    return torch.where(bad_f, torch.full_like(t, 0.001), t)


def _dead_lane_constants(dtype, dev):
    def f(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    far, zero, eps, one = f(3.0), f(0.0), f(1e-3), f(1.0)

    def dead_de(x, y, z):
        return de_finish(_sqrt(x * x + y * y + z * z), one)

    nxr = dead_de(far + eps, zero, zero) - zero
    nyr = dead_de(far, zero + eps, zero) - zero
    nzr = dead_de(far, zero, zero + eps) - zero
    nl = _sqrt(nxr * nxr + nyr * nyr + nzr * nzr)
    fb = nl < 1e-4
    nl = torch.clamp_min(nl, 1e-12)
    nxc = torch.where(fb, zero, nxr / nl)
    nyc = torch.where(fb, one, nyr / nl)
    nzc = torch.where(fb, zero, nzr / nl)
    ao = f(0.0)
    for k in AO_KS:
        ao = ao + torch.exp(-10.0 * dead_de(far + nxc * k, zero + nyc * k,
                                            zero + nzc * k))
    return nxc, nyc, nzc, ao


def march(lanes: "Lanes", tc, width: int, map_height: int, limit: int,
          int_power, dtype) -> Dict[str, torch.Tensor]:
    """K4b with shading over the (rows, width) lanes of ``lanes``: hit, t,
    d, esc, nx, ny, nz, ao, and each lane's march evaluations (msteps)
    and DE iterations (work: the march, the escape recovery and the 11
    shading taps)."""
    dev = lanes.device
    f32, i32 = dtype, torch.int32
    shape = (len(lanes.rows), width)
    rows = torch.tensor(lanes.rows, dtype=i32, device=dev)
    cols = torch.arange(width, dtype=i32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    pxf = (cols.to(f32) + zero)[None, :].expand(shape)
    pyf = (rows.to(f32) + zero)[:, None].expand(shape)
    ro, fov, power = lanes.row_params(dtype)
    rdx, rdy, rdz = ray_dirs(pxf, pyf, width, map_height, ro, fov)

    cidx = torch.arange(width, device=dev) // CONE
    t = torch.clamp_min(tc[torch.tensor(lanes.block_of_row, device=dev)]
                        [:, cidx], 0.001)

    def zeros(dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    phase = zeros(i32)
    mstep, work = zeros(i32), zeros(i32)
    hit, rel_prev = zeros(torch.bool), zeros(torch.bool)
    relax = torch.ones(shape, dtype=torch.bool, device=dev)
    d_hit, prev_step = zeros(), zeros()
    prev_rad = torch.full(shape, float("inf"), dtype=f32, device=dev)
    esc_hit, hx, hy, hz = zeros(), zeros(), zeros(), zeros()
    dxp, dyp, dzp, kf, ao = zeros(), zeros(), zeros(), zeros(), zeros()
    nx, ny, nz = zeros(), torch.ones(shape, dtype=f32, device=dev), zeros()
    orb = _Orbits(ro[0] + rdx * t, ro[1] + rdy * t, ro[2] + rdz * t)
    while True:
        running = phase != DONE
        if not bool(running.any()):
            break
        act = running & orb.live(limit, phase == ESC)
        orb.step(act, power, limit, int_power)
        work = work + act.to(i32)
        ended = running & ~orb.live(limit, phase == ESC)
        if not bool(ended.any()):
            continue
        d = de_finish(orb.r, orb.dr)
        ev_m = ended & (phase == MARCH)
        ev_e = ended & (phase == ESC)
        ev_s = ended & (phase >= TAP0)
        new_phase = phase

        mstep = mstep + ev_m.to(i32)
        bad = ~torch.isfinite(d)
        rad = 0.5 * d
        over_b = ev_m & rel_prev & (bad | (prev_step > prev_rad + rad))
        usable = ev_m & ~over_b
        thr = torch.clamp_min(1e-3 * t, 1e-4)
        hit_now = usable & ~bad & (d < thr)
        hit = hit | hit_now
        d_hit = torch.where(hit_now, d, d_hit)
        out = (t > MAX_DIST) | (d > MAX_DIST)
        m_ended = hit_now | (usable & (bad | out))
        still = usable & ~m_ended
        relax_now = relax & (d > RELAX_CUTOFF * thr)
        step_n = torch.clamp_min(torch.where(relax_now, OMEGA * rad, rad),
                                 0.0005)
        t = torch.where(still, t + step_n,
                        torch.where(over_b, t - prev_step + prev_rad, t))
        prev_step = torch.where(still, step_n,
                                torch.where(over_b, prev_rad, prev_step))
        prev_rad = torch.where(still, rad, prev_rad)
        relax = relax & ~over_b
        rel_prev = torch.where(still, relax_now, rel_prev & ~over_b)
        sx, sy, sz = ro[0] + rdx * t, ro[1] + rdy * t, ro[2] + rdz * t
        stop = ev_m & (m_ended | (mstep >= MAX_STEPS))
        to_esc = stop & hit
        hx = torch.where(to_esc, sx, hx)
        hy = torch.where(to_esc, sy, hy)
        hz = torch.where(to_esc, sz, hz)
        new_phase = torch.where(stop, torch.where(hit, ESC, DONE), new_phase)

        if bool(ev_e.any()):
            esc_f = torch.where(orb.esc < 0, limit, orb.esc).to(f32)
            esc_hit = torch.where(ev_e, esc_f, esc_hit)
            new_phase = torch.where(ev_e, TAP0, new_phase)
            sx = torch.where(ev_e, hx + 1e-3, sx)
            sy = torch.where(ev_e, hy, sy)
            sz = torch.where(ev_e, hz, sz)

        if bool(ev_s.any()):
            k = phase - TAP0
            dxp = torch.where(ev_s & (k == 0), d, dxp)
            dyp = torch.where(ev_s & (k == 1), d, dyp)
            dzp = torch.where(ev_s & (k == 2), d, dzp)
            nsel = ev_s & (k == 2)
            nxr, nyr, nzr = dxp - d_hit, dyp - d_hit, dzp - d_hit
            nl = _sqrt(nxr * nxr + nyr * nyr + nzr * nzr)
            fb = nl < 1e-4
            nl = torch.clamp_min(nl, 1e-12)
            nx = torch.where(nsel, torch.where(fb, 0.0, nxr / nl), nx)
            ny = torch.where(nsel, torch.where(fb, 1.0, nyr / nl), ny)
            nz = torch.where(nsel, torch.where(fb, 0.0, nzr / nl), nz)
            kf = torch.where(nsel, AO_KS[0], kf)
            aosel = ev_s & (k >= 3)
            ao = torch.where(aosel, ao + torch.exp(-10.0 * d), ao)
            kf = torch.where(aosel, kf + 0.02, kf)
            tx = torch.where(k <= 1, hx, hx + nx * kf)
            ty = torch.where(k == 0, hy + 1e-3,
                             torch.where(k == 1, hy, hy + ny * kf))
            tz = torch.where(k == 0, hz,
                             torch.where(k == 1, hz + 1e-3, hz + nz * kf))
            sx = torch.where(ev_s, tx, sx)
            sy = torch.where(ev_s, ty, sy)
            sz = torch.where(ev_s, tz, sz)
            new_phase = torch.where(
                ev_s, torch.where(k == N_TAPS - 1, DONE, phase + 1),
                new_phase)

        phase = new_phase
        orb.restart(ended & (phase != DONE), sx, sy, sz)

    nxc, nyc, nzc, aoc = _dead_lane_constants(f32, dev)
    return {"hit": hit, "t": t, "d": d_hit, "esc": esc_hit,
            "nx": torch.where(hit, nx, nxc), "ny": torch.where(hit, ny, nyc),
            "nz": torch.where(hit, nz, nzc), "ao": torch.where(hit, ao, aoc),
            "msteps": mstep, "work": work}


class Lanes:
    """The march's lanes: every frame's chosen rows, one after another, and
    the cone blocks they lie in.  ``frames`` is [(camera, rows), ...] with
    camera (ro, fov, dyn_power, beta) as numpy f32."""

    def __init__(self, frames: Sequence[tuple], device):
        self.device = torch.device(device)
        self.cams = [cam for cam, _ in frames]
        self.rows: List[int] = []
        self.row_frame: List[int] = []
        self.block_rows: List[int] = []
        self.block_frame: List[int] = []
        self.block_of_row: List[int] = []
        for i, (_, rows) in enumerate(frames):
            blocks = sorted({r // CONE for r in rows})
            at = {b: len(self.block_rows) + j for j, b in enumerate(blocks)}
            self.block_rows += blocks
            self.block_frame += [i] * len(blocks)
            self.rows += list(rows)
            self.row_frame += [i] * len(rows)
            self.block_of_row += [at[r // CONE] for r in rows]

    def _params(self, frame_of, dtype):
        def col(k):
            return _per_row([self.cams[i][k] for i in frame_of], dtype,
                            self.device)

        ro = tuple(_per_row([self.cams[i][0][a] for i in frame_of], dtype,
                            self.device) for a in range(3))
        return ro, col(1), col(2), col(3)

    def row_params(self, dtype):
        ro, fov, power, _ = self._params(self.row_frame, dtype)
        return ro, fov, power

    def block_params(self, dtype):
        return self._params(self.block_frame, dtype)


# ---- shading (ops/bulb_math.py, ops/palettes.py) ----------------------------

def _vec3(r, g, b, dtype, device):
    return torch.tensor([r, g, b], dtype=dtype, device=device)


def _fract(t):
    return t - torch.floor(t)


def _clamp(t, lo, hi):
    return torch.minimum(torch.maximum(
        t, torch.as_tensor(lo, dtype=torch.float32, device=t.device)),
        torch.as_tensor(hi, dtype=torch.float32, device=t.device))


def _smoothstep(t):
    t = _clamp(t, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _mix(a, b, t):
    t = t[..., None]
    return a * (1.0 - t) + b * t


def _bulb_hsv2rgb(h, s, v):
    base = torch.stack([h * 6.0 + 0.0, h * 6.0 + 4.0, h * 6.0 + 2.0], dim=-1)
    rgb = _clamp(torch.abs(torch.remainder(base, 6.0) - 3.0) - 1.0, 0.0, 1.0)
    one = torch.ones_like(rgb)
    return v[..., None] * (one * (1.0 - s[..., None]) + rgb * s[..., None])


def _hash(px, py):
    return _fract(torch.sin(px * 127.1 + py * 311.7) * 43758.5453123)


def _noise(px, py):
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


def _bulb_dynamic(t):
    hue = _fract(t + 0.3 * torch.sin(t * 12.0))
    sat = 0.6 + 0.4 * torch.sin(t * 7.0)
    val = torch.pow(t, float(np.float32(0.4)))
    return _bulb_hsv2rgb(hue, sat, val)


def _bulb_fire_and_ice(t):
    blend = _smoothstep(t)
    zeros, ones = torch.zeros_like(blend), torch.ones_like(blend)
    fire = torch.stack([torch.pow(blend, 2.0), blend * 0.5, zeros], dim=-1)
    ice = torch.stack([zeros, 0.5 + 0.5 * blend, ones], dim=-1)
    return _mix(fire * 1.0, ice * 1.0, _fract(t * 3.0))


# the palette modes palette 0 reads: its own and the alternate (mode + 1)
PALETTES = {0: _bulb_dynamic, 1: _bulb_fire_and_ice}


def bulb_color(t, mode: int):
    """mandelbulb.comp:63-75 for the modes of PALETTES."""
    t = _fract(t)
    n = _noise(t * 100.0, t * 57.0) * 0.02
    return PALETTES[mode](t + n)


def shade_hit(pos, normal, rd, d_at_hit, escape_iter, t, s: dict,
              max_iterations: int, palette_mode: int, ao_sum):
    """Hit shading (mandelbulb.comp:141-160); ``s`` holds the frame's
    color_offset, color_scale, time and dyn_power as 0-dim tensors."""
    dev, dt = d_at_hit.device, d_at_hit.dtype
    nx, ny, nz = normal
    ll = math.sqrt(1.0 + 1.0 + 0.8 * 0.8)
    lx, ly, lz = 1.0 / ll, 1.0 / ll, 0.8 / ll
    diffuse = torch.clamp_min(nx * lx + ny * ly + nz * lz, 0.0)
    ambient = 0.15
    vx, vy, vz = -rd[0], -rd[1], -rd[2]
    ndl = nx * lx + ny * ly + nz * lz
    rx = -lx + 2.0 * ndl * nx
    ry = -ly + 2.0 * ndl * ny
    rz = -lz + 2.0 * ndl * nz
    spec = torch.pow(torch.clamp_min(vx * rx + vy * ry + vz * rz, 0.0), 64.0)
    rim = torch.pow(1.0 - torch.clamp_min(nx * vx + ny * vy + nz * vz, 0.0),
                    2.0)
    glow = torch.exp(-8.0 * d_at_hit)
    filament = torch.exp(-30.0 * d_at_hit)

    pr = _sqrt(pos[0] ** 2 + pos[1] ** 2 + pos[2] ** 2)
    log_pr = torch.log(torch.clamp_min(pr, 1e-12))
    it = escape_iter + 1.0 - torch.log(torch.clamp_min(log_pr, 1e-12)) \
        / torch.log(s["dyn_power"] + 1e-4)
    it = it / torch.tensor(float(max_iterations), dtype=dt, device=dev)
    it = _fract(s["color_offset"] + torch.pow(
        torch.clamp_min(it, 0.0), float(_f32(0.6))) * s["color_scale"])
    base = bulb_color(it, palette_mode)
    alt = bulb_color(_fract(it + 0.33), (palette_mode + 1) % 6)
    mixw = 0.3 + 0.3 * torch.sin(s["time"] * 0.5)
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
    ao = 1.0 - ao_sum / torch.tensor(8.0, dtype=dt, device=dev)
    color = color * (ao * 0.8 + 0.2)[..., None]
    dist_factor = torch.clamp(
        t / torch.tensor(MAX_DIST, dtype=dt, device=dev), 0.0, 1.0)
    fog = (dist_factor * 0.6)[..., None]
    return color * (1.0 - fog) + _vec3(0.0, 0.0, 0.1, dt, dev) * fog


def sky_color(rd):
    dev, dt = rd[1].device, rd[1].dtype
    sky = torch.clamp(rd[1] * 0.5 + 0.5, 0.0, 1.0)[..., None]
    return _vec3(0.02, 0.02, 0.05, dt, dev) * (1.0 - sky) \
        + _vec3(0.5, 0.6, 0.8, dt, dev) * sky


# ---- post chain and quantize (ops/coloring.py, models/common.py) ------------

def _clip01(x):
    return torch.clamp(x, 0.0, 1.0)


def enhance_color(color, brightness, saturation, contrast):
    color = color * brightness
    color = (color - 0.5) * contrast + 0.5
    gray = (color[..., 0] * 0.299 + color[..., 1] * 0.587
            + color[..., 2] * 0.114)[..., None]
    color = gray * (1.0 - saturation) + color * saturation
    return _clip01(color)


def aces_tonemap(color):
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return _clip01((color * (a * color + b)) / (color * (c * color + d) + e))


def gamma_correct(color, gamma: float = GAMMA):
    return torch.pow(torch.clamp_min(color, 0.0),
                     float(np.float32(1.0 / gamma)))


def quantize8(img):
    img = torch.clamp(img, 0.0, 1.0)
    img = img * 255.0 + 0.5
    return img.to(torch.uint8)


# ---- frames ----------------------------------------------------------------

# a frame's f32 scalars (``models/mandelbulb._DYN_FIELDS``)
_KEYS = ("camera_distance", "rotation_y", "power", "time", "fov",
         "rotation_speed", "color_offset", "color_scale", "brightness",
         "saturation", "contrast")

def frames(scenes: Sequence[dict], rows: Sequence[int], width: int,
           height: int, device, dtype=torch.float32):
    """The uint8 (len(rows), width, 3) rows of each frame of ``scenes`` (one
    dict a frame: the configuration's fields and the frame's ``time``),
    with each frame's march planes over those rows: ``[(img, planes),
    ...]`` in the order of ``scenes``.  One AA sample (offset 0); the
    palette modes of PALETTES."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    rows = list(rows)
    prepared = []
    for sc in scenes:
        c = clamped(sc)
        p = {k: _f32(c[k]) for k in _KEYS}
        ro, dyn_power = camera_setup(p)
        cam = (ro, p["fov"], dyn_power, cone_beta(p["fov"], height))
        prepared.append((c, p, ro, dyn_power, cam))

    planes_of = {}
    by_instance = {}
    for i, (c, _, _, dyn_power, _) in enumerate(prepared):
        by_instance.setdefault(
            (int_power_of(dyn_power), c["max_iterations"]), []).append(i)
    for (ip, limit), idx in by_instance.items():
        lanes = Lanes([(prepared[i][4], rows) for i in idx], dev)
        tc = cone(lanes, width, height, limit, ip, dtype)
        m = march(lanes, tc, width, height, limit, ip, dtype)
        k = len(rows)
        for j, i in enumerate(idx):
            planes_of[i] = {n: x[j * k:(j + 1) * k] for n, x in m.items()}

    out = []
    for i, (c, p, ro, dyn_power, _) in enumerate(prepared):
        f = planes_of[i]
        out.append((_shade_frame(c, p, ro, dyn_power, f, rows, width,
                                 height, dev, dtype), f))
    return out


def _shade_frame(c, p, ro, dyn_power, f, rows, width, height, dev, dtype):
    """One frame's rows from its march planes: ``_render_sample``'s
    shading, then ``band_render_fn``'s AA sum and post chain, and the
    quantize."""
    vals = torch.tensor([float(p[k]) for k in _KEYS] + [float(dyn_power)],
                        dtype=torch.float32, device=dev)
    s = {k: vals[j].to(dtype) for j, k in enumerate(_KEYS + ("dyn_power",))}
    ro_t = tuple(torch.tensor(float(v), dtype=torch.float32,
                              device=dev).to(dtype) for v in ro)
    n = len(rows)
    pyg = torch.tensor(rows, dtype=torch.int32, device=dev).to(dtype)[
        :, None].expand(n, width)
    pxg = torch.arange(width, dtype=dtype, device=dev)[None, :] \
        .expand(n, width)
    pxg = pxg + float(np.float32(0.0))
    pyg = pyg + float(np.float32(0.0))
    rd = ray_dirs(pxg, pyg, width, height, ro_t, s["fov"])
    hit = f["hit"]
    t = f["t"]
    pos = tuple(o + r * t for o, r in zip(ro_t, rd))
    hit_color = shade_hit(pos, (f["nx"], f["ny"], f["nz"]), rd, f["d"],
                          f["esc"], t, s, c["max_iterations"],
                          c["palette_mode"], ao_sum=f["ao"])
    sample = torch.where(hit[..., None], hit_color, sky_color(rd)) \
        .to(torch.float32)
    acc = torch.zeros((n, width, 3), dtype=torch.float32, device=dev)
    acc = acc + sample
    color = acc / torch.tensor(1.0, dtype=torch.float32, device=dev)
    color = enhance_color(color, vals[_KEYS.index("brightness")],
                          vals[_KEYS.index("saturation")],
                          vals[_KEYS.index("contrast")])
    return quantize8(gamma_correct(aces_tonemap(color)))
