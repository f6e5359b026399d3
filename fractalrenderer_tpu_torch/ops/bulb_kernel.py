"""Mandelbulb raymarch fields, kernels K4a (cone prepass) and K4b (march +
shading) — the port's counterpart of ``fractalrenderer_tpu/ops/bulb_kernel.py``.

K4a marches one conservative ray per cone×cone pixel block (hit threshold
inflated to 3βt) and gives every pixel of the block a safe start depth.
K4b sphere-traces each pixel from there with over-relaxation (ω = 1.6 while
d > 8·threshold; an overshoot reverts and latches relaxation off), caps the
march at MAX_STEPS evaluations, recovers the escape index from one
full-length orbit at the hit, and with ``shade`` walks the 3 normal taps and
the 8 AO taps.  Each lane follows the JAX flat form's trajectory
(``_flat_march``/``_flat_shade``: orbits stop exactly when dr overflows to
+inf), with the nested form's cap: every evaluation counts and the lane
stops after the 200th whatever its state.

- ``pack_march_params``/``pack_cone_params`` build the 9- and 11-float
  vectors exactly as the JAX ``march_fields`` packs them;
- ``cone_fields_cuda``/``march_fields_cuda`` launch the hand-written CUDA
  kernels (csrc/bulb.cu) on the current stream.  K4b is a persistent
  kernel (``march_grid``: one wave of blocks) whose lanes take pixels from
  a queue in 8×4-patch order (``patch_order_xy``) whose head the wrapper
  zeroes for each launch, and share each hit pixel's 12 shading orbits
  with the other lanes of their warp; an optional trips buffer
  (``trips_buffer``) receives its per-warp counters, which
  ``decode_trips`` reads;
- ``cone_fields_plain``/``march_fields_plain`` are the same per-lane state
  machines as plain PyTorch ops on (H, W) tensors: each loop trip advances
  every live orbit by one DE step and handles the event of each lane whose
  orbit just ended;
- ``march_fields`` (the JAX signature, with ``device`` for ``interpret``
  and no ``tile``) takes the plain versions for a CPU device only; for a
  CUDA device it launches the kernels or raises.

``stats=True`` adds two per-lane planes: ``msteps`` (march evaluations, the
JAX nested form's ``msteps``) and ``work`` (DE iterations the lane ran:
march, esc recovery and shading), and ``warp_work``, each lane's maximum
of ``work`` over its 8×4-pixel patch.  They replace the JAX per-tile
``de_trips``/``n_trips``/``ao_trips``, which measure a TPU tile schedule:
Σwork is the DE work the frame needs, and Σwarp_work / Σwork the
divergence waste of a static schedule of one patch per warp (K4a's, and
K4b's before its lanes refilled); K4b's own is its counters' lane
utilisation.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.diag import span
from . import bulb_math as bm
from . import trig

(B_ROX, B_ROY, B_ROZ, B_FOV, B_POWER, B_LIMIT, B_OFFX, B_OFFY,
 B_ROW0) = range(9)
NB = 9
# cone-pass params: the march vector's first 8 slots, then the band's first
# coarse row (in B_ROW0), the coarse pixel stride and the cone half-angle
C_STEP, C_BETA = 9, 10
NCB = 11

# Over-relaxed sphere tracing (Keinert et al., "Enhanced Sphere Tracing").
OMEGA = 1.6
RELAX_CUTOFF = 8.0


def _ao_offsets() -> Tuple[float, ...]:
    """The shader's f32 AO loop for(k = 0.01; k < 0.15; k += 0.02): eight
    taps at the accumulated f32 offsets (the last is 0.14999998)."""
    ks, k = [], np.float32(0.01)
    while k < np.float32(0.15):
        ks.append(float(k))
        k = np.float32(k + np.float32(0.02))
    return tuple(ks)


AO_KS = _ao_offsets()
assert len(AO_KS) == 8  # csrc/bulb.cu walks eight AO taps

# the plain version's phases: the march, the esc recovery, the 11 taps
MARCH, ESC, TAP0 = 0, 1, 2
N_TAPS = 3 + len(AO_KS)
DONE = TAP0 + N_TAPS

# K4b's per-warp counters, the columns of a trips buffer (csrc/bulb.cu
# T_*): loop trips, trips in which a lane stepped, trips in which a lane
# ran event code, the sum of the stepping lanes over the trips, pixels
# finished, the SM, and the start and end (ns, %globaltimer) as lo/hi
TRIP_FIELDS = ("trips", "step_trips", "event_trips", "lane_steps", "pixels",
               "smid", "start_lo", "start_hi", "end_lo", "end_hi")

# warp footprint of both kernels: 8 columns x 4 rows
WARP_W, WARP_H = 8, 4
_MAX_HEIGHT = 65535 * 8  # CUDA grid.y limit for K4a's 32x8-lane blocks
# K4b's int32 queue head passes the queue's end by at most a round per lane
_MAX_QUEUE = (1 << 31) - (1 << 24)
_EARLY_EXIT_EVERY = 8  # plain path: test for live lanes this often


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Host side: the parameter vectors
# ---------------------------------------------------------------------------

def pack_march_params(*, ro, fov, power, max_iter: int,
                      offset=(0.0, 0.0), row0=0.0) -> np.ndarray:
    """The 9-float march vector, slot for slot as the JAX ``march_fields``
    packs it (bulb_kernel.py:947-955)."""
    f = np.float32
    return np.array([f(ro[0]), f(ro[1]), f(ro[2]), f(fov), f(power),
                     f(max(1, int(max_iter))), f(offset[0]), f(offset[1]),
                     f(row0)], np.float32)


def pack_cone_params(params: np.ndarray, cone: int,
                     map_height: int) -> np.ndarray:
    """The 11-float cone vector (bulb_kernel.py:966-976): the march
    vector's first 8 slots, start_c = floor(row0 / cone), the stride and
    beta = f32(fov) · f32((0.75·cone + 1) / map_height)."""
    cs = np.float32(cone)
    start_c = np.floor(params[B_ROW0] / cs)
    beta = params[B_FOV] * np.float32((0.75 * cone + 1.0) / map_height)
    return np.concatenate([params[:B_ROW0],
                           np.array([start_c, cs, beta], np.float32)])


def resolve_int_power(power, int_power="auto") -> Optional[int]:
    """The static integer-power decision of the JAX ``march_fields``:
    powers 2..16 that are whole take the trig-free DE step."""
    if int_power != "auto":
        return None if int_power is None else int(int_power)
    pw = float(power)
    return int(pw) if pw.is_integer() and 2.0 <= pw <= 16.0 else None


def _check_common(params: np.ndarray, n: int, int_power) -> int:
    if params.dtype != np.float32 or params.shape != (n,):
        raise ValueError(f"params must be float32 of shape ({n},), got "
                         f"{params.dtype} {params.shape}")
    if int_power is not None and not 2 <= int_power <= 16:
        raise ValueError(f"int_power must be None or in 2..16, got "
                         f"{int_power}")
    limit = int(params[B_LIMIT])
    if not 1 <= limit < 1 << 24:
        raise ValueError("the iteration limit must be in [1, 2^24)")
    return limit


def _check_march(params, tc, width, height, map_height, cone,
                 int_power) -> int:
    _check_common(params, NB, int_power)
    if width < 1 or height < 1:
        raise ValueError(f"bad field size {width}x{height}")
    if cdiv(width, WARP_W) * cdiv(height, WARP_H) * 32 > _MAX_QUEUE:
        raise ValueError(f"field size {width}x{height} is too large")
    row0 = float(params[B_ROW0])
    if not row0.is_integer() or row0 < 0 or row0 + height > map_height:
        raise ValueError(f"band rows [{row0}, {row0 + height}) are not "
                         f"whole rows of the image height {map_height}")
    if tc is not None:
        want = (cdiv(height, cone) + 1, cdiv(width, cone))
        if cone < 1 or tuple(tc.shape) != want or tc.dtype != torch.float32:
            raise ValueError(f"the cone grid must be float32 {want} for "
                             f"cone {cone}, got {tc.dtype} "
                             f"{tuple(tc.shape)}")
    return int(row0)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

class _Orbits:
    """Every lane's current DE orbit: its start position p, z, dr, the
    carried |z|, its iteration count and _de_tile's escape index."""

    def __init__(self, x, y, z):
        self.px, self.py, self.pz = x, y, z
        self.zx, self.zy, self.zz = x, y, z
        self.dr = torch.ones_like(x)
        self.r = trig.sqrt(x * x + y * y + z * z)
        self.oi = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
        self.esc = self._esc0(self.r)

    @staticmethod
    def _esc0(r):
        return torch.where(r > 2.0, 0, -1).to(torch.int32)

    def restart(self, sel, x, y, z):
        """Start a new orbit at (x, y, z) on the lanes of ``sel``."""
        self.px = torch.where(sel, x, self.px)
        self.py = torch.where(sel, y, self.py)
        self.pz = torch.where(sel, z, self.pz)
        self.zx = torch.where(sel, x, self.zx)
        self.zy = torch.where(sel, y, self.zy)
        self.zz = torch.where(sel, z, self.zz)
        self.dr = torch.where(sel, torch.ones_like(self.dr), self.dr)
        r0 = trig.sqrt(self.px * self.px + self.py * self.py
                       + self.pz * self.pz)
        self.r = torch.where(sel, r0, self.r)
        self.oi = torch.where(sel, 0, self.oi)
        self.esc = torch.where(sel, self._esc0(r0), self.esc)

    def live(self, limit: int, full_length):
        """_flat_march's orbit_act (dr-overflow exit) or, where
        ``full_length``, _de_tile's act."""
        return (self.r <= 2.0) & (self.r >= 1e-4) & (self.oi < limit) \
            & (full_length | (self.dr < float("inf")))

    def step(self, act, power, limit: int, int_power):
        if int_power is not None:
            zx, zy, zz, dr, _ = bm.de_step_int(
                self.zx, self.zy, self.zz, self.dr, self.px, self.py,
                self.pz, int_power, act, r=self.r)
        else:
            zx, zy, zz, dr, _ = bm.de_step(
                self.zx, self.zy, self.zz, self.dr, self.px, self.py,
                self.pz, power, act, r=self.r)
        # inactive lanes keep their z, so rn equals their carried r
        rn = trig.sqrt(zx * zx + zy * zy + zz * zz)
        self.esc = torch.where((self.esc < 0) & act & (rn > 2.0)
                               & (self.oi + 1 < limit), self.oi + 1,
                               self.esc)
        self.zx, self.zy, self.zz, self.dr, self.r = zx, zy, zz, dr, rn
        self.oi = self.oi + act.to(torch.int32)


def expand_cone(tc: torch.Tensor, row0: int, cone: int, width: int,
                height: int) -> torch.Tensor:
    """K4a's grid at the band's full resolution: each pixel takes its
    image-aligned block's t (bulb_kernel.py:983-987; the grid's row 0 is
    block floor(row0 / cone))."""
    ridx = (row0 % cone + torch.arange(height, device=tc.device)) // cone
    cidx = torch.arange(width, device=tc.device) // cone
    return tc[ridx][:, cidx]


def cone_fields_plain(params: np.ndarray, *, coarse_w: int, coarse_h: int,
                      width: int, map_height: int, int_power, device,
                      stats: bool = False):
    """K4a as plain PyTorch ops: the (coarse_h, coarse_w) start depths.
    The CPU path of march_fields, and the comparator of the CUDA kernel on
    the card.  ``stats`` also returns each coarse lane's march evaluations
    and DE iterations (int32 planes), the kernel's work."""
    limit = _check_common(params, NCB, int_power)
    dev = torch.device(device)
    f32 = torch.float32
    p = torch.from_numpy(params).to(dev)
    shape = (coarse_h, coarse_w)
    cs, beta = p[C_STEP], p[C_BETA]
    cols = torch.arange(coarse_w, dtype=torch.int32, device=dev).to(f32)
    rows = torch.arange(coarse_h, dtype=torch.int32, device=dev).to(f32)
    pxf = (cols * cs + p[B_OFFX] + (cs - 1.0) * 0.5)[None, :].expand(shape)
    pyf = ((rows + p[B_ROW0]) * cs + p[B_OFFY]
           + (cs - 1.0) * 0.5)[:, None].expand(shape)
    ro = (p[B_ROX], p[B_ROY], p[B_ROZ])
    rdx, rdy, rdz = bm.ray_dirs(pxf, pyf, width, map_height, ro, p[B_FOV])
    power = p[B_POWER]

    t = torch.full(shape, 0.001, dtype=f32, device=dev)
    mstep = torch.zeros(shape, dtype=torch.int32, device=dev)
    work = torch.zeros_like(mstep)
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
        work = work + act.to(torch.int32)
        ended = ~done & ~orb.live(limit, False)
        d = bm.de_finish(orb.r, orb.dr)
        bad = ~torch.isfinite(d)
        thr = torch.maximum(torch.clamp_min(1e-3 * t, 1e-4), 3.0 * beta * t)
        stop = ended & (bad | (d < thr) | (t > bm.MAX_DIST)
                        | (d > bm.MAX_DIST))
        bad_f = bad_f | (ended & bad)
        mstep = mstep + ended.to(torch.int32)
        t = torch.where(ended & ~stop,
                        t + torch.clamp_min(d * 0.5, 0.0005), t)
        done = done | stop | (ended & (mstep >= bm.MAX_STEPS))
        orb.restart(ended & ~done, ro[0] + rdx * t, ro[1] + rdy * t,
                    ro[2] + rdz * t)
    t0 = torch.where(bad_f, torch.full_like(t, 0.001), t)
    return (t0, mstep, work) if stats else t0


def _dead_lane_constants(dev):
    """_flat_shade's closed-form normal and AO of a non-hit lane: parked at
    (3, 0, 0) with d0 = 0, every tap orbit is dead on arrival."""
    def f(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    far, zero, eps, one = f(3.0), f(0.0), f(1e-3), f(1.0)

    def dead_de(x, y, z):
        return bm.de_finish(trig.sqrt(x * x + y * y + z * z), one)

    nxr = dead_de(far + eps, zero, zero) - zero
    nyr = dead_de(far, zero + eps, zero) - zero
    nzr = dead_de(far, zero, zero + eps) - zero
    nl = trig.sqrt(nxr * nxr + nyr * nyr + nzr * nzr)
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


def march_fields_plain(params: np.ndarray, tc: Optional[torch.Tensor], *,
                       width: int, height: int, map_height: int, cone: int,
                       shade: bool, int_power, stats: bool,
                       device) -> Tuple[torch.Tensor, ...]:
    """K4b as plain PyTorch ops: returns hit, t, d, esc [, nx, ny, nz, ao]
    [, msteps, work] as (height, width) f32.  ``tc`` is K4a's grid (or None
    for t0 = 0.001).  The CPU path of march_fields, and the comparator of
    the CUDA kernel on the card."""
    row0 = _check_march(params, tc, width, height, map_height, cone,
                        int_power)
    limit = int(params[B_LIMIT])
    dev = torch.device(device)
    f32, i32 = torch.float32, torch.int32
    p = torch.from_numpy(params).to(dev)
    shape = (height, width)
    rows = torch.arange(row0, row0 + height, dtype=i32, device=dev)
    cols = torch.arange(width, dtype=i32, device=dev)
    pxf = (cols.to(f32) + p[B_OFFX])[None, :].expand(shape)
    pyf = (rows.to(f32) + p[B_OFFY])[:, None].expand(shape)
    ro = (p[B_ROX], p[B_ROY], p[B_ROZ])
    rdx, rdy, rdz = bm.ray_dirs(pxf, pyf, width, map_height, ro, p[B_FOV])
    power = p[B_POWER]

    if tc is not None:
        t = torch.clamp_min(expand_cone(tc.to(dev), row0, cone, width,
                                        height), 0.001)
    else:
        t = torch.full(shape, 0.001, dtype=f32, device=dev)

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
        d = bm.de_finish(orb.r, orb.dr)
        ev_m = ended & (phase == MARCH)
        ev_e = ended & (phase == ESC)
        ev_s = ended & (phase >= TAP0)
        new_phase = phase

        # the march update (_flat_march body), nested-form cap
        mstep = mstep + ev_m.to(i32)
        bad = ~torch.isfinite(d)
        rad = 0.5 * d
        over_b = ev_m & rel_prev & (bad | (prev_step > prev_rad + rad))
        usable = ev_m & ~over_b
        thr = torch.clamp_min(1e-3 * t, 1e-4)
        hit_now = usable & ~bad & (d < thr)
        hit = hit | hit_now
        d_hit = torch.where(hit_now, d, d_hit)
        out = (t > bm.MAX_DIST) | (d > bm.MAX_DIST)
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
        stop = ev_m & (m_ended | (mstep >= bm.MAX_STEPS))
        to_esc = stop & hit
        hx = torch.where(to_esc, sx, hx)
        hy = torch.where(to_esc, sy, hy)
        hz = torch.where(to_esc, sz, hz)
        new_phase = torch.where(stop, torch.where(hit, ESC, DONE), new_phase)

        # the esc recovery's end
        if bool(ev_e.any()):
            esc_f = torch.where(orb.esc < 0, limit, orb.esc).to(f32)
            esc_hit = torch.where(ev_e, esc_f, esc_hit)
            new_phase = torch.where(ev_e, TAP0 if shade else DONE, new_phase)
            sx = torch.where(ev_e, hx + 1e-3, sx)
            sy = torch.where(ev_e, hy, sy)
            sz = torch.where(ev_e, hz, sz)

        # a shading tap's end (_flat_shade body)
        if bool(ev_s.any()):
            k = phase - TAP0
            dxp = torch.where(ev_s & (k == 0), d, dxp)
            dyp = torch.where(ev_s & (k == 1), d, dyp)
            dzp = torch.where(ev_s & (k == 2), d, dzp)
            nsel = ev_s & (k == 2)
            nxr, nyr, nzr = dxp - d_hit, dyp - d_hit, dzp - d_hit
            nl = trig.sqrt(nxr * nxr + nyr * nyr + nzr * nzr)
            fb = nl < 1e-4
            nl = torch.clamp_min(nl, 1e-12)
            nx = torch.where(nsel, torch.where(fb, 0.0, nxr / nl), nx)
            ny = torch.where(nsel, torch.where(fb, 1.0, nyr / nl), ny)
            nz = torch.where(nsel, torch.where(fb, 0.0, nzr / nl), nz)
            kf = torch.where(nsel, AO_KS[0], kf)
            aosel = ev_s & (k >= 3)
            ao = torch.where(aosel, ao + torch.exp(-10.0 * d), ao)
            kf = torch.where(aosel, kf + 0.02, kf)
            # the next tap: the normal's basis offsets, then h + n·k
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

    outs = [hit.to(f32), t, d_hit, esc_hit]
    if shade:
        nxc, nyc, nzc, aoc = _dead_lane_constants(dev)
        outs += [torch.where(hit, nx, nxc), torch.where(hit, ny, nyc),
                 torch.where(hit, nz, nzc), torch.where(hit, ao, aoc)]
    if stats:
        outs += [mstep.to(f32), work.to(f32)]
    return tuple(outs)


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

def cone_fields_cuda(params: np.ndarray, *, coarse_w: int, coarse_h: int,
                     width: int, map_height: int, int_power,
                     device) -> torch.Tensor:
    """Launch K4a (csrc/bulb.cu) on ``device`` (same signature and result
    as cone_fields_plain).  Counts its launches in
    ``cone_fields_cuda.launches``."""
    from . import _cuda

    _check_common(params, NCB, int_power)
    if coarse_w < 1 or coarse_h < 1 or coarse_h > _MAX_HEIGHT:
        raise ValueError(f"bad cone grid {coarse_w}x{coarse_h}")
    dev = _cuda.cuda_device(device)
    params = np.ascontiguousarray(params)
    lib = _cuda.load_library()
    with torch.cuda.device(dev):
        t0 = torch.empty((coarse_h, coarse_w), dtype=torch.float32,
                         device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fr_bulb_cone(int_power or 0, params.ctypes.data, coarse_w,
                              coarse_h, width, map_height, t0.data_ptr(),
                              stream)
    _cuda.check(lib, rc, "bulb cone")
    cone_fields_cuda.launches += 1
    return t0


cone_fields_cuda.launches = 0


def march_grid(int_power, width: int, height: int,
               device) -> Tuple[int, int]:
    """(blocks of 256 threads, resident blocks per SM) of K4b's launch for
    a width x height field on ``device``: the trips buffer has 8 rows (one
    per warp) per block."""
    import ctypes

    from . import _cuda

    dev = _cuda.cuda_device(device)
    lib = _cuda.load_library()
    blocks, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.fr_bulb_march_grid(int_power or 0, width, height,
                                    ctypes.byref(blocks),
                                    ctypes.byref(per_sm))
    _cuda.check(lib, rc, "bulb march occupancy")
    return blocks.value, per_sm.value


def trips_buffer(int_power, width: int, height: int,
                 device) -> torch.Tensor:
    """A zeroed trips buffer for K4b's launch: (warps, len(TRIP_FIELDS))
    int32 on ``device``."""
    blocks, _ = march_grid(int_power, width, height, device)
    return torch.zeros((blocks * 8, len(TRIP_FIELDS)), dtype=torch.int32,
                       device=device)


def decode_trips(trips: torch.Tensor) -> Dict[str, float]:
    """Sum K4b's per-warp counters (the rows of a filled trips buffer; rows
    of warps that finished no pixel are left out) and derive: lane
    utilisation, lane_steps / (32 step_trips); the event share,
    event_trips / trips; the span (ns) from the first warp's start to the
    last warp's end; and the tail share, the part of the span after the
    number of running warps last fell below half its peak."""
    a = trips.detach().cpu().numpy().astype(np.int64)
    a = a[a[:, TRIP_FIELDS.index("pixels")] > 0]
    col = {n: a[:, i] for i, n in enumerate(TRIP_FIELDS)}
    start = (col["start_hi"] << 32) | (col["start_lo"] & 0xFFFFFFFF)
    end = (col["end_hi"] << 32) | (col["end_lo"] & 0xFFFFFFFF)
    out = {n: int(col[n].sum()) for n in TRIP_FIELDS[:5]}
    out["warps"] = int(len(a))
    out["sms"] = int(len(np.unique(col["smid"])))
    out["lane_util"] = out["lane_steps"] / max(32 * out["step_trips"], 1)
    out["event_share"] = out["event_trips"] / max(out["trips"], 1)
    t0, t1 = int(start.min()), int(end.max())
    out["span_ns"] = t1 - t0
    # running warps over time: +1 at each start, -1 at each end (ends
    # first where they tie)
    times = np.concatenate([start, end])
    steps = np.concatenate([np.ones_like(start), -np.ones_like(end)])
    order = np.lexsort((steps, times))
    running = np.cumsum(steps[order])
    # the event after which fewer than half the peak run, for good (the
    # last event leaves none running)
    last_high = np.flatnonzero(running >= running.max() / 2.0)[-1]
    t_half = int(times[order][last_high + 1])
    out["tail_share"] = (t1 - t_half) / max(t1 - t0, 1)
    return out


def march_fields_cuda(params: np.ndarray, tc: Optional[torch.Tensor], *,
                      width: int, height: int, map_height: int, cone: int,
                      shade: bool, int_power, stats: bool, device,
                      trips: Optional[torch.Tensor] = None,
                      ) -> Tuple[torch.Tensor, ...]:
    """Launch K4b (csrc/bulb.cu) on ``device`` (same signature and results
    as march_fields_plain; ``tc`` must lie on ``device``).  ``trips``, a
    buffer from trips_buffer, is zeroed and filled with the launch's
    per-warp counters (decode_trips reads it); without it the kernel
    writes none.  Counts its launches in ``march_fields_cuda.launches``,
    and those of the polynomial-trig DE step (``int_power`` None) in
    ``march_fields_cuda.trig_launches``."""
    from . import _cuda

    _check_march(params, tc, width, height, map_height, cone, int_power)
    dev = _cuda.cuda_device(device)
    if tc is not None and (tc.device != dev or not tc.is_contiguous()):
        raise ValueError("the cone grid must be a contiguous tensor on "
                         f"{dev}")
    if trips is not None:
        want = (march_grid(int_power, width, height, dev)[0] * 8,
                len(TRIP_FIELDS))
        if (trips.dtype != torch.int32 or trips.device != dev
                or tuple(trips.shape) != want or not trips.is_contiguous()):
            raise ValueError(f"the trips buffer must be a contiguous int32 "
                             f"{want} tensor on {dev}, got {trips.dtype} "
                             f"{tuple(trips.shape)} on {trips.device}")
    params = np.ascontiguousarray(params)
    lib = _cuda.load_library()
    n_out = (8 if shade else 4) + (2 if stats else 0)
    with torch.cuda.device(dev):
        outs = tuple(torch.empty((height, width), dtype=torch.float32,
                                 device=dev) for _ in range(n_out))
        ptrs = [o.data_ptr() for o in outs[:4]]
        ptrs += ([o.data_ptr() for o in outs[4:8]] if shade else [None] * 4)
        ptrs += ([o.data_ptr() for o in outs[-2:]] if stats else [None] * 2)
        # the pixel queue's head, zeroed on the launch's stream
        head = torch.zeros(1, dtype=torch.int32, device=dev)
        ptrs.append(head.data_ptr())
        if trips is not None:
            trips.zero_()
        ptrs.append(None if trips is None else trips.data_ptr())
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fr_bulb_march(
            int_power or 0, params.ctypes.data,
            None if tc is None else tc.data_ptr(),
            0 if tc is None else tc.shape[1], max(int(cone), 1), width,
            height, map_height, int(bool(shade)), *ptrs, stream)
    _cuda.check(lib, rc, "bulb march")
    march_fields_cuda.launches += 1
    march_fields_cuda.trig_launches += int(int_power is None)
    return outs


march_fields_cuda.launches = 0
march_fields_cuda.trig_launches = 0


def patch_order_xy(width: int, height: int, device="cpu"):
    """K4b's pixel queue (csrc/bulb.cu patch_xy): index i of the
    cdiv(width, 8) x cdiv(height, 4) x 32 queue fills 8x4 patches, the
    patches in row-major order.  Returns (x, y, valid) int32/bool tensors
    over the queue; the invalid entries are the ragged right and bottom
    edges' padding, which the kernel skips."""
    pw = cdiv(width, WARP_W)
    i = torch.arange(pw * cdiv(height, WARP_H) * 32, dtype=torch.int32,
                     device=device)
    q, r = i // 32, i % 32
    x = (q % pw) * WARP_W + r % WARP_W
    y = (q // pw) * WARP_H + r // WARP_W
    return x, y, (x < width) & (y < height)


def warp_max(plane: torch.Tensor) -> torch.Tensor:
    """Each lane's maximum of ``plane`` (H, W) over its 8×4-pixel patch
    (aligned at multiples of 8 columns and 4 rows): the model of a static
    schedule in which each warp runs one patch, as K4a does and K4b did
    until its lanes refilled from a pixel queue.  Σwarp_max / Σplane is
    that schedule's divergence waste, against which K4b's counters (its
    lane utilisation) are read."""
    h, w = plane.shape
    hp, wp = cdiv(h, WARP_H) * WARP_H, cdiv(w, WARP_W) * WARP_W
    padded = torch.zeros((hp, wp), dtype=plane.dtype, device=plane.device)
    padded[:h, :w] = plane
    m = padded.view(hp // WARP_H, WARP_H, wp // WARP_W, WARP_W).amax(
        dim=(1, 3))
    return m.repeat_interleave(WARP_H, 0).repeat_interleave(WARP_W, 1)[:h, :w]


def march_fields(width: int, height: int, *, ro, fov, power, max_iter: int,
                 offset=(0.0, 0.0), shade: bool = False, row0=0,
                 map_height: Optional[int] = None, int_power="auto",
                 cone: int = 8, stats: bool = False,
                 device="cuda") -> Dict[str, torch.Tensor]:
    """Raymarch fields {"hit", "t", "d", "esc" [, "nx", "ny", "nz", "ao"]
    [, "msteps", "work", "warp_work"]} as (height, width) f32 on ``device``,
    with the JAX signature.  ``ro``/``fov``/``power`` are host scalars
    (rounded to f32); for a row band pass its global first row as ``row0``
    and the image height as ``map_height``.  ``cone``: the prepass block
    size (0 disables it).  The march vector and K4b run in the span
    ``k4b.launch``, the cone vector and K4a in ``k4a.launch``."""
    with span("k4b.launch"):
        params = pack_march_params(ro=ro, fov=fov, power=power,
                                   max_iter=max_iter, offset=offset,
                                   row0=row0)
        int_power = resolve_int_power(power, int_power)
        map_h = int(map_height if map_height is not None else height)
        cone = int(cone)
        dev = torch.device(device)
        if dev.type == "cpu":
            cone_impl, march_impl = cone_fields_plain, march_fields_plain
        elif dev.type == "cuda":
            cone_impl, march_impl = cone_fields_cuda, march_fields_cuda
        else:
            raise ValueError(f"unsupported device {dev}")
    tc = None
    if cone:
        with span("k4a.launch"):
            tc = cone_impl(pack_cone_params(params, cone, map_h),
                           coarse_w=cdiv(width, cone),
                           coarse_h=cdiv(height, cone) + 1, width=width,
                           map_height=map_h, int_power=int_power,
                           device=dev)
    with span("k4b.launch"):
        outs = march_impl(params, tc, width=width, height=height,
                          map_height=map_h, cone=cone, shade=bool(shade),
                          int_power=int_power, stats=bool(stats),
                          device=dev)
    names = ["hit", "t", "d", "esc"] + (["nx", "ny", "nz", "ao"]
                                        if shade else [])
    if stats:
        names += ["msteps", "work"]
    fields = dict(zip(names, outs))
    if stats:
        fields["warp_work"] = warp_max(fields["work"])
    return fields
