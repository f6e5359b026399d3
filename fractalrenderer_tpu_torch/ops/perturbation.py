"""Perturbation deep zoom, kernel K3 (the port's counterpart of
``fractalrenderer_tpu/ops/perturbation.py``): the Mandelbrot family with
per-pixel (Zhuoran) rebasing and the series-skip start, in the three delta
tiers of the rebasing pipeline.

Every pixel iterates its delta δ ← 2Zδ + δ² + δc against one reference orbit
Z (``deepzoom/orbit.py``), in f32 (tier ``"f32"``), in double-double
(``"dd"``, ``dd_delta``) or in floatexp (``"fx"``, ``scaled_delta``: a dd
mantissa and an i32 exponent, past the f32 exponent range).  A lane whose
full value |Z + δ| drops below |δ|, or that reaches the end of the orbit
with budget left, rebases (δ ← Z + δ) and at once restarts at orbit index 0,
up to ``max_passes`` rounds; a lane still wanting a rebase after that leaves
``want`` = 1 for the caller's HP fallback (models/deep_zoom.py).  The TPU
kernel runs these rounds per tile; each lane's iteration sequence is the
same, and the ``rounds`` plane is per pixel here (its max is the TPU's
``passes``).

- ``pack_pert_operands`` builds the 41-float parameter vector and the orbit
  streams exactly as the JAX ``perturbation_fields`` builds its operands;
- ``perturbation_fields_cuda`` launches the hand-written CUDA kernel
  (csrc/perturbation.cu) on the current stream;
- ``perturbation_fields_plain`` is the same per-lane computation as plain
  PyTorch elementwise ops on (H, W) tensors, each lane with its own orbit
  index;
- ``perturbation_fields`` (the JAX signature, with ``device``) takes the
  plain version for a CPU device only; for a CUDA device it launches the
  kernel or raises.

The other families, stacked spp² AA, the error ledger and the non-rebasing
path raise NotImplementedError naming their ROADMAP item.
"""
from __future__ import annotations

import math
from fractions import Fraction
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import dd

# Parameter vector layout, identical to the JAX package's
# (fractalrenderer_tpu/ops/perturbation.py:49-54).
(Q_CXH, Q_CXL, Q_CYH, Q_CYL, Q_PSH, Q_PSL, Q_LIMIT, Q_BAIL2, Q_REFLEN,
 Q_GLITCH_TOL, Q_SHIFTXH, Q_SHIFTXL, Q_SHIFTYH, Q_SHIFTYL, Q_OFFX,
 Q_OFFY, Q_AR, Q_AI, Q_BR, Q_BI, Q_CR, Q_CI, Q_NSKIP, Q_ROW0,
 Q_ARL, Q_AIL, Q_BRL, Q_BIL, Q_CRL, Q_CIL, Q_SEXP, Q_M0, Q_FIRST,
 Q_Z0XH, Q_Z0XL, Q_Z0YH, Q_Z0YL, Q_PP, Q_RR, Q_SE0, Q_AROW0) = range(41)
NQ = 41

# The JAX package buckets the orbit length up to a power of two (>= 256) no
# larger than this, and stores longer orbits whole; Q_REFLEN is the orbit
# length clamped to that bucket, so the port computes it the same way.
ORBIT_BUCKET_MAX = 32768

# exponent of an exact floatexp zero (far below any real scale, safe from
# i32 overflow when doubled)
E_ZERO = -(1 << 24)

TIERS = ("f32", "dd", "fx")  # the kernel's tier ids, in order

_EARLY_EXIT_EVERY = 16  # plain path: test for live lanes this often
_MAX_HEIGHT = 65535 * 8  # CUDA grid.y limit for the (32, 8) blocks

DD = Tuple[float, float]


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} not ported yet (ROADMAP Queue 1 item {item})")


# ---------------------------------------------------------------------------
# Host side: the operands of one launch
# ---------------------------------------------------------------------------

def _series_f32_representable(s) -> bool:
    """The non-floatexp tiers ship the raw f64 series coefficients as f32;
    past 1e36 (chaotic references at QUAD depths) they would turn into
    inf/NaN, so such a series is dropped (the skip is an optimisation)."""
    vals = (s.a.real, s.a.imag, s.b.real, s.b.imag, s.c.real, s.c.imag)
    return all(abs(v) < 1e36 and v == v for v in vals)


def pack_pert_operands(orbit: np.ndarray, width: int, height: int, *,
                       center_x_dd: DD, center_y_dd: DD,
                       zoom_dd: DD = (0.0, 0.0), max_iter: int,
                       bailout: float = 4.0, glitch_tol: float = 1e-6,
                       ref_shift_x: DD = (0.0, 0.0),
                       ref_shift_y: DD = (0.0, 0.0),
                       offset: Tuple[float, float] = (0.0, 0.0),
                       iter_limit=None, series=None, row0=0.0,
                       map_height: Optional[int] = None,
                       dd_delta: bool = False, scaled_delta: bool = False,
                       zoom_frac: Union[str, Fraction, None] = None,
                       ref_shift_x_frac: Union[str, Fraction, None] = None,
                       ref_shift_y_frac: Union[str, Fraction, None] = None
                       ) -> Tuple[np.ndarray, Tuple[np.ndarray, ...], str]:
    """The parameters (NQ,) f32, the orbit streams and the tier of one K3
    launch, packed as the JAX ``perturbation_fields`` packs its operands
    for the rebasing Mandelbrot path (perturbation.py:1444-1808): the exact
    rational step zoom·4/map_h², the 2^s pre-scale of the floatexp tier,
    the series coefficients in either form.  Streams: re and im of the
    orbit as f32 (f32 tier), plus the lo parts of the f64 orbit (dd and
    floatexp tiers), each ``cap`` long and zero past the orbit."""
    if scaled_delta:
        if dd_delta:
            raise ValueError("scaled_delta supersedes dd_delta")
        if series is not None and series.n_skip > 1:
            from ..deepzoom.series import SeriesSkipFX

            if not isinstance(series, SeriesSkipFX):
                raise ValueError("scaled-delta series skip requires "
                                 "SeriesSkipFX (compute_series_skip_fx)")
    if iter_limit is None:
        iter_limit = max_iter
    map_h = int(map_height if map_height is not None else height)
    # exact per-pixel step = zoom * 4 / map_height^2
    if zoom_frac is not None:
        zoom_fr = Fraction(zoom_frac)
    else:
        zoom_fr = Fraction(zoom_dd[0]) + Fraction(zoom_dd[1])
    step_fr = zoom_fr * 4 / (map_h * map_h)
    s_exp = 0
    if scaled_delta:
        if step_fr == 0:
            raise ValueError("scaled_delta requires a nonzero zoom")
        # scale so step' ~ 2^-14: delta-c mantissas land in [2^-14, ~2]
        s_exp = -14 - (step_fr.numerator.bit_length()
                       - step_fr.denominator.bit_length())
        step_fr *= Fraction(2) ** s_exp
    step_dd = dd.dd_from_fraction(step_fr)
    if scaled_delta:
        sh_x = Fraction(ref_shift_x_frac) if ref_shift_x_frac is not None \
            else Fraction(0)
        sh_y = Fraction(ref_shift_y_frac) if ref_shift_y_frac is not None \
            else Fraction(0)
        two_s = Fraction(2) ** s_exp
        ref_shift_x = dd.dd_from_fraction(sh_x * two_s)
        ref_shift_y = dd.dd_from_fraction(sh_y * two_s)
    if max_iter >= 1 << 24:
        # per-pixel counters (and LIMIT/REFLEN params) are f32: n+1 == n
        # past 2^24, which would wedge the interior latch
        raise ValueError("max_iter must be < 2^24 (f32 counter precision)")
    if int(iter_limit) >= 1 << 24:
        raise ValueError("iter_limit must be < 2^24 (f32 counter "
                         "precision)")
    if series is not None and max(bailout, 2.0) < 4.0:
        raise ValueError(
            "series skip requires bailout >= 4 (its escape-exactness "
            "proof needs |z| <= |Z| + |delta| < bailout over the skipped "
            "range; see deepzoom/series.py)")
    bailout = max(2.0, float(bailout))  # comp:114

    if max_iter + 1 > ORBIT_BUCKET_MAX:
        cap = int(max(max_iter + 1, 2))
    else:
        b = 256
        while b < max_iter + 1:
            b *= 2
        cap = int(min(b, ORBIT_BUCKET_MAX))
    L = int(min(len(orbit), cap))
    orbit_re = np.zeros(cap, np.float32)
    orbit_im = np.zeros(cap, np.float32)
    orbit_re[:L] = orbit[:L, 0].astype(np.float32)
    orbit_im[:L] = orbit[:L, 1].astype(np.float32)
    streams = (orbit_re, orbit_im)
    if dd_delta or scaled_delta:
        # hi/lo split of the f64 orbit: the dd/floatexp loops need dd Z
        orbit_re_lo = np.zeros(cap, np.float32)
        orbit_im_lo = np.zeros(cap, np.float32)
        orbit_re_lo[:L] = (orbit[:L, 0] - orbit_re[:L]
                           .astype(np.float64)).astype(np.float32)
        orbit_im_lo[:L] = (orbit[:L, 1] - orbit_im[:L]
                           .astype(np.float64)).astype(np.float32)
        streams += (orbit_re_lo, orbit_im_lo)

    params = np.zeros(NQ, np.float32)
    params[Q_CXH], params[Q_CXL] = center_x_dd
    params[Q_CYH], params[Q_CYL] = center_y_dd
    params[Q_PSH], params[Q_PSL] = step_dd
    params[Q_SEXP] = s_exp
    params[Q_LIMIT] = max(1, int(iter_limit))
    params[Q_BAIL2] = bailout * bailout
    params[Q_REFLEN] = L
    params[Q_GLITCH_TOL] = glitch_tol
    params[Q_SHIFTXH], params[Q_SHIFTXL] = ref_shift_x
    params[Q_SHIFTYH], params[Q_SHIFTYL] = ref_shift_y
    params[Q_OFFX], params[Q_OFFY] = offset

    def put_dd(hi_idx, lo_idx, value):
        params[hi_idx], params[lo_idx] = dd.dd_from_double(value)

    if series is not None and 1 < series.n_skip < L and scaled_delta:
        # floatexp coefficients pre-aligned to a shared exponent e0, so the
        # kernel's dd Horner over the scaled dc mantissa (= dc·2^s) yields
        # the delta mantissa at exponent e0 (perturbation.py:1750-1774)
        fx = [(series.a, series.a_e, 1), (series.b, series.b_e, 2),
              (series.c, series.c_e, 3)]
        e0 = max(e - k * s_exp for m, e, k in fx if m != 0)
        slots = ((Q_AR, Q_ARL, Q_AI, Q_AIL), (Q_BR, Q_BRL, Q_BI, Q_BIL),
                 (Q_CR, Q_CRL, Q_CI, Q_CIL))
        for (m, e, k), (rh, rl, ih, il) in zip(fx, slots):
            d = (e - k * s_exp) - e0
            if m == 0 or d < -1070:
                continue  # zeros are the params default
            put_dd(rh, rl, math.ldexp(m.real, d))
            put_dd(ih, il, math.ldexp(m.imag, d))
        params[Q_NSKIP] = series.n_skip
        params[Q_SE0] = e0
    elif series is not None and 1 < series.n_skip < L \
            and _series_f32_representable(series):
        put_dd(Q_AR, Q_ARL, series.a.real)
        put_dd(Q_AI, Q_AIL, series.a.imag)
        put_dd(Q_BR, Q_BRL, series.b.real)
        put_dd(Q_BI, Q_BIL, series.b.imag)
        put_dd(Q_CR, Q_CRL, series.c.real)
        put_dd(Q_CI, Q_CIL, series.c.imag)
        params[Q_NSKIP] = series.n_skip
    else:
        # peel update 0 (delta_1 = dc, Z_0 = 0); floatexp: A'=1 at e0=-s
        # reduces the Horner to delta_1 = dc_m · 2^-s exactly
        params[Q_AR], params[Q_NSKIP] = 1.0, 1.0
        params[Q_SE0] = -s_exp
    params[Q_FIRST] = 1.0
    params[Q_ROW0] = row0
    tier = "fx" if scaled_delta else ("dd" if dd_delta else "f32")
    return params, streams, tier


# ---------------------------------------------------------------------------
# The launch: plain PyTorch version and CUDA kernel
# ---------------------------------------------------------------------------

def _check_launch(params: np.ndarray, streams: Sequence, tier: str,
                  width: int, height: int, map_height: int,
                  max_passes: int) -> Tuple[int, int, int, int]:
    """Validate a launch; returns (limit, ref_len, n0, row0)."""
    if tier not in TIERS:
        raise ValueError(f"tier must be one of {TIERS}, got {tier!r}")
    if params.dtype != np.float32 or params.shape != (NQ,):
        raise ValueError(f"params must be float32 of shape ({NQ},), got "
                         f"{params.dtype} {params.shape}")
    want_streams = 2 if tier == "f32" else 4
    if len(streams) != want_streams:
        raise ValueError(f"tier {tier!r} takes {want_streams} orbit "
                         f"streams, got {len(streams)}")
    lengths = {tuple(s.shape) for s in streams}
    if len(lengths) != 1 or len(next(iter(lengths))) != 1:
        raise ValueError(f"orbit streams must be 1-D of one length, got "
                         f"{sorted(lengths)}")
    cap = next(iter(lengths))[0]
    if any(s.dtype not in (np.float32, torch.float32) for s in streams):
        raise ValueError("orbit streams must be float32")
    if width < 1 or height < 1:
        raise ValueError(f"bad field size {width}x{height}")
    if height > _MAX_HEIGHT or width * height >= 1 << 31:
        raise ValueError(f"field size {width}x{height} is too large")
    row0 = int(params[Q_ROW0])
    if row0 < 0 or row0 + height > map_height:
        raise ValueError(f"band rows [{row0}, {row0 + height}) fall outside "
                         f"the image height {map_height}")
    limit = int(params[Q_LIMIT])
    if not 1 <= limit < 1 << 24:
        raise ValueError("the iteration limit must be in [1, 2^24)")
    if not 1 <= max_passes < 1 << 31:
        raise ValueError(f"max_passes must be >= 1, got {max_passes}")
    ref_len, n0 = int(params[Q_REFLEN]), int(params[Q_NSKIP])
    if not (0 <= ref_len <= cap and 0 <= n0 < cap):
        raise ValueError(f"orbit length {ref_len} / start index {n0} do not "
                         f"fit streams of length {cap}")
    return limit, ref_len, n0, row0


def _device_streams(streams: Sequence, dev: torch.device):
    return [s.to(dev) if isinstance(s, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(s)).to(dev)
            for s in streams]


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2^k as f32 for an int32 tensor k through the exponent field (0
    below 2^-126, 2^127 above): exact, unlike exp2."""
    kc = torch.clamp(k, -126, 127)
    f = ((kc + 127) << 23).view(torch.float32)
    return torch.where(k < -126, torch.zeros_like(f), f)


def _expo(x: torch.Tensor) -> torch.Tensor:
    """floor(log2 |x|) of a normal f32 from its exponent field (-127 for
    0)."""
    return ((x.view(torch.int32) >> 23) & 0xFF) - 127


def _scl(v, f):
    return v[0] * f, v[1] * f


def _cmul_dd(ar, ai, br, bi):
    return (dd.dd_sub(dd.dd_mul(ar, br), dd.dd_mul(ai, bi)),
            dd.dd_add(dd.dd_mul(ar, bi), dd.dd_mul(ai, br)))


def _select(cond, a, b):
    """torch.where over a dd pair."""
    return torch.where(cond, a[0], b[0]), torch.where(cond, a[1], b[1])


def perturbation_fields_plain(params: np.ndarray, streams: Sequence, *,
                              tier: str, width: int, height: int,
                              map_height: int, max_passes: int,
                              device) -> Tuple[torch.Tensor, ...]:
    """K3 as plain PyTorch ops on ``device``: returns (n, zx, zy, glitch,
    want, rounds).  The CPU path of perturbation_fields, and the
    comparator of the CUDA kernel on the card.  Each lane keeps its own
    orbit index (a gather per orbit read) and restarts at index 0 at the
    step after it raises ``want``, as a kernel thread does."""
    limit, ref_len, n0, row0 = _check_launch(params, streams, tier, width,
                                             height, map_height, max_passes)
    dev = torch.device(device)
    f32, i32 = torch.float32, torch.int32
    shape = (height, width)
    p = torch.from_numpy(params).to(dev)
    ore, oim, *lo = _device_streams(streams, dev)
    last = ore.shape[0] - 1
    pert_end = ref_len - 1
    limit_f, bail2 = p[Q_LIMIT], p[Q_BAIL2]
    s_exp = int(params[Q_SEXP])

    # dc = step * (pixel - size/2 + offset) + shift, in dd
    rows = torch.arange(row0, row0 + height, dtype=i32, device=dev).to(f32)
    cols = torch.arange(width, dtype=i32, device=dev).to(f32)
    half_w = torch.tensor(width * 0.5, dtype=f32, device=dev)
    half_h = torch.tensor(map_height * 0.5, dtype=f32, device=dev)
    nx = ((cols - half_w) + p[Q_OFFX])[None, :].expand(shape).contiguous()
    ny = ((rows - half_h) + p[Q_OFFY])[:, None].expand(shape).contiguous()
    step = (p[Q_PSH], p[Q_PSL])
    dcx = dd.dd_add(dd.dd_mul_float(step, nx), (p[Q_SHIFTXH], p[Q_SHIFTXL]))
    dcy = dd.dd_add(dd.dd_mul_float(step, ny), (p[Q_SHIFTYH], p[Q_SHIFTYL]))
    delta_r, delta_i = dd.dd_to_float(dcx), dd.dd_to_float(dcy)

    # series initial delta d_{n0} = ((C dc + B) dc + A) dc
    if tier == "f32":
        hr, hi = p[Q_CR], p[Q_CI]
        hr, hi = (hr * delta_r - hi * delta_i + p[Q_BR],
                  hr * delta_i + hi * delta_r + p[Q_BI])
        hr, hi = (hr * delta_r - hi * delta_i + p[Q_AR],
                  hr * delta_i + hi * delta_r + p[Q_AI])
        dr = hr * delta_r - hi * delta_i
        di = hr * delta_i + hi * delta_r
        z1r, z1i = dr, di
    else:
        tr, tj = _cmul_dd((p[Q_CR], p[Q_CRL]), (p[Q_CI], p[Q_CIL]), dcx, dcy)
        tr = dd.dd_add(tr, (p[Q_BR], p[Q_BRL]))
        tj = dd.dd_add(tj, (p[Q_BI], p[Q_BIL]))
        tr, tj = _cmul_dd(tr, tj, dcx, dcy)
        tr = dd.dd_add(tr, (p[Q_AR], p[Q_ARL]))
        tj = dd.dd_add(tj, (p[Q_AI], p[Q_AIL]))
        dzr, dzi = _cmul_dd(tr, tj, dcx, dcy)
        if tier == "fx":
            # the Horner value sits at exponent Q_SE0: renormalise
            mag0 = torch.maximum(torch.abs(dzr[0]), torch.abs(dzi[0]))
            zero0 = mag0 == 0.0
            k0 = torch.where(zero0, 0, _expo(mag0))
            f0 = _pow2(-k0)
            dzr, dzi = _scl(dzr, f0), _scl(dzi, f0)
            ex = torch.where(zero0, E_ZERO, torch.clamp(
                k0 + int(params[Q_SE0]), E_ZERO, 1 << 24)).to(i32)
            dfac0 = _pow2(ex)
            z1r = dd.dd_to_float(dzr) * dfac0
            z1i = dd.dd_to_float(dzi) * dfac0
        else:
            z1r, z1i = dd.dd_to_float(dzr), dd.dd_to_float(dzi)
    zfr = ore[n0] + z1r
    zfi = oim[n0] + z1i
    nf = torch.full(shape, float(n0 - 1), dtype=f32, device=dev)
    i = torch.full(shape, n0, dtype=torch.int64, device=dev)
    want = torch.zeros(shape, dtype=torch.bool, device=dev)
    rounds = torch.ones(shape, dtype=i32, device=dev)

    step_no = 0
    while True:
        # a lane that raised want last step starts its next round at once
        restart = want & (rounds < max_passes)
        i = torch.where(restart, 0, i)
        rounds = rounds + restart.to(i32)
        want = want & ~restart
        mag2 = zfr * zfr + zfi * zfi
        alive = (mag2 <= bail2) & (i < pert_end) & ~want & (nf < limit_f)
        if step_no % _EARLY_EXIT_EVERY == 0 and not bool(alive.any()):
            break
        step_no += 1
        nf = nf + alive.to(f32)
        ic, ip = i.clamp(max=last), (i + 1).clamp(max=last)
        zr, zi, zr1, zi1 = ore[ic], oim[ic], ore[ip], oim[ip]
        ends = (i + 1) >= pert_end
        if tier == "f32":
            t1r = 2.0 * (zr * dr - zi * di)
            t1i = 2.0 * (zr * di + zi * dr)
            t2r = dr * dr - di * di
            t2i = (2.0 * dr) * di
            ndr = t1r + t2r + delta_r
            ndi = t1i + t2i + delta_i
            nzfr, nzfi = zr1 + ndr, zi1 + ndi
            zm2 = nzfr * nzfr + nzfi * nzfi
            dm2 = ndr * ndr + ndi * ndi
            want_now = alive & ((zm2 < dm2) | ends) & (nf < limit_f)
            ndr = torch.where(want_now, nzfr, ndr)
            ndi = torch.where(want_now, nzfi, ndi)
            dr = torch.where(alive, ndr, dr)
            di = torch.where(alive, ndi, di)
        else:
            orl, oil = lo
            zrl, zil, zrl1, zil1 = orl[ic], oil[ic], orl[ip], oil[ip]
            z2r = (zr * 2.0, zrl * 2.0)  # 2Z in dd
            z2i = (zi * 2.0, zil * 2.0)
            t1r = dd.dd_sub(dd.dd_mul(dzr, z2r), dd.dd_mul(dzi, z2i))
            t1i = dd.dd_add(dd.dd_mul(dzi, z2r), dd.dd_mul(dzr, z2i))
            sq_r = dd.dd_sub(dd.dd_mul(dzr, dzr), dd.dd_mul(dzi, dzi))
            rz = dd.dd_mul(dzr, dzi)
            sq_i = (rz[0] * 2.0, rz[1] * 2.0)
            if tier == "dd":
                ndr = dd.dd_add(dd.dd_add(t1r, sq_r), dcx)
                ndi = dd.dd_add(dd.dd_add(t1i, sq_i), dcy)
                nzfr = (zr1 + ndr[0]) + (zrl1 + ndr[1])
                nzfi = (zi1 + ndi[0]) + (zil1 + ndi[1])
                zm2 = nzfr * nzfr + nzfi * nzfi
                dm2 = ndr[0] * ndr[0] + ndi[0] * ndi[0]
                want_now = alive & ((zm2 < dm2) | ends) & (nf < limit_f)
                # rebase: d <- Z_{i+1} + d, in dd
                ndr = _select(want_now, dd.dd_add((zr1, zrl1), ndr), ndr)
                ndi = _select(want_now, dd.dd_add((zi1, zil1), ndi), ndi)
            else:
                # the three terms at exponents ex, 2ex and -s aligned to
                # their max by exact powers of two, then renormalised
                e2 = ex + ex
                emax = torch.clamp_min(torch.maximum(ex, e2), -s_exp)
                fA, fB = _pow2(ex - emax), _pow2(e2 - emax)
                nmr = dd.dd_add(_scl(t1r, fA), _scl(sq_r, fB))
                nmi = dd.dd_add(_scl(t1i, fA), _scl(sq_i, fB))
                fC = _pow2(-s_exp - emax)
                nmr = dd.dd_add(nmr, _scl(dcx, fC))
                nmi = dd.dd_add(nmi, _scl(dcy, fC))
                mag = torch.maximum(torch.abs(nmr[0]), torch.abs(nmi[0]))
                zero = mag == 0.0
                k = torch.where(zero, 0, _expo(mag))
                fN = _pow2(-k)
                nmr, nmi = _scl(nmr, fN), _scl(nmi, fN)
                nex = torch.where(zero, E_ZERO,
                                  torch.clamp(emax + k, E_ZERO, 1 << 24))
                # z_full = Z + m 2^ex; Zhuoran test; rebase to exponent 0
                dfac = _pow2(nex)
                nzfr = (zr1 + nmr[0] * dfac) + (zrl1 + nmr[1] * dfac)
                nzfi = (zi1 + nmi[0] * dfac) + (zil1 + nmi[1] * dfac)
                zm2 = nzfr * nzfr + nzfi * nzfi
                dm2 = (nmr[0] * nmr[0] + nmi[0] * nmi[0]) * _pow2(nex + nex)
                want_now = alive & ((zm2 < dm2) | ends) & (nf < limit_f)
                ndr = _select(want_now, dd.dd_add((zr1, zrl1), _scl(nmr, dfac)),
                              nmr)
                ndi = _select(want_now, dd.dd_add((zi1, zil1), _scl(nmi, dfac)),
                              nmi)
                ex = torch.where(alive, torch.where(want_now, 0, nex), ex)
            dzr = _select(alive, ndr, dzr)
            dzi = _select(alive, ndi, dzi)
        zfr = torch.where(alive, nzfr, zfr)
        zfi = torch.where(alive, nzfi, zfi)
        want = want | want_now
        i = i + alive.to(torch.int64)

    lim = torch.tensor(limit, dtype=i32, device=dev)
    n = torch.where(nf >= limit_f, lim, torch.clamp_min(nf, 0.0).to(i32))
    return (n, zfr, zfi, torch.zeros(shape, dtype=f32, device=dev),
            want.to(f32), rounds.to(f32))


def perturbation_fields_cuda(params: np.ndarray, streams: Sequence, *,
                             tier: str, width: int, height: int,
                             map_height: int, max_passes: int,
                             device) -> Tuple[torch.Tensor, ...]:
    """Launch the CUDA kernel K3 on ``device`` (same signature and results
    as perturbation_fields_plain; ``streams`` may be numpy arrays or
    tensors already on the device).  Counts its launches in
    ``perturbation_fields_cuda.launches``."""
    from . import _cuda

    _check_launch(params, streams, tier, width, height, map_height,
                  max_passes)
    dev = _cuda.cuda_device(device)
    params = np.ascontiguousarray(params)
    lib = _cuda.load_library()
    with torch.cuda.device(dev):
        orbit = [s.contiguous() for s in _device_streams(streams, dev)]
        if tier == "f32":  # the lo streams are not read
            orbit += orbit
        shape = (height, width)
        n = torch.empty(shape, dtype=torch.int32, device=dev)
        planes = [torch.empty(shape, dtype=torch.float32, device=dev)
                  for _ in range(4)]  # zx, zy, want, rounds
        glitch = torch.zeros(shape, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fr_perturbation(
            TIERS.index(tier), params.ctypes.data,
            *(o.data_ptr() for o in orbit), width, height, map_height,
            max_passes, n.data_ptr(), *(q.data_ptr() for q in planes),
            stream)
    _cuda.check(lib, rc, "perturbation")
    perturbation_fields_cuda.launches += 1
    zx, zy, want, rounds = planes
    return n, zx, zy, glitch, want, rounds


perturbation_fields_cuda.launches = 0


def perturbation_fields(orbit: np.ndarray, width: int, height: int, *,
                        center_x_dd: DD, center_y_dd: DD,
                        zoom_dd: DD = (0.0, 0.0), max_iter: int,
                        bailout: float = 4.0, glitch_tol: float = 1e-6,
                        ref_shift_x: DD = (0.0, 0.0),
                        ref_shift_y: DD = (0.0, 0.0),
                        offset: Tuple[float, float] = (0.0, 0.0),
                        iter_limit=None, float_continuation: bool = True,
                        series=None, row0=0.0,
                        map_height: Optional[int] = None,
                        dd_delta: bool = False, scaled_delta: bool = False,
                        zoom_frac: Union[str, Fraction, None] = None,
                        ref_shift_x_frac: Union[str, Fraction, None] = None,
                        ref_shift_y_frac: Union[str, Fraction, None] = None,
                        rebase: bool = False, max_passes: int = 256,
                        rebase_inkernel: bool = True, julia: bool = False,
                        julia_z0=None, ship: bool = False,
                        phoenix: bool = False, phoenix_p: float = 0.0,
                        phoenix_r: float = 0.0, aa_spp: int = 1,
                        orbit_exp: Optional[np.ndarray] = None,
                        track_err: bool = False,
                        device="cuda") -> Dict[str, torch.Tensor]:
    """Perturbation fields {"n", "zx", "zy", "glitch", "want", "passes",
    "rounds_plane"} on ``device`` against a precomputed reference orbit
    ((L, 2) float64 from deepzoom.orbit), with the JAX signature.  Runs the
    rebasing Mandelbrot path (``rebase=True, float_continuation=False``);
    ``passes`` is the most rounds any pixel took, ``rounds_plane`` the
    per-pixel rounds."""
    if julia or ship or phoenix:
        raise _unported("the Julia, Burning Ship and Phoenix deep-zoom "
                        "families are", "6(d)")
    if int(aa_spp) > 1:
        raise _unported("stacked spp² AA is", "6(e)")
    if track_err:
        raise _unported("the exact-dust error ledger is", "6(f)")
    if not rebase or float_continuation:
        raise _unported("the non-rebasing path (Pauldelbrot flag, secondary "
                        "references, float continuation) is", "6(g)")
    if not rebase_inkernel:
        raise NotImplementedError("the multi-pass rebase form is the JAX "
                                  "package's oracle and is not ported")
    if orbit_exp is not None:
        raise ValueError("orbit_exp is only valid with julia=True and "
                         "scaled_delta=True (the floatexp drift-table path)")
    params, streams, tier = pack_pert_operands(
        orbit, width, height, center_x_dd=center_x_dd,
        center_y_dd=center_y_dd, zoom_dd=zoom_dd, max_iter=max_iter,
        bailout=bailout, glitch_tol=glitch_tol, ref_shift_x=ref_shift_x,
        ref_shift_y=ref_shift_y, offset=offset, iter_limit=iter_limit,
        series=series, row0=row0, map_height=map_height, dd_delta=dd_delta,
        scaled_delta=scaled_delta, zoom_frac=zoom_frac,
        ref_shift_x_frac=ref_shift_x_frac, ref_shift_y_frac=ref_shift_y_frac)
    dev = torch.device(device)
    if dev.type == "cpu":
        impl = perturbation_fields_plain
    elif dev.type == "cuda":
        impl = perturbation_fields_cuda
    else:
        raise ValueError(f"unsupported device {dev}")
    n, zx, zy, glitch, want, rounds = impl(
        params, streams, tier=tier, width=width, height=height,
        map_height=int(height if map_height is None else map_height),
        max_passes=int(max_passes), device=dev)
    return {"n": n, "zx": zx, "zy": zy, "glitch": glitch, "want": want,
            "passes": rounds.max().to(torch.int32), "rounds_plane": rounds}
