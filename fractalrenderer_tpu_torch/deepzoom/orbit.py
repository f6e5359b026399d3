"""Reference-orbit computation (z <- z^2 + c at arbitrary precision).

Port of DeepZoomManager::compute_reference_orbit (deep_zoom_system.cpp:
363-448 double path, :262-361 MPFR path).  The orbit is a host-side scalar
loop — O(max_iter) bigint work shared by every pixel — so it runs natively:
a C++ fixed-point engine (native/orbit.cpp, built on demand, loaded via
ctypes) with a pure-Python bignum fallback.

Semantics (matching the reference):
- store z BEFORE each update; check escape on the stored z; the escaped z is
  the final stored entry (deep_zoom_system.cpp:294-319).
- double path escapes at |z| > 2; HP path at |z|^2 > 4 — identical; we use
  mag^2 > 4 everywhere.
"""
from __future__ import annotations

import ctypes
from fractions import Fraction
from typing import Optional, Tuple, Union

import numpy as np

from .hp import HPFloat

# Optional progress hook for long orbit computations, called as
# hook(done_iterations, max_iter) — the reference prints orbit progress
# every 5% (deep_zoom_system.cpp:313-318).  The CLI installs a stderr
# printer around deep-zoom renders; both engines report through it (the
# native loop via a ctypes callback every 8192 iterations, the Python
# engine every 5%).
progress_hook = None

_PROGRESS_CFUNC = ctypes.CFUNCTYPE(None, ctypes.c_long, ctypes.c_long)


def _load_native() -> Optional[ctypes.CDLL]:
    """Load the native orbit library via utils/native_build; None on
    failure (callers fall back to the pure-Python bignum engine)."""
    from ..utils.native_build import load_native_lib

    def configure(lib):
        u64p = ctypes.POINTER(ctypes.c_uint64)
        f64p = ctypes.POINTER(ctypes.c_double)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.orbit_compute_kind2.restype = ctypes.c_long
        lib.orbit_compute_kind2.argtypes = [
            u64p, ctypes.c_int, u64p, ctypes.c_int,
            u64p, ctypes.c_int, u64p, ctypes.c_int,
            u64p, ctypes.c_int, u64p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_double,
            f64p, f64p, ctypes.c_int, ctypes.c_int,
        ]
        lib.orbit_compute_kind2_fx.restype = ctypes.c_long
        lib.orbit_compute_kind2_fx.argtypes = [
            u64p, ctypes.c_int, u64p, ctypes.c_int,
            u64p, ctypes.c_int, u64p, ctypes.c_int,
            u64p, ctypes.c_int, u64p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_double,
            f64p, f64p, i32p, i32p, ctypes.c_int, ctypes.c_int,
        ]
        # present in rebuilt libs; older .so files simply lack the symbol
        if hasattr(lib, "orbit_set_progress"):
            lib.orbit_set_progress.restype = None
            lib.orbit_set_progress.argtypes = [_PROGRESS_CFUNC]

    return load_native_lib("liborbit", configure)


def _to_limbs(value: Union[str, float, HPFloat], frac_bits: int,
              n_limbs: int) -> Tuple[np.ndarray, int]:
    if isinstance(value, HPFloat):
        man = value.man << (frac_bits - value.bits) if frac_bits >= value.bits \
            else value.man >> (value.bits - frac_bits)
    else:
        frac = Fraction(value if isinstance(value, str) else float(value))
        man = round(frac * (1 << frac_bits))
    sign = -1 if man < 0 else (1 if man > 0 else 0)
    man = abs(man)
    limbs = np.zeros(n_limbs, np.uint64)
    for i in range(n_limbs):
        limbs[i] = man & 0xFFFFFFFFFFFFFFFF
        man >>= 64
    if man:
        raise OverflowError("coordinate magnitude exceeds fixed-point range")
    return limbs, sign


def fx_from_man(man: int, frac_bits: int):
    """Mirror native/orbit.cpp to_double_fx exactly: frexp-style
    (mantissa, exponent) with |mantissa| in [0.5, 1) summed from the
    top three limbs BIT-aligned to the magnitude's leading bit, so
    drift values beyond f64's range keep full relative precision."""
    import math
    if man == 0:
        return 0.0, 0
    sign = -1.0 if man < 0 else 1.0
    m = abs(man)
    magbits = m.bit_length()
    n = (magbits + 63) // 64
    top_bits = magbits - (n - 1) * 64
    mask = 0xFFFFFFFFFFFFFFFF
    d = math.ldexp((m >> ((n - 1) * 64)) & mask, -top_bits)
    if n >= 2:
        d += math.ldexp((m >> ((n - 2) * 64)) & mask, -top_bits - 64)
    if n >= 3:
        d += math.ldexp((m >> ((n - 3) * 64)) & mask, -top_bits - 128)
    e = magbits - frac_bits
    if d == 1.0:  # top 54+ bits all ones round up; keep |m| in [0.5,1)
        d, e = 0.5, e + 1
    return sign * d, e


def compute_orbit_python(cx: Union[str, float, HPFloat],
                         cy: Union[str, float, HPFloat],
                         precision_bits: int, max_iter: int,
                         escape_mag_sq: float = 4.0,
                         z0x: Union[str, float, HPFloat, None] = None,
                         z0y: Union[str, float, HPFloat, None] = None,
                         emit_rel: bool = False,
                         kind: int = 0, pp: float = 0.0,
                         rr: float = 0.0, emit_fx: bool = False):
    """Pure-Python bignum fallback — bit-identical to the native path: each
    product is truncated toward zero after the fixed-point shift (Python's
    ``>>`` floors negatives toward -inf, so the cross term shifts the
    magnitude and reapplies the sign, and the doubling happens after the
    shift, exactly like native/orbit.cpp mul_shift)."""
    bits = precision_bits
    one = 1 << bits

    def to_man(v):
        if isinstance(v, HPFloat):
            return v.man << (bits - v.bits) if bits >= v.bits \
                else v.man >> (v.bits - bits)
        return round(Fraction(v if isinstance(v, str) else float(v)) * one)

    cxm, cym = to_man(cx), to_man(cy)
    zr = to_man(z0x) if z0x is not None else 0
    zi = to_man(z0y) if z0y is not None else 0
    z0r, z0i = zr, zi
    ppm, rrm = to_man(float(pp)), to_man(float(rr))
    przr = przi = 0  # phoenix z_{n-1}
    out = np.empty((max_iter, 2), np.float64)
    exps = np.zeros((max_iter, 2), np.int32) if emit_fx else None
    stored = 0
    import math

    def to_f64(man: int) -> float:
        # Mirror native/orbit.cpp to_double exactly: sum the top three
        # 64-bit limbs as ldexp'd doubles (limb-aligned, not bit-aligned).
        if man == 0:
            return 0.0
        sign = -1.0 if man < 0 else 1.0
        m = abs(man)
        n = (m.bit_length() + 63) // 64  # limbs after trimming zeros
        exp_msl = (n - 1) * 64 - bits
        mask = 0xFFFFFFFFFFFFFFFF
        d = math.ldexp((m >> ((n - 1) * 64)) & mask, exp_msl)
        if n >= 2:
            d += math.ldexp((m >> ((n - 2) * 64)) & mask, exp_msl - 64)
        if n >= 3:
            d += math.ldexp((m >> ((n - 3) * 64)) & mask, exp_msl - 128)
        return sign * d

    def to_fx(man: int):
        return fx_from_man(man, bits)

    hook = progress_hook
    prog_step = max(1, max_iter // 20)  # every 5%, like the reference
    for i in range(max_iter):
        if hook is not None and i and i % prog_step == 0:
            hook(i, max_iter)
        dre = to_f64(zr)
        dim = to_f64(zi)
        if emit_fx:
            mre, mim = (zr - z0r, zi - z0i) if emit_rel else (zr, zi)
            out[i, 0], exps[i, 0] = to_fx(mre)
            out[i, 1], exps[i, 1] = to_fx(mim)
        elif emit_rel:
            out[i] = (to_f64(zr - z0r), to_f64(zi - z0i))
        else:
            out[i] = (dre, dim)
        stored = i + 1
        mag2 = dre * dre + dim * dim
        if mag2 > escape_mag_sq or not np.isfinite(mag2):
            break
        t = zr * zi
        t = (t >> bits) if t >= 0 else -((-t) >> bits)
        if kind == 1:  # burning ship: y' = 2|x*y| + cy
            t = abs(t)
        nzr = ((zr * zr) >> bits) - ((zi * zi) >> bits) + cxm
        nzi = (t << 1) + cym
        if kind == 2:  # phoenix: + p*z_n + r*z_{n-1} (truncating products)
            def tm(a, b):
                v = a * b
                return (v >> bits) if v >= 0 else -((-v) >> bits)
            nzr += tm(ppm, zr) + tm(rrm, przr)
            nzi += tm(ppm, zi) + tm(rrm, przi)
            przr, przi = zr, zi
        zr, zi = nzr, nzi
    if emit_fx:
        return out[:stored], exps[:stored]
    return out[:stored]


def compute_orbit(cx: Union[str, float, HPFloat],
                  cy: Union[str, float, HPFloat],
                  precision_bits: int, max_iter: int,
                  escape_mag_sq: float = 4.0,
                  force_python: bool = False,
                  z0x: Union[str, float, HPFloat, None] = None,
                  z0y: Union[str, float, HPFloat, None] = None,
                  emit_rel: bool = False, kind: int = 0,
                  pp: float = 0.0, rr: float = 0.0,
                  emit_fx: bool = False):
    """Returns an (L, 2) float64 array of the orbit z <- z^2 + c from z0
    (default 0 — the Mandelbrot critical orbit; Julia references pass the
    view center), trimmed at escape (L <= max_iter).

    ``emit_rel=True`` emits the DRIFT D_i = z_i - z0 instead of z_i,
    computed in fixed point so tiny drifts near a periodic start survive
    the f64 conversion (deep-Julia kernels reconstruct Z = Z0 + D).
    ``emit_fx=True`` returns a pair (mantissas (L, 2) f64, exponents
    (L, 2) i32) with each entry = m * 2^e and |m| in [0.5, 1) — full
    53-bit relative precision at ANY magnitude, where the plain f64
    emission flushes drifts below ~1e-308 to subnormals/zero (this is
    what floored the deep-zoom julia tier at ~1e-290).
    ``kind``: 0 = z^2+c; 1 = Burning Ship ((|x|+i|y|)^2 + c);
    2 = Phoenix (z^2 + c + pp*z_n + rr*z_{n-1}, carried z_{n-1})."""
    precision_bits = max(64, int(precision_bits))
    lib = None if force_python else _load_native()
    if lib is None:
        return compute_orbit_python(cx, cy, precision_bits, max_iter,
                                    escape_mag_sq, z0x=z0x, z0y=z0y,
                                    emit_rel=emit_rel, kind=kind,
                                    pp=pp, rr=rr, emit_fx=emit_fx)
    # 8 integer bits of headroom (|z| <= 2 pre-escape, c within ±2)
    frac_bits = precision_bits
    n_limbs = (frac_bits + 8 + 63) // 64
    cx_l, sx = _to_limbs(cx, frac_bits, n_limbs)
    cy_l, sy = _to_limbs(cy, frac_bits, n_limbs)
    zx_l, szx = _to_limbs(z0x if z0x is not None else 0.0, frac_bits,
                          n_limbs)
    zy_l, szy = _to_limbs(z0y if z0y is not None else 0.0, frac_bits,
                          n_limbs)
    # The one exact float→fixed conversion for the Phoenix coefficients
    # happens here (Fraction-based, same as the Python engine's to_man),
    # so both engines iterate identical fixed-point values.
    pp_l, spp = _to_limbs(float(pp), frac_bits, n_limbs)
    rr_l, srr = _to_limbs(float(rr), frac_bits, n_limbs)
    out_re = np.empty(max_iter, np.float64)
    out_im = np.empty(max_iter, np.float64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    f64p = ctypes.POINTER(ctypes.c_double)
    hook = progress_hook
    cb = None
    if hook is not None and hasattr(lib, "orbit_set_progress"):
        # keep a reference for the duration of the call; cleared after so
        # a stale hook can never outlive its CLI context
        cb = _PROGRESS_CFUNC(lambda d, t: hook(int(d), int(t)))
        lib.orbit_set_progress(cb)
    try:
        if emit_fx:
            i32p = ctypes.POINTER(ctypes.c_int32)
            exp_re = np.zeros(max_iter, np.int32)
            exp_im = np.zeros(max_iter, np.int32)
            n = lib.orbit_compute_kind2_fx(
                cx_l.ctypes.data_as(u64p), sx, cy_l.ctypes.data_as(u64p),
                sy, zx_l.ctypes.data_as(u64p), szx,
                zy_l.ctypes.data_as(u64p), szy,
                pp_l.ctypes.data_as(u64p), spp,
                rr_l.ctypes.data_as(u64p), srr,
                n_limbs, frac_bits, max_iter, escape_mag_sq,
                out_re.ctypes.data_as(f64p), out_im.ctypes.data_as(f64p),
                exp_re.ctypes.data_as(i32p), exp_im.ctypes.data_as(i32p),
                1 if emit_rel else 0, int(kind))
            return (np.stack([out_re[:n], out_im[:n]], axis=1),
                    np.stack([exp_re[:n], exp_im[:n]], axis=1))
        n = lib.orbit_compute_kind2(
            cx_l.ctypes.data_as(u64p), sx, cy_l.ctypes.data_as(u64p), sy,
            zx_l.ctypes.data_as(u64p), szx, zy_l.ctypes.data_as(u64p), szy,
            pp_l.ctypes.data_as(u64p), spp, rr_l.ctypes.data_as(u64p), srr,
            n_limbs, frac_bits, max_iter, escape_mag_sq,
            out_re.ctypes.data_as(f64p), out_im.ctypes.data_as(f64p),
            1 if emit_rel else 0, int(kind))
        return np.stack([out_re[:n], out_im[:n]], axis=1)
    finally:
        if cb is not None:
            lib.orbit_set_progress(_PROGRESS_CFUNC())  # NULL fn pointer
