"""Plain high-precision Mandelbrot reference orbit and the exact host
conversions of the deep-zoom launch.

Frozen copies, at commit f3d0ace5ea09, of ``fractalrenderer_tpu_torch/
deepzoom/orbit.py`` (``compute_orbit_python``'s kind-0 recurrence in Python
integers: fixed point with ``bits`` fraction bits, each product truncated
toward zero after the shift, the stored value converted from the top
three 64-bit limbs), ``deepzoom/hp.py`` (``precision_mode_for_zoom``'s
bits), and ``ops/dd.py`` (``dd_from_fraction``: correctly rounded f32
pairs of an exact rational).  No native code and nothing of the program.
"""
from __future__ import annotations

import math
from fractions import Fraction
from typing import Tuple

import numpy as np


def orbit_bits(zoom: Fraction) -> int:
    """The orbit's fraction bits at ``zoom`` (the DOUBLE and QUAD tiers of
    precision_mode_for_zoom, bucketed up to a multiple of 64)."""
    z = abs(float(zoom))
    if z > 1e-14:
        bits = 64
    elif z > 1e-30:
        bits = max(128, max(128, min(64 + int(-math.log10(z) * 3.32) + 64,
                                     4096)))
    else:
        raise ValueError("the floatexp tier's zooms are not covered")
    return -(-bits // 64) * 64


def _to_f64(man: int, bits: int) -> float:
    if man == 0:
        return 0.0
    sign = -1.0 if man < 0 else 1.0
    m = abs(man)
    n = (m.bit_length() + 63) // 64
    exp_msl = (n - 1) * 64 - bits
    mask = 0xFFFFFFFFFFFFFFFF
    d = math.ldexp((m >> ((n - 1) * 64)) & mask, exp_msl)
    if n >= 2:
        d += math.ldexp((m >> ((n - 2) * 64)) & mask, exp_msl - 64)
    if n >= 3:
        d += math.ldexp((m >> ((n - 3) * 64)) & mask, exp_msl - 128)
    return sign * d


def to_man(v: Fraction, bits: int) -> int:
    return round(Fraction(v) * (1 << bits))


def orbit(cxm: int, cym: int, bits: int, max_len: int,
          escape_mag_sq: float = 4.0) -> np.ndarray:
    """z <- z^2 + c from 0 with c = (cxm, cym) / 2^bits: the (L, 2) f64
    orbit, each z stored before its update, trimmed after the first stored
    z with |z|^2 > escape_mag_sq (L <= max_len)."""
    zr = zi = 0
    out = np.empty((max_len, 2), np.float64)
    stored = 0
    for i in range(max_len):
        dre, dim = _to_f64(zr, bits), _to_f64(zi, bits)
        out[i] = (dre, dim)
        stored = i + 1
        mag2 = dre * dre + dim * dim
        if mag2 > escape_mag_sq or not np.isfinite(mag2):
            break
        t = zr * zi
        t = (t >> bits) if t >= 0 else -((-t) >> bits)
        nzr = ((zr * zr) >> bits) - ((zi * zi) >> bits) + cxm
        zi = (t << 1) + cym
        zr = nzr
    return out[:stored]


def _f32_round_fraction(frac) -> float:
    frac = Fraction(frac)
    if frac == 0:
        return 0.0
    sign = -1.0 if frac < 0 else 1.0
    m = abs(frac)
    k = m.numerator.bit_length() - m.denominator.bit_length()
    e = k if m >= Fraction(2) ** k else k - 1
    if e > 128:
        return float(np.float32(sign * np.inf))
    shift = (23 - e) if e >= -126 else 149
    scaled = m * (1 << shift) if shift >= 0 else m / (1 << -shift)
    n = scaled.numerator // scaled.denominator
    rem2 = 2 * (scaled - n)
    if rem2 > 1 or (rem2 == 1 and n % 2 == 1):
        n += 1
    return float(np.float32(sign * np.ldexp(np.float64(n), -shift)))


def dd_from_fraction(frac) -> Tuple[float, float]:
    frac = Fraction(frac)
    hi = _f32_round_fraction(frac)
    if not math.isfinite(hi):
        return hi, 0.0
    return hi, _f32_round_fraction(frac - Fraction(hi))
