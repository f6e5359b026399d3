"""Double-double (two-float32) arithmetic (the port's counterpart of
``fractalrenderer_tpu/ops/dd.py``).

Coordinates past f32 precision are carried as unevaluated (hi, lo) f32
pairs (test_deep_zoom.comp:20-51), giving ~48 bits of mantissa.  The CUDA
kernels (csrc/dd.cuh, shared by dd_escape.cu and perturbation.cu) take the
product error term from one exact fmaf, err = fmaf(a, b, -p); ``two_prod``
here computes the same number with no fused operation: a * b in f64 is
exact (24 + 24 bits <= 53), subtracting f64(p) is exact, and the one
rounding to f32 is the fmaf's.  Wherever neither the product nor its
exact error is subnormal, that equals the JAX package's Dekker/Veltkamp error (its TPU
kernel has no f32 FMA); in the subnormal zone it is the correctly rounded
error, where XLA:CPU flushes.  ``split`` (Veltkamp) stays for the tests
that hold it against the JAX package's.

The tensor functions take f32 tensors (or 0-dim f32 tensors); nothing here
may be reassociated.  The host-side converters (``dd_from_*``) are
framework-free copies of the JAX package's.
"""
from __future__ import annotations

import math
from fractions import Fraction
from typing import Tuple

import numpy as np

# Veltkamp split constant for f32: 2^12 + 1
SPLIT = 4097.0


def two_sum(a, b):
    """Knuth two-sum: a + b = s + err exactly (|err| <= ulp(s)/2)."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def split(a):
    """Veltkamp split of an f32 into 12+12-bit halves (hi + lo == a)."""
    c = SPLIT * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """a * b = p + err exactly: err is fmaf(a, b, -p), computed as
    f32(f64(a) * f64(b) - f64(p)) (both f64 operations exact)."""
    p = a * b
    err = (a.double() * b.double() - p.double()).float()
    return p, err


def dd_add(a, b):
    """(a_hi,a_lo) + (b_hi,b_lo) — dd_add_dd (test_deep_zoom.comp:30-38)."""
    ah, al = a
    bh, bl = b
    s = ah + bh
    v = s - ah
    t = ((bh - v) + (ah - (s - v))) + (al + bl)
    hi = s + t
    lo = t - (hi - s)
    return hi, lo


def dd_add_float(a, b):
    """dd + f32 — dd_add_sf (test_deep_zoom.comp:20-28)."""
    ah, al = a
    t1 = ah + b
    e = t1 - ah
    t2 = ((b - e) + (ah - (t1 - e))) + al
    hi = t1 + t2
    lo = t2 - (hi - t1)
    return hi, lo


def dd_mul_float(a, b):
    """dd * f32 — dd_mul_sf (test_deep_zoom.comp:40-47) with the exact
    two-prod error term."""
    ah, al = a
    p, e = two_prod(ah, b)
    lo = al * b + e
    hi = p + lo
    lo = lo - (hi - p)
    return hi, lo


def dd_mul(a, b):
    """dd * dd (full product)."""
    ah, al = a
    bh, bl = b
    p, e = two_prod(ah, bh)
    e = e + (ah * bl + al * bh)
    hi = p + e
    lo = e - (hi - p)
    return hi, lo


def dd_neg(a):
    return -a[0], -a[1]


def dd_sub(a, b):
    return dd_add(a, dd_neg(b))


def dd_to_float(a):
    """A dd pair as one f32: hi + lo, rounded once."""
    return a[0] + a[1]


def ddc_square_add(zr, zi, cr, ci):
    """(zr + i zi)^2 + (cr + i ci) with every component a dd pair."""
    zr2 = dd_mul(zr, zr)
    zi2 = dd_mul(zi, zi)
    zrzi = dd_mul(zr, zi)
    new_r = dd_add(dd_sub(zr2, zi2), cr)
    two_zrzi = (zrzi[0] * 2.0, zrzi[1] * 2.0)  # exact scale by 2
    new_i = dd_add(two_zrzi, ci)
    return new_r, new_i


def ddc_mag2(zr, zi):
    """|z|^2 as a plain f32 (enough for escape tests)."""
    return (zr[0] * zr[0] + zi[0] * zi[0]
            + 2.0 * (zr[0] * zr[1] + zi[0] * zi[1]))


# ---------------------------------------------------------------------------
# Host-side conversions to (hi, lo) f32 pairs
# ---------------------------------------------------------------------------

def _f32_round_fraction(frac) -> float:
    """Correctly-rounded (half-even) f32 of an exact Fraction, straight from
    the rational (going through a double first can round twice)."""
    frac = Fraction(frac)
    if frac == 0:
        return 0.0
    sign = -1.0 if frac < 0 else 1.0
    m = abs(frac)
    k = m.numerator.bit_length() - m.denominator.bit_length()
    e = k if m >= Fraction(2) ** k else k - 1  # 2^e <= m < 2^(e+1)
    if e > 128:
        return float(np.float32(sign * np.inf))
    shift = (23 - e) if e >= -126 else 149  # subnormal grid at 2^-149
    scaled = m * (1 << shift) if shift >= 0 else m / (1 << -shift)
    n = scaled.numerator // scaled.denominator
    rem2 = 2 * (scaled - n)
    if rem2 > 1 or (rem2 == 1 and n % 2 == 1):
        n += 1
    # n <= 2^24, exactly representable in f64; scaling by a power of two
    # onto the f32 grid converts exactly
    return float(np.float32(sign * np.ldexp(np.float64(n), -shift)))


def dd_from_fraction(frac) -> Tuple[float, float]:
    """Exact rational → (hi, lo): hi the correctly-rounded f32 of the
    value, lo the correctly-rounded f32 of the exact residual."""
    frac = Fraction(frac)
    hi = _f32_round_fraction(frac)
    if not math.isfinite(hi):
        return hi, 0.0
    lo = _f32_round_fraction(frac - Fraction(hi))
    return hi, lo


def dd_from_double(v: float) -> Tuple[float, float]:
    """Split a Python double into f32 (hi, lo) (compute_effect_manager.h:
    247-261); v - hi is exact in f64, so this equals
    dd_from_fraction(Fraction(v))."""
    hi = np.float32(v)
    lo = np.float32(v - float(hi))
    return float(hi), float(lo)


def dd_from_string(s: str) -> Tuple[float, float]:
    """Decimal string → (hi, lo) with correct double-double rounding."""
    return dd_from_fraction(Fraction(s))
