"""Series approximation for perturbation deep zoom.

The reference declared this capability (fractal_state.h:89-90
``use_series_approximation``/``series_order``; skip heuristic sketched in
the unwired mandelbrot_deep_zoom.comp:109-117) but never wired it.  This is
the real thing, in the standard Kalles-Fraktaler form:

δ_n is approximated by a cubic series in δc along the reference orbit:
    δ_n ≈ A_n·δc + B_n·δc² + C_n·δc³
with host-side recurrences (complex doubles, O(L) work):
    A_{n+1} = 2·Z_n·A_n + 1
    B_{n+1} = 2·Z_n·B_n + A_n²
    C_{n+1} = 2·Z_n·C_n + 2·A_n·B_n

``n_skip`` is the largest n where the cubic truncation term stays below
``tol`` of the LINEAR term (|C·δc³| <= tol·|A·δc| — stricter than
relative-to-the-sum, since |A·δc| <= |δ_est|) for the largest |δc| in the
view AND |δ_n| stays small.
With bailout ≥ 4 and |Z_n| ≤ 2 pre-escape, |z| ≤ |Z| + |δ| < bailout, so no
pixel can escape during the skipped iterations — the skip is *exact* with
respect to iteration counts.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction
from typing import Tuple, Union

import numpy as np


@dataclass(frozen=True)
class SeriesSkip:
    n_skip: int                 # orbit index the kernel starts at (>= 1)
    a: complex                  # A_{n_skip}
    b: complex
    c: complex


def compute_series_skip(orbit: np.ndarray, dc_max: float,
                        tol: float = 1e-6,
                        delta_cap: float = 1e-3) -> SeriesSkip:
    """Walk the orbit accumulating A/B/C and return the deepest safe skip.

    ``dc_max``: the largest |δc| over the view (pixel furthest from the
    reference).  Returns n_skip=1 (no skip) when nothing is safe.
    """
    L = len(orbit)
    A, B, C = 0j, 0j, 0j
    best = SeriesSkip(1, 1.0 + 0j, 0j, 0j)
    for n in range(L - 1):
        Z = complex(orbit[n, 0], orbit[n, 1])
        A, B, C = (2.0 * Z * A + 1.0,
                   2.0 * Z * B + A * A,
                   2.0 * Z * C + 2.0 * A * B)
        # series value/terms at the worst-case pixel
        t1 = abs(A) * dc_max
        t2 = abs(B) * dc_max * dc_max
        t3 = abs(C) * dc_max * dc_max * dc_max
        delta_est = t1 + t2 + t3
        if not np.isfinite(delta_est):
            break
        # truncation must be negligible and δ must stay far below bailout
        if t3 > tol * max(t1, 1e-300) or delta_est > delta_cap:
            break
        # n+1 is the orbit index of δ_{n+1}; valid start point
        best = SeriesSkip(n + 1, A, B, C)
    return best


def series_delta_coeffs(skip: SeriesSkip) -> Tuple[float, ...]:
    """Flatten to f32-friendly scalars for the kernel params."""
    return (skip.a.real, skip.a.imag, skip.b.real, skip.b.imag,
            skip.c.real, skip.c.imag, float(skip.n_skip))


# ---------------------------------------------------------------------------
# Floatexp series for the scaled-delta (ARBITRARY) tier
# ---------------------------------------------------------------------------
#
# Past zoom ~1e-30 the coefficients A/B/C themselves overflow/underflow f64
# (A grows roughly like 1/|δc| before the truncation test stops the skip),
# so the host accumulates them as floatexp — complex f64 mantissa + int
# exponent — the same representation the kernel carries per-pixel deltas in.


@dataclass(frozen=True)
class SeriesSkipFX:
    """Cubic series coefficients in floatexp: X = x * 2^x_e."""
    n_skip: int
    a: complex
    a_e: int
    b: complex
    b_e: int
    c: complex
    c_e: int


_FX_ZERO = (0j, 0)


def _fx_norm(m: complex, e: int) -> Tuple[complex, int]:
    """Renormalize so max(|re|,|im|) lands in [0.5, 1)."""
    mag = max(abs(m.real), abs(m.imag))
    if mag == 0.0:
        return _FX_ZERO
    k = math.frexp(mag)[1]  # mag in [2^(k-1), 2^k)
    return complex(math.ldexp(m.real, -k), math.ldexp(m.imag, -k)), e + k


def _fx_cmul(a: Tuple[complex, int], b: Tuple[complex, int]):
    return _fx_norm(a[0] * b[0], a[1] + b[1])


def _fx_add(a: Tuple[complex, int], b: Tuple[complex, int]):
    if a[0] == 0:
        return b
    if b[0] == 0:
        return a
    if a[1] < b[1]:
        a, b = b, a
    d = b[1] - a[1]
    if d < -120:  # below f64 noise next to a — exact enough to drop
        return a
    return _fx_norm(a[0] + complex(math.ldexp(b[0].real, d),
                                   math.ldexp(b[0].imag, d)), a[1])


def _fx_abs(a: Tuple[complex, int]) -> Tuple[float, int]:
    """(magnitude mantissa, exponent); mantissa 0 means zero."""
    return abs(a[0]), a[1]


def _mag_mul(a: Tuple[float, int], b: Tuple[float, int]) -> Tuple[float, int]:
    return a[0] * b[0], a[1] + b[1]


def _mag_add(a: Tuple[float, int], b: Tuple[float, int]) -> Tuple[float, int]:
    if a[0] == 0.0:
        return b
    if b[0] == 0.0:
        return a
    if a[1] < b[1]:
        a, b = b, a
    d = b[1] - a[1]
    return (a[0] + (math.ldexp(b[0], d) if d >= -120 else 0.0), a[1])


def _mag_gt(a: Tuple[float, int], b: Tuple[float, int]) -> bool:
    """a > b for non-negative floatexp magnitudes."""
    if a[0] == 0.0:
        return False
    if b[0] == 0.0:
        return True
    d = a[1] - b[1]
    if d > 120:
        return True
    if d < -120:
        return False
    return math.ldexp(a[0], d) > b[0]


def _mag_from_fraction(fr: Fraction) -> Tuple[float, int]:
    if fr == 0:
        return 0.0, 0
    fr = abs(fr)
    e = fr.numerator.bit_length() - fr.denominator.bit_length()
    m = float(fr * Fraction(2) ** (-e))  # in [0.5, 2)
    if m >= 1.0:
        m, e = m * 0.5, e + 1
    return m, e


def compute_series_skip_fx(orbit: np.ndarray,
                           dc_max: Union[Fraction, str],
                           tol: float = 1e-6,
                           delta_cap: float = 1e-3) -> SeriesSkipFX:
    """Floatexp version of compute_series_skip for the scaled-delta tier,
    where |δc| (and hence the A/B/C dynamic range) is far outside f64.

    ``dc_max`` is exact (Fraction or decimal string) because the zoom
    itself may underflow f64.  The acceptance test is identical to the f64
    version: cubic term below ``tol`` of the linear term at the worst-case
    pixel AND worst-case |δ| below ``delta_cap`` at EVERY prefix step (so
    with bailout >= 4 no pixel can escape inside the skipped range)."""
    dcm = _mag_from_fraction(Fraction(dc_max))
    dcm2 = _mag_mul(dcm, dcm)
    dcm3 = _mag_mul(dcm2, dcm)
    tol_m = _mag_from_fraction(Fraction(tol))
    cap_m = _mag_from_fraction(Fraction(delta_cap))
    L = len(orbit)
    A = B = C = _FX_ZERO
    one = _fx_norm(1.0 + 0j, 0)
    best = SeriesSkipFX(1, 1.0 + 0j, 0, 0j, 0, 0j, 0)
    for n in range(L - 1):
        Z2 = _fx_norm(2.0 * complex(orbit[n, 0], orbit[n, 1]), 0)
        A, B, C = (_fx_add(_fx_cmul(Z2, A), one),
                   _fx_add(_fx_cmul(Z2, B), _fx_cmul(A, A)),
                   _fx_add(_fx_cmul(Z2, C),
                           _fx_cmul(_fx_norm(2.0 + 0j, 0), _fx_cmul(A, B))))
        t1 = _mag_mul(_fx_abs(A), dcm)
        t2 = _mag_mul(_fx_abs(B), dcm2)
        t3 = _mag_mul(_fx_abs(C), dcm3)
        delta_est = _mag_add(_mag_add(t1, t2), t3)
        if _mag_gt(t3, _mag_mul(tol_m, t1)) or _mag_gt(delta_est, cap_m):
            break
        best = SeriesSkipFX(n + 1, A[0], A[1], B[0], B[1], C[0], C[1])
    return best
