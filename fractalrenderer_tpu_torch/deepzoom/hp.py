"""Host-side arbitrary-precision math — replaces the reference's GMP/MPFR
wrapper (src/high_precision_math.h) with integer fixed-point built on Python
bignums (no external libs; the hot loop has a C++ fast path, see orbit.py).

A ``HPFloat`` stores value = mantissa / 2^frac_bits with a Python-int
mantissa, mirroring MPFR's binary significand semantics closely enough for
reference orbits (the only consumer).  Also ports:

- calculate_precision_bits_for_zoom (high_precision_math.h:303-316)
- the ArbitraryFloat decimal mantissa/exponent scalar (deep_zoom_system.h:
  27-54) used by zoom-path animation
- precision-mode thresholds (deep_zoom_system.cpp:226-249)
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from fractions import Fraction
from typing import Tuple, Union

Number = Union[int, float, str, "HPFloat"]


class PrecisionMode(enum.Enum):
    """deep_zoom_system.h:18-22."""

    DOUBLE = 0
    QUAD = 1
    ARBITRARY = 2


def calculate_precision_bits_for_zoom(zoom: float) -> int:
    """high_precision_math.h:303-316: 64 bits above 1e-14, else
    64 + digits*3.32 + 64, clamped to [128, 4096]."""
    z = abs(zoom)
    if z == 0.0:
        return 4096  # below double range entirely — deepest setting
    if z >= 1e-14:
        return 64
    digits_needed = -math.log10(z)
    bits = 64 + int(digits_needed * 3.32) + 64
    return max(128, min(bits, 4096))


def precision_mode_for_zoom(zoom: float) -> Tuple[PrecisionMode, int]:
    """deep_zoom_system.cpp:226-249 thresholds (1e-14 / 1e-30)."""
    z = abs(zoom)
    if z == 0.0:
        return PrecisionMode.ARBITRARY, 4096
    if z > 1e-14:
        return PrecisionMode.DOUBLE, 64
    if z > 1e-30:
        # the bits formula's 64-bit shortcut uses z >= 1e-14 while the
        # mode threshold is strict, so exactly 1e-14 would pair QUAD with
        # 64 bits (an orbit quantum coarser than a 1080p pixel step) —
        # floor the QUAD tier at the formula's documented 128 minimum
        return PrecisionMode.QUAD, max(
            128, calculate_precision_bits_for_zoom(z))
    return PrecisionMode.ARBITRARY, calculate_precision_bits_for_zoom(z)


def precision_mode_for_zoom_frac(fr: Fraction) -> Tuple[PrecisionMode, int]:
    """Exact-rational precision selection — extends the reference's formula
    past f64's exponent range (its 4096-bit cap topped out near 1e-1150;
    the floatexp kernel tier has no such floor, so neither should the host
    orbit).  Uncapped above: bits = 64 + digits*3.32 + 64, clamped to
    [128, 1<<20]."""
    if fr == 0:
        return PrecisionMode.ARBITRARY, 4096
    z = abs(float(fr))
    if z > 0.0:  # within f64 range: defer to the reference formula
        return precision_mode_for_zoom(z)
    digits = (abs(fr.denominator).bit_length()
              - abs(fr.numerator).bit_length()) * 0.30103
    bits = int(64 + digits * 3.32 + 64)
    return PrecisionMode.ARBITRARY, max(128, min(bits, 1 << 20))


class HPFloat:
    """Fixed-point arbitrary precision: value = man / 2^bits."""

    __slots__ = ("man", "bits")

    def __init__(self, value: Number = 0.0, bits: int = 128):
        self.bits = int(bits)
        if isinstance(value, HPFloat):
            self.man = value.man << (self.bits - value.bits) \
                if self.bits >= value.bits else value.man >> (value.bits - self.bits)
        elif isinstance(value, Fraction):
            self.man = round(value * (1 << self.bits))
        elif isinstance(value, str):
            frac = Fraction(value.strip())
            self.man = round(frac * (1 << self.bits))
        elif isinstance(value, int):
            self.man = value << self.bits
        else:
            f = Fraction(float(value))
            self.man = round(f * (1 << self.bits))

    @staticmethod
    def _raw(man: int, bits: int) -> "HPFloat":
        h = HPFloat.__new__(HPFloat)
        h.man = man
        h.bits = bits
        return h

    # -- arithmetic ------------------------------------------------------
    def __add__(self, other):
        o = other if isinstance(other, HPFloat) else HPFloat(other, self.bits)
        if o.bits != self.bits:
            o = HPFloat(o, self.bits)
        return HPFloat._raw(self.man + o.man, self.bits)

    def __sub__(self, other):
        o = other if isinstance(other, HPFloat) else HPFloat(other, self.bits)
        if o.bits != self.bits:
            o = HPFloat(o, self.bits)
        return HPFloat._raw(self.man - o.man, self.bits)

    def __mul__(self, other):
        o = other if isinstance(other, HPFloat) else HPFloat(other, self.bits)
        if o.bits != self.bits:
            o = HPFloat(o, self.bits)
        return HPFloat._raw((self.man * o.man) >> self.bits, self.bits)

    def __truediv__(self, other):
        o = other if isinstance(other, HPFloat) else HPFloat(other, self.bits)
        if o.bits != self.bits:
            o = HPFloat(o, self.bits)
        if o.man == 0:
            raise ZeroDivisionError
        return HPFloat._raw((self.man << self.bits) // o.man, self.bits)

    def __neg__(self):
        return HPFloat._raw(-self.man, self.bits)

    def __abs__(self):
        return HPFloat._raw(abs(self.man), self.bits)

    # -- comparisons ------------------------------------------------------
    def _cmp_man(self, other) -> Tuple[int, int]:
        o = other if isinstance(other, HPFloat) else HPFloat(other, self.bits)
        if o.bits != self.bits:
            o = HPFloat(o, self.bits)
        return self.man, o.man

    def __lt__(self, other):
        a, b = self._cmp_man(other)
        return a < b

    def __le__(self, other):
        a, b = self._cmp_man(other)
        return a <= b

    def __gt__(self, other):
        a, b = self._cmp_man(other)
        return a > b

    def __ge__(self, other):
        a, b = self._cmp_man(other)
        return a >= b

    def __eq__(self, other):
        try:
            a, b = self._cmp_man(other)
        except (TypeError, ValueError):
            return NotImplemented
        return a == b

    def __hash__(self):
        return hash((self.man, self.bits))

    # -- conversions ------------------------------------------------------
    def to_double(self) -> float:
        if self.man == 0:
            return 0.0
        sign = -1.0 if self.man < 0 else 1.0
        m = abs(self.man)
        nb = m.bit_length()
        # Take the top 53 bits for a correctly-truncated double.
        shift = nb - 53
        if shift > 0:
            top = m >> shift
            return sign * math.ldexp(top, shift - self.bits)
        return sign * math.ldexp(m, -self.bits)

    def to_string(self, digits: int = 30) -> str:
        """Decimal formatting (high_precision_math.h:319-325)."""
        sign = "-" if self.man < 0 else ""
        m = abs(self.man)
        ip = m >> self.bits
        fp = m - (ip << self.bits)
        dec = (fp * 10 ** digits) >> self.bits
        return f"{sign}{ip}.{str(dec).zfill(digits)}"

    def __repr__(self):
        return f"HPFloat({self.to_string(24)}, bits={self.bits})"


class HPComplex:
    """high_precision_math.h:195-296."""

    __slots__ = ("real", "imag")

    def __init__(self, real: Number = 0.0, imag: Number = 0.0,
                 bits: int = 128):
        self.real = real if isinstance(real, HPFloat) else HPFloat(real, bits)
        self.imag = imag if isinstance(imag, HPFloat) else HPFloat(imag, bits)

    def square(self) -> "HPComplex":
        r = self.real * self.real - self.imag * self.imag
        i = (self.real * self.imag)
        i = HPFloat._raw(i.man << 1, i.bits)
        return HPComplex(r, i)

    def __add__(self, other: "HPComplex") -> "HPComplex":
        return HPComplex(self.real + other.real, self.imag + other.imag)

    def magnitude_squared(self) -> HPFloat:
        return self.real * self.real + self.imag * self.imag

    def to_complex(self) -> complex:
        return complex(self.real.to_double(), self.imag.to_double())


@dataclass
class ArbitraryFloat:
    """Decimal mantissa/exponent scalar (deep_zoom_system.h:27-54) — used by
    zoom-path animation where only ~15 digits matter."""

    mantissa: float = 0.0
    exponent: int = 0

    @staticmethod
    def from_double(value: float) -> "ArbitraryFloat":
        if value == 0.0:
            return ArbitraryFloat(0.0, 0)
        e = int(math.floor(math.log10(abs(value))))
        a = ArbitraryFloat(value / 10.0 ** e, e)
        a.normalize()
        return a

    def normalize(self):
        if self.mantissa == 0.0:
            self.exponent = 0
            return
        while abs(self.mantissa) >= 10.0:
            self.mantissa /= 10.0
            self.exponent += 1
        while abs(self.mantissa) < 1.0 and self.mantissa != 0.0:
            self.mantissa *= 10.0
            self.exponent -= 1

    def to_double(self) -> float:
        return self.mantissa * 10.0 ** self.exponent

    def __mul__(self, other: "ArbitraryFloat") -> "ArbitraryFloat":
        r = ArbitraryFloat(self.mantissa * other.mantissa,
                           self.exponent + other.exponent)
        r.normalize()
        return r
