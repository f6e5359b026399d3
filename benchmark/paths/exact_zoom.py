"""A deep zoom from ``zoom_from`` to ``zoom_to`` in ``frames`` geometric
steps about the configuration's centre, the frames of ``zoom-path`` at
any depth: every zoom and centre is an exact decimal string, and no
number of the path passes through a double, so frames past the f64
floor (a zoom below 4.9e-324 reads 0 as a double) are stated as they
are.

Frame f's zoom is zoom_from·(zoom_to/zoom_from)^(f/(frames-1)) rounded
to ``DIGITS`` significant decimal digits; the first and last frames are
``zoom_from`` and ``zoom_to`` themselves.  The seed moves the centre by
up to ``seed.jitter`` of the deepest view (4·zoom/height) in each axis,
the offset rounded once to ``DIGITS`` digits; the centre keeps every
digit of it."""
from __future__ import annotations

from decimal import Decimal, Inexact, localcontext
from typing import Dict, List

DIGITS = 34  # significant digits of a frame's zoom


def _exact_sum(a: Decimal, b: Decimal) -> str:
    """a + b with every digit of both kept, written out in full."""
    with localcontext() as ctx:
        ctx.prec = max(a.adjusted(), b.adjusted()) - min(
            a.as_tuple().exponent, b.as_tuple().exponent) + 2
        ctx.traps[Inexact] = True
        return format(a + b, "f")


def zooms(t: dict) -> List[str]:
    """The pass's zooms as decimal strings, frame by frame."""
    n = int(t["frames"])
    with localcontext() as ctx:
        ctx.prec = DIGITS
        z0, z1 = Decimal(t["zoom_from"]), Decimal(t["zoom_to"])
        out = [t["zoom_from"]]
        for f in range(1, n - 1):
            with localcontext() as wide:
                wide.prec = DIGITS + 20
                z = z0 * (z1 / z0) ** (Decimal(f) / Decimal(n - 1))
            out.append(str(+z))  # rounded to DIGITS
        out.append(t["zoom_to"])
    return out


def frames(t: dict, config: dict, rng) -> List[Dict]:
    zs = zooms(t)
    h = int(config["export_height"])
    with localcontext() as ctx:
        ctx.prec = DIGITS
        deepest = min(Decimal(z) for z in zs)
        jit = Decimal(str(t["seed"]["jitter"])) * 4 * deepest / h
        # a draw enters as its exact binary value, the offset rounded once
        dx = jit * Decimal(float(rng.uniform(-1.0, 1.0)))
        dy = jit * Decimal(float(rng.uniform(-1.0, 1.0)))
    cx = _exact_sum(Decimal(config["center_x"]), dx)
    cy = _exact_sum(Decimal(config["center_y"]), dy)
    return [{"hp_center_x": cx, "hp_center_y": cy, "hp_zoom": z,
             "max_iterations": int(config["max_iterations"])}
            for z in zs]
