"""A deep zoom from ``zoom_from`` to ``zoom_to`` in ``frames`` geometric
steps about the configuration's centre, the frames of ``zoom-path``;
zooms and centres are exact decimal strings.

The seed moves the centre by up to ``seed.jitter`` of the deepest view in
each axis."""
from __future__ import annotations

from decimal import Decimal, localcontext
from typing import Dict, List


def frames(t: dict, config: dict, rng) -> List[Dict]:
    with localcontext() as ctx:
        ctx.prec = 60
        n = int(t["frames"])
        z0, z1 = Decimal(t["zoom_from"]), Decimal(t["zoom_to"])
        h = int(config["export_height"])
        # the deep view spans 4 zoom / height vertically (step 4 zoom / h^2)
        view = Decimal(4) * min(z0, z1) / Decimal(h)
        jit = Decimal(repr(float(t["seed"]["jitter"]))) * view
        cx = Decimal(config["center_x"]) + jit * Decimal(
            repr(float(rng.uniform(-1.0, 1.0))))
        cy = Decimal(config["center_y"]) + jit * Decimal(
            repr(float(rng.uniform(-1.0, 1.0))))
        ratio = float(z1 / z0)
    out = []
    for f in range(n):
        zoom = float(z0) * ratio ** (f / (n - 1))
        out.append({"hp_center_x": str(cx), "hp_center_y": str(cy),
                    "hp_zoom": repr(zoom),
                    "max_iterations": int(config["max_iterations"])})
    return out
