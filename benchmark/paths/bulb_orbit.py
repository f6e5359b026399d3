"""The Mandelbulb's own clock through an animation export: frame ``f`` at
``time = t0 + f / fps`` (the animation renderer passes the frame time into
the bulb's dispatch), from which the shader turns the camera (rotation
0.3 t), pulses its distance (3 (1 + 0.3 sin(0.5 t))) and its power
(8 + 0.5 sin(0.7 t)).

The seed draws ``t0`` uniform in [0, ``seed.t0_span``)."""
from __future__ import annotations

from typing import Dict, List


def frames(t: dict, config: dict, rng) -> List[Dict]:
    n, fps = int(t["frames"]), float(t["fps"])
    t0 = float(rng.uniform(0.0, float(t["seed"]["t0_span"])))
    return [{"time": t0 + f / fps} for f in range(n)]
