"""The animation renderer's interpolation between two keyframes (linear
easing: centre linear, zoom in log space, iterations stepped at t = 0.33
and 0.67), the root bench's zoom animation: a frozen copy of
``anim/keyframes.Animation.interpolate`` at commit f3d0ace5ea09 for the
fields these frames use, and of its frame clock (frame / fps).

The seed moves the end centre by up to ``seed.jitter`` of the end view in
each axis."""
from __future__ import annotations

import math
from typing import Dict, List


def frames(t: dict, config: dict, rng) -> List[Dict]:
    k1, k2 = t["keyframes"]
    n, fps = int(t["frames"]), float(t["fps"])
    duration = n / fps
    jit = float(t["seed"]["jitter"]) * float(k2["zoom"])
    ex = float(k2["center_x"]) + jit * rng.uniform(-1.0, 1.0)
    ey = float(k2["center_y"]) + jit * rng.uniform(-1.0, 1.0)
    out = []
    for f in range(n):
        time = min(max(f / fps, 0.0), duration)
        s = min(max(time / duration, 0.0), 1.0)
        z1, z2 = float(k1["zoom"]), float(k2["zoom"])
        zoom = max(0.000001, math.exp(math.log(z1)
                                      + s * (math.log(z2) - math.log(z1))))
        step = 0.0 if s < 0.33 else (0.5 if s < 0.67 else 1.0)
        iters = int(k1["max_iterations"]
                    + step * (k2["max_iterations"] - k1["max_iterations"]))
        out.append({
            "center_x": float(k1["center_x"])
            + s * (ex - float(k1["center_x"])),
            "center_y": float(k1["center_y"])
            + s * (ey - float(k1["center_y"])),
            "zoom": zoom, "max_iterations": iters})
    return out
