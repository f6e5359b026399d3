"""A c-parameter sweep around the upstream's Julia presets
(src/ui_manager.cpp:1255-1260): a loop through the presets in the traffic
file's order and back to the first, each leg ``per_leg`` c values evenly
spaced from its preset, start included and end excluded, so a pass is
``per_leg`` times the number of presets.

The seed moves each preset by up to ``seed.jitter`` in both axes, drawn
once per preset, so every leg starts at its jittered preset."""
from __future__ import annotations

from typing import Dict, List


def frames(t: dict, config: dict, rng) -> List[Dict]:
    jit = float(t["seed"]["jitter"])
    presets = [(float(p["c_real"]) + jit * rng.uniform(-1.0, 1.0),
                float(p["c_imag"]) + jit * rng.uniform(-1.0, 1.0))
               for p in t["presets"]]
    k = int(t["per_leg"])
    out = []
    for i, (ar, ai) in enumerate(presets):
        br, bi = presets[(i + 1) % len(presets)]
        out += [{"c_real": ar + (br - ar) * j / k,
                 "c_imag": ai + (bi - ai) * j / k} for j in range(k)]
    return out
