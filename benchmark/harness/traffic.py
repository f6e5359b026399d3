"""The one generator of the benchmark's traffic: from a traffic file's
parameters, the cell's configuration and ``--seed`` to the frames of one
pass, in the order the window renders them.

The traffic file's ``"path"`` names the camera path, ``paths/<path>.py``,
whose ``frames(traffic, config, rng)`` gives the pass's frames by index
from the seed's generator; a new path is a new file there.  This module
adds what every path shares: the frame the pass starts at
(``seed.rotate``) and the frames the comparison checks, both drawn from
the seed, so every seed renders the same number of frames at the same
sizes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from .spec import BENCH_DIR, load_module


@dataclass
class Traffic:
    frames: List[Dict]   # by frame index
    order: List[int]     # frame indices of one pass, in render order
    sample: List[int]    # frame indices the comparison checks


def generate(traffic: dict, config: dict, checks: dict, seed: int,
             bench_dir: str = BENCH_DIR) -> Traffic:
    rng = np.random.default_rng(int(seed))
    frames = load_module("paths", traffic["path"], bench_dir).frames(
        traffic, config, rng)
    n = len(frames)
    start = int(rng.integers(n)) if traffic["seed"].get("rotate") else 0
    order = [(start + k) % n for k in range(n)]
    k = min(int(checks["sample_frames"]), n)
    sample = sorted(int(i) for i in rng.choice(n, size=k, replace=False))
    return Traffic(frames, order, sample)
