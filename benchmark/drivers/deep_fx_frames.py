"""Driver of the deep-zoom export past the f64 floor: ``deep_frames``'
frames (the deep branch of the animation renderer without its fetch and
PNG writes: every frame through ``models.render`` with ``quantize=8``,
the configuration's ``rebasing`` and ``max_passes``, against one
reference orbit at the deepest frame's centre and one ``orbit_cache`` for
the run) in the floatexp delta tier.  A frame that the program renders
in another delta precision than the configuration's ``precision`` stops
the run.

Set-up builds the scenes and renders the first frame of the pass in each
of the orbit's bits buckets (``reference/deep_fx.orbit_bits``, the
program's rule), which computes and caches every orbit the pass uses, so
the window computes none.

The comparison recomputes the orbit in Python integers at each sampled
frame's bits and runs the plain floatexp perturbation
(``reference/deep_fx.py``) over every ``row_stride``-th row of each
sampled frame, from a first row drawn from the seed, then colours and
quantizes those rows.  The control runs the reference's double-double
deltas instead, which flush to 0 past 1e-38.
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from benchmark.drivers import deep_frames
from benchmark.reference import deep_fx

# the deltas' precision as the configuration states it → the control's,
# the nearest precision below
LOWER = {"fx": "dd"}


class Driver(deep_frames.Driver):
    def __init__(self, config, traffic, checks, tr, seed, device):
        if config["fractal"] != "deep_zoom":
            raise ValueError("the plain deep reference is the deep zoom's")
        if config["precision"] not in LOWER:
            raise ValueError(f"the floatexp reference runs {sorted(LOWER)}, "
                             f"not {config['precision']!r}")
        if int(config["quantize_bits"]) != 8:
            raise ValueError("the comparison reads uint8 frames")
        self.config, self.checks, self.tr = config, checks, tr
        self.device = torch.device(device)
        self.w = int(config["export_width"])
        self.h = int(config["export_height"])
        self.units = [(f,) for f in tr.order]
        stride = int(checks["row_stride"])
        first = int(np.random.default_rng([int(seed), 1]).integers(stride))
        self.rows = list(range(first, self.h, stride))
        deepest = min(tr.frames, key=lambda f: abs(Fraction(f["hp_zoom"])))
        self.ref = (deepest["hp_center_x"], deepest["hp_center_y"])

    def buckets(self) -> dict:
        """The orbit's bits → the pass's first frame at those bits."""
        first = {}
        for f in self.tr.order:
            bits = deep_fx.orbit_bits(Fraction(self.tr.frames[f]["hp_zoom"]))
            first.setdefault(bits, f)
        return first

    def setup(self):
        super().setup()
        # the first bucket's first frame is the pass's, rendered above
        for f in list(self.buckets().values())[1:]:
            h = self.submit((f,))
            self.wait(h)
            self.outputs((f,), h)

    def reference_rows(self, frames, tier: str = None):
        """The plain reference's uint8 (rows, width, 3) of each frame in
        ``frames`` over the sampled rows, and each frame's count plane;
        the deltas in ``tier``, else the configuration's precision."""
        c = self.config
        center = tuple(Fraction(self.tr.frames[frames[0]][k])
                       for k in ("hp_center_x", "hp_center_y"))
        ref = tuple(Fraction(v) for v in self.ref)
        blocks = [(Fraction(self.tr.frames[f]["hp_zoom"]), self.rows)
                  for f in frames]
        out = deep_fx.frames(
            blocks, center, ref, self.w, self.h, int(c["max_iterations"]),
            float(c["bailout"]), c["color_offset"], c["color_scale"],
            int(c["palette_mode"]), self.device, int(c["max_passes"]),
            tier or c["precision"])
        return dict(zip(frames, out))

    def control_outputs(self, frames):
        """The control's frames, kept as the program's are: the reference
        with its deltas in the precision below the configuration's, over
        the sampled rows (the other rows are never compared)."""
        out = {}
        for f, (img, _) in self.reference_rows(
                list(frames), LOWER[self.config["precision"]]).items():
            full = torch.zeros((self.h, self.w, 3), dtype=torch.uint8,
                               device=img.device)
            full[self.rows] = img
            out[f] = full
        return out
