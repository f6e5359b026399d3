"""Driver of the deep-zoom export: the deep branch of the animation
renderer (``anim/renderer.AnimationRenderer.start_render``) without its
fetch and PNG writes: every frame through ``models.render`` with
``quantize=8``, the configuration's ``rebasing`` and ``max_passes``,
against one reference orbit at the deepest frame's centre (``ref_center``)
and one ``orbit_cache`` for the run.  A frame that the program renders in
another delta precision than the configuration's ``precision`` stops the
run.

Set-up builds the scenes and renders the pass's first frame, which
computes and caches the orbit.  A unit is one frame; the wait, for every
stream of the card, is where ``start_render`` fetches it.

The comparison recomputes the orbit in Python integers and runs the plain
perturbation (``reference/deep.py``) over every ``row_stride``-th row of
each sampled frame, from a first row drawn from the seed, all sampled
frames' lanes in one loop, then colours and quantizes those rows.
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from benchmark.harness import compare
from benchmark.reference import deep, hp_orbit

# the deltas' precision as the configuration states it → the control's,
# the nearest precision below
LOWER = {"dd": "f32"}


def delta_tier(info: dict) -> str:
    """The delta precision a frame was rendered in, from the program's
    render info."""
    if info["scaled_delta"]:
        return "fx"
    return "dd" if info["dd_delta"] else "f32"


class Driver:
    def __init__(self, config, traffic, checks, tr, seed, device):
        if config["fractal"] != "deep_zoom":
            raise ValueError("the plain deep reference is the deep zoom's")
        if config["precision"] not in LOWER:
            raise ValueError(f"the deep reference runs {sorted(LOWER)}, "
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

    def setup(self):
        from fractalrenderer_tpu_torch import models
        from fractalrenderer_tpu_torch.scene import FractalType, Scene

        c = self.config
        self.models = models
        self.scenes = [Scene(
            fractal_type=FractalType[c["fractal"].upper()],
            hp_center_x=f["hp_center_x"],
            hp_center_y=f["hp_center_y"], hp_zoom=f["hp_zoom"],
            max_iterations=f["max_iterations"], use_perturbation=True,
            use_series_approximation=c["series_skip"],
            samples_per_pixel=c["spp"], bailout=c["bailout"],
            palette_mode=c["palette_mode"], color_offset=c["color_offset"],
            color_scale=c["color_scale"]) for f in self.tr.frames]
        self.cache = {}
        h = self.submit(self.units[0])
        self.wait(h)
        self.outputs(self.units[0], h)

    def submit(self, unit):
        (f,) = unit
        c = self.config
        return self.models.render(
            self.scenes[f], self.w, self.h, device=self.device,
            quantize=int(c["quantize_bits"]), ref_center=self.ref,
            orbit_cache=self.cache, rebasing=bool(c["rebasing"]),
            max_passes=int(c["max_passes"]), return_info=True)

    def wait(self, handle):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def outputs(self, unit, handle):
        img, info = handle
        if delta_tier(info) != self.config["precision"]:
            raise RuntimeError(
                f"frame {unit[0]} rendered with {delta_tier(info)} deltas, "
                f"the configuration states {self.config['precision']}")
        return [(unit[0], img)]

    def release(self):
        self.scenes = self.cache = self.models = None

    def reference_rows(self, frames, tier: str = None):
        """The plain reference's uint8 (rows, width, 3) of each frame in
        ``frames`` over the sampled rows, and each frame's count plane;
        the deltas in ``tier``, else the configuration's precision."""
        c = self.config
        tier = tier or c["precision"]
        max_iter = int(c["max_iterations"])
        center = tuple(Fraction(self.tr.frames[frames[0]][k])
                       for k in ("hp_center_x", "hp_center_y"))
        ref = tuple(Fraction(v) for v in self.ref)
        by_bits = {}
        for f in frames:
            z = Fraction(self.tr.frames[f]["hp_zoom"])
            by_bits.setdefault(hp_orbit.orbit_bits(z), []).append((f, z))
        out = {}
        for bits, group in by_bits.items():
            o = hp_orbit.orbit(hp_orbit.to_man(ref[0], bits),
                               hp_orbit.to_man(ref[1], bits), bits,
                               max_iter + 1)
            n, zx, zy, _ = deep.fields(
                [(z, self.rows) for _, z in group], o, center, ref, self.w,
                self.h, max_iter, float(c["bailout"]), bits, tier,
                self.device, int(c["max_passes"]))
            k = len(self.rows)
            for j, (f, _) in enumerate(group):
                sl = slice(j * k, (j + 1) * k)
                img = deep.color(n[sl], zx[sl], zy[sl], max_iter,
                                 c["color_offset"], c["color_scale"],
                                 int(c["palette_mode"]))
                out[f] = (deep.quantize8(img), n[sl])
        return out

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

    def check(self, kept):
        """The numbers compared over the sampled rows, each with its limit,
        and each frame's work: the delta steps its pixels need, n - (n0 -
        1) = n with the series off, estimated for the whole frame from the
        sampled rows, and the finished frame's bytes."""
        acc = compare.Diff()
        work = {}
        frames = sorted(kept)
        if frames:
            ref = self.reference_rows(frames)
            for f in frames:
                img, n = ref[f]
                acc.add(kept[f][self.rows], img)
                steps = int(n.to(torch.int64).sum())
                work[f] = {"steps": steps * self.h / len(self.rows),
                           "bytes": 3 * self.w * self.h}
        return compare.checks(acc, self.checks), work
