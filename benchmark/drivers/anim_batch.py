"""Driver of the 2D animation export: the batch branch of the animation
renderer (``anim/renderer.AnimationRenderer.start_render``) without its
fetch and PNG writes.

Set-up builds each frame's scene and dynamic parameters, the group's
static configuration under the animation's iteration cap, as
``start_render`` groups them, the one ``batch_render_fn(cfg,
quantize=<quantize_bits>, planar=True)`` of the group, and each chunk's
parameter columns (``start_render``'s own host work, which the program's
call does not include).  A unit is a chunk of ``batch_size`` frames of the
pass (the pass's last chunk is shorter); its call renders the chunk, and
the wait, for every stream of the card, is where ``start_render`` fetches
the chunk.

The comparison renders each sampled frame with the plain reference
(``reference/plain2d.py``) at the full 1920 x 1080 and compares the planar
uint8 planes channel value by channel value.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.harness import compare
from benchmark.reference import plain2d

# the escape loop's precision as the configuration states it → the
# reference's dtype and the control's, the nearest precision below
PRECISION = {"f32": (torch.float32, torch.bfloat16)}


class Driver:
    def __init__(self, config, traffic, checks, tr, seed, device):
        # what the reference and the comparison cover; any other
        # configuration is refused rather than run as this one
        if config["fractal"] != "mandelbrot":
            raise ValueError("the plain 2D reference is the Mandelbrot set's")
        if config["precision"] not in PRECISION:
            raise ValueError(f"the batch path runs {sorted(PRECISION)}, "
                             f"not {config['precision']!r}")
        if int(config["quantize_bits"]) != 8:
            raise ValueError("the comparison reads uint8 frames")
        self.dtype, self.lower = PRECISION[config["precision"]]
        self.config, self.checks, self.tr = config, checks, tr
        self.device = torch.device(device)
        self.w = int(config["export_width"])
        self.h = int(config["export_height"])
        b = int(config["batch_size"])
        order = tr.order
        self.units = [tuple(order[i:i + b]) for i in range(0, len(order), b)]

    def _scene_kw(self, f: dict) -> dict:
        c = self.config
        return dict(center_x=f["center_x"], center_y=f["center_y"],
                    zoom=f["zoom"], max_iterations=f["max_iterations"],
                    bailout=c["bailout"], antialiasing_samples=c["aa"],
                    palette_mode=c["palette_mode"],
                    interior_style=c["interior_style"],
                    color_offset=c["color_offset"],
                    color_scale=c["color_scale"],
                    color_brightness=c["brightness"],
                    color_saturation=c["saturation"],
                    color_contrast=c["contrast"])

    def setup(self):
        from fractalrenderer_tpu_torch.models import common
        from fractalrenderer_tpu_torch.scene import FractalType, Scene

        kind = FractalType[self.config["fractal"].upper()]
        scenes = [Scene(fractal_type=kind, **self._scene_kw(f))
                  for f in self.tr.frames]
        self.cap = max(s.max_iterations for s in scenes)
        fam, conv, clamp = common.family_map()[kind]
        cfgs = {dataclasses.replace(common.scene_static_cfg(
            s, self.w, self.h, fam, conv, clamp, device=str(self.device)),
            max_iter=self.cap) for s in scenes}
        if len(cfgs) != 1:
            raise ValueError("the pass's frames must form one static group")
        cfg = cfgs.pop()
        if not common.planar_export_ok(cfg):
            raise ValueError("the configuration must export planar frames")
        self.fn = common.batch_render_fn(
            cfg, quantize=int(self.config["quantize_bits"]), planar=True)
        dyns = [common.scene_dyn_params(s) for s in scenes]
        # each chunk's columns, as start_render builds them
        self.batches = {
            unit: {k: np.asarray([dyns[f][k] for f in unit], np.float32)
                   for k in dyns[unit[0]]} for unit in self.units}
        for unit in self.units:  # every chunk size of the pass, once
            self.wait(self.submit(unit))

    def submit(self, unit):
        return self.fn(self.batches[unit])

    def wait(self, handle):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def outputs(self, unit, handle):
        return [(f, handle[j]) for j, f in enumerate(unit)]

    def release(self):
        self.fn = None

    def reference_frame(self, f: int, dtype=None):
        """The plain reference's planar uint8 frame ``f``, its count plane
        and skip mask."""
        c = self.config
        fr = self.tr.frames[f]
        scene = {"center_x": fr["center_x"], "center_y": fr["center_y"],
                 "zoom": fr["zoom"], "iter_limit": fr["max_iterations"],
                 "bailout": c["bailout"], "color_offset": c["color_offset"],
                 "color_scale": c["color_scale"],
                 "brightness": c["brightness"],
                 "saturation": c["saturation"], "contrast": c["contrast"]}
        cap = max(fr["max_iterations"] for fr in self.tr.frames)
        return plain2d.frame_planar(self.w, self.h, range(self.h), scene,
                                    cap, int(c["palette_mode"]),
                                    int(c["interior_style"]), self.device,
                                    dtype or self.dtype)

    def control_outputs(self, frames):
        """The control's frames, kept as the program's are: the reference
        with its escape loop in the precision below the configuration's."""
        return {f: self.reference_frame(f, self.lower)[0] for f in frames}

    def check(self, kept):
        """The numbers compared over the sampled frames, each with its
        limit, and each frame's work: K1's loop updates (min(n, limit - 1)
        over the pixels the interior skip leaves in the loop) and the
        finished frame's bytes."""
        acc = compare.Diff()
        work = {}
        for f in sorted(kept):
            ref, n, skip = self.reference_frame(f)
            acc.add(kept[f], ref)
            limit = int(self.tr.frames[f]["max_iterations"])
            upd = torch.clamp(n.to(torch.int64), max=limit - 1)
            work[f] = {"updates": int(upd[~skip].sum()),
                       "bytes": int(ref.numel())}
        return compare.checks(acc, self.checks), work
