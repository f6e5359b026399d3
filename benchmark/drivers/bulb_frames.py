"""Driver of the Mandelbulb animation export: the per-frame branch of the
animation renderer (``anim/renderer.AnimationRenderer.start_render``)
without its fetch and PNG writes: every bulb frame through
``models.render`` at the frame's time with ``quantize=8``.

Set-up builds each frame's scene and renders the pass's first frame.  A
unit is one frame; the wait, for every stream of the card, is where
``start_render`` fetches it.

The comparison runs the plain reference (``reference/bulb.py``) over every
``row_stride``-th row of each sampled frame, from a first row drawn from
the seed, all sampled frames' rows in one march, then shades, colours and
quantizes those rows.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import compare
from benchmark.reference import bulb

# the march's and shading's precision as the configuration states it → the
# reference's dtype and the control's, the nearest precision below
PRECISION = {"f32": (torch.float32, torch.bfloat16)}
# the shader's camera turn (rad/s), fixed in the port's scene
ROTATION_SPEED = 0.3


class Driver:
    def __init__(self, config, traffic, checks, tr, seed, device):
        # what the reference and the comparison cover; any other
        # configuration is refused rather than run as this one
        if config["fractal"] != "mandelbulb":
            raise ValueError("the plain bulb reference is the Mandelbulb's")
        if config["precision"] not in PRECISION:
            raise ValueError(f"the bulb path runs {sorted(PRECISION)}, "
                             f"not {config['precision']!r}")
        if int(config["quantize_bits"]) != 8:
            raise ValueError("the comparison reads uint8 frames")
        if int(config["aa"]) != 1:
            raise ValueError("the plain bulb reference renders one sample")
        if int(config["palette_mode"]) not in bulb.PALETTES:
            raise ValueError(f"the reference has the palette modes "
                             f"{sorted(bulb.PALETTES)}")
        if float(config["rotation_speed"]) != ROTATION_SPEED:
            raise ValueError(f"the program turns the camera at the "
                             f"shader's {ROTATION_SPEED} rad/s")
        self.dtype, self.lower = PRECISION[config["precision"]]
        self.config, self.checks, self.tr = config, checks, tr
        self.device = torch.device(device)
        self.w = int(config["export_width"])
        self.h = int(config["export_height"])
        self.units = [(f,) for f in tr.order]
        stride = int(checks["row_stride"])
        first = int(np.random.default_rng([int(seed), 1]).integers(stride))
        self.rows = list(range(first, self.h, stride))

    def setup(self):
        from fractalrenderer_tpu_torch import models
        from fractalrenderer_tpu_torch.scene import FractalType, Scene

        c = self.config
        self.models = models
        self.scenes = [Scene(
            fractal_type=FractalType[c["fractal"].upper()],
            mandelbulb_power=c["mandelbulb_power"],
            max_iterations=c["max_iterations"],
            camera_distance=c["camera_distance"],
            rotation_y=c["rotation_y"], fov=c["fov"],
            antialiasing_samples=c["aa"], palette_mode=c["palette_mode"],
            color_offset=c["color_offset"], color_scale=c["color_scale"],
            color_brightness=c["brightness"],
            color_saturation=c["saturation"], color_contrast=c["contrast"],
            time=f["time"]) for f in self.tr.frames]
        h = self.submit(self.units[0])
        self.wait(h)
        self.outputs(self.units[0], h)

    def submit(self, unit):
        (f,) = unit
        return self.models.render(self.scenes[f], self.w, self.h,
                                  device=self.device,
                                  quantize=int(self.config["quantize_bits"]))

    def wait(self, handle):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def outputs(self, unit, handle):
        return [(unit[0], handle)]

    def release(self):
        self.scenes = self.models = None

    def reference_rows(self, frames, dtype=None):
        """The plain reference's uint8 (rows, width, 3) of each frame in
        ``frames`` over the sampled rows, and its march planes there."""
        c = self.config
        scenes = [{
            "camera_distance": c["camera_distance"],
            "rotation_y": c["rotation_y"], "power": c["mandelbulb_power"],
            "max_iterations": c["max_iterations"], "fov": c["fov"],
            "rotation_speed": c["rotation_speed"], "aa": c["aa"],
            "palette_mode": c["palette_mode"],
            "color_offset": c["color_offset"],
            "color_scale": c["color_scale"], "brightness": c["brightness"],
            "saturation": c["saturation"], "contrast": c["contrast"],
            "time": self.tr.frames[f]["time"]} for f in frames]
        out = bulb.frames(scenes, self.rows, self.w, self.h, self.device,
                          dtype or self.dtype)
        return dict(zip(frames, out))

    def control_outputs(self, frames):
        """The control's frames, kept as the program's are: the reference
        with its march and shading in the precision below the
        configuration's, over the sampled rows (the other rows are never
        compared)."""
        out = {}
        for f, (img, _) in self.reference_rows(list(frames),
                                               self.lower).items():
            full = torch.zeros((self.h, self.w, 3), dtype=torch.uint8,
                               device=img.device)
            full[self.rows] = img
            out[f] = full
        return out

    def check(self, kept):
        """The numbers compared over the sampled rows, each with its limit,
        and each frame's work, estimated for the whole frame from the
        sampled rows: the DE iterations its pixels need (the march, the
        escape recovery and the normal and AO taps), the pixels that hit,
        and the finished frame's bytes."""
        acc = compare.Diff()
        work = {}
        frames = sorted(kept)
        if frames:
            ref = self.reference_rows(frames)
            scale = self.h / len(self.rows)
            for f in frames:
                img, planes = ref[f]
                acc.add(kept[f][self.rows], img)
                work[f] = {
                    "steps": int(planes["work"].to(torch.int64).sum())
                    * scale,
                    "hits": int(planes["hit"].sum()) * scale,
                    "bytes": 3 * self.w * self.h}
        return compare.checks(acc, self.checks), work
