"""Driver of the Julia c-parameter sweep: the sweep verb
(``cli.cmd_sweep``) without its fetch and PNG writes, one call
``models.julia.render_c_sweep(scene, cs, width, height, device=...)`` a
unit, as the verb calls it.

Set-up builds the configuration's scene and each unit's c values and
warms one call of each unit size.  A unit is ``sweep_size`` consecutive c
values of the pass in render order (the pass's last unit is shorter where
the pass is not a whole number of them); the wait, for every stream of
the card, is where ``cmd_sweep`` fetches the sweep.  A sampled frame is
copied out of its sweep's f32 output (one copy on the card, a few a
pass), so the run holds the sampled frames, not every sweep one of them
came from.

The comparison quantizes each sampled f32 frame with the reference's
quantize and compares its uint8 planes with the plain reference's
(``reference/plain_julia.py``) at the full frame, channel value by
channel value.  Each sampled frame's work is the reference's per-sample
count planes (K1's loop updates over every pixel: a Julia frame has no
interior skip), the f32 frame's bytes, the frame's samples, and the
growth of the program's counter ``band_render_fn.param_uploads`` over
the frames rendered after set-up (the window, the traced pass and any
sampled frame rendered after the window), per frame; None where the
program has no such counter.
"""
from __future__ import annotations

import sys

import torch

from benchmark.harness import compare
from benchmark.reference import plain_julia

# the escape loop's precision as the configuration states it → the
# reference's dtype and the control's, the nearest precision below
PRECISION = {"f32": (torch.float32, torch.bfloat16)}


def _param_uploads():
    """The program's count of a 2D frame's host-scalar copies, or None
    where it has no such counter."""
    common = sys.modules.get("fractalrenderer_tpu_torch.models.common")
    return getattr(getattr(common, "band_render_fn", None),
                   "param_uploads", None)


class Driver:
    def __init__(self, config, traffic, checks, tr, seed, device):
        # what the reference and the comparison cover; any other
        # configuration is refused rather than run as this one
        if config["fractal"] != "julia":
            raise ValueError("the plain sweep reference is the Julia set's")
        if config["precision"] not in PRECISION:
            raise ValueError(f"the sweep runs {sorted(PRECISION)}, "
                             f"not {config['precision']!r}")
        if int(config["aa"]) < 2:
            raise ValueError("the cell runs the multi-sample branch: aa must "
                             "be 2 or more")
        if int(config["palette_mode"]) not in plain_julia.PALETTES:
            raise ValueError(f"the reference has the palette modes "
                             f"{list(plain_julia.PALETTES)}")
        self.dtype, self.lower = PRECISION[config["precision"]]
        self.config, self.checks, self.tr = config, checks, tr
        self.device = torch.device(device)
        self.w = int(config["export_width"])
        self.h = int(config["export_height"])
        self.aa = int(config["aa"])
        b = int(traffic["sweep_size"])
        order = tr.order
        self.units = [tuple(order[i:i + b]) for i in range(0, len(order), b)]
        self.sample = set(tr.sample)
        self.uploads0 = None
        self.rendered = 0

    def setup(self):
        from fractalrenderer_tpu_torch.models import julia
        from fractalrenderer_tpu_torch.scene import FractalType, Scene

        c = self.config
        self.sweep = julia.render_c_sweep
        self.scene = Scene(
            fractal_type=FractalType.JULIA, center_x=c["center_x"],
            center_y=c["center_y"], zoom=c["zoom"],
            max_iterations=c["max_iterations"], bailout=c["bailout"],
            antialiasing_samples=self.aa, palette_mode=c["palette_mode"],
            interior_style=c["interior_style"],
            color_offset=c["color_offset"], color_scale=c["color_scale"],
            color_brightness=c["brightness"],
            color_saturation=c["saturation"], color_contrast=c["contrast"])
        self.cs = {unit: [(self.tr.frames[f]["c_real"],
                           self.tr.frames[f]["c_imag"]) for f in unit]
                   for unit in self.units}
        sizes = {}
        for unit in self.units:
            sizes.setdefault(len(unit), unit)
        for unit in sizes.values():  # every unit size of the pass, once
            self.wait(self.submit(unit))
        self.uploads0 = _param_uploads()
        self.rendered = 0

    def submit(self, unit):
        self.rendered += len(unit)
        return self.sweep(self.scene, self.cs[unit], self.w, self.h,
                          device=self.device)

    def wait(self, handle):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def outputs(self, unit, handle):
        return [(f, handle[j].clone() if f in self.sample else None)
                for j, f in enumerate(unit)]

    def release(self):
        self.sweep = None

    def _view(self, f: int) -> dict:
        c, fr = self.config, self.tr.frames[f]
        return {"center_x": c["center_x"], "center_y": c["center_y"],
                "zoom": c["zoom"], "bailout": c["bailout"],
                "iter_limit": c["max_iterations"],
                "c_real": fr["c_real"], "c_imag": fr["c_imag"],
                "color_offset": c["color_offset"],
                "color_scale": c["color_scale"],
                "brightness": c["brightness"],
                "saturation": c["saturation"], "contrast": c["contrast"]}

    def reference_frame(self, f: int, dtype=None):
        """The plain reference's frame ``f``: its uint8 planes, f32 image,
        per-sample count planes and limit."""
        cap = plain_julia.iter_bucket(int(self.config["max_iterations"]))
        return plain_julia.frame(self.w, self.h, range(self.h), self._view(f),
                                 self.aa, cap, self.device,
                                 dtype or self.dtype)

    def control_outputs(self, frames):
        """The control's frames, kept as the program's are (f32 images):
        the reference with its escape loop in the precision below the
        configuration's."""
        return {f: self.reference_frame(f, self.lower)[1] for f in frames}

    def _uploads_per_frame(self):
        now = _param_uploads()
        if now is None or self.uploads0 is None or not self.rendered:
            return None
        return (now - self.uploads0) / self.rendered

    def check(self, kept):
        """The numbers compared over the sampled frames, each with its
        limit, and each frame's work."""
        acc = compare.Diff()
        work = {}
        uploads = self._uploads_per_frame()
        for f in sorted(kept):
            ref, _, n, limit_f = self.reference_frame(f)
            acc.add(plain_julia.quantize8(kept[f].to(ref.device))
                    .permute(2, 0, 1), ref)
            upd = torch.clamp(n.to(torch.int64), max=int(limit_f) - 1)
            work[f] = {"updates": int(upd.sum()),
                       "bytes": 4 * 3 * self.w * self.h,
                       "samples": self.aa * self.aa,
                       "param_uploads": uploads}
        return compare.checks(acc, self.checks), work
