"""The benchmark's cells cut to a size the CPU tests hold: the same files,
with the frame, the pass, the iterations and the sample made small."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import spec  # noqa: E402

ANIM = "mandelbrot_f32.anim_export"
DEEP = "deep_zoom_dd.zoom_export"


def small(name: str, **over) -> spec.Cell:
    c = spec.load_cell(name)
    if name == ANIM:
        c.config.update(export_width=64, export_height=36)
        c.traffic.update(frames=16)
        c.traffic["keyframes"][0]["max_iterations"] = 32
        c.traffic["keyframes"][1]["max_iterations"] = 64
        c.checks["sample_frames"] = 6
    else:
        # a view with structure under 300 iterations: c = i (its orbit is
        # preperiodic, so the reference orbit runs its full length)
        c.config.update(export_width=48, export_height=27,
                        max_iterations=300, center_x="0.0", center_y="1.0")
        c.traffic.update(frames=4, zoom_from="1e-8", zoom_to="1e-9")
        c.checks.update(sample_frames=2, row_stride=4)
    for k, v in over.items():
        for d in (c.config, c.traffic, c.checks):
            if k in d:
                d[k] = v
    return c
