#!/usr/bin/env python3
"""The giant still's host deflate, estimated from strips of its image.

    python3 tools/deflate_estimate.py [--side 16384] [--rows 16]
        [--device cpu|cuda]

Renders five ``rows``-row strips of bench config 5's image (the default
Mandelbrot view at 256 iterations, ``side`` x ``side``) at rows spread
over its top half (the view is symmetric), quantizes them to 16 bits as
the giant still does, and deflates each strip's scanlines at levels 1
(the resume tiles) and 3 (the final IDAT) on one core of this host.
Prints one JSON line: each level's compressed / raw ratio, MB/s a core,
and the worker seconds the whole image would take at that rate.
Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=16384)
    ap.add_argument("--rows", type=int, default=16)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from fractalrenderer_tpu_torch import Scene
    from fractalrenderer_tpu_torch.models import common
    from fractalrenderer_tpu_torch.utils import png

    side = args.side
    scene = Scene(max_iterations=256)
    cfg = common.scene_static_cfg(scene, side, side, "mandelbrot",
                                  "centered", False, device=args.device)
    strip = common.band_render_fn(cfg, args.rows, side)
    levels = {1: [0, 0, 0.0], 3: [0, 0, 0.0]}
    for k in range(5):
        row0 = k * (side // 2 - args.rows) // 4
        img = strip(common.scene_dyn_params(scene), row0)
        rows = common.quantize_image(img, bit_depth=16).cpu().numpy()
        raw = png.band_raw_bytes(rows[::-1], 16)
        for level, acc in levels.items():
            t0 = time.perf_counter()
            out = png.deflate_chunk(raw, level)
            acc[2] += time.perf_counter() - t0
            acc[0] += len(raw)
            acc[1] += len(out)
    image_bytes = side * (side * 6 + 1)
    print(json.dumps({f"level{lv}": {
        "ratio": c / r, "mb_s_per_core": r / t / 1e6,
        "image_worker_seconds": image_bytes / (r / t)}
        for lv, (r, c, t) in levels.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
