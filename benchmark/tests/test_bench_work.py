"""Each roofline's work count against a count by hand at 16 x 9: K1's loop
updates from a scalar f32 loop per pixel, K3's delta steps from each
pixel's own exact orbit."""
from fractions import Fraction

import numpy as np

from small_cells import ANIM, DEEP, small
from benchmark.harness.spec import load_module
from benchmark.harness.traffic import generate

W, H = 16, 9


def _driver(cell, seed):
    tr = generate(cell.traffic, cell.config, cell.checks, seed)
    drv = load_module("drivers", cell.traffic["driver"]).Driver(
        cell.config, cell.traffic, cell.checks, tr, seed, "cpu")
    return tr, drv


def _k1_updates_by_hand(f: dict) -> int:
    """min(n, limit - 1) over the pixels outside the cardioid and the
    period-2 bulb, each pixel's f32 loop run by itself."""
    s = np.float32
    cx, cy, zoom = s(f["center_x"]), s(f["center_y"]), s(f["zoom"])
    limit = f["max_iterations"]
    total = 0
    for py in range(H):
        for px in range(W):
            cr = cx + ((s(px) + s(0) - s(0.5) * s(W)) / s(H)) * zoom
            ci = cy + ((s(py) + s(0) - s(0.5) * s(H)) / s(H)) * zoom
            xq = cr - s(0.25)
            q = xq * xq + ci * ci
            if q * (q + xq) <= s(0.25) * (ci * ci) or \
                    (cr + s(1)) * (cr + s(1)) + ci * ci <= s(0.0625):
                continue
            x, y, n = cr, ci, 0
            for _ in range(1, limit):
                if x * x + y * y > s(16):
                    break
                n += 1
                x, y = x * x - y * y + cr, (s(2) * x) * y + ci
            total += n
    return total


def test_k1_work_by_hand():
    cell = small(ANIM, export_width=W, export_height=H, frames=16)
    tr, drv = _driver(cell, 11)
    kept = {f: drv.reference_frame(f)[0] for f in tr.sample}
    _, work = drv.check(kept)
    for f in tr.sample:
        assert work[f]["updates"] == _k1_updates_by_hand(tr.frames[f])
        assert work[f]["bytes"] == 3 * W * H


def _k3_steps_by_hand(f: dict, width: int, height: int, max_iter: int):
    """n per pixel from the pixel's own orbit in exact rationals rounded to
    160 fraction bits: the first index k with |z_k|^2 > 16 gives n = k - 1
    (a pixel that never escapes: max_iter)."""
    bits = 160
    one = 1 << bits
    cx, cy = Fraction(f["hp_center_x"]), Fraction(f["hp_center_y"])
    step = Fraction(f["hp_zoom"]) * 4 / (height * height)
    total = 0
    for py in range(height):
        for px in range(width):
            cr = round((cx + step * (px - Fraction(width, 2))) * one)
            ci = round((cy + step * (py - Fraction(height, 2))) * one)
            zr = zi = 0
            n = max_iter
            for k in range(max_iter + 1):
                if zr * zr + zi * zi > 16 * one * one:
                    n = k - 1
                    break
                zr, zi = ((zr * zr - zi * zi) >> bits) + cr, \
                    ((2 * zr * zi) >> bits) + ci
            total += n
    return total


def test_k3_work_by_hand():
    cell = small(DEEP, export_width=W, export_height=H, row_stride=1)
    tr, drv = _driver(cell, 4)
    ref = drv.reference_rows(tr.sample)
    full = {}
    for f in tr.sample:
        import torch

        img = torch.zeros((H, W, 3), dtype=torch.uint8)
        img[drv.rows] = ref[f][0]
        full[f] = img
    _, work = drv.check(full)
    for f in tr.sample:
        assert work[f]["steps"] == _k3_steps_by_hand(tr.frames[f], W, H, 300)
        assert work[f]["bytes"] == 3 * W * H
