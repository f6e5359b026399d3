"""The frozen plain reference against the port's own plain versions on
the CPU, at 160 x 90 and below: the 2D frame, the orbit and the deep
frame bit for bit.  Only this file imports the port."""
import dataclasses
from fractions import Fraction

import numpy as np
import pytest
import torch

from small_cells import ANIM, DEEP, small
from benchmark.harness.traffic import generate
from benchmark.reference import deep, hp_orbit, plain2d

W, H = 160, 90


def _anim_frames(n_frames, seed):
    cell = small(ANIM, export_width=W, export_height=H, frames=n_frames)
    tr = generate(cell.traffic, cell.config, cell.checks, seed)
    return cell, tr


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 9])
def test_2d_frames_equal_the_port(seed):
    from fractalrenderer_tpu_torch.models import common
    from fractalrenderer_tpu_torch.scene import Scene

    cell, tr = _anim_frames(6, seed)
    c = cell.config
    scenes = [Scene(center_x=f["center_x"], center_y=f["center_y"],
                    zoom=f["zoom"], max_iterations=f["max_iterations"])
              for f in tr.frames]
    cap = max(s.max_iterations for s in scenes)
    cfg = dataclasses.replace(common.scene_static_cfg(
        scenes[0], W, H, "mandelbrot", "centered", False, device="cpu"),
        max_iter=cap)
    dyns = [common.scene_dyn_params(s) for s in scenes]
    batch = {k: np.asarray([d[k] for d in dyns], np.float32) for k in dyns[0]}
    got = common.batch_render_fn(cfg, quantize=8, planar=True)(batch)
    for i, f in enumerate(tr.frames):
        scene = {"center_x": f["center_x"], "center_y": f["center_y"],
                 "zoom": f["zoom"], "iter_limit": f["max_iterations"],
                 "bailout": c["bailout"], "color_offset": 0.0,
                 "color_scale": 1.0, "brightness": 1.0, "saturation": 1.0,
                 "contrast": 1.0}
        ref, n, skip = plain2d.frame_planar(W, H, range(H), scene, cap, 0, 0,
                                            "cpu")
        assert torch.equal(got[i], ref)


def test_2d_counts_equal_the_port_on_a_band():
    from fractalrenderer_tpu_torch.ops import escape

    scene = {"center_x": -0.743, "center_y": 0.1318, "zoom": 0.01,
             "iter_limit": 700, "bailout": 4.0}
    params = escape.pack_params(center_x=-0.743, center_y=0.1318, zoom=0.01,
                                iter_limit=700, row0=30)
    n, zx, zy = escape.escape_fields_plain(
        params, width=W, height=20, map_height=H, row0=30,
        max_iter_cap=1024, interior_skip=True, fused_color=None,
        device="cpu")
    rn, rzx, rzy, skip, _ = plain2d.escape_counts(W, H, range(30, 50), scene,
                                                  1024, "cpu")
    assert torch.equal(n, rn) and torch.equal(zx, rzx) and \
        torch.equal(zy, rzy)


@pytest.mark.parametrize("cx,cy,zoom,iters", [
    ("-0.74364388703715158", "0.13182590420531198", "1e-12", 3000),
    ("-1.7497219297", "0.0000000000", "1e-20", 500)])
def test_orbit_equals_the_port(cx, cy, zoom, iters):
    from fractalrenderer_tpu_torch.deepzoom import orbit

    bits = hp_orbit.orbit_bits(Fraction(zoom))
    want = hp_orbit.orbit(hp_orbit.to_man(Fraction(cx), bits),
                          hp_orbit.to_man(Fraction(cy), bits), bits,
                          iters + 1)
    for force_python in (True, False):
        got = orbit.compute_orbit(cx, cy, bits, iters + 1,
                                  force_python=force_python)
        np.testing.assert_array_equal(got, want)


def test_orbit_bits_follow_the_port():
    from fractalrenderer_tpu_torch.deepzoom.hp import \
        precision_mode_for_zoom_frac

    for z in ("1e-8", "1e-11", "1e-13", "2e-14", "1e-16", "1e-25"):
        _, bits = precision_mode_for_zoom_frac(Fraction(z))
        assert hp_orbit.orbit_bits(Fraction(z)) == -(-bits // 64) * 64


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 77])
def test_deep_rows_equal_the_port(seed):
    from fractalrenderer_tpu_torch import models
    from fractalrenderer_tpu_torch.scene import FractalType, Scene

    cell = small(DEEP, export_width=W, export_height=H, max_iterations=400,
                 row_stride=9)
    from benchmark.harness.spec import load_module

    tr = generate(cell.traffic, cell.config, cell.checks, seed)
    drv = load_module("drivers", "deep_frames").Driver(
        cell.config, cell.traffic, cell.checks, tr, seed, "cpu")
    ref = drv.reference_rows(list(range(len(tr.frames))))
    cache = {}
    for i, f in enumerate(tr.frames):
        s = Scene(fractal_type=FractalType.DEEP_ZOOM,
                  hp_center_x=f["hp_center_x"], hp_center_y=f["hp_center_y"],
                  hp_zoom=f["hp_zoom"], max_iterations=400,
                  use_perturbation=True)
        img = models.render(s, W, H, device="cpu", quantize=8,
                            ref_center=drv.ref, orbit_cache=cache)
        assert torch.equal(img[drv.rows], ref[i][0])


def test_deep_f32_tier_equals_the_port():
    from fractalrenderer_tpu_torch.ops import perturbation

    cx, cy, z = (Fraction("-0.74364388703715158"),
                 Fraction("0.13182590420531198"), Fraction("1e-6"))
    o = hp_orbit.orbit(hp_orbit.to_man(cx, 64), hp_orbit.to_man(cy, 64), 64,
                       501)
    rows = list(range(40, 48))
    n, zx, zy, _ = deep.fields([(z, rows)], o, (cx, cy), (cx, cy), W, H,
                               500, 4.0, 64, "f32", "cpu", 256)
    f = perturbation.perturbation_fields(
        o, W, 8, center_x_dd=hp_orbit.dd_from_fraction(cx),
        center_y_dd=hp_orbit.dd_from_fraction(cy), zoom_frac=str(z),
        max_iter=500, float_continuation=False, rebase=True, row0=40.0,
        map_height=H, device="cpu")
    assert torch.equal(f["n"], n) and torch.equal(f["zx"], zx)
