"""The port's ``export-print`` and ``zoom-path`` verbs and its deep-zoom
manager (``deepzoom/manager.py``) on the CPU device: twins of
tests/test_cli.py's export-print and zoom-path tests and of
tests/test_deepzoom.py's manager and shared-orbit tests, and the same
scenes through both CLIs (export-print against the JAX CLI's ``--golden``,
whose counts the JAX CPU kernel's FMA contraction does not move;
zoom-path against the JAX CLI where the frames' counts agree, the pattern
of test_torch_deepzoom.py)."""
import math
import os

import numpy as np
import pytest
import torch

from fractalrenderer_tpu import cli as jax_cli
from fractalrenderer_tpu.deepzoom import manager as jax_manager
from fractalrenderer_tpu.models import deep_zoom as jax_dz
from fractalrenderer_tpu.utils.png import read_png
from fractalrenderer_tpu_torch import FractalType, Scene, cli, models
from fractalrenderer_tpu_torch.deepzoom import hp, manager
from fractalrenderer_tpu_torch.models import deep_zoom
from fractalrenderer_tpu_torch.utils.image import (downsample2x,
                                                   to_export_orientation)


def _pixels16(img):
    """The 16-bit PNG pixels of an f32 image, flipped for export."""
    img = np.clip(to_export_orientation(img).numpy(), 0.0, 1.0)
    return (img * 65535.0 + 0.5).astype(np.uint16)


def test_export_print_cap(tmp_path, capsys):
    rc = cli.main(["export-print", "--width", "20000", "--height", "20000",
                   "--supersample", "--out", str(tmp_path / "x.png")])
    assert rc == 2
    assert "32000" in capsys.readouterr().err


def test_export_print_small(tmp_path, capsys):
    out = str(tmp_path / "p.png")
    rc = cli.main(["export-print", "--device", "cpu", "--width", "32",
                   "--height", "16", "--iters", "16", "--out", out])
    assert rc == 0
    assert "Exported 32x16 16-bit PNG" in capsys.readouterr().out
    img = read_png(out)
    assert img.dtype == np.uint16 and img.shape == (16, 32, 3)
    raw = open(out, "rb").read()
    assert b"pHYs" in raw and b"Print Size (inches)" in raw
    assert b"gAMA" in raw and b"0.11 x 0.05" in raw


@pytest.mark.parametrize("downsample", [False, True])
def test_export_print_supersample(tmp_path, downsample):
    # --supersample renders at 2x and writes it as-is; with --downsample
    # the 2x render is box-filtered back to the requested size
    out = str(tmp_path / "p.png")
    rc = cli.main(["export-print", "--device", "cpu", "--width", "24",
                   "--height", "14", "--iters", "48", "--supersample",
                   *(["--downsample"] if downsample else []), "--out", out])
    assert rc == 0
    img = read_png(out)
    big = models.render(Scene(max_iterations=48), 48, 28, device="cpu")
    want = _pixels16(downsample2x(big) if downsample else big)
    assert img.shape == want.shape == ((14, 24, 3) if downsample
                                       else (28, 48, 3))
    np.testing.assert_array_equal(img, want)


def test_downsample2x_equals_the_jax_helper():
    from fractalrenderer_tpu.utils.image import downsample2x as jax_ds

    img = np.random.default_rng(7).random((9, 13, 3), dtype=np.float32)
    got = downsample2x(torch.from_numpy(img))
    assert got.shape == (4, 6, 3)
    np.testing.assert_array_equal(got.numpy(), jax_ds(img))


def test_export_print_above_the_one_pass_size_names_item_8(tmp_path,
                                                           capsys,
                                                           monkeypatch):
    def no_render(*a, **kw):
        raise AssertionError("rendered")

    monkeypatch.setattr(models, "render", no_render)
    out = tmp_path / "big.png"
    rc = cli.main(["export-print", "--device", "cpu", "--width", "8200",
                   "--height", "8200", "--supersample", "--downsample",
                   "--out", str(out)])
    assert rc == 2
    err = capsys.readouterr().err.strip()
    assert "\n" not in err and "ROADMAP Queue 1 item 8" in err
    assert "16400x16400" in err
    assert not out.exists()


@pytest.mark.parametrize("extra", [
    [], ["--supersample", "--downsample"],
    ["--type", "julia", "--supersample"],
    ["--type", "burning-ship", "--center", "-0.5", "-0.6", "--zoom", "2",
     "--dpi", "150"],
    ["--golden", "--type", "phoenix"],
], ids=["default", "ss-ds", "julia-ss", "ship-dpi150", "golden-phoenix"])
def test_export_print_matches_the_jax_cli(tmp_path, extra):
    mine, ref = str(tmp_path / "mine.png"), str(tmp_path / "ref.png")
    flags = ["--width", "40", "--height", "22", "--iters", "64", *extra]
    assert cli.main(["export-print", "--device", "cpu", *flags,
                     "--out", mine]) == 0
    jax_flags = [f for f in flags if f != "--golden"]
    assert jax_cli.main(["export-print", "--golden", *jax_flags,
                         "--out", ref]) == 0
    a, b = read_png(mine), read_png(ref)
    assert a.dtype == b.dtype == np.uint16 and a.shape == b.shape
    assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= 1
    raw_a, raw_b = open(mine, "rb").read(), open(ref, "rb").read()
    for chunk in (b"pHYs", b"gAMA", b"sRGB", b"Print Size (inches)"):
        assert (chunk in raw_a) and (chunk in raw_b)
    phys = raw_b[raw_b.index(b"pHYs"):][:13]
    assert phys in raw_a


def test_zoom_path_cli(tmp_path):
    out_dir = str(tmp_path / "zp")
    rc = cli.main(["zoom-path", "--device", "cpu", "--preset-zoom",
                   "Seahorse", "--frames", "2", "--width", "24", "--height",
                   "12", "--iters", "150", "--out-dir", out_dir])
    assert rc == 0
    assert sorted(os.listdir(out_dir)) == ["frame_000000.png",
                                           "frame_000001.png"]


def test_zoom_path_custom_target(tmp_path, capsys):
    # the deep-zoom panel's typed Target X/Y/Zoom + Start Zoom Animation
    # (ui_manager.cpp:701-710): frame 0 is the current view, the last
    # frame is the typed target
    out_dir = str(tmp_path / "zpt")
    rc = cli.main(["zoom-path", "--device", "cpu", "--target-x", "-0.745",
                   "--target-y", "0.113", "--target-zoom", "1e-6",
                   "--frames", "2", "--width", "24", "--height", "12",
                   "--iters", "150", "--out-dir", out_dir])
    assert rc == 0
    assert sorted(os.listdir(out_dir)) == ["frame_000000.png",
                                           "frame_000001.png"]
    capsys.readouterr()
    # neither preset nor a full target is an error, not a hang
    assert cli.main(["zoom-path", "--device", "cpu", "--target-x", "-0.5",
                     "--frames", "2", "--out-dir", out_dir]) == 2
    err = capsys.readouterr().err.strip()
    assert err.startswith("error:") and "--target-zoom" in err


def _frame_scene(start, end, t, iters):
    cx = start.center_x + t * (end.center_x - start.center_x)
    cy = start.center_y + t * (end.center_y - start.center_y)
    zoom = math.exp(math.log(start.zoom)
                    + t * (math.log(end.zoom) - math.log(start.zoom)))
    return Scene(fractal_type=FractalType.DEEP_ZOOM, use_perturbation=True,
                 max_iterations=iters, center_x=cx, center_y=cy, zoom=zoom,
                 hp_center_x=repr(cx), hp_center_y=repr(cy),
                 hp_zoom=repr(zoom))


def test_zoom_path_frames_use_one_orbit_and_end_at_a_standalone_render(
        tmp_path, monkeypatch):
    calls = []
    orig = deep_zoom.orbit_mod.compute_orbit

    def counting(*a, **kw):
        if "escape_mag_sq" not in kw:  # not an HP-fallback pixel's orbit
            calls.append(a[:2])
        return orig(*a, **kw)

    monkeypatch.setattr(deep_zoom.orbit_mod, "compute_orbit", counting)
    out_dir = str(tmp_path / "zp")
    assert cli.main(["zoom-path", "--device", "cpu", "--preset-zoom", "Mini",
                     "--frames", "3", "--width", "32", "--height", "18",
                     "--iters", "300", "--out-dir", out_dir]) == 0
    start, end = manager.preset_zoom_path("Mini")
    assert calls == [(repr(end.center_x), repr(end.center_y))]
    for f, t in enumerate((0.0, 0.5, 1.0)):
        img = read_png(os.path.join(out_dir, f"frame_{f:06d}.png"))
        want = to_export_orientation(models.render(
            _frame_scene(start, end, t, 300), 32, 18, device="cpu",
            ref_center=(repr(end.center_x), repr(end.center_y)),
            quantize=8)).numpy()
        np.testing.assert_array_equal(img, want)
    # the last frame's shift is 0: it equals a render with its own orbit
    alone = to_export_orientation(models.render(
        _frame_scene(start, end, 1.0, 300), 32, 18, device="cpu",
        quantize=8)).numpy()
    np.testing.assert_array_equal(img, alone)


def test_zoom_path_matches_the_jax_cli(tmp_path):
    flags = ["--preset-zoom", "Seahorse", "--frames", "2", "--width", "24",
             "--height", "12", "--iters", "150"]
    mine, ref = str(tmp_path / "mine"), str(tmp_path / "ref")
    assert cli.main(["zoom-path", "--device", "cpu", *flags,
                     "--out-dir", mine]) == 0
    assert jax_cli.main(["zoom-path", *flags, "--out-dir", ref]) == 0
    assert sorted(os.listdir(mine)) == sorted(os.listdir(ref))
    start, end = manager.preset_zoom_path("Seahorse")
    ref_center = (repr(end.center_x), repr(end.center_y))
    for f, t in enumerate((0.0, 1.0)):
        a = read_png(os.path.join(mine, f"frame_{f:06d}.png"))
        b = read_png(os.path.join(ref, f"frame_{f:06d}.png"))
        scene = _frame_scene(start, end, t, 150)
        n, *_ = deep_zoom.render_fields(scene, 24, 12, ref_center=ref_center,
                                        device="cpu")
        jn, *_ = jax_dz.render_fields(
            jax_cli.Scene.from_dict(scene.to_dict()), 24, 12,
            ref_center=ref_center)
        # counts agree but where the JAX CPU kernel's contracted FMAs move
        # a boundary pixel of the whole-set frame
        same = (n == np.asarray(jn))[::-1]
        assert (~same).mean() < 0.02
        lsb = np.abs(a.astype(np.int64) - b.astype(np.int64))
        assert lsb[same].max() <= 1


def test_zoom_path_shared_reference_orbit(monkeypatch):
    # twin of tests/test_deepzoom.py::test_zoom_path_shared_reference_orbit:
    # every frame against ONE reference orbit at the final (deepest) center
    # via the shift mechanism, and the final frame bit-identical to a
    # standalone render
    end_cx, end_cy = "-0.74364388703715158", "0.13182590420531198"
    W, H, MI, FRAMES = 32, 24, 600, 6
    calls = []
    orig = deep_zoom.orbit_mod.compute_orbit

    def counting(*a, **kw2):
        calls.append(1)
        return orig(*a, **kw2)

    monkeypatch.setattr(deep_zoom.orbit_mod, "compute_orbit", counting)
    cache = {}
    last = None
    for f in range(FRAMES):
        t = f / (FRAMES - 1)
        zoom = math.exp(math.log(1e-5)
                        + t * (math.log(1e-9) - math.log(1e-5)))
        cx = float(end_cx) + (1 - t) * 3e-6  # center moves per frame
        s = Scene(fractal_type=FractalType.DEEP_ZOOM,
                  hp_center_x=repr(cx) if t < 1 else end_cx,
                  hp_center_y=end_cy, hp_zoom=repr(zoom),
                  max_iterations=MI, use_perturbation=True)
        n, zx, zy, g, info = deep_zoom.render_fields(
            s, W, H, ref_center=(end_cx, end_cy), orbit_cache=cache,
            device="cpu")
        assert info["glitched_pixels_remaining"] == 0
        assert np.isfinite(zx).all()
        last = n
    assert len(calls) <= 2, f"{len(calls)} orbit computations for {FRAMES}"
    s_end = Scene(fractal_type=FractalType.DEEP_ZOOM, hp_center_x=end_cx,
                  hp_center_y=end_cy, hp_zoom=repr(1e-9), max_iterations=MI,
                  use_perturbation=True)
    n_alone, *_ = deep_zoom.render_fields(s_end, W, H, device="cpu")
    np.testing.assert_array_equal(last, n_alone)


def test_manager_precision_and_depth():
    m = manager.DeepZoomManager()
    m.state.zoom = 1e-16
    m.update_precision_mode()
    assert m.state.precision_mode == hp.PrecisionMode.QUAD
    assert m.state.high_precision_enabled
    m.update(0.0)
    assert m.state.zoom_depth_level == 3
    m.state.zoom = 1e-8
    m.update(0.0)
    assert m.state.zoom_depth_level == 1
    # estimate formula (deep_zoom_system.cpp:200-202)
    assert m.state.estimated_render_time == pytest.approx(
        m.state.max_iterations * 0.001 * 1 * 1.5)


def test_manager_zoom_path_animation():
    m = manager.DeepZoomManager()
    m.state.use_perturbation = False  # skip orbit computation in update
    m.zoom_to(-0.75, 0.1, 1e-6, duration=2.0)
    # First update consumes the zero-duration start keyframe (the reference
    # resets the clock on keyframe advance, deep_zoom_system.cpp:498-516).
    m.update(1.0)
    assert m.state.zoom_animating and m.state.zoom == pytest.approx(2.0)
    m.update(1.0)  # halfway through the second keyframe
    assert m.state.zoom == pytest.approx(
        math.exp(math.log(2.0) + 0.5 * (math.log(1e-6) - math.log(2.0))))
    m.update(2.5)
    assert not m.state.zoom_animating
    assert m.state.zoom == pytest.approx(1e-6)
    assert m.state.zoom_progress == 1.0


def test_manager_export_and_presets():
    m = manager.DeepZoomManager()
    txt = m.export_coordinates()
    assert "Center X" in txt and "Iterations" in txt
    path = manager.preset_zoom_path("Seahorse")
    assert len(path) == 2 and path[1].zoom == 1e-6
    s = m.to_scene()
    assert s.fractal_type.name == "DEEP_ZOOM"


@pytest.mark.parametrize("name", ["Seahorse", "elephant", "Mini"])
def test_manager_follows_the_jax_manager(name):
    # the same preset played with the same clock: identical states, and
    # the same reference orbit at each keyframe's end
    mine, ref = manager.DeepZoomManager(), jax_manager.DeepZoomManager()
    for m in (mine, ref):
        m.state.max_iterations = 200
    tgt = next(t for t in manager.DEEP_ZOOM_PRESETS
               if t.name.lower().startswith(name.lower()))
    mine.play_preset(tgt)
    ref.play_preset(next(t for t in jax_manager.DEEP_ZOOM_PRESETS
                         if t.name == tgt.name))
    assert manager.preset_zoom_path(name) == [
        manager.ZoomKeyframe(**vars(k))
        for k in jax_manager.preset_zoom_path(name)]
    for dt in (0.5, 0.5, tgt.duration / 3, tgt.duration / 3,
               tgt.duration):
        mine.update(dt)
        ref.update(dt)
        a, b = vars(mine.state), vars(ref.state)
        assert {k: (v.name if hasattr(v, "name") else v)
                for k, v in a.items()} == \
            {k: (v.name if hasattr(v, "name") else v) for k, v in b.items()}
    assert not mine.state.zoom_animating
    np.testing.assert_array_equal(mine.reference_orbit, ref.reference_orbit)
    assert mine.export_coordinates() == ref.export_coordinates()
