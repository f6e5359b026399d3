"""The port's animation subsystem (``anim/``), its batch pipeline
(``models/common.batch_render_fn``) and its ``animate`` and ``encode``
verbs on the CPU device: twins of tests/test_anim.py, tests/test_qtpng.py
and the animate/encode tests of tests/test_cli.py, each run through the
port and the JAX package on the same seed-made inputs.

Interpolated scenes are equal field for field, ``.franim`` files load
across the two packages both ways, the qtpng muxer writes the same bytes
and the ffmpeg command lines are equal.  A frame of a batch is the single
render of its scene bit for bit; rendered frames hold against
``render_numpy`` at atol 1e-5 and against the JAX renderer's frames under
test_torch_render.py's bound (|diff| > 2e-2 on < 1% of pixels, on PNGs 5
LSB of 255).
"""
import json
import math
import os

import numpy as np
import pytest
import torch

import fractalrenderer_tpu as fr
from fractalrenderer_tpu import cli as jax_cli
from fractalrenderer_tpu.anim import franim as jax_franim
from fractalrenderer_tpu.anim import keyframes as jax_kf
from fractalrenderer_tpu.anim import qtpng as jax_qtpng
from fractalrenderer_tpu.anim import renderer as jax_renderer
from fractalrenderer_tpu.anim import video as jax_video
from fractalrenderer_tpu.models import common as jax_common
from fractalrenderer_tpu.utils.png import read_png
from fractalrenderer_tpu.utils.png import write_png as jax_write_png
from fractalrenderer_tpu_torch import FractalType, Scene, cli, models
from fractalrenderer_tpu_torch.anim import (AnimationRenderer, franim,
                                            qtpng, renderer, video)
from fractalrenderer_tpu_torch.anim.keyframes import (Animation,
                                                      InterpolationType,
                                                      Keyframe, Playback,
                                                      apply_easing)
from fractalrenderer_tpu_torch.models import common
from fractalrenderer_tpu_torch.utils.image import to_export_orientation
from fractalrenderer_tpu_torch.utils.png import write_png


def _strip_time(buf: bytes) -> bytes:
    """A PNG file's bytes without its tIME chunk (length, tag, 7 bytes,
    CRC): the one chunk that depends on the clock."""
    i = buf.find(b"tIME")
    return buf if i < 0 else buf[:i - 4] + buf[i + 4 + 7 + 4:]


def _jax_scene(scene):
    return fr.Scene.from_dict(json.loads(scene.to_json()))


def _fields(scene):
    return json.loads(scene.to_json())


def _jax_anim(anim):
    """The same animation built from the JAX package's classes."""
    j = jax_kf.Animation(name=anim.name, description=anim.description,
                         duration=anim.duration, loop=anim.loop,
                         target_fps=anim.target_fps,
                         export_width=anim.export_width,
                         export_height=anim.export_height)
    for k in anim.keyframes:
        j.keyframes.append(jax_kf.Keyframe(
            k.time, _jax_scene(k.scene),
            jax_kf.InterpolationType(int(k.interp_type))))
    return j


def _bad_fraction(a, b, tol):
    return (np.abs(a.astype(np.float64) - b.astype(np.float64))
            > tol).any(axis=-1).mean()


def make_zoom_anim():
    a = Animation(duration=10.0, target_fps=30)
    a.keyframes.append(Keyframe(0.0, Scene(center_x=-0.5, zoom=2.5,
                                           max_iterations=256),
                                InterpolationType.LINEAR))
    a.keyframes.append(Keyframe(10.0, Scene(center_x=-0.74, zoom=0.008,
                                            max_iterations=1024),
                                InterpolationType.LINEAR))
    return a


def _random_anim(seed):
    """Three keyframes of seed-made views, colours and iteration counts,
    with every easing."""
    rng = np.random.default_rng(seed)
    a = Animation(duration=6.0, target_fps=4)
    for t in (0.0, 2.5, 6.0):
        a.keyframes.append(Keyframe(t, Scene(
            center_x=float(rng.uniform(-1.5, 0.5)),
            center_y=float(rng.uniform(-0.8, 0.8)),
            zoom=float(10 ** rng.uniform(-3, 0.5)),
            max_iterations=int(rng.integers(32, 1500)),
            palette_mode=int(rng.integers(0, 6)),
            color_offset=float(rng.uniform(0, 1)),
            color_scale=float(rng.uniform(0.5, 3)),
            color_brightness=float(rng.uniform(0.5, 1.5)),
            rotation_y=float(rng.uniform(-1, 1)),
            bailout=float(rng.uniform(2, 16))),
            InterpolationType(int(rng.integers(0, 5)))))
    return a


# -- keyframes ---------------------------------------------------------------
def test_easing_matches_reference():
    # animation_system.cpp:200-212
    assert apply_easing(0.25, InterpolationType.EASE_IN_OUT) == pytest.approx(
        2 * 0.25 * 0.25)
    assert apply_easing(0.75, InterpolationType.EASE_IN_OUT) == pytest.approx(
        1 - (-2 * 0.75 + 2) ** 2 / 2)
    assert apply_easing(0.5, InterpolationType.EASE_IN) == 0.25
    assert apply_easing(0.5, InterpolationType.EASE_OUT) == 0.75
    assert apply_easing(0.5, InterpolationType.EXPONENTIAL) == 0.25
    assert apply_easing(0.3, InterpolationType.LINEAR) == 0.3
    ts = np.random.default_rng(5).uniform(0, 1, 64)
    for kind in InterpolationType:
        for t in ts:
            assert apply_easing(float(t), kind) == jax_kf.apply_easing(
                float(t), jax_kf.InterpolationType(int(kind)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interpolated_scenes_equal_jax_field_for_field(seed):
    a = _random_anim(seed)
    j = _jax_anim(a)
    times = np.random.default_rng(seed + 100).uniform(-1, 7, 40)
    for t in [*times, 0.0, 2.5, 6.0]:
        assert _fields(a.interpolate(float(t))) == _fields(
            j.interpolate(float(t))), t
    assert a.total_frames == j.total_frames == 24
    assert [a.frame_time(f) for f in range(24)] == [
        j.frame_time(f) for f in range(24)]


def test_log_zoom_interpolation():
    # animation_system.cpp:131-145
    a = make_zoom_anim()
    s = a.interpolate(5.0)
    want = math.exp(math.log(2.5) + 0.5 * (math.log(0.008) - math.log(2.5)))
    assert s.zoom == pytest.approx(want)
    assert s.center_x == pytest.approx(-0.5 + 0.5 * (-0.74 + 0.5))
    assert _fields(s) == _fields(_jax_anim(a).interpolate(5.0))


def test_stepped_iterations():
    # animation_system.cpp:147-161: buckets at t<0.33 / <0.67 / else
    a = make_zoom_anim()
    assert a.interpolate(1.0).max_iterations == 256
    assert a.interpolate(5.0).max_iterations == 640  # midpoint
    assert a.interpolate(9.0).max_iterations == 1024


def test_palette_switch_at_half():
    a = Animation(duration=2.0)
    a.keyframes.append(Keyframe(0.0, Scene(palette_mode=1),
                                InterpolationType.LINEAR))
    a.keyframes.append(Keyframe(2.0, Scene(palette_mode=4),
                                InterpolationType.LINEAR))
    assert a.interpolate(0.9).palette_mode == 1
    assert a.interpolate(1.1).palette_mode == 4


def test_key1_fields_and_close_keyframes():
    a = Animation(duration=1.0)
    a.keyframes.append(Keyframe(0.0, Scene(bailout=8.0, antialiasing_samples=4,
                                           orbit_trap_enabled=True,
                                           julia_c_real=0.123)))
    a.keyframes.append(Keyframe(1.0, Scene(bailout=2.0)))
    s = a.interpolate(0.7)
    assert s.bailout == 8.0 and s.antialiasing_samples == 4
    assert s.orbit_trap_enabled and s.julia_c_real == 0.123
    assert _fields(s) == _fields(_jax_anim(a).interpolate(0.7))
    b = Animation(duration=1.0)
    b.keyframes.append(Keyframe(0.5, Scene(zoom=1.0)))
    b.keyframes.append(Keyframe(0.5004, Scene(zoom=99.0)))
    assert b.interpolate(0.5002).zoom == 1.0


def test_add_keyframe_sorts_and_extends_duration():
    a = Animation(duration=1.0)
    a.add_keyframe(5.0, Scene())
    a.add_keyframe(2.0, Scene())
    assert [k.time for k in a.keyframes] == [2.0, 5.0]
    assert a.duration == 6.0  # time + 1 (animation_system.cpp:20-22)


def test_playback_loop_and_stop():
    a = make_zoom_anim()
    a.loop = False
    p = Playback(a)
    p.play()
    assert p.playing
    p.update(12.0)
    assert not p.playing and p.current_time == a.duration
    a.loop = True
    p2 = Playback(a)
    p2.play()
    p2.update(12.0)
    assert p2.playing and p2.current_time == pytest.approx(2.0)
    j = jax_kf.Playback(_jax_anim(a))
    j.play()
    p3 = Playback(a)
    p3.play()
    for dt in np.random.default_rng(3).uniform(0, 4, 10):
        assert _fields(p3.update(float(dt))) == _fields(j.update(float(dt)))


def test_interpolate_hp_fields_move_per_frame():
    from fractions import Fraction

    s1 = Scene(fractal_type=FractalType.DEEP_ZOOM, hp_center_x="-0.75",
               hp_center_y="0.1", hp_zoom="1e-8", max_iterations=500)
    s2 = s1.with_(hp_center_x="-0.7500000000000001", hp_zoom="1e-12")
    a = Animation(duration=2.0, target_fps=1)
    a.keyframes.append(Keyframe(0.0, s1, InterpolationType.LINEAR))
    a.keyframes.append(Keyframe(2.0, s2, InterpolationType.LINEAR))

    mid = a.interpolate(1.0)
    assert mid.hp_zoom not in (s1.hp_zoom, s2.hp_zoom)
    zt = float(Fraction(mid.hp_zoom))
    assert abs(zt - 1e-10) / 1e-10 < 1e-12
    cx = Fraction(mid.hp_center_x)
    assert cx == (Fraction("-0.75") + Fraction("-0.7500000000000001")) / 2
    j = _jax_anim(a)
    for t in (0.0, 0.37, 1.0, 1.61, 2.0):
        assert _fields(a.interpolate(t)) == _fields(j.interpolate(t))


def test_interpolate_clamps_outside_keyframe_span():
    a = Animation(duration=10.0, target_fps=1)
    a.keyframes.append(Keyframe(5.0, Scene(zoom=2.0, center_x=-1.0),
                                InterpolationType.EASE_IN_OUT))
    a.keyframes.append(Keyframe(8.0, Scene(zoom=0.5, center_x=0.5),
                                InterpolationType.EASE_IN_OUT))
    before = a.interpolate(0.0)
    assert before.zoom == 2.0 and before.center_x == -1.0
    after = a.interpolate(10.0)
    assert after.zoom == 0.5 and after.center_x == 0.5


# -- .franim -----------------------------------------------------------------
def test_franim_roundtrip(tmp_path):
    a = make_zoom_anim()
    a.name = "test"
    a.export_width, a.export_height = 640, 360
    path = str(tmp_path / "a.franim")
    franim.save(a, path)
    b = franim.load(path)
    assert b.name == "test" and b.duration == 10.0
    assert b.export_width == 640
    assert len(b.keyframes) == 2
    assert b.keyframes[1].scene.zoom == pytest.approx(0.008)
    assert b.keyframes[1].scene.max_iterations == 1024
    d = json.loads(open(path).read())
    kf = d["keyframes"][0]
    for f in ("center_x", "center_y", "zoom", "max_iterations",
              "palette_mode", "color_offset", "color_scale", "time",
              "interp_type", "bailout", "antialiasing_samples",
              "orbit_trap_enabled", "orbit_trap_radius"):
        assert f in kf, f


def _mixed_anim():
    a = Animation(name="mixed", duration=3.0, target_fps=2,
                  export_width=32, export_height=24)
    a.keyframes.append(Keyframe(0.0, Scene(
        fractal_type=FractalType.JULIA, julia_c_real=-0.4,
        julia_c_imag=0.6, max_iterations=48), InterpolationType.LINEAR))
    # a frame at a keyframe's time takes the segment that ends there
    a.keyframes.append(Keyframe(0.75, Scene(
        fractal_type=FractalType.MANDELBULB, max_iterations=8,
        rotation_y=0.5)))
    dz = Scene(fractal_type=FractalType.DEEP_ZOOM, use_perturbation=True,
               hp_center_x="-0.743643887037151",
               hp_center_y="0.13182590420533", hp_zoom="3e-5",
               max_iterations=1000)
    a.keyframes.append(Keyframe(1.75, dz, InterpolationType.EASE_OUT))
    a.keyframes.append(Keyframe(3.0, dz.with_(hp_zoom="1e-5")))
    return a


@pytest.mark.parametrize("anim", ["zoom", "mixed", "random"])
def test_franim_loads_across_packages(tmp_path, anim):
    # a .franim written by either package loads in the other, with the
    # same keyframes; both write the same file for the same animation
    a = {"zoom": make_zoom_anim, "mixed": _mixed_anim,
         "random": lambda: _random_anim(4)}[anim]()
    mine, theirs = str(tmp_path / "port.franim"), str(tmp_path / "jax.franim")
    franim.save(a, mine)
    jax_franim.save(_jax_anim(a), theirs)
    assert open(mine).read() == open(theirs).read()
    for back, path in ((jax_franim.load, mine), (franim.load, theirs)):
        b = back(path)
        assert [k.time for k in b.keyframes] == [k.time for k in a.keyframes]
        assert [int(k.interp_type) for k in b.keyframes] == [
            int(k.interp_type) for k in a.keyframes]
        for kb, ka in zip(b.keyframes, a.keyframes):
            assert _fields(kb.scene) == _fields(ka.scene)
        assert (b.duration, b.target_fps, b.export_width,
                b.export_height) == (a.duration, a.target_fps,
                                     a.export_width, a.export_height)


def test_franim_malformed_inputs_raise_valueerror(tmp_path):
    for bad in ('{"keyframes": "x"}', "[1, 2, 3]", '"str"',
                '{"keyframes": [{"zoom": "abc", "time": 0}]}',
                '{"keyframes": [{"time": 0, "extra": 7}]}',
                '{"keyframes": [{"zoom": 1.0}]}',        # missing time
                '{"keyframes": [{"time": 0, "extra": '
                '{"fractal_type": "nope"}}]}'):
        p = tmp_path / "bad.franim"
        p.write_text(bad)
        with pytest.raises(ValueError):
            franim.load(str(p))
        with pytest.raises(ValueError):
            jax_franim.load(str(p))
    p = tmp_path / "ok.franim"
    p.write_text('{"keyframes": [{"time": 0.0, "zoom": 2.0},'
                 ' {"time": 1.0, "zoom": 1.0}]}')
    a = franim.load(str(p))
    assert len(a.keyframes) == 2 and a.keyframes[0].scene.zoom == 2.0


def test_franim_loads_reference_sample():
    # The sample shipped at the reference repo root (6 keyframes, 20 s,
    # 2560x1440 @ 120 fps), checked out beside this repository where the
    # JAX original looks for it
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(os.path.dirname(repo), "reference", "FractalRenderer",
                        ".franim")
    if not os.path.exists(path):
        pytest.skip("reference sample not available")
    a = franim.load(path)
    assert a.duration == 20.0
    assert a.target_fps == 120
    assert (a.export_width, a.export_height) == (2560, 1440)
    assert len(a.keyframes) == 6
    s = a.interpolate(2.5)
    assert 0.008 < s.zoom < 2.5
    assert a.total_frames == 2400


def test_franim_roundtrip_preserves_hp_fields(tmp_path):
    s = Scene(fractal_type=FractalType.DEEP_ZOOM, use_perturbation=True,
              hp_center_x="-0.743643887037151001882355212130",
              hp_center_y="0.131825904205311970493132056385",
              hp_zoom="1e-25", max_iterations=5000)
    a = Animation(duration=1.0, target_fps=1)
    a.keyframes.append(Keyframe(0.0, s))
    a.keyframes.append(Keyframe(1.0, s.with_(hp_zoom="1e-26")))
    path = str(tmp_path / "deep.franim")
    franim.save(a, path)
    b = franim.load(path)
    r = b.keyframes[0].scene
    assert r.hp_center_x == s.hp_center_x
    assert r.hp_center_y == s.hp_center_y
    assert r.hp_zoom == "1e-25" and r.use_perturbation
    assert b.keyframes[1].scene.hp_zoom == "1e-26"
    assert jax_franim.load(path).keyframes[1].scene.hp_zoom == "1e-26"


# -- the batch pipeline --------------------------------------------------------
def test_batch_render_fn_quantize_matches_host():
    """batch_render_fn(quantize=8/16) produces exactly the bytes
    utils.png._prepare_rows derives from the f32 batch, and the JAX
    quantize_image's bytes."""
    s = Scene(max_iterations=48)
    cfg = common.scene_static_cfg(s, 32, 24, "mandelbrot", "pixel", False,
                                  device="cpu")
    dyn = common.scene_dyn_params(s)
    batch = {k: np.asarray([v, v], np.float32) for k, v in dyn.items()}
    f32 = common.batch_render_fn(cfg)(batch)
    assert f32.shape == (2, 24, 32, 3) and f32.dtype == torch.float32
    f32 = f32.numpy()
    for depth, dt, scale in ((8, np.uint8, 255.0), (16, np.uint16, 65535.0)):
        q = common.batch_render_fn(cfg, quantize=depth)(batch).numpy()
        assert q.dtype == dt
        ref = (np.clip(f32, 0.0, 1.0) * scale + 0.5).astype(dt)
        np.testing.assert_array_equal(q, ref)
        np.testing.assert_array_equal(q, np.asarray(
            jax_common.quantize_image(f32, bit_depth=depth)))
        assert common.planar_export_ok(cfg)
        qp = common.batch_render_fn(cfg, quantize=depth,
                                    planar=True)(batch).numpy()
        assert qp.shape == (2, 3, 24, 32) and qp.dtype == dt
        np.testing.assert_array_equal(np.moveaxis(qp, 1, 3), ref)


def test_planar_export_eligibility_and_band_fn():
    trap = Scene(max_iterations=32, orbit_trap_enabled=True)
    cfg_trap = common.scene_static_cfg(trap, 16, 8, "mandelbrot", "pixel",
                                       False, device="cpu")
    assert not common.planar_export_ok(cfg_trap)
    with pytest.raises(ValueError):
        common.band_render_fn(cfg_trap, 8, 8, planar_quantize=8)
    with pytest.raises(ValueError, match="planar batch export"):
        common.batch_render_fn(cfg_trap, quantize=8, planar=True)
    aa = Scene(max_iterations=32, antialiasing_samples=2)
    cfg_aa = common.scene_static_cfg(aa, 16, 8, "mandelbrot", "pixel",
                                     False, device="cpu")
    assert not common.planar_export_ok(cfg_aa)
    s = Scene(max_iterations=32)
    cfg = common.scene_static_cfg(s, 16, 8, "mandelbrot", "pixel", False,
                                  device="cpu")
    with pytest.raises(ValueError, match="planar batch export"):
        common.batch_render_fn(cfg, quantize=0, planar=True)
    dyn = {k: np.float32(v) for k, v in common.scene_dyn_params(s).items()}
    f32 = common.render_fn(cfg)(dyn).numpy()
    planes = common.band_render_fn(cfg, 8, 8, planar_quantize=16)(dyn, 0)
    ref = (np.clip(f32, 0.0, 1.0) * 65535.0 + 0.5).astype(np.uint16)
    np.testing.assert_array_equal(np.moveaxis(planes.numpy(), 0, 2), ref)


# the families and options of the batch path: (family, scene fields)
BATCH_CASES = {
    "mandelbrot": (FractalType.MANDELBROT, {}),
    "mandelbrot-trap-aa2": (FractalType.MANDELBROT, dict(
        orbit_trap_enabled=True, interior_style=2, antialiasing_samples=2)),
    "julia": (FractalType.JULIA, dict(julia_c_real=-0.8,
                                      julia_c_imag=0.156)),
    "burning-ship-stripes": (FractalType.BURNING_SHIP, dict(
        stripe_enabled=True, interior_style=2, orbit_trap_enabled=True)),
    "phoenix": (FractalType.PHOENIX, dict(phoenix_r=-0.4, phoenix_p=0.1)),
}


def _batch_anim(ft, extra, w=40, h=22):
    """Four frames zooming off-axis, the iteration limit stepping from 64
    to 500 under the animation's cap (500, where a single render buckets
    to 256 or 512)."""
    a = Animation(duration=4.0, target_fps=1, export_width=w,
                  export_height=h)
    a.keyframes.append(Keyframe(0.0, Scene(
        fractal_type=ft, center_x=-0.3, center_y=0.35, zoom=1.6,
        max_iterations=64, **extra), InterpolationType.LINEAR))
    a.keyframes.append(Keyframe(4.0, Scene(
        fractal_type=ft, center_x=-0.55, center_y=0.55, zoom=0.3,
        max_iterations=500, **extra), InterpolationType.LINEAR))
    return a


@pytest.mark.parametrize("quantize,planar", [(0, False), (8, False),
                                             (8, True), (16, True)])
@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_batch_frames_equal_single_renders(case, quantize, planar):
    # the animation's cap fixes max_iter while iter_limit steps per frame,
    # and the batch holds np.float32 values: each frame still equals the
    # single render of its scene (bucketed cap, Python floats) bit for bit
    ft, extra = BATCH_CASES[case]
    a = _batch_anim(ft, extra)
    scenes = [a.interpolate(a.frame_time(f)) for f in range(a.total_frames)]
    assert {s.max_iterations for s in scenes} == {64, 282, 500}
    cap = max(s.max_iterations for s in scenes)
    cfg = renderer._static_key(scenes[0], 40, 22, cap, "cpu")
    assert cfg.max_iter == 500
    if planar and not common.planar_export_ok(cfg):
        with pytest.raises(ValueError):
            common.batch_render_fn(cfg, quantize=quantize, planar=planar)
        return
    dyns = [common.scene_dyn_params(s) for s in scenes]
    batch = {k: np.asarray([d[k] for d in dyns], np.float32)
             for k in dyns[0]}
    out = common.batch_render_fn(cfg, quantize=quantize, planar=planar)(batch)
    assert out.shape[0] == 4
    for i, s in enumerate(scenes):
        ref = models.render(s, 40, 22, device="cpu", quantize=quantize)
        got = out[i].permute(1, 2, 0) if planar else out[i]
        assert got.dtype == ref.dtype and torch.equal(got, ref), i


def test_render_animation_frames_cpu():
    a = make_zoom_anim()
    a.export_width, a.export_height = 48, 24
    a.target_fps = 1  # 10 frames
    out = renderer.render_animation_frames(a, frames=[0, 5, 9],
                                           device="cpu")
    assert out.shape == (3, 24, 48, 3) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    assert (out[0] - out[2]).abs().max() > 0.05
    jax_out = jax_renderer.render_animation_frames(_jax_anim(a),
                                                   frames=[0, 5, 9])
    for i, f in enumerate([0, 5, 9]):
        s = a.interpolate(a.frame_time(f))
        ref = fr.render_numpy(_jax_scene(s), 48, 24)
        np.testing.assert_allclose(out[i].numpy(), ref, rtol=0, atol=1e-5)
        assert _bad_fraction(out[i].numpy(), np.asarray(jax_out[i]),
                             2e-2) < 0.01


def _read_frames(folder):
    return {f: read_png(os.path.join(folder, f))
            for f in sorted(os.listdir(folder)) if f.endswith(".png")}


def test_animation_renderer_writes_pngs(tmp_path):
    from fractalrenderer_tpu_torch.anim.renderer import RenderStatus

    a = make_zoom_anim()
    a.duration, a.target_fps = 4.0, 1  # 4 frames
    a.export_width, a.export_height = 48, 24
    r = AnimationRenderer(batch_size=3, device="cpu")
    seen = []
    r.on_frame_complete = lambda f, total: seen.append(f)
    ok = r.start_render(a, str(tmp_path / "port"))
    assert ok and r.progress.status == RenderStatus.COMPLETE
    assert sorted(seen) == [0, 1, 2, 3]
    mine = _read_frames(tmp_path / "port")
    assert mine["frame_000000.png"].shape == (24, 48, 3)
    # the JAX renderer's frames of the same animation
    assert jax_renderer.AnimationRenderer(batch_size=3).start_render(
        _jax_anim(a), str(tmp_path / "jax"))
    ref = _read_frames(tmp_path / "jax")
    assert list(mine) == list(ref)
    for name in mine:
        assert _bad_fraction(mine[name], ref[name], 5) < 0.01, name


@pytest.mark.parametrize("bit_depth", [8, 16])
def test_animation_frames_are_flipped_single_renders(tmp_path, bit_depth):
    # off-axis frames of a batch (two chunks, the last short) are the
    # quantized single renders flipped once for export
    a = _batch_anim(FractalType.MANDELBROT, {}, 36, 20)
    r = AnimationRenderer(batch_size=3, device="cpu")
    assert r.start_render(a, str(tmp_path), bit_depth=bit_depth)
    for f in range(a.total_frames):
        s = a.interpolate(a.frame_time(f))
        want = to_export_orientation(models.render(
            s, 36, 20, device="cpu", quantize=bit_depth)).numpy()
        got = read_png(str(tmp_path / f"frame_{f:06d}.png"))
        np.testing.assert_array_equal(got, want)
        assert not np.array_equal(got, want[::-1])


def test_animation_renderer_needs_two_keyframes(tmp_path):
    a = Animation()
    a.keyframes.append(Keyframe(0.0, Scene()))
    errs = []
    r = AnimationRenderer(device="cpu")
    r.on_render_error = errs.append
    assert not r.start_render(a, str(tmp_path))
    assert errs and "2 keyframes" in errs[0]


def test_animation_renderer_takes_a_mesh(tmp_path):
    # AnimationRenderer(mesh=...): 5 frames in chunks of 2 over 2 frame
    # groups of 2 rows (the last chunk padded to the batch size), 16-bit,
    # each PNG the unsharded renderer's
    from fractalrenderer_tpu_torch.parallel import make_render_mesh

    a = Animation(duration=5.0, target_fps=1, export_width=40,
                  export_height=18)
    a.keyframes.append(Keyframe(0.0, Scene(max_iterations=24, zoom=2.5)))
    a.keyframes.append(Keyframe(5.0, Scene(max_iterations=40, zoom=0.6,
                                           center_x=-0.7)))
    mesh = make_render_mesh(devices=[torch.device("cpu")] * 4, frames=2)
    r = AnimationRenderer(batch_size=2, device="cpu", mesh=mesh)
    assert r.mesh is mesh
    assert r.start_render(a, str(tmp_path / "m"), bit_depth=16)
    assert AnimationRenderer(batch_size=2, device="cpu").start_render(
        a, str(tmp_path / "s"), bit_depth=16)
    mine, ref = _read_frames(tmp_path / "m"), _read_frames(tmp_path / "s")
    assert list(mine) == list(ref) and len(mine) == 5
    for name in mine:
        assert mine[name].dtype == np.uint16
        np.testing.assert_array_equal(mine[name], ref[name])


def test_palette_switch_splits_groups(tmp_path):
    a = Animation(duration=4.0, target_fps=1, export_width=32,
                  export_height=16)
    a.keyframes.append(Keyframe(0.0, Scene(max_iterations=16, palette_mode=0),
                                InterpolationType.LINEAR))
    a.keyframes.append(Keyframe(4.0, Scene(max_iterations=16, palette_mode=3),
                                InterpolationType.LINEAR))
    r = AnimationRenderer(batch_size=4, device="cpu")
    assert r.start_render(a, str(tmp_path))
    first = read_png(str(tmp_path / "frame_000000.png"))
    last = read_png(str(tmp_path / "frame_000003.png"))
    assert np.abs(first.astype(int) - last.astype(int)).max() > 20


def test_mandelbulb_animation_fallback(tmp_path):
    a = Animation(duration=2.0, target_fps=1, export_width=24,
                  export_height=12)
    a.keyframes.append(Keyframe(0.0, Scene(
        fractal_type=FractalType.MANDELBULB, max_iterations=8,
        rotation_y=0.0)))
    a.keyframes.append(Keyframe(2.0, Scene(
        fractal_type=FractalType.MANDELBULB, max_iterations=8,
        rotation_y=1.0)))
    r = AnimationRenderer(device="cpu")
    assert r.start_render(a, str(tmp_path))
    assert len(os.listdir(tmp_path)) == 2
    # frame 1 runs the bulb's clock at its frame time
    s = a.interpolate(1.0).with_(time=1.0)
    want = to_export_orientation(models.render(s, 24, 12, device="cpu",
                                               quantize=8)).numpy()
    np.testing.assert_array_equal(
        read_png(str(tmp_path / "frame_000001.png")), want)


def test_mixed_family_animation_routes_per_frame(tmp_path):
    a = Animation(duration=0.2, target_fps=10, export_width=24,
                  export_height=16)
    a.keyframes.append(Keyframe(0.0, Scene(fractal_type=FractalType.MANDELBROT,
                                           max_iterations=32),
                                InterpolationType.LINEAR))
    a.keyframes.append(Keyframe(0.2, Scene(fractal_type=FractalType.MANDELBULB,
                                           max_iterations=16),
                                InterpolationType.LINEAR))
    r = AnimationRenderer(device="cpu")
    out = tmp_path / "mixed"
    assert r.start_render(a, str(out))
    assert len(os.listdir(out)) == a.total_frames
    # the Mandelbrot frames against the JAX renderer's
    assert jax_renderer.AnimationRenderer().start_render(
        _jax_anim(a), str(tmp_path / "jax"))
    mine, ref = _read_frames(out), _read_frames(tmp_path / "jax")
    assert list(mine) == list(ref)
    assert _bad_fraction(mine["frame_000000.png"], ref["frame_000000.png"],
                         5) < 0.01


def test_mixed_franim_renders_each_family_per_frame(tmp_path, monkeypatch):
    # Julia, then Mandelbulb, then deep zoom: the per-frame branch, one
    # reference orbit for every deep-zoom frame, each frame the scene
    # rendered alone (within 1 LSB)
    from fractalrenderer_tpu_torch.deepzoom import orbit as orbit_mod

    a = _mixed_anim()
    path = str(tmp_path / "mixed.franim")
    jax_franim.save(_jax_anim(a), path)
    a = franim.load(path)
    batches = []
    monkeypatch.setattr(common, "batch_render_fn",
                        lambda *x, **k: batches.append(1))
    calls = []
    real = orbit_mod.compute_orbit

    def counting(*args, **kw):
        calls.append(kw.get("escape_mag_sq"))
        return real(*args, **kw)

    monkeypatch.setattr(orbit_mod, "compute_orbit", counting)
    out = tmp_path / "frames"
    assert cli.main(["animate", "--device", "cpu", "--franim", path,
                     "--out-dir", str(out)]) == 0
    assert not batches, "the batch branch ran"
    assert calls == [None], f"{len(calls)} orbit computations"
    kinds = [a.interpolate(a.frame_time(f)).fractal_type
             for f in range(a.total_frames)]
    assert kinds == [FractalType.JULIA] * 2 + [FractalType.MANDELBULB] * 2 \
        + [FractalType.DEEP_ZOOM] * 2
    for f in range(a.total_frames):
        s = a.interpolate(a.frame_time(f))
        if s.fractal_type == FractalType.MANDELBULB:
            s = s.with_(time=a.frame_time(f))
        want = to_export_orientation(models.render(s, 32, 24, device="cpu",
                                                   quantize=8)).numpy()
        got = read_png(str(out / f"frame_{f:06d}.png"))
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, f
        assert 0 < got.mean() < 255, f


def test_deep_zoom_animation_shares_reference_orbit(tmp_path, monkeypatch):
    from fractalrenderer_tpu_torch.models import deep_zoom

    a = Animation(duration=0.3, target_fps=10, export_width=24,
                  export_height=16)
    a.keyframes.append(Keyframe(0.0, Scene(
        fractal_type=FractalType.DEEP_ZOOM, center_x=-0.7436438870371,
        center_y=0.1318259042053, zoom=1e-5, max_iterations=300),
        InterpolationType.LINEAR))
    a.keyframes.append(Keyframe(0.3, Scene(
        fractal_type=FractalType.DEEP_ZOOM, center_x=-0.74364388703715,
        center_y=0.13182590420531, zoom=1e-8, max_iterations=300),
        InterpolationType.LINEAR))
    calls = []
    orig = deep_zoom.orbit_mod.compute_orbit

    def counting(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    monkeypatch.setattr(deep_zoom.orbit_mod, "compute_orbit", counting)
    r = AnimationRenderer(device="cpu")
    assert r.start_render(a, str(tmp_path / "dz"))
    assert len(calls) <= 2, f"{len(calls)} orbit computations"
    assert len(os.listdir(tmp_path / "dz")) == a.total_frames


def test_per_frame_animation_quantizes_like_f32(tmp_path):
    s = Scene(fractal_type=FractalType.DEEP_ZOOM, use_perturbation=True,
              hp_center_x="-0.743643887037151",
              hp_center_y="0.13182590420533",
              hp_zoom="1e-8", max_iterations=200)
    a = Animation(duration=1.0, target_fps=2)
    a.keyframes.append(Keyframe(0.0, s))
    a.keyframes.append(Keyframe(1.0, s.with_(hp_zoom="5e-9")))
    out = str(tmp_path / "frames")
    r = AnimationRenderer(device="cpu")
    assert r.start_render(a, out, 20, 12)
    got = read_png(os.path.join(out, "frame_000000.png"))
    ref_path = str(tmp_path / "ref.png")
    write_png(ref_path, to_export_orientation(
        models.render(s, 20, 12, device="cpu")).numpy(), bit_depth=8)
    np.testing.assert_array_equal(got, read_png(ref_path))


def test_animation_resume_skips_complete_frames(tmp_path):
    a = Animation(duration=4.0, target_fps=1, export_width=32,
                  export_height=16)
    a.keyframes.append(Keyframe(0.0, Scene(max_iterations=16, zoom=2.0)))
    a.keyframes.append(Keyframe(4.0, Scene(max_iterations=16, zoom=0.5)))
    out = str(tmp_path / "frames")
    r = AnimationRenderer(batch_size=2, device="cpu")
    assert r.start_render(a, out)
    total = a.total_frames
    paths = [os.path.join(out, f"frame_{f:06d}.png") for f in range(total)]
    originals = [open(q, "rb").read() for q in paths]
    with open(paths[1], "wb") as f:
        f.write(originals[1][:20])
    os.remove(paths[2])
    mtime0 = os.path.getmtime(paths[0])
    rendered = []
    r2 = AnimationRenderer(batch_size=2, device="cpu")
    r2.on_frame_complete = lambda f, t: rendered.append(f)
    assert r2.start_render(a, out, resume=True)
    assert set(rendered) == {1, 2}
    assert os.path.getmtime(paths[0]) == mtime0
    # the re-rendered frames equal the first render's but for the tIME
    # chunk, whose one-second stamp may differ between the two renders
    for q, orig in zip(paths, originals):
        new = open(q, "rb").read()
        assert b"tIME" in new and b"tIME" in orig
        assert _strip_time(new) == _strip_time(orig)
    # a frame of another size does not count as complete
    assert not renderer._frame_complete(paths[0], 16, 16, 8)
    assert renderer._frame_complete(paths[0], 32, 16, 8)


# -- video ---------------------------------------------------------------------
def test_ffmpeg_command_matrix():
    s = video.VideoEncodeSettings(output_filename="out.mp4",
                                  codec=video.VideoCodec.H264,
                                  quality=video.VideoQuality.HIGH, crf=20,
                                  fps=30)
    cmd = video.build_ffmpeg_command("frames", s)
    assert cmd[:5] == ["ffmpeg", "-y", "-framerate", "30", "-i"]
    assert cmd[5].endswith("frame_%06d.png")
    assert ["-c:v", "libx264"] == cmd[6:8]
    assert cmd[-5:] == ["-progress", "pipe:1", "-loglevel", "warning",
                        "out.mp4"]


@pytest.mark.parametrize("codec", [c for c in video.VideoCodec
                                   if c != video.VideoCodec.QTPNG],
                         ids=lambda c: c.value)
def test_ffmpeg_command_equals_jax(codec):
    # every quality, with and without audio, equal to the JAX command
    for quality in video.VideoQuality:
        for audio in ("", "music.wav"):
            kw = dict(output_filename="o.mov", fps=24, crf=21,
                      audio_file=audio)
            mine = video.build_ffmpeg_command("fr", video.VideoEncodeSettings(
                codec=codec, quality=quality, **kw))
            ref = jax_video.build_ffmpeg_command(
                "fr", jax_video.VideoEncodeSettings(
                    codec=jax_video.VideoCodec(codec.value),
                    quality=jax_video.VideoQuality(quality.value), **kw))
            assert mine == ref, (codec, quality, audio)


def test_encoder_graceful_without_frames(tmp_path):
    enc = video.VideoEncoder()
    s = video.VideoEncodeSettings(output_filename=str(tmp_path / "o.mp4"))
    ok = enc.encode(str(tmp_path), s)
    assert not ok
    assert enc.progress.finished
    assert ("No frames" in enc.progress.error
            or "FFmpeg not found" in enc.progress.error)


_FAKE_FFMPEG = r'''#!/usr/bin/env python3
import os, sys, time
args = sys.argv[1:]
assert "-i" in args, args
pattern = args[args.index("-i") + 1]
assert pattern.endswith("frame_%06d.png"), pattern
assert "-progress" in args and args[args.index("-progress") + 1] == "pipe:1"
out = args[-1]
assert not out.startswith("-"), f"output must be last: {args}"
if os.environ.get("FAKE_FFMPEG_FAIL"):
    sys.stderr.write("boom\n")
    sys.exit(1)
folder = os.path.dirname(pattern)
frames = sorted(f for f in os.listdir(folder) if f.startswith("frame_"))
for k in range(len(frames)):
    sys.stdout.write(f"frame={k + 1}\nfps={42.5}\nprogress=continue\n")
    sys.stdout.flush()
sys.stdout.write("progress=end\n")
with open(out, "wb") as fh:
    fh.write(b"\x00\x00\x00\x18ftypmp42fake")
sys.exit(0)
'''


@pytest.fixture
def fake_ffmpeg(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    exe = bindir / "ffmpeg"
    exe.write_text(_FAKE_FFMPEG)
    exe.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ.get('PATH', '')}")
    return exe


def _write_fake_frames(folder, n=5):
    os.makedirs(folder, exist_ok=True)
    for k in range(n):
        with open(os.path.join(folder, f"frame_{k:06d}.png"), "wb") as fh:
            fh.write(b"\x89PNG fake")


def test_video_encoder_end_to_end(fake_ffmpeg, tmp_path):
    frames = str(tmp_path / "frames")
    _write_fake_frames(frames, 5)
    out = str(tmp_path / "out.mp4")
    enc = video.VideoEncoder()
    seen = []
    enc.on_progress = lambda p: seen.append((p.current_frame, p.fps))
    ok = enc.encode(frames, video.VideoEncodeSettings(output_filename=out))
    assert ok and enc.progress.success and enc.progress.finished
    assert os.path.exists(out)
    assert enc.progress.current_frame == 5
    assert enc.progress.fps == pytest.approx(42.5)
    assert enc.progress.progress == pytest.approx(1.0)
    assert any(f == 3 for f, _ in seen)
    assert len(os.listdir(frames)) == 5


def test_video_encoder_cleanup_and_failure(fake_ffmpeg, tmp_path,
                                           monkeypatch):
    frames = str(tmp_path / "frames")
    _write_fake_frames(frames, 3)
    out = str(tmp_path / "v.mp4")
    enc = video.VideoEncoder()
    ok = enc.encode(frames, video.VideoEncodeSettings(
        output_filename=out, cleanup_frames=True,
        codec=video.VideoCodec.VP9, quality=video.VideoQuality.DRAFT))
    assert ok
    assert os.listdir(frames) == []
    _write_fake_frames(frames, 3)
    monkeypatch.setenv("FAKE_FFMPEG_FAIL", "1")
    enc2 = video.VideoEncoder()
    ok2 = enc2.encode(frames, video.VideoEncodeSettings(
        output_filename=str(tmp_path / "v2.mp4")))
    assert not ok2 and not enc2.progress.success
    assert "exited with code 1" in enc2.progress.error
    assert len(os.listdir(frames)) == 3


def test_cli_animate_encode_with_ffmpeg(fake_ffmpeg, tmp_path, capsys):
    out_dir = str(tmp_path / "frames")
    rc = cli.main(["animate", "--device", "cpu", "--width", "24",
                   "--height", "12", "--iters", "16", "--zoom-to", "1.0",
                   "--duration", "2", "--fps", "1", "--out-dir", out_dir,
                   "--encode"])
    assert rc == 0
    assert os.path.exists(os.path.join(out_dir, "animation.mp4"))
    assert "Encoded ->" in capsys.readouterr().out


def test_cli_animate_encode_fails_without_ffmpeg(tmp_path, capsys,
                                                 monkeypatch):
    # no ffmpeg on the PATH: any codec but qtpng fails as the JAX
    # encoder does, after the frames are written
    monkeypatch.setattr(video.shutil, "which", lambda name: None)
    monkeypatch.setattr(jax_video.shutil, "which", lambda name: None)
    argv = ["--width", "24", "--height", "12", "--iters", "16", "--zoom-to",
            "1.0", "--duration", "2", "--fps", "1", "--encode", "--codec",
            "h265"]
    rc = cli.main(["animate", "--device", "cpu", *argv, "--out-dir",
                   str(tmp_path / "p")])
    err = capsys.readouterr().err
    assert rc == jax_cli.main(["animate", *argv, "--out-dir",
                               str(tmp_path / "j")]) == 1
    assert err == capsys.readouterr().err
    assert "FFmpeg not found" in err
    assert len(os.listdir(tmp_path / "p")) == 2


# -- qtpng ---------------------------------------------------------------------
def _png_frames(folder, n=5, w=32, h=20, seed=3):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for k in range(n):
        p = os.path.join(folder, f"frame_{k:06d}.png")
        write_png(p, rng.random((h, w, 3)).astype(np.float32))
        paths.append(p)
    return paths


def test_png_frames_equal_the_jax_writer(tmp_path):
    # the qtpng twins below mux the port's PNGs: byte for byte the JAX
    # writer's for the same pixels
    rng = np.random.default_rng(11)
    img = rng.random((20, 32, 3)).astype(np.float32)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    write_png(a, img)
    jax_write_png(b, img)
    ra, rb = open(a, "rb").read(), open(b, "rb").read()
    assert b"IDAT" in ra and _strip_time(ra) == _strip_time(rb)
    assert len(_strip_time(ra)) == len(ra) - (19 if b"tIME" in ra else 0)


@pytest.mark.parametrize("n,fps", [(5, 30), (3, 24), (1, 60)])
def test_write_mov_bytes_equal_jax(tmp_path, n, fps):
    paths = _png_frames(tmp_path / "f", n=n, seed=n)
    mine, ref = str(tmp_path / "port.mov"), str(tmp_path / "jax.mov")
    info = qtpng.write_mov(mine, paths, fps=fps)
    assert info == jax_qtpng.write_mov(ref, paths, fps=fps)
    assert open(mine, "rb").read() == open(ref, "rb").read()
    dec, jdec = qtpng.read_mov(mine), jax_qtpng.read_mov(ref)
    assert dec == jdec and len(dec["frames"]) == n


def test_mov_byte_level_round_trip(tmp_path):
    paths = _png_frames(tmp_path / "f", n=6, w=40, h=24)
    out = str(tmp_path / "clip.mov")
    qtpng.write_mov(out, paths, fps=24)
    dec = qtpng.read_mov(out)
    assert (dec["width"], dec["height"]) == (40, 24)
    assert dec["fps"] == pytest.approx(24.0)
    assert dec["duration_s"] == pytest.approx(6 / 24, rel=1e-3)
    assert len(dec["frames"]) == 6
    for sample, p in zip(dec["frames"], paths):
        assert sample == open(p, "rb").read()
        back = tmp_path / "back.png"
        back.write_bytes(sample)
        np.testing.assert_array_equal(read_png(str(back)), read_png(p))


def test_read_mov_rejects_corruption(tmp_path):
    import struct

    paths = _png_frames(tmp_path / "f", n=3)
    out = str(tmp_path / "clip.mov")
    info = qtpng.write_mov(out, paths, fps=30)
    buf = bytearray(open(out, "rb").read())
    # the first sample begins where the sizes of ftyp and the mdat header
    # end
    (ftyp,) = struct.unpack(">I", bytes(buf[:4]))
    off = ftyp + 8
    assert bytes(buf[off:off + 8]) == b"\x89PNG\r\n\x1a\n"
    buf[off] ^= 0xFF
    bad = tmp_path / "bad.mov"
    bad.write_bytes(bytes(buf))
    for mod in (qtpng, jax_qtpng):
        with pytest.raises(ValueError, match="not a complete PNG"):
            mod.read_mov(str(bad))
    trunc = tmp_path / "trunc.mov"
    trunc.write_bytes(bytes(buf[:-20]))
    with pytest.raises(ValueError):
        qtpng.read_mov(str(trunc))
    assert info["frames"] == 3


def test_encoder_qtpng_codec_path(tmp_path):
    _png_frames(tmp_path / "frames", n=4)
    enc = video.VideoEncoder()
    seen = []
    enc.on_progress = lambda p: seen.append(p.current_frame)
    ok = enc.encode(str(tmp_path / "frames"), video.VideoEncodeSettings(
        output_filename=str(tmp_path / "out.mp4"),
        codec=video.VideoCodec.QTPNG, fps=24, cleanup_frames=True))
    assert ok and enc.progress.success
    assert enc.progress.current_frame == 4
    out = str(tmp_path / "out.mov")
    assert os.path.exists(out)
    assert os.listdir(tmp_path / "frames") == []
    assert open(out, "rb").read(12)[4:] == b"ftypqt  "


def test_cli_animate_encode_qtpng(tmp_path):
    """animate --encode --codec qtpng: the whole pipeline, no ffmpeg."""
    out_dir = str(tmp_path / "frames")
    video_out = str(tmp_path / "zoom.mov")
    rc = cli.main(["animate", "--device", "cpu", "--width", "48",
                   "--height", "24", "--iters", "24", "--zoom-to", "1.0",
                   "--duration", "0.05", "--fps", "60",
                   "--out-dir", out_dir, "--encode",
                   "--video-out", video_out, "--codec", "qtpng"])
    assert rc == 0
    buf = open(video_out, "rb").read()
    assert buf[4:12] == b"ftypqt  "
    assert b"moov" in buf and b"png " in buf
    dec = qtpng.read_mov(video_out)
    assert len(dec["frames"]) == 3
    assert dec["frames"][0] == open(os.path.join(
        out_dir, "frame_000000.png"), "rb").read()


def test_qtpng_rejects_garbage(tmp_path):
    bad = tmp_path / "x.png"
    bad.write_bytes(b"not a png")
    with pytest.raises(ValueError):
        qtpng.write_mov(str(tmp_path / "o.mov"), [str(bad)], 30)
    enc = video.VideoEncoder()
    ok = enc.encode(str(tmp_path), video.VideoEncodeSettings(
        codec=video.VideoCodec.QTPNG,
        output_filename=str(tmp_path / "o.mov")))
    assert not ok and "No frames" in enc.progress.error


def test_mov_rejects_over_4gib(tmp_path, monkeypatch):
    paths = _png_frames(tmp_path / "f", n=2)
    monkeypatch.setattr(os.path, "getsize", lambda p: 3 << 30)
    with pytest.raises(ValueError, match="GiB"):
        qtpng.write_mov(str(tmp_path / "big.mov"), paths, 30)


# -- the animate and encode verbs ------------------------------------------------
def test_animate_zoom(tmp_path):
    out_dir = str(tmp_path / "frames")
    rc = cli.main(["animate", "--device", "cpu", "--zoom-to", "0.5",
                   "--duration", "3", "--fps", "1", "--width", "32",
                   "--height", "16", "--iters", "16", "--out-dir", out_dir])
    assert rc == 0
    files = sorted(os.listdir(out_dir))
    assert files == ["frame_000000.png", "frame_000001.png",
                     "frame_000002.png"]


def test_animate_cli_matches_jax_cli(tmp_path):
    # the same command through both CLIs: the same files, pixels within 5
    # LSB on < 1% of them
    argv = ["--zoom-to", "0.05", "--duration", "5", "--fps", "1",
            "--width", "40", "--height", "24", "--iters", "96", "--center",
            "-0.7", "0.25", "--batch-size", "2", "--palette", "3"]
    assert cli.main(["animate", "--device", "cpu", *argv, "--out-dir",
                     str(tmp_path / "p")]) == 0
    assert jax_cli.main(["animate", *argv, "--out-dir",
                         str(tmp_path / "j")]) == 0
    mine, ref = _read_frames(tmp_path / "p"), _read_frames(tmp_path / "j")
    assert list(mine) == list(ref) and len(mine) == 5
    for name in mine:
        assert _bad_fraction(mine[name], ref[name], 5) < 0.01, name


def test_animate_franim(tmp_path):
    a = Animation(duration=2.0, target_fps=1, export_width=32,
                  export_height=16)
    a.keyframes.append(Keyframe(0.0, Scene(max_iterations=16, zoom=2.0)))
    a.keyframes.append(Keyframe(2.0, Scene(max_iterations=16, zoom=0.5)))
    fpath = str(tmp_path / "z.franim")
    franim.save(a, fpath)
    out_dir = str(tmp_path / "frames")
    rc = cli.main(["animate", "--device", "cpu", "--franim", fpath,
                   "--out-dir", out_dir])
    assert rc == 0
    assert len(os.listdir(out_dir)) == 2


def test_animate_save_franim(tmp_path):
    fr_path = str(tmp_path / "zoom.franim")
    out_dir = str(tmp_path / "fr")
    rc = cli.main(["animate", "--device", "cpu", "--zoom-to", "1.0",
                   "--duration", "2", "--fps", "1", "--width", "24",
                   "--height", "12", "--iters", "8", "--out-dir", out_dir,
                   "--save-franim", fr_path])
    assert rc == 0 and os.path.exists(fr_path)
    a = franim.load(fr_path)
    assert a.export_width == 24 and len(a.keyframes) == 2
    assert len(jax_franim.load(fr_path).keyframes) == 2


def test_animate_resume_renders_nothing_twice(tmp_path, monkeypatch):
    argv = ["animate", "--device", "cpu", "--zoom-to", "0.5", "--duration",
            "3", "--fps", "1", "--width", "24", "--height", "12", "--iters",
            "16", "--out-dir", str(tmp_path / "f")]
    assert cli.main(argv) == 0
    from fractalrenderer_tpu_torch.ops import escape

    launches = []
    real = escape.escape_fields_plain

    def counting(*a, **kw):
        launches.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(escape, "escape_fields_plain", counting)
    assert cli.main([*argv, "--resume"]) == 0
    assert launches == []


def test_animate_bad_franim_exits_2(tmp_path, capsys):
    p = tmp_path / "bad.franim"
    p.write_text('{"keyframes": "x"}')
    rc = cli.main(["animate", "--device", "cpu", "--franim", str(p)])
    assert rc == 2 and "cannot load" in capsys.readouterr().err


def test_animate_sharded_matches_animate(tmp_path):
    # --sharded splits the frame batches over the visible devices (the one
    # CPU with --device cpu): the same files as without it
    argv = ["animate", "--device", "cpu", "--zoom-to", "0.2", "--duration",
            "3", "--fps", "1", "--width", "32", "--height", "20", "--iters",
            "32", "--batch-size", "2"]
    assert cli.main([*argv, "--out-dir", str(tmp_path / "s")]) == 0
    assert cli.main([*argv, "--sharded", "--out-dir",
                     str(tmp_path / "m")]) == 0
    mine, ref = _read_frames(tmp_path / "m"), _read_frames(tmp_path / "s")
    assert list(mine) == list(ref) and len(mine) == 3
    for name in mine:
        np.testing.assert_array_equal(mine[name], ref[name])


def test_animate_refuses_cuda_without_cuda(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["animate", "--width", "16", "--height", "8",
                   "--out-dir", str(tmp_path / "x")])
    assert rc == 2 and "CUDA is not available" in capsys.readouterr().err


def test_encode_without_frames(tmp_path):
    rc = cli.main(["encode", str(tmp_path), "--out", str(tmp_path / "o.mp4")])
    assert rc == 1


def test_encode_qtpng_cli(tmp_path, capsys):
    _png_frames(tmp_path / "frames", n=3)
    rc = cli.main(["encode", str(tmp_path / "frames"), "--codec", "qtpng",
                   "--fps", "24", "--out", str(tmp_path / "o.mp4")])
    assert rc == 0
    assert "Encoded ->" in capsys.readouterr().out
    dec = qtpng.read_mov(str(tmp_path / "o.mov"))
    assert len(dec["frames"]) == 3 and dec["fps"] == pytest.approx(24.0)


@pytest.mark.parametrize("verb", ["animate", "encode"])
def test_verb_flags_match_jax_cli(verb):
    # the JAX parsers' flags and defaults, plus the port's own --device
    # where frames render and --profile (a torch.profiler trace of the verb)
    def flags(parser):
        sp = parser._subparsers._group_actions[0].choices[verb]
        return {a.dest: (a.default, tuple(a.choices or ()))
                for a in sp._actions
                if a.dest not in ("help", "cpu", "device", "profile")}

    assert flags(cli.build_parser()) == flags(jax_cli.build_parser())
