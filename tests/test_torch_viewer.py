"""The port's line-REPL viewer (``fractalrenderer_tpu_torch/viewer.py``) on the
CPU device: twins of tests/test_cli.py's viewer tests, each run through the
port and the JAX package on the same inputs.

The same ``Viewer.handle`` sequences give the same scenes (JSON equal) and
the same messages (file paths aside, each package writing its own files);
``ansi_render`` returns the same string for the same image; rendered frames
and exports hold against the JAX golden reference within 1 LSB (the port's
plain kernels equal it; the JAX kernels in interpret mode leave it on a few
pixels, test_torch_gfx.py).
"""
import json
import math
import os
import random

import numpy as np
import pytest

import fractalrenderer_tpu as fr
from fractalrenderer_tpu import viewer as jax_viewer
from fractalrenderer_tpu.anim import franim as jax_franim
from fractalrenderer_tpu.utils.png import read_png
from fractalrenderer_tpu_torch import cli, viewer
from fractalrenderer_tpu_torch.anim import franim, video
from fractalrenderer_tpu_torch.anim.keyframes import InterpolationType
from fractalrenderer_tpu_torch.scene import FractalType, Scene
from fractalrenderer_tpu_torch.viewer import Viewer, ansi_render


def _jax_scene(scene):
    return fr.Scene.from_dict(json.loads(scene.to_json()))


def _pair(scene=None, **kw):
    """The same viewer in both packages: (port on the CPU, JAX)."""
    return (Viewer(scene, device="cpu", **kw),
            jax_viewer.Viewer(None if scene is None else _jax_scene(scene),
                              **kw))


def _scene(v):
    return json.loads(v.scene.to_json())


def _both(mine, ref, line, jline=None):
    """One command line through both viewers; the same scene and message
    (``jline`` is the JAX viewer's line where a path differs)."""
    a = mine.handle(line)
    b = ref.handle(line if jline is None else jline)
    if jline is not None and isinstance(a, str) and isinstance(b, str):
        b = b.replace(jline.split()[-1], line.split()[-1])
    assert a == b, line
    assert _scene(mine) == _scene(ref), line
    return a


def _q8(img):
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255.0 + 0.5).astype(
        np.int64)


def test_viewer_commands(tmp_path):
    mine, ref = _pair(Scene(max_iterations=16, zoom=2.5), cols=24, rows=8)
    assert _both(mine, ref, "+") == ""
    assert mine.scene.zoom == pytest.approx(2.0)
    assert mine.scene.max_iterations == 512  # auto-iteration ladder
    for line in ("d", "tab", "type burning-ship", "p 3",
                 "preset Seahorse Valley", "w", "a", "s", "-",
                 "click 3 4", "rclick 20 1"):
        _both(mine, ref, line)
    assert mine.scene.fractal_type == FractalType.MANDELBROT  # the preset
    assert "zoom=" in _both(mine, ref, "coords")
    assert "unknown command" in _both(mine, ref, "bogus")
    assert mine.handle("q") is None and ref.handle("q") is None
    # frame: ANSI half blocks with a status line; the same string as the
    # JAX viewer's where the two frames agree (the cell path's image is
    # the golden render's within 1 LSB)
    v2, j2 = _pair(Scene(max_iterations=8), cols=16, rows=4)
    out = v2.frame()
    assert "▀" in out and "Mandelbrot" in out
    assert out.splitlines()[-1] == j2.frame().splitlines()[-1]
    path = str(tmp_path / "shot.png")
    assert "saved" in v2.handle(f"save {path}")
    gold = _q8(fr.render_numpy(j2.scene, 128, 64))[::-1]
    assert np.abs(read_png(path).astype(np.int64) - gold).max() <= 1


def test_ansi_render_equals_jax():
    img = np.random.default_rng(21).random((9, 11, 3), dtype=np.float32)
    img[0, 0] = (-1.0, 2.0, 0.5)  # clipped
    assert ansi_render(img) == jax_viewer.ansi_render(img)


def test_frame_is_the_golden_render():
    v = Viewer(Scene(max_iterations=32, palette_mode=2), cols=20, rows=6,
               device="cpu")
    img = viewer._host(viewer.models.render(v.scene, 20, 12, device="cpu"))
    gold = fr.render_numpy(_jax_scene(v.scene), 20, 12)
    assert np.abs(_q8(img) - _q8(gold)).max() <= 1
    assert v.frame() == ansi_render(img[::-1]) + "\n" + \
        v.frame().splitlines()[-1]


def test_viewer_parameter_commands():
    mine, ref = _pair(Scene(max_iterations=8), cols=16, rows=4)
    for line in ("julia -0.42 0.61", "julia San Marco", "phoenix 0.3 -0.4",
                 "phoenix julia 0.56 -0.5", "phoenix julia", "bulb power 6",
                 "bulb dist 5.5", "bulb rot 1.25", "bulb fov 1.5",
                 "bulb resetcam", "bulb nope 1"):
        _both(mine, ref, line)
    s = mine.scene
    assert s.fractal_type == FractalType.MANDELBULB
    assert (s.julia_c_real, s.julia_c_imag) == (0.56, -0.5)
    assert not s.use_julia_set and s.mandelbulb_power == 6.0
    assert (s.camera_distance, s.rotation_y, s.fov) == (3.0, 0.0, 1.5)


def test_nonpositive_sizes_are_clean_errors(tmp_path, capsys):
    out = str(tmp_path / "x.png")
    assert cli.main(["render", "--device", "cpu", "--width", "0",
                     "--height", "32", "--out", out]) == 2
    assert cli.main(["export-print", "--device", "cpu", "--width", "-4",
                     "--height", "8", "--out", out]) == 2
    assert cli.main(["giant", "--device", "cpu", "--width", "16",
                     "--height", "0", "--out", out]) == 2
    mine, ref = _pair(Scene(max_iterations=8), cols=8, rows=2)
    assert "bad export size" in _both(mine, ref, "export 0 0 z.png")
    assert "bad export size" in _both(mine, ref, "export -4 8 z.png")
    assert "32000 cap" in _both(mine, ref, "export 40000 2 x.png")
    assert not os.listdir(tmp_path)


def test_viewer_command_fuzz(tmp_path, monkeypatch):
    """No command line, however malformed, escapes handle() as an
    exception; the port answers each line as the JAX viewer does and ends
    in the same scene."""
    monkeypatch.chdir(tmp_path)
    rng = random.Random(1234)
    words = ["julia", "phoenix", "bulb", "p", "i", "aa", "spp", "style",
             "trap", "stripes", "enhance", "preset", "type", "key",
             "anim", "scene", "click", "rclick", "w", "a", "s", "d",
             "tab", "+", "-", "e", "r", "coords", "export", "h",
             "spinx", "", "nope"]
    argpool = ["", "0", "1", "-1", "2.5", "-0.7", "1e9", "-1e-9", "inf",
               "nan", "junk", "auto", "julia", "resetcam", "dist", "rot",
               "power", "fov", "add", "list", "del", "clear", "save",
               "load", "seek", "interp", "fps", "dur", "info",
               str(tmp_path / "f.json"), "San Marco", "0.5"]
    mine, ref = _pair(Scene(max_iterations=8), cols=8, rows=2)
    for _ in range(400):
        line = " ".join([rng.choice(words)]
                        + [rng.choice(argpool)
                           for _ in range(rng.randrange(4))])
        out = mine.handle(line)
        assert isinstance(out, str), f"{line!r} -> {out!r}"
        want = ref.handle(line)
        if line.split()[:1] == ["h"]:
            # help prints each module's docstring after "commands:"
            out, want = out[:out.index("q ")], want[:want.index("q ")]
        assert out == want, line
        assert _scene(mine) == _scene(ref), line
    assert isinstance(mine.scene.max_iterations, int)


def test_viewer_minimap():
    mine, ref = _pair(Scene(max_iterations=16, zoom=0.05, center_x=-0.745,
                            center_y=0.113), cols=24, rows=8)
    out = mine.handle("minimap")
    assert "▀" in out and "center marker" in out
    assert out.splitlines()[-1] == ref.handle("m").splitlines()[-1]


def test_viewer_screen_y_conventions():
    mine, ref = _pair(Scene(max_iterations=16, zoom=2.0), cols=24, rows=8)
    _both(mine, ref, "w")
    assert mine.scene.center_y > 0.0
    mine, ref = _pair(Scene(max_iterations=16, zoom=2.0), cols=24, rows=8)
    _both(mine, ref, "click 12 0")  # top row of the displayed image
    assert mine.scene.center_y > 0.0


def test_viewer_keyframe_capture_workflow(tmp_path):
    mine, ref = _pair()
    assert "no keyframes" in _both(mine, ref, "key list")
    assert "t=0s" in _both(mine, ref, "key add")
    _both(mine, ref, "+")
    msg = _both(mine, ref, "key add")
    assert "keyframe 1" in msg and "t=2s" in msg
    for line in ("key add 5.5", "key list", "key del 2", "key list",
                 "anim fps 30", "anim loop", "anim loop"):
        _both(mine, ref, line)
    path = str(tmp_path / "session.franim")
    jpath = str(tmp_path / "jax.franim")
    assert "2 keyframes" in _both(mine, ref, f"anim save {path}",
                                  f"anim save {jpath}")
    anim, janim = franim.load(path), jax_franim.load(jpath)
    assert len(anim.keyframes) == 2 and anim.target_fps == 30
    assert [json.loads(k.scene.to_json()) for k in anim.keyframes] == \
        [json.loads(k.scene.to_json()) for k in janim.keyframes]
    # the port's viewer loads the JAX viewer's file
    v2 = Viewer(device="cpu")
    assert "2 keyframes" in v2.handle(f"anim load {jpath}")
    assert "fps=30" in v2.handle("anim info")


def test_viewer_anim_render_from_session(tmp_path):
    v = Viewer(device="cpu")
    v.scene = v.scene.with_(max_iterations=24)
    for line in ("key add 0", "+", "key add 0.05", "anim fps 40",
                 "anim dur 0.05"):
        v.handle(line)
    out = str(tmp_path / "fr")
    msg = v.handle(f"anim render {out} 32 16")
    assert "-> " in msg and "2 frames" in msg
    files = sorted(os.listdir(out))
    assert files == ["frame_000000.png", "frame_000001.png"]
    first = read_png(os.path.join(out, files[0])).astype(np.int64)
    kf0 = _jax_scene(v._anim().keyframes[0].scene)
    assert np.abs(first - _q8(fr.render_numpy(kf0, 32, 16))[::-1]).max() <= 1
    enc = video.VideoEncoder()
    assert enc.encode(out, video.VideoEncodeSettings(
        output_filename=str(tmp_path / "clip.mov"),
        codec=video.VideoCodec.QTPNG, fps=40))


def test_keyframe_update_jump_commands():
    mine, ref = _pair(cols=24, rows=12)
    for line in ("key add 0", "+", "key add 4", "+", "key update 1",
                 "key jump 0", "key jump 7", "key update 7"):
        _both(mine, ref, line)
    assert mine._anim().keyframes[1].time == 4.0
    assert mine.scene.zoom == mine._anim().keyframes[0].scene.zoom


def test_auto_iterations_enhance_and_hp_coords():
    mine, ref = _pair(Scene(zoom=1e-5, max_iterations=64), cols=16, rows=8)
    assert "auto" in _both(mine, ref, "i auto")
    assert mine.scene.max_iterations > 64 and mine.scene.zoom == 1e-5
    for line in ("enhance brightness 1.5", "enhance contrast 0.8",
                 "enhance gamma 2", "enhance reset"):
        _both(mine, ref, line)
    assert (mine.scene.color_brightness, mine.scene.color_saturation,
            mine.scene.color_contrast) == (1.0, 1.0, 1.0)
    d, jd = _pair(Scene(fractal_type=FractalType.DEEP_ZOOM,
                        hp_center_x="-0.74364388703715158",
                        hp_center_y="0.13182590420531198",
                        hp_zoom="1e-32"), cols=16, rows=8)
    msg = _both(d, jd, "coords")
    assert "-0.74364388703715158" in msg and "1e-32" in msg


@pytest.mark.parametrize("ss", [False, True], ids=["plain", "ss"])
def test_viewer_export_command(tmp_path, monkeypatch, ss):
    """The in-app export panel: a 16-bit PNG of the view on the viewer's
    device; 'ss' supersamples 2x and box-downsamples.  Within 1 LSB of 8
    bits of the JAX golden render (the same pipeline to 16 bits)."""
    monkeypatch.chdir(tmp_path)
    mine, ref = _pair(Scene(max_iterations=16), cols=16, rows=4)
    line = "export 48 32 ss out.png" if ss else "export 48 32 out.png"
    assert "exported" in _both(mine, ref, line, line.replace("out", "jx"))
    img = read_png("out.png")
    assert img.shape == (32, 48, 3) and img.dtype == np.uint16
    if ss:
        g = fr.render_numpy(ref.scene, 96, 64)
        g = (g[0::2, 0::2] + g[1::2, 0::2] + g[0::2, 1::2]
             + g[1::2, 1::2]) * 0.25
    else:
        g = fr.render_numpy(ref.scene, 48, 32)
    want = (np.clip(g, 0, 1) * 65535 + 0.5).astype(np.int64)[::-1]
    assert np.abs(img.astype(np.int64) - want).max() <= 257
    raw = open("out.png", "rb").read()
    assert b"fractalrenderer_tpu_torch (print export)" in raw
    assert b"pHYs" in raw


def test_viewer_export_banded(tmp_path, monkeypatch):
    """Sizes past cli._BANDED_EXPORT_PIXELS stream through the banded
    giant exporter on the viewer's device: the same pixels as the
    one-pass export."""
    monkeypatch.chdir(tmp_path)
    v = Viewer(Scene(max_iterations=16), cols=16, rows=4, device="cpu")
    assert "16-bit" in v.handle("export 40 24 one.png")
    monkeypatch.setattr(cli, "_BANDED_EXPORT_PIXELS", 100)
    assert "(banded)" in v.handle("export 40 24 band.png")
    np.testing.assert_array_equal(read_png("one.png"), read_png("band.png"))


def test_viewer_effects_commands():
    mine, ref = _pair(Scene(max_iterations=8), cols=16, rows=4)
    for line in ("p 4 0.25 2.0", "style 2", "trap 0.75", "trap",
                 "stripes 6.5", "stripes", "aa 2", "spp 2", "i 300"):
        _both(mine, ref, line)
    s = mine.scene
    assert (s.palette_mode, s.color_offset, s.color_scale) == (4, 0.25, 2.0)
    assert s.interior_style == 2 and not s.orbit_trap_enabled
    assert s.orbit_trap_radius == 0.75 and s.stripe_density == 6.5
    assert not s.stripe_enabled and s.samples_per_pixel == 2


def test_viewer_anim_encode(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    v = Viewer(Scene(max_iterations=8, zoom=2.5), cols=16, rows=4,
               device="cpu")
    for line in ("key add 0", "+", "key add 1", "anim fps 2", "anim dur 1"):
        v.handle(line)
    assert "frames" in v.handle("anim render frames 32 16")
    msg = v.handle("anim encode frames clip.mov")
    assert "encoded" in msg, msg
    assert os.path.getsize("clip.mov") > 100


def test_viewer_anim_seek():
    mine, ref = _pair(Scene(max_iterations=8, zoom=4.0), cols=16, rows=4)
    _both(mine, ref, "key add 0")
    mine.scene = mine.scene.with_(zoom=1.0)
    ref.scene = ref.scene.with_(zoom=1.0)
    _both(mine, ref, "key add 10")
    assert "t=5" in _both(mine, ref, "anim seek 5")
    assert mine.scene.zoom == pytest.approx(math.sqrt(4.0 * 1.0))


def test_viewer_key_interp():
    mine, ref = _pair(Scene(max_iterations=8, zoom=4.0), cols=16, rows=4)
    _both(mine, ref, "key add 0")
    mine.scene = mine.scene.with_(zoom=1.0)
    ref.scene = ref.scene.with_(zoom=1.0)
    _both(mine, ref, "key add 10")
    assert "LINEAR" in _both(mine, ref, "key interp 1 linear")
    assert mine._anim().keyframes[1].interp_type == InterpolationType.LINEAR
    _both(mine, ref, "anim seek 2.5")
    assert mine.scene.zoom == pytest.approx(
        math.exp(math.log(4.0) + 0.25 * (math.log(1.0) - math.log(4.0))))
    assert "unknown interpolation" in _both(mine, ref, "key interp 1 bogus")


def test_viewer_scene_files_cross_packages(tmp_path):
    """`scene save` / `scene load`: a file either viewer saved loads in the
    other to the same scene."""
    mine, ref = _pair(Scene(max_iterations=40, palette_mode=3), cols=8,
                      rows=2)
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    _both(mine, ref, f"scene save {a}", f"scene save {b}")
    assert json.loads(open(a).read()) == json.loads(open(b).read())
    mine.handle("r")
    assert mine.handle(f"scene load {b}") == f"loaded {b}"
    assert _scene(mine) == _scene(ref)


def test_repl_run_on_the_cpu(monkeypatch, capsys):
    """viewer.run: a frame, then one frame per command, until q."""
    lines = iter(["+", "p 2", "q"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(lines))
    assert viewer.run(Scene(max_iterations=8), cols=12, rows=3,
                      device="cpu") == 0
    out = capsys.readouterr().out
    assert out.count("Mandelbrot  center=") == 3 and "▀" in out
