"""The port's live raw-terminal session (``fractalrenderer_tpu_torch/live.py``)
on the CPU device: twins of tests/test_live.py, each run through the port and
the JAX package on the same seed-made inputs.

``parse_input`` gives the same events and remainders on the same byte
streams (the fuzz included); sessions fed the same events at the same
``now``/``dt`` end with the same Scene (JSON equal), the same held keys,
command line, flags, message and status line; ``compose_frame`` returns the
same string for the same image.  Rendered session frames at <= 64x48 px
hold against the JAX session's: the planar uint8 and cell f32 2D frames
within 1 LSB of the JAX golden reference everywhere and of the JAX frame on
>= 99% of pixels (test_torch_gfx.py), the deep zoom at 1e-12 within 1 LSB
on >= 98% of pixels, and the bulb within 1 LSB on >= 99% of pixels (the
bulb's march is held to the JAX one statistically, test_torch_bulb.py).
The JAX session's CPU preview has no twin: the port draws nothing before
its device's first frame, and a CUDA session never renders on the CPU.
"""
import io
import json
import os
import pty
import select
import subprocess
import sys
import time
from collections import deque

import numpy as np
import pytest
import torch

import fractalrenderer_tpu as fr
from fractalrenderer_tpu import live as jax_live
from fractalrenderer_tpu_torch import models
from fractalrenderer_tpu_torch import live
from fractalrenderer_tpu_torch.live import (LiveSession, compose_frame,
                                            parse_input)
from fractalrenderer_tpu_torch.scene import FractalType, Scene
from test_torch_gfx import assert_2d_planes, assert_deep_frames

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DEEP = dict(fractal_type=FractalType.DEEP_ZOOM,
            hp_center_x="-0.74364388703715158",
            hp_center_y="0.13182590420531198", use_perturbation=True)


def _jax_scene(scene):
    return fr.Scene.from_dict(json.loads(scene.to_json()))


def _pair(scene=None, cols=40, rows=10, **kw):
    """The same session in both packages: (port on the CPU, JAX)."""
    scene = scene if scene is not None else Scene(zoom=2.0,
                                                  max_iterations=64)
    return (LiveSession(scene, cols=cols, rows=rows, device="cpu", **kw),
            jax_live.LiveSession(_jax_scene(scene), cols=cols, rows=rows,
                                 **kw))


def _state(s):
    """What a session's input handling decides, as plain data."""
    return dict(scene=json.loads(s.scene.to_json()), held=dict(s.held),
                cmdline=s.cmdline, running=s.running, spin=s.spin,
                spin_speed=s.spin_speed, message=s.message,
                size=(s.width, s.height), dirty=s.dirty,
                flags=(s.show_status, s.show_help, s.show_minimap,
                       s.fullscreen),
                playing=s.playing, play_t=s.play_t,
                status=s.status_line())


def _twin(script, scene=None, **kw):
    """Run ``script(session)`` on both sessions; their states must agree.
    Returns the port's session."""
    mine, ref = _pair(scene, **kw)
    script(mine)
    script(ref)
    assert _state(mine) == _state(ref)
    return mine


def _keys(s, keys, now=0.0):
    for k in keys:
        s.handle_event(("key", "enter" if k == "\r" else k), now)


# ---- byte-stream parsing -------------------------------------------------

PARSE_CASES = {
    "plain": b"wq e",
    "arrows_specials": b"\x1b[A\x1b[B\x1b[C\x1b[D\t\r\x7f\x03",
    "sgr_mouse": (b"\x1b[<0;10;5M\x1b[<0;10;5m\x1b[<32;11;6M"
                  b"\x1b[<64;2;2M\x1b[<65;2;2M\x1b[<2;7;7M"),
    "split": b"a\x1b[<0;3",
    "esc_prefix": b"\x1bq",
    "lone_esc": b"\x1b",
    "wheel_modifiers": (b"\x1b[<68;3;3M\x1b[<69;3;3M\x1b[<80;3;3M"
                        b"\x1b[<66;3;3M\x1b[<67;3;3M"),
}


@pytest.mark.parametrize("name", list(PARSE_CASES))
def test_parse_input_equals_jax(name):
    buf = PARSE_CASES[name]
    assert parse_input(buf) == jax_live.parse_input(buf)


def test_parse_plain_keys():
    ev, rest = parse_input(b"wq e")
    assert ev == [("key", "w"), ("key", "q"), ("key", " "), ("key", "e")]
    assert rest == b""


def test_parse_arrows_and_specials():
    ev, _ = parse_input(b"\x1b[A\x1b[B\x1b[C\x1b[D\t\r\x7f\x03")
    assert ev == [("key", "up"), ("key", "down"), ("key", "right"),
                  ("key", "left"), ("key", "tab"), ("key", "enter"),
                  ("key", "backspace"), ("key", "ctrl-c")]


def test_parse_sgr_mouse():
    ev, _ = parse_input(PARSE_CASES["sgr_mouse"])
    assert ev == [("mouse", 0, 9, 4, "press"),
                  ("mouse", 0, 9, 4, "release"),
                  ("mouse", 0, 10, 5, "motion"),
                  ("mouse", 0, 1, 1, "wheelup"),
                  ("mouse", 1, 1, 1, "wheeldown"),
                  ("mouse", 2, 6, 6, "press")]


def test_parse_split_sequence_resumes():
    ev, rest = parse_input(b"a\x1b[<0;3")
    assert ev == [("key", "a")] and rest == b"\x1b[<0;3"
    ev2, rest2 = parse_input(rest + b";4M")
    assert (ev2, rest2) == jax_live.parse_input(rest + b";4M")
    assert ev2 == [("mouse", 0, 2, 3, "press")] and rest2 == b""


def test_parse_esc_prefix_vs_key():
    assert parse_input(b"\x1bq") == ([("key", "esc"), ("key", "q")], b"")
    assert parse_input(b"\x1b") == ([], b"\x1b")


def test_parse_wheel_with_modifier_bits():
    ev, _ = parse_input(PARSE_CASES["wheel_modifiers"])
    assert [e[4] for e in ev] == ["wheelup", "wheeldown", "wheelup"]


def test_parse_and_handle_fuzz():
    """Random byte soup parses to the same events and remainders in both
    packages, never raises, always makes progress, and drives both
    sessions to the same state; then valid SGR reports with extreme
    coordinates and button bits."""
    import random

    rng = random.Random(99)
    mine, ref = _pair(Scene(zoom=2.0, max_iterations=8), cols=16, rows=4)
    # input handling is under test, not the render stack
    for s in (mine, ref):
        s.screenshot = lambda: "stubbed shot"
    carry = jcarry = b""
    now = 0.0
    for _ in range(300):
        chunk = bytes(rng.randrange(256) for _ in range(rng.randrange(24)))
        events, carry = parse_input(carry + chunk)
        jevents, jcarry = jax_live.parse_input(jcarry + chunk)
        assert (events, carry) == (jevents, jcarry)
        assert len(carry) < 64
        now += 0.01
        for ev in events:
            if ev in (("key", "esc"), ("key", "ctrl-c")):
                continue  # quit keys end a real session; keep fuzzing
            mine.handle_event(ev, now)
            ref.handle_event(ev, now)
        mine.tick(now, 0.01)
        ref.tick(now, 0.01)
        assert _state(mine)["scene"] == _state(ref)["scene"]
    for _ in range(200):
        btn = rng.randrange(256)
        cx, cy = rng.randrange(0, 9999), rng.randrange(0, 9999)
        data = f"\x1b[<{btn};{cx};{cy}{chr(rng.choice(b'Mm'))}".encode()
        events, rest = parse_input(data)
        assert (events, rest) == jax_live.parse_input(data)
        assert rest == b""
        now += 0.01
        for ev in events:
            mine.handle_event(ev, now)
            ref.handle_event(ev, now)
    assert _state(mine) == _state(ref)
    assert isinstance(mine.scene.zoom, float)


# ---- continuous-input semantics (input_handler.h:211-248) ---------------

def test_pan_speed_is_zoom_proportional():
    def script(s):
        s.handle_event(("key", "w"), 0.0)
        s.tick(0.01, 0.016)

    s = _twin(script)
    dy1 = s.scene.center_y
    assert dy1 == pytest.approx(2.0 * 0.016 * 2.0)  # zoom * dt * 2
    z = _twin(script, Scene(zoom=0.2, max_iterations=64))
    assert z.scene.center_y == pytest.approx(dy1 / 10)


@pytest.mark.parametrize("key,dx_sign,dy_sign", [
    ("a", -1, 0), ("d", 1, 0), ("left", -1, 0), ("right", 1, 0),
    ("w", 0, 1), ("s", 0, -1), ("up", 0, 1), ("down", 0, -1)])
def test_pan_directions_and_aspect(key, dx_sign, dy_sign):
    def script(s):
        s.handle_event(("key", key), 0.0)
        s.tick(0.01, 0.02)

    t = _twin(script)
    aspect = t.width / t.height
    pan = 2.0 * 0.02 * 2.0
    assert t.scene.center_x - (-0.5) == pytest.approx(dx_sign * pan * aspect)
    assert t.scene.center_y == pytest.approx(dy_sign * pan)


@pytest.mark.parametrize("key,factor,iters", [("e", 0.8, 512),
                                              ("q", 1.25, 512)])
def test_continuous_zoom_dt_scaled_with_iteration_ladder(key, factor, iters):
    def script(s):
        s.handle_event(("key", key), 0.0)
        s.tick(0.01, 1.0 / 60.0)  # exactly one reference frame

    s = _twin(script)
    assert s.scene.zoom == pytest.approx(2.0 * factor)
    assert s.scene.max_iterations == iters


def test_tap_vs_held_windows():
    def script(s):
        s.handle_event(("key", "e"), 0.0)
        s.handle_event(("key", "e"), 0.3)

    s = _twin(script)
    assert s.held["e"] == pytest.approx(0.3 + live._HOLD_S)
    assert (live._TAP_S, live._HOLD_S, live._REPEAT_DETECT_S) == (
        jax_live._TAP_S, jax_live._HOLD_S, jax_live._REPEAT_DETECT_S)
    s.tick(5.0, 0.016)
    assert "e" not in s.held


def test_stalled_frame_does_not_teleport():
    def script(s):
        s.handle_event(("key", "w"), 0.0)
        s.tick(0.01, 3.0)  # a 3-second frame stall

    s = _twin(script)
    assert abs(s.scene.center_y) <= 2.0 * 0.25 * 2.0 + 1e-9


# ---- hotkeys (input_handler.h:165-209) ----------------------------------

def test_hotkeys_iterations_palette_type_reset():
    def script(s):
        _keys(s, ["]"])
        assert s.scene.max_iterations == 128
        _keys(s, ["[", "["])
        assert s.scene.max_iterations == 64  # clamped at 64
        _keys(s, ["4"])
        assert s.scene.palette_mode == 3
        _keys(s, ["tab"])
        assert s.scene.fractal_type.name == "JULIA"
        _keys(s, ["r"])

    s = _twin(script)
    assert s.scene.zoom == 1.5  # reference reset quirk


@pytest.mark.parametrize("key", ["z", "x", "c"])
def test_deep_zoom_preset_hotkeys(key):
    s = _twin(lambda s: _keys(s, [key]))
    assert s.scene.fractal_type == FractalType.DEEP_ZOOM
    assert s.scene.max_iterations >= 1024
    if key == "x":
        assert float(s.scene.hp_zoom) == pytest.approx(1e-8)


def test_auto_rotate_toggle_and_spin():
    def script(s):
        s.scene = s.scene.with_(fractal_type=type(s.scene.fractal_type)
                                .MANDELBULB)
        s.handle_event(("key", "o"), 0.0)
        s.tick(0.1, 0.2)
        s.handle_event(("key", "o"), 0.2)
        s.tick(0.3, 0.2)

    s = _twin(script)
    assert not s.spin
    assert s.scene.rotation_y == pytest.approx(0.5 * 0.2)  # speed 0.5


def test_fullscreen_toggle_changes_render_size():
    mine, ref = _pair()
    w0, h0 = mine.width, mine.height
    for s in (mine, ref):
        s.handle_event(("key", "f"), 0.0)
    assert _state(mine) == _state(ref)
    assert mine.fullscreen and (mine.width, mine.height) != (w0, h0)
    for s in (mine, ref):
        s.handle_event(("key", "f"), 0.0)
    assert _state(mine) == _state(ref)
    assert (mine.width, mine.height) == (w0, h0)


def test_live_spin_speed_command():
    # :spin [SPEED] = the Auto Rotate checkbox + Rotation Speed slider
    # (ui_manager.cpp:1302-1309)
    def script(s):
        s.command("spin 1.5")
        s.tick(now=0.0, dt=0.1)
        s.command("spin")
        s.command("spin 99")
        s.command("spin abc")

    s = _twin(script, Scene(fractal_type=FractalType.MANDELBULB,
                            max_iterations=8), cols=16, rows=4)
    assert s.spin and s.spin_speed == 2.0
    assert s.scene.rotation_y == pytest.approx(1.5 * 0.1)
    assert "bad spin speed" in s.message


# ---- mouse (input_handler.h:101-163) ------------------------------------

def test_mouse_wheel_zoom_2d_and_bulb_camera():
    s = _twin(lambda s: s.handle_event(("mouse", 0, 5, 5, "wheelup"), 0.0))
    assert s.scene.zoom == pytest.approx(2.0 * 0.8)
    b = _twin(lambda s: s.handle_event(("mouse", 0, 5, 5, "wheelup"), 0.0),
              Scene(zoom=2.0, max_iterations=64,
                    fractal_type=FractalType.MANDELBULB,
                    camera_distance=1.05))
    assert b.scene.camera_distance == pytest.approx(1.0)  # clamp [1, 10]


def test_mouse_drag_pans_and_rotates_bulb():
    def script(s):
        s.handle_event(("mouse", 0, 10, 5, "press"), 0.0)
        s.handle_event(("mouse", 0, 12, 4, "motion"), 0.1)
        s.handle_event(("mouse", 0, 12, 4, "release"), 0.2)
        s.handle_event(("mouse", 0, 20, 8, "motion"), 0.3)  # not dragging

    s = _twin(script)
    aspect = s.width / s.height
    assert s.scene.center_x == pytest.approx(
        -0.5 - 2 / s.width * 2.0 * aspect)
    assert s.scene.center_y == pytest.approx(0.0 + (-2) / s.height * 2.0)

    def bulb(s):
        s.handle_event(("mouse", 0, 10, 5, "press"), 0.0)
        s.handle_event(("mouse", 0, 15, 5, "motion"), 0.1)

    b = _twin(bulb, Scene(zoom=2.0, max_iterations=64,
                          fractal_type=FractalType.MANDELBULB))
    assert b.scene.rotation_y == pytest.approx(5 * 0.01)


def test_double_click_zooms_in_right_click_out():
    def double(s):
        s.handle_event(("mouse", 0, 10, 5, "press"), 0.0)
        s.handle_event(("mouse", 0, 10, 5, "press"), 0.1)

    assert _twin(double).scene.zoom < 2.0
    r = _twin(lambda s: s.handle_event(("mouse", 2, 10, 5, "press"), 0.0))
    assert r.scene.zoom > 2.0

    def slow(s):
        s.handle_event(("mouse", 0, 10, 5, "press"), 0.0)
        s.handle_event(("mouse", 0, 10, 5, "press"), 1.0)

    assert _twin(slow).scene.zoom == pytest.approx(2.0)


# ---- command line & overlays --------------------------------------------

def test_cmdline_modal_consumes_burst(tmp_path):
    path = tmp_path / "live.json"
    jpath = tmp_path / "jax_live.json"
    mine, ref = _pair()
    _keys(mine, f":scene save {path}\r")
    _keys(ref, f":scene save {jpath}\r")
    assert mine.cmdline is None and not mine.held
    assert json.loads(path.read_text()) == json.loads(jpath.read_text())
    assert json.loads(path.read_text())["zoom"] == 2.0
    assert mine.scene.fractal_type == FractalType.MANDELBROT
    # a file the JAX session saved loads in the port's session
    _keys(mine, ["5"], 1.0)
    _keys(mine, f":scene load {jpath}\r", 1.0)
    assert mine.scene.palette_mode == 0


def test_cmdline_esc_cancels_not_quits():
    s = _twin(lambda s: _keys(s, [":", "q", "esc"]))
    assert s.cmdline is None and s.running


def test_compose_frame_overlays():
    mine, ref = _pair()
    img = np.random.default_rng(11).random(
        (mine.height, mine.width, 3), dtype=np.float32)

    def both():
        a = compose_frame(mine, img)
        assert a == jax_live.compose_frame(ref, img)
        return a

    base = both()
    assert "\x1b[H" in base and "\x1b[7m" in base
    for s in (mine, ref):
        s.handle_event(("key", "h"), 0.0)
    assert "auto-rotate" in both()
    for s in (mine, ref):
        _keys(s, ["h", " "])  # help off, status off
    assert "\x1b[7m" not in both()
    for s in (mine, ref):
        _keys(s, [":", "c"])
    assert both().endswith(":c\x1b[K\x1b[J")


def test_ansi_rows_equal_jax():
    img = np.random.default_rng(12).random((9, 7, 3), dtype=np.float32)
    img[2:5] = 0.25  # a flat run: the SGR reuse path
    assert live._ansi_rows(img) == jax_live._ansi_rows(img)
    assert live._osc52("x = (1, 2) é") == jax_live._osc52("x = (1, 2) é")


def test_coords_copies_via_osc52():
    import base64

    mine, ref = _pair()
    for s in (mine, ref):
        _keys(s, ":coords\r")
    assert mine.message.startswith("center=")
    img = np.zeros((mine.height, mine.width, 3), np.float32)
    frame = compose_frame(mine, img)
    assert frame == jax_live.compose_frame(ref, img)
    start = frame.index("\x1b]52;c;") + len("\x1b]52;c;")
    end = frame.index("\x1b\\", start)
    assert base64.standard_b64decode(frame[start:end]).decode() == \
        mine.message
    assert "\x1b]52;" not in compose_frame(mine, img)


@pytest.mark.parametrize("key", ["esc", "ctrl-c"])
def test_quit_keys(key):
    assert not _twin(lambda s: _keys(s, [key])).running


# ---- session file and the event loop -------------------------------------

def _run(mod, data: bytes, **kw):
    r, w = os.pipe()
    os.write(w, data)
    os.close(w)
    extra = dict(device="cpu") if mod is live else {}
    with open(r, "rb", buffering=0) as fin, open(os.devnull, "w") as fout:
        return mod.run_live(infile=fin, outfile=fout, cols=16, rows=5, **kw,
                            **extra)


def test_session_auto_persist_and_resume(tmp_path, monkeypatch):
    """The imgui.ini analog, at the JAX session file's location and in its
    JSON: a session saved by either package resumes in the other."""
    sess_file = tmp_path / "last_session.json"
    monkeypatch.setenv("FRACTAL_TPU_SESSION_FILE", str(sess_file))
    assert live._session_file() == jax_live._session_file()
    monkeypatch.delenv("FRACTAL_TPU_SESSION_FILE")
    assert live._session_file() == jax_live._session_file()
    monkeypatch.setenv("FRACTAL_TPU_SESSION_FILE", str(sess_file))
    _run(live, b"eee\x1b", persist=True)            # zoom in, quit
    saved = json.loads(sess_file.read_text())
    assert saved["zoom"] < Scene().zoom
    # the JAX package resumes the port's file, and the port the JAX one's
    _run(jax_live, b"\x1b", resume_last=True, persist=True, max_frames=1)
    assert json.loads(sess_file.read_text()) == saved
    _run(live, b"\x1b", resume_last=True, persist=True, max_frames=1)
    assert json.loads(sess_file.read_text()) == saved
    assert live.load_last_session().to_json() == \
        jax_live.load_last_session().to_json()
    sess_file.write_text("{not json")
    assert live.load_last_session() is None


def test_ctrl_c_quits_cleanly_and_persists(tmp_path, monkeypatch):
    sess_file = tmp_path / "last.json"
    monkeypatch.setenv("FRACTAL_TPU_SESSION_FILE", str(sess_file))
    calls = {"n": 0}
    orig_poll = live.TermUI.poll

    def poll(self, timeout):
        calls["n"] += 1
        if calls["n"] >= 3:
            raise KeyboardInterrupt
        return orig_poll(self, timeout)

    monkeypatch.setattr(live.TermUI, "poll", poll)
    r, w = os.pipe()
    os.close(w)
    with open(r, "rb", buffering=0) as fin, open(os.devnull, "w") as fout:
        rc = live.run_live(infile=fin, outfile=fout, cols=8, rows=4,
                           persist=True, device="cpu")
    assert rc == 0
    assert json.loads(sess_file.read_text())["zoom"] > 0


def test_termui_poll_equals_jax():
    """TermUI's reads: a split CSI carried across polls, a bare ESC flushed
    as the Esc key on a quiet poll, EOF as Esc; the same events as the JAX
    TermUI from the same pipe bytes."""
    got = []
    for mod in (live, jax_live):
        r, w = os.pipe()
        with open(r, "rb", buffering=0) as fin:
            ui = mod.TermUI(infile=fin, outfile=io.StringIO())
            seq = []
            os.write(w, b"a\x1b[<0;3")
            seq.append(ui.poll(0.5))
            os.write(w, b";4M\x1b")
            seq.append(ui.poll(0.5))
            seq.append(ui.poll(0.01))  # quiet: the bare ESC is the Esc key
            os.close(w)
            seq.append(ui.poll(0.5))   # EOF
        got.append(seq)
    assert got[0] == got[1]
    assert got[0][2] == [("key", "esc")] and got[0][3] == [("key", "esc")]


def _cli_env(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, *filter(None, [env.get("PYTHONPATH")])])
    env["FRACTAL_TPU_SESSION_FILE"] = str(tmp_path / "pty_last.json")
    env.pop("FRACTAL_TPU_GFX", None)
    return env


def test_live_session_over_pty(tmp_path):
    """Boot the port's CLI live loop on a pty on the CPU device, steer it
    (a `:scene save`, then `e`), and let --max-frames end it: it restores
    the terminal, exits 0 and persists the zoomed scene."""
    scene_file = tmp_path / "sess.json"
    err_file = tmp_path / "stderr.txt"
    m, sl = pty.openpty()
    with open(err_file, "wb") as ef:
        p = subprocess.Popen(
            [sys.executable, "-m", "fractalrenderer_tpu_torch.cli",
             "interactive", "--live", "--device", "cpu", "--cols", "30",
             "--rows", "6", "--iters", "32", "--max-frames", "4"],
            stdin=sl, stdout=sl, stderr=ef, env=_cli_env(tmp_path),
            cwd=str(tmp_path))
    os.close(sl)
    out = b""

    def drain(seconds):
        nonlocal out
        end = time.time() + seconds
        while time.time() < end:
            r, _, _ = select.select([m], [], [], 0.05)
            if r:
                try:
                    out += os.read(m, 65536)
                except OSError:
                    return

    def ctx():
        return (f"poll={p.poll()!r} out_tail={out[-300:]!r} "
                f"stderr_tail={err_file.read_bytes()[-1500:]!r}")

    try:
        end = time.time() + 120
        while b"\x1b[7m" not in out and time.time() < end:
            drain(0.5)
        assert b"\x1b[?1049h" in out, ctx()   # alternate screen
        assert b"\x1b[?1006h" in out, ctx()   # SGR mouse reporting
        assert b"\x1b[7m" in out, ctx()       # status bar drawn
        assert "▀".encode() in out, ctx()     # half-block pixels
        os.write(m, f":scene save {scene_file}\r".encode())
        end = time.time() + 60
        while not scene_file.exists() and time.time() < end:
            drain(0.5)
        assert scene_file.exists(), ctx()
        end = time.time() + 60
        while p.poll() is None and time.time() < end:
            os.write(m, b"e")  # each tap zooms for at least one frame
            drain(1.0)
        assert p.poll() == 0, ctx()
        drain(0.5)
        assert b"\x1b[?1049l" in out, ctx()   # terminal restored
        assert json.loads(scene_file.read_text())["zoom"] == 2.5
        persisted = json.loads((tmp_path / "pty_last.json").read_text())
        assert persisted["zoom"] < 2.5, ctx()  # the 'e' zoomed in
    finally:
        if p.poll() is None:
            p.kill()
        os.close(m)


def test_deep_zoom_dispatch_reuses_orbit_cache():
    s = LiveSession(Scene(hp_zoom="1e-9", max_iterations=2048, **DEEP),
                    cols=8, rows=4, device="cpu")
    img1 = s.dispatch()
    assert img1 is not None and len(s._orbit_cache) == 1
    s.handle_event(("key", "+"), 0.0)   # hp zoom step, same center
    assert s.scene.max_iterations == 2048
    img2 = s.dispatch()
    assert img2 is not None and len(s._orbit_cache) == 1  # orbit reused


def test_screenshot_is_uppercase_s(monkeypatch, tmp_path):
    """'S' screenshots; lowercase 's' pans.  The screenshot is the 8x
    render of the session's scene on its device, written flipped."""
    from fractalrenderer_tpu_torch.utils.png import read_png

    monkeypatch.chdir(tmp_path)
    s = LiveSession(Scene(zoom=2.0, max_iterations=16), cols=6, rows=3,
                    device="cpu")
    s.handle_event(("key", "s"), 0.0)
    assert "s" in s.held and not os.listdir(tmp_path)
    s.handle_event(("key", "S"), 0.0)
    assert s.message == "saved screenshot_001.png"
    img = read_png("screenshot_001.png")
    want = models.render(s.scene, 48, 48, device="cpu", quantize=8)
    np.testing.assert_array_equal(img, want.flip(0).numpy())


def test_deep_zoom_pan_moves_hp_center():
    from fractions import Fraction

    def script(s):
        s.handle_event(("key", "d"), 0.0)
        s.tick(0.01, 0.016)

    scene = Scene(hp_center_x="-0.5", hp_center_y="0", hp_zoom="1e-20",
                  max_iterations=64, **{k: v for k, v in DEEP.items()
                                        if not k.startswith("hp_")})
    s = _twin(script, scene)
    aspect = s.width / s.height
    expect = Fraction("1e-20") * Fraction(repr(float(0.016 * 2.0 * aspect)))
    assert Fraction(s.scene.hp_center_x) - Fraction("-0.5") == expect

    def drag(s):
        script(s)
        s.handle_event(("mouse", 0, 10, 5, "press"), 1.0)
        s.handle_event(("mouse", 0, 12, 5, "motion"), 1.1)

    d = _twin(drag, scene)
    assert d.scene.hp_center_x != s.scene.hp_center_x


def _capture_two(s):
    s.command("key add 0")
    s.handle_event(("key", "e"), 0.0)
    s.tick(0.01, 1 / 60)
    s.held.clear()
    s.command("key add 4")


def test_anim_playback_in_live_session():
    def script(s):
        s.command("key add 0")
        s.command("anim play")
        assert not s.playing and "need" in s.message
        s.handle_event(("key", "e"), 0.0)
        s.tick(0.01, 1 / 60)
        s.held.clear()
        s.command("key add 4")
        s.command("anim play")
        s.tick(0.1, 2.0)  # halfway
        assert s.playing
        for _ in range(40):
            s.tick(0.2, 0.25)
        assert not s.playing and "done" in s.message
        s.command("anim play")
        s.handle_event(("key", "w"), 1.0)

    s = _twin(script)
    assert not s.playing and not s.held


def test_anim_playback_loop_mouse_and_bad_time():
    def script(s):
        _capture_two(s)
        s.command("anim play now")
        assert not s.playing and "bad start time" in s.message
        s.viewer._anim().loop = True
        s.command("anim play")
        for _ in range(40):
            s.tick(0.2, 0.25)
        assert s.playing and 0.0 <= s.play_t <= 5.0
        s.handle_event(("mouse", 64, 10, 5, "press"), 1.0)  # wheel up

    s = _twin(script)
    assert not s.playing and "stopped" in s.message


def test_anim_pause_resume():
    def script(s):
        _capture_two(s)
        s.command("anim pause")
        assert "nothing playing" in s.message
        s.command("anim play")
        for _ in range(10):
            s.tick(0.1, 0.2)
        s.command("anim pause")
        assert not s.playing and "paused at 2.0" in s.message
        s.tick(0.2, 0.5)
        assert "paused" in s.status_line()
        s.handle_event(("key", "]"), 1.0)
        s.command("anim play")
        assert s.playing and "resumed at 2.0" in s.message
        for _ in range(40):
            s.tick(0.2, 0.25)

    s = _twin(script)
    assert not s.playing and s.playback is None and "done" in s.message


def test_live_deep_zoom_descent_to_1e20():
    """Interactive descent past the dd threshold: continuous 'e' from 2e-14
    through 1e-20, with the same hp camera and status line as the JAX
    session at every step, the precision tier promoted (DOUBLE -> QUAD),
    and at most one reference orbit per tier; the port's frames render
    (finite) at every 8th step and the last (the plain K3 on the CPU is
    launch-bound: a frame costs its iterations, not its pixels)."""
    from fractions import Fraction

    scene = Scene(hp_zoom="2e-14", max_iterations=256, **DEEP)
    mine, ref = _pair(scene, cols=12, rows=5)
    assert "DOUBLE:64b" in mine.status_line()
    now = 0.0
    for step in range(200):
        if Fraction(str(mine.scene.hp_zoom)) <= Fraction(1, 10 ** 20):
            break
        for s in (mine, ref):
            s.handle_event(("key", "e"), now)
            s.tick(now + 0.001, 1 / 60)
        assert _state(mine) == _state(ref)
        if step % 8 == 0:
            assert torch.isfinite(mine.dispatch()).all()
        now += 0.1
    assert Fraction(str(mine.scene.hp_zoom)) <= Fraction(1, 10 ** 20)
    assert "QUAD:" in mine.status_line()
    assert mine.scene.max_iterations > 256
    assert len(mine._orbit_cache) <= 6, len(mine._orbit_cache)
    cx_before = mine.scene.hp_center_x
    for s in (mine, ref):
        s.handle_event(("mouse", 0, 4, 2, "press"), now)
        s.handle_event(("mouse", 32, 6, 3, "motion"), now + 0.05)
        s.handle_event(("mouse", 0, 6, 3, "release"), now + 0.1)
    assert _state(mine) == _state(ref)
    assert mine.scene.hp_center_x != cx_before
    assert torch.isfinite(mine.dispatch()).all()


# ---- frames of the session's paths against the JAX session's --------------

def _gfx_pair(scene, kind="sixel", cols="8", lines="4", monkeypatch=None):
    from fractalrenderer_tpu import gfx as jax_gfx
    from fractalrenderer_tpu_torch import gfx

    monkeypatch.setenv("COLUMNS", cols)
    monkeypatch.setenv("LINES", lines)
    mine, ref = _pair(scene, cols=None, rows=None)
    mine.enable_gfx(gfx.GfxInfo(kind, None))
    ref.enable_gfx(jax_gfx.GfxInfo(kind, None))
    return mine, ref


def test_planar_gfx_frame_is_the_jax_sessions(monkeypatch):
    """Pixel sessions dispatch the planar uint8 path (3, H, W) on the
    session's device: 64x48 under an 8x4-cell sixel terminal."""
    mine, ref = _gfx_pair(Scene(max_iterations=64), monkeypatch=monkeypatch)
    img = mine.dispatch()
    assert img.device.type == "cpu" and img.dtype == torch.uint8
    assert tuple(img.shape) == (3, 48, 64)
    assert_2d_planes(img.numpy(), ref.dispatch(), ref.scene)
    # the same image through the planar renderer the port exposes
    from fractalrenderer_tpu_torch.models import common

    cfg = common.scene_static_cfg(mine.scene, 64, 48,
                                  *common.family_map()[FractalType.MANDELBROT],
                                  device="cpu")
    assert torch.equal(img, common.planar_render_fn(cfg, 8)(
        common.scene_dyn_params(mine.scene)))


@pytest.mark.parametrize("scene", [
    dict(max_iterations=64),
    dict(max_iterations=48, fractal_type=FractalType.JULIA,
         antialiasing_samples=2),
    dict(max_iterations=48, fractal_type=FractalType.BURNING_SHIP,
         orbit_trap_enabled=True),
], ids=["mandelbrot", "julia_aa2", "ship_trap"])
def test_cell_frame_is_the_jax_sessions(scene):
    """Half-block sessions dispatch the f32 (H, W, 3) path; the frame and
    the composed terminal string agree with the JAX session's."""
    mine, ref = _pair(Scene(**scene), cols=24, rows=9)
    img = mine.dispatch()
    assert img.dtype == torch.float32 and tuple(img.shape) == (18, 24, 3)
    q = (np.clip(img.numpy(), 0, 1) * 255 + 0.5).astype(np.uint8)
    jimg = np.asarray(ref.dispatch())
    jq = (np.clip(jimg, 0, 1) * 255 + 0.5).astype(np.uint8)
    assert_2d_planes(q.transpose(2, 0, 1), jq.transpose(2, 0, 1), ref.scene)
    assert compose_frame(mine, img.numpy()) == \
        jax_live.compose_frame(ref, img.numpy())


def test_deep_gfx_frame_is_the_jax_sessions(monkeypatch):
    """The deep zoom at 1e-12 through the session's orbit cache, quantized
    on the device: (H, W, 3) uint8 at 64x48."""
    mine, ref = _gfx_pair(Scene(hp_zoom="1e-12", max_iterations=1000,
                                **DEEP), monkeypatch=monkeypatch)
    img = mine.dispatch()
    assert img.dtype == torch.uint8 and tuple(img.shape) == (48, 64, 3)
    assert_deep_frames(img.numpy(), ref.dispatch())
    assert len(mine._orbit_cache) == 1


def test_bulb_gfx_frame_is_the_jax_sessions(monkeypatch):
    """The Mandelbulb frame (f32, quantized on the host when composed) at
    32x24 under a 4x2-cell terminal, then one spin tick."""
    mine, ref = _gfx_pair(Scene(fractal_type=FractalType.MANDELBULB,
                                max_iterations=16), cols="4", lines="3",
                          monkeypatch=monkeypatch)
    for s in (mine, ref):
        s.handle_event(("key", "o"), 0.0)
        s.tick(0.1, 0.1)
    assert _state(mine) == _state(ref)
    img = mine.dispatch()
    assert img.dtype == torch.float32 and tuple(img.shape) == (32, 32, 3)
    q = (np.clip(img.numpy(), 0, 1) * 255 + 0.5).astype(np.int64)
    jq = (np.clip(np.asarray(ref.dispatch()), 0, 1) * 255
          + 0.5).astype(np.int64)
    off = (np.abs(q - jq) > 1).any(axis=-1)
    assert off.mean() <= 0.01, off.mean()


# ---- frames in flight (FRAME_OVERLAP=2) ----------------------------------

class _Event:
    def __init__(self, done):
        self.done = done

    def query(self):
        return self.done


def test_pop_ready_waits_for_the_oldest_frame():
    q = deque()
    assert live.pop_ready(q) is None
    q.append((0.0, "a", _Event(False)))
    assert live.pop_ready(q) is None          # running, a second may go
    q.append((0.1, "b", _Event(False)))
    assert live.pop_ready(q)[1] == "a"        # two in flight: fetch waits
    assert live.pop_ready(q) is None
    q[0][2].done = True
    assert live.pop_ready(q)[1] == "b" and not q
    q.append((0.2, None, None))               # the minimap: no frame
    assert live.pop_ready(q) == (0.2, None, None)


def test_cpu_frames_are_ready_at_once():
    s = LiveSession(Scene(max_iterations=16), cols=8, rows=4, device="cpu")
    frame = s.dispatch()
    assert live.frame_event(frame) is None and live.frame_event(None) is None
    q = deque([(0.0, frame, live.frame_event(frame))])
    t0, got, _ = live.pop_ready(q)
    assert got is frame
    np.testing.assert_array_equal(live.fetch(got), frame.numpy())
    assert live.fetch(None) is None


def test_cuda_session_never_renders_on_the_cpu(monkeypatch):
    """A session on a CUDA device without CUDA raises at its first
    dispatch, out of run_live, before anything is drawn: there is no CPU
    preview and no fallback (the JAX session's render_preview_cpu has no
    counterpart)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    devices = []
    real = models.render

    def spy(scene, w, h, **kw):
        devices.append(str(kw.get("device")))
        return real(scene, w, h, **kw)

    monkeypatch.setattr(models, "render", spy)
    assert not hasattr(models, "render_preview_cpu")
    r, w = os.pipe()
    out = io.StringIO()
    try:
        with open(r, "rb", buffering=0) as fin:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                live.run_live(Scene(max_iterations=16), infile=fin,
                              outfile=out, cols=12, rows=4, max_frames=1,
                              gfx="off")
    finally:
        os.close(w)
    assert devices == ["cuda"]
    s = out.getvalue()
    assert "▀" not in s and "\x1b[7m" not in s  # no frame, no status bar
    assert s.endswith("\x1b[?1049l")              # the terminal restored
    sess = LiveSession(Scene(max_iterations=16), cols=8, rows=4)
    assert sess.device == "cuda" and sess.viewer.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sess.screenshot()
    assert devices == ["cuda", "cuda"]


def test_prewarm_ladder_renders_nothing(monkeypatch):
    import threading

    calls = []
    monkeypatch.setattr(models, "render", lambda *a, **k: calls.append(1))
    s = LiveSession(Scene(max_iterations=16), cols=8, rows=4, device="cpu")
    before = threading.active_count()
    assert s.prewarm_ladder() is None
    assert threading.active_count() == before and not calls


def test_termui_write_delivers_a_large_frame_whole():
    """TermUI.write sends a frame of several slices to a pty, each once the
    pty can take it, and every byte arrives in order; to a non-terminal it
    is one write and a flush."""
    import threading

    text = "\x1bP0;1;0q" + "".join(
        chr(63 + (i * 7919) % 63) for i in range(3 * live._WRITE_SLICE
                                                 + 123)) + "\x1b\\▀"
    m, sl = pty.openpty()
    got = b""
    try:
        with open(sl, "w", closefd=False) as fout:
            ui = live.TermUI(infile=io.BytesIO(), outfile=fout)
            t = threading.Thread(target=ui.write, args=(text,))
            t.start()
            want = text.encode()
            end = time.time() + 60
            while len(got) < len(want) and time.time() < end:
                r, _, _ = select.select([m], [], [], 0.05)
                if r:
                    got += os.read(m, 1 << 16)
            t.join(10)
    finally:
        os.close(m)
        os.close(sl)
    assert got == want
    out = io.StringIO()
    live.TermUI(infile=io.BytesIO(), outfile=out).write(text)
    assert out.getvalue() == text
