"""The port's in-band pixel graphics (``fractalrenderer_tpu_torch/gfx.py``)
and the live session's pixel path on the CPU device: twins of
tests/test_gfx.py, each run through the port and the JAX package on the same
seed-made inputs.

Escape strings (kitty chunking, iTerm2, sixel with the native encoder and
the NumPy one, ``compose_frame``) are identical; detection on the same pty
answers gives the same GfxInfo and the same pushed-back bytes; sessions fed
the same events end with the same Scene (JSON equal).  Rendered frames are
compared as pixels: the port's deep-zoom frames within 1 LSB of the JAX
session's on at least 98% of pixels (test_torch_deepzoom.py's contract:
the iteration counts of the two packages agree on at least 95% of pixels
and the colours within 1 LSB where they do); its planar uint8 2D frames within 1 LSB of the JAX golden
reference (``render_numpy``) everywhere and of the JAX session's frame on
at least 99% of pixels (the JAX kernels in interpret mode on the CPU leave
their own golden on ~0.1% of the pixels of a 480x272 frame at 512
iterations; the port's plain kernel does not).  The PNG bytes of a live
frame are not compared, because the status line carries each process's
own frame time.
"""
import base64
import io
import json
import os
import pty
import re
import struct
import tty

import numpy as np
import pytest

import fractalrenderer_tpu as fr
from fractalrenderer_tpu import gfx as jax_gfx
from fractalrenderer_tpu import live as jax_live
from fractalrenderer_tpu_torch import Scene, gfx, live
from fractalrenderer_tpu_torch.live import LiveSession, compose_frame
from fractalrenderer_tpu_torch.utils.png import read_png

GFX_ENV = ("FRACTAL_TPU_GFX", "TERM_PROGRAM", "LC_TERMINAL")


def _jax_scene(scene):
    return fr.Scene.from_dict(json.loads(scene.to_json()))


def _pair(scene, **kw):
    """The same session in both packages: (port on the CPU, JAX)."""
    return (LiveSession(scene, device="cpu", **kw),
            jax_live.LiveSession(_jax_scene(scene), **kw))


def _same_scene(a, b):
    assert json.loads(a.scene.to_json()) == json.loads(b.scene.to_json())


def _kitty_payload(out: str) -> bytes:
    """Reassemble the base64 payload of the first kitty image in ``out``."""
    parts = re.findall(r"\x1b_G([^;\x1b]*);([^\x1b]*)\x1b\\", out)
    payload = ""
    started = False
    for ctrl, data in parts:
        keys = dict(kv.split("=") for kv in ctrl.split(",") if "=" in kv)
        if keys.get("a") == "T":
            started = True
            payload = data
            if keys.get("m", "0") == "0":
                break
        elif started:
            payload += data
            if keys.get("m") == "0":
                break
    assert started, f"no kitty transmit found in {out[:200]!r}"
    return base64.standard_b64decode(payload)


def _png_pixels(png: bytes, tmp_path) -> np.ndarray:
    """The pixels of an in-memory PNG, through the port's reader."""
    path = tmp_path / f"f{len(list(tmp_path.iterdir()))}.png"
    path.write_bytes(png)
    return read_png(str(path)).astype(np.int64)


def assert_2d_planes(mine, ref, jscene):
    """Uint8 planes (3, H, W) of a 2D frame: within 1 LSB of the JAX golden
    render of ``jscene`` everywhere, and of the JAX session's planes
    ``ref`` on at least 99% of pixels."""
    mine = np.asarray(mine).astype(np.int64)
    h, w = mine.shape[1:]
    gold = fr.render_numpy(jscene, w, h)
    gold = (np.clip(gold, 0.0, 1.0) * 255.0 + 0.5).astype(np.int64)
    assert np.abs(mine - gold.transpose(2, 0, 1)).max() <= 1
    off = np.abs(mine - np.asarray(ref).astype(np.int64)).max(axis=0) > 1
    assert off.mean() <= 0.01, off.mean()


def assert_deep_frames(mine, ref):
    """(H, W, 3) uint8 deep-zoom frames: within 1 LSB of the JAX session's
    on at least 98% of pixels."""
    d = np.abs(np.asarray(mine).astype(np.int64)
               - np.asarray(ref).astype(np.int64))
    off = (d > 1).any(axis=-1)
    assert off.mean() <= 0.02, off.mean()


def _png_dims(png: bytes):
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    return struct.unpack(">II", png[16:24])


def _run_live_both(monkeypatch, env, scene, **kw):
    """run_live of both packages with ``env`` set, reading a pipe that stays
    open (max_frames ends the loop): their terminal output strings."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    outs = []
    for mod, sc, extra in ((live, scene, dict(device="cpu")),
                           (jax_live, _jax_scene(scene), {})):
        r, w = os.pipe()
        out = io.StringIO()
        try:
            with open(r, "rb", buffering=0) as fin:
                mod.run_live(sc, infile=fin, outfile=out, **kw, **extra)
        finally:
            os.close(w)
        outs.append(out.getvalue())
    return outs


# ---- emit_frame ------------------------------------------------------------

def test_kitty_emit_chunking_round_trips():
    blob = np.random.default_rng(1).bytes(9000)  # b64 ≈ 12000 > 2 chunks
    out = gfx.emit_frame(gfx.GfxInfo("kitty", None), blob, cols=80, rows=24)
    assert out == jax_gfx.emit_frame(jax_gfx.GfxInfo("kitty", None), blob,
                                     cols=80, rows=24)
    head = out[: out.index(";")]
    for want in ("a=T", "f=100", "q=2", "z=-1", "c=80", "r=24", "m=1"):
        assert want in head, head
    assert _kitty_payload(out) == blob
    small = gfx.emit_frame(gfx.GfxInfo("kitty", None), b"x" * 10, 2, 2,
                           image_id=7)
    assert small == jax_gfx.emit_frame(jax_gfx.GfxInfo("kitty", None),
                                       b"x" * 10, 2, 2, image_id=7)
    assert small.count("\x1b_G") == 1 and "m=" not in small.split(";")[0]


def test_iterm_emit():
    blob = np.random.default_rng(2).bytes(333)
    out = gfx.emit_frame(gfx.GfxInfo("iterm", None), blob, cols=10, rows=5)
    assert out == jax_gfx.emit_frame(jax_gfx.GfxInfo("iterm", None), blob,
                                     cols=10, rows=5)
    assert out.startswith("\x1b]1337;File=inline=1")
    assert f"size={len(blob)}" in out and "width=10" in out
    assert out.endswith("\x07")
    assert base64.standard_b64decode(out.split(":")[-1][:-1]) == blob


# ---- detection -------------------------------------------------------------

def test_detect_forced_and_off(monkeypatch):
    monkeypatch.delenv("FRACTAL_TPU_GFX", raising=False)
    for force in ("kitty", "iterm", "sixel", "off", "none", "0", "bogus"):
        a = gfx.detect(None, None, force=force)
        b = jax_gfx.detect(None, None, force=force)
        assert (a and (a.kind, a.term_px)) == (b and (b.kind, b.term_px))
    for env in ("kitty", "off", "SIXEL"):
        monkeypatch.setenv("FRACTAL_TPU_GFX", env)
        a, b = gfx.detect(None, None), jax_gfx.detect(None, None)
        assert (a and a.kind) == (b and b.kind)
    monkeypatch.setenv("FRACTAL_TPU_GFX", "kitty")
    assert gfx.detect(None, None, force="auto").kind == "kitty"
    monkeypatch.setenv("FRACTAL_TPU_GFX", "off")
    assert gfx.detect(None, None) is None


def test_detect_iterm_env(monkeypatch):
    monkeypatch.delenv("FRACTAL_TPU_GFX", raising=False)
    monkeypatch.setenv("TERM_PROGRAM", "iTerm.app")
    assert gfx.detect(io.BytesIO(), io.StringIO()).kind == "iterm"
    assert jax_gfx.detect(io.BytesIO(), io.StringIO()).kind == "iterm"
    monkeypatch.delenv("TERM_PROGRAM")
    monkeypatch.setenv("LC_TERMINAL", "iTerm2")
    assert gfx.detect(io.BytesIO(), io.StringIO()).kind == "iterm"


def test_detect_non_tty_returns_none(monkeypatch):
    for k in GFX_ENV:
        monkeypatch.delenv(k, raising=False)
    r, w = os.pipe()
    try:
        with open(r, "rb", buffering=0) as fin:
            assert gfx.detect(fin, io.StringIO()) is None
            assert jax_gfx.detect(fin, io.StringIO()) is None
            info = gfx.GfxInfo("kitty", (10, 10))
            assert gfx.requery(fin, io.StringIO(), info) is info
    finally:
        os.close(w)


def _handshake(mod, answers: bytes, **kw):
    """``mod.detect`` on a raw pty preloaded with ``answers``: (GfxInfo,
    the bytes pushed back, what detect wrote)."""
    m, sl = pty.openpty()
    tty.setraw(sl)
    got = []
    try:
        os.write(m, answers)
        with open(sl, "rb", buffering=0, closefd=False) as fin, \
                open(sl, "w", closefd=False) as fout:
            info = mod.detect(fin, fout, timeout=2.0, pushback=got.append,
                              **kw)
        written = os.read(m, 4096)
    finally:
        os.close(m)
        os.close(sl)
    return info, got, written


def _info(i):
    return None if i is None else (i.kind, i.term_px, i.cell_px)


@pytest.mark.parametrize("answers", [
    b"\x1b_Gi=31;OK\x1b\\\x1b[4;320;640t\x1b[?62;c",
    b"\x1b[?62;c",
], ids=["kitty", "plain"])
def test_detect_handshake_on_pty(monkeypatch, answers):
    for k in GFX_ENV:
        monkeypatch.delenv(k, raising=False)
    mine, _, wrote = _handshake(gfx, answers)
    ref, _, jwrote = _handshake(jax_gfx, answers)
    assert _info(mine) == _info(ref) and wrote == jwrote
    if b"_G" in answers:
        assert mine.kind == "kitty" and mine.term_px == (640, 320)
        w, h = gfx.pick_render_size(mine, 80, 24, 23)
        assert (w, h) == jax_gfx.pick_render_size(ref, 80, 24, 23)
        assert w == 640 and h == int(23 * (320 / 24)) // 2 * 2
    else:
        assert mine is None


def test_detect_pushes_back_typeahead(monkeypatch):
    for k in GFX_ENV:
        monkeypatch.delenv(k, raising=False)
    answers = b"\x1b_Gi=31;OK\x1b\\\x1b[?62;c" b"eee"  # user held 'e'
    mine, got, _ = _handshake(gfx, answers)
    ref, jgot, _ = _handshake(jax_gfx, answers)
    assert _info(mine) == _info(ref) and mine.kind == "kitty"
    assert got == jgot == [b"eee"]


def test_pick_render_size_defaults_and_caps():
    rng = np.random.default_rng(3)
    cases = [(None, 120, 35, 34), ((10000, 8000), 500, 100, 99)]
    cases += [((int(rng.integers(100, 4000)), int(rng.integers(100, 3000))),
               int(rng.integers(1, 300)), int(rng.integers(2, 100)),
               int(rng.integers(1, 99))) for _ in range(40)]
    for term_px, cols, rows, img_rows in cases:
        for cell in ((8.0, 16.0), (10.0, 20.0), (7.0, 15.0)):
            a = gfx.pick_render_size(gfx.GfxInfo("kitty", term_px, cell),
                                     cols, rows, img_rows)
            b = jax_gfx.pick_render_size(
                jax_gfx.GfxInfo("kitty", term_px, cell), cols, rows,
                img_rows)
            assert a == b, (term_px, cols, rows, img_rows, cell)
    assert gfx.pick_render_size(gfx.GfxInfo("kitty", None), 120, 35,
                                34) == (960, 544)
    assert gfx.pick_render_size(gfx.GfxInfo("kitty", (10000, 8000)), 500,
                                100, 99) == (1920, 1080)  # capped


# ---- live-session gfx path --------------------------------------------------

def test_live_session_gfx_frame_bytes(monkeypatch, tmp_path):
    """run_live with a forced kitty backend emits protocol-correct PNG
    frames at pixel resolution, placed as the JAX session places them, with
    the same pixels."""
    mine, ref = _run_live_both(
        monkeypatch, dict(COLUMNS="24", LINES="9", FRACTAL_TPU_GFX="kitty"),
        Scene(max_iterations=24), max_frames=1)
    png, jpng = _kitty_payload(mine), _kitty_payload(ref)
    assert _png_dims(png) == _png_dims(jpng) == (192, 128)
    lsb = np.abs(_png_pixels(png, tmp_path)
                 - _png_pixels(jpng, tmp_path)).max()
    assert lsb <= 1, lsb
    head = mine[mine.index("\x1b_G"):].split(";")[0]
    assert head == ref[ref.index("\x1b_G"):].split(";")[0]
    assert "c=24" in head and "r=8" in head
    assert "\x1b[9;1H" in mine and "\x1b[7m" in mine
    # the terminal set-up precedes the frame as in the JAX session, and
    # the session cleanup deletes the placements before leaving alt screen
    assert mine[:mine.index("\x1b_Ga=T")] == ref[:ref.index("\x1b_Ga=T")]
    assert mine.endswith("\x1b_Ga=d,d=A,q=2\x1b\\\x1b[?1006l\x1b[?1002l"
                         "\x1b[?25h\x1b[?1049l")
    assert ref.endswith(mine[-40:])


def test_live_session_gfx_mouse_scaling(monkeypatch):
    """Mouse cells map through px_per_cell: a double-click at the window
    center zooms to the view center, in both packages to the same Scene."""
    monkeypatch.setenv("COLUMNS", "20")
    monkeypatch.setenv("LINES", "11")
    mine, ref = _pair(Scene(max_iterations=16))
    mine.enable_gfx(gfx.GfxInfo("kitty", None))
    ref.enable_gfx(jax_gfx.GfxInfo("kitty", None))
    assert (mine.viewer.width, mine.viewer.height) == (160, 160)
    assert mine.px_per_cell == ref.px_per_cell == (8.0, 16.0)
    c0 = mine.scene.center_x
    for s in (mine, ref):
        s.handle_event(("mouse", 0, 10, 5, "press"), 1.0)
        s.handle_event(("mouse", 0, 10, 5, "press"), 1.1)
        s.handle_event(("mouse", 0, 3, 7, "press"), 2.0)
        s.handle_event(("mouse", 0, 5, 9, "motion"), 2.1)
        s.handle_event(("mouse", 2, 12, 2, "press"), 2.2)
    _same_scene(mine, ref)
    assert mine.scene.zoom != Scene().zoom
    assert abs(mine.scene.center_x - c0) < 0.5


def test_live_session_gfx_overlays(monkeypatch):
    """Help draws over the image as text; the minimap clears the image and
    falls back to the text composer; the strings equal the JAX session's
    for the same uint8 planes."""
    monkeypatch.setenv("COLUMNS", "20")
    monkeypatch.setenv("LINES", "6")
    mine, ref = _pair(Scene(max_iterations=16))
    mine.enable_gfx(gfx.GfxInfo("kitty", None))
    ref.enable_gfx(jax_gfx.GfxInfo("kitty", None))
    img = np.random.default_rng(4).integers(
        0, 256, (3, mine.height, mine.width), dtype=np.uint8)
    for s in (mine, ref):
        s.show_help = True
    a, b = compose_frame(mine, img), jax_live.compose_frame(ref, img)
    assert a == b and "\x1b_G" in a and "w a s d" in a
    for s in (mine, ref):
        s.show_help = False
        s.show_minimap = True
    a, b = compose_frame(mine, img), jax_live.compose_frame(ref, img)
    assert a == b
    assert "\x1b_Ga=d,d=A" in a and "\x1b_Ga=T" not in a
    mine.show_minimap = False
    compose_frame(mine, img)
    key, blob = mine._png_cache
    compose_frame(mine, img)
    assert mine._png_cache == (key, blob)


# ---- sixel -----------------------------------------------------------------

def _decode_sixel(s: str, w: int, h: int) -> np.ndarray:
    """Minimal sixel decoder (palette defs + color runs)."""
    assert s.startswith("\x1bP0;1;0q") and s.endswith("\x1b\\")
    body = s[len("\x1bP0;1;0q"):-2]
    assert body.startswith(f'"1;1;{w};{h}')
    body = body[len(f'"1;1;{w};{h}'):]
    pal = {}
    img = np.zeros((h, w, 3), np.uint8)
    i = y0 = x = color = 0
    while i < len(body):
        ch = body[i]
        if ch == "#":
            j = i + 1
            while j < len(body) and body[j].isdigit():
                j += 1
            idx = int(body[i + 1:j])
            if j < len(body) and body[j] == ";":
                parts = []
                k = j
                for _ in range(4):
                    k2 = k + 1
                    while k2 < len(body) and body[k2].isdigit():
                        k2 += 1
                    parts.append(int(body[k + 1:k2]))
                    k = k2
                assert parts[0] == 2
                pal[idx] = tuple(round(p * 255 / 100) for p in parts[1:])
                i = k
            else:
                color = idx
                i = j
            continue
        if ch == "$":
            x = 0
            i += 1
            continue
        if ch == "-":
            y0 += 6
            x = 0
            i += 1
            continue
        if ch == "!":
            j = i + 1
            while body[j].isdigit():
                j += 1
            n = int(body[i + 1:j])
            bits = ord(body[j]) - 63
            i = j + 1
        else:
            n, bits = 1, ord(ch) - 63
            i += 1
        for k in range(6):
            if bits & (1 << k) and y0 + k < h:
                img[y0 + k, x:x + n] = pal[color]
        x += n
    return img


def test_sixel_round_trip():
    img8 = np.random.default_rng(7).integers(0, 256, (20, 33, 3), np.uint8)
    s = gfx.encode_frame(gfx.GfxInfo("sixel", None), img8, 33, 4)
    assert s == jax_gfx.encode_frame(jax_gfx.GfxInfo("sixel", None), img8,
                                     33, 4)
    dec = _decode_sixel(s, 33, 20)
    r = img8[..., 0].astype(np.int32) * 6 // 256
    g = img8[..., 1].astype(np.int32) * 7 // 256
    b = img8[..., 2].astype(np.int32) * 6 // 256

    def chan(v, levels):
        pct = np.round(v * 100 / (levels - 1)).astype(int)
        return np.round(pct * 255 / 100).astype(int)

    want = np.stack([chan(r, 6), chan(g, 7), chan(b, 6)], axis=-1)
    np.testing.assert_array_equal(dec, want)


def _sixel_frames():
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:32, 0:57]
    return [
        rng.integers(0, 256, (20, 33, 3), np.uint8),
        np.stack([(xx * 4 % 256).astype(np.uint8),
                  (yy * 7 % 256).astype(np.uint8),
                  np.full_like(xx, 9, np.uint8)], -1),
        np.zeros((7, 130, 3), np.uint8),
    ]


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_sixel_native_matches_numpy(monkeypatch, native):
    """The port's sixel string equals the JAX package's, through
    native/sixel.cpp and through the NumPy fallback, across noise, smooth
    runs and a height that is not a multiple of 6."""
    if native and gfx._load_sixel_native() is None:
        pytest.skip("no native toolchain")
    if not native:
        monkeypatch.setattr(gfx, "_load_sixel_native", lambda: None)
    for img8 in _sixel_frames():
        h, w = img8.shape[:2]
        s = gfx.sixel_frame(img8)
        assert s == jax_gfx.sixel_frame(img8)
        r = img8[..., 0].astype(np.int32) * 6 // 256
        g = img8[..., 1].astype(np.int32) * 7 // 256
        b = img8[..., 2].astype(np.int32) * 6 // 256
        body = jax_gfx._sixel_body_numpy(r * 42 + g * 6 + b, h, w)
        prefix = "\x1bP0;1;0q" + f'"1;1;{w};{h}' + gfx._SIXEL_PALETTE
        assert s == prefix + body + "\x1b\\"


def test_encode_frame_kitty_and_iterm_png(tmp_path):
    """encode_frame's kitty and iTerm2 strings carry the port's PNG of the
    frame, equal to the JAX package's string (the PNG bytes of both
    writers are equal at compress level 1)."""
    img8 = np.random.default_rng(8).integers(0, 256, (12, 20, 3), np.uint8)
    for kind in ("kitty", "iterm"):
        a = gfx.encode_frame(gfx.GfxInfo(kind, None), img8, 5, 2)
        b = jax_gfx.encode_frame(jax_gfx.GfxInfo(kind, None), img8, 5, 2)
        assert a == b, kind
    png = _kitty_payload(gfx.encode_frame(gfx.GfxInfo("kitty", None), img8,
                                          5, 2))
    np.testing.assert_array_equal(_png_pixels(png, tmp_path), img8)


def test_detect_sixel_via_da1(monkeypatch):
    for k in GFX_ENV:
        monkeypatch.delenv(k, raising=False)
    answers = b"\x1b[4;240;480t\x1b[6;20;10t\x1b[?62;4;22c"
    mine, _, _ = _handshake(gfx, answers)
    ref, _, _ = _handshake(jax_gfx, answers)
    assert _info(mine) == _info(ref) == ("sixel", (480, 240), (10.0, 20.0))
    # capability 44 (not 4) must NOT match
    assert _handshake(gfx, b"\x1b[?62;44;22c")[0] is None


def test_requery_keeps_kind_on_pty(monkeypatch):
    """requery refreshes the geometry from the size reports (no kitty
    probe) and keeps the kind, as the JAX requery does."""
    for k in GFX_ENV:
        monkeypatch.delenv(k, raising=False)
    answers = b"\x1b[4;300;900t\x1b[6;15;9t\x1b[?62;4c" b"w"
    got = {}
    for mod in (gfx, jax_gfx):
        m, sl = pty.openpty()
        tty.setraw(sl)
        back = []
        try:
            os.write(m, answers)
            with open(sl, "rb", buffering=0, closefd=False) as fin, \
                    open(sl, "w", closefd=False) as fout:
                info = mod.requery(fin, fout, mod.GfxInfo("kitty", (1, 1)),
                                   timeout=2.0, pushback=back.append)
            wrote = os.read(m, 4096)
        finally:
            os.close(m)
            os.close(sl)
        got[mod] = (_info(info), back, wrote)
    assert got[gfx] == got[jax_gfx]
    assert got[gfx][0] == ("kitty", (900, 300), (9.0, 15.0))
    assert got[gfx][1] == [b"w"] and b"_G" not in got[gfx][2]


def test_live_session_sixel_frame(monkeypatch):
    mine, ref = _run_live_both(
        monkeypatch, dict(COLUMNS="20", LINES="7", FRACTAL_TPU_GFX="sixel"),
        Scene(max_iterations=16), max_frames=1)
    assert "\x1bP0;1;0q" in mine and mine.count("\x1b\\") >= 1
    assert '"1;1;160;96' in mine
    # the sixel images are the same string: the frames agree to the LSB at
    # this size, so the 6x7x6 quantization lands on the same palette
    i, j = mine.index("\x1bP0;1;0q"), ref.index("\x1bP0;1;0q")
    assert mine[i:mine.index("\x1b\\", i) + 2] == \
        ref[j:ref.index("\x1b\\", j) + 2]


def test_gfx_interactive_degradation(monkeypatch):
    """Big pixel windows render HALF resolution while keys are held and
    snap back on the settle frame, as the JAX session does; the frames of
    both scales equal the JAX session's within 1 LSB."""
    monkeypatch.setenv("COLUMNS", "120")
    monkeypatch.setenv("LINES", "35")
    mine, ref = _pair(Scene(max_iterations=16))
    mine.enable_gfx(gfx.GfxInfo("kitty", None))
    ref.enable_gfx(jax_gfx.GfxInfo("kitty", None))
    assert (mine.viewer.width, mine.viewer.height) == (960, 544)
    img = mine.dispatch().numpy()
    assert img.shape == (3, 544, 960) and img.dtype == np.uint8
    assert_2d_planes(img, ref.dispatch(), ref.scene)
    for s in (mine, ref):
        s.handle_event(("key", "e"), 0.0)
        s.tick(0.01, 0.016)
    _same_scene(mine, ref)
    assert mine._gfx_scale() == ref._gfx_scale() == 2
    img2 = mine.dispatch().numpy()
    assert img2.shape == (3, 272, 480)
    assert_2d_planes(img2, ref.dispatch(), ref.scene)
    for s in (mine, ref):
        s.dirty = False
        s.tick(10.0, 0.016)
    assert mine.dirty and ref.dirty and mine._gfx_scale() == 1
    monkeypatch.setenv("COLUMNS", "20")
    monkeypatch.setenv("LINES", "8")
    small = LiveSession(Scene(max_iterations=16), device="cpu")
    small.enable_gfx(gfx.GfxInfo("kitty", None))
    small.handle_event(("key", "e"), 0.0)
    assert small._gfx_scale() == 1
    monkeypatch.setenv("COLUMNS", "120")
    monkeypatch.setenv("LINES", "35")
    six = LiveSession(Scene(max_iterations=16), device="cpu")
    six.enable_gfx(gfx.GfxInfo("sixel", None))
    six.handle_event(("key", "e"), 0.0)
    assert six._gfx_scale() == 1
    six.tick(0.01, 0.016)
    six.dirty = False
    six.tick(10.0, 0.016)
    assert not six.dirty


def test_gfx_degradation_applies_to_deep_zoom(monkeypatch):
    """Deep-zoom dispatch also renders half-res during interaction, one
    orbit serving both sizes; each frame equals the JAX session's within 1
    LSB."""
    monkeypatch.setenv("COLUMNS", "12")
    monkeypatch.setenv("LINES", "5")
    monkeypatch.setattr(live, "_DEGRADE_MIN_PIXELS", 1000)
    monkeypatch.setattr(jax_live, "_DEGRADE_MIN_PIXELS", 1000)
    mine, ref = _pair(Scene(
        fractal_type=live.FractalType.DEEP_ZOOM,
        hp_center_x="-0.74364388703715158",
        hp_center_y="0.13182590420531198",
        hp_zoom="1e-8", max_iterations=300, use_perturbation=True))
    mine.enable_gfx(gfx.GfxInfo("kitty", None))
    ref.enable_gfx(jax_gfx.GfxInfo("kitty", None))
    assert (mine.viewer.width, mine.viewer.height) == (96, 64)
    img = mine.dispatch().numpy()
    assert img.shape == (64, 96, 3) and img.dtype == np.uint8
    assert_deep_frames(img, ref.dispatch())
    for s in (mine, ref):
        s.handle_event(("key", "e"), 0.0)
        s.tick(0.01, 0.016)
    _same_scene(mine, ref)
    img2 = mine.dispatch().numpy()
    assert img2.shape == (32, 48, 3)
    assert_deep_frames(img2, ref.dispatch())
    assert len(mine._orbit_cache) >= 1
