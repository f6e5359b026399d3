"""Live raw-terminal interactive session of the PyTorch port (the counterpart
of ``fractalrenderer_tpu/live.py``) — the equivalent of the reference's
real-time SDL event loop (src/vk_engine.cpp:630-733).

Where viewer.py is a line-based REPL (type a command, get a frame), this
module is the *live* experience the reference is built around: a cbreak
terminal event loop polling input every frame, immediate single-keystroke
hotkeys, **continuous** held-key pan/zoom with zoom-proportional speed
(src/input_handler.h:211-248), SGR mouse reporting (wheel zoom, drag pan,
double-click zoom-to-point, right-click zoom-out — input_handler.h:101-163),
an auto-rotating mandelbulb (vk_engine.cpp:713), and a status line with live
frame times.  Frames render on the session's device (CUDA by default: the
port's kernels; ``device="cpu"`` runs their plain PyTorch versions) with up
to two frames in flight (the reference's FRAME_OVERLAP=2, vk_engine.h:44):
a frame's kernels are queued on the current CUDA stream, a CUDA event
recorded behind them tells the loop when the frame can be fetched, and the
loop polls input meanwhile (2D and Mandelbulb frames).  A deep-zoom frame
synchronizes inside models/deep_zoom.render (it builds the reference orbit
on the host and reads the glitch count back before colouring), so it is
complete when dispatch returns: no two deep frames are ever in flight.
Nothing is drawn before the device's first frame lands: there is no CPU
preview.

Display: in a kitty-graphics or iTerm2 terminal the session shows REAL
PIXEL frames at the window's native resolution, ≤1080p (gfx.py — the
answer to the reference's 1700×900 SDL window, vk_engine.h:74), detected
by an in-band handshake at startup (--gfx / $FRACTAL_TPU_GFX force or
disable it).  Other terminals keep truecolor half-block cells.

Hotkey map (every binding in input_handler.h:165-248 mapped or N/A'd):

  w/a/s/d, arrows  continuous pan, speed = zoom * dt * 2 (:211-235)
  q / e            continuous zoom out/in + auto-iteration ladder
                   (:238-245 -> vk_engine.cpp:1731-1756), dt-scaled to the
                   reference's 60 fps frame loop
  r                reset view (:167)
  Tab              next fractal type (:170)
  S                screenshot -> screenshot_NNN.png (:176; lowercase s pans)
  Space            toggle status bar (:179 toggled the ImGui UI)
  h                help overlay (:182)
  f                fullscreen: render at the full terminal size (:185)
  [ / ]            max_iterations -/+ 64 (:188-193)
  1-6              palette 0-5 (:194-196)
  z/x/c            deep-zoom presets Seahorse/Elephant/Mini (:198-206)
  o                toggle mandelbulb auto-rotate (ui_manager.cpp:1302-1306;
                   rotation_y += speed * dt per frame, vk_engine.cpp:713;
                   `:spin [SPEED]` is the Rotation Speed slider, 0.1-2.0)
  + / -            single zoom step (wheel semantics); on the mandelbulb the
                   wheel moves camera_distance in [1, 10] (:102-107)
  m                minimap view
  :                command line (all viewer.py REPL commands, incl.
                   `scene save FILE` / `scene load FILE`)
  Esc / Ctrl-C     quit (SDL_QUIT path)

  N/A from the reference: window minimize/restore + resize debounce (no
  window), ImGui capture flags (no widgets), clipboard copy (use
  `:coords`).

Latency: at terminal resolutions K1 is a few hundredths of a millisecond
on an H100; the loop overlaps device work with input polling, so
keypress-to-frame is set by the poll, the fetch and the frame's encode
(bench_all config 8 measures it on a pty).
"""
from __future__ import annotations

import os
import select
import shutil
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

import torch

from . import models, presets
from .scene import FractalType, Scene, _auto_iterations_wheel
from .viewer import Viewer, _TYPES

# Keys driven by process_continuous_input (input_handler.h:211-248).
_CONTINUOUS = {"w", "a", "s", "d", "q", "e", "up", "down", "left", "right"}
# Autorepeat emulation: the reference reads the true key state each frame
# (SDL_GetKeyboardState), which a terminal cannot expose — we infer "held"
# from the autorepeat stream instead.  A first press acts briefly (a tap
# moves a little); once a repeat for the same key arrives the key is
# clearly held, so the window widens to bridge repeat gaps and the
# initial-delay pause.
_TAP_S = 0.08
_HOLD_S = 0.45
_REPEAT_DETECT_S = 0.6
_REF_FPS = 60.0  # the reference applies one handle_zoom per ~60 Hz frame
_ROTATION_SPEED = 0.5  # fractal_state.h:68
# TermUI.write's slice of a frame's bytes on a terminal descriptor
_WRITE_SLICE = 65536
# Pixel sessions below this render size never degrade during interaction
# (they are already fetch-cheap); above it, held-key frames render at
# half resolution and the terminal scales the placement.
_DEGRADE_MIN_PIXELS = 500_000

Event = Tuple  # ("key", name) | ("mouse", btn, cx, cy, kind)


def _session_file() -> str:
    """Where the last session's Scene persists (the reference resumes
    implicitly via imgui.ini next to the binary; we keep the analog under
    XDG config).  FRACTAL_TPU_SESSION_FILE overrides (tests)."""
    return os.environ.get("FRACTAL_TPU_SESSION_FILE") or os.path.join(
        os.path.expanduser("~"), ".config", "fractalrenderer_tpu",
        "last_session.json")


def load_last_session() -> Optional[Scene]:
    """Best-effort restore of the previous session's Scene (None if no
    file, unreadable, or stale-format)."""
    try:
        with open(_session_file()) as fh:
            return Scene.from_json(fh.read())
    except Exception:
        return None


def save_last_session(scene: Scene) -> None:
    """Best-effort persist; atomic so a crash mid-write can't corrupt the
    resume file."""
    try:
        path = _session_file()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(scene.to_json(indent=2))
        os.replace(tmp, path)
    except OSError:
        pass


def parse_input(buf: bytes) -> Tuple[List[Event], bytes]:
    """Parse raw terminal bytes into events; returns (events, remainder).

    Handles plain keys, CSI arrows, and SGR-1006 mouse reports.  The
    remainder holds an incomplete trailing escape sequence, fed back on
    the next read.
    """
    events: List[Event] = []
    i, n = 0, len(buf)
    while i < n:
        b = buf[i]
        if b != 0x1B:
            ch = chr(b)
            if ch == "\t":
                events.append(("key", "tab"))
            elif ch in ("\r", "\n"):
                events.append(("key", "enter"))
            elif ch in ("\x7f", "\x08"):
                events.append(("key", "backspace"))
            elif ch == "\x03":
                events.append(("key", "ctrl-c"))
            elif b >= 0x20:
                events.append(("key", ch))
            i += 1
            continue
        # ESC ...
        if i + 1 >= n:
            # Lone ESC at the end: could be the Esc key or a split
            # sequence; defer to the caller (it re-reads with a tiny
            # timeout and flushes a bare ESC as the Esc key).
            return events, buf[i:]
        if buf[i + 1] != ord("["):
            events.append(("key", "esc"))
            i += 1
            continue
        # CSI
        j = i + 2
        while j < n and not (0x40 <= buf[j] <= 0x7E):
            j += 1
        if j >= n:
            return events, buf[i:]
        body, final = buf[i + 2:j].decode("ascii", "replace"), chr(buf[j])
        i = j + 1
        if final in "ABCD" and not body:
            events.append(("key", {"A": "up", "B": "down", "C": "right",
                                   "D": "left"}[final]))
        elif final in "Mm" and body.startswith("<"):
            try:
                btn, cx, cy = (int(p) for p in body[1:].split(";"))
            except ValueError:
                continue
            if btn & 64 and not (btn & 32):
                # wheel: bit 6 set; shift/meta/ctrl add 4/8/16 — mask the
                # low 2 bits for direction; 2/3 = horizontal wheel (ignore)
                sub = btn & 3
                if sub > 1:
                    continue
                kind = "wheelup" if sub == 0 else "wheeldown"
            elif btn & 32:
                kind = "motion"
            else:
                kind = "press" if final == "M" else "release"
            events.append(("mouse", btn & 3, cx - 1, cy - 1, kind))
        # other CSI sequences are ignored
    return events, b""


@dataclass
class FrameStats:
    """Rolling frame-time average for the status line (the reference
    shows ImGui's Framerate, ui_manager.cpp:572)."""

    times: List[float] = field(default_factory=list)

    def add(self, seconds: float) -> None:
        self.times.append(seconds)
        del self.times[:-20]

    @property
    def ms(self) -> float:
        return 1e3 * (sum(self.times) / len(self.times)) if self.times \
            else 0.0


class LiveSession:
    """All interactive state + input semantics, terminal-free (the pty
    loop in run_live drives it; tests drive it directly)."""

    def __init__(self, scene: Optional[Scene] = None,
                 cols: Optional[int] = None, rows: Optional[int] = None,
                 spin: bool = False, device="cuda"):
        # every render of the session (frames, screenshots, `:` commands)
        # runs on this device; none moves to another on its own
        self.viewer = Viewer(scene, cols=cols, rows=rows, device=device)
        self._base_size = (self.viewer.width, self.viewer.height)
        # pixel-graphics backend (gfx.GfxInfo) — None keeps half-blocks;
        # px_per_cell maps mouse cells → render pixels (half-block cells
        # are 1×2 render pixels; a kitty/iTerm2 image cell is
        # width/cols × height/rows)
        self.gfx = None
        self.gfx_cols = 0
        self.gfx_rows = 0
        # set by _live_loop once gfx is enabled: re-runs the pixel-size
        # queries (CSI 14t/16t) so a resize/fullscreen toggle refreshes
        # term_px/cell_px instead of reusing the startup handshake's
        self.gfx_requery = None
        self.px_per_cell = (1.0, 2.0)
        # one-shot out-of-band escape bytes (OSC 52 clipboard copy),
        # consumed by the next compose_frame
        self.pending_osc = ""
        self._png_cache: Tuple = (None, b"")
        self._was_interactive = False
        self._last_scale = 1
        self.spin = spin
        self.spin_speed = _ROTATION_SPEED  # Rotation Speed slider
        self.running = True
        self.dirty = True
        self.show_status = True
        self.show_help = False
        self.show_minimap = False
        self.fullscreen = False
        self.held: dict = {}
        self._last_key_at: dict = {}
        # one session orbit cache: held-key renders, screenshots, and
        # `:`-commands (incl. :export) all reuse the same deep orbits
        self._orbit_cache: dict = self.viewer._orbit_cache
        self.stats = FrameStats()
        self.message = ""
        self._shot_n = 0
        self._last_click: Tuple[float, int, int] = (-1e9, 0, 0)
        self._dragging = False
        self._drag_at: Tuple[int, int] = (0, 0)
        # command-line mode: None = off; a string = the line being typed
        self.cmdline: Optional[str] = None
        self.redraw = True  # recompose overlays without re-rendering
        # timeline playback (the reference's AnimationSystem::play —
        # animation_system.cpp:40-80): scene follows a keyframes.Playback
        # clock (None = not playing), which owns end-of-timeline and
        # loop-wrap semantics
        self.playback = None

    # -- playback ---------------------------------------------------------
    @property
    def playing(self) -> bool:
        return self.playback is not None and self.playback.playing

    @property
    def play_t(self) -> float:
        return self.playback.current_time if self.playback else 0.0

    def _stop_playback(self, message: str) -> None:
        self.playback = None
        self.message = message

    # -- geometry ---------------------------------------------------------
    @property
    def scene(self) -> Scene:
        return self.viewer.scene

    @scene.setter
    def scene(self, s: Scene) -> None:
        if s is not self.viewer.scene:
            self.viewer.scene = s
            self.dirty = True

    @property
    def device(self):
        return self.viewer.device

    @property
    def width(self) -> int:
        return self.viewer.width

    @property
    def height(self) -> int:
        return self.viewer.height

    def _set_fullscreen(self, on: bool) -> None:
        self.fullscreen = on
        if self.gfx is not None:
            # pixel mode already fills the window — re-measure in case
            # the terminal was resized since the session started (incl.
            # the PIXEL geometry: cols/rows alone leave the cell-size
            # estimate and px_per_cell mouse mapping stale)
            if self.gfx_requery is not None:
                try:
                    self.gfx = self.gfx_requery(self.gfx)
                except Exception:
                    pass
            self.enable_gfx(self.gfx)
            return
        if on:
            tw, th = shutil.get_terminal_size((100, 40))
            self.viewer.width = tw
            self.viewer.height = max(2, (th - 1) * 2)
        else:
            self.viewer.width, self.viewer.height = self._base_size
        self.dirty = True

    def enable_gfx(self, info) -> None:
        """Switch to in-band pixel frames (kitty/iTerm2): render at the
        terminal's real pixel size (≤1080p) instead of half-block cells —
        the reference's 1700×900 interactive window, finally matched
        (vk_engine.h:74)."""
        from . import gfx as gfx_mod

        tw, th = shutil.get_terminal_size((100, 40))
        img_rows = max(2, th - 1)  # one row stays for the status bar
        w, h = gfx_mod.pick_render_size(info, tw, th, img_rows)
        self.gfx = info
        self.gfx_cols, self.gfx_rows = tw, img_rows
        self.viewer.width, self.viewer.height = w, h
        self._base_size = (w, h)
        self.px_per_cell = (w / tw, h / img_rows)
        self._png_cache = (None, b"")
        self.dirty = True

    # -- input ------------------------------------------------------------
    def handle_event(self, ev: Event, now: float) -> None:
        if ev[0] == "key":
            self._handle_key(ev[1], now)
        else:
            if self.playing and self.cmdline is None:
                # mouse input hands control back too (same contract as a
                # keystroke — otherwise a wheel/drag fights the timeline,
                # its scene change overwritten by the next tick)
                self._stop_playback("playback stopped")
                self.redraw = True
                return
            self._handle_mouse(ev, now)

    def _handle_key(self, key: str, now: float) -> None:
        self.redraw = True
        if self.cmdline is not None:
            # modal `:` line editor — keystrokes build the command, so a
            # pasted ":scene save f\r" burst can't trigger hotkeys
            if key == "enter":
                line, self.cmdline = self.cmdline, None
                if line:
                    self.command(line)
            elif key in ("esc", "ctrl-c"):
                self.cmdline = None
            elif key == "backspace":
                self.cmdline = self.cmdline[:-1]
            elif key == "tab":
                self.cmdline += " "
            elif len(key) == 1:
                self.cmdline += key
            return
        if self.playing:
            # any keystroke stops playback and hands control back (the
            # reference stops via the timeline UI; a live key is ours)
            self._stop_playback("playback stopped")
            return
        s = self.scene
        deep = s.fractal_type == FractalType.DEEP_ZOOM
        if key in _CONTINUOUS:
            repeat = now - self._last_key_at.get(key, -1e9) < _REPEAT_DETECT_S
            self.held[key] = now + (_HOLD_S if repeat else _TAP_S)
            self._last_key_at[key] = now
            return
        if key in ("esc", "ctrl-c"):
            self.running = False
        elif key == "r":
            self.scene = s.reset()
        elif key == "tab":
            idx = _TYPES.index(s.fractal_type)
            self.scene = s.with_(fractal_type=_TYPES[(idx + 1) % len(_TYPES)])
        elif key == "S":
            # the reference's SDLK_s fires screenshot AND pan-down on the
            # same press (input_handler.h:176 + :224) — a quirk we split:
            # lowercase pans (held), uppercase takes the screenshot
            self.message = self.screenshot()
        elif key == " ":
            self.show_status = not self.show_status
            self.dirty = True
        elif key in ("h", "?"):
            self.show_help = not self.show_help
            self.dirty = True
        elif key == "f":
            self._set_fullscreen(not self.fullscreen)
        elif key == "[":
            self.scene = s.with_(max_iterations=max(64, s.max_iterations - 64))
        elif key == "]":
            self.scene = s.with_(max_iterations=min(8192,
                                                    s.max_iterations + 64))
        elif key in "123456":
            self.scene = s.with_(palette_mode=int(key) - 1)
        elif key in "zxc":
            t = presets.DEEP_ZOOM_PRESETS["zxc".index(key)]
            self.scene = s.with_(
                fractal_type=FractalType.DEEP_ZOOM,
                center_x=t.center_x, center_y=t.center_y, zoom=t.zoom,
                hp_center_x=repr(t.center_x), hp_center_y=repr(t.center_y),
                hp_zoom=repr(t.zoom),
                max_iterations=max(s.max_iterations, 1024))
            self.message = f"deep zoom preset: {t.name}"
        elif key == "o":
            self.spin = not self.spin
            self.message = f"auto-rotate {'on' if self.spin else 'off'}"
        elif key in ("+", "="):
            if s.fractal_type == FractalType.MANDELBULB:
                self.scene = s.with_(camera_distance=max(
                    1.0, s.camera_distance * 0.9))
            else:
                self.scene = s.hp_zoomed(True) if deep else s.zoomed(True)
        elif key == "-":
            if s.fractal_type == FractalType.MANDELBULB:
                self.scene = s.with_(camera_distance=min(
                    10.0, s.camera_distance * 1.1))
            else:
                self.scene = s.hp_zoomed(False) if deep else s.zoomed(False)
        elif key == "m":
            self.show_minimap = not self.show_minimap
            self.dirty = True
        elif key == ":":
            self.cmdline = ""

    def _handle_mouse(self, ev: Event, now: float) -> None:
        _, btn, cx, cy, kind = ev
        s = self.scene
        bulb = s.fractal_type == FractalType.MANDELBULB
        deep = s.fractal_type == FractalType.DEEP_ZOOM
        ppx, ppy = self.px_per_cell  # half-blocks: 1×2 px; gfx: w/cols etc.
        px, py_screen = cx * ppx, cy * ppy
        if kind == "wheelup" or kind == "wheeldown":
            zoom_in = kind == "wheelup"
            if bulb:  # input_handler.h:102-107
                f = 0.9 if zoom_in else 1.1
                self.scene = s.with_(camera_distance=min(
                    10.0, max(1.0, s.camera_distance * f)))
            else:
                self.scene = s.hp_zoomed(zoom_in) if deep \
                    else s.zoomed(zoom_in)
        elif kind == "press" and btn == 0:
            t0, x0, y0 = self._last_click
            if now - t0 < 0.3 and abs(cx - x0) <= 2 and abs(cy - y0) <= 2:
                self._zoom_to_cell(px, py_screen, True)  # double-click
            else:
                self._dragging = True
                self._drag_at = (cx, cy)
            self._last_click = (now, cx, cy)
        elif kind == "press" and btn == 2:
            self._zoom_to_cell(px, py_screen, False)
        elif kind == "motion" and self._dragging:
            dx = (cx - self._drag_at[0]) * ppx
            dy = (cy - self._drag_at[1]) * ppy
            self._drag_at = (cx, cy)
            if bulb:  # input_handler.h:147-150
                self.scene = s.with_(rotation_y=s.rotation_y + dx * 0.01)
            elif self.width and self.height:
                aspect = self.width / self.height
                # screen up = +imag (the display flips the render)
                self.scene = self._pan(s, -dx / self.width * aspect,
                                       dy / self.height)
        elif kind == "release":
            self._dragging = False

    def _zoom_to_cell(self, px: float, py_screen: float,
                      zoom_in: bool) -> None:
        s = self.scene
        py = self.height - 1 - py_screen  # display flip
        if s.fractal_type == FractalType.DEEP_ZOOM:
            self.scene = s.hp_zoom_to_point(px, py, self.width, self.height,
                                            zoom_in)
        else:
            self.scene = s.zoom_to_point(px, py, self.width, self.height,
                                         zoom_in=zoom_in)

    @staticmethod
    def _pan(s: Scene, vx: float, vy: float) -> Scene:
        """Pan by view-relative offsets; deep-zoom scenes route through
        the exact-rational hp camera (a float center shift is a silent
        no-op there — rendering reads hp_center_* when set)."""
        if s.fractal_type == FractalType.DEEP_ZOOM:
            return s.hp_panned(vx, vy)
        return s.with_(center_x=s.center_x + s.zoom * vx,
                       center_y=s.center_y + s.zoom * vy)

    # -- per-frame update -------------------------------------------------
    def tick(self, now: float, dt: float) -> None:
        """Continuous input + animations for one frame (the reference's
        process_continuous_input + auto_rotate, vk_engine.cpp:697-716)."""
        dt = min(dt, 0.25)  # a stalled frame must not teleport the view
        expired = [k for k, t in self.held.items() if t < now]
        for k in expired:
            del self.held[k]
        s = self.scene
        if self.held:
            vstep = dt * 2.0  # pan = zoom * dt * 2 (input_handler.h:214)
            aspect = self.width / self.height if self.height else 1.0
            vx = vy = 0.0
            if "w" in self.held or "up" in self.held:
                vy += vstep  # screen up = +imag in our display orientation
            if "s" in self.held or "down" in self.held:
                vy -= vstep
            if "a" in self.held or "left" in self.held:
                vx -= vstep * aspect
            if "d" in self.held or "right" in self.held:
                vx += vstep * aspect
            if vx or vy:
                s = self._pan(s, vx, vy)
            zin = "e" in self.held
            zout = "q" in self.held
            if zin != zout:
                if s.fractal_type == FractalType.DEEP_ZOOM:
                    s = s.hp_zoomed(zin)  # one exact step per frame
                else:
                    # one handle_zoom (x0.8 / x1.25) per 60 Hz reference
                    # frame, scaled to our actual dt
                    factor = (0.8 if zin else 1.25) ** (dt * _REF_FPS)
                    z = s.zoom * factor
                    s = s.with_(zoom=z,
                                max_iterations=_auto_iterations_wheel(z))
            self.scene = s
        if self.spin and s.fractal_type == FractalType.MANDELBULB:
            self.scene = self.scene.with_(
                rotation_y=self.scene.rotation_y + self.spin_speed * dt)
        if self.playback is not None:
            frame = self.playback.update(dt)  # None while paused
            if frame is not None:
                self.scene = frame
                if not self.playback.playing:  # non-loop timeline ended
                    self._stop_playback("playback done")
        # interactive-degradation settle: the frame AFTER input goes
        # quiet re-renders at full resolution — but only when the last
        # dispatched frame actually WAS degraded (sixel and small
        # windows never degrade; re-rendering an identical full-res
        # frame there would waste a full fetch per keystroke)
        interactive_now = (bool(self.held) or self.playing
                           or self._dragging)
        if self.gfx is not None and self._was_interactive \
                and not interactive_now and self._last_scale != 1:
            self.dirty = True
        self._was_interactive = interactive_now

    # -- output -----------------------------------------------------------
    def _gfx_scale(self) -> int:
        """Interactive degradation for pixel sessions: while input is
        live (held keys / drag / playback) frames render at HALF
        resolution — the terminal scales the placement, the fetch drops
        4x, and continuous pan/zoom stays fluid on big windows (a full
        1080p planar fetch alone is ~200 ms on a tunneled link).  The
        first quiet frame snaps back to full resolution.  Only engages
        above ~0.5 Mpix (small windows are already fast), and not for
        sixel (no terminal-side scaling; a host upscale would cost what
        the smaller fetch saves)."""
        if self.gfx is None or self.gfx.kind == "sixel":
            return 1
        if self.width * self.height < _DEGRADE_MIN_PIXELS:
            return 1
        interactive = bool(self.held) or self.playing or self._dragging
        return 2 if interactive else 1

    def _scaled_size(self, scale: int) -> Tuple[int, int]:
        """Render size at the given degradation scale.  Scale 1 passes
        the session size through UNTOUCHED (an odd --cols width must keep
        rendering exactly); scale 2 halves and floors to even."""
        if scale == 1:
            return self.width, self.height
        return (max(2, (self.width // scale) & ~1),
                max(2, (self.height // scale) & ~1))

    def _render_async(self, scene: Scene, scale: Optional[int] = None):
        """Dispatch one frame of ``scene`` at the session size on the
        session's device; returns the frame's tensor (its kernels may still
        be queued).  Pixel (gfx) sessions prefer the planar-quantized path
        — fused K1 + quantization to uint8 planes on the device, so the
        fetch carries 1 B/px/ch instead of 4.  ``scale`` overrides the
        degradation decision (a caller timing both scales passes it);
        dispatch() leaves it None."""
        if scale is None:
            # a real dispatch: record the scale for the settle logic
            # (an explicit scale must not clobber it)
            scale = self._gfx_scale()
            self._last_scale = scale
        if scene.fractal_type == FractalType.DEEP_ZOOM:
            # session-persistent orbit cache: pan/zoom about a center
            # reuses its reference orbit instead of recomputing the HP
            # loop every frame (the reference recomputes only when dirty,
            # deep_zoom_system.cpp:363).  Interactive degradation applies
            # here too — deep frames are the heaviest, and the kernel
            # cost scales with pixels (the orbit is resolution-free)
            from .models import deep_zoom

            w, h = self._scaled_size(scale)
            return deep_zoom.render(
                scene, w, h,
                orbit_cache=self._orbit_cache,
                quantize=8 if self.gfx is not None else 0,
                device=self.device)
        if self.gfx is not None:
            from .models import common as _c
            from .utils.diag import validate_scene

            fam = _c.family_map().get(scene.fractal_type)
            if fam is not None:
                sc = validate_scene(scene)
                w, h = self._scaled_size(scale)
                cfg = _c.scene_static_cfg(sc, w, h, *fam,
                                          device=str(self.device))
                if _c.planar_export_ok(cfg):
                    return _c.planar_render_fn(cfg, 8)(
                        _c.scene_dyn_params(sc))
        return models.render(scene, self.width, self.height,
                             device=self.device)

    def dispatch(self):
        """Dispatch the current frame's render (async on device)."""
        if self.show_minimap:
            return None  # minimap composes host-side
        return self._render_async(self.scene)

    def prewarm_ladder(self) -> None:
        """Nothing to do in the port, so it renders nothing and starts no
        thread.  The JAX session compiled one XLA program per rung of the
        auto-iteration ladder (256/512/1024/1536/2048,
        vk_engine.cpp:1739-1753) in a background thread so that continuous
        zoom would not stall on a compile.  Here every kernel is built once
        per source (ops/_cuda.build) and K1 takes the iteration limit and
        its cap at run time, so a rung's first frame costs what a warm one
        does (chip_smoke.py's live phase times each rung cold and warm at
        scales 1 and 2).  A second thread rendering onto the card while the
        loop dispatches would only compete with the session's frames."""
        return None

    def screenshot(self) -> str:
        from .utils.image import to_export_orientation
        from .utils.png import write_png

        self._shot_n += 1
        path = f"screenshot_{self._shot_n:03d}.png"
        # the orbit cache is keyed by center/bits/max_iter (resolution-
        # independent), so the 8x deep-zoom render reuses the session's
        # reference orbit instead of freezing on a fresh HP loop
        kw = {"orbit_cache": self._orbit_cache} \
            if self.scene.fractal_type == FractalType.DEEP_ZOOM else {}
        # cell sessions upscale 8x for a print-worthy shot; pixel (gfx)
        # sessions are already ~1080p, so 2x suffices (and 8x would be 60+
        # Mpix)
        scale = 2 if self.gfx is not None else 8
        img = models.render(self.scene, self.width * scale,
                            self.height * scale, device=self.device, **kw)
        write_png(path, to_export_orientation(img).cpu().numpy(),
                  metadata=self.scene.metadata_summary())
        return f"saved {path}"

    def command(self, line: str) -> None:
        """Run one `:`-prefixed command through the REPL vocabulary."""
        parts = line.strip().split()
        if parts[:2] == ["anim", "play"]:
            from .anim.keyframes import Playback

            anim = self.viewer._anim()
            if len(anim.keyframes) < 2:
                self.message = "need >= 2 keyframes to play (key add)"
            elif (len(parts) == 2 and self.playback is not None
                    and not self.playback.playing):
                # bare play after pause resumes (the timeline's ▶/⏸
                # toggle, ui_manager.cpp:817-834)
                self.playback.play()
                self.message = f"resumed at {self.playback.current_time:.1f}s"
            else:
                try:
                    t0 = float(parts[2]) if len(parts) > 2 else 0.0
                except ValueError:
                    self.message = f"bad start time: {parts[2]!r}"
                    self.dirty = True
                    return
                self.playback = Playback(anim)
                self.playback.play()
                self.playback.seek(t0)
                self.message = (f"playing {anim.duration:g}s "
                                "(any key stops)")
            self.dirty = True
            return
        if parts[:2] == ["anim", "pause"]:
            if self.playback is not None and self.playback.playing:
                self.playback.pause()
                self.message = (f"paused at {self.playback.current_time:.1f}s"
                                " (:anim play resumes)")
            else:
                self.message = "nothing playing"
            self.dirty = True
            return
        if parts[:2] == ["anim", "stop"]:
            self._stop_playback("playback stopped")
            self.dirty = True
            return
        if parts and parts[0] == "spin":
            # the Auto Rotate checkbox + Rotation Speed slider
            # (ui_manager.cpp:1302-1309; applied per frame like
            # vk_engine.cpp:713-714): bare toggles, a value sets the
            # speed in rad/s (slider range 0.1-2.0, fractal_state.h:68)
            if len(parts) > 1:
                try:
                    self.spin_speed = min(2.0, max(0.1, float(parts[1])))
                except ValueError:
                    self.message = f"bad spin speed: {parts[1]!r}"
                    self.dirty = True
                    return
                self.spin = True
                self.message = f"auto-rotate on, {self.spin_speed:g} rad/s"
            else:
                self.spin = not self.spin
                self.message = f"auto-rotate {'on' if self.spin else 'off'}"
            self.dirty = True
            return
        msg = self.viewer.handle(line)
        if msg is None:
            self.running = False
        else:
            self.message = msg.strip()
            if parts and parts[0] == "coords" and self.message:
                # "Copy Coordinates" actually copies (vk_engine.cpp:
                # 1048-1055 SDL_SetClipboardText): emit OSC 52 so
                # terminals that permit it put the string on the system
                # clipboard; the status line still shows it either way
                self.pending_osc += _osc52(self.message)
        self.dirty = True

    def status_line(self) -> str:
        s = self.scene
        zoom = s.hp_zoom if (s.fractal_type == FractalType.DEEP_ZOOM
                             and s.hp_zoom is not None) else f"{s.zoom:.3g}"
        parts = [s.fractal_type.display_name,
                 f"({s.center_x:.6g}, {s.center_y:.6g})",
                 f"zoom={zoom}", f"iters={s.max_iterations}",
                 f"{self.stats.ms:.1f} ms/frame"]
        if s.fractal_type == FractalType.DEEP_ZOOM:
            # live precision-tier display: the deep-zoom panel's
            # "Precision Mode" readout (ui_manager.cpp:659-757) — descent
            # promotions (DOUBLE→QUAD→ARBITRARY) show as they happen
            try:
                from fractions import Fraction

                from .deepzoom.hp import precision_mode_for_zoom_frac

                z = s.hp_zoom if s.hp_zoom is not None else s.zoom
                mode, bits = precision_mode_for_zoom_frac(
                    Fraction(str(z)))
                # report the 64-bit-bucketed bits the orbit actually uses
                # (models/deep_zoom.render_fields buckets identically)
                bits = -(-bits // 64) * 64
                parts.insert(4, f"{mode.name}:{bits}b")
            except (ValueError, ZeroDivisionError):
                pass
        if self.spin:
            parts.append("spin")
        if self.playing:
            dur = self.playback.animation.duration
            parts.append(f"play {self.play_t:.1f}/{dur:g}s")
        elif self.playback is not None:
            parts.append(f"paused {self.play_t:.1f}s")
        if self.message:
            parts.append("| " + self.message)
        return "  ".join(parts)

    HELP = (
        " w a s d / arrows  pan (hold)      q / e  zoom out / in (hold)  ",
        " mouse: wheel zoom, drag pan, dbl-click zoom in, right zoom out ",
        " r reset   Tab type   S screenshot   f fullscreen   m minimap   ",
        " [ ] iterations   1-6 palette   z/x/c deep-zoom presets         ",
        " o auto-rotate (bulb)   Space status   : command   Esc quit     ",
        " :scene save FILE / :scene load FILE persist the session        ",
        " :key add  :anim save F  :anim play   capture + play keyframes  ",
    )


def _ansi_rows(img: np.ndarray) -> List[str]:
    """f32 RGB (H, W, 3) render → truecolor half-block rows (top first),
    with run-length color-code reuse (interiors are flat: reusing the
    previous cell's SGR attributes cuts the frame bytes ~5-10x)."""
    img8 = (np.clip(img[::-1], 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h = img8.shape[0] - (img8.shape[0] % 2)
    rows = []
    for tr, br in zip(img8[0:h:2], img8[1:h:2]):
        cells = []
        last = None
        for (r1, g1, b1), (r2, g2, b2) in zip(tr, br):
            cur = (r1, g1, b1, r2, g2, b2)
            if cur != last:
                cells.append(f"\x1b[38;2;{r1};{g1};{b1};48;2;{r2};{g2};{b2}m")
                last = cur
            cells.append("▀")
        rows.append("".join(cells) + "\x1b[0m")
    return rows


def _compose_gfx(sess: LiveSession, img: Optional[np.ndarray]) -> str:
    """Pixel-frame redraw: clear the text layer, place the frame (kitty:
    in-band PNG at z=-1, under text, one image id per session so each
    frame replaces the last; iTerm2: inline PNG; sixel: direct raster),
    then print overlays/status as ordinary text.  The encoded escape is
    cached per fetched frame (redraws re-emit bytes)."""
    from . import gfx as gfx_mod

    out = []
    if sess.gfx.kind == "kitty":
        out.append(gfx_mod.kitty_clear())
    out.append("\x1b[2J\x1b[H")
    if img is not None:
        # cache key holds the ARRAY REFERENCE (identity via `is`): a bare
        # id() key could collide when CPython reuses a freed ndarray's
        # address and replay a stale frame; holding the reference pins it
        key = img
        if sess._png_cache[0] is not key:
            if img.dtype == np.uint8:
                # device-quantized fetch: (3, H, W) planes from the
                # planar path or (H, W, 3) from deep zoom — no host math
                img8 = np.moveaxis(img, 0, 2) \
                    if img.ndim == 3 and img.shape[0] == 3 else img
                img8 = img8[::-1]
            else:
                img8 = (np.clip(img[::-1], 0.0, 1.0) * 255.0
                        + 0.5).astype(np.uint8)
            sess._png_cache = (key, gfx_mod.encode_frame(
                sess.gfx, img8, sess.gfx_cols, sess.gfx_rows))
        out.append(sess._png_cache[1])
    if sess.show_help:
        top = max(0, (sess.gfx_rows - len(sess.HELP)) // 2)
        for k, text in enumerate(sess.HELP):
            out.append(f"\x1b[{top + k + 1};1H\x1b[1;37;44m{text}\x1b[0m")
    out.append(f"\x1b[{sess.gfx_rows + 1};1H")
    if sess.cmdline is not None:
        out.append(":" + sess.cmdline)
    elif sess.show_status:
        out.append("\x1b[7m" + sess.status_line()[:max(sess.gfx_cols, 60)]
                   + "\x1b[0m")
    out.append("\x1b[K")
    return "".join(out)


def _osc52(text: str) -> str:
    """OSC 52 clipboard-set escape: terminals that allow it (xterm,
    kitty, iTerm2, foot, tmux with set-clipboard) copy ``text`` to the
    system clipboard — the reference's SDL_SetClipboardText path for
    "Copy Coordinates" (vk_engine.cpp:1048-1055)."""
    import base64

    payload = base64.standard_b64encode(text.encode("utf-8")).decode()
    return "\x1b]52;c;" + payload + "\x1b\\"


def compose_frame(sess: LiveSession, img: Optional[np.ndarray]) -> str:
    """Full redraw string: home cursor, view rows, overlays, status."""
    # one-shot out-of-band escapes (OSC 52 clipboard copy) ride the next
    # frame write — they paint nothing, order vs the frame is irrelevant
    pre, sess.pending_osc = sess.pending_osc, ""
    if sess.gfx is not None:
        if not sess.show_minimap:
            return pre + _compose_gfx(sess, img)
        # minimap in pixel mode: a text screen — delete the image frame
        # first (it sits under the text layer and would show through)
        from . import gfx as gfx_mod

        if sess.gfx.kind == "kitty":
            pre += gfx_mod.kitty_clear()
        pre += "\x1b[2J"
    if sess.show_minimap:
        body = sess.viewer.minimap().split("\n")
    elif img is not None:
        body = _ansi_rows(img)
    else:
        body = []
    if sess.show_help:
        top = max(0, (len(body) - len(sess.HELP)) // 2)
        for k, text in enumerate(sess.HELP):
            if top + k < len(body):
                body[top + k] = "\x1b[1;37;44m" + text + "\x1b[0m"
            else:
                body.append("\x1b[1;37;44m" + text + "\x1b[0m")
    out = [pre + "\x1b[H"]
    for line in body:
        out.append(line + "\x1b[K\r\n")
    if sess.cmdline is not None:
        out.append(":" + sess.cmdline)
    elif sess.show_status:
        out.append("\x1b[7m" + sess.status_line()[:max(sess.width, 60)]
                   + "\x1b[0m")
    out.append("\x1b[K\x1b[J")
    return "".join(out)


class TermUI:
    """Raw-terminal IO: cbreak mode, alternate screen, SGR mouse
    reporting, non-blocking reads."""

    def __init__(self, infile=None, outfile=None):
        self.fin = infile if infile is not None else sys.stdin
        self.fout = outfile if outfile is not None else sys.stdout
        self._saved = None
        self._rest = b""

    def __enter__(self):
        import termios
        import tty

        fd = self.fin.fileno()
        try:
            self._saved = termios.tcgetattr(fd)
            tty.setcbreak(fd)
        except termios.error:
            self._saved = None  # not a real tty (tests pipe stdin)
        self.fout.write("\x1b[?1049h\x1b[?25l\x1b[?1002h\x1b[?1006h\x1b[2J")
        self.fout.flush()
        return self

    def __exit__(self, *exc):
        import termios

        self.fout.write("\x1b[?1006l\x1b[?1002l\x1b[?25h\x1b[?1049l")
        self.fout.flush()
        if self._saved is not None:
            termios.tcsetattr(self.fin.fileno(), termios.TCSADRAIN,
                              self._saved)
        return False

    def write(self, text: str) -> None:
        """Write ``text`` and flush it.  On a terminal file descriptor the
        bytes go out in slices of at most _WRITE_SLICE, each once select()
        says the terminal can take it: a pixel frame runs to megabytes of
        escape, and some pty implementations (gVisor's) keep 128 KiB of a
        larger write, drop the rest and report it all written, where a
        Linux pty blocks the writer."""
        try:
            fd = self.fout.fileno()
            tty_out = os.isatty(fd)
        except (AttributeError, OSError, ValueError):
            tty_out = False
        if not tty_out:
            self.fout.write(text)
            self.fout.flush()
            return
        self.fout.flush()
        data = memoryview(text.encode(getattr(self.fout, "encoding", None)
                                      or "utf-8"))
        while data:
            select.select([], [fd], [])
            data = data[os.write(fd, data[:_WRITE_SLICE]):]

    def poll(self, timeout: float) -> List[Event]:
        fd = self.fin.fileno()
        try:
            ready, _, _ = select.select([fd], [], [], timeout)
        except (OSError, ValueError):
            return [("key", "esc")]  # stdin gone: quit
        data = b""
        if ready:
            try:
                data = os.read(fd, 4096)
            except OSError:
                return [("key", "esc")]
            if data == b"":
                return [("key", "esc")]  # EOF (pty closed)
        buf = self._rest + data
        events, self._rest = parse_input(buf)
        if self._rest == b"\x1b" and not data:
            # a bare ESC that stayed unpaired across a poll: the Esc key
            self._rest = b""
            events.append(("key", "esc"))
        return events


def run_live(scene: Optional[Scene] = None, cols: Optional[int] = None,
             rows: Optional[int] = None, spin: bool = False,
             max_frames: Optional[int] = None, infile=None,
             outfile=None, resume_last: bool = False,
             persist: bool = False, gfx: Optional[str] = None,
             device="cuda") -> int:
    """The event loop: poll input → continuous update → async dispatch →
    fetch+draw, with up to two frames in flight (FRAME_OVERLAP=2).

    ``resume_last``: start from the previous session's persisted Scene
    (the reference resumes implicitly via imgui.ini); ``persist``: save
    the Scene on exit so the next launch can.

    ``gfx``: pixel-frame protocol — "auto" (default; in-band handshake,
    $FRACTAL_TPU_GFX overrides), "kitty", "iterm", or "off".  With a
    capable terminal the session renders real ≥0.5 Mpix frames (the
    reference's 1700×900 window experience); otherwise half-block cells
    as before.  ``device``: where every frame renders."""
    if resume_last:
        prev = load_last_session()
        if prev is not None:
            scene = prev
    sess = LiveSession(scene, cols=cols, rows=rows, spin=spin,
                       device=device)
    ui = TermUI(infile=infile, outfile=outfile)
    try:
        _live_loop(sess, ui, max_frames, gfx_mode=gfx)
    except KeyboardInterrupt:
        # tty.setcbreak keeps ISIG, so ^C arrives as KeyboardInterrupt,
        # not as a \x03 byte — treat it as quit (TermUI.__exit__ has
        # already restored the terminal on the way out)
        pass
    finally:
        sess.running = False
        # persist even on ^C/errors — the reference writes imgui.ini on
        # any exit path
        if persist:
            save_last_session(sess.scene)
    return 0


def _live_loop(sess: "LiveSession", ui: "TermUI",
               max_frames: Optional[int],
               gfx_mode: Optional[str] = None) -> None:
    from collections import deque

    from . import gfx as gfx_mod

    with ui:
        if gfx_mode != "off":
            # the handshake needs the terminal in cbreak mode (responses
            # arrive on stdin), so it runs inside the TermUI context
            def _pushback(b: bytes) -> None:
                ui._rest += b  # type-ahead during the handshake survives

            try:
                info = gfx_mod.detect(ui.fin, ui.fout, force=gfx_mode,
                                      pushback=_pushback)
            except Exception:
                info = None
            if info is not None:
                sess.enable_gfx(info)
                sess.gfx_requery = lambda cur: gfx_mod.requery(
                    ui.fin, ui.fout, cur, pushback=_pushback)

        # (dispatch time, frame tensor or None, its CUDA event or None)
        inflight: deque = deque()
        try:
            _live_frames(sess, ui, max_frames, time.perf_counter(),
                         inflight)
        finally:
            # placement cleanup must survive ^C / errors out of the loop
            # (tty cbreak keeps ISIG, so KeyboardInterrupt lands here)
            if sess.gfx is not None and sess.gfx.kind == "kitty":
                try:
                    ui.write(gfx_mod.kitty_clear())
                except (OSError, ValueError):
                    pass


def frame_event(frame):
    """A CUDA event recorded on the current stream of ``frame``'s device
    right after its dispatch, or None when the frame is ready at once (no
    frame, or a frame on the CPU)."""
    if frame is None or frame.device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(frame.device))
    return ev


def pop_ready(inflight) -> Optional[tuple]:
    """The oldest in-flight ``(t0, frame, event)`` once it may be drawn:
    when its event has completed (or it has none), or when two frames are
    in flight (FRAME_OVERLAP=2: the fetch then waits for the oldest).
    None while the oldest is still running and a second may dispatch."""
    if not inflight:
        return None
    ev = inflight[0][2]
    if len(inflight) == 2 or ev is None or ev.query():
        return inflight.popleft()
    return None


def fetch(frame) -> Optional[np.ndarray]:
    """The frame's host copy (waits for its kernels on a CUDA device)."""
    return None if frame is None else frame.cpu().numpy()


def _live_frames(sess, ui, max_frames, last, inflight) -> None:
    """The poll → tick → dispatch → fetch/draw cycle (split out so
    _live_loop can guarantee the kitty placement cleanup in a finally)."""
    last_img: Optional[np.ndarray] = None
    frames = 0
    while sess.running:
        now = time.perf_counter()
        dt, last = now - last, now
        timeout = 0.002 if (sess.dirty or inflight) else 0.05
        for ev in ui.poll(timeout):
            sess.handle_event(ev, time.perf_counter())
        sess.tick(time.perf_counter(), dt)
        animating = bool(sess.held) or sess.playing or (
            sess.spin
            and sess.scene.fractal_type == FractalType.MANDELBULB)
        # FRAME_OVERLAP=2: while frame n is on the device, frame n+1
        # (with the input applied since) dispatches behind it.
        if (sess.dirty or animating) and len(inflight) < 2:
            sess.dirty = False
            t0 = time.perf_counter()
            frame = sess.dispatch()
            inflight.append((t0, frame, frame_event(frame)))
        done = pop_ready(inflight)
        if done is not None:
            t0, frame, _ = done
            last_img = fetch(frame)
            sess.stats.add(time.perf_counter() - t0)
            sess.redraw = False
            frames += 1
            ui.write(compose_frame(sess, last_img))
            if max_frames is not None and frames >= max_frames:
                break
        elif sess.redraw and not inflight:
            # overlay/status/cmdline changed without a scene change:
            # recompose over the last fetched image
            sess.redraw = False
            ui.write(compose_frame(sess, last_img))
