"""Interactive terminal viewer of the PyTorch port (the counterpart of
``fractalrenderer_tpu/viewer.py``) — the headless equivalent of the reference's
SDL/ImGui session (SURVEY.md §7 maps the GUI to 'CLI verbs + camera
utilities'; this module supplies the *interactive* part).

Renders the scene to ANSI truecolor half-block characters (two pixels per
character cell) and exposes the reference's interaction vocabulary
(src/input_handler.h hotkeys) as REPL commands:

  +/-            zoom in/out about the center (0.8x/1.25x + auto-iterations,
                 vk_engine.cpp:1731-1756)
  click X Y      zoom toward a pixel (zoom_to_point, vk_engine.cpp:1758-1794);
                 X/Y are image pixels measured from the TOP-LEFT of the
                 displayed view (one terminal row shows 2 pixel rows)
  w/a/s/d        pan (w = up on screen; zoom-proportional step,
                 input_handler.h:211-248)
  tab / type T   cycle / set fractal type
  p N [OFF [SC]] palette (+ offset/scale sliders); i N|auto iterations;
                 aa N; e toggle orbit trap; trap [R]; stripes [D];
                 style N interior style;
                 enhance reset|brightness/saturation/contrast V; coords
  preset NAME    location preset; julia NAME|CR CI (the c sliders);
                 phoenix P [R] / phoenix julia [CR CI] (damping/memory
                 sliders + Julia Set Mode); bulb dist|rot|power|fov V /
                 bulb resetcam (the 3D Parameters panel);
                 reset (R); save FILE (S)
  export W H [ss] [FILE]   16-bit print export of the current view (the
                 in-app export panel, ui_manager.cpp:590-655); 'ss' =
                 2x supersample + downsample; huge sizes stream banded
  scene save F / scene load F   persist / restore the session Scene (JSON)
  key add [T] / key list / key del N / key update N / key jump N /
                 key interp N TYPE (linear|ease_in_out|ease_in|ease_out|
                 exponential) /
                 key clear   capture keyframes from the current view
                 (the reference's timeline UI incl. its context menu)
  anim save/load F, fps N, dur S, loop, info, seek T, render DIR [W H],
                 encode DIR OUT [CODEC]   session animation export and
                 one-click encode (qtpng default — no ffmpeg needed);
                 ':anim play/pause/stop' (live mode) plays it
  q              quit

For the LIVE raw-terminal loop (continuous held-key pan/zoom, mouse,
immediate hotkeys) see live.py — `cli interactive` uses it on a TTY.

Runs on anything with a truecolor terminal; each command re-renders on the
viewer's device (``Viewer(..., device=)``, CUDA by default: the port's
kernels; ``device="cpu"`` runs their plain PyTorch versions).  No render
ever moves to another device on its own.
"""
from __future__ import annotations

import shutil
from typing import Optional

import numpy as np

from . import models, presets
from .scene import FractalType, Scene
from .utils.image import to_export_orientation
from .utils.png import write_png


def _host(img) -> np.ndarray:
    """A rendered tensor as a host NumPy array (the frame's fetch)."""
    return img.cpu().numpy()


def _export(img) -> np.ndarray:
    """A rendered (H, W, 3) tensor flipped for a file and fetched."""
    return _host(to_export_orientation(img))

_TYPES = [FractalType.MANDELBROT, FractalType.JULIA,
          FractalType.BURNING_SHIP, FractalType.MANDELBULB,
          FractalType.PHOENIX, FractalType.DEEP_ZOOM]


def ansi_render(img: np.ndarray) -> str:
    """f32 RGB (H, W, 3) → ANSI truecolor half-block art (▀: fg=top px,
    bg=bottom px)."""
    img8 = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h = img8.shape[0] - (img8.shape[0] % 2)
    top = img8[0:h:2]
    bot = img8[1:h:2]
    lines = []
    for tr, br in zip(top, bot):
        cells = []
        for (r1, g1, b1), (r2, g2, b2) in zip(tr, br):
            cells.append(f"\x1b[38;2;{r1};{g1};{b1}m"
                         f"\x1b[48;2;{r2};{g2};{b2}m▀")
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


class Viewer:
    """Holds the interactive state: the current Scene (the reference's
    mutable FractalState), the render geometry and the device every render
    runs on."""

    def __init__(self, scene: Optional[Scene] = None,
                 cols: Optional[int] = None, rows: Optional[int] = None,
                 device="cuda"):
        self.scene = scene or Scene(zoom=2.5)
        self.device = device
        tw, th = shutil.get_terminal_size((100, 40))
        self.width = cols or min(tw, 140)
        self.height = (rows or min(th - 4, 44)) * 2  # half blocks
        self._session_anim = None  # lazy: interactive keyframe capture
        # deep-zoom reference orbits reused across commands; the live
        # loop (live.py) shares its own cache by assigning this attribute
        self._orbit_cache: dict = {}

    def _anim(self):
        if self._session_anim is None:
            from .anim.keyframes import Animation

            self._session_anim = Animation(name="session")
        return self._session_anim

    # -- command handlers --------------------------------------------------
    def handle(self, line: str) -> Optional[str]:
        """Apply one command; returns a status message or None to quit."""
        parts = line.strip().split()
        if not parts:
            return ""
        cmd, args = parts[0].lower(), parts[1:]
        s = self.scene
        try:
            if cmd in ("q", "quit", "exit"):
                return None
            deep = s.fractal_type == FractalType.DEEP_ZOOM
            if cmd == "+":
                self.scene = s.hp_zoomed(True) if deep \
                    else s.zoomed(zoom_in=True)
            elif cmd == "-":
                self.scene = s.hp_zoomed(False) if deep \
                    else s.zoomed(zoom_in=False)
            elif cmd in ("click", "rclick"):
                px, py = float(args[0]), float(args[1])
                # the display is the vertical flip of the render (+imag at
                # the top), so a coordinate measured on screen maps to
                # render row height-1-py
                py = self.height - 1 - py
                zoom_in = cmd == "click"
                self.scene = (s.hp_zoom_to_point(px, py, self.width,
                                                 self.height, zoom_in)
                              if deep else
                              s.zoom_to_point(px, py, self.width,
                                              self.height, zoom_in=zoom_in))
            elif cmd in ("w", "a", "s", "d"):
                # zoom-proportional pan (input_handler.h:211-248); 'w' is
                # up ON SCREEN = +imag (the display flips the render)
                step = s.zoom * 0.05
                dx = {"a": -step, "d": step}.get(cmd, 0.0)
                dy = {"w": step, "s": -step}.get(cmd, 0.0)
                self.scene = s.with_(center_x=s.center_x + dx,
                                     center_y=s.center_y + dy)
            elif cmd == "tab":
                idx = _TYPES.index(s.fractal_type)
                self.scene = s.with_(
                    fractal_type=_TYPES[(idx + 1) % len(_TYPES)])
            elif cmd == "type":
                self.scene = s.with_(fractal_type=FractalType.parse(args[0]))
            elif cmd == "p":
                # palette grid + its offset/scale sliders
                # (ui_manager.cpp:470-515): p N [OFFSET [SCALE]]
                kw = {"palette_mode": int(args[0])}
                if len(args) > 1:
                    kw["color_offset"] = float(args[1])
                if len(args) > 2:
                    kw["color_scale"] = float(args[2])
                self.scene = s.with_(**kw)
            elif cmd == "style":
                # interior style combo (ui_manager.cpp:541-546)
                self.scene = s.with_(interior_style=int(args[0]))
            elif cmd == "trap":
                # orbit trap: bare = toggle (same as 'e'); with a value =
                # enable and set the radius slider (ui_manager.cpp:549-556)
                if args:
                    self.scene = s.with_(orbit_trap_enabled=True,
                                         orbit_trap_radius=float(args[0]))
                else:
                    self.scene = s.with_(
                        orbit_trap_enabled=not s.orbit_trap_enabled)
            elif cmd == "i":
                if args and args[0].lower() == "auto":
                    # the iterations slider's "Auto" button
                    # (ui_manager.cpp:447-451): pick from the zoom ladder
                    from .scene import _auto_iterations_wheel

                    self.scene = s.with_(
                        max_iterations=_auto_iterations_wheel(s.zoom))
                    return f"iterations={self.scene.max_iterations} (auto)"
                self.scene = s.with_(max_iterations=int(args[0]))
            elif cmd == "aa":
                self.scene = s.with_(antialiasing_samples=int(args[0]))
            elif cmd == "spp":
                # deep-zoom samples/pixel axis (device-batched stacking)
                self.scene = s.with_(samples_per_pixel=int(args[0]))
            elif cmd == "e":
                self.scene = s.with_(orbit_trap_enabled=not s.orbit_trap_enabled)
            elif cmd == "enhance":
                # "Reset Enhancement" (ui_manager.cpp:517-522) or set one
                # of the three color sliders: enhance reset |
                # enhance brightness/saturation/contrast V
                if args and args[0] == "reset":
                    self.scene = s.with_(color_brightness=1.0,
                                         color_saturation=1.0,
                                         color_contrast=1.0)
                    return "enhancement reset"
                field = {"brightness": "color_brightness",
                         "saturation": "color_saturation",
                         "contrast": "color_contrast"}.get(args[0])
                if field is None:
                    return f"unknown enhance field {args[0]!r}"
                self.scene = s.with_(**{field: float(args[1])})
            elif cmd == "stripes":
                # bare = toggle; with a value = enable and set the density
                # slider (ui_manager.cpp:559-566)
                if args:
                    self.scene = s.with_(stripe_enabled=True,
                                         stripe_density=float(args[0]))
                else:
                    self.scene = s.with_(stripe_enabled=not s.stripe_enabled)
            elif cmd in ("r", "reset"):
                self.scene = s.reset()
            elif cmd == "preset":
                self.scene = presets.find_preset(" ".join(args)).apply(s)
            elif cmd == "julia":
                # preset name, or the C Real / C Imaginary sliders
                # (ui_manager.cpp:1239-1242): julia CR CI
                try:
                    cr, ci = float(args[0]), float(args[1])
                except (ValueError, IndexError):
                    cr, ci = presets.JULIA_PRESETS[" ".join(args)]
                self.scene = s.with_(fractal_type=FractalType.JULIA,
                                     julia_c_real=cr, julia_c_imag=ci)
            elif cmd == "phoenix":
                # the Phoenix parameter sliders (ui_manager.cpp:1343-1384):
                # phoenix P [R] sets the damping/memory terms;
                # phoenix julia [CR CI] toggles Julia Set Mode (and
                # optionally sets its c, the conditional sliders)
                if args and args[0] == "julia":
                    kw = {"use_julia_set": not s.use_julia_set}
                    if len(args) > 2:
                        kw = {"use_julia_set": True,
                              "julia_c_real": float(args[1]),
                              "julia_c_imag": float(args[2])}
                    self.scene = s.with_(fractal_type=FractalType.PHOENIX,
                                         **kw)
                else:
                    kw = {"phoenix_p": float(args[0])}
                    if len(args) > 1:
                        kw["phoenix_r"] = float(args[1])
                    self.scene = s.with_(fractal_type=FractalType.PHOENIX,
                                         **kw)
            elif cmd == "bulb":
                # the 3D Parameters panel (ui_manager.cpp:1277-1310):
                # bulb dist|rot|power|fov V, bulb resetcam
                sub = args[0]
                if sub == "resetcam":  # ui_manager.cpp:1287-1291
                    self.scene = s.with_(camera_distance=3.0,
                                         rotation_y=0.0)
                else:
                    field = {"dist": "camera_distance",
                             "rot": "rotation_y",
                             "power": "mandelbulb_power",
                             "fov": "fov"}.get(sub)
                    if field is None:
                        return f"unknown bulb control {sub!r}"
                    self.scene = s.with_(**{field: float(args[1])})
                if s.fractal_type != FractalType.MANDELBULB:
                    self.scene = self.scene.with_(
                        fractal_type=FractalType.MANDELBULB)
            elif cmd == "key":
                # interactive keyframe capture — the reference's animation
                # timeline semantics (ui_manager.cpp:760-1220: capture
                # keyframe from the current view, list, delete) as
                # commands; 'anim save FILE' writes the .franim
                sub = args[0].lower() if args else "list"
                anim = self._anim()
                if sub == "add":
                    t = (float(args[1]) if len(args) > 1 else
                         (anim.keyframes[-1].time + 2.0 if anim.keyframes
                          else 0.0))
                    anim.add_keyframe(t, s)
                    return (f"keyframe {len(anim.keyframes) - 1} at "
                            f"t={t:g}s (zoom={s.zoom:.3g})")
                if sub == "del":
                    anim.remove_keyframe(int(args[1]))
                    return f"{len(anim.keyframes)} keyframes"
                if sub == "update":
                    # context menu "Update with current view"
                    # (ui_manager.cpp:987-993)
                    i = int(args[1])
                    if not 0 <= i < len(anim.keyframes):
                        return f"no keyframe {i}"
                    anim.update_keyframe(i, s)
                    return f"keyframe {i} updated (zoom={s.zoom:.3g})"
                if sub == "interp":
                    # the per-keyframe interpolation combo in the
                    # timeline (ui_manager.cpp keyframe row; easing is
                    # chosen by the SECOND keyframe of each segment,
                    # animation_system.cpp:107-122)
                    from .anim.keyframes import InterpolationType

                    i = int(args[1])
                    if not 0 <= i < len(anim.keyframes):
                        return f"no keyframe {i}"
                    name = args[2].upper().replace("-", "_")
                    try:
                        kind = InterpolationType[name]
                    except KeyError:
                        opts = "|".join(t.name.lower()
                                        for t in InterpolationType)
                        return f"unknown interpolation {args[2]!r} ({opts})"
                    import dataclasses

                    anim.keyframes[i] = dataclasses.replace(
                        anim.keyframes[i], interp_type=kind)
                    return f"keyframe {i} interpolation = {kind.name}"
                if sub == "jump":
                    # context menu "Jump to this keyframe"
                    # (ui_manager.cpp:981-985): view snaps to its scene
                    i = int(args[1])
                    if not 0 <= i < len(anim.keyframes):
                        return f"no keyframe {i}"
                    self.scene = anim.keyframes[i].scene
                    return (f"jumped to keyframe {i} "
                            f"(t={anim.keyframes[i].time:g}s)")
                if sub == "clear":
                    anim.clear_keyframes()
                    return "keyframes cleared"
                if sub == "list":
                    if not anim.keyframes:
                        return "no keyframes (key add [T] captures the view)"
                    return "\n".join(
                        f"  [{i}] t={k.time:g}s {k.scene.fractal_type.name} "
                        f"zoom={k.scene.zoom:.3g} "
                        f"center=({k.scene.center_x:.6g}, "
                        f"{k.scene.center_y:.6g})"
                        for i, k in enumerate(anim.keyframes))
                return f"unknown key subcommand {sub!r}"
            elif cmd == "anim":
                from .anim import franim

                sub = args[0].lower()
                anim = self._anim()
                if sub == "save":
                    if not anim.keyframes:
                        return "no keyframes to save"
                    franim.save(anim, args[1])
                    return (f"{len(anim.keyframes)} keyframes, "
                            f"{anim.duration:g}s -> {args[1]} "
                            f"(render: cli animate --franim {args[1]})")
                if sub == "load":
                    self._session_anim = franim.load(args[1])
                    return (f"loaded {len(self._session_anim.keyframes)} "
                            f"keyframes, {self._session_anim.duration:g}s")
                if sub == "fps":
                    anim.target_fps = int(args[1])
                    return f"fps={anim.target_fps}"
                if sub == "dur":
                    anim.duration = float(args[1])
                    return f"duration={anim.duration:g}s"
                if sub == "loop":
                    # the timeline's loop checkbox (ui_manager.cpp:828):
                    # live ':anim play' wraps instead of stopping
                    anim.loop = not anim.loop
                    return f"loop {'on' if anim.loop else 'off'}"
                if sub in ("play", "stop"):
                    return ("playback runs in the live viewer "
                            "(cli interactive on a TTY)")
                if sub == "info":
                    return (f"{len(anim.keyframes)} keyframes, "
                            f"duration={anim.duration:g}s, "
                            f"fps={anim.target_fps}, "
                            f"{anim.export_width}x{anim.export_height}")
                if sub == "seek":
                    # the timeline scrub slider (ui_manager.cpp:838-852):
                    # jump the view to the interpolated state at time T
                    # without playing
                    if len(anim.keyframes) < 2:
                        return "need >= 2 keyframes to seek"
                    t = float(args[1])
                    self.scene = anim.interpolate(t)
                    return f"view at t={t:g}s"
                if sub == "render":
                    # the timeline's export button (ui_manager.cpp:
                    # 1040-1136): render the session animation to PNG
                    # frames; size defaults to the view
                    from .anim.renderer import AnimationRenderer

                    if len(anim.keyframes) < 2:
                        return "need >= 2 keyframes to render"
                    out_dir = args[1]
                    w = int(args[2]) if len(args) > 2 else self.width
                    h = int(args[3]) if len(args) > 3 else self.height
                    r = AnimationRenderer(device=self.device)
                    ok = r.start_render(anim, out_dir, w, h)
                    if not ok:
                        return f"render failed: {r.progress.status.name}"
                    return (f"{anim.total_frames} frames ({w}x{h}) -> "
                            f"{out_dir} (encode: cli encode {out_dir} "
                            f"--codec qtpng)")
                if sub == "encode":
                    # the timeline's one-click "Render & Encode" button
                    # (ui_manager.cpp:1123-1136 -> render_and_encode):
                    # anim encode DIR OUT [CODEC] — frames rendered by
                    # 'anim render DIR' become a video; qtpng needs no
                    # ffmpeg, other codecs degrade gracefully without one
                    from .anim import video

                    frames_dir, out = args[1], args[2]
                    codec = args[3] if len(args) > 3 else "qtpng"
                    settings = video.VideoEncodeSettings(
                        output_filename=out,
                        codec=video.VideoCodec(codec),
                        fps=int(anim.target_fps) or 30)
                    enc = video.VideoEncoder()
                    if not enc.encode(frames_dir, settings):
                        return f"encode failed: {enc.progress.error}"
                    return f"encoded -> {settings.output_filename}"
                return f"unknown anim subcommand {sub!r}"
            elif cmd == "scene":
                # in-session state persistence (the reference resumes via
                # imgui.ini + clipboard coords; we persist the Scene JSON)
                sub = args[0].lower()
                path = args[1]
                if sub == "save":
                    with open(path, "w") as fh:
                        fh.write(s.to_json(indent=2))
                    return f"scene -> {path}"
                elif sub == "load":
                    with open(path) as fh:
                        self.scene = Scene.from_json(fh.read())
                    return f"loaded {path}"
                return f"unknown scene subcommand {sub!r}"
            elif cmd in ("save", "s!"):
                path = args[0] if args else "screenshot.png"
                img = models.render(s, self.width * 8, self.height * 8,
                                    device=self.device)
                write_png(path, _export(img), metadata=s.metadata_summary())
                return f"saved {path}"
            elif cmd == "export":
                # the in-app high-res export panel (ui_manager.cpp:590-655)
                # — 16-bit print PNG at arbitrary size from the live view;
                # 'ss' renders 2x and box-downsamples.  Sizes past one
                # device pass stream through the banded giant exporter.
                ew, eh = int(args[0]), int(args[1])
                rest = list(args[2:])
                ss = "ss" in rest
                if ss:
                    rest.remove("ss")
                path = rest[0] if rest else f"export_{ew}x{eh}.png"
                # the reference's panel clamps to [100, 32000]
                # (ui_manager.cpp:617-618); we allow small sizes but a
                # non-positive dimension is an error, not a crash
                if ew < 1 or eh < 1:
                    return f"error: bad export size {ew}x{eh}"
                if max(ew, eh) * (2 if ss else 1) > 32000:
                    return "error: exceeds 32000 cap (ui_manager.cpp:617)"
                meta = {"Software":
                        "fractalrenderer_tpu_torch (print export)",
                        **s.metadata_summary()}
                from .cli import _BANDED_EXPORT_PIXELS

                if ew * eh * (4 if ss else 1) > _BANDED_EXPORT_PIXELS:
                    from .parallel import render_giant_still

                    render_giant_still(
                        s, ew, eh, path, bit_depth=16, supersample=ss,
                        extra_metadata=meta,
                        orbit_cache=self._orbit_cache, keep_tiles=False,
                        device=self.device)
                    return f"exported {ew}x{eh} (banded) -> {path}"
                if s.fractal_type == FractalType.DEEP_ZOOM:
                    from .models import deep_zoom
                    from .utils.diag import validate_scene

                    img = deep_zoom.render(
                        validate_scene(s),
                        ew * 2 if ss else ew, eh * 2 if ss else eh,
                        orbit_cache=self._orbit_cache, device=self.device)
                else:
                    img = models.render(
                        s, ew * 2 if ss else ew, eh * 2 if ss else eh,
                        device=self.device)
                if ss:
                    from .utils.image import downsample2x

                    img = downsample2x(img)
                write_png(path, _export(img), bit_depth=16,
                          metadata=meta, dpi=300.0)
                return f"exported {ew}x{eh} 16-bit -> {path}"
            elif cmd in ("m", "minimap"):
                return self.minimap()
            elif cmd == "coords":
                # "Copy Coordinates" (ui_manager.cpp:671-675): hp strings
                # win when present — past ~1e-16 the f64 round-trip would
                # not reproduce the view
                if (s.fractal_type == FractalType.DEEP_ZOOM
                        and s.hp_center_x is not None):
                    return (f"center=({s.hp_center_x}, {s.hp_center_y}) "
                            f"zoom={s.hp_zoom} iters={s.max_iterations}")
                return (f"center=({s.center_x!r}, {s.center_y!r}) "
                        f"zoom={s.zoom!r} iters={s.max_iterations}")
            elif cmd in ("h", "help", "?"):
                return __doc__.split("commands:")[-1]
            else:
                return f"unknown command {cmd!r} (h for help)"
        except (ValueError, KeyError, IndexError, OSError) as e:
            return f"error: {e}"
        return ""

    def minimap(self) -> str:
        """Overview map with a position indicator (ui_manager.cpp:1497-1538
        drew a cardioid sketch; we render the real set) — shows where the
        current center sits in the default viewport of the current type."""
        from dataclasses import replace as _r

        s = self.scene
        over = _r(s, center_x=-0.5,  # both overview defaults center here
                  center_y=0.0 if s.fractal_type.name != "BURNING_SHIP"
                  else -0.6,
                  zoom=2.5, max_iterations=64, antialiasing_samples=1)
        w, h = min(self.width, 60), min(self.height, 40)
        img = _host(models.render(over, w, h, device=self.device))[::-1]
        # invert the centered mapping to place the marker
        #   px = (cx - over_cx)/zoom * h + 0.5*w   (centered convention)
        mx = int((s.center_x - over.center_x) / over.zoom * h + 0.5 * w)
        my_render = (s.center_y - over.center_y) / over.zoom * h + 0.5 * h
        my = int(h - 1 - my_render)  # display flip
        img = np.array(img)
        if 0 <= my < h and 0 <= mx < w:
            y0, y1 = max(my - 1, 0), min(my + 2, h)
            x0, x1 = max(mx - 1, 0), min(mx + 2, w)
            img[y0:y1, x0:x1] = np.array([1.0, 0.1, 0.1], np.float32)
        return (ansi_render(img)
                + f"\ncenter marker at ({mx}, {my})")

    def frame(self) -> str:
        img = _host(models.render(self.scene, self.width, self.height,
                                  device=self.device))
        # terminal rows go top-down; flip to put +imag at the top like the
        # reference's exports
        s = self.scene
        status = (f"{s.fractal_type.display_name}  "
                  f"center=({s.center_x:.6g}, {s.center_y:.6g})  "
                  f"zoom={s.zoom:.3g}  iters={s.max_iterations}  "
                  f"palette={s.palette_mode}")
        return ansi_render(img[::-1]) + "\n" + status


def run(scene: Optional[Scene] = None, cols: Optional[int] = None,
        rows: Optional[int] = None, device="cuda") -> int:
    v = Viewer(scene, cols=cols, rows=rows, device=device)
    print(v.frame())
    while True:
        try:
            line = input("fractal> ")
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        msg = v.handle(line)
        if msg is None:
            return 0
        print(v.frame())
        if msg:
            print(msg)
