"""Command-line interface of the PyTorch port (counterpart of
``fractalrenderer_tpu/cli.py``).  The ``info``, ``presets``,
``export-print`` (banded above 2^27 rendered pixels), ``zoom-path``,
``sweep``, ``animate`` (with ``--sharded``), ``encode`` and ``giant`` verbs
are ported, and ``render`` for the four 2D families (every AA, trap,
stripe, interior-style and Julia option), ``--golden`` (the CPU golden
reference of the 2D families), ``--precision dd``, ``--type deep-zoom``
(the rebasing perturbation path at every depth: Mandelbrot with
``--series``, ``--deep-julia``, ``--deep-ship`` with ``--exact-dust``,
``--deep-phoenix``, and ``--spp 2|4`` supersampling), ``--type mandelbulb``
(``--power``, ``--time``, ``--aa``, ``--palette``) and ``--sharded`` (row
bands across the visible CUDA devices, or the one CPU with ``--device
cpu``), and ``interactive``, the terminal viewer (the live raw-terminal
session on a TTY, the line REPL when piped).

Usage examples:
  python -m fractalrenderer_tpu_torch.cli render --out m.png
  python -m fractalrenderer_tpu_torch.cli render --preset "Seahorse Valley" \\
      --width 1920 --height 1080 --out sea.png
  python -m fractalrenderer_tpu_torch.cli render --device cpu --width 320 \\
      --height 180 --out small.png
  python -m fractalrenderer_tpu_torch.cli render --type julia \\
      --julia-preset "Douady's Rabbit" --aa 2 --out rabbit.png
  python -m fractalrenderer_tpu_torch.cli render --precision dd \\
      --preset "Seahorse Valley" --hp-zoom 1e-9 --iters 1500 --out dd.png
  python -m fractalrenderer_tpu_torch.cli render --type deep-zoom \\
      --hp-center-x -0.74364388703715158 --hp-center-y 0.13182590420531198 \\
      --hp-zoom 1e-12 --iters 10000 --out deep.png
  python -m fractalrenderer_tpu_torch.cli render --type deep-zoom \\
      --deep-ship --hp-center-x -1.7623025 --hp-center-y -0.028000625 \\
      --hp-zoom 1e-10 --iters 1500 --spp 2 --out ship.png
  python -m fractalrenderer_tpu_torch.cli render --type deep-zoom \\
      --deep-ship --exact-dust --hp-center-x -1.7623025 \\
      --hp-center-y -0.028000625 --hp-zoom 1e-10 --iters 400 --out dust.png
  python -m fractalrenderer_tpu_torch.cli render --type mandelbulb \\
      --time 1.0 --aa 2 --out bulb.png
  python -m fractalrenderer_tpu_torch.cli render --golden --width 320 \\
      --height 180 --out golden.png
  python -m fractalrenderer_tpu_torch.cli export-print --width 2400 \\
      --height 3000 --supersample --out print.png
  python -m fractalrenderer_tpu_torch.cli zoom-path --preset-zoom Seahorse \\
      --frames 60 --out-dir zoom_frames
  python -m fractalrenderer_tpu_torch.cli zoom-path --preset-zoom Seahorse \\
      --frames 8 --out-dir zoom_frames --profile traces
  python -m fractalrenderer_tpu_torch.cli sweep --count 16 --out-dir sweep
  python -m fractalrenderer_tpu_torch.cli animate --zoom-to 0.01 \\
      --duration 10 --fps 30 --out-dir frames --encode --codec qtpng
  python -m fractalrenderer_tpu_torch.cli encode frames --codec qtpng \\
      --out zoom.mov
  python -m fractalrenderer_tpu_torch.cli giant --width 16384 \\
      --height 16384 --band-rows 1024 --out giant.png
  python -m fractalrenderer_tpu_torch.cli interactive
  python -m fractalrenderer_tpu_torch.cli interactive --device cpu --repl
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import torch

from . import presets as presets_mod
from .scene import FractalType, Scene
from .utils import png
from .utils.image import downsample2x, to_export_orientation


def _add_scene_args(p: argparse.ArgumentParser):
    p.add_argument("--type", default=None,
                   help="mandelbrot|julia|burning-ship|phoenix|mandelbulb|deep-zoom")
    p.add_argument("--scene", default=None, help="scene JSON file")
    p.add_argument("--preset", default=None, help="named location preset")
    p.add_argument("--center", type=float, nargs=2, default=None,
                   metavar=("X", "Y"),
                   help="view center as one flag (same as --center-x/-y; "
                        "also makes the bare '--center' prefix unambiguous)")
    p.add_argument("--center-x", type=float, default=None)
    p.add_argument("--center-y", type=float, default=None)
    p.add_argument("--zoom", type=float, default=None)
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--bailout", type=float, default=None)
    p.add_argument("--aa", type=int, default=None, choices=(1, 2, 4, 8))
    p.add_argument("--palette", type=int, default=None)
    p.add_argument("--color-offset", type=float, default=None)
    p.add_argument("--color-scale", type=float, default=None)
    p.add_argument("--brightness", type=float, default=None)
    p.add_argument("--saturation", type=float, default=None)
    p.add_argument("--contrast", type=float, default=None)
    p.add_argument("--interior-style", type=int, default=None)
    p.add_argument("--orbit-trap", action="store_true", default=None)
    p.add_argument("--orbit-trap-radius", type=float, default=None)
    p.add_argument("--stripes", action="store_true", default=None)
    p.add_argument("--stripe-density", type=float, default=None)
    p.add_argument("--julia-cr", type=float, default=None)
    p.add_argument("--julia-ci", type=float, default=None)
    p.add_argument("--julia-preset", default=None,
                   help="named Julia c preset (e.g. \"Douady's Rabbit\")")
    p.add_argument("--deep-julia", dest="deep_julia", action="store_true",
                   default=None,
                   help="deep-zoom the JULIA set of --julia-cr/ci (beyond "
                        "the reference, which only deep-zooms Mandelbrot)")
    p.add_argument("--deep-ship", dest="deep_ship", action="store_true",
                   default=None,
                   help="deep-zoom the BURNING SHIP via diffabs "
                        "perturbation (beyond the reference)")
    p.add_argument("--deep-phoenix", dest="deep_phoenix",
                   action="store_true", default=None,
                   help="deep-zoom the PHOENIX set (two-term-recurrence "
                        "perturbation; beyond the reference)")
    p.add_argument("--phoenix-p", type=float, default=None)
    p.add_argument("--phoenix-r", type=float, default=None)
    p.add_argument("--use-julia-set", action="store_true", default=None)
    p.add_argument("--power", type=float, default=None,
                   help="mandelbulb power")
    p.add_argument("--time", type=float, default=None,
                   help="mandelbulb animation clock")
    p.add_argument("--hp-center-x", default=None,
                   help="high-precision center (decimal string, deep zoom)")
    p.add_argument("--hp-center-y", default=None)
    p.add_argument("--hp-zoom", default=None)
    p.add_argument("--perturbation", action="store_true", default=None)
    p.add_argument("--series", action="store_true", default=None,
                   help="series-approximation iteration skip (deep zoom; "
                        "exact — counts are unchanged)")
    p.add_argument("--spp", type=int, default=None, choices=(1, 2, 4),
                   help="deep-zoom samples per pixel axis (spp^2 subpixel "
                        "samples, device-batched; ui_manager.cpp:659-757 "
                        "samples toggle)")
    p.add_argument("--exact-dust", action="store_true",
                   help="Burning Ship dust tier (--deep-ship): per-pixel "
                        "error ledger + 160-bit orbit + HP fallback for "
                        "flagged lanes — oracle-exact counts in chaotic "
                        "dust, at extra host cost (DESIGN.md §8)")


_ARG_TO_FIELD = {
    "center_x": "center_x", "center_y": "center_y", "zoom": "zoom",
    "iters": "max_iterations", "bailout": "bailout",
    "aa": "antialiasing_samples", "palette": "palette_mode",
    "color_offset": "color_offset", "color_scale": "color_scale",
    "brightness": "color_brightness", "saturation": "color_saturation",
    "contrast": "color_contrast", "interior_style": "interior_style",
    "orbit_trap": "orbit_trap_enabled",
    "orbit_trap_radius": "orbit_trap_radius",
    "stripes": "stripe_enabled", "stripe_density": "stripe_density",
    "julia_cr": "julia_c_real", "julia_ci": "julia_c_imag",
    "phoenix_p": "phoenix_p", "phoenix_r": "phoenix_r",
    "use_julia_set": "use_julia_set", "power": "mandelbulb_power",
    "time": "time", "hp_center_x": "hp_center_x",
    "hp_center_y": "hp_center_y", "hp_zoom": "hp_zoom",
    "perturbation": "use_perturbation",
    "deep_julia": "deep_zoom_julia",
    "deep_ship": "deep_zoom_ship",
    "deep_phoenix": "deep_zoom_phoenix",
    "series": "use_series_approximation",
    "spp": "samples_per_pixel",
}


def scene_from_args(args) -> Scene:
    if args.scene:
        with open(args.scene) as f:
            scene = Scene.from_dict(json.load(f))
    else:
        scene = Scene()
    if args.preset:
        scene = presets_mod.find_preset(args.preset).apply(scene)
    if getattr(args, "julia_preset", None):
        cr, ci = presets_mod.JULIA_PRESETS[args.julia_preset]
        scene = scene.with_(julia_c_real=cr, julia_c_imag=ci,
                            fractal_type=FractalType.JULIA)
    if args.type:
        scene = scene.with_(fractal_type=FractalType.parse(args.type))
    if getattr(args, "center", None) is not None:
        # fill only axes the user didn't set explicitly — an explicit
        # --center-x/--center-y always wins over the pair flag
        if args.center_x is None:
            args.center_x = args.center[0]
        if args.center_y is None:
            args.center_y = args.center[1]
    overrides = {}
    for arg, fld in _ARG_TO_FIELD.items():
        v = getattr(args, arg, None)
        if v is not None:
            overrides[fld] = v
    if overrides:
        scene = scene.with_(**overrides)
    return scene


def _size_ok(args) -> bool:
    """A non-positive --width/--height must be a clean error, not a
    kernel-shape traceback (the reference's panel clamps its inputs,
    ui_manager.cpp:617-618)."""
    w, h = getattr(args, "width", 1), getattr(args, "height", 1)
    if w < 1 or h < 1:
        print(f"error: bad render size {w}x{h}", file=sys.stderr)
        return False
    return True


@contextlib.contextmanager
def _orbit_progress():
    """Print reference-orbit progress to stderr during deep-zoom renders
    (the reference prints every 5%, deep_zoom_system.cpp:313-318).  A new
    orbit (done going backwards or a new total) finishes the previous
    line and restarts the 5% ladder."""
    from .deepzoom import orbit as _orbit

    st = {"last": -1, "prev_done": None, "total": None}

    def hook(done, total):
        if (st["total"] != total
                or (st["prev_done"] is not None and done < st["prev_done"])):
            if st["last"] >= 0:
                print(file=sys.stderr)  # finish the previous orbit's line
            st["last"] = -1
            st["total"] = total
        st["prev_done"] = done
        pct = done * 100 // max(total, 1)
        if pct // 5 > st["last"]:
            st["last"] = pct // 5
            print(f"\r  reference orbit {done}/{total} ({pct}%)",
                  end="", file=sys.stderr, flush=True)

    prev = _orbit.progress_hook
    _orbit.progress_hook = hook
    try:
        yield
    finally:
        _orbit.progress_hook = prev
        if st["last"] >= 0:
            print(file=sys.stderr)


def _device_or_none(name: str):
    """The torch device named ``name``, or None after printing why it
    cannot be used."""
    try:
        dev = torch.device(name)
    except RuntimeError:
        print(f"error: unknown device {name!r}", file=sys.stderr)
        return None
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {name}: CUDA is not available here "
              "(--device cpu runs the plain PyTorch path)", file=sys.stderr)
        return None
    if dev.type not in ("cuda", "cpu"):
        print(f"error: unsupported device {name!r}", file=sys.stderr)
        return None
    if dev.type == "cuda" and (dev.index or 0) >= torch.cuda.device_count():
        print(f"error: --device {name}: no such CUDA device (this machine "
              f"has {torch.cuda.device_count()})", file=sys.stderr)
        return None
    return dev


def _mesh_for(dev, frames: bool = False):
    """The device grid of ``--sharded`` and ``--mesh``: every visible CUDA
    device for a CUDA ``dev`` (as row bands, or with ``frames`` one frame
    group each, as the JAX CLI's mesh takes every chip), the one CPU for
    ``--device cpu``."""
    from .parallel import make_render_mesh

    if dev.type == "cpu":
        return make_render_mesh(devices=[dev])
    return make_render_mesh(frames=torch.cuda.device_count() if frames
                            else 1)


def _render(scene: Scene, width: int, height: int, golden: bool, dev):
    """The f32 (H, W, 3) image: the CPU golden reference, or models.render
    on ``dev`` (the JAX CLI's ``_render``)."""
    if golden:
        from .reference import golden as g

        return g.render_scene(scene, width, height)
    from . import models

    return models.render(scene, width, height, device=dev)


def cmd_render(args) -> int:
    if not _size_ok(args):
        return 2
    if args.sharded and (args.golden or args.precision == "dd"):
        print("error: --sharded does not combine with --golden or "
              "--precision dd", file=sys.stderr)
        return 2
    # --golden is the CPU reference; --precision dd takes the dd kernel
    # before it, as in the JAX CLI
    golden = args.golden and args.precision != "dd"
    dev = torch.device("cpu") if golden else _device_or_none(args.device)
    if dev is None:
        return 2
    scene = scene_from_args(args)
    if args.precision == "dd" and scene.fractal_type != FractalType.MANDELBROT:
        print("error: --precision dd is the double-double MANDELBROT kernel "
              f"(got --type {scene.fractal_type.name.lower()})",
              file=sys.stderr)
        return 2
    if args.exact_dust and not (scene.fractal_type == FractalType.DEEP_ZOOM
                                and scene.deep_zoom_ship):
        # a silently ignored exactness flag would be worse than an error
        print("error: --exact-dust is the Burning Ship dust tier: use "
              "--type deep-zoom --deep-ship (see DESIGN.md §8)",
              file=sys.stderr)
        return 2
    if args.exact_dust and args.sharded:
        # the deep-zoom model's own guard, as a clean exit
        print("error: --exact-dust does not compose with --sharded yet (its "
              "HP fallback is per pixel)", file=sys.stderr)
        return 2
    if args.debug:
        from .utils.diag import scene_debug_summary

        print(scene_debug_summary(scene), file=sys.stderr)
    from . import models

    t0 = time.monotonic()
    dz_info = None
    try:
        # quantized on the device; the interleave and flip are tensor glue
        if golden:
            img = _render(scene, args.width, args.height, True, dev)
        elif scene.fractal_type == FractalType.DEEP_ZOOM:
            from .models import deep_zoom
            from .utils.diag import validate_scene

            dz_kw = {"exact_dust": True} if args.exact_dust else {}
            if args.sharded:
                dz_kw["mesh"] = _mesh_for(dev)
            with _orbit_progress():
                img, dz_info = deep_zoom.render(
                    validate_scene(scene), args.width, args.height,
                    return_info=True, quantize=args.bit_depth, device=dev,
                    **dz_kw)
        elif args.precision == "dd":
            from .models.mandelbrot import render_dd
            from .ops.coloring import quantize_image

            img = quantize_image(render_dd(scene, args.width, args.height,
                                           device=dev),
                                 bit_depth=args.bit_depth)
        elif args.sharded:
            # row bands across devices, bit-identical to the one-device
            # render (gather-free: parallel/tiled.py), joined on the host
            from .parallel import render_sharded

            img = render_sharded(scene, args.width, args.height,
                                 mesh=_mesh_for(dev), quantize=args.bit_depth)
        else:
            img = models.render(scene, args.width, args.height, device=dev,
                                quantize=args.bit_depth)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    img = to_export_orientation(img).cpu().numpy()
    dt = time.monotonic() - t0
    meta = {"Software": "fractalrenderer_tpu_torch",
            "Fractal": scene.fractal_type.display_name,
            **scene.metadata_summary()}
    png.write_png(args.out, img, bit_depth=args.bit_depth, metadata=meta,
                  dpi=args.dpi)
    mpix = args.width * args.height / dt / 1e6
    where = "the CPU golden reference" if golden else dev
    print(f"Rendered {args.width}x{args.height} "
          f"{scene.fractal_type.display_name} on {where} in {dt*1e3:.1f} ms "
          f"({mpix:.0f} Mpix/s incl. host transfer) -> {args.out}")
    if dz_info is not None:
        algo = dz_info["algorithm"]
        if algo == "rebase":
            algo = f"rebase x{dz_info['rebase_passes']} passes"
        print(f"  deep zoom: {dz_info['precision_mode']} "
              f"({dz_info['precision_bits']} bits), {algo}, "
              f"{dz_info['references_used']} reference orbit(s), "
              f"{dz_info['glitched_pixels_initial']} glitch-flagged -> "
              f"{dz_info['fallback_pixels']} HP-fallback, "
              f"{dz_info['glitched_pixels_remaining']} remaining")
    return 0


# Above this many rendered pixels (supersampling included) export-print
# streams through the banded giant-still path (render_giant_still): the
# reference's one-allocation staging buffer capped print sizes there
# (vk_engine.cpp:1939-2003); here the 32000-cap presets stay reachable on
# one device.
_BANDED_EXPORT_PIXELS = 1 << 27  # 134M px ≈ 1.6 GB f32 RGB


def cmd_export_print(args) -> int:
    """16-bit print export (vk_engine.cpp:1796-2232): renders at 2x when
    supersampling and embeds gAMA/sRGB/pHYs/tEXt metadata.  Oversized
    renders delegate to the resumable banded exporter."""
    if not _size_ok(args):
        return 2
    scene = scene_from_args(args)
    rw = args.width * 2 if args.supersample else args.width
    rh = args.height * 2 if args.supersample else args.height
    if max(rw, rh) > 32000:  # ui_manager.cpp:617-618
        print("error: render dimension exceeds 32000 cap", file=sys.stderr)
        return 2
    dev = torch.device("cpu") if args.golden \
        else _device_or_none(args.device)
    if dev is None:
        return 2
    if rw * rh > _BANDED_EXPORT_PIXELS and not args.golden:
        from .parallel import render_giant_still

        meta = {
            "Software": "fractalrenderer_tpu_torch (print export)",
            "Print Size (inches)":
                f"{args.width/args.dpi:.2f} x {args.height/args.dpi:.2f}",
        }
        ss = bool(args.supersample and args.downsample)
        w, h = ((args.width, args.height) if ss or not args.supersample
                else (rw, rh))
        print(f"{rw}x{rh} render exceeds one-pass size; streaming in "
              "bands (resumable)")
        t0 = time.monotonic()
        render_giant_still(scene, w, h, args.out, bit_depth=16,
                           dpi=args.dpi, supersample=ss,
                           extra_metadata=meta, keep_tiles=False,
                           device=dev)
        print(f"Exported {w}x{h} 16-bit PNG in "
              f"{time.monotonic()-t0:.1f}s -> {args.out}")
        return 0
    t0 = time.monotonic()
    try:
        img = _render(scene, rw, rh, args.golden, dev)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.supersample and args.downsample:
        img = downsample2x(img)
    meta = {
        "Software": "fractalrenderer_tpu_torch (print export)",
        "Print Size (inches)":
            f"{args.width/args.dpi:.2f} x {args.height/args.dpi:.2f}",
        **scene.metadata_summary(),
    }
    png.write_png(args.out, to_export_orientation(img).cpu().numpy(),
                  bit_depth=16, metadata=meta, dpi=args.dpi)
    print(f"Exported {img.shape[1]}x{img.shape[0]} 16-bit PNG in "
          f"{time.monotonic()-t0:.1f}s -> {args.out}")
    return 0


def cmd_zoom_path(args) -> int:
    """Render one of the reference's deep-zoom preset sequences
    (deep_zoom_system.cpp:575-602), or a zoom to a typed target, as a
    frame sequence with log-zoom interpolation.  Every frame renders on
    the device against one reference orbit at the final centre."""
    import math

    from .deepzoom.manager import ZoomKeyframe, preset_zoom_path
    from .models import render as model_render
    from .utils.diag import trace

    base = scene_from_args(args).with_(fractal_type=FractalType.DEEP_ZOOM,
                                       use_perturbation=True)
    if args.preset_zoom:
        path = preset_zoom_path(args.preset_zoom)
        start, end = path[0], path[1]
    else:
        # the deep-zoom panel's typed Target X/Y/Zoom + Start Zoom
        # Animation (ui_manager.cpp:701-710): zoom from the current view
        # (scene flags / defaults) to the custom target, exactly
        # DeepZoomManager.zoom_to's path shape
        if None in (args.target_x, args.target_y, args.target_zoom):
            print("error: zoom-path needs --preset-zoom or all of "
                  "--target-x/--target-y/--target-zoom", file=sys.stderr)
            return 2
        start = ZoomKeyframe(base.center_x, base.center_y, base.zoom, 0.0)
        end = ZoomKeyframe(args.target_x, args.target_y, args.target_zoom)
    if not _size_ok(args):
        return 2
    dev = _device_or_none(args.device)
    if dev is None:
        return 2
    os.makedirs(args.out_dir, exist_ok=True)
    # One reference orbit at the final (deepest) center serves every frame
    # via the shift mechanism; the cache also holds it across frames.  The
    # reference recomputed per frame (deep_zoom_system.cpp:454-559).
    ref_center = (repr(end.center_x), repr(end.center_y))
    cache = {}
    with trace(args.profile, device=dev), _orbit_progress():
        for f in range(args.frames):
            t = f / max(args.frames - 1, 1)
            cx = start.center_x + t * (end.center_x - start.center_x)
            cy = start.center_y + t * (end.center_y - start.center_y)
            zoom = math.exp(math.log(start.zoom)
                            + t * (math.log(end.zoom)
                                   - math.log(start.zoom)))
            sc = base.with_(center_x=cx, center_y=cy, zoom=zoom,
                            hp_center_x=repr(cx), hp_center_y=repr(cy),
                            hp_zoom=repr(zoom))
            # quantized to uint8 on the device: the frames fetch 1 B per
            # channel
            img = model_render(sc, args.width, args.height, device=dev,
                               ref_center=ref_center, orbit_cache=cache,
                               quantize=8)
            png.write_png(os.path.join(args.out_dir, f"frame_{f:06d}.png"),
                          to_export_orientation(img).cpu().numpy())
            print(f"\rframe {f+1}/{args.frames} zoom={zoom:.3e}", end="",
                  flush=True)
    print()
    return 0


def cmd_animate(args) -> int:
    """Render an animation (a .franim file, or a two-keyframe zoom from the
    scene flags) to a PNG sequence, optionally encoded to video."""
    from .anim import AnimationRenderer, franim, video
    from .anim.keyframes import Animation, Keyframe
    from .utils.diag import trace

    dev = _device_or_none(args.device)
    if dev is None:
        return 2
    if args.franim:
        try:
            anim = franim.load(args.franim)
        except (ValueError, OSError) as e:
            print(f"error: cannot load {args.franim}: {e}",
                  file=sys.stderr)
            return 2
    else:
        # Build a two-keyframe zoom animation from CLI args
        scene = scene_from_args(args)
        end = scene.with_(zoom=args.zoom_to) if args.zoom_to else scene
        anim = Animation(duration=args.duration, target_fps=args.fps or 60)
        anim.keyframes.append(Keyframe(0.0, scene))
        anim.keyframes.append(Keyframe(args.duration, end))
    if args.fps:
        anim.target_fps = args.fps
    if args.duration and args.franim is None:
        anim.duration = args.duration
    if args.width:
        anim.export_width = args.width
    if args.height:
        anim.export_height = args.height
    if args.save_franim:
        franim.save(anim, args.save_franim)
        print(f"Saved animation -> {args.save_franim}")

    # --sharded: frame batches split over every visible device, one frame
    # group each (render_frames_sharded)
    r = AnimationRenderer(batch_size=args.batch_size, device=dev,
                          mesh=_mesh_for(dev, frames=True) if args.sharded
                          else None)
    last = [-1]

    def on_frame(f, total):
        pct = 100.0 * r.progress.progress
        if f - last[0] >= max(1, total // 100):
            print(f"\rRendering frame {f+1}/{total} ({pct:.1f}%) "
                  f"ETA {r.progress.estimated_time_remaining:.0f}s",
                  end="", flush=True)
            last[0] = f

    r.on_frame_complete = on_frame
    with trace(args.profile, device=dev):
        ok = r.start_render(anim, args.out_dir, args.width, args.height,
                            bit_depth=args.bit_depth, resume=args.resume)
    print()
    if not ok:
        print("render failed or cancelled", file=sys.stderr)
        return 1
    print(f"Rendered {anim.total_frames} frames -> {args.out_dir}")
    if args.encode:
        settings = video.VideoEncodeSettings(
            output_filename=args.video_out
            or os.path.join(args.out_dir, "animation.mp4"),
            codec=video.VideoCodec(args.codec),
            quality=video.VideoQuality(args.quality),
            fps=anim.target_fps, crf=args.crf,
            cleanup_frames=args.cleanup_frames)
        enc = video.VideoEncoder()
        if not enc.encode(args.out_dir, settings):
            print(f"encode failed: {enc.progress.error}", file=sys.stderr)
            return 1
        print(f"Encoded -> {settings.output_filename}")
    return 0


def cmd_encode(args) -> int:
    """Encode an existing frame sequence (ffmpeg, or the built-in qtpng
    muxer)."""
    from .anim import video

    settings = video.VideoEncodeSettings(
        output_filename=args.out, codec=video.VideoCodec(args.codec),
        quality=video.VideoQuality(args.quality), fps=args.fps,
        crf=args.crf, audio_file=args.audio or "",
        cleanup_frames=args.cleanup_frames)
    enc = video.VideoEncoder()

    def on_p(p):
        print(f"\rframe {p.current_frame}/{p.total_frames} fps={p.fps:.0f}",
              end="", flush=True)

    enc.on_progress = on_p
    ok = enc.encode(args.frames_dir, settings)
    print()
    if not ok:
        print(f"encode failed: {enc.progress.error}", file=sys.stderr)
        return 1
    # qtpng corrects the extension to .mov in settings
    print(f"Encoded -> {settings.output_filename}")
    return 0


def cmd_giant(args) -> int:
    """BASELINE config #5: a progressive, resumable giant still, rendered
    in row bands and streamed into one PNG (parallel.render_giant_still)."""
    from .parallel import render_giant_still

    if not _size_ok(args):
        return 2
    if args.band_rows < 1:
        print(f"error: bad --band-rows {args.band_rows}", file=sys.stderr)
        return 2
    dev = _device_or_none(args.device)
    if dev is None:
        return 2
    scene = scene_from_args(args)

    def cb(b, total):
        print(f"\rband {b}/{total}", end="", flush=True)

    info = render_giant_still(
        scene, args.width, args.height, args.out,
        band_rows=args.band_rows, tile_dir=args.tile_dir,
        resume=not args.no_resume, bit_depth=args.bit_depth, dpi=args.dpi,
        mesh=_mesh_for(dev) if args.mesh else None, use_mesh=args.mesh,
        supersample=args.supersample, progress_cb=cb, device=dev)
    print(f"\n{info['rendered']} bands rendered, {info['skipped']} resumed "
          f"-> {info['out']}")
    return 0


def cmd_sweep(args) -> int:
    """BASELINE config #2: render a batch of Julia c values (aa² K1
    launches each, on one stream) and write a PNG per c."""
    from .models.julia import render_c_sweep

    if not _size_ok(args):
        return 2
    dev = _device_or_none(args.device)
    if dev is None:
        return 2
    scene = scene_from_args(args).with_(fractal_type=FractalType.JULIA)
    c0 = tuple(float(v) for v in args.c_start.split(","))
    c1 = tuple(float(v) for v in args.c_end.split(","))
    n = max(args.count, 1)
    cs = [(c0[0] + (c1[0] - c0[0]) * k / max(n - 1, 1),
           c0[1] + (c1[1] - c0[1]) * k / max(n - 1, 1)) for k in range(n)]
    t0 = time.monotonic()
    out = render_c_sweep(scene, cs, args.width, args.height,
                         device=dev).cpu()
    dt = time.monotonic() - t0
    os.makedirs(args.out_dir, exist_ok=True)
    for k, (img, c) in enumerate(zip(out, cs)):
        png.write_png(os.path.join(args.out_dir, f"sweep_{k:03d}.png"),
                      to_export_orientation(img).numpy(),
                      metadata={"Julia c": f"{c[0]} + {c[1]}i"})
    mpix = n * args.width * args.height / dt / 1e6
    print(f"Rendered {n} c values in {dt:.2f}s ({mpix:.0f} Mpix/s) "
          f"-> {args.out_dir}")
    return 0


def cmd_interactive(args) -> int:
    """The terminal viewer on ``--device``: the live raw-terminal loop on a
    TTY (live.py), the line REPL when piped or with ``--repl``
    (viewer.py).  Where the JAX CLI probes its device link first
    (cli.py:708), this verb makes the other verbs' check: a CUDA device
    that does not exist exits 2 before the session starts, and nothing
    renders on the CPU instead."""
    dev = _device_or_none(args.device)
    if dev is None:
        return 2
    scene = scene_from_args(args)
    no_explicit_view = (args.zoom is None and args.scene is None
                        and args.preset is None)
    if no_explicit_view:
        scene = scene.with_(zoom=2.5)
    # Live raw-terminal loop on a TTY (the reference's real-time event
    # loop); line-based REPL when piped or forced with --repl.
    live_mode = args.live or (not args.repl and sys.stdin.isatty())
    if live_mode:
        from . import live

        # the reference resumes where you left it (imgui.ini persists
        # next to the binary); explicit view args or --fresh start clean.
        # Exit without interpreter teardown on every path (normal return,
        # ^C, device errors), as the JAX CLI does: run_live restores the
        # terminal and persists the session on all of these paths itself,
        # nothing later relies on atexit, and no thread still running is
        # joined.
        rc = 1
        try:
            rc = live.run_live(
                scene, cols=args.cols, rows=args.rows,
                spin=args.spin, max_frames=args.max_frames,
                resume_last=no_explicit_view and not args.fresh,
                persist=not args.fresh, gfx=args.gfx, device=dev)
        except BaseException:
            import traceback

            traceback.print_exc()
        finally:
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(rc)
    from . import viewer

    return viewer.run(scene, cols=args.cols, rows=args.rows, device=dev)


def cmd_presets(args) -> int:
    print("Location presets (fractal_state.h:171-189):")
    for p in presets_mod.MANDELBROT_PRESETS + presets_mod.BURNING_SHIP_PRESETS:
        print(f"  {p.name:18s} {p.fractal_type.display_name:13s} "
              f"center=({p.center_x}, {p.center_y}) zoom={p.zoom} "
              f"iters={p.iterations}")
    print("\nJulia c presets:")
    for name, (cr, ci) in presets_mod.JULIA_PRESETS.items():
        print(f"  {name:18s} c = {cr} + {ci}i")
    print("\nPhoenix (p, r) presets:")
    for name, (pp, rr) in presets_mod.PHOENIX_PRESETS.items():
        print(f"  {name:18s} p={pp} r={rr}")
    print("\nMandelbulb power presets:")
    for name, pw in presets_mod.MANDELBULB_POWER_PRESETS.items():
        print(f"  {name:18s} power={pw}")
    print("\nDeep-zoom targets (deep_zoom_system.cpp:575-602):")
    for z in presets_mod.DEEP_ZOOM_PRESETS:
        print(f"  {z.name:22s} center=({z.center_x}, {z.center_y}) "
              f"zoom={z.zoom}")
    print("\nPrint sizes (ui_manager.cpp:595-611):")
    for name, (w, h) in presets_mod.PRINT_SIZE_PRESETS.items():
        print(f"  {name:18s} {w}x{h}")
    from .ops import palettes as pal

    print("\nPalettes:")
    print(f"  mandelbrot/phoenix ({pal.num_palettes('classic')}): "
          + ", ".join(pal.CLASSIC_NAMES))
    print(f"  julia/burning-ship ({pal.num_palettes('enhanced')}): "
          + ", ".join(pal.ENHANCED_NAMES))
    print(f"  deep zoom ({pal.num_palettes('deepzoom')}): hsv, blue, fire, "
          "gray")
    print(f"  mandelbulb ({pal.num_palettes('bulb')}): dynamic, fire_and_ice,"
          " lava, neon, dynamic^0.5, fire_and_ice^0.6")
    return 0


def cmd_info(args) -> int:
    """The package, torch and CUDA versions, each CUDA device, the nvcc
    the kernels build with, and whether the kernel library of these
    sources is built (nothing is built or launched)."""
    import subprocess

    from . import __version__
    from .ops import _cuda

    print(f"fractalrenderer_tpu_torch {__version__}")
    cuda = torch.cuda.is_available()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, backend: "
          + ("cuda" if cuda else "cpu (no CUDA device: --device cpu runs "
                                 "the plain PyTorch path)"))
    for i in range(torch.cuda.device_count() if cuda else 0):
        print(f"  device: cuda:{i} {torch.cuda.get_device_name(i)}")
    try:
        nvcc = _cuda.find_nvcc()
    except RuntimeError:
        print("nvcc: NOT FOUND: kernels cannot build")
    else:
        ver = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        print(f"nvcc: {nvcc} ({ver.splitlines()[-1] if ver else '?'})")
    lib = _cuda.library_path()
    print(f"kernel library: {'built' if os.path.exists(lib) else 'not built'}"
          f" ({lib})")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="fractalrenderer_tpu_torch",
        description="Fractal renderer, PyTorch + CUDA port")
    sub = ap.add_subparsers(dest="command", required=True)
    device_help = ("torch device: cuda (the CUDA kernels, default) or cpu "
                   "(their plain PyTorch versions)")
    profile_help = ("run the verb under torch.profiler and write a chrome "
                    "trace into DIR: the program's stage spans beside the "
                    "card's records")

    p = sub.add_parser("render", help="render one frame to PNG")
    _add_scene_args(p)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--out", default="fractal.png")
    p.add_argument("--bit-depth", type=int, default=8, choices=(8, 16))
    p.add_argument("--dpi", type=float, default=None)
    p.add_argument("--device", default="cuda", help=device_help)
    p.add_argument("--golden", action="store_true",
                   help="render with the CPU golden reference (2D "
                        "families; slow)")
    p.add_argument("--precision", default="f32", choices=("f32", "dd"),
                   help="dd = double-double Mandelbrot kernel")
    p.add_argument("--debug", action="store_true",
                   help="print a scene debug summary")
    p.add_argument("--sharded", action="store_true",
                   help="split the frame's rows across the visible devices")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("export-print",
                       help="16-bit print-quality export @300DPI")
    _add_scene_args(p)
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--height", type=int, required=True)
    p.add_argument("--supersample", action="store_true",
                   help="render at 2x (written as-is, like the reference)")
    p.add_argument("--downsample", action="store_true",
                   help="box-filter the 2x render back to target size")
    p.add_argument("--dpi", type=float, default=300.0)
    p.add_argument("--out", default="print.png")
    p.add_argument("--golden", action="store_true",
                   help="render with the CPU golden reference")
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=cmd_export_print)

    p = sub.add_parser("zoom-path", help="render a deep-zoom preset sequence")
    _add_scene_args(p)
    p.add_argument("--preset-zoom",
                   help="Seahorse|Elephant|Mini (deep_zoom_system presets)")
    p.add_argument("--target-x", type=float, default=None,
                   help="custom zoom target (the deep-zoom panel's typed "
                        "Target X/Y/Zoom, ui_manager.cpp:701-710); "
                        "needs --target-y/--target-zoom too")
    p.add_argument("--target-y", type=float, default=None)
    p.add_argument("--target-zoom", type=float, default=None)
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=540)
    p.add_argument("--out-dir", default="zoom_frames")
    p.add_argument("--device", default="cuda", help=device_help)
    p.add_argument("--profile", metavar="DIR", default=None,
                   help=profile_help)
    p.set_defaults(fn=cmd_zoom_path)

    p = sub.add_parser("animate", help="render an animation (.franim or zoom)")
    _add_scene_args(p)
    p.add_argument("--franim", default=None, help=".franim animation file")
    p.add_argument("--zoom-to", type=float, default=None,
                   help="end zoom for a 2-keyframe zoom animation")
    p.add_argument("--duration", type=float, default=10.0)
    p.add_argument("--fps", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--out-dir", default="frames")
    p.add_argument("--save-franim", default=None,
                   help="also write the animation as a .franim file")
    p.add_argument("--bit-depth", type=int, default=8, choices=(8, 16))
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--resume", action="store_true",
                   help="skip frames already complete in --out-dir "
                        "(resume an interrupted sequence render)")
    p.add_argument("--sharded", action="store_true",
                   help="split frame batches across the visible devices")
    p.add_argument("--encode", action="store_true")
    p.add_argument("--video-out", default=None)
    p.add_argument("--codec", default="h264",
                   choices=["h264", "h265", "vp9", "prores", "av1", "qtpng"])
    p.add_argument("--quality", default="high",
                   choices=["draft", "good", "high", "lossless"])
    p.add_argument("--crf", type=int, default=18)
    p.add_argument("--cleanup-frames", action="store_true")
    p.add_argument("--device", default="cuda", help=device_help)
    p.add_argument("--profile", metavar="DIR", default=None,
                   help=profile_help)
    p.set_defaults(fn=cmd_animate)

    p = sub.add_parser("encode", help="encode an existing frame sequence")
    p.add_argument("frames_dir")
    p.add_argument("--out", default="animation.mp4")
    p.add_argument("--codec", default="h264",
                   choices=["h264", "h265", "vp9", "prores", "av1", "qtpng"])
    p.add_argument("--quality", default="high",
                   choices=["draft", "good", "high", "lossless"])
    p.add_argument("--fps", type=int, default=60)
    p.add_argument("--crf", type=int, default=18)
    p.add_argument("--audio", default=None)
    p.add_argument("--cleanup-frames", action="store_true")
    p.set_defaults(fn=cmd_encode)

    p = sub.add_parser("giant", help="progressive/resumable giant still")
    _add_scene_args(p)
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--height", type=int, required=True)
    p.add_argument("--band-rows", type=int, default=512)
    p.add_argument("--out", default="giant.png")
    p.add_argument("--bit-depth", type=int, default=16, choices=(8, 16))
    p.add_argument("--dpi", type=float, default=300.0)
    p.add_argument("--tile-dir", default=None)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--mesh", action="store_true",
                   help="split each band across all devices")
    p.add_argument("--supersample", action="store_true",
                   help="render bands at 2x and box-downsample "
                        "(banded form of export-print --supersample)")
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=cmd_giant)

    p = sub.add_parser("sweep", help="batched Julia c-parameter sweep")
    _add_scene_args(p)
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=540)
    p.add_argument("--c-start", default="-0.9,0.1",
                   help="start c as 're,im'")
    p.add_argument("--c-end", default="-0.6,0.3", help="end c as 're,im'")
    p.add_argument("--count", type=int, default=16)
    p.add_argument("--out-dir", default="sweep")
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("interactive",
                       help="terminal viewer (live loop on a TTY; REPL "
                            "when piped)")
    _add_scene_args(p)
    p.add_argument("--cols", type=int, default=None)
    p.add_argument("--rows", type=int, default=None)
    p.add_argument("--live", action="store_true",
                   help="force the raw-terminal live loop")
    p.add_argument("--repl", action="store_true",
                   help="force the line-based REPL")
    p.add_argument("--spin", action="store_true",
                   help="start with mandelbulb auto-rotate on "
                        "(vk_engine.cpp:713)")
    p.add_argument("--max-frames", type=int, default=None,
                   help="exit after N drawn frames (for testing)")
    p.add_argument("--fresh", action="store_true",
                   help="don't resume the previous session or persist "
                        "this one (default resumes like the reference's "
                        "imgui.ini)")
    p.add_argument("--gfx", default=None,
                   choices=["auto", "kitty", "iterm", "sixel", "off"],
                   help="pixel-frame protocol for the live session "
                        "(default auto: in-band handshake; kitty/ghostty/"
                        "wezTerm/konsole speak kitty, iTerm2 its own, "
                        "xterm/foot/mlterm sixel; falls back to "
                        "half-block cells)")
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=cmd_interactive)

    p = sub.add_parser("presets", help="list the built-in presets")
    p.set_defaults(fn=cmd_presets)
    p = sub.add_parser("info", help="versions, CUDA devices, nvcc and the "
                                    "kernel library")
    p.set_defaults(fn=cmd_info)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
