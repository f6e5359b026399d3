"""Command-line interface of the PyTorch port (counterpart of
``fractalrenderer_tpu/cli.py``).  The ``info`` and ``presets`` verbs are
ported, and ``render`` for the four 2D families (every AA, trap, stripe,
interior-style and Julia option), ``--precision dd``, ``--type
deep-zoom`` (the rebasing
perturbation path at every depth: Mandelbrot with ``--series``,
``--deep-julia``, ``--deep-ship`` with ``--exact-dust``, ``--deep-phoenix``,
and ``--spp 2|4`` supersampling) and ``--type mandelbulb`` (``--power``,
``--time``, ``--aa``, ``--palette``); the other verbs and the unported
render options exit with code 2 and a one-line message naming the ROADMAP
item that ports them.

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
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from . import presets as presets_mod
from .scene import FractalType, Scene
from .utils import png
from .utils.image import to_export_orientation


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


# render options the port does not run yet → ROADMAP Queue 1 item
_UNPORTED_RENDER_FLAGS = (
    ("golden", "--golden", 4),
    ("sharded", "--sharded", 8),
)

# verbs of the JAX CLI the port does not run yet → ROADMAP Queue 1 item
_UNPORTED_VERBS = {
    "export-print": 4, "animate": 4, "encode": 4, "sweep": 3,
    "zoom-path": 6, "giant": 8, "interactive": 9,
}


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
    return dev


def cmd_render(args) -> int:
    if not _size_ok(args):
        return 2
    for attr, flag, item in _UNPORTED_RENDER_FLAGS:
        if getattr(args, attr):
            print(f"error: {flag} is not ported yet (ROADMAP Queue 1 item "
                  f"{item})", file=sys.stderr)
            return 2
    dev = _device_or_none(args.device)
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
    if args.debug:
        from .utils.diag import scene_debug_summary

        print(scene_debug_summary(scene), file=sys.stderr)
    from . import models

    t0 = time.monotonic()
    dz_info = None
    try:
        # quantized on the device; the interleave and flip are tensor glue
        if scene.fractal_type == FractalType.DEEP_ZOOM:
            from .models import deep_zoom
            from .utils.diag import validate_scene

            dz_kw = {"exact_dust": True} if args.exact_dust else {}
            with _orbit_progress():
                img, dz_info = deep_zoom.render(
                    validate_scene(scene), args.width, args.height,
                    return_info=True, quantize=args.bit_depth, device=dev,
                    **dz_kw)
        elif args.precision == "dd":
            from .models.common import quantize_image
            from .models.mandelbrot import render_dd

            img = quantize_image(render_dd(scene, args.width, args.height,
                                           device=dev),
                                 bit_depth=args.bit_depth)
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
    print(f"Rendered {args.width}x{args.height} "
          f"{scene.fractal_type.display_name} on {dev} in {dt*1e3:.1f} ms "
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
    import os
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

    p = sub.add_parser("render", help="render one frame to PNG")
    _add_scene_args(p)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--out", default="fractal.png")
    p.add_argument("--bit-depth", type=int, default=8, choices=(8, 16))
    p.add_argument("--dpi", type=float, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the CUDA kernels, default) or "
                        "cpu (their plain PyTorch versions)")
    p.add_argument("--golden", action="store_true",
                   help="render with the CPU golden reference (not ported)")
    p.add_argument("--precision", default="f32", choices=("f32", "dd"),
                   help="dd = double-double Mandelbrot kernel")
    p.add_argument("--debug", action="store_true",
                   help="print a scene debug summary")
    p.add_argument("--sharded", action="store_true",
                   help="shard the frame's rows across devices (not ported)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("presets", help="list the built-in presets")
    p.set_defaults(fn=cmd_presets)
    p = sub.add_parser("info", help="versions, CUDA devices, nvcc and the "
                                    "kernel library")
    p.set_defaults(fn=cmd_info)

    for verb, item in _UNPORTED_VERBS.items():
        p = sub.add_parser(verb, help=f"not ported yet (ROADMAP Queue 1 "
                                      f"item {item})")
        p.set_defaults(fn=None, roadmap_item=item)
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args, extra = ap.parse_known_args(argv)
    if args.fn is None:
        print(f"error: the {args.command!r} verb is not ported yet (ROADMAP "
              f"Queue 1 item {args.roadmap_item})", file=sys.stderr)
        return 2
    if extra:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
