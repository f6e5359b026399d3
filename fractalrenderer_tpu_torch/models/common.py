"""Shared render pipeline for the 2D escape-time families (the port's
counterpart of ``fractalrenderer_tpu/models/common.py``).

Pipeline per frame (mirrors the shader main() structure):
  for each AA offset: escape kernel → per-sample colouring
  average samples → enhance/ACES/gamma post chain

Two branches, chosen per static configuration as the JAX package chooses:
the fused branch colours in the kernel's epilogue (and applies the post
chain there too when there is one sample); the unfused branch takes the
fields (with the trap and stripe planes its colouring reads) and colours,
averages and post-chains them as tensor glue.  Every scalar is rounded
to f32 first, as the JAX pipeline casts its traced values: the kernel's
parameter vector (ops/escape.pack_params) and the glue's f32 tensors on
the device.

PyTorch runs eagerly, so there is no compiled-function cache: ``render_fn``
builds the per-configuration closure directly, and ``batch_render_fn``
renders a batch of frames as one launch sequence on the current stream.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..ops import coloring, mapping
from ..ops.coloring import ColorParams, quantize_image
from ..ops.escape import escape_fields
from ..scene import Scene
from ..utils.diag import span


@dataclass(frozen=True)
class StaticCfg:
    family: str
    width: int
    height: int
    max_iter: int
    aa: int
    palette_mode: int
    interior_style: int
    orbit_trap_enabled: bool
    stripe_enabled: bool
    use_julia: bool
    clamp_mins: bool          # julia/bs/phoenix clamp brightness/sat/contrast
    aa_convention: str        # 'centered' (mandelbrot) or 'uv'
    device: str = "cuda"


# fractal type → (kernel family, AA convention, post-chain clamp) for the
# four 2D escape-time families (mandelbulb/deep-zoom have their own models).
def family_map():
    from ..scene import FractalType

    return {
        FractalType.MANDELBROT: ("mandelbrot", "centered", False),
        FractalType.JULIA: ("julia", "uv", True),
        FractalType.BURNING_SHIP: ("burning_ship", "uv", True),
        FractalType.PHOENIX: ("phoenix", "uv", True),
    }


# Dynamic parameters: plain dict of floats.
DYN_KEYS = ("center_x", "center_y", "zoom", "bailout", "iter_limit",
            "julia_c_real", "julia_c_imag", "phoenix_p", "phoenix_r",
            "color_offset", "color_scale", "orbit_trap_radius",
            "stripe_density", "brightness", "saturation", "contrast")


def _iter_bucket(max_iter: int) -> int:
    """Round the static cap up to a power of two (min 256), below the f32
    counter ceiling.  The escape loop is bounded by the dynamic
    iter_limit; the cap only bounds it from above (the JAX package shares
    one compiled kernel per bucket; the port keeps the bucket so both clamp
    an oversized limit to the same value)."""
    b = 256
    while b < max_iter:
        b *= 2
    return min(b, (1 << 24) - 1)


def scene_static_cfg(scene: Scene, width: int, height: int,
                     family: str, aa_convention: str, clamp_mins: bool,
                     **kw) -> StaticCfg:
    return StaticCfg(
        family=family, width=width, height=height,
        max_iter=_iter_bucket(int(scene.max_iterations)),
        aa=max(int(scene.antialiasing_samples), 1),
        palette_mode=int(scene.palette_mode),
        interior_style=int(scene.interior_style),
        orbit_trap_enabled=bool(scene.orbit_trap_enabled),
        stripe_enabled=bool(scene.stripe_enabled),
        use_julia=bool(scene.use_julia_set),
        clamp_mins=clamp_mins, aa_convention=aa_convention, **kw)


def scene_dyn_params(scene: Scene) -> dict:
    """Extract the dynamic parameter dict; keys == DYN_KEYS."""
    return {
        "center_x": scene.center_x, "center_y": scene.center_y,
        "zoom": scene.zoom, "bailout": scene.bailout,
        "iter_limit": float(scene.max_iterations),
        "julia_c_real": scene.julia_c_real, "julia_c_imag": scene.julia_c_imag,
        "phoenix_p": scene.phoenix_p, "phoenix_r": scene.phoenix_r,
        "color_offset": scene.color_offset, "color_scale": scene.color_scale,
        "orbit_trap_radius": scene.orbit_trap_radius,
        "stripe_density": scene.stripe_density,
        "brightness": scene.color_brightness,
        "saturation": scene.color_saturation,
        "contrast": scene.color_contrast,
    }


def _track_flags(cfg: StaticCfg) -> Tuple[bool, bool]:
    if cfg.family == "mandelbrot":
        track_trap = cfg.orbit_trap_enabled or cfg.interior_style == 2
        return track_trap, False
    if cfg.family == "burning_ship":
        track_trap = cfg.orbit_trap_enabled
        track_stripe = cfg.stripe_enabled and cfg.interior_style == 2
        return track_trap, track_stripe
    return False, False


def _color_params(cfg: StaticCfg, dyn: dict) -> ColorParams:
    """ColorParams of the unfused branch from the f32 dynamic scalars;
    max_iterations is the iteration limit clamped to the static cap, as
    the kernel clamps n.  The cap's copy counts in
    ``band_render_fn.param_uploads``."""
    cap = torch.tensor(float(cfg.max_iter), dtype=torch.float32,
                       device=dyn["iter_limit"].device)
    band_render_fn.param_uploads += 1
    return ColorParams(
        max_iterations=torch.minimum(dyn["iter_limit"], cap),
        bailout=dyn["bailout"],
        palette_mode=cfg.palette_mode,
        color_offset=dyn["color_offset"],
        color_scale=dyn["color_scale"],
        interior_style=cfg.interior_style,
        orbit_trap_enabled=cfg.orbit_trap_enabled,
        orbit_trap_radius=dyn["orbit_trap_radius"],
        stripe_enabled=cfg.stripe_enabled,
        stripe_density=dyn["stripe_density"],
        phoenix_stripe_control=dyn["stripe_density"],
    )


def _interior_skip_ok(cfg: StaticCfg) -> bool:
    """The analytic interior skip is exact for n but zeroes the interior z,
    so it is only safe when nothing reads interior z.  Also the Mandelbrot
    fused-colouring eligibility condition."""
    return (cfg.family == "mandelbrot"
            and not cfg.stripe_enabled
            and not cfg.orbit_trap_enabled
            and cfg.interior_style != 2)


def _fused_ok(cfg: StaticCfg) -> bool:
    """The in-kernel fused-colouring eligibility predicate: no trap or
    stripe consumers and no interior-z reader.  Julia and Phoenix fuse
    unconditionally."""
    track_trap, track_stripe = _track_flags(cfg)
    return (cfg.family in ("julia", "phoenix")
            or _interior_skip_ok(cfg)
            or (cfg.family == "burning_ship"
                and not track_trap and not track_stripe))


def planar_export_ok(cfg: StaticCfg) -> bool:
    """True when the config can export as quantized planar planes
    (3, H, W): the fused kernel emits the post-chained planes of the single
    AA sample, so quantization consumes them directly."""
    return _fused_ok(cfg) and cfg.aa == 1


def _dyn_f32(dyn: dict, device) -> dict:
    """The dynamic scalars as f32 tensors on the device (the JAX pipeline
    casts every value to jnp.float32 before the pipeline sees it), copied
    to the device in one transfer, counted in
    ``band_render_fn.param_uploads``."""
    keys = list(dyn)
    vals = torch.tensor([float(dyn[k]) for k in keys], dtype=torch.float32,
                        device=device)
    band_render_fn.param_uploads += 1
    return {k: vals[i] for i, k in enumerate(keys)}


def _sample(cfg: StaticCfg, dyn: dict, band_h: int, full_h: int, row0: int,
            off, **kw):
    return escape_fields(
        cfg.family, cfg.width, band_h,
        center_x=dyn["center_x"], center_y=dyn["center_y"],
        zoom=dyn["zoom"], max_iter=cfg.max_iter, bailout=dyn["bailout"],
        offset=off, julia_c=(dyn["julia_c_real"], dyn["julia_c_imag"]),
        phoenix_p=dyn["phoenix_p"], phoenix_r=dyn["phoenix_r"],
        use_julia=cfg.use_julia, trap_radius=dyn["orbit_trap_radius"],
        stripe_density=dyn["stripe_density"], iter_limit=dyn["iter_limit"],
        row0=row0, map_height=full_h, interior_skip=_interior_skip_ok(cfg),
        device=cfg.device, **kw)


def _average_then_post(cfg: StaticCfg, dyn: dict, acc: torch.Tensor,
                       count: int) -> torch.Tensor:
    """Sample average, divided by a device tensor (its copy counted in
    ``band_render_fn.param_uploads``), then the post chain."""
    denom = torch.tensor(float(count), dtype=torch.float32,
                         device=acc.device)
    band_render_fn.param_uploads += 1
    return coloring.post_chain_traced(
        acc / denom, dyn["brightness"], dyn["saturation"], dyn["contrast"],
        clamp_mins=cfg.clamp_mins)


def band_render_fn(cfg: StaticCfg, band_h: int, full_h: int,
                   planar_quantize: int = 0):
    """Build fn(dyn, row0, out=None) rendering ``band_h`` local rows whose
    global first row is ``row0``.  Returns f32 (band_h, W, 3), or with
    ``planar_quantize`` 8/16 the quantized (3, band_h, W) planes (only
    when ``planar_export_ok(cfg)``).  ``out``, a tensor of that shape and
    dtype, receives the result in the pipeline's last operation; on the
    card the quantized planes are K1's own stores, into ``out`` (which
    must then be contiguous) or a tensor made for the call.

    A frame of more than one sample, or of the unfused branch, runs its
    sample average, the post chain and the copy into ``out`` in the span
    ``batch.post``; a fused single-sample frame opens none.  Each copy of
    a frame's host scalars to the device (``_dyn_f32``, the average's
    divisor, the unfused colouring's cap; on the card each a synchronising
    pageable copy) adds one to ``band_render_fn.param_uploads``: two a
    fused multi-sample frame, three an unfused one, none a fused
    single-sample one."""
    if torch.device(cfg.device).type == "cuda":
        from ..ops._cuda import cuda_device

        cuda_device(cfg.device)  # raises before any tensor is made
    if planar_quantize and not planar_export_ok(cfg):
        raise ValueError("planar_quantize requires a fused single-sample "
                         "config (planar_export_ok)")
    if cfg.aa_convention == "centered":
        offsets = mapping.aa_offsets_centered(cfg.aa)
    else:
        offsets = mapping.aa_offsets_uv(cfg.aa, cfg.width)
    track_trap, track_stripe = _track_flags(cfg)

    if _fused_ok(cfg):
        # The kernel colours each sample; with one sample it also applies
        # the post chain, with more it emits pre-post-chain planes that are
        # summed in offset order and post-chained here.
        with_post = len(offsets) == 1
        # on the card K1's epilogue quantizes the planar frame itself, so
        # the frame launches no glue; the plain K1 on the CPU leaves it to
        # the stack and quantize_image below
        in_kernel = (bool(planar_quantize)
                     and torch.device(cfg.device).type == "cuda")
        qdtype = torch.uint8 if planar_quantize == 8 else torch.uint16

        def fused(dyn, row0: int, out=None):
            # only a sum of samples needs the accumulator: one sample returns
            # the kernel's planes, so a frame fills no buffer it never reads
            acc = None if with_post else torch.zeros(
                (band_h, cfg.width, 3), dtype=torch.float32, device=cfg.device)
            if in_kernel and out is None:
                out = torch.empty((3, band_h, cfg.width), dtype=qdtype,
                                  device=cfg.device)
            for off in offsets:
                f = _sample(cfg, dyn, band_h, full_h, row0, off,
                            fused_color=(cfg.palette_mode,
                                         cfg.interior_style, cfg.clamp_mins,
                                         with_post),
                            color_offset=dyn["color_offset"],
                            color_scale=dyn["color_scale"],
                            brightness=dyn["brightness"],
                            saturation=dyn["saturation"],
                            contrast=dyn["contrast"],
                            quantized=out if in_kernel else None)
                if in_kernel:
                    return out
                with span("batch.glue"):
                    if planar_quantize:
                        planes = torch.stack([f["r"], f["g"], f["b"]], dim=0)
                        return quantize_image(planes,
                                              bit_depth=planar_quantize,
                                              out=out)
                    if with_post:  # the one sample, already post-chained
                        return torch.stack([f["r"], f["g"], f["b"]], dim=-1,
                                           out=out)
                    acc = acc + torch.stack([f["r"], f["g"], f["b"]], dim=-1)
            with span("batch.post"):
                return _into(out, _average_then_post(
                    cfg, _dyn_f32(dyn, cfg.device), acc, len(offsets)))

        return fused

    def unfused(dyn, row0: int, out=None):
        dyn_t = _dyn_f32(dyn, cfg.device)
        p = _color_params(cfg, dyn_t)
        acc = torch.zeros((band_h, cfg.width, 3), dtype=torch.float32,
                          device=cfg.device)
        for off in offsets:
            f = _sample(cfg, dyn, band_h, full_h, row0, off,
                        track_trap=track_trap, track_stripe=track_stripe)
            if cfg.family == "mandelbrot":
                trap = f.get("trap", torch.full_like(f["zx"], 1e20))
                color = coloring.color_mandelbrot(f["n"], f["zx"], f["zy"],
                                                  trap, p)
            else:  # burning_ship: the only other family that can't fuse
                trap = f.get("trap", torch.full_like(f["zx"], 1e10))
                stripe = f.get("stripe", torch.zeros_like(f["zx"]))
                color = coloring.color_burning_ship(
                    f["n"], f["zx"], f["zy"], trap, stripe, p)
            acc = acc + color
        # julia.comp:319-322 clamp floors live inside post_chain_traced
        with span("batch.post"):
            return _into(out, _average_then_post(cfg, dyn_t, acc,
                                                 len(offsets)))

    return unfused


band_render_fn.param_uploads = 0


def _into(out, img: torch.Tensor) -> torch.Tensor:
    return img if out is None else out.copy_(img)


def band_renderer(scene: Scene, width: int, height: int, *, device="cuda",
                  orbit_cache=None):
    """The 2D families' ``models.band_renderer`` (``orbit_cache`` unused),
    through :func:`band_render_fn`."""
    fam, conv, clamp = family_map()[scene.fractal_type]
    cfg = scene_static_cfg(scene, width, height, fam, conv, clamp,
                           device=str(device))
    dyn = scene_dyn_params(scene)
    return lambda row0, rows: band_render_fn(cfg, rows, height)(dyn, row0)


def render_fn(cfg: StaticCfg):
    """render(dyn) -> f32 (H, W, 3) for one static configuration."""
    band = band_render_fn(cfg, cfg.height, cfg.height)
    return lambda dyn: band(dyn, 0)


def planar_render_fn(cfg: StaticCfg, quantize: int = 8):
    """render(dyn) -> quantized (3, H, W) uint8/uint16 planes; requires
    ``planar_export_ok(cfg)``."""
    band = band_render_fn(cfg, cfg.height, cfg.height,
                          planar_quantize=quantize)
    return lambda dyn: band(dyn, 0)


def batch_render_fn(cfg: StaticCfg, quantize: int = 0, planar: bool = False):
    """render(dyn_batch) for a batch of frames of one static configuration:
    a dict of (B,)-shaped dynamic parameters → f32 (B, H, W, 3) in [0, 1].

    ``quantize`` 8/16 returns the frames quantized to uint8/uint16 on the
    device (quantize_image's expression); with ``planar`` (which needs
    ``quantize`` and ``planar_export_ok(cfg)``) as (B, 3, H, W) planes, for
    the caller to interleave after the fetch.

    The frames render one after another on the current stream, each as the
    single-frame pipeline (one K1 launch per frame and AA sample, with its
    parameters by value, so a frame's launch needs no copy to the device)
    writing into its slot of one output tensor; a planar frame on the card
    is K1's quantized stores into its slot alone.  The parameters are f32
    first, as the JAX batch casts them, so a frame equals a single render
    of its scene bit for bit.  Each frame runs in the span
    ``batch.frame``, its glue's launches in ``batch.glue``, a multi-sample
    or unfused frame's average and post chain in ``batch.post``; the
    chunk's parameter columns and each frame's parameters are
    ``k1.prepare``."""
    if planar and not (quantize and planar_export_ok(cfg)):
        raise ValueError("planar batch export requires quantize=8|16 and "
                         "planar_export_ok(cfg)")
    band = band_render_fn(cfg, cfg.height, cfg.height,
                          planar_quantize=quantize if planar else 0)
    dtype = {0: torch.float32, 8: torch.uint8, 16: torch.uint16}[quantize]

    def fn(dyn_batch: dict) -> torch.Tensor:
        with span("k1.prepare"):
            cols = {k: np.asarray(v, np.float32).reshape(-1)
                    for k, v in dyn_batch.items()}
        b = len(next(iter(cols.values())))
        shape = ((b, 3, cfg.height, cfg.width) if planar
                 else (b, cfg.height, cfg.width, 3))
        out = torch.empty(shape, dtype=dtype, device=cfg.device)
        for i in range(b):
            with span("batch.frame"):
                with span("k1.prepare"):
                    dyn = {k: v[i] for k, v in cols.items()}
                    slot = out[i]
                if quantize and not planar:
                    img = band(dyn, 0)
                    with span("batch.glue"):
                        quantize_image(img, bit_depth=quantize, out=slot)
                else:
                    band(dyn, 0, out=slot)
        return out

    return fn


def render_scene(scene: Scene, width: int, height: int, family: str,
                 aa_convention: str, clamp_mins: bool, *, device="cuda",
                 quantize: int = 0) -> torch.Tensor:
    """Render ``scene`` on ``device``: f32 (H, W, 3) in [0, 1], or with
    ``quantize`` 8/16 the quantized (H, W, 3) image (quantized on the
    device: the fused single-sample planes directly, any other
    configuration's interleaved image)."""
    cfg = scene_static_cfg(scene, width, height, family, aa_convention,
                           clamp_mins, device=str(device))
    dyn = scene_dyn_params(scene)
    if quantize and planar_export_ok(cfg):
        return planar_render_fn(cfg, quantize)(dyn).permute(1, 2, 0)
    img = render_fn(cfg)(dyn)
    return quantize_image(img, bit_depth=quantize) if quantize else img
