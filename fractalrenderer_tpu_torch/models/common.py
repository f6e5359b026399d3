"""Shared render pipeline for the 2D escape-time families (the port's
counterpart of ``fractalrenderer_tpu/models/common.py``).

Ported so far: the Mandelbrot family with one AA sample and no trap,
stripe or trap-glow consumers — exactly the configurations the fused
kernel path serves (escape kernel with the interior skip, colour and post
chain in the kernel epilogue, quantization as tensor glue).  Everything
else raises NotImplementedError naming its ROADMAP item.

PyTorch runs eagerly, so there is no compiled-function cache: ``render_fn``
builds the per-configuration closure directly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..ops import mapping
from ..ops.escape import escape_fields
from ..scene import FractalType, Scene


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
    clamp_mins: bool          # julia/bs/phoenix clamp brightness/sat/contrast
    aa_convention: str        # 'centered' (mandelbrot) or 'uv'
    device: str = "cuda"


# fractal type → (kernel family, AA convention, post-chain clamp) for the
# four 2D escape-time families (mandelbulb/deep-zoom have their own models).
def family_map():
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


def _interior_skip_ok(cfg: StaticCfg) -> bool:
    """The analytic interior skip is exact for n but zeroes the interior z,
    so it is only safe when nothing reads interior z.  Also the Mandelbrot
    fused-colouring eligibility condition."""
    return (cfg.family == "mandelbrot"
            and not cfg.stripe_enabled
            and not cfg.orbit_trap_enabled
            and cfg.interior_style != 2)


def _fused_ok(cfg: StaticCfg) -> bool:
    """The in-kernel fused-colouring eligibility predicate.  Of the JAX
    package's fused families only Mandelbrot is ported."""
    return _interior_skip_ok(cfg)


def planar_export_ok(cfg: StaticCfg) -> bool:
    """True when the config can export as quantized planar planes
    (3, H, W): the fused kernel emits the post-chained planes of the single
    AA sample, so quantization consumes them directly."""
    return _fused_ok(cfg) and cfg.aa == 1


def unsupported_reason(cfg: StaticCfg) -> Optional[str]:
    """Why the port cannot render ``cfg`` yet, or None."""
    if cfg.family != "mandelbrot":
        return (f"the {cfg.family} family is not ported yet (ROADMAP "
                "Queue 1 item 2)")
    if cfg.aa != 1:
        return (f"antialiasing {cfg.aa} (> 1) is not ported yet (ROADMAP "
                "Queue 1 item 2)")
    if cfg.orbit_trap_enabled or cfg.stripe_enabled \
            or cfg.interior_style not in (0, 1):
        return ("orbit traps, stripes and interior styles other than 0 and "
                "1 are not ported yet (ROADMAP Queue 1 item 2)")
    return None


def band_render_fn(cfg: StaticCfg, band_h: int, full_h: int,
                   planar_quantize: int = 0):
    """Build fn(dyn, row0) rendering ``band_h`` local rows whose global
    first row is ``row0``: the fused branch (one AA sample, colour and post
    chain in the kernel).  Returns f32 (band_h, W, 3), or with
    ``planar_quantize`` 8/16 the quantized (3, band_h, W) planes."""
    reason = unsupported_reason(cfg)
    if reason is not None:
        raise NotImplementedError(reason)
    if cfg.aa_convention == "centered":
        (off,) = mapping.aa_offsets_centered(cfg.aa)
    else:
        (off,) = mapping.aa_offsets_uv(cfg.aa, cfg.width)

    def fn(dyn, row0: int):
        f = escape_fields(
            cfg.family, cfg.width, band_h,
            center_x=dyn["center_x"], center_y=dyn["center_y"],
            zoom=dyn["zoom"], max_iter=cfg.max_iter,
            bailout=dyn["bailout"], offset=off,
            iter_limit=dyn["iter_limit"], row0=row0, map_height=full_h,
            interior_skip=_interior_skip_ok(cfg),
            fused_color=(cfg.palette_mode, cfg.interior_style,
                         cfg.clamp_mins, True),
            color_offset=dyn["color_offset"],
            color_scale=dyn["color_scale"],
            brightness=dyn["brightness"], saturation=dyn["saturation"],
            contrast=dyn["contrast"], device=cfg.device)
        if planar_quantize:
            planes = torch.stack([f["r"], f["g"], f["b"]], dim=0)
            return quantize_image(planes, bit_depth=planar_quantize)
        return torch.stack([f["r"], f["g"], f["b"]], dim=-1)

    return fn


def quantize_image(img: torch.Tensor, *, bit_depth: int) -> torch.Tensor:
    """Clip/scale/round an f32 [0,1] image to uint8/uint16 on its device —
    the exact utils.png._prepare_rows expression, so a device-quantized
    frame produces byte-identical PNGs."""
    img = torch.clamp(img, 0.0, 1.0)
    if bit_depth == 8:
        return (img * 255.0 + 0.5).to(torch.uint8)
    return (img * 65535.0 + 0.5).to(torch.uint16)


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


def render_scene(scene: Scene, width: int, height: int, family: str,
                 aa_convention: str, clamp_mins: bool, *, device="cuda",
                 quantize: int = 0) -> torch.Tensor:
    """Render ``scene`` on ``device``: f32 (H, W, 3) in [0, 1], or with
    ``quantize`` 8/16 the quantized (H, W, 3) image (planes quantized on
    the device, then interleaved)."""
    cfg = scene_static_cfg(scene, width, height, family, aa_convention,
                           clamp_mins, device=str(device))
    dyn = scene_dyn_params(scene)
    if quantize:
        return planar_render_fn(cfg, quantize)(dyn).permute(1, 2, 0)
    return render_fn(cfg)(dyn)
