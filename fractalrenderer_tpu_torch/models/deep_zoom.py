"""Deep-zoom renderer: host HP reference orbit + the perturbation kernel K3
(the port's counterpart of ``fractalrenderer_tpu/models/deep_zoom.py``).

Pipeline (config #4 of BASELINE.md), the rebasing Mandelbrot path:
1. Compute the reference orbit at the scene center in arbitrary precision
   (deepzoom/orbit.py — native C++ fixed-point or Python bignum).
2. Run the perturbation kernel (ops/perturbation.py) with per-pixel
   rebasing: one reference orbit serves the whole image, glitch-free by
   construction; lanes still wanting a rebase after ``max_passes`` rounds
   are iterated directly in HP on the host.
3. Color with the deep-zoom palette set (test_deep_zoom.comp:73-103) on
   the device; no enhance/ACES post chain.

The other families, ``rebasing=False``, ``exact_dust``, supersampling
(``samples_per_pixel`` > 1) and mesh sharding raise NotImplementedError
naming their ROADMAP item.
"""
from __future__ import annotations

import math
from fractions import Fraction
from typing import Tuple

import numpy as np
import torch

from ..deepzoom import orbit as orbit_mod
from ..deepzoom.hp import HPFloat, precision_mode_for_zoom_frac
from ..ops import coloring
from ..ops.coloring import ColorParams
from ..ops.dd import dd_from_string
from ..ops.perturbation import perturbation_fields
from ..scene import Scene


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} not ported yet (ROADMAP Queue 1 item {item})")


def _dd_of(value, fallback: float) -> Tuple[float, float]:
    if value is not None:
        return dd_from_string(str(value))
    return dd_from_string(repr(float(fallback)))


def _scene_coords(scene: Scene):
    cx = scene.hp_center_x if scene.hp_center_x is not None else scene.center_x
    cy = scene.hp_center_y if scene.hp_center_y is not None else scene.center_y
    zoom = scene.hp_zoom if scene.hp_zoom is not None else scene.zoom
    return cx, cy, zoom


def _check_ported(scene: Scene, rebasing: bool = True, exact_dust: bool = False,
                 aa_spp: int = 1, mesh=None) -> None:
    """Raise NotImplementedError for a deep-zoom option K3 does not run
    yet, before any orbit is computed."""
    if (getattr(scene, "deep_zoom_julia", False)
            or getattr(scene, "deep_zoom_ship", False)
            or getattr(scene, "deep_zoom_phoenix", False)):
        raise _unported("the Julia, Burning Ship and Phoenix deep-zoom "
                        "families are", "6(d)")
    if int(aa_spp) > 1 or max(int(scene.samples_per_pixel), 1) > 1:
        raise _unported("deep-zoom supersampling (spp > 1) is", "6(e)")
    if exact_dust:
        raise _unported("the exact-dust tier is", "6(f)")
    if not rebasing:
        raise _unported("the non-rebasing deep-zoom pipeline is", "6(g)")
    if mesh is not None:
        raise _unported("mesh sharding is", "8")


def render_fields(scene: Scene, width: int, height: int,
                  max_references: int = 16, glitch_tol: float = 1e-6,
                  offset: Tuple[float, float] = (0.0, 0.0),
                  force_python_orbit: bool = False,
                  orbit_cache: dict = None, mesh=None,
                  ref_center: Tuple[str, str] = None,
                  rebasing: bool = True, max_passes: int = 256,
                  aa_spp: int = 1,
                  row_band: Tuple[int, int] = None,
                  keep_device: bool = False,
                  exact_dust: bool = False,
                  debug_rounds: bool = False, device="cuda"):
    """Returns (n, zx, zy, glitch_remaining, info dict), with the JAX
    signature plus ``device``.

    ``keep_device``: when no lane needs the host HP fallback (the normal
    case), return ``n/zx/zy`` as tensors on ``device`` (``glitch_remaining``
    is then an all-False host array); otherwise, and without it, they come
    back as host numpy arrays.
    ``row_band``: optional (row0, band_h) — render only ``band_h`` rows of
    the full ``height``-tall image starting at global row ``row0`` (the
    pixel mapping, series bound and HP fallback keep the full geometry).
    ``orbit_cache``: optional dict keyed by exact HP center values; reuses
    reference orbits across calls.
    ``ref_center``: optional (cx, cy) decimal strings — compute/reuse the
    reference orbit at THIS point and render via the shift mechanism
    (c = ref + pixel-delta + (center - ref)).
    ``debug_rounds``: include the per-pixel rounds plane in
    ``info["rounds_plane"]`` (a tensor on ``device``).
    ``max_references`` and ``glitch_tol`` belong to the non-rebasing
    pipeline and are accepted for the signature only."""
    _check_ported(scene, rebasing, exact_dust, aa_spp, mesh)
    band_kw = {}
    row_off = 0
    if row_band is not None:
        row_off, band_h = int(row_band[0]), int(row_band[1])
        band_kw = {"row0": float(row_off), "map_height": height}
    else:
        band_h = height
    cx, cy, zoom = _scene_coords(scene)
    zoom_fr = Fraction(str(zoom))
    zoom_f = float(zoom_fr)
    mode, bits = precision_mode_for_zoom_frac(zoom_fr)
    # Bucket the orbit precision UP to the next 64-bit step, so one orbit
    # serves ~19 digits of an interactive descent (never less accurate).
    bits = -(-bits // 64) * 64
    max_iter = scene.max_iterations

    center_x_dd = _dd_of(cx, 0.0)
    center_y_dd = _dd_of(cy, 0.0)
    zoom_dd = _dd_of(zoom, 0.0)

    # Deltas iterate in double-double past 1e-7 (f32's 2^-24 relative
    # error is below pixel scale above it) and in floatexp in ARBITRARY
    # mode (zoom < 1e-30).
    scaled = mode.name == "ARBITRARY"
    dd_delta = (zoom_f <= 1e-7) and not scaled

    # +1: the kernel's index-consistent escape test reads orbit[i+1], so a
    # full-strength (interior) reference needs max_iter+1 stored entries.
    def _ckey(v):
        # exact cache identity (HPFloat by mantissa, strings by value)
        return (v.man, v.bits) if isinstance(v, HPFloat) \
            else Fraction(str(v))

    def cached_orbit(ocx, ocy):
        # the key carries every field of the JAX package's key (family
        # flags False here), so the two caches key alike
        key = (_ckey(ocx), _ckey(ocy), bits, max_iter, False, None, False,
               False, None, None)
        if orbit_cache is not None and key in orbit_cache:
            return orbit_cache[key]
        o = orbit_mod.compute_orbit(ocx, ocy, bits, max_iter + 1,
                                    force_python=force_python_orbit)
        if orbit_cache is not None:
            orbit_cache[key] = o
        return o

    hp_bits = max(bits, 128)
    digs = max(40, int(hp_bits * 0.302) + 12)
    shift_kw = {}
    if ref_center is not None:
        # One shared orbit at ref_center; the pixel deltas pick up
        # shift = (scene center - ref), exactly like a secondary reference.
        rcx_s, rcy_s = ref_center
        orbit = cached_orbit(rcx_s, rcy_s)
        center_x_dd = dd_from_string(rcx_s)
        center_y_dd = dd_from_string(rcy_s)
        sx_s = (HPFloat(str(cx), hp_bits)
                - HPFloat(rcx_s, hp_bits)).to_string(digs)
        sy_s = (HPFloat(str(cy), hp_bits)
                - HPFloat(rcy_s, hp_bits)).to_string(digs)
        shift_kw = dict(ref_shift_x=dd_from_string(sx_s),
                        ref_shift_y=dd_from_string(sy_s),
                        ref_shift_x_frac=sx_s, ref_shift_y_frac=sy_s)
    else:
        orbit = cached_orbit(cx, cy)

    series = None
    if scene.use_series_approximation and max(scene.bailout, 2.0) >= 4.0 \
            and ref_center is None:
        aspect = width / height
        # +1/height: subpixel AA offsets push |dc| up to one pixel past the
        # geometric corner; the series exactness bound must cover them
        corner = math.hypot(0.5 * aspect + 1.0 / height, 0.5 + 1.0 / height)
        if scaled:
            # zoom may underflow f64 here — dc_max stays exact-rational and
            # the coefficients accumulate in floatexp
            from ..deepzoom.series import compute_series_skip_fx

            dc_max_fr = zoom_fr * 4 * Fraction(corner) / height
            series = compute_series_skip_fx(orbit, dc_max_fr)
        else:
            from ..deepzoom.series import compute_series_skip

            dc_max = zoom_f * 4.0 / height * corner
            series = compute_series_skip(orbit, dc_max)

    f = perturbation_fields(
        orbit, width, band_h, center_x_dd=center_x_dd,
        center_y_dd=center_y_dd, zoom_dd=zoom_dd, max_iter=max_iter,
        bailout=scene.bailout, glitch_tol=glitch_tol, offset=offset,
        float_continuation=False, series=series, dd_delta=dd_delta,
        scaled_delta=scaled, zoom_frac=str(zoom), rebase=True,
        max_passes=max_passes, device=device, **band_kw, **shift_kw)
    want = f["want"] > 0.5
    n_want = int(want.sum())
    info = {"precision_mode": mode.name, "precision_bits": bits,
            "dd_delta": dd_delta, "scaled_delta": scaled,
            "deep_zoom_julia": False, "deep_zoom_ship": False,
            "deep_zoom_phoenix": False, "algorithm": "rebase",
            "rebase_passes": int(f["passes"]),
            "reference_iterations": len(orbit), "references_used": 1,
            "series_skip": series.n_skip if series else 0,
            "dust_suspect_pixels": 0, "glitched_pixels_initial": n_want}
    if debug_rounds:
        info["rounds_plane"] = f["rounds_plane"]
    if keep_device and n_want == 0:
        # the render is complete: the field planes stay on the device for
        # the caller to colour there
        info.update(fallback_pixels=0, glitched_pixels_remaining=0,
                    fields_on_device=True)
        return (f["n"], f["zx"], f["zy"],
                np.zeros((band_h, width), bool), info)
    n = f["n"].cpu().numpy()
    zx = f["zx"].cpu().numpy()
    zy = f["zy"].cpu().numpy()
    glitch = want.cpu().numpy()

    # ---- guaranteed fallback: direct HP iteration of survivors ---------
    # Lanes still wanting a rebase after max_passes rounds (a pathological
    # short-orbit case) each get their own exact orbit from the HP engine —
    # the pixel IS the reference, so by construction it cannot glitch.
    info["fallback_pixels"] = n_want
    if glitch.any():
        cx_hp = HPFloat(str(cx), hp_bits)
        cy_hp = HPFloat(str(cy), hp_bits)
        # exact-rational pixel mapping, identical to the kernel's
        # dc = step * (p - size/2) with step = zoom*4/height^2
        step_fr = Fraction(str(zoom)) * 4 / (height * height)
        bail = max(2.0, float(scene.bailout))
        bail2 = bail * bail
        for y, x in zip(*np.nonzero(glitch)):
            y, x = int(y), int(x)
            # y is band-local when row_band is set; the mapping is global
            dcx = step_fr * (Fraction(x + offset[0]) - Fraction(width, 2))
            dcy = step_fr * (Fraction(y + row_off + offset[1])
                             - Fraction(height, 2))
            o = orbit_mod.compute_orbit(
                cx_hp + HPFloat(dcx, hp_bits), cy_hp + HPFloat(dcy, hp_bits),
                hp_bits, max_iter + 1, escape_mag_sq=bail2,
                force_python=force_python_orbit)
            zfx, zfy = float(o[-1, 0]), float(o[-1, 1])
            escaped = zfx * zfx + zfy * zfy > bail2
            # kernel count convention: n = #{i >= 1 : |z_i| <= bail} — the
            # first escaped index k gives n = k - 1; interior reports the
            # limit
            n[y, x] = (len(o) - 2) if escaped else max_iter
            zx[y, x] = zfx
            zy[y, x] = zfy
        glitch = np.zeros_like(glitch)
    info["glitched_pixels_remaining"] = int(glitch.sum())
    return n, zx, zy, glitch, info


def color_fields_device(n, zx, zy, p: ColorParams) -> torch.Tensor:
    """Colour deep-zoom field planes on their device (the
    ops.coloring.color_deep_zoom expression) and return an (H, W, 3) f32
    tensor.  Offset, scale and max_iter enter as f32 tensors, as the JAX
    package traces them; palette_mode is static."""
    dev = zx.device
    vals = torch.tensor([float(p.max_iterations), float(p.color_offset),
                         float(p.color_scale)], dtype=torch.float32,
                        device=dev)
    q = ColorParams(max_iterations=vals[0], bailout=4.0,
                    palette_mode=int(p.palette_mode), color_offset=vals[1],
                    color_scale=vals[2])
    return coloring.color_deep_zoom(n, zx, zy, q)


def render(scene: Scene, width: int, height: int,
           return_info: bool = False, orbit_cache: dict = None,
           quantize: int = 0, device="cuda", **kw):
    """Render a deep-zoom scene on ``device``: f32 (H, W, 3) in [0, 1], or
    with ``quantize`` 8/16 the image quantized on the device with the PNG
    writer's exact expression.  Fields from the HP fallback (host arrays)
    are colored on the device too, with the same expression."""
    from .common import quantize_image

    p = ColorParams(
        max_iterations=scene.max_iterations, bailout=scene.bailout,
        palette_mode=scene.palette_mode, color_offset=scene.color_offset,
        color_scale=scene.color_scale)
    n, zx, zy, _, info = render_fields(scene, width, height,
                                       orbit_cache=orbit_cache,
                                       keep_device=True, device=device, **kw)
    dev = torch.device(device)
    n, zx, zy = (torch.as_tensor(a).to(dev) for a in (n, zx, zy))
    img = color_fields_device(n, zx, zy, p)
    if quantize in (8, 16):
        img = quantize_image(img, bit_depth=quantize)
    if return_info:
        return img, info
    return img
