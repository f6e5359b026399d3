"""Deep-zoom renderer: host HP reference orbit + the perturbation kernel K3
(the port's counterpart of ``fractalrenderer_tpu/models/deep_zoom.py``).

Pipeline (config #4 of BASELINE.md):
1. Compute the reference orbit at the scene center in arbitrary precision
   (deepzoom/orbit.py — native C++ fixed-point or Python bignum): z² + c
   from 0 (Mandelbrot), the Burning Ship and Phoenix recurrences (kind 1
   and 2), or for a deep Julia the drift D = Z − Z0 from the view center
   with the scene's shared c (floatexp-emitted in the ARBITRARY tier).
2. Run the perturbation kernel (ops/perturbation.py) with per-pixel
   rebasing (every family, the default): one reference orbit serves the
   whole image, glitch-free by construction.  ``exact_dust`` (Burning
   Ship) adds the kernel's error ledger on a ≥ 160-bit orbit.
   ``rebasing=False`` (Mandelbrot) runs the legacy pipeline instead: one
   pass with the Pauldelbrot glitch flag (f32 float continuation above
   1e-7), then secondary references centred on flagged pixels.
3. Lanes still flagged (rebase rounds exhausted, dust suspects, glitches
   no reference fixed) are iterated directly in HP on the host.
4. Color with the deep-zoom palette set (test_deep_zoom.comp:73-103) on
   the device; no enhance/ACES post chain.

Supersampling: scene.samples_per_pixel (1/2/4, fractal_state.h:91) renders
spp² subpixel samples per pixel, stacked into one K3 launch (power-of-two
spp, rebasing) and averaged in sample order.

``mesh``: a parallel.RenderMesh routes every kernel pass through the
gather-free row bands of parallel/tiled.py.
"""
from __future__ import annotations

import functools
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


# Suspect threshold of the exact-dust tier: a pixel whose error ledger
# (log2 absolute error, ops/perturbation track_err) exceeds 2^-8 joins the
# HP fallback — the JAX package's margin below the smallest count-flipping
# error it observed (errx >= 3.8 at the 1e-10/400 dust view).
_DUST_SUSPECT_LOG2 = -8.0


def _dd_of(value, fallback: float) -> Tuple[float, float]:
    if value is not None:
        return dd_from_string(str(value))
    return dd_from_string(repr(float(fallback)))


def _scene_coords(scene: Scene):
    cx = scene.hp_center_x if scene.hp_center_x is not None else scene.center_x
    cy = scene.hp_center_y if scene.hp_center_y is not None else scene.center_y
    zoom = scene.hp_zoom if scene.hp_zoom is not None else scene.zoom
    return cx, cy, zoom


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
    ``aa_spp``: render the spp² subpixel samples of each pixel in one
    stacked K3 launch; the planes are then (spp², band_h, width), sample s
    at offset ((s mod spp)/spp, (s div spp)/spp).
    ``row_band``: optional (row0, band_h) — render only ``band_h`` rows of
    the full ``height``-tall image starting at global row ``row0`` (the
    pixel mapping, series bound and HP fallback keep the full geometry).
    ``orbit_cache``: optional dict keyed by exact HP center values and the
    recurrence; reuses reference orbits across calls.
    ``mesh``: a parallel.RenderMesh with a 'rows' axis routes every kernel
    pass through the gather-free row bands (parallel/tiled.py) on the
    mesh's devices instead of ``device``; with ``keep_device`` the planes
    stay on the device where every band sits on one, else they are joined
    on the host.
    ``ref_center``: optional (cx, cy) decimal strings — compute/reuse the
    reference orbit at THIS point and render via the shift mechanism
    (c = ref + pixel-delta + (center - ref)).
    ``debug_rounds``: include the per-pixel rounds plane in
    ``info["rounds_plane"]`` (a tensor on ``device``).
    ``exact_dust`` (Burning Ship, rebasing): the kernel's error ledger
    flags lanes whose carried delta error could flip their count; they
    join the HP fallback (``info["dust_suspect_pixels"]``).
    ``rebasing=False`` (Mandelbrot): the legacy pipeline — Pauldelbrot
    flags (``glitch_tol``) and up to ``max_references`` secondary
    reference orbits, each centred on the deepest-running flagged pixel.
    Every option check raises before any orbit is computed."""
    aa_spp = int(aa_spp)
    julia = bool(getattr(scene, "deep_zoom_julia", False))
    ship = bool(getattr(scene, "deep_zoom_ship", False))
    phoenix = bool(getattr(scene, "deep_zoom_phoenix", False))
    if exact_dust:
        # the ledger runs in the Ship kernel's rebasing dd / floatexp
        # tiers; suspects re-render per pixel on the host
        if not (ship and rebasing):
            raise ValueError("exact_dust is the Burning Ship dust tier "
                             "(deep_zoom_ship scenes, rebasing pipeline)")
        if mesh is not None:
            raise ValueError("exact_dust does not compose with mesh "
                             "sharding yet (host fallback is per-pixel)")
    if aa_spp > 1 and not (rebasing and tuple(offset) == (0.0, 0.0)):
        raise ValueError("aa_spp needs the rebasing pipeline and the "
                         "default offset")
    if julia + ship + phoenix > 1:
        raise ValueError("pick ONE of deep_zoom_julia / _ship / _phoenix")
    if (julia or ship or phoenix) and not rebasing:
        family = "julia" if julia else ("ship" if ship else "phoenix")
        raise ValueError(f"deep-zoom {family} requires the rebasing "
                         "pipeline")
    band_kw = {}
    row_off = 0
    if row_band is not None:
        row_off, band_h = int(row_band[0]), int(row_band[1])
        band_kw = {"row0": float(row_off), "map_height": height}
    else:
        band_h = height
    if mesh is not None:
        from ..parallel.tiled import perturbation_fields_sharded

        field_fn = functools.partial(perturbation_fields_sharded, mesh=mesh,
                                     keep_device=keep_device)
    else:
        field_fn = functools.partial(perturbation_fields, device=device)
    cx, cy, zoom = _scene_coords(scene)
    zoom_fr = Fraction(str(zoom))
    zoom_f = float(zoom_fr)
    mode, bits = precision_mode_for_zoom_frac(zoom_fr)
    # Bucket the orbit precision UP to the next 64-bit step, so one orbit
    # serves ~19 digits of an interactive descent (never less accurate).
    bits = -(-bits // 64) * 64
    if exact_dust:
        # dust counts pin only over a high-precision orbit (96-bit deltas
        # over a 160-bit table): the table's own recurrence error amplifies
        # chaotically just like the delta's
        bits = max(bits + 96, 160)
    max_iter = scene.max_iterations

    center_x_dd = _dd_of(cx, 0.0)
    center_y_dd = _dd_of(cy, 0.0)
    zoom_dd = _dd_of(zoom, 0.0)

    # Deltas iterate in double-double past 1e-7 (f32's 2^-24 relative
    # error is below pixel scale above it) and in floatexp in ARBITRARY
    # mode (zoom < 1e-30).  The legacy pipeline continues starved lanes in
    # f32 above 1e-7, where f32 c still resolves the pixel; deeper, they
    # are flagged and re-referenced.
    scaled = mode.name == "ARBITRARY"
    dd_delta = (zoom_f <= 1e-7) and not scaled
    float_cont = zoom_f > 1e-7 and not rebasing
    if ship:
        # the armada dust flips f32-tier counts even at 1e-5 — always dd
        dd_delta = not scaled
    jc = (repr(float(scene.julia_c_real)), repr(float(scene.julia_c_imag)))

    # +1: the kernel's index-consistent escape test reads orbit[i+1], so a
    # full-strength (interior) reference needs max_iter+1 stored entries.
    def _ckey(v):
        # exact cache identity (HPFloat by mantissa, strings by value)
        return (v.man, v.bits) if isinstance(v, HPFloat) \
            else Fraction(str(v))

    def cached_orbit(ocx, ocy):
        # the orbit depends on the recurrence too: the key carries every
        # field of the JAX package's key, so the two caches key alike
        key = (_ckey(ocx), _ckey(ocy), bits, max_iter, julia,
               jc if julia else None, ship, phoenix,
               (float(scene.phoenix_p), float(scene.phoenix_r))
               if phoenix else None,
               scaled if julia else None)  # drift emission format
        if orbit_cache is not None and key in orbit_cache:
            return orbit_cache[key]
        if julia:
            # z0 = the view point, c = the shared Julia constant; the table
            # holds the drift D = Z - Z0, floatexp-emitted (mantissa,
            # exponent) in the ARBITRARY tier so no depth underflows it
            o = orbit_mod.compute_orbit(jc[0], jc[1], bits, max_iter + 1,
                                        force_python=force_python_orbit,
                                        z0x=ocx, z0y=ocy, emit_rel=True,
                                        emit_fx=scaled)
        else:
            o = orbit_mod.compute_orbit(
                ocx, ocy, bits, max_iter + 1,
                force_python=force_python_orbit,
                kind=1 if ship else (2 if phoenix else 0),
                pp=float(scene.phoenix_p), rr=float(scene.phoenix_r))
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
        orbit_center = (rcx_s, rcy_s)
    else:
        orbit = cached_orbit(cx, cy)
        orbit_center = (cx, cy)
    # emit_fx orbits come back as (mantissas, exponents); plain ones bare
    orbit, orbit_exp = orbit if isinstance(orbit, tuple) else (orbit, None)

    series = None
    if scene.use_series_approximation and max(scene.bailout, 2.0) >= 4.0 \
            and ref_center is None and not (julia or ship or phoenix):
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

    f = field_fn(
        orbit, width, band_h, center_x_dd=center_x_dd,
        center_y_dd=center_y_dd, zoom_dd=zoom_dd, max_iter=max_iter,
        bailout=scene.bailout, glitch_tol=glitch_tol, offset=offset,
        float_continuation=float_cont, series=series, dd_delta=dd_delta,
        scaled_delta=scaled, zoom_frac=str(zoom), rebase=rebasing,
        max_passes=max_passes, julia=julia, ship=ship, phoenix=phoenix,
        phoenix_p=float(scene.phoenix_p), phoenix_r=float(scene.phoenix_r),
        julia_z0=((float(Fraction(str(orbit_center[0]))),
                   float(Fraction(str(orbit_center[1])))) if julia else None),
        orbit_exp=orbit_exp, aa_spp=aa_spp, track_err=exact_dust,
        **band_kw, **shift_kw)
    # rebasing: lanes still wanting a round after max_passes (a
    # pathological short-orbit case); legacy: the Pauldelbrot and starved
    # flags
    flagged = f["want" if rebasing else "glitch"] > 0.5
    dust_suspect = 0
    if exact_dust:
        # precision-starved dust lanes join the HP-fallback set: the
        # per-pixel orbit below pins their counts exactly
        suspect = f["errx"] > _DUST_SUSPECT_LOG2
        dust_suspect = int(suspect.sum())
        flagged = flagged | suspect
    n_flagged = int(flagged.sum())
    info = {"precision_mode": mode.name, "precision_bits": bits,
            "dd_delta": dd_delta, "scaled_delta": scaled,
            "deep_zoom_julia": julia, "deep_zoom_ship": ship,
            "deep_zoom_phoenix": phoenix,
            "algorithm": "rebase" if rebasing else "secondary_refs",
            "rebase_passes": int(f["passes"]) if rebasing else 0,
            "reference_iterations": len(orbit), "references_used": 1,
            "series_skip": series.n_skip if series else 0,
            "dust_suspect_pixels": dust_suspect,
            "glitched_pixels_initial": n_flagged}
    if debug_rounds and rebasing:
        info["rounds_plane"] = f["rounds_plane"]
    if keep_device and rebasing and n_flagged == 0:
        # the render is complete: the field planes stay on the device for
        # the caller to colour there
        info.update(fallback_pixels=0, glitched_pixels_remaining=0,
                    fields_on_device=True)
        return (f["n"], f["zx"], f["zy"],
                np.zeros(tuple(f["n"].shape), bool), info)
    n = f["n"].cpu().numpy()
    zx = f["zx"].cpu().numpy()
    zy = f["zy"].cpu().numpy()
    glitch = flagged.cpu().numpy()

    cx_hp = HPFloat(str(cx), hp_bits)
    cy_hp = HPFloat(str(cy), hp_bits)
    # exact-rational pixel mapping, identical to the kernel's
    # dc = step * (p - size/2) with step = zoom*4/height^2, so secondary
    # references and the HP fallback sample the c the kernel does
    step_fr = Fraction(str(zoom)) * 4 / (height * height)

    def pixel_c(py, px, off=None):
        # py is band-local when row_band is set; the mapping is global
        off = offset if off is None else off
        dcx = step_fr * (Fraction(px + off[0]) - Fraction(width, 2))
        dcy = step_fr * (Fraction(py + row_off + off[1])
                         - Fraction(height, 2))
        return (cx_hp + HPFloat(dcx, hp_bits), cy_hp + HPFloat(dcy, hp_bits))

    # ---- secondary references for glitched pixels (legacy pipeline) ----
    refs = 1
    prev_glitched = None
    while not rebasing and glitch.any() and refs < max_references:
        remaining = int(glitch.sum())
        if prev_glitched is not None and remaining >= prev_glitched:
            break  # no progress: leave the rest to the HP fallback
        prev_glitched = remaining
        ys, xs = np.nonzero(glitch)
        # probe a spread of flagged pixels and adopt the one whose orbit
        # runs deepest — ideally an interior pixel, whose orbit resolves
        # every starved pixel at once
        best = None
        for k in np.linspace(0, len(ys) - 1, min(12, len(ys))).astype(int):
            cxy = pixel_c(int(ys[k]), int(xs[k]))
            o = cached_orbit(cxy[0], cxy[1])
            if best is None or len(o) > len(best[0]):
                best = (o, cxy)
            if len(o) >= max_iter + 1:
                break  # a non-escaping reference
        orbit2, (ref_cx, ref_cy) = best
        # the delta against the new reference needs shift = center - ref
        sx_str = (cx_hp - ref_cx).to_string(digs)
        sy_str = (cy_hp - ref_cy).to_string(digs)
        f2 = field_fn(
            orbit2, width, band_h,
            center_x_dd=dd_from_string(ref_cx.to_string(40)),
            center_y_dd=dd_from_string(ref_cy.to_string(40)),
            zoom_dd=zoom_dd, max_iter=max_iter, bailout=scene.bailout,
            glitch_tol=glitch_tol, ref_shift_x=dd_from_string(sx_str),
            ref_shift_y=dd_from_string(sy_str), offset=offset,
            float_continuation=float_cont, dd_delta=dd_delta,
            scaled_delta=scaled, zoom_frac=str(zoom),
            ref_shift_x_frac=sx_str, ref_shift_y_frac=sy_str, rebase=False,
            **band_kw)
        fix = glitch & ~(f2["glitch"] > 0.5).cpu().numpy()
        n[fix] = f2["n"].cpu().numpy()[fix]
        zx[fix] = f2["zx"].cpu().numpy()[fix]
        zy[fix] = f2["zy"].cpu().numpy()[fix]
        glitch = glitch & ~fix
        refs += 1

    # ---- guaranteed fallback: direct HP iteration of survivors ---------
    # Each flagged lane left gets its own exact orbit from the HP engine —
    # the pixel IS the reference, so by construction it cannot glitch.
    info["fallback_pixels"] = int(glitch.sum())
    if glitch.any():
        bail = max(2.0, float(scene.bailout))
        bail2 = bail * bail
        if n.ndim == 3:  # stacked AA: per-sample subpixel offsets
            lanes = [(int(s), int(y), int(x))
                     for s, y, x in np.argwhere(glitch)]
        else:
            lanes = [(None, int(y), int(x))
                     for y, x in zip(*np.nonzero(glitch))]
        for smp, y, x in lanes:
            off = offset if smp is None else \
                ((smp % aa_spp) / aa_spp, (smp // aa_spp) / aa_spp)
            pcx, pcy = pixel_c(y, x, off)
            if julia:
                o = orbit_mod.compute_orbit(
                    jc[0], jc[1], hp_bits, max_iter + 1,
                    escape_mag_sq=bail2, force_python=force_python_orbit,
                    z0x=pcx, z0y=pcy)
            else:
                o = orbit_mod.compute_orbit(
                    pcx, pcy, hp_bits, max_iter + 1, escape_mag_sq=bail2,
                    force_python=force_python_orbit,
                    kind=1 if ship else (2 if phoenix else 0),
                    pp=float(scene.phoenix_p), rr=float(scene.phoenix_r))
            zfx, zfy = float(o[-1, 0]), float(o[-1, 1])
            escaped = zfx * zfx + zfy * zfy > bail2
            # kernel count convention: n = #{i >= 1 : |z_i| <= bail} — the
            # first escaped index k gives n = k - 1; interior reports the
            # limit
            at = (y, x) if smp is None else (smp, y, x)
            n[at] = (len(o) - 2) if escaped else max_iter
            zx[at] = zfx
            zy[at] = zfy
        glitch = np.zeros_like(glitch)
    info["references_used"] = refs
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


def _average(acc: torch.Tensor, nsamp: int) -> torch.Tensor:
    # divide by an f32 tensor: the same IEEE quotient on every device
    return acc / torch.tensor(float(nsamp), dtype=torch.float32,
                              device=acc.device)


def color_avg_device(n, zx, zy, p: ColorParams, nsamp: int) -> torch.Tensor:
    """Colour the ``nsamp`` stacked AA sample planes (nsamp, H, W) on their
    device and return their average: f32 adds in sample order, then one
    division by f32(nsamp), the expression of the JAX package's device and
    host averages (so either gives the same bits)."""
    acc = color_fields_device(n[0], zx[0], zy[0], p)
    for s in range(1, int(nsamp)):
        acc = acc + color_fields_device(n[s], zx[s], zy[s], p)
    return _average(acc, nsamp)


def color_stacked_samples(n, zx, zy, p: ColorParams, nsamp: int,
                          device="cuda") -> torch.Tensor:
    """Average the coloured samples of a stacked (nsamp, H, W) field render
    on ``device``.  Planes from the HP fallback (numpy) are moved there
    first and coloured with the same expression and sample order, so the
    average does not depend on where the planes came from."""
    dev = torch.device(device)
    n, zx, zy = (torch.as_tensor(a).to(dev) for a in (n, zx, zy))
    return color_avg_device(n, zx, zy, p, nsamp)


class SampleAccumulator:
    """Colour policy of a sequential AA sample loop (render() with a
    non-power-of-two spp): each sample's planes are coloured on ``device``
    (numpy planes from an HP fallback are moved there first) and added to
    the f32 accumulator in sample order; ``average`` divides once by
    f32(nsamp), as color_avg_device does."""

    def __init__(self, p: ColorParams, device="cuda"):
        self._p = p
        self._dev = torch.device(device)
        self._acc = None

    def add(self, n, zx, zy):
        n, zx, zy = (torch.as_tensor(a).to(self._dev) for a in (n, zx, zy))
        c = color_fields_device(n, zx, zy, self._p)
        self._acc = c if self._acc is None else self._acc + c

    def average(self, nsamp: int) -> torch.Tensor:
        """The f32 mean plane."""
        return _average(self._acc, nsamp)


def render(scene: Scene, width: int, height: int,
           return_info: bool = False, orbit_cache: dict = None,
           quantize: int = 0, device="cuda", **kw):
    """Render a deep-zoom scene on ``device``: f32 (H, W, 3) in [0, 1], or
    with ``quantize`` 8/16 the image quantized on the device with the PNG
    writer's exact expression.  A power-of-two ``samples_per_pixel`` spp
    renders the spp² samples in one stacked K3 launch (``info`` then has
    ``aa_samples`` and ``aa_batched``); another spp renders them one launch
    each at offsets (sx/spp, sy/spp).  Fields from the HP fallback (host
    arrays) are colored on the device too, with the same expression."""
    from .common import quantize_image

    p = ColorParams(
        max_iterations=scene.max_iterations, bailout=scene.bailout,
        palette_mode=scene.palette_mode, color_offset=scene.color_offset,
        color_scale=scene.color_scale)
    spp = max(int(scene.samples_per_pixel), 1)
    cache = orbit_cache if orbit_cache is not None else {}
    stacked = spp > 1 and (spp & (spp - 1)) == 0 \
        and kw.get("rebasing", True)
    if stacked:
        n, zx, zy, _, info = render_fields(scene, width, height,
                                           orbit_cache=cache, aa_spp=spp,
                                           keep_device=True, device=device,
                                           **kw)
        img = color_stacked_samples(n, zx, zy, p, spp * spp, device)
        info = dict(info, aa_samples=spp * spp, aa_batched=True)
    else:
        accu = SampleAccumulator(p, device)
        infos = []
        for sy in range(spp):
            for sx in range(spp):
                off = (sx / spp, sy / spp) if spp > 1 else (0.0, 0.0)
                n, zx, zy, _, i = render_fields(scene, width, height,
                                                offset=off,
                                                orbit_cache=cache,
                                                keep_device=True,
                                                device=device, **kw)
                accu.add(n, zx, zy)
                infos.append(i)
        img = accu.average(spp * spp)
        info = infos[0]
    if quantize in (8, 16):
        img = quantize_image(img, bit_depth=quantize)
    if return_info:
        return img, info
    return img
