"""The single-pass non-rebasing form of K3 and the legacy deep-zoom pipeline
of the port (``perturbation_fields(rebase=False)`` in
``fractalrenderer_tpu_torch/ops/perturbation.py`` and
``models/deep_zoom.render_fields(rebasing=False)``: the Pauldelbrot flag,
starved lanes, f32 float continuation and secondary references) against
the JAX package, f64 iteration and the exact HP oracle, on the CPU.

- The operands are bit-equal to the JAX ``perturbation_fields(rebase=False,
  _build_only=True)`` operands in each tier, with and without float
  continuation and against a secondary reference's shift; the JAX |Z|²
  table the kernel does not ship is bit-equal to the square of the f32
  streams, which the kernel computes instead.
- The plain single pass matches the JAX kernel run in interpret mode: the
  dd and floatexp tiers' counts and glitch flags are equal.  XLA:CPU
  contracts multiply-adds, which moves f32-tier lanes near the boundary,
  so the f32 tier holds ≥ 99% of counts within 1 (measured on this
  repository's CPU runs: 100% at these views) and equal glitch flags.
- The JAX kernel's shared orbit index moves in chunks of 16, so a lane
  alive at the orbit's end continues at n0 + 16·⌈(end − n0)/16⌉; the port
  follows it (test_continuation_resumes_on_the_chunk_grid).
- The JAX package's twin tests hold at their own bounds.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

import fractalrenderer_tpu as fr
from fractalrenderer_tpu.deepzoom import orbit as jax_orbit
from fractalrenderer_tpu.deepzoom.hp import HPFloat
from fractalrenderer_tpu.models import deep_zoom as jax_dz
from fractalrenderer_tpu.ops import perturbation as jax_pert
from fractalrenderer_tpu_torch import FractalType, Scene
from fractalrenderer_tpu_torch.models import deep_zoom
from fractalrenderer_tpu_torch.ops import perturbation
from fractalrenderer_tpu_torch.ops.dd import dd_from_string

SEAHORSE = ("-0.743643887037151", "0.13182590420533")
C_I = ("0", "1")
# a reference that escapes after 43 iterations: its lanes starve
ESCAPING = ("0.245670923653024", "0.580340963154017")
# references escaping after 94 and 447 iterations
ESCAPING_94 = ("-0.7436", "0.1318")
ESCAPING_447 = ("-0.77568377", "0.13646737")

# case: (center, zoom, iterations, orbit bits, options, W, H)
CASES = {
    "f32-cont": (SEAHORSE, "1e-5", 300, 64,
                 dict(float_continuation=True), 24, 16),
    "f32-cont-escaping": (ESCAPING, "1e-3", 600, 64,
                          dict(float_continuation=True), 24, 16),
    "f32-escaping": (ESCAPING_94, "1e-3", 600, 64, {}, 24, 16),
    "dd-escaping": (ESCAPING_447, "1e-10", 2500, 128, dict(dd_delta=True),
                    24, 16),
    "fx": (C_I, "1e-50", 400, 300, dict(scaled_delta=True,
                                        zoom_frac="1e-50"), 16, 12),
}


@pytest.fixture(scope="module")
def orbits():
    """Reference orbits by (center, bits, entries), computed once."""
    cache = {}

    def get(center, bits, entries):
        key = (center, bits, entries)
        if key not in cache:
            cache[key] = jax_orbit.compute_orbit(*center, bits, entries)
        return cache[key]

    return get


def _kw(center, zoom, iters, opts):
    kw = dict(center_x_dd=dd_from_string(center[0]),
              center_y_dd=dd_from_string(center[1]), max_iter=iters,
              rebase=False, float_continuation=False)
    kw.update(opts)
    if "zoom_frac" not in opts:
        kw["zoom_dd"] = dd_from_string(zoom)
    return kw


# ---------------------------------------------------------------------------
# packing: bit-equal to the JAX operands
# ---------------------------------------------------------------------------

SHIFTS = {
    "dd": dict(ref_shift_x=dd_from_string("2e-12"),
               ref_shift_y=dd_from_string("-1e-12")),
    "fx": dict(ref_shift_x_frac="2e-52", ref_shift_y_frac="-1e-52"),
}


@pytest.mark.parametrize("shift", [False, True], ids=["own", "shifted"])
@pytest.mark.parametrize("case", ["f32-cont", "f32-escaping", "dd-escaping",
                                  "fx"])
def test_single_pass_operands_bit_equal_to_jax(orbits, case, shift):
    center, zoom, iters, bits, opts, W, H = CASES[case]
    orb = orbits(center, bits, iters + 1)
    kw = _kw(center, zoom, iters, opts)
    if shift:
        kw.update(SHIFTS["fx" if case == "fx" else "dd"])
    ops, call_kw = jax_pert.perturbation_fields(orb, W, H, _build_only=True,
                                                **kw)
    params, streams, launch = perturbation.pack_pert_operands(orb, W, H,
                                                              **kw)
    tier = case.split("-")[0]
    assert (launch["tier"], launch["form"]) == (tier, "single")
    assert launch["float_cont"] == call_kw["float_continuation"]
    assert "max_passes" not in call_kw  # the single-pass call
    np.testing.assert_array_equal(params.view(np.int32),
                                  np.asarray(ops[0])[0].view(np.int32))
    for mine, k in zip(streams, (1, 2, 4, 5)):
        np.testing.assert_array_equal(mine.view(np.int32),
                                      np.asarray(ops[k]).view(np.int32))
    # the Pauldelbrot table: the square of the f32 streams, as the kernel
    # computes it from streams 0 and 1
    mag2 = streams[0] * streams[0] + streams[1] * streams[1]
    np.testing.assert_array_equal(mag2.view(np.int32),
                                  np.asarray(ops[3]).view(np.int32))


def test_single_pass_guards_match_jax(orbits):
    orb = orbits(SEAHORSE, 64, 401)
    kw = _kw(SEAHORSE, "1e-6", 400, {})
    for extra, match in [
            (dict(dd_delta=True, float_continuation=True), "f32 tier"),
            (dict(scaled_delta=True, zoom_frac="1e-6",
                  float_continuation=True), "f32 tier"),
            (dict(julia=True, julia_z0=(0.0, 0.0)), "rebasing pipeline"),
            (dict(ship=True), "rebasing pipeline"),
            (dict(aa_spp=2), "requires the rebasing"),
            (dict(dd_delta=True, ship=True, track_err=True), "rebasing"),
            (dict(rebase=True, float_continuation=True), "supersedes")]:
        with pytest.raises(ValueError, match=match):
            perturbation.perturbation_fields(orb, 8, 6, device="cpu",
                                             **dict(kw, **extra))


# ---------------------------------------------------------------------------
# the plain single pass against the JAX kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_single_pass_matches_jax_interpret(orbits, case):
    center, zoom, iters, bits, opts, W, H = CASES[case]
    orb = orbits(center, bits, iters + 1)
    kw = _kw(center, zoom, iters, opts)
    mine = perturbation.perturbation_fields(orb, W, H, device="cpu", **kw)
    assert set(mine) == {"n", "zx", "zy", "glitch"}
    mine = {k: v.numpy() for k, v in mine.items()}
    ref = {k: np.asarray(v)
           for k, v in jax_pert.perturbation_fields(orb, W, H, **kw).items()}
    n, nref = mine["n"], ref["n"]
    assert n.dtype == np.int32 and n.shape == nref.shape == (H, W)
    assert len(np.unique(nref)) > 10
    np.testing.assert_array_equal(mine["glitch"], ref["glitch"])
    if case.startswith("f32"):
        assert (np.abs(n - nref) <= 1).mean() >= 0.99
    else:
        np.testing.assert_array_equal(n, nref)
    if "escaping" in case and "cont" not in case:
        assert (mine["glitch"] > 0.5).any()  # starved lanes are flagged


def test_continuation_resumes_on_the_chunk_grid(orbits, monkeypatch):
    # The reference escapes at index 43: the lanes alive there (the orbit
    # ends at pert_end = 43, n0 = 1) continue at 1 + 16·⌈42/16⌉ = 49 in the
    # JAX kernel, not at 43, so they get 6 steps fewer before the limit: a
    # lane that escapes within 6 steps of the budget reports the limit.  A
    # thread that continued at the orbit's end would count those lanes.
    center, zoom, _, bits, opts, W, H = CASES["f32-cont-escaping"]
    iters = 52
    orb = orbits(center, bits, iters + 1)
    assert len(orb) - 1 == 43 and (43 - 1) % perturbation.CHUNK
    kw = _kw(center, zoom, iters, opts)
    ref = np.asarray(jax_pert.perturbation_fields(orb, W, H, **kw)["n"])
    n = perturbation.perturbation_fields(orb, W, H, device="cpu",
                                         **kw)["n"].numpy()
    np.testing.assert_array_equal(n, ref)
    assert ((ref > 43) & (ref < iters)).sum() >= 10  # lanes continued
    monkeypatch.setattr(perturbation, "CHUNK", 1)
    n_end = perturbation.perturbation_fields(orb, W, H, device="cpu",
                                             **kw)["n"].numpy()
    moved = n_end != ref
    assert moved.any() and (ref[moved] == iters).all()
    assert (n_end[moved] >= iters - 6).all()


def _f64_counts(cx, cy, zoom, W, H, max_iter, bail2):
    """Direct f64 iteration of the JAX tests' pixel grid: the counts and the
    lanes still alive after ``max_iter`` steps."""
    py, px = np.mgrid[0:H, 0:W].astype(np.float64)
    ps = float(zoom) * 4 / H
    cr = float(cx) + (px / W - 0.5) * (W / H) * ps
    ci = float(cy) + (py / H - 0.5) * ps
    zr, zi = np.zeros_like(cr), np.zeros_like(ci)
    n = np.zeros(cr.shape, np.int64)
    alive = np.ones(cr.shape, bool)
    for _ in range(max_iter):
        x = zr * zr - zi * zi + cr
        y = 2 * zr * zi + ci
        zr = np.where(alive, x, zr)
        zi = np.where(alive, y, zi)
        esc = alive & (zr * zr + zi * zi > bail2)
        n = np.where(alive & ~esc, n + 1, n)
        alive &= ~esc
    return n, alive


@pytest.mark.parametrize("center,zoom,iters", [
    (SEAHORSE, "1e-4", 500), (ESCAPING_94, "1e-2", 300),
    (ESCAPING, "1e-2", 600)], ids=["seahorse", "escaping-94", "escaping-43"])
def test_f32_single_pass_as_close_to_f64_as_jax(orbits, center, zoom, iters):
    # where contraction moves chaotic f32 lanes, the port and the JAX kernel
    # stand as close to direct f64 iteration as each other
    W, H = 24, 16
    orb = orbits(center, 64, iters + 1)
    kw = _kw(center, zoom, iters, dict(float_continuation=True))
    n = perturbation.perturbation_fields(orb, W, H, device="cpu",
                                         **kw)["n"].numpy()
    nref = np.asarray(jax_pert.perturbation_fields(orb, W, H, **kw)["n"])
    n64, alive = _f64_counts(*center, zoom, W, H, iters, 16.0)
    n64 = np.where(alive, iters, n64)
    mine, theirs = (n != n64).mean(), (nref != n64).mean()
    assert mine <= theirs + 0.02 and mine < 0.15, (mine, theirs)


def _pert(cx, cy, zoom, max_iter, W=48, H=32, **kw):
    orb = jax_orbit.compute_orbit(cx, cy, 64, max_iter)
    return perturbation.perturbation_fields(
        orb, W, H, center_x_dd=dd_from_string(cx),
        center_y_dd=dd_from_string(cy), zoom_dd=dd_from_string(zoom),
        max_iter=max_iter, device="cpu", **kw), orb


def test_perturbation_moderate_zoom_vs_f64():
    cx, cy, zoom = SEAHORSE[0], SEAHORSE[1], "1e-5"
    W, H, MI = 48, 32, 600
    f, orb = _pert(cx, cy, zoom, MI, W, H)
    n = f["n"].numpy()
    nref, _ = _f64_counts(cx, cy, zoom, W, H, MI, 16.0)
    # f32 deltas flip chaotic boundary pixels; structure must agree
    assert (n != nref).mean() < 0.15
    assert abs((n == MI).mean() - (nref == MI).mean()) < 0.05


def test_perturbation_starved_pixels_flagged():
    # pixels outliving an escaping reference are flagged, not iterated on
    f, orb = _pert(*ESCAPING, "1e-9", 400, float_continuation=False)
    assert len(orb) < 400
    g, n = f["glitch"].numpy(), f["n"].numpy()
    long_lived = n >= len(orb) - 1
    assert long_lived.any() and (g[long_lived] > 0.5).all()


def _dz_scene(center, zoom, iters, **kw):
    return Scene(fractal_type=FractalType.DEEP_ZOOM, hp_center_x=center[0],
                 hp_center_y=center[1], hp_zoom=zoom, max_iterations=iters,
                 use_perturbation=True, **kw)


def test_series_skip_preserves_counts():
    base = _dz_scene(("-0.74364388703715158", "0.13182590420531198"),
                     "1e-9", 2500)
    n0, *_, i0 = deep_zoom.render_fields(base, 48, 32, rebasing=False,
                                         device="cpu")
    n1, *_, i1 = deep_zoom.render_fields(
        base.with_(use_series_approximation=True), 48, 32, rebasing=False,
        device="cpu")
    assert i1["series_skip"] > 10 and i0["series_skip"] == 0
    assert i0["glitched_pixels_remaining"] == i1["glitched_pixels_remaining"]
    assert (n0 != n1).mean() < 0.15
    assert abs((n0 == 2500).mean() - (n1 == 2500).mean()) < 0.02


def test_deep_zoom_zero_glitch_guarantee():
    # secondary references off (max_references=1): every starved survivor
    # goes through the HP fallback, ending at exactly 0 flagged pixels
    s = _dz_scene(ESCAPING, "1e-9", 400)
    n, zx, zy, glitch, info = deep_zoom.render_fields(
        s, 32, 24, max_references=1, rebasing=False, device="cpu")
    assert info["fallback_pixels"] > 0
    assert info["glitched_pixels_remaining"] == 0 and not glitch.any()
    assert info["algorithm"] == "secondary_refs"
    assert info["references_used"] == 1 and info["rebase_passes"] == 0


def test_deep_zoom_fallback_matches_f64_oracle():
    cx, cy, zoom = ESCAPING[0], ESCAPING[1], "1e-8"
    W, H, MI = 24, 16, 60
    s = _dz_scene(ESCAPING, zoom, MI)
    orb = jax_orbit.compute_orbit(cx, cy, 64, MI + 1)
    assert len(orb) < MI
    n, zx, zy, glitch, info = deep_zoom.render_fields(
        s, W, H, max_references=1, rebasing=False, device="cpu")
    assert info["fallback_pixels"] > 0 and not glitch.any()
    nref, alive = _f64_counts(cx, cy, zoom, W, H, MI,
                              max(2.0, s.bailout) ** 2)
    nref = np.where(alive, MI, nref)
    starved = nref >= len(orb) - 2
    assert starved.any()
    np.testing.assert_array_equal(n[starved], nref[starved])


def _hp_oracle_counts(cx, cy, zoom, W, H, MI, bits, bail=4.0):
    step = Fraction(zoom) * 4 / (H * H)
    cx_hp, cy_hp = HPFloat(cx, bits), HPFloat(cy, bits)
    n = np.zeros((H, W), np.int64)
    for py in range(H):
        for px in range(W):
            pcx = cx_hp + HPFloat(step * (Fraction(px) - Fraction(W, 2)),
                                  bits)
            pcy = cy_hp + HPFloat(step * (Fraction(py) - Fraction(H, 2)),
                                  bits)
            o = jax_orbit.compute_orbit(pcx, pcy, bits, MI + 1,
                                        escape_mag_sq=bail * bail)
            zfx, zfy = o[-1]
            n[py, px] = (len(o) - 2) if zfx * zfx + zfy * zfy > bail * bail \
                else MI
    return n


def test_scaled_delta_matches_hp_oracle():
    # the twin of test_scaled_delta_matches_hp_oracle[1e-50]: the
    # Misiurewicz point c = i, an interior reference, one pass
    W, H, MI, bits, zoom = 12, 8, 400, 300, "1e-50"
    orb = jax_orbit.compute_orbit(*C_I, bits, MI + 1)
    assert len(orb) == MI + 1
    f = perturbation.perturbation_fields(
        orb, W, H, center_x_dd=(0.0, 0.0), center_y_dd=(1.0, 0.0),
        max_iter=MI, scaled_delta=True, zoom_frac=zoom,
        float_continuation=False, device="cpu")
    n = f["n"].numpy()
    assert not (f["glitch"] > 0.5).any()
    nref = _hp_oracle_counts(*C_I, zoom, W, H, MI, bits)
    assert len(np.unique(nref)) > 3
    assert (n == nref).mean() >= 0.9 and np.abs(n - nref).max() <= 1


def test_deep_zoom_model_uses_rebasing_by_default():
    s = _dz_scene(ESCAPING, "1e-9", 400)
    n, zx, zy, glitch, info = deep_zoom.render_fields(s, 32, 24,
                                                      device="cpu")
    assert info["algorithm"] == "rebase" and info["references_used"] == 1
    assert info["glitched_pixels_remaining"] == 0
    assert info["fallback_pixels"] == 0 and not glitch.any()
    # and the legacy pipeline agrees on this benign view
    n2, *_rest, info2 = deep_zoom.render_fields(s, 32, 24, rebasing=False,
                                                device="cpu")
    assert info2["algorithm"] == "secondary_refs"
    assert (n == n2).mean() > 0.97


# ---------------------------------------------------------------------------
# the legacy pipeline through the model against the JAX model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zoom,iters", [("1e-9", 400), ("1e-6", 600)],
                         ids=["dd-secondary-refs", "f32-continuation"])
def test_legacy_render_fields_matches_jax(zoom, iters):
    s = _dz_scene(ESCAPING, zoom, iters)
    js = fr.Scene.from_dict(s.to_dict())
    n, zx, zy, glitch, info = deep_zoom.render_fields(s, 24, 16,
                                                      rebasing=False,
                                                      device="cpu")
    jn, _, _, jglitch, jinfo = jax_dz.render_fields(js, 24, 16,
                                                    rebasing=False)
    for k in ("precision_mode", "precision_bits", "dd_delta", "algorithm",
              "rebase_passes", "reference_iterations", "references_used",
              "glitched_pixels_initial", "fallback_pixels",
              "glitched_pixels_remaining"):
        assert info[k] == jinfo[k], k
    assert not glitch.any() and isinstance(n, np.ndarray)
    assert (n == np.asarray(jn)).mean() >= 0.99
    if zoom == "1e-9":
        assert info["references_used"] > 1  # secondary references ran


def test_legacy_render_samples_match_jax():
    # render() runs the legacy pipeline one sample at a time (spp 2: four
    # launches at the subpixel offsets, averaged in sample order)
    s = _dz_scene(ESCAPING, "1e-9", 300, samples_per_pixel=2, palette_mode=2)
    img, info = deep_zoom.render(s, 16, 12, rebasing=False, quantize=8,
                                 return_info=True, device="cpu")
    ref = np.asarray(jax_dz.render(fr.Scene.from_dict(s.to_dict()), 16, 12,
                                   rebasing=False, quantize=8))
    assert info["algorithm"] == "secondary_refs"
    assert img.shape == ref.shape == (12, 16, 3)
    lsb = np.abs(img.numpy().astype(np.int64) - ref.astype(np.int64))
    assert (lsb <= 1).mean() >= 0.99


def test_secondary_reference_orbits_cached_by_exact_value():
    # at 1e-30 the probed candidates differ beyond 24 digits; the orbit
    # cache keys them by exact value, so every probe gets its own orbit
    cache = {}
    s = _dz_scene(ESCAPING, "1e-30", 300)
    n, *_, info = deep_zoom.render_fields(s, 16, 12, rebasing=False,
                                          orbit_cache=cache, device="cpu")
    assert info["references_used"] > 1
    assert info["glitched_pixels_remaining"] == 0
    centers = [(k[0], k[1]) for k in cache]
    assert len(set(centers)) == len(cache) > 2
    assert all(isinstance(k[0], tuple) for k in centers[1:])
