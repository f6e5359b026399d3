"""The port's deep-zoom model (``models/deep_zoom.py``: render_fields,
color_fields_device, render) and its colouring against the JAX package, on
the CPU (the plain K3).  Twins of the rebasing Mandelbrot tests of
tests/test_deepzoom.py, and the JAX ``deep_zoom.render`` held to colours
within 1e-5 where the counts agree and to < 5% of pixels differing (the
pattern of test_render_dd_close_to_jax_render_dd).  The weights of this
model are the reference orbit and the parameters, carried across by the
packing tests of test_torch_perturbation.py.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

import fractalrenderer_tpu as fr
from fractalrenderer_tpu.models import deep_zoom as jax_dz
from fractalrenderer_tpu.ops import coloring as jax_coloring
from fractalrenderer_tpu_torch import FractalType, Scene
from fractalrenderer_tpu_torch import render as frt_render
from fractalrenderer_tpu_torch.models import deep_zoom
from fractalrenderer_tpu_torch.ops.coloring import ColorParams

SEAHORSE = ("-0.74364388703715158", "0.13182590420531198")
BENIGN = ("0.245670923653024", "0.580340963154017")


def _scene(center, zoom, iters, **kw):
    return Scene(fractal_type=FractalType.DEEP_ZOOM, hp_center_x=center[0],
                 hp_center_y=center[1], hp_zoom=zoom, max_iterations=iters,
                 use_perturbation=True, **kw)


def _jax_scene(scene):
    return fr.Scene.from_dict(scene.to_dict())


def test_deep_zoom_model_uses_rebasing_by_default():
    s = _scene(BENIGN, "1e-9", 400)
    n, zx, zy, glitch, info = deep_zoom.render_fields(s, 32, 24,
                                                      device="cpu")
    assert info["algorithm"] == "rebase"
    assert info["references_used"] == 1
    assert info["glitched_pixels_remaining"] == 0
    assert info["fallback_pixels"] == 0  # no HP fallback needed
    assert not glitch.any()
    assert isinstance(n, np.ndarray) and n.shape == (24, 32)


@pytest.mark.parametrize("center,zoom,iters,tier", [
    (SEAHORSE, "1e-6", 600, "f32"),
    (SEAHORSE, "1e-12", 600, "dd"),
    (("0", "1"), "1e-50", 400, "fx"),
], ids=["f32", "dd", "fx"])
def test_render_fields_matches_jax(center, zoom, iters, tier):
    s = _scene(center, zoom, iters)
    n, zx, zy, glitch, info = deep_zoom.render_fields(s, 16, 12,
                                                      device="cpu")
    jn, jzx, jzy, jglitch, jinfo = jax_dz.render_fields(_jax_scene(s), 16,
                                                        12)
    for k in ("precision_mode", "precision_bits", "dd_delta",
              "scaled_delta", "algorithm", "rebase_passes",
              "reference_iterations", "references_used", "series_skip",
              "glitched_pixels_initial", "fallback_pixels",
              "glitched_pixels_remaining"):
        assert info[k] == jinfo[k], k
    assert (info["dd_delta"], info["scaled_delta"]) == \
        (tier == "dd", tier == "fx")
    same = n == np.asarray(jn)
    assert same.mean() >= 0.98 and np.abs(n - np.asarray(jn)).max() <= 1
    np.testing.assert_allclose(zx[same], np.asarray(jzx)[same],
                               rtol=1e-3 if tier == "f32" else 1e-6)


@pytest.mark.parametrize("zoom", ["1e-306", "1e-318", "1e-326", "3e-325"])
def test_render_fields_past_the_f64_floor_matches_jax(zoom):
    # the floor cell's frames (c = i jittered, a shared reference off the
    # scene centre): the zoom subnormal or 0 as a double, 1152- and
    # 1216-bit orbits, the shift at ~380 digits, against the JAX package
    from test_torch_deep_fx import MI, W, H, _view

    ref, ctr = _view(zoom, W, H)
    s = _scene(ctr, zoom, MI, use_series_approximation=False)
    n, zx, zy, glitch, info = deep_zoom.render_fields(s, W, H, device="cpu",
                                                      ref_center=ref)
    jn, jzx, jzy, jglitch, jinfo = jax_dz.render_fields(_jax_scene(s), W, H,
                                                        ref_center=ref)
    for k in ("precision_mode", "precision_bits", "dd_delta",
              "scaled_delta", "algorithm", "rebase_passes",
              "reference_iterations", "references_used", "series_skip",
              "glitched_pixels_initial", "fallback_pixels",
              "glitched_pixels_remaining"):
        assert info[k] == jinfo[k], k
    assert info["scaled_delta"] and info["precision_bits"] >= 1152
    assert len(np.unique(n)) > 10  # the frame has structure
    np.testing.assert_array_equal(n, np.asarray(jn))
    np.testing.assert_array_equal(glitch, np.asarray(jglitch))
    np.testing.assert_allclose(zx, np.asarray(jzx), rtol=1e-6)
    np.testing.assert_allclose(zy, np.asarray(jzy), rtol=1e-6)


def _fx_view():
    # the floor cell's geometry: one reference off c = i and a scene centre
    # a few pixels from it, both at the deepest frame's scale
    from test_torch_deep_fx import _view

    return _view("1e-326", 12, 8)


def _dd_view(dx=0):
    # a reference 2 and -1 pixels of the 1e-10 view off the centre; the
    # centre panned by ``dx`` pixels
    step = Fraction("1e-10") * 4 / 64
    ctr = tuple(Fraction(v) for v in SEAHORSE)
    ref = (ctr[0] + 2 * step, ctr[1] - step)
    return tuple(map(str, ref)), (str(ctr[0] + dx * step), str(ctr[1]))


_JULIA = dict(deep_zoom_julia=True, julia_c_real=-0.7, julia_c_imag=0.27015)


def _sequence(case):
    """The case's frames as (scene, ref_center) and, for the run with one
    shared cache, the plan's builds, its orbits and the values they keep."""
    if case == "fx_fixed_centre":
        # 1e-306 and 2e-307 in one bits bucket, 1e-318 to 1e-326 in the
        # next: two orbits, each building its reference, shift and streams
        ref, ctr = _fx_view()
        frames = [(_scene(ctr, z, 1000, use_series_approximation=False), ref)
                  for z in ("1e-306", "2e-307", "1e-318", "5e-319",
                            "1e-326")]
        return frames, 6, 2, 6
    if case == "dd_fixed_centre":
        ref, ctr = _dd_view()
        return [(_scene(ctr, z, 400), ref)
                for z in ("1e-9", "5e-10", "2e-10", "1e-10")], 3, 1, 3
    if case == "moving_centre":
        # the shift slot is rebuilt at every move (back to the first centre
        # too: one slot), the reference and the streams are kept
        frames = []
        for dx in (0, 1, 2, 0):
            ref, ctr = _dd_view(dx)
            frames.append((_scene(ctr, "1e-10", 400), ref))
        return frames, 2 + 4, 1, 3
    if case == "bits_bucket":
        # 1e-20 takes a bucket of its own, so an orbit, reference, shift
        # and streams of its own; 1e-9 comes back to the first
        ref, ctr = _dd_view()
        return [(_scene(ctr, z, 400), ref)
                for z in ("1e-9", "1e-20", "5e-10")], 6, 2, 6
    # families sharing the dict: an orbit per recurrence, each keeping its
    # reference and streams (no ref_center: no shift)
    kinds = [{}, dict(deep_zoom_ship=True), _JULIA]
    return [(_scene(SEAHORSE, z, 300, **k), None)
            for z in ("1e-9", "5e-10") for k in kinds], 6, 3, 6


@pytest.mark.parametrize("case", ["fx_fixed_centre", "dd_fixed_centre",
                                  "moving_centre", "bits_bucket",
                                  "families"])
def test_a_shared_cache_renders_every_frame_bit_equal(case):
    # frames against one orbit_cache keep the reference's values, the shift
    # and K3's streams across frames; each frame equals a render with a
    # cache of its own, bit for bit, info included
    frames, builds, orbits, kept = _sequence(case)
    fresh = [deep_zoom.render_fields(s, 12, 8, ref_center=ref,
                                     orbit_cache={}, device="cpu")
             for s, ref in frames]
    cache = {}
    b0, h0 = (deep_zoom.render_fields.plan_builds,
              deep_zoom.render_fields.plan_hits)
    shared = [deep_zoom.render_fields(s, 12, 8, ref_center=ref,
                                      orbit_cache=cache, device="cpu")
              for s, ref in frames]
    lookups = sum(2 + (ref is not None) for _, ref in frames)
    assert deep_zoom.render_fields.plan_builds - b0 == builds
    assert deep_zoom.render_fields.plan_hits - h0 == lookups - builds
    # no entry per zoom or per centre: an orbit each, one slot per value
    assert len(cache) == orbits
    assert sum(len(e._kept) for e in cache.values()) == kept
    for a, b in zip(shared, fresh):
        for x, y in zip(a[:4], b[:4]):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()
        assert a[4] == b[4]
    infos = [f[4] for f in shared]
    if case == "fx_fixed_centre":
        assert all(i["scaled_delta"] for i in infos)
        assert len({i["precision_bits"] for i in infos}) == 2
    elif case == "families":
        assert len({i["deep_zoom_julia"] + 2 * i["deep_zoom_ship"]
                    for i in infos}) == 3
    else:
        assert all(i["dd_delta"] for i in infos)


def test_a_cache_for_one_call_behaves_as_none():
    # a fresh cache, or none, builds every value the frame uses once
    ref, ctr = _dd_view()
    s = _scene(ctr, "1e-10", 300)
    b0, h0 = (deep_zoom.render_fields.plan_builds,
              deep_zoom.render_fields.plan_hits)
    a = deep_zoom.render_fields(s, 12, 8, ref_center=ref, device="cpu")
    b = deep_zoom.render_fields(s, 12, 8, ref_center=ref, orbit_cache={},
                                device="cpu")
    assert deep_zoom.render_fields.plan_builds - b0 == 6
    assert deep_zoom.render_fields.plan_hits == h0
    for x, y in zip(a[:4], b[:4]):
        assert x.tobytes() == y.tobytes()


def test_series_skip_with_rebasing():
    # the first round starts at the series-skip index; later rounds at 0
    base = _scene(SEAHORSE, "1e-9", 2500)
    n0, *_, i0 = deep_zoom.render_fields(base, 48, 32, device="cpu")
    n1, *_, i1 = deep_zoom.render_fields(
        base.with_(use_series_approximation=True), 48, 32, device="cpu")
    assert i1["algorithm"] == "rebase" and i1["series_skip"] > 10
    assert i1["glitched_pixels_remaining"] == 0
    mism = float((n0 != n1).mean())
    assert mism < 0.05, f"series+rebase changed {mism:.3%} of counts"
    jinfo = jax_dz.render_fields(
        _jax_scene(base.with_(use_series_approximation=True)), 48, 32)[-1]
    assert i1["series_skip"] == jinfo["series_skip"]


def test_rebase_max_passes_fallback():
    # an exhausted pass budget routes the leftover want lanes through the
    # guaranteed HP fallback: zero flagged pixels, the full render's counts
    s = _scene(BENIGN, "1e-9", 400)
    n, zx, zy, glitch, info = deep_zoom.render_fields(s, 16, 12,
                                                      max_passes=1,
                                                      device="cpu")
    assert info["fallback_pixels"] > 0
    assert info["glitched_pixels_remaining"] == 0
    n_full, *_, info2 = deep_zoom.render_fields(s, 16, 12, device="cpu")
    assert info2["fallback_pixels"] == 0
    np.testing.assert_array_equal(n, n_full)


def test_ref_center_shift_exact():
    # a render against a reference orbit at a nearby off-center point
    # (c = ref + delta + (center - ref)) is bit-identical to the standalone
    # render, as the JAX package's zoom paths rely on
    cx, cy = "-0.743643887037151", "0.13182590420533"
    s = _scene((cx, cy), "1e-9", 400)
    n0, *_ = deep_zoom.render_fields(s, 16, 12, device="cpu")
    rc = (repr(float(cx) + 2e-9), repr(float(cy) - 1e-9))
    n1, *_ = deep_zoom.render_fields(s, 16, 12, ref_center=rc, device="cpu")
    np.testing.assert_array_equal(n0, n1)
    jn1, *_ = jax_dz.render_fields(_jax_scene(s), 16, 12, ref_center=rc)
    np.testing.assert_array_equal(n1, np.asarray(jn1))


def test_row_band_equals_frame_rows():
    s = _scene(SEAHORSE, "1e-12", 600)
    full = deep_zoom.render_fields(s, 16, 12, device="cpu")
    band = deep_zoom.render_fields(s, 16, 12, row_band=(4, 5), device="cpu")
    for a, b in zip(band[:3], full[:3]):
        np.testing.assert_array_equal(a, b[4:9])


def test_keep_device_and_orbit_cache():
    s = _scene(SEAHORSE, "1e-12", 600)
    cache = {}
    n, zx, zy, glitch, info = deep_zoom.render_fields(
        s, 16, 12, keep_device=True, orbit_cache=cache, debug_rounds=True,
        device="cpu")
    assert isinstance(n, torch.Tensor) and info["fields_on_device"]
    assert not glitch.any() and glitch.shape == (12, 16)
    assert float(info["rounds_plane"].max()) == info["rebase_passes"]
    assert len(cache) == 1
    calls = []
    orig = deep_zoom.orbit_mod.compute_orbit
    deep_zoom.orbit_mod.compute_orbit = lambda *a, **k: calls.append(1) \
        or orig(*a, **k)
    try:
        n2, *_ = deep_zoom.render_fields(s, 16, 12, orbit_cache=cache,
                                         device="cpu")
    finally:
        deep_zoom.orbit_mod.compute_orbit = orig
    assert not calls  # the cached orbit served
    np.testing.assert_array_equal(n.numpy(), n2)


def test_deep_zoom_beyond_f64_exponent_range():
    # zoom 1e-500 underflows float64; precision selection works from the
    # exact Fraction and the floatexp + rebase path matches the exact HP
    # oracle
    from test_torch_perturbation import _hp_oracle_counts

    zoom, W, H, MI = "1e-500", 8, 6, 2000
    s = _scene(("0", "1"), zoom, MI)
    n, zx, zy, g, info = deep_zoom.render_fields(s, W, H, device="cpu")
    assert info["precision_mode"] == "ARBITRARY"
    assert 1000 < info["precision_bits"] < 4096
    assert info["glitched_pixels_remaining"] == 0
    nref = _hp_oracle_counts("0", "1", zoom, W, H, MI, info["precision_bits"])
    assert len(np.unique(nref)) > 3
    assert (n == nref).mean() >= 0.9


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 7])
def test_color_deep_zoom_matches_jax(mode):
    # CPU libm and XLA round log/sqrt differently by an ulp, which moves
    # `smooth` by up to an ulp of n; with n <= 120 that stays under 1e-5
    # through the steepest palette (hue: 0.05 * 6 * scale per unit)
    rng = np.random.default_rng(mode)
    n = rng.integers(0, 121, (20, 30)).astype(np.int32)
    n[:3] = 120  # interior rows
    # escaped pixels have |z| > bailout (2): a radius in [2, 60)
    r = rng.uniform(2.0, 60.0, (20, 30))
    a = rng.uniform(-np.pi, np.pi, (20, 30))
    zx = (r * np.cos(a)).astype(np.float32)
    zy = (r * np.sin(a)).astype(np.float32)
    p = ColorParams(max_iterations=120.0, bailout=4.0, palette_mode=mode,
                    color_offset=0.3, color_scale=1.7)
    mine = deep_zoom.color_fields_device(torch.from_numpy(n),
                                         torch.from_numpy(zx),
                                         torch.from_numpy(zy), p)
    ref = jax_dz.color_fields_device(n, zx, zy, jax_coloring.ColorParams(
        max_iterations=120, bailout=4.0, palette_mode=mode,
        color_offset=0.3, color_scale=1.7))
    assert mine.shape == (20, 30, 3) and mine.dtype == torch.float32
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    assert (mine[:3] == 0).all()


@pytest.mark.parametrize("quantize", [0, 8, 16])
def test_render_close_to_jax_render(quantize):
    # 24x16 at 1e-9 x600 through models.render (the dispatch the CLI uses)
    s = _scene(SEAHORSE, "1e-9", 600, palette_mode=1)
    img, info = deep_zoom.render(s, 24, 16, return_info=True,
                                 quantize=quantize, device="cpu")
    ref, jinfo = jax_dz.render(_jax_scene(s), 24, 16, return_info=True,
                               quantize=quantize)
    ref = np.asarray(ref)
    assert info["rebase_passes"] == jinfo["rebase_passes"]
    via_models = frt_render(s, 24, 16, device="cpu", quantize=quantize)
    assert torch.equal(via_models, img)
    n, *_ = deep_zoom.render_fields(s, 24, 16, device="cpu")
    jn, *_ = jax_dz.render_fields(_jax_scene(s), 24, 16)
    same = n == np.asarray(jn)
    assert (~same).mean() < 0.05
    img = img.numpy()
    assert img.dtype == ref.dtype and img.shape == ref.shape == (16, 24, 3)
    if quantize:
        lsb = np.abs(img.astype(np.int64) - ref.astype(np.int64))[same]
        assert lsb.max() <= 1
    else:
        np.testing.assert_allclose(img[same], ref[same], rtol=0, atol=1e-5)


def test_unported_options_raise_before_any_orbit():
    calls = []
    orig = deep_zoom.orbit_mod.compute_orbit
    deep_zoom.orbit_mod.compute_orbit = lambda *a, **k: calls.append(1)
    try:
        for kw, extra, exc, match in [
                # the families, spp, exact dust, the legacy pipeline and
                # mesh sharding render (test_torch_pert_families.py,
                # test_torch_deepzoom_aa.py, test_torch_exact_dust.py,
                # test_torch_pert_single.py, test_torch_parallel_deep.py);
                # these are the JAX model's own guards
                (dict(deep_zoom_ship=True),
                 dict(exact_dust=True, mesh=object()), ValueError,
                 "does not compose with mesh"),
                (dict(deep_zoom_phoenix=True), dict(rebasing=False),
                 ValueError, "phoenix requires the rebasing"),
                (dict(samples_per_pixel=4), dict(exact_dust=True),
                 ValueError, "Burning Ship dust tier"),
                ({}, dict(exact_dust=True), ValueError,
                 "Burning Ship dust tier"),
                (dict(deep_zoom_ship=True),
                 dict(exact_dust=True, rebasing=False), ValueError,
                 "Burning Ship dust tier")]:
            with pytest.raises(exc, match=match):
                deep_zoom.render(_scene(SEAHORSE, "1e-9", 100, **kw), 8, 8,
                                 device="cpu", **extra)
    finally:
        deep_zoom.orbit_mod.compute_orbit = orig
    assert not calls


def test_render_takes_a_mesh():
    # mesh=: every kernel pass over the grid's row bands (3 CPU devices,
    # 12 rows in bands of 4), one reference orbit; the same image
    from fractalrenderer_tpu_torch.parallel import make_render_mesh

    s = _scene(SEAHORSE, "1e-9", 300)
    mesh = make_render_mesh(devices=[torch.device("cpu")] * 3)
    img, info = deep_zoom.render(s, 16, 12, device="cpu", mesh=mesh,
                                 return_info=True, quantize=16)
    assert info["references_used"] == 1 and info["fields_on_device"]
    assert torch.equal(img, deep_zoom.render(s, 16, 12, device="cpu",
                                             quantize=16))
