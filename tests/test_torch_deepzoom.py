"""The port's deep-zoom model (``models/deep_zoom.py``: render_fields,
color_fields_device, render) and its colouring against the JAX package, on
the CPU (the plain K3).  Twins of the rebasing Mandelbrot tests of
tests/test_deepzoom.py, and the JAX ``deep_zoom.render`` held to colours
within 1e-5 where the counts agree and to < 5% of pixels differing (the
pattern of test_render_dd_close_to_jax_render_dd).  The weights of this
model are the reference orbit and the parameters, carried across by the
packing tests of test_torch_perturbation.py.
"""
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
