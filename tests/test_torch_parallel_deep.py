"""The port's row bands and giant stills (``parallel/``) for the deep zoom
(K3) and the Mandelbulb (K4a/K4b): twins of tests/test_parallel.py on a
CPU grid of 8, ``make_render_mesh(devices=[cpu] * 8)``.

Every sharded or banded result is bit-equal to the port's whole-frame
render: the deep zoom's tiers (f32, dd, floatexp), its families and stacked
spp² over one reference orbit, and the bulb, whose cone prepass blocks are
aligned to the image, not to the band.  One CPU-only exception, measured in
test_mandelbulb_cpu_glue_on_ragged_bands: PyTorch's CPU log, pow and
atan2 run whole vector blocks of a tensor through a vectorized routine and
its tail through a scalar one, which differ by an ulp; the bulb's shading
glue uses them, so a band whose element count is not a multiple of the
block can land a few pixels a few ulps off on the CPU (its K4a/K4b planes
stay bit-equal), the 2D colour's case in test_torch_parallel.py.  On the card every element takes the same routine, and
tests/test_torch_cuda.py holds those bands bit-equal.  The bulb tests
below at the JAX tests' sizes have whole blocks in every band.  Against the JAX package on the
same scene, the pattern of test_torch_deepzoom.py: counts equal on >= 98%
of pixels and within 1 elsewhere, and colours within 1 LSB (16 bit) where
the counts agree; the bulb's PNG within 1 LSB but on under 1% of pixels
(the JAX march on the CPU is not bit-exact: its own sharded test allows
1e-4, test_parallel.py:267-284).
"""
import numpy as np
import pytest
import torch

import fractalrenderer_tpu as fr
from fractalrenderer_tpu.deepzoom import orbit as jax_om
from fractalrenderer_tpu.models import deep_zoom as jax_dz
from fractalrenderer_tpu.models import mandelbulb as jax_mb
from fractalrenderer_tpu.parallel import mesh as jax_mesh
from fractalrenderer_tpu.parallel import tiled as jax_tiled
from fractalrenderer_tpu.utils.png import read_png as jax_read_png
from fractalrenderer_tpu_torch import FractalType, Scene
from fractalrenderer_tpu_torch.deepzoom import orbit as om
from fractalrenderer_tpu_torch.models import common, deep_zoom, mandelbulb
from fractalrenderer_tpu_torch.ops.dd import dd_from_string
from fractalrenderer_tpu_torch.ops.perturbation import perturbation_fields
from fractalrenderer_tpu_torch.parallel import (make_render_mesh,
                                                render_giant_still)
from fractalrenderer_tpu_torch.parallel.tiled import \
    perturbation_fields_sharded
from fractalrenderer_tpu_torch.utils.image import downsample2x
from fractalrenderer_tpu_torch.utils.png import read_png

CPU = torch.device("cpu")
CX, CY = "-0.743643887037151", "0.13182590420533"


def _mesh(n=8):
    return make_render_mesh(devices=[CPU] * n)


def _jax_scene(scene):
    return fr.Scene.from_dict(scene.to_dict())


def _dz(zoom="1e-8", iters=300, **kw):
    return Scene(fractal_type=FractalType.DEEP_ZOOM, use_perturbation=True,
                 hp_center_x=CX, hp_center_y=CY, hp_zoom=zoom,
                 max_iterations=iters, **kw)


def _png_pixels(img, bit_depth):
    return common.quantize_image(img, bit_depth=bit_depth).numpy()[::-1]


def _counts_near_jax(n, jn):
    """The deep zoom's count contract against the JAX package on the CPU
    (test_torch_deepzoom.py): equal on >= 98% of pixels, within 1
    elsewhere; returns where they are equal."""
    n, jn = np.asarray(n), np.asarray(jn)
    same = n == jn
    assert same.mean() >= 0.98 and np.abs(n - jn).max() <= 1
    return same


def test_deep_zoom_sharded_matches_single():
    # the single pass (rebase=False) of the legacy pipeline, bands of 6
    orb = om.compute_orbit(CX, CY, 64, 401)
    kw = dict(center_x_dd=dd_from_string(CX), center_y_dd=dd_from_string(CY),
              zoom_dd=dd_from_string("1e-8"), max_iter=400,
              float_continuation=False)
    single = perturbation_fields(orb, 64, 48, device="cpu", **kw)
    sharded = perturbation_fields_sharded(orb, 64, 48, mesh=_mesh(), **kw)
    assert set(sharded) == set(single)
    for k in ("n", "zx", "zy", "glitch"):
        assert torch.equal(sharded[k], single[k]), k
    theirs = jax_tiled.perturbation_fields_sharded(
        jax_om.compute_orbit(CX, CY, 64, 401), 64, 48, **kw)
    same = _counts_near_jax(sharded["n"], theirs["n"])
    np.testing.assert_allclose(sharded["zx"].numpy()[same],
                               np.asarray(theirs["zx"])[same], rtol=1e-3)


def test_deep_zoom_sharded_floatexp_matches_single():
    # the ARBITRARY (floatexp) tier splits like the f32/dd tiers, over an
    # uneven split (32 rows over 5 devices: 7-row bands, the last 4)
    orb = om.compute_orbit(CX, CY, 300, 401)
    kw = dict(center_x_dd=dd_from_string(CX), center_y_dd=dd_from_string(CY),
              max_iter=400, float_continuation=False, rebase=True,
              scaled_delta=True, zoom_frac="1e-40")
    single = perturbation_fields(orb, 64, 32, device="cpu", **kw)
    sharded = perturbation_fields_sharded(orb, 64, 32, mesh=_mesh(5), **kw)
    for k in ("n", "zx", "zy", "want", "rounds_plane"):
        assert torch.equal(sharded[k], single[k]), k
    assert sharded["passes"] == int(single["passes"])
    assert not (sharded["want"] > 0.5).any()


@pytest.mark.parametrize("zoom,iters,tier", [
    ("1e-6", 600, "f32"), ("1e-12", 600, "dd"), ("1e-50", 400, "fx")],
    ids=["f32", "dd", "fx"])
def test_deep_zoom_tiers_sharded_match_single(zoom, iters, tier):
    s = _dz(zoom, iters) if tier != "fx" else _dz(zoom, iters).with_(
        hp_center_x="0", hp_center_y="1")
    n1, zx1, zy1, _, i1 = deep_zoom.render_fields(s, 16, 12, device="cpu")
    n2, zx2, zy2, _, i2 = deep_zoom.render_fields(s, 16, 12, mesh=_mesh(),
                                                  device="cpu")
    assert (i2["dd_delta"], i2["scaled_delta"]) == (tier == "dd",
                                                    tier == "fx")
    assert i2["rebase_passes"] == i1["rebase_passes"]
    for a, b in ((n1, n2), (zx1, zx2), (zy1, zy2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fam_kw,cx,cy", [
    (dict(deep_zoom_julia=True, julia_c_real=-0.7, julia_c_imag=0.27015),
     "-0.2", "0.65"),
    (dict(deep_zoom_ship=True), "-1.7443359374999999", "-0.017451171875"),
    (dict(deep_zoom_phoenix=True), "-0.1465", "0.2115"),
], ids=["julia", "ship", "phoenix"])
def test_deep_zoom_families_sharded_match_single(fam_kw, cx, cy):
    s = Scene(fractal_type=FractalType.DEEP_ZOOM, use_perturbation=True,
              hp_center_x=cx, hp_center_y=cy, hp_zoom="1e-9",
              max_iterations=300, **fam_kw)
    n1, zx1, *_ = deep_zoom.render_fields(s, 32, 16, device="cpu")
    n2, zx2, *_ = deep_zoom.render_fields(s, 32, 16, mesh=_mesh(),
                                          device="cpu")
    np.testing.assert_array_equal(n1, n2)
    np.testing.assert_array_equal(zx1, zx2)
    jn, *_ = jax_dz.render_fields(_jax_scene(s), 32, 16,
                                  mesh=jax_mesh.make_render_mesh())
    _counts_near_jax(n2, jn)


def test_deep_zoom_model_sharded():
    s = _dz(iters=600)
    n_s, zx_s, _, _, info_s = deep_zoom.render_fields(s, 48, 32,
                                                      mesh=_mesh(),
                                                      device="cpu")
    n_1, zx_1, _, _, info_1 = deep_zoom.render_fields(s, 48, 32,
                                                      device="cpu")
    np.testing.assert_array_equal(n_s, n_1)
    np.testing.assert_array_equal(zx_s, zx_1)
    assert info_s["references_used"] == info_1["references_used"] == 1


def test_deep_zoom_legacy_pipeline_sharded():
    # rebasing=False: the single pass and every secondary reference's
    # pass run over the bands
    s = _dz(iters=600)
    n1, zx1, _, g1, i1 = deep_zoom.render_fields(s, 40, 24, rebasing=False,
                                                 device="cpu")
    n2, zx2, _, g2, i2 = deep_zoom.render_fields(s, 40, 24, rebasing=False,
                                                 mesh=_mesh(), device="cpu")
    assert i2["algorithm"] == "secondary_refs"
    assert i2["references_used"] == i1["references_used"]
    np.testing.assert_array_equal(n1, n2)
    np.testing.assert_array_equal(zx1, zx2)
    assert not g2.any()


def test_deep_zoom_mesh_device_quantized_bytes():
    # the sharded deep zoom keeps its planes on the device where every
    # band sits on one (keep_device), colours and quantizes there, and
    # gives the single-device bytes
    s = _dz()
    img_m, info = deep_zoom.render(s, 48, 32, mesh=_mesh(), quantize=16,
                                   return_info=True, device="cpu")
    assert info["fields_on_device"] is True
    assert img_m.dtype == torch.uint16
    assert torch.equal(img_m, deep_zoom.render(s, 48, 32, quantize=16,
                                               device="cpu"))
    theirs = np.asarray(jax_dz.render(_jax_scene(s), 48, 32, quantize=16,
                                      mesh=jax_mesh.make_render_mesh()))
    n, *_ = deep_zoom.render_fields(s, 48, 32, device="cpu")
    jn, *_ = jax_dz.render_fields(_jax_scene(s), 48, 32)
    same = _counts_near_jax(n, jn)
    lsb = np.abs(img_m.numpy().astype(np.int64) - theirs.astype(np.int64))
    assert lsb[same].max() <= 1


def test_keep_device_over_distinct_devices_joins_on_the_host():
    # "cpu" and "cpu:0" are two devices to the grid: bands on distinct
    # devices cannot join on one, so keep_device gathers them on the host,
    # equal to the one-device planes
    orb = om.compute_orbit(CX, CY, 64, 301)
    kw = dict(center_x_dd=dd_from_string(CX), center_y_dd=dd_from_string(CY),
              zoom_dd=dd_from_string("1e-8"), max_iter=300, rebase=True,
              float_continuation=False)
    two = make_render_mesh(devices=["cpu", "cpu:0", "cpu"])
    joined = perturbation_fields_sharded(orb, 24, 10, mesh=two,
                                         keep_device=True, **kw)
    single = perturbation_fields(orb, 24, 10, device="cpu", **kw)
    for k in ("n", "zx", "zy", "want"):
        assert torch.equal(joined[k], single[k]), k


def test_stacked_aa_sharded_matches_single():
    # aa_spp x mesh: each device stacks the spp^2 segments of its OWN band
    # (Q_AROW0), bit-identical to the single-device stacked render
    s = _dz()
    W, H = 32, 24
    n1, zx1, zy1, _, _ = deep_zoom.render_fields(s, W, H, aa_spp=2,
                                                 device="cpu")
    n2, zx2, zy2, _, _ = deep_zoom.render_fields(s, W, H, aa_spp=2,
                                                 mesh=_mesh(), device="cpu")
    assert n2.shape == (4, H, W)
    np.testing.assert_array_equal(n1, n2)
    np.testing.assert_array_equal(zx1, zx2)
    np.testing.assert_array_equal(zy1, zy2)


def test_mandelbulb_sharded_matches_single():
    # the bands' marches and shading are the whole frame's rows bit for
    # bit (the JAX package allows 1e-4 here for XLA's fusion order under
    # shard_map; the port's eager glue runs the same ops on every band)
    s = Scene(fractal_type=FractalType.MANDELBULB, max_iterations=12)
    W, H = 64, 48
    single = mandelbulb.render(s, W, H, device="cpu")
    sharded = mandelbulb.render_sharded(s, W, H, mesh=_mesh())
    assert sharded.shape == single.shape
    assert torch.equal(sharded, single)
    theirs = jax_mb.render_sharded(_jax_scene(s), W, H)
    bad = (np.abs(sharded.numpy() - theirs) > 2e-2).any(axis=-1)
    assert bad.mean() < 0.01


def test_mandelbulb_sharded_uneven_bands():
    # twin of the JAX XLA-march test (that march is not ported): 30 rows
    # over 8 devices, 4-row bands whose first rows are not on the cone
    # prepass's 8-row block grid
    s = Scene(fractal_type=FractalType.MANDELBULB, max_iterations=10)
    W, H = 48, 30
    single = mandelbulb.render(s, W, H, device="cpu")
    assert torch.equal(mandelbulb.render_sharded(s, W, H, mesh=_mesh()),
                       single)


def test_mandelbulb_cpu_glue_on_ragged_bands():
    # 90 rows over 7 bands of 13 (the last 12) at width 48: each band's
    # K4a/K4b planes are the whole frame's rows bit for bit; the colour
    # may differ by a few ulps (test_torch_parallel.CPU_TAIL_ATOL, 1e-6)
    # on the few pixels in a band's scalar tail (the module docstring)
    from fractalrenderer_tpu_torch.ops import bulb_kernel, bulb_math
    from fractalrenderer_tpu_torch.parallel.mesh import row_bands

    s = Scene(fractal_type=FractalType.MANDELBULB, max_iterations=12)
    W, H = 48, 90
    p = mandelbulb._bulb_params(s)
    ro, power = bulb_math.camera_setup(p)

    def planes(rows, row0):
        return bulb_kernel.march_fields(
            W, rows, ro=ro, fov=p.fov, power=power,
            max_iter=p.max_iterations, row0=row0, map_height=H, shade=True,
            int_power=8, device="cpu")

    whole = planes(H, 0)
    parts = [planes(rows, r0) for r0, rows in row_bands(H, 7)]
    for k in whole:
        assert torch.equal(torch.cat([q[k] for q in parts]), whole[k]), k
    single = mandelbulb.render(s, W, H, device="cpu")
    sharded = mandelbulb.render_sharded(s, W, H, mesh=_mesh(7))
    d = (sharded - single).abs()
    assert float(d.max()) <= 1e-6
    assert (d > 0).any(axis=-1).float().mean() < 0.01


def test_giant_still_mandelbulb(tmp_path):
    s = Scene(fractal_type=FractalType.MANDELBULB, max_iterations=24)
    out = str(tmp_path / "bulb.png")
    info = render_giant_still(s, 64, 48, out, band_rows=16, bit_depth=8,
                              dpi=None, device="cpu")
    assert info["rendered"] == 3
    img = read_png(out)
    np.testing.assert_array_equal(
        img, _png_pixels(mandelbulb.render(s, 64, 48, device="cpu"), 8))
    theirs = str(tmp_path / "jax.png")
    jax_tiled.render_giant_still(_jax_scene(s), 64, 48, theirs,
                                 band_rows=16, bit_depth=8, dpi=None)
    d = np.abs(img.astype(np.int64) - jax_read_png(theirs).astype(np.int64))
    assert (d.max(axis=-1) > 1).mean() < 0.01


def test_giant_still_deep_zoom(tmp_path):
    # one reference orbit serves every band: the streamed 16-bit PNG equals
    # a monolithic deep-zoom render exactly
    s = _dz()
    out = str(tmp_path / "deep.png")
    info = render_giant_still(s, 48, 40, out, band_rows=16, bit_depth=16,
                              dpi=None, device="cpu")
    assert info["rendered"] == 3
    img = read_png(out)
    assert img.shape == (40, 48, 3)
    np.testing.assert_array_equal(
        img, _png_pixels(deep_zoom.render(s, 48, 40, device="cpu"), 16))
    theirs = str(tmp_path / "jax.png")
    jax_tiled.render_giant_still(_jax_scene(s), 48, 40, theirs,
                                 band_rows=16, bit_depth=16, dpi=None)
    n, *_ = deep_zoom.render_fields(s, 48, 40, device="cpu")
    jn, *_ = jax_dz.render_fields(_jax_scene(s), 48, 40)
    same = _counts_near_jax(n, jn)[::-1]
    lsb = np.abs(img.astype(np.int64)
                 - jax_read_png(theirs).astype(np.int64)).max(axis=-1)
    assert lsb[same].max() <= 1


def test_giant_still_deep_zoom_mesh(tmp_path):
    # use_mesh composes with deep-zoom bands: the giant band's global row
    # offset and the per-device bands add up in perturbation_fields_sharded
    s = _dz()
    plain = str(tmp_path / "deep.png")
    meshed = str(tmp_path / "deep_mesh.png")
    render_giant_still(s, 48, 32, plain, band_rows=16, bit_depth=16,
                       dpi=None, device="cpu")
    render_giant_still(s, 48, 32, meshed, band_rows=16, bit_depth=16,
                       dpi=None, use_mesh=True, mesh=_mesh(), device="cpu")
    np.testing.assert_array_equal(read_png(plain), read_png(meshed))


def test_giant_still_supersample_deep_zoom(tmp_path):
    s = _dz()
    out = str(tmp_path / "ssdeep.png")
    render_giant_still(s, 32, 24, out, band_rows=8, bit_depth=16, dpi=None,
                       supersample=True, device="cpu")
    ref = downsample2x(deep_zoom.render(s, 64, 48, device="cpu"))
    np.testing.assert_array_equal(read_png(out), _png_pixels(ref, 16))


def test_giant_still_deep_zoom_scaled_julia(tmp_path):
    # the floatexp (ARBITRARY) tier and a deep-zoom JULIA at 1e-40 in
    # bands equal the monolithic render exactly
    s = Scene(fractal_type=FractalType.DEEP_ZOOM, use_perturbation=True,
              deep_zoom_julia=True, julia_c_real=-0.7, julia_c_imag=0.27015,
              hp_center_x="1.4842927481401905",
              hp_center_y="-0.1372305142501787",
              hp_zoom="1e-40", max_iterations=200)
    out = str(tmp_path / "dj.png")
    info = render_giant_still(s, 24, 18, out, band_rows=8, bit_depth=16,
                              dpi=None, device="cpu")
    assert info["rendered"] == 3
    np.testing.assert_array_equal(
        read_png(out), _png_pixels(deep_zoom.render(s, 24, 18, device="cpu"),
                                   16))


def test_giant_still_deep_zoom_spp(tmp_path):
    # samples_per_pixel 2: each band renders its 4 samples in ONE stacked
    # launch, equal to the monolithic stacked render
    s = _dz(samples_per_pixel=2)
    out = str(tmp_path / "spp.png")
    render_giant_still(s, 32, 24, out, band_rows=8, bit_depth=16, dpi=None,
                       device="cpu")
    np.testing.assert_array_equal(
        read_png(out), _png_pixels(deep_zoom.render(s, 32, 24, device="cpu"),
                                   16))


def test_giant_still_deep_zoom_spp_sequential_fallback(tmp_path,
                                                       monkeypatch):
    # over the stacked budget, the band's samples render one offset at a
    # time: the same pixels
    from fractalrenderer_tpu_torch.parallel import tiled

    s = _dz(samples_per_pixel=2)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    render_giant_still(s, 24, 12, a, band_rows=8, bit_depth=16, dpi=None,
                       device="cpu")
    monkeypatch.setattr(tiled, "_STACKED_BAND_PIXELS", 1)
    calls = []
    real = deep_zoom.render_fields

    def spy(*args, **kw):
        calls.append(kw.get("aa_spp", 1))
        return real(*args, **kw)

    monkeypatch.setattr(deep_zoom, "render_fields", spy)
    render_giant_still(s, 24, 12, b, band_rows=8, bit_depth=16, dpi=None,
                       device="cpu", resume=False)
    assert calls == [1] * 8  # 2 bands x 4 offsets
    np.testing.assert_array_equal(read_png(a), read_png(b))
