"""The port's render pipeline (``render`` on the CPU device, i.e. the plain
kernel versions) against the numpy golden render and the JAX render, for
the four families with AA, traps, stripes and interior styles.

Counts are exact on the port, so against ``render_numpy`` every pixel must
agree within atol 1e-5; against the JAX ``fr.render`` (interpret mode, not
count-exact on CPU) the bad-pixel fraction bound of test_golden_vs_kernel.py
applies (|diff| > 2e-2 on < 1% of pixels).
"""
import numpy as np
import pytest
import torch

import fractalrenderer_tpu as fr
import fractalrenderer_tpu_torch as frt
from fractalrenderer_tpu.models import common as jax_common
from fractalrenderer_tpu_torch.models import common

SCENES = {
    "default": {},
    "palette3_interior1": dict(palette_mode=3, interior_style=1,
                               color_offset=0.25, color_scale=2.0),
}
W, H = 160, 90


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_matches_golden(name):
    kw = SCENES[name]
    img = frt.render(frt.Scene(**kw), W, H, device="cpu")
    assert img.shape == (H, W, 3) and img.dtype == torch.float32
    ref = fr.render_numpy(fr.Scene(**kw), W, H)
    np.testing.assert_allclose(img.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_close_to_jax(name):
    kw = SCENES[name]
    img = frt.render(frt.Scene(**kw), W, H, device="cpu").numpy()
    ref = np.asarray(fr.render(fr.Scene(**kw), W, H))
    bad = (np.abs(img - ref) > 2e-2).any(axis=-1)
    assert bad.mean() < 0.01, f"bad colour fraction {bad.mean()}"


@pytest.mark.parametrize("bit_depth", [8, 16])
def test_quantized_render_matches_jax_quantize(bit_depth):
    s = frt.Scene(max_iterations=64)
    img = frt.render(s, 48, 32, device="cpu")
    q = frt.render(s, 48, 32, device="cpu", quantize=bit_depth)
    want = np.asarray(jax_common.quantize_image(img.numpy(),
                                                bit_depth=bit_depth))
    assert q.shape == (32, 48, 3)
    assert q.numpy().dtype == want.dtype
    np.testing.assert_array_equal(q.numpy(), want)


@pytest.mark.parametrize("kw", [
    {},
    dict(center_x=-0.743643887037151, center_y=0.13182590420533,
         zoom=0.008, max_iterations=1024, palette_mode=4),
    dict(fractal_type=fr.FractalType.JULIA, julia_c_real=-0.4,
         julia_c_imag=0.6, color_brightness=1.3, color_saturation=0.7,
         color_contrast=1.2, antialiasing_samples=2, stripe_enabled=True),
    dict(max_iterations=9_000_000, interior_style=2, orbit_trap_enabled=True,
         hp_zoom="1e-12", use_perturbation=True),
])
def test_scene_json_from_jax_gives_same_params(kw):
    jax_scene = fr.Scene(**kw)
    scene = frt.Scene.from_json(jax_scene.to_json())
    assert scene.to_dict() == jax_scene.to_dict()
    assert common.scene_dyn_params(scene) == \
        jax_common.scene_dyn_params(jax_scene)
    assert common.DYN_KEYS == jax_common.DYN_KEYS
    mine = common.scene_static_cfg(scene, 64, 32, "mandelbrot", "centered",
                                   False)
    ref = jax_common.scene_static_cfg(jax_scene, 64, 32, "mandelbrot",
                                      "centered", False)
    for field in ("max_iter", "aa", "palette_mode", "interior_style",
                  "orbit_trap_enabled", "stripe_enabled", "clamp_mins",
                  "aa_convention"):
        assert getattr(mine, field) == getattr(ref, field), field
    assert common._interior_skip_ok(mine) == jax_common._interior_skip_ok(ref)
    assert common.planar_export_ok(mine) == jax_common.planar_export_ok(ref)


def test_iter_bucket_matches_jax():
    for mi in (1, 255, 256, 257, 300, 1024, 9_000_000, (1 << 24) - 1):
        assert common._iter_bucket(mi) == jax_common._iter_bucket(mi)


def test_oversized_iter_limit_colors_interior_consistently():
    # twin: a limit beyond the static cap colours like the cap itself
    s = frt.Scene(max_iterations=96)
    cfg = common.scene_static_cfg(s, 32, 16, "mandelbrot", "centered", False,
                                  device="cpu")
    fn = common.render_fn(cfg)
    dyn = common.scene_dyn_params(s)
    over = fn(dict(dyn, iter_limit=float(cfg.max_iter) + 1000.0))
    at_cap = fn(dict(dyn, iter_limit=float(cfg.max_iter)))
    assert torch.equal(over, at_cap)


@pytest.mark.parametrize("kw,extra,exc,match", [
    # the deep zoom renders every family, spp, exact dust and the legacy
    # pipeline (test_torch_pert_families, test_torch_deepzoom_aa,
    # test_torch_exact_dust, test_torch_pert_single) and takes a mesh
    # (below); the JAX model's own guards refuse them outside their domain
    (dict(fractal_type=frt.FractalType.DEEP_ZOOM),
     dict(exact_dust=True), ValueError, "Burning Ship dust tier"),
    (dict(fractal_type=frt.FractalType.DEEP_ZOOM, deep_zoom_phoenix=True),
     dict(rebasing=False), ValueError, "requires the rebasing pipeline"),
])
def test_unported_scenes_raise(kw, extra, exc, match):
    with pytest.raises(exc, match=match):
        frt.render(frt.Scene(**kw), 16, 8, device="cpu", **extra)


def test_deep_zoom_spp_renders_over_a_mesh():
    # models.render passes mesh= to the deep zoom: the stacked spp-2
    # samples of each band of a 2-device CPU grid, the unsharded image
    from fractalrenderer_tpu_torch.parallel import make_render_mesh

    s = frt.Scene(fractal_type=frt.FractalType.DEEP_ZOOM,
                  samples_per_pixel=2, max_iterations=200,
                  hp_center_x="-0.743643887037151",
                  hp_center_y="0.13182590420533", hp_zoom="1e-8")
    mesh = make_render_mesh(devices=[torch.device("cpu")] * 2)
    img = frt.render(s, 16, 8, device="cpu", mesh=mesh)
    assert torch.equal(img, frt.render(s, 16, 8, device="cpu"))


FT = fr.FractalType
_BS = dict(fractal_type=FT.BURNING_SHIP, center_x=-0.5, center_y=-0.6,
           zoom=2.0, max_iterations=48)
# the scenes of test_golden_vs_kernel.py:303-345, the families' defaults
# and each effect option alone
EFFECT_SCENES = {
    "julia": dict(fractal_type=FT.JULIA),
    "burning_ship": dict(fractal_type=FT.BURNING_SHIP),
    "phoenix": dict(fractal_type=FT.PHOENIX),
    "orbit_trap": dict(orbit_trap_enabled=True),
    "stripes": dict(stripe_enabled=True),
    "interior_style_2": dict(interior_style=2),
    "mb_trap_r03": dict(max_iterations=48, zoom=2.8, orbit_trap_enabled=True,
                        orbit_trap_radius=0.3),
    "mb_stripes_7": dict(max_iterations=48, zoom=2.8, stripe_enabled=True,
                         stripe_density=7.0),
    "mb_style1": dict(max_iterations=48, zoom=2.8, interior_style=1),
    "mb_style2_trap": dict(max_iterations=48, zoom=2.8, interior_style=2,
                           orbit_trap_enabled=True),
    "mb_palette4": dict(max_iterations=48, zoom=2.8, color_offset=0.37,
                        color_scale=2.5, palette_mode=4),
    "mb_enhance": dict(max_iterations=48, zoom=2.8, color_brightness=1.4,
                       color_saturation=0.6, color_contrast=1.2),
    "bs_style1_trap": dict(_BS, interior_style=1, orbit_trap_enabled=True),
    "bs_style2_stripes": dict(_BS, interior_style=2, stripe_enabled=True,
                              stripe_density=12.0),
    "bs_style3": dict(_BS, interior_style=3),
    "phoenix_params": dict(fractal_type=FT.PHOENIX, zoom=3.0,
                           max_iterations=48, phoenix_p=0.2,
                           phoenix_r=-0.3, stripe_density=5.0),
    "phoenix_julia_mode": dict(fractal_type=FT.PHOENIX, use_julia_set=True,
                               julia_c_real=0.3, julia_c_imag=0.2,
                               max_iterations=48),
    "julia_rabbit_floors": dict(fractal_type=FT.JULIA, julia_c_real=-0.123,
                                julia_c_imag=0.745, color_brightness=0.05,
                                color_saturation=-0.5, palette_mode=7),
}


def _port_scene(jax_scene):
    return frt.Scene.from_json(jax_scene.to_json())


@pytest.mark.parametrize("aa", [1, 2])
@pytest.mark.parametrize("name", sorted(EFFECT_SCENES))
def test_effect_scene_matches_golden(name, aa):
    # counts are exact on the port, so every pixel agrees with the golden
    # render within the colour contract 1e-5 (tighter than the
    # bad-fraction bounds the JAX kernel needs on CPU).  Phoenix's stripes
    # take the polynomial atan2 (error up to ~1.8e-6, times the stripe
    # density inside a sine) where golden takes numpy's: atol 5e-5 there.
    s = fr.Scene(antialiasing_samples=aa, **EFFECT_SCENES[name])
    img = frt.render(_port_scene(s), 48, 32, device="cpu")
    assert img.shape == (32, 48, 3) and img.dtype == torch.float32
    ref = fr.render_numpy(s, 48, 32)
    atol = 5e-5 if name.startswith("phoenix") else 1e-5
    np.testing.assert_allclose(img.numpy(), ref, rtol=0, atol=atol)


@pytest.mark.parametrize("name,frac", [("julia", 0.01),
                                       ("bs_style2_stripes", 0.06),
                                       ("phoenix_params", 0.03)])
def test_effect_scene_close_to_jax(name, frac):
    s = fr.Scene(antialiasing_samples=2, **EFFECT_SCENES[name])
    img = frt.render(_port_scene(s), 48, 32, device="cpu").numpy()
    ref = np.asarray(fr.render(s, 48, 32))
    bad = (np.abs(img - ref) > 2e-2).any(axis=-1)
    assert bad.mean() < frac, f"bad colour fraction {bad.mean()}"


def test_branch_choice_matches_jax():
    # the fused/unfused choice and the tracked fields follow the JAX
    # predicates for every family and effect
    for name, kw in EFFECT_SCENES.items():
        s = fr.Scene(**kw)
        for fam, (family, conv, clamp) in jax_common.family_map().items():
            ref = jax_common.scene_static_cfg(s.with_(fractal_type=fam), 32,
                                              16, family, conv, clamp)
            mine = common.scene_static_cfg(
                _port_scene(s.with_(fractal_type=fam)), 32, 16, family, conv,
                clamp)
            assert mine.use_julia == ref.use_julia
            assert common._fused_ok(mine) == jax_common._fused_ok(ref), name
            assert common._track_flags(mine) == \
                jax_common._track_flags(ref), name
            assert common.planar_export_ok(mine) == \
                jax_common.planar_export_ok(ref), name


@pytest.mark.parametrize("bit_depth", [8, 16])
def test_quantized_unfused_render_matches_jax_quantize(bit_depth):
    # configurations that cannot export planar planes quantize the
    # interleaved image on the device
    s = frt.Scene(max_iterations=64, antialiasing_samples=2,
                  orbit_trap_enabled=True)
    img = frt.render(s, 48, 32, device="cpu")
    q = frt.render(s, 48, 32, device="cpu", quantize=bit_depth)
    want = np.asarray(jax_common.quantize_image(img.numpy(),
                                                bit_depth=bit_depth))
    np.testing.assert_array_equal(q.numpy(), want)


def test_distance_field_matches_jax():
    from fractalrenderer_tpu.models.mandelbrot import \
        distance_field as jax_distance_field
    from fractalrenderer_tpu_torch.models.mandelbrot import distance_field

    s = fr.Scene(max_iterations=64)
    d = distance_field(_port_scene(s), 48, 32, device="cpu").numpy()
    ref = jax_distance_field(s, 48, 32)
    assert d.shape == (32, 48) and (d >= 0).all()
    # the JAX kernel on CPU is near-exact (FMA contraction), so compare
    # where both see the exterior, relatively
    both = (d > 0) & (ref > 0)
    assert both.mean() > 0.5
    np.testing.assert_allclose(d[both], ref[both], rtol=1e-2)
    assert ((d > 0) != (ref > 0)).mean() < 0.01


def test_validate_scene_repairs_like_jax():
    from fractalrenderer_tpu.utils.diag import validate_scene as jax_validate
    from fractalrenderer_tpu_torch.utils.diag import validate_scene

    s = dict(zoom=float("nan"), bailout=-1.0, max_iterations=0)
    assert validate_scene(frt.Scene(**s)).to_dict() == \
        jax_validate(fr.Scene(**s)).to_dict()
    img = frt.render(frt.Scene(zoom=0.0, max_iterations=16), 16, 8,
                     device="cpu")
    assert torch.isfinite(img).all()
