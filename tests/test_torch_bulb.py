"""The port's Mandelbulb (ops/bulb_math.py, ops/bulb_kernel.py's plain K4a
and K4b, models/mandelbulb.py, ``cli render --type mandelbulb``) against
the JAX package on the CPU.

The JAX march runs as tests/test_mandelbulb.py runs it: Pallas interpret
mode with a (8, 128) tile.  What is exact and what is statistical:

- the integer-power DE step uses only +, -, x, / and the IEEE sqrt, so it
  is bit-equal to the numpy reference; the parameter vectors are bit-equal
  to the JAX packing; ``camera_setup``/``ray_dirs`` bit-equal to numpy;
- the trig DE step, the march and the shading run XLA:CPU code on the JAX
  side, which contracts multiply-adds and has other pow/sin/log/exp ulps,
  so equality is statistical (hit maps and esc on >= 98% of lanes) and the
  continuous outputs are held to stated tolerances;
- AO is also held against a float64 recomputation from the port's own hit
  positions and normals (in place of the reference's loose bound).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fractalrenderer_tpu as fr
from fractalrenderer_tpu.models import mandelbulb as jax_mb
from fractalrenderer_tpu.ops import bulb_kernel as jbk
from fractalrenderer_tpu.ops import bulb_math as jbm
from fractalrenderer_tpu.ops import palettes as jpal
from fractalrenderer_tpu.ops import trig as jtrig
from fractalrenderer_tpu_torch import FractalType, Scene, cli
from fractalrenderer_tpu_torch.models import mandelbulb
from fractalrenderer_tpu_torch.ops import bulb_kernel as bk
from fractalrenderer_tpu_torch.ops import bulb_math as bm
from fractalrenderer_tpu_torch.ops import consts
from fractalrenderer_tpu_torch.ops import palettes as pal
from fractalrenderer_tpu_torch.ops import trig
from fractalrenderer_tpu_torch.ops.coloring import quantize_image
from fractalrenderer_tpu_torch.utils.image import to_export_orientation

ITERS = 32  # DE iteration limit of the march comparisons
PLANES = ("hit", "t", "d", "esc", "nx", "ny", "nz", "ao")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _de_state(seed, n=4096):
    """Random f32 DE states around the bulb, with m = 0 (axis) lanes and a
    random activity mask."""
    rng = np.random.default_rng(seed)
    zx, zy, zz, px, py, pz = (rng.uniform(-1.3, 1.3, n).astype(np.float32)
                              for _ in range(6))
    zx[:8] = 0.0
    zy[:8] = 0.0
    dr = rng.uniform(0.5, 50.0, n).astype(np.float32)
    active = rng.uniform(size=n) < 0.8
    return zx, zy, zz, dr, px, py, pz, active


@pytest.mark.parametrize("p", range(2, 17))
def test_de_step_int_bit_equal_to_reference(p):
    zx, zy, zz, dr, px, py, pz, act = _de_state(p)
    for carried in (False, True):
        r = np.sqrt(zx * zx + zy * zy + zz * zz) if carried else None
        got = bm.de_step_int(*map(_t, (zx, zy, zz, dr, px, py, pz)), p,
                             _t(act), r=None if r is None else _t(r))
        want = jbm.de_step_int(np, zx, zy, zz, dr, px, py, pz, p, act, r=r)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("power", [2.5, 3.3221, 8.3221, 15.9])
def test_de_step_trig_matches_reference(power):
    # the reference with the JAX polynomials in jax.numpy (f32 throughout):
    # acos/atan2 agree bit for bit (test_acos_matches_reference), so the
    # rest is torch's vs XLA's pow/sin/cos, a few ulps each, which the
    # power-p map amplifies: held to 64 ulps of the output's scale
    # r^p + |p|, and dr (no trig) to 4 ulps
    zx, zy, zz, dr, px, py, pz, act = _de_state(int(power * 10))
    pw = np.float32(power)
    got = bm.de_step(*map(_t, (zx, zy, zz, dr, px, py, pz)),
                     torch.tensor(pw), _t(act))
    want = jbm.de_step(jnp, *map(jnp.asarray, (zx, zy, zz, dr, px, py, pz)),
                       jnp.float32(pw), jnp.asarray(act),
                       acos_fn=lambda v: jtrig.acos(jnp, v),
                       atan2_fn=lambda a, b: jtrig.atan2(jnp, a, b))
    r = np.sqrt(zx * zx + zy * zy + zz * zz)
    eps = np.float32(2.0 ** -23)
    for k, (g, w, s) in enumerate(zip(got[:3], want[:3], (px, py, pz))):
        scale = np.maximum(r, 1e-12) ** pw + np.abs(s)
        err = np.abs(g.numpy() - np.asarray(w))
        assert (err <= 64 * eps * scale).all(), (k, (err / scale).max())
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=4 * eps, atol=0)


def test_acos_matches_reference():
    x = np.random.default_rng(7).uniform(-1.0, 1.0, 20000)
    x = np.concatenate([x, [-1.0, 1.0, 0.0, -0.0, 1.5, -1.5]]).astype(
        np.float32)
    got = trig.acos(_t(x)).numpy()
    # the JAX polynomial in f32 (jax.numpy): bit-equal
    np.testing.assert_array_equal(got, np.asarray(jtrig.acos(jnp,
                                                             jnp.asarray(x))))
    # in numpy, which folds its quadrant constants in f64: within 1 ulp
    np.testing.assert_allclose(got, jtrig.acos(np, x), rtol=0, atol=3e-7)
    # the true arccos: the polynomial's own error
    np.testing.assert_allclose(got, np.arccos(np.clip(x, -1, 1)), rtol=0,
                               atol=5e-6)


@pytest.mark.parametrize("fn", ["bulb_dynamic", "bulb_fire_and_ice",
                                "bulb_lava", "bulb_neon"])
def test_bulb_palettes_match_reference(fn):
    t = np.random.default_rng(11).uniform(-0.2, 1.2, 20000).astype(
        np.float32)
    got = getattr(pal, fn)(_t(t)).numpy()
    want = getattr(jpal, fn)(np, t)
    assert got.shape == t.shape + (3,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", range(6))
def test_bulb_color_matches_reference(mode):
    # bulb_color adds hash noise: fract(sin(127.1x + 311.7y) * 43758.5),
    # at arguments up to ~6e4, so one ulp of sin moves the noise by ~1e-4
    # (torch's CPU sin and numpy's differ by an ulp on some inputs).
    # Within 1e-5 where the noise agrees, and within 1e-3 everywhere.
    t = np.random.default_rng(mode).uniform(-2.0, 3.0, 20000).astype(
        np.float32)
    got = pal.bulb_color(_t(t), mode).numpy()
    want = jpal.bulb_color(np, t, mode)
    err = np.abs(got - want).max(axis=-1)
    tf = t - np.floor(t)
    noise_same = (pal._noise(_t(tf) * 100.0, _t(tf) * 57.0).numpy()
                  == jpal._noise(np, tf * np.float32(100.0),
                                 tf * np.float32(57.0)))
    assert noise_same.mean() > 0.5
    assert (err[noise_same] <= 1e-5).all()
    assert err.max() <= 1e-3
    assert pal.num_palettes("bulb") == 6


def _jax_packed(monkeypatch, width, height, **kw):
    """The operands the JAX march_fields hands its two pallas_calls."""
    seen = {}

    def cone_call(params, **ckw):
        seen["cone"], seen["cone_kw"] = np.asarray(params)[0], ckw
        ch, cw = ckw["coarse_h"], ckw["coarse_w"]
        return jnp.arange(ch * cw, dtype=jnp.float32).reshape(ch, cw)

    def march_call(params, t0=None, **mkw):
        seen["march"], seen["march_kw"] = np.asarray(params)[0], mkw
        seen["t0"] = None if t0 is None else np.asarray(t0)
        n = 8 if mkw["shade"] else 4
        return tuple(jnp.zeros((height, width), jnp.float32)
                     for _ in range(n))

    monkeypatch.setattr(jbk, "_cone_call", cone_call)
    monkeypatch.setattr(jbk, "_march_call", march_call)
    jbk.march_fields(width, height, **kw)
    return seen


@pytest.mark.parametrize("cone", [8, 0])
@pytest.mark.parametrize("band", [dict(row0=0), dict(row0=37,
                                                     map_height=90)],
                         ids=["frame", "band"])
def test_param_vectors_match_jax_packing(monkeypatch, cone, band):
    width, height = 50, 21
    ro, dyn = bm.camera_setup(bm.BulbParams(time=1.3, rotation_y=0.4))
    kw = dict(ro=tuple(float(v) for v in ro), fov=1.1, power=float(dyn),
              max_iter=77, offset=(0.5, 0.25), shade=True, cone=cone,
              **band)
    seen = _jax_packed(monkeypatch, width, height, **kw)
    params = bk.pack_march_params(
        ro=kw["ro"], fov=kw["fov"], power=kw["power"],
        max_iter=kw["max_iter"], offset=kw["offset"], row0=band["row0"])
    assert params.dtype == np.float32 and params.shape == (bk.NB,)
    np.testing.assert_array_equal(params, seen["march"])
    assert seen["march_kw"]["map_height"] == band.get("map_height", height)
    assert bk.resolve_int_power(kw["power"]) == seen["march_kw"]["int_power"]
    map_h = band.get("map_height", height)
    if not cone:
        assert "cone" not in seen and seen["t0"] is None
        return
    cparams = bk.pack_cone_params(params, cone, map_h)
    assert cparams.dtype == np.float32 and cparams.shape == (bk.NCB,)
    np.testing.assert_array_equal(cparams, seen["cone"])
    ckw = seen["cone_kw"]
    assert (ckw["coarse_h"], ckw["coarse_w"]) == (
        bk.cdiv(height, cone) + 1, bk.cdiv(width, cone))
    assert ckw["map_height"] == map_h and ckw["width"] == width
    # the image-aligned expansion of the coarse grid to the band's pixels
    tc = torch.arange(ckw["coarse_h"] * ckw["coarse_w"],
                      dtype=torch.float32).reshape(ckw["coarse_h"], -1)
    got = bk.expand_cone(tc, band["row0"], cone, width, height)
    np.testing.assert_array_equal(got.numpy(), seen["t0"])


def test_int_power_gates_match_jax():
    for power, time in ((8.0, 0.0), (3.0, 0.0), (8.0, 1.0), (16.0, 0.0),
                        (1.0, 0.0), (20.0, 0.0), (7.5, 0.0)):
        s = fr.Scene(fractal_type=fr.FractalType.MANDELBULB,
                     mandelbulb_power=power, time=time)
        jp = jax_mb._bulb_params(s)
        p = mandelbulb._bulb_params(Scene.from_json(s.to_json()))
        assert p.__dict__ == jp.__dict__
        assert mandelbulb._static_int_power(p) == jax_mb._static_int_power(jp)
        assert bk.resolve_int_power(power) == (
            int(power) if power.is_integer() and 2 <= power <= 16 else None)
    s = fr.Scene(fractal_type=fr.FractalType.MANDELBULB, fov=9.0,
                 camera_distance=-1.0, color_scale=0.0, palette_mode=9)
    assert mandelbulb.dyn_params(Scene.from_json(s.to_json())) == \
        jax_mb.dyn_params(s)
    assert mandelbulb._DYN_FIELDS == jax_mb._DYN_FIELDS


@pytest.mark.parametrize("kw", [dict(), dict(time=1.0),
                                dict(time=2.7, rotation_y=0.5,
                                     camera_distance=2.2, power=5.0)],
                         ids=["default", "time 1", "animated"])
def test_camera_and_ray_dirs_match_reference(kw):
    p = bm.BulbParams(**kw).clamped()
    ro, dyn = bm.camera_setup(p)
    # numpy f32 scalars on both sides: bit-equal
    jp = jbm.BulbParams(**{k: np.float32(v) if isinstance(v, float) else v
                           for k, v in p.__dict__.items()})
    jro, jdyn = jbm.camera_setup(np, jp)
    assert all(np.float32(a) == np.float32(b) for a, b in zip(ro, jro))
    assert np.float32(dyn) == np.float32(jdyn)
    # against the jax.numpy camera (XLA's sin/cos): within 2 ulps
    xro, xdyn = jbm.camera_setup(jnp, jbm.BulbParams(
        **{k: jnp.float32(v) if isinstance(v, float) else v
           for k, v in p.__dict__.items()}))
    np.testing.assert_array_max_ulp(
        np.array(ro, np.float32), np.array([float(v) for v in xro],
                                           np.float32), maxulp=2)
    np.testing.assert_array_max_ulp(np.float32(dyn), np.float32(xdyn),
                                    maxulp=2)
    w, h = 37, 23
    pyg, pxg = np.mgrid[0:h, 0:w].astype(np.float32)
    pxg, pyg = pxg + np.float32(0.5), pyg + np.float32(0.25)
    ro_t = tuple(torch.tensor(v) for v in ro)
    got = bm.ray_dirs(_t(pxg), _t(pyg), w, h, ro_t,
                      torch.tensor(np.float32(p.fov)))
    want = jbm.ray_dirs(np, pxg, pyg, w, h, ro, np.float32(p.fov))
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), wv)


def test_cone_plain_matches_jax():
    # XLA:CPU contracts multiply-adds, so a few coarse lanes stop one
    # march step apart; the rest agree within 2e-6 relative
    width, height, cone = 96, 64, 8
    ro, _ = bm.camera_setup(bm.BulbParams())
    params = bk.pack_march_params(ro=ro, fov=1.0, power=8.0,
                                  max_iter=ITERS)
    cparams = bk.pack_cone_params(params, cone, height)
    ch, cw = bk.cdiv(height, cone) + 1, bk.cdiv(width, cone)
    got = bk.cone_fields_plain(cparams, coarse_w=cw, coarse_h=ch,
                               width=width, map_height=height, int_power=8,
                               device="cpu").numpy()
    want = np.asarray(jbk._cone_call(
        jnp.asarray(cparams).reshape(1, bk.NCB), width=width,
        map_height=height, coarse_h=ch, coarse_w=cw, tile=(8, 128),
        interpret=True, int_power=8))
    assert got.shape == want.shape == (ch, cw)
    close = np.abs(got - want) <= 2e-6 * np.abs(want)
    assert close.mean() >= 0.95
    assert got.min() >= 0.001 and np.isfinite(got).all()


_CASES = {
    # name: (width, height, scene params)
    "power8": (64, 48, dict()),
    "power3_time1": (48, 32, dict(power=3.0, time=1.0)),
    "power16": (48, 32, dict(power=16.0)),
}
_RUNS = {}


def _march_kw(case):
    w, h, kw = _CASES[case]
    p = bm.BulbParams(max_iterations=ITERS, **kw).clamped()
    ro, dyn = bm.camera_setup(p)
    return w, h, dict(ro=tuple(float(v) for v in ro), fov=p.fov,
                      power=float(dyn), max_iter=ITERS, shade=True)


def _runs(case, nested=True):
    """The port's plain march (with stats), the JAX flat form and, unless
    ``nested`` is False, the JAX nested form (stats=True), as numpy."""
    if case not in _RUNS:
        w, h, kw = _march_kw(case)
        mine = bk.march_fields(w, h, stats=True, device="cpu", **kw)
        flat = jbk.march_fields(w, h, tile=(8, 128), **kw)
        _RUNS[case] = [{k: v.numpy() for k, v in mine.items()},
                       {k: np.asarray(v) for k, v in flat.items()}, None]
    if nested and _RUNS[case][2] is None:
        w, h, kw = _march_kw(case)
        nest = jbk.march_fields(w, h, tile=(8, 128), stats=True, **kw)
        _RUNS[case][2] = {k: np.asarray(v) for k, v in nest.items()}
    return _RUNS[case]


def _reference(case):
    """The JAX flat form, with the nested form's planes on the lanes where
    the nested form ran into the 200-step cap (the cap the port keeps)."""
    mine, flat, nest = _runs(case)
    cap = nest["msteps"] >= bm.MAX_STEPS
    return mine, {k: np.where(cap, nest[k], flat[k]) for k in PLANES}, nest


@pytest.mark.parametrize("case", ["power8", "power3_time1"])
def test_march_plain_matches_jax(case):
    mine, ref, _ = _reference(case)
    for k in PLANES:
        assert mine[k].shape == ref[k].shape and mine[k].dtype == np.float32
    hm, hr = mine["hit"] > 0.5, ref["hit"] > 0.5
    assert 0.1 < hm.mean() < 0.9  # the view really has bulb and sky
    both = hm & hr
    # the measured agreement (pytest -s prints it)
    print(f"\n{case}: hit maps equal on {(hm == hr).mean():.4f}; on the "
          f"{both.sum()} lanes that hit in both, esc equal on "
          f"{(mine['esc'] == ref['esc'])[both].mean():.4f}, " + ", ".join(
              f"{k} max |diff| {np.abs(mine[k] - ref[k])[both].max():.3g} "
              f"(<= 1e-3 on {(np.abs(mine[k] - ref[k])[both] <= 1e-3).mean():.4f})"
              for k in ("t", "d", "nx", "ny", "nz", "ao")))
    assert (hm == hr).mean() >= 0.98
    assert (mine["esc"] == ref["esc"])[both].mean() >= 0.98
    # t and d: a few f32 ulps of drift along the same march
    np.testing.assert_allclose(mine["t"][both], ref["t"][both], rtol=1e-5)
    assert np.abs(mine["d"] - ref["d"])[both].max() <= 1e-5
    # normals are finite differences of DEs over eps = 1e-3, so the DEs'
    # ulps are amplified ~1e3x; AO sums exp(-10 d) over 8 taps whose
    # orbits may escape one iteration apart: statistical bounds
    for k, tol in (("nx", 1e-3), ("ny", 1e-3), ("nz", 1e-3), ("ao", 1e-3)):
        err = np.abs(mine[k] - ref[k])[both]
        assert (err <= tol).mean() >= 0.97, (k, (err <= tol).mean())
        assert err.max() <= (0.1 if k != "ao" else 1.0), (k, err.max())
    # non-hit lanes: the closed-form constant normal and AO (XLA's log is
    # an ulp off torch's, and AO's exp(-10 d) at d ~ 1.65 scales that
    # ulp of d by ~16: rtol 1e-5)
    miss = ~hm & ~hr
    for k in ("nx", "ny", "nz", "ao"):
        np.testing.assert_allclose(mine[k][miss], ref[k][miss], rtol=1e-5,
                                   atol=0)


@pytest.mark.parametrize("case", ["power8", "power3_time1"])
def test_msteps_equal_to_jax_nested(case):
    mine, ref, nest = _reference(case)
    same = (mine["hit"] > 0.5) == (ref["hit"] > 0.5)
    assert (mine["msteps"] == nest["msteps"])[same].mean() >= 0.98
    assert mine["msteps"].max() <= bm.MAX_STEPS
    # every lane runs at least one march evaluation (sky lanes' orbits
    # may end before their first DE iteration); hit lanes also run the
    # esc recovery and the 11 shading taps
    hit = mine["hit"] > 0.5
    assert (mine["msteps"] >= 1).all()
    assert mine["work"][hit].mean() > 2 * mine["work"][~hit].mean()
    assert (mine["warp_work"] >= mine["work"]).all()


def test_power16_hit_map_matches_jax_flat():
    # powers 13-16 follow the flat form (dr frozen at inf: a hit)
    mine, flat, _ = _runs("power16", nested=False)
    hm, hf = mine["hit"] > 0.5, flat["hit"] > 0.5
    assert 0.05 < hm.mean() < 0.95
    assert (hm == hf).mean() >= 0.98
    both = hm & hf
    assert (mine["esc"] == flat["esc"])[both].mean() >= 0.98


def _de64(px, py, pz, power, limit):
    """The reference DE (exact trig) in float64, to the iteration limit."""
    zx, zy, zz = px.copy(), py.copy(), pz.copy()
    dr = np.ones_like(px)
    for _ in range(limit):
        r = np.sqrt(zx * zx + zy * zy + zz * zz)
        act = (r <= 2.0) & (r >= 1e-4)
        if not act.any():
            break
        zx, zy, zz, dr, _ = jbm.de_step(np, zx, zy, zz, dr, px, py, pz,
                                        power, act)
    r = np.sqrt(zx * zx + zy * zy + zz * zz)
    return jbm.de_finish(np, r, dr)


def test_ao_against_float64():
    # AO = sum over the 8 taps h + n k of exp(-10 DE), recomputed in
    # float64 with exact trig from the port's own hit positions and
    # normals: the f32 kernel arithmetic, dr overflowing to inf (DE 0,
    # exp 1) and the taps' f32 positions stay within 2e-3 on >= 95% of
    # hit lanes and within 1e-2 on average
    w, h, kw = _march_kw("power8")
    mine = _runs("power8", nested=False)[0]
    hit = mine["hit"] > 0.5
    pyg, pxg = np.mgrid[0:h, 0:w].astype(np.float32)
    ro_t = tuple(torch.tensor(np.float32(v)) for v in kw["ro"])
    rd = bm.ray_dirs(_t(pxg), _t(pyg), w, h, ro_t,
                     torch.tensor(np.float32(kw["fov"])))
    t = _t(mine["t"])
    hpos = [(o + r * t).numpy()[hit].astype(np.float64)
            for o, r in zip(ro_t, rd)]
    n = [mine[k][hit].astype(np.float64) for k in ("nx", "ny", "nz")]
    ao64 = np.zeros(hit.sum())
    for k in bk.AO_KS:
        ao64 += np.exp(-10.0 * _de64(*(hp + nv * k for hp, nv in
                                        zip(hpos, n)), 8.0, ITERS))
    err = np.abs(mine["ao"][hit] - ao64)
    print(f"\nAO against float64 on {hit.sum()} hit lanes: max |diff| "
          f"{err.max():.3g}, mean {err.mean():.3g}, <= 2e-3 on "
          f"{(err <= 2e-3).mean():.4f}")
    assert hit.sum() > 100
    assert (err <= 2e-3).mean() >= 0.95, (err <= 2e-3).mean()
    assert err.mean() <= 1e-2, err.mean()


def test_band_rows_equal_whole_frame():
    # rows [13, 25) of a 36-row frame: the band starts inside a cone block
    w, h, r0, bh = 40, 36, 13, 12
    kw = dict(ro=(0.0, 0.0, 3.0), fov=1.0, power=8.0, max_iter=24,
              shade=True, device="cpu")
    full = bk.march_fields(w, h, **kw)
    band = bk.march_fields(w, bh, row0=r0, map_height=h, **kw)
    assert (full["hit"][r0:r0 + bh] > 0).any()
    for k in PLANES:
        assert torch.equal(band[k], full[k][r0:r0 + bh]), k
    scene = Scene(fractal_type=FractalType.MANDELBULB, max_iterations=24,
                  antialiasing_samples=2)
    img = mandelbulb.render(scene, w, h, device="cpu")
    fn = mandelbulb.band_render_fn(scene, w, bh, h, device="cpu")
    assert torch.equal(fn(mandelbulb.dyn_params(scene), r0),
                       img[r0:r0 + bh])


def test_march_fields_checks():
    kw = dict(ro=(0.0, 0.0, 3.0), fov=1.0, power=8.0, max_iter=8)
    with pytest.raises(ValueError, match="whole rows"):
        bk.march_fields(8, 8, row0=4, map_height=8, device="cpu", **kw)
    with pytest.raises(ValueError, match="2\\^24"):
        bk.march_fields(8, 8, device="cpu", **dict(kw, max_iter=1 << 24))
    with pytest.raises(ValueError, match="unsupported device"):
        bk.march_fields(8, 8, device="meta", **kw)
    # K4b's pixel queue (8x4 patches of 32) must fit its int32 head
    with pytest.raises(ValueError, match="too large"):
        bk.march_fields(1 << 16, 1 << 15, cone=0, device="cpu", **kw)
    f = bk.march_fields(8, 4, device="cpu", **kw)
    assert list(f) == ["hit", "t", "d", "esc"]
    f = bk.march_fields(8, 4, cone=0, shade=True, stats=True, device="cpu",
                        **kw)
    assert list(f) == [*PLANES, "msteps", "work", "warp_work"]


def test_warp_max_takes_each_8x4_patch_maximum():
    plane = torch.arange(13 * 19, dtype=torch.float32).reshape(13, 19)
    got = bk.warp_max(plane)
    for y in range(13):
        for x in range(19):
            y0, x0 = y // 4 * 4, x // 8 * 8
            assert got[y, x] == plane[y0:y0 + 4, x0:x0 + 8].max()


@pytest.mark.parametrize("size", [(1, 1), (5, 3), (37, 23), (1920, 1080)],
                         ids=str)
def test_patch_order_is_a_bijection_onto_the_frame(size):
    w, h = size
    x, y, valid = bk.patch_order_xy(w, h)
    pw, ph = bk.cdiv(w, 8), bk.cdiv(h, 4)
    assert len(x) == pw * ph * 32
    # every pixel of the frame exactly once; the rest is the ragged edges'
    # padding, outside the frame
    flat = (y[valid].long() * w + x[valid].long())
    assert torch.equal(torch.sort(flat).values, torch.arange(w * h))
    assert ((x[~valid] >= w) | (y[~valid] >= h)).all()
    # consecutive indices fill one 8x4 patch, patches row-major
    q = torch.arange(len(x)) // 32
    assert torch.equal(x // 8, (q % pw).to(x.dtype))
    assert torch.equal(y // 4, (q // pw).to(y.dtype))
    r = torch.arange(len(x)) % 32
    assert torch.equal(x % 8, (r % 8).to(x.dtype))
    assert torch.equal(y % 4, (r // 8).to(y.dtype))


def _trips_rows(rows):
    """A trips buffer from (trips, step, event, lanes, pixels, smid, start,
    end) tuples, the times split into lo/hi int32 words."""
    out = []
    for *c, t0, t1 in rows:
        words = []
        for t in (t0, t1):
            lo = np.array([t & 0xFFFFFFFF], np.uint32).view(np.int32)[0]
            words += [int(lo), t >> 32]
        out.append([*c, *words])
    return torch.tensor(out, dtype=torch.int32)


def test_decode_trips_sums_and_shares():
    base = 5 << 32  # times above 2^32 ns: the hi words count
    buf = _trips_rows([
        # four warps run together from 0 to 100; one of them runs on alone
        # to 400 (the tail: 300 of the 400 ns span)
        (10, 8, 4, 200, 32, 0, base, base + 100),
        (10, 6, 5, 100, 32, 1, base, base + 100),
        (10, 10, 2, 320, 32, 1, base, base + 100),
        (40, 30, 20, 600, 16, 2, base, base + 400),
        # a warp that finished no pixel: left out
        (3, 0, 3, 0, 0, 3, base, base + 900),
    ])
    c = bk.decode_trips(buf)
    assert c["warps"] == 4 and c["sms"] == 3
    assert (c["trips"], c["step_trips"], c["event_trips"], c["lane_steps"],
            c["pixels"]) == (70, 54, 31, 1220, 112)
    assert c["lane_util"] == pytest.approx(1220 / (32 * 54))
    assert c["event_share"] == pytest.approx(31 / 70)
    assert c["span_ns"] == 400
    assert c["tail_share"] == pytest.approx(300 / 400)


def test_decode_trips_of_one_wave_without_tail():
    # every warp ends at once: no tail
    buf = _trips_rows([(5, 5, 1, 160, 32, s, 1000, 2000) for s in range(4)])
    c = bk.decode_trips(buf)
    assert c["tail_share"] == 0.0 and c["span_ns"] == 1000
    assert c["lane_util"] == 1.0


def test_entry_points_default_to_the_card(monkeypatch):
    import inspect

    from fractalrenderer_tpu_torch.ops import (dd_escape, escape,
                                               perturbation)

    for fn in (escape.escape_fields, dd_escape.dd_escape_fields,
               perturbation.perturbation_fields, bk.march_fields,
               mandelbulb.render, mandelbulb.band_render_fn):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bk.march_fields(8, 4, ro=(0.0, 0.0, 3.0), fov=1.0, power=8.0,
                        max_iter=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        mandelbulb.render(Scene(fractal_type=FractalType.MANDELBULB), 8, 4)


_RENDER_CASES = {
    "aa1 time0 palette0": dict(),
    "aa2 time0 palette0": dict(antialiasing_samples=2),
    "aa1 time1 palette3": dict(time=1.0, palette_mode=3),
    "aa2 time1 palette3": dict(time=1.0, palette_mode=3,
                               antialiasing_samples=2),
}


@pytest.mark.parametrize("name", list(_RENDER_CASES))
def test_render_matches_jax(name):
    # the reference's own Pallas-vs-numpy contract is mean |diff| < 0.01
    # and < 8% of pixels over 0.05 (tests/test_mandelbulb.py:67-69); the
    # port comes within 5e-3 and 2%
    js = fr.Scene(fractal_type=fr.FractalType.MANDELBULB, max_iterations=24,
                  **_RENDER_CASES[name])
    img = mandelbulb.render(Scene.from_json(js.to_json()), 48, 27,
                            device="cpu")
    assert img.shape == (27, 48, 3) and img.dtype == torch.float32
    ref = np.asarray(jax_mb.render(js, 48, 27, pallas_march=True))
    diff = np.abs(img.numpy() - ref)
    print(f"\n{name}: mean |diff| {diff.mean():.3g}, max {diff.max():.3g}, "
          f"pixels over 0.05: {(diff > 0.05).any(axis=-1).mean():.4f}")
    assert diff.mean() < 5e-3, diff.mean()
    assert (diff > 0.05).any(axis=-1).mean() < 0.02
    assert img.numpy().std() > 0.02  # bulb and sky


def test_models_render_dispatches_the_bulb():
    import fractalrenderer_tpu_torch as frt

    scene = Scene(fractal_type=FractalType.MANDELBULB, max_iterations=16)
    img = frt.render(scene, 24, 16, device="cpu")
    assert torch.equal(img, mandelbulb.render(scene, 24, 16, device="cpu"))
    q = frt.render(scene, 24, 16, device="cpu", quantize=8)
    assert q.dtype == torch.uint8
    assert torch.equal(q, quantize_image(img, bit_depth=8))


@pytest.mark.parametrize("value", [8.0, 1080, -0.0, 0.0, 1e-30,
                                   (0.0, 0.0, 0.1), [0.5, 0.6, 0.8]],
                         ids=str)
def test_cached_constant_equals_a_fresh_tensor(value):
    want = torch.tensor(value, dtype=torch.float32, device="cpu")
    got = consts.f32(value, "cpu")
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.device == want.device
    # bit for bit: -0.0 keeps its sign apart from 0.0
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    builds = consts.f32.builds
    assert consts.f32(value, torch.device("cpu")) is got
    assert consts.f32.builds == builds


def test_warm_cpu_frames_build_no_constants_and_upload_once():
    scenes = [Scene(fractal_type=FractalType.MANDELBULB, max_iterations=16,
                    **kw)
              for kw in (dict(), dict(time=1.3), dict(time=0.4,
                                                      antialiasing_samples=2),
                         dict(time=2.0, palette_mode=3))]
    for s in scenes:
        mandelbulb.render(s, 24, 16, device="cpu")
    builds = mandelbulb.render.const_builds
    uploads = mandelbulb.render.param_uploads
    versions = {k: t._version for k, t in consts._CACHE.items()}
    for s in scenes * 2:
        mandelbulb.render(s, 24, 16, device="cpu", quantize=8)
    assert mandelbulb.render.const_builds == builds
    assert mandelbulb.render.param_uploads == uploads + 2 * len(scenes)
    # nothing wrote into a shared constant
    assert {k: consts._CACHE[k]._version for k in versions} == versions
    # a band counts its own copy
    mandelbulb.band_render_fn(scenes[1], 24, 5, 16, device="cpu")(
        mandelbulb.dyn_params(scenes[1]), 7)
    assert mandelbulb.render.param_uploads == uploads + 2 * len(scenes) + 1
    assert mandelbulb.render.const_builds == builds


def test_cli_mandelbulb_png(tmp_path, capsys):
    from fractalrenderer_tpu.utils.png import read_png

    out = str(tmp_path / "bulb.png")
    argv = ["render", "--device", "cpu", "--type", "mandelbulb", "--width",
            "40", "--height", "24", "--iters", "24", "--power", "6",
            "--time", "0.5", "--aa", "2", "--palette", "4", "--debug",
            "--out", out]
    assert cli.main(argv) == 0
    said = capsys.readouterr()
    assert "Rendered 40x24 Mandelbulb on cpu" in said.out
    assert "bulb power=6.0" in said.err
    scene = cli.scene_from_args(cli.build_parser().parse_args(argv))
    assert (scene.mandelbulb_power, scene.time, scene.antialiasing_samples,
            scene.palette_mode) == (6.0, 0.5, 2, 4)
    ref = to_export_orientation(quantize_image(
        mandelbulb.render(scene, 40, 24, device="cpu"),
        bit_depth=8)).numpy()
    img = read_png(out)
    assert img.shape == (24, 40, 3)
    assert np.abs(img.astype(np.int64) - ref).max() <= 1
    assert 0 < img.mean() < 255


def test_cli_mandelbulb_without_cuda_exits_2(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "x.png"
    rc = cli.main(["render", "--type", "mandelbulb", "--width", "16",
                   "--height", "8", "--device", "cuda", "--out", str(out)])
    assert rc == 2
    assert "CUDA is not available" in capsys.readouterr().err
    assert not out.exists()


def test_debug_summary_matches_jax():
    from fractalrenderer_tpu.utils.diag import scene_debug_summary as jsum
    from fractalrenderer_tpu_torch.utils.diag import scene_debug_summary

    s = fr.Scene(fractal_type=fr.FractalType.MANDELBULB, mandelbulb_power=5.5,
                 time=0.25, fov=1.2)
    assert scene_debug_summary(Scene.from_json(s.to_json())) == jsum(s)
