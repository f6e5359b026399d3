"""Kernel K3's Julia, Burning Ship and Phoenix families in the port
(``fractalrenderer_tpu_torch/ops/perturbation.py`` and
``models/deep_zoom.py``) against the JAX package, on the CPU.

- The K3 operands (41 parameters and the 2, 4 or 6 orbit streams) are
  bit-equal to the JAX ``perturbation_fields(..., _build_only=True)``
  operands for every family and delta tier, the Julia floatexp tier with
  and without the floatexp drift emission (``orbit_exp``) and at its
  21845-entry bucket; with kernel = plain version on the card
  (tests/test_torch_cuda.py) this is the bit-exact hold on the kernel.
- The plain K3 meets the exact HP per-pixel oracle at the views and bounds
  of the JAX package's twin tests: ≥ 90% of counts exact (Julia), ≥ 85%
  (the Burning Ship armada dust, the JAX test's own bound), ≥ 95% (the
  others).
- The plain K3 matches the JAX kernel run in interpret mode: ``passes``
  equal, counts equal on ≥ 98% of pixels and each within 1, and zx/zy
  within rtol 1e-3 (f32 tier) or 1e-6 (dd and floatexp tiers) where the
  counts agree.  XLA:CPU contracts multiply-adds and flushes subnormals, and
  near a Julia set or on the Burning Ship's real axis the map expands a
  one-ulp difference ≥ 3× per step, so: the f32 tier's zx/zy are compared
  on pixels that escape within 32 iterations (Julia f32 at 1e-6 differs by
  up to 6.4 relative on its interior lanes, 5.5e-4 below 32 iterations),
  and the Ship views have an odd height, so that no pixel row lies on the
  real axis, whose interior lanes iterate the fully chaotic x ↦ x² − 2.
  Measured on this repository's CPU runs: counts equal everywhere, dd and
  floatexp zx/zy bit-equal except Julia dd (2.6e-7 relative) and floatexp
  (1.7e-7).
- The deep-zoom model renders each family like the JAX model: the same
  tier flags and info, counts equal on ≥ 98% of pixels, and the quantized
  image within 1 LSB where the counts agree.
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

JC = ("-0.7", "0.27015")
# the repelling fixed point of z^2 + JC to 75 digits (test_deepzoom.py)
JZSTAR = (
    "1.484292748140190509759902440314769152069911011656749053313607708428926366189",
    "-0.137230514250178732651450854196740117783619435441039716507673181503075677979")
ARMADA = ("-1.7623025", "-0.028000625")
ANTENNA = ("-2", "0")
PHOENIX = ("0.5334632772339566", "0.05")
# the Phoenix escape-set boundary bisected from PHOENIX to ~1e-54 with
# r = -0.5 and (a non-dyadic coefficient) r = -0.51, as the JAX tests
# test_deep_phoenix_floatexp_matches_exact_oracle and
# test_deep_phoenix_floatexp_nondyadic_r_matches_exact_oracle bisect it
PHOENIX_BOUNDARY = {
    -0.5: "0.5334632772339567418393595102554605166733089273921899914820528611543455",
    -0.51: "0.5363685622288939118213416621494880258143653450622962128740227946683769",
}


def _view(family, tier, center, zoom, iters, bits, rr=-0.5, fx_emit=True):
    """(orbit, perturbation_fields keywords) of a family view, the orbit
    as the deep-zoom model computes it."""
    cx, cy = center
    if family == "julia":
        emit = tier == "fx" and fx_emit
        orb = jax_orbit.compute_orbit(*JC, bits, iters + 1, z0x=cx, z0y=cy,
                                      emit_rel=True, emit_fx=emit)
        kw = dict(julia=True, julia_z0=(float(cx), float(cy)),
                  center_x_dd=(0.0, 0.0), center_y_dd=(0.0, 0.0))
        if emit:
            orb, kw["orbit_exp"] = orb
    else:
        kind = 1 if family == "ship" else 2
        orb = jax_orbit.compute_orbit(cx, cy, bits, iters + 1, kind=kind,
                                      pp=0.0, rr=rr if kind == 2 else 0.0)
        kw = dict(center_x_dd=dd_from_string(cx),
                  center_y_dd=dd_from_string(cy))
        kw.update({"ship": True} if kind == 1
                  else dict(phoenix=True, phoenix_p=0.0, phoenix_r=rr))
    kw["max_iter"] = iters
    if tier == "fx":
        kw.update(scaled_delta=True, zoom_frac=zoom)
    else:
        kw.update(zoom_dd=dd_from_string(zoom), dd_delta=tier == "dd")
    return orb, kw


# ---------------------------------------------------------------------------
# packing: bit-equal to the JAX operands
# ---------------------------------------------------------------------------

PACK_VIEWS = {
    ("julia", "f32"): (JZSTAR, "1e-6", 300, 128),
    ("julia", "dd"): (JZSTAR, "1e-12", 300, 128),
    ("julia", "fx"): (JZSTAR, "1e-50", 400, 300),
    ("ship", "f32"): (ARMADA, "1e-5", 300, 128),
    ("ship", "dd"): (ARMADA, "1e-10", 400, 128),
    ("ship", "fx"): (ANTENNA, "1e-40", 600, 320),
    ("phoenix", "f32"): (PHOENIX, "1e-6", 400, 128),
    ("phoenix", "dd"): (PHOENIX, "1e-10", 400, 128),
    ("phoenix", "fx"): ((PHOENIX_BOUNDARY[-0.51], "0.05"), "1e-50", 400, 300),
}


def _assert_operands_equal(params, streams, launch, ops, call_kw, tier,
                           family):
    assert launch["tier"] == tier and launch["family"] == family
    assert call_kw["dd_delta"] == (tier == "dd")
    assert call_kw["scaled"] == (tier == "fx")
    assert (call_kw["julia"], call_kw["ship"], call_kw["phoenix"]) == tuple(
        family == f for f in ("julia", "ship", "phoenix"))
    ref_params = np.asarray(ops[0])
    np.testing.assert_array_equal(params.view(np.int32),
                                  ref_params[0].view(np.int32))
    # JAX operands: params, re, im, |Z|^2, re lo, im lo, re exp, im exp
    idx = {2: (1, 2), 4: (1, 2, 4, 5), 6: (1, 2, 4, 5, 6, 7)}[len(streams)]
    assert len(streams) == perturbation.n_streams(tier, family)
    for mine, k in zip(streams, idx):
        ref = np.asarray(ops[k])
        assert mine.dtype == np.float32 and mine.shape == ref.shape
        np.testing.assert_array_equal(mine.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("family,tier", list(PACK_VIEWS),
                         ids=[f"{f}-{t}" for f, t in PACK_VIEWS])
def test_operands_bit_equal_to_jax(family, tier):
    center, zoom, iters, bits = PACK_VIEWS[family, tier]
    orb, kw = _view(family, tier, center, zoom, iters, bits,
                    rr=-0.51 if tier == "fx" else -0.5)
    ops, call_kw = jax_pert.perturbation_fields(
        orb, 24, 16, float_continuation=False, rebase=True,
        _build_only=True, **kw)
    params, streams, launch = perturbation.pack_pert_operands(orb, 24, 16,
                                                              **kw)
    _assert_operands_equal(params, streams, launch, ops, call_kw, tier,
                           family)
    assert (launch["width"], launch["height"], launch["spp"]) == (24, 16, 1)


@pytest.mark.parametrize("emit", ["frexp", "orbit_exp", "bucket-21845"])
def test_julia_fx_operands_bit_equal_to_jax(emit):
    # the 6-stream drift tables: from np.frexp of a plain f64 table, from
    # the engine's floatexp emission, and with an orbit longer than the
    # Julia floatexp bucket (32768*4//6 = 21845 entries: Q_REFLEN clamps
    # to it, where the other tiers' bucket would be 32768)
    iters = 17000 if emit == "bucket-21845" else 400
    if emit == "bucket-21845":
        # packing reads values only: a synthetic 25000-entry drift table
        rng = np.random.default_rng(5)
        orb = rng.standard_normal((25000, 2)) * 1e-3
        orb[::97] = 0.0  # exact zeros take the E_ZERO exponent
        kw = dict(julia=True, julia_z0=(1.25, -0.5), center_x_dd=(0.0, 0.0),
                  center_y_dd=(0.0, 0.0), max_iter=iters, scaled_delta=True,
                  zoom_frac="1e-40",
                  orbit_exp=rng.integers(-300, 5, (25000, 2)))
    else:
        orb, kw = _view("julia", "fx", JZSTAR, "1e-50", iters, 300,
                        fx_emit=emit == "orbit_exp")
    ops, call_kw = jax_pert.perturbation_fields(
        orb, 16, 12, float_continuation=False, rebase=True,
        _build_only=True, **kw)
    params, streams, launch = perturbation.pack_pert_operands(orb, 16, 12,
                                                              **kw)
    _assert_operands_equal(params, streams, launch, ops, call_kw, "fx",
                           "julia")
    if emit == "bucket-21845":
        assert int(params[perturbation.Q_REFLEN]) == 21845 == \
            perturbation.JULIA_FX_BUCKET_MAX
        assert not call_kw["orbit_hbm"] and len(streams[0]) == 21845
        assert (streams[4][::97] == perturbation.E_ZERO).all()


def test_family_packing_guards_match_jax():
    orb, kw = _view("julia", "fx", JZSTAR, "1e-50", 60, 300, fx_emit=False)
    # a plain f64 drift table cannot carry sub-1e-290 drifts
    with pytest.raises(ValueError, match="floatexp drift"):
        perturbation.pack_pert_operands(orb, 8, 6, **dict(
            kw, zoom_frac="1e-320"))
    with pytest.raises(ValueError, match="floatexp drift"):
        jax_pert.perturbation_fields(orb, 8, 6, float_continuation=False,
                                     rebase=True, _build_only=True, **dict(
                                         kw, zoom_frac="1e-320"))
    # exponent streams outside the Julia floatexp tier
    jorb, jexp = jax_orbit.compute_orbit(*JC, 300, 50, z0x=JZSTAR[0],
                                         z0y=JZSTAR[1], emit_rel=True,
                                         emit_fx=True)
    bad = dict(kw, scaled_delta=False, dd_delta=True, zoom_frac=None,
               zoom_dd=(1e-12, 0.0), orbit_exp=jexp, max_iter=49)
    with pytest.raises(ValueError, match="orbit_exp is only valid"):
        perturbation.pack_pert_operands(jorb, 8, 6, **bad)
    with pytest.raises(ValueError, match="orbit_exp is only valid"):
        perturbation.perturbation_fields(jorb, 8, 6, rebase=True,
                                         float_continuation=False,
                                         device="cpu", **bad)
    with pytest.raises(ValueError, match="mutually exclusive"):
        perturbation.pack_pert_operands(orb, 8, 6, **dict(kw, ship=True))
    # the families run the rebasing pipeline only, with no series skip
    from fractalrenderer_tpu_torch.deepzoom.series import SeriesSkip

    dorb, dkw = _view("julia", "dd", JZSTAR, "1e-12", 60, 128)
    with pytest.raises(ValueError, match="Mandelbrot-only"):
        perturbation.pack_pert_operands(dorb, 8, 6, **dict(
            dkw, series=SeriesSkip(5, 1, 0, 0)))
    with pytest.raises(ValueError, match="rebasing pipeline"):
        perturbation.perturbation_fields(orb, 8, 6, float_continuation=True,
                                         rebase=True, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the plain K3 against the exact HP oracle (the JAX package's twin tests)
# ---------------------------------------------------------------------------

def _oracle_counts(family, center, zoom, W, H, MI, bits, rr=-0.5):
    """Exact per-pixel counts by direct HP iteration (the JAX package's
    engine) with the kernel's mapping and count convention."""
    step = Fraction(zoom) * 4 / (H * H)
    cxh, cyh = HPFloat(center[0], bits), HPFloat(center[1], bits)
    n = np.zeros((H, W), np.int64)
    for py in range(H):
        for px in range(W):
            pcx = cxh + HPFloat(step * (Fraction(px) - Fraction(W, 2)), bits)
            pcy = cyh + HPFloat(step * (Fraction(py) - Fraction(H, 2)), bits)
            if family == "julia":
                o = jax_orbit.compute_orbit(*JC, bits, MI + 1,
                                            escape_mag_sq=16.0, z0x=pcx,
                                            z0y=pcy)
            else:
                o = jax_orbit.compute_orbit(
                    pcx, pcy, bits, MI + 1, escape_mag_sq=16.0,
                    kind=1 if family == "ship" else 2, pp=0.0,
                    rr=rr if family == "phoenix" else 0.0)
            zfx, zfy = o[-1]
            n[py, px] = (len(o) - 2) if zfx * zfx + zfy * zfy > 16.0 else MI
    return n


# (family, tier, center, zoom, iterations, orbit bits, phoenix r, bound)
ORACLE_CASES = {
    # test_deep_julia_matches_exact_oracle (f64 drift, frexp streams)
    "julia-dd-1e-10": ("julia", "dd", JZSTAR, "1e-10", 300, 128, None, 0.9),
    "julia-dd-1e-20": ("julia", "dd", JZSTAR, "1e-20", 300, 192, None, 0.9),
    "julia-fx-1e-50": ("julia", "fx", JZSTAR, "1e-50", 400, 300, None, 0.9),
    # test_deep_ship_matches_exact_oracle, ..._floatexp_...
    "ship-dd-armada": ("ship", "dd", ARMADA, "1e-10", 400, 128, None, 0.85),
    "ship-fx-1e-50": ("ship", "fx", ANTENNA, "1e-50", 300, 300, None, 0.95),
    # test_deep_phoenix_matches_exact_oracle, the two floatexp tests
    "phoenix-f32-1e-6": ("phoenix", "f32", PHOENIX, "1e-6", 400, 128, -0.5,
                         0.95),
    "phoenix-dd-1e-10": ("phoenix", "dd", PHOENIX, "1e-10", 400, 128, -0.5,
                         0.95),
    "phoenix-fx-1e-50": ("phoenix", "fx", (PHOENIX_BOUNDARY[-0.5], "0.05"),
                         "1e-50", 400, 300, -0.5, 0.95),
    "phoenix-fx-r-0.51": ("phoenix", "fx", (PHOENIX_BOUNDARY[-0.51], "0.05"),
                          "1e-50", 400, 300, -0.51, 0.95),
}


@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_plain_matches_exact_oracle(case):
    family, tier, center, zoom, MI, bits, rr, bound = ORACLE_CASES[case]
    orb, kw = _view(family, tier, center, zoom, MI, bits, rr=rr or 0.0,
                    fx_emit=False)
    f = perturbation.perturbation_fields(orb, 12, 8, rebase=True,
                                         float_continuation=False,
                                         device="cpu", **kw)
    n = f["n"].numpy()
    assert not (f["want"] > 0.5).any()
    nref = _oracle_counts(family, center, zoom, 12, 8, MI, bits, rr or 0.0)
    assert len(np.unique(nref)) > 3
    exact = (n == nref).mean()
    assert exact >= bound, f"only {exact:.2%}\n{n}\n{nref}"


# ---------------------------------------------------------------------------
# the plain K3 against the JAX kernel in interpret mode
# ---------------------------------------------------------------------------

# (family, tier, center, zoom, iterations, orbit bits, phoenix r, W, H)
INTERPRET_CASES = {
    "julia-f32": ("julia", "f32", JZSTAR, "1e-6", 300, 128, None, 12, 8),
    "julia-dd": ("julia", "dd", JZSTAR, "1e-20", 300, 192, None, 12, 8),
    "julia-fx": ("julia", "fx", JZSTAR, "1e-50", 400, 300, None, 12, 8),
    "ship-f32": ("ship", "f32", ANTENNA, "1e-5", 300, 128, None, 16, 9),
    "ship-dd": ("ship", "dd", ANTENNA, "1e-10", 300, 128, None, 16, 9),
    "ship-fx": ("ship", "fx", ANTENNA, "1e-50", 300, 300, None, 16, 9),
    "phoenix-f32": ("phoenix", "f32", PHOENIX, "1e-6", 400, 128, -0.5, 12,
                    8),
    "phoenix-dd": ("phoenix", "dd", PHOENIX, "1e-10", 400, 128, -0.5, 12, 8),
    "phoenix-fx": ("phoenix", "fx", (PHOENIX_BOUNDARY[-0.51], "0.05"),
                   "1e-50", 400, 300, -0.51, 12, 8),
}


@pytest.mark.parametrize("case", list(INTERPRET_CASES))
def test_plain_matches_jax_interpret(case):
    family, tier, center, zoom, MI, bits, rr, W, H = INTERPRET_CASES[case]
    orb, kw = _view(family, tier, center, zoom, MI, bits, rr=rr or 0.0)
    kw.update(float_continuation=False, rebase=True)
    mine = perturbation.perturbation_fields(orb, W, H, device="cpu", **kw)
    ref = {k: np.asarray(v)
           for k, v in jax_pert.perturbation_fields(orb, W, H, **kw).items()}
    assert int(mine["passes"]) == int(ref["passes"]) > 1
    assert not (mine["want"] > 0.5).any() and not (ref["want"] > 0.5).any()
    n, nref = mine["n"].numpy(), ref["n"]
    assert n.dtype == np.int32 and n.shape == nref.shape == (H, W)
    assert len(np.unique(nref)) > 3
    same = n == nref
    assert same.mean() >= 0.98 and np.abs(n - nref).max() <= 1
    if tier == "f32":
        same &= n < 32
    assert same.sum() >= 8
    rtol = 1e-3 if tier == "f32" else 1e-6
    for k in ("zx", "zy"):
        np.testing.assert_allclose(mine[k].numpy()[same], ref[k][same],
                                   rtol=rtol, atol=0)
    assert not mine["glitch"].any()


# ---------------------------------------------------------------------------
# the deep-zoom model: each family against the JAX model
# ---------------------------------------------------------------------------

MODEL_SCENES = {
    "julia-dd": dict(deep_zoom_julia=True, julia_c_real=-0.7,
                     julia_c_imag=0.27015, hp_center_x=JZSTAR[0],
                     hp_center_y=JZSTAR[1], hp_zoom="1e-12",
                     max_iterations=500),
    "julia-fx": dict(deep_zoom_julia=True, julia_c_real=-0.7,
                     julia_c_imag=0.27015, hp_center_x=JZSTAR[0],
                     hp_center_y=JZSTAR[1], hp_zoom="1e-40",
                     max_iterations=200),
    "ship-dd": dict(deep_zoom_ship=True, hp_center_x=ANTENNA[0],
                    hp_center_y=ANTENNA[1], hp_zoom="1e-10",
                    max_iterations=300),
    "ship-fx": dict(deep_zoom_ship=True, hp_center_x=ANTENNA[0],
                    hp_center_y=ANTENNA[1], hp_zoom="1e-40",
                    max_iterations=200),
    "phoenix-f32": dict(deep_zoom_phoenix=True, phoenix_p=0.0,
                        phoenix_r=-0.5, hp_center_x=PHOENIX[0],
                        hp_center_y=PHOENIX[1], hp_zoom="1e-6",
                        max_iterations=400),
    "phoenix-dd": dict(deep_zoom_phoenix=True, phoenix_p=0.0,
                       phoenix_r=-0.5, hp_center_x=PHOENIX[0],
                       hp_center_y=PHOENIX[1], hp_zoom="1e-10",
                       max_iterations=400),
}


@pytest.mark.parametrize("case", list(MODEL_SCENES))
def test_render_fields_and_render_match_jax(case):
    s = Scene(fractal_type=FractalType.DEEP_ZOOM, use_perturbation=True,
              palette_mode=2, **MODEL_SCENES[case])
    js = fr.Scene.from_dict(s.to_dict())
    W, H = 16, 9
    n, zx, zy, glitch, info = deep_zoom.render_fields(s, W, H, device="cpu")
    jn, jzx, jzy, jglitch, jinfo = jax_dz.render_fields(js, W, H)
    for k in ("precision_mode", "precision_bits", "dd_delta",
              "scaled_delta", "deep_zoom_julia", "deep_zoom_ship",
              "deep_zoom_phoenix", "algorithm", "rebase_passes",
              "reference_iterations", "series_skip",
              "glitched_pixels_initial", "fallback_pixels",
              "glitched_pixels_remaining"):
        assert info[k] == jinfo[k], k
    family, tier = case.split("-")
    assert info[f"deep_zoom_{family}"]
    assert (info["dd_delta"], info["scaled_delta"]) == (tier == "dd",
                                                        tier == "fx")
    same = n == np.asarray(jn)
    assert same.mean() >= 0.98 and np.abs(n - np.asarray(jn)).max() <= 1
    assert len(np.unique(n)) > 3
    img = deep_zoom.render(s, W, H, device="cpu", quantize=8).numpy()
    ref = np.asarray(jax_dz.render(js, W, H, quantize=8))
    assert img.shape == ref.shape == (H, W, 3)
    lsb = np.abs(img.astype(np.int64) - ref.astype(np.int64))[same]
    assert lsb.max() <= 1


def test_family_hp_fallback_matches_full_render():
    # an exhausted pass budget routes the leftover lanes of a family view
    # through the HP fallback with that family's recurrence: zero flagged
    # pixels, the counts of the full render
    s = Scene(fractal_type=FractalType.DEEP_ZOOM, use_perturbation=True,
              **MODEL_SCENES["phoenix-dd"])
    n, _, _, glitch, info = deep_zoom.render_fields(s, 12, 8, max_passes=1,
                                                    device="cpu")
    assert info["fallback_pixels"] > 0 and not glitch.any()
    n_full, *_, info2 = deep_zoom.render_fields(s, 12, 8, device="cpu")
    assert info2["fallback_pixels"] == 0
    assert (n == n_full).mean() >= 0.95
    jn, *_, jinfo = jax_dz.render_fields(fr.Scene.from_dict(s.to_dict()),
                                         12, 8, max_passes=1)
    assert jinfo["fallback_pixels"] == info["fallback_pixels"]
    np.testing.assert_array_equal(n, np.asarray(jn))


def test_family_orbit_cache_keys_the_recurrence():
    # one cache shared across families keeps an orbit per recurrence
    cache = {}
    kw = dict(hp_center_x=PHOENIX[0], hp_center_y=PHOENIX[1],
              hp_zoom="1e-8", max_iterations=200)
    n_m, *_ = deep_zoom.render_fields(
        Scene(fractal_type=FractalType.DEEP_ZOOM, **kw), 8, 6,
        orbit_cache=cache, device="cpu")
    n_p, *_ = deep_zoom.render_fields(
        Scene(fractal_type=FractalType.DEEP_ZOOM, deep_zoom_phoenix=True,
              phoenix_r=-0.5, **kw), 8, 6, orbit_cache=cache, device="cpu")
    assert len(cache) == 2
    assert not np.array_equal(n_m, n_p)
    assert isinstance(n_p, np.ndarray) and not torch.is_tensor(n_p)


# ---------------------------------------------------------------------------
# the floatexp tier below the f64 floor (the JAX package's twin tests)
# ---------------------------------------------------------------------------

def _julia_fixed_point(digits):
    """The repelling fixed point z* = (1 + sqrt(1 - 4c))/2 of z² + JC as
    decimal strings with ``digits`` digits, by exact-rational complex
    Newton for w = sqrt(1 - 4c) from the f64 seed (test_deepzoom.py)."""
    import cmath

    cr, ci = Fraction(JC[0]), Fraction(JC[1])
    tr, ti = 1 - 4 * cr, -4 * ci
    w = cmath.sqrt(complex(float(tr), float(ti)))
    wr, wi = Fraction(w.real), Fraction(w.imag)
    scale = 1 << (int(digits * 3.33) + 256)

    def rnd(x):
        return Fraction(round(x * scale), scale)

    for _ in range(16):
        m2 = wr * wr + wi * wi
        qr = (tr * wr + ti * wi) / m2
        qi = (ti * wr - tr * wi) / m2
        wr, wi = rnd((wr + qr) / 2), rnd((wi + qi) / 2)
    zr, zi = (1 + wr) / 2, wi / 2
    assert abs(zr * zr - zi * zi + cr - zr) < Fraction(1, 10 ** (digits - 2))
    assert abs(2 * zr * zi + ci - zi) < Fraction(1, 10 ** (digits - 2))

    def dec(x):
        sign = "-" if x < 0 else ""
        x = abs(x)
        ip = int(x)
        return f"{sign}{ip}.{int((x - ip) * 10 ** digits):0{digits}d}"

    return dec(zr), dec(zi)


@pytest.mark.parametrize("zoom,MI,bits,digits", [
    ("1e-320", 900, 1200, 360), ("1e-400", 1150, 1500, 450)])
def test_deep_julia_below_f64_floor_matches_exact_oracle(zoom, MI, bits,
                                                         digits):
    # the floatexp drift emission carries drifts f64 cannot represent;
    # the center is the repelling fixed point to ``digits`` digits
    zc = _julia_fixed_point(digits)
    orb, oexp = jax_orbit.compute_orbit(*JC, bits, MI + 1, z0x=zc[0],
                                        z0y=zc[1], emit_rel=True,
                                        emit_fx=True)
    assert int(oexp.min()) < -1062  # drifts below the f64 range
    f = perturbation.perturbation_fields(
        orb, 12, 8, center_x_dd=(0.0, 0.0), center_y_dd=(0.0, 0.0),
        max_iter=MI, float_continuation=False, rebase=True, julia=True,
        julia_z0=(float(zc[0][:20]), float(zc[1][:20])), scaled_delta=True,
        zoom_frac=zoom, orbit_exp=oexp, device="cpu")
    n = f["n"].numpy()
    assert not (f["want"] > 0.5).any()
    nref = _oracle_counts("julia", zc, zoom, 12, 8, MI, bits)
    assert len(np.unique(nref)) > 3
    assert (n == nref).mean() >= 0.9, f"{n}\n{nref}"


def test_deep_julia_model_below_f64_floor():
    # the model picks the floatexp drift emission itself at 1e-320
    zc = _julia_fixed_point(360)
    s = Scene(fractal_type=FractalType.DEEP_ZOOM, deep_zoom_julia=True,
              julia_c_real=-0.7, julia_c_imag=0.27015, hp_center_x=zc[0],
              hp_center_y=zc[1], hp_zoom="1e-320", max_iterations=900,
              use_perturbation=True)
    n, zx, zy, g, info = deep_zoom.render_fields(s, 12, 8, device="cpu")
    assert info["precision_mode"] == "ARBITRARY"
    assert info["precision_bits"] > 1070
    assert info["glitched_pixels_remaining"] == 0
    nref = _oracle_counts("julia", zc, "1e-320", 12, 8, 900,
                          info["precision_bits"])
    assert len(np.unique(nref)) > 3
    assert (np.asarray(n) == nref).mean() >= 0.9


def test_deep_ship_below_f64_floor_matches_exact_oracle():
    # the antenna tip at 1e-320: absolute O(1) orbit, floatexp diffabs
    W, H, MI, bits, zoom = 12, 8, 620, 1200, "1e-320"
    orb = jax_orbit.compute_orbit(*ANTENNA, bits, MI + 1, kind=1)
    assert len(orb) == MI + 1
    f = perturbation.perturbation_fields(
        orb, W, H, center_x_dd=(-2.0, 0.0), center_y_dd=(0.0, 0.0),
        max_iter=MI, float_continuation=False, rebase=True, ship=True,
        scaled_delta=True, zoom_frac=zoom, device="cpu")
    n = f["n"].numpy()
    assert not (f["want"] > 0.5).any()
    nref = _oracle_counts("ship", ANTENNA, zoom, W, H, MI, bits)
    assert len(np.unique(nref)) > 3
    assert (n == nref).mean() >= 0.95, f"{n}\n{nref}"


def test_deep_phoenix_below_f64_floor_matches_exact_oracle():
    # the escape-set boundary bisected with exact rationals to ~1e-340,
    # 20 decades past the view, so the center stays interior while the
    # escape band crosses the 1e-320 view
    PP, RR = 0.0, -0.5
    W, H, MI, bits, zoom = 12, 8, 1800, 1300, "1e-320"
    cy = Fraction(PHOENIX[1])

    def interior(cxf):
        o = jax_orbit.compute_orbit(HPFloat(cxf, bits), HPFloat(cy, bits),
                                    bits, MI + 1, kind=2, pp=PP, rr=RR)
        return len(o) == MI + 1

    a = Fraction(PHOENIX[0])
    b = a + Fraction(1, 10 ** 8)
    assert interior(a) and not interior(b)
    while b - a > Fraction(1, 10 ** 340):
        m = (a + b) / 2
        if interior(m):
            a = m
        else:
            b = m
    cxh = HPFloat(a, bits)
    orb = jax_orbit.compute_orbit(cxh, HPFloat(cy, bits), bits, MI + 1,
                                  kind=2, pp=PP, rr=RR)
    assert len(orb) == MI + 1
    f = perturbation.perturbation_fields(
        orb, W, H, center_x_dd=dd_from_string(cxh.to_string(40)),
        center_y_dd=dd_from_string(PHOENIX[1]), max_iter=MI,
        float_continuation=False, rebase=True, phoenix=True, phoenix_p=PP,
        phoenix_r=RR, scaled_delta=True, zoom_frac=zoom, device="cpu")
    n = f["n"].numpy()
    assert not (f["want"] > 0.5).any()
    nref = _oracle_counts("phoenix", (cxh.to_string(340), PHOENIX[1]), zoom,
                          W, H, MI, bits, RR)
    assert len(np.unique(nref)) > 3
    assert (n == nref).mean() >= 0.95, f"{n}\n{nref}"
