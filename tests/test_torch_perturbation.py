"""The port's deep-zoom host side and the plain version of kernel K3
(``fractalrenderer_tpu_torch/ops/perturbation.py``) against the JAX
package, on the CPU.

- The host copies (reference orbits from both engines, the series skip,
  the precision tiers) agree with the JAX package's bit for bit.
- The K3 operands (41 parameters and the orbit streams) are bit-equal to
  the JAX ``perturbation_fields(..., _build_only=True)`` operands in each
  delta tier, with and without the series skip and on a row band; this and
  kernel = plain version on the card (tests/test_torch_cuda.py) are the
  bit-exact hold on the kernel.
- The plain K3 meets the exact HP per-pixel oracle (the JAX package's
  engine) at the bounds of the JAX tests, and matches the JAX kernel run in
  interpret mode.  XLA:CPU may contract multiply-adds, so that comparison
  has a tolerance: counts on at most 2% of pixels, each by at most 1, and
  zx/zy within rtol 1e-3 (f32 deltas) or 1e-6 (dd and floatexp deltas)
  where the counts agree.  Measured on this repository's CPU runs: no count
  differs in any tier, zx/zy are bit-equal in the dd and floatexp tiers and
  within 3.2e-4 relative in the f32 tier, and ``passes`` is equal.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

from fractalrenderer_tpu.deepzoom import hp as jax_hp
from fractalrenderer_tpu.deepzoom import orbit as jax_orbit
from fractalrenderer_tpu.deepzoom import series as jax_series
from fractalrenderer_tpu.ops import perturbation as jax_pert
from fractalrenderer_tpu_torch.deepzoom import hp, orbit, series
from fractalrenderer_tpu_torch.ops import perturbation
from fractalrenderer_tpu_torch.ops.dd import dd_from_string

SEAHORSE = ("-0.74364388703715158", "0.13182590420531198")
C_I = ("0", "1")  # Misiurewicz point c = i: structure at every depth
# a reference that escapes at 448 iterations, far before the budget
STARVING = ("-0.77568377", "0.13646737")

# tier: (center, zoom, iterations, orbit bits, perturbation options)
TIERS = {
    "f32": (SEAHORSE, "1e-6", 600, 64, {}),
    "dd": (SEAHORSE, "1e-12", 600, 128, dict(dd_delta=True)),
    "fx": (C_I, "1e-50", 400, 320, dict(scaled_delta=True,
                                        zoom_frac="1e-50")),
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


def _view_kw(center, zoom, iters, opts):
    kw = dict(center_x_dd=dd_from_string(center[0]),
              center_y_dd=dd_from_string(center[1]), max_iter=iters, **opts)
    if "zoom_frac" not in opts:
        kw["zoom_dd"] = dd_from_string(zoom)
    return kw


# ---------------------------------------------------------------------------
# host copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("force_python", [False, True],
                         ids=["native", "python"])
@pytest.mark.parametrize("center,bits,entries", [
    (SEAHORSE, 64, 600), (SEAHORSE, 128, 600), (C_I, 300, 401),
], ids=["seahorse-64", "seahorse-128", "c=i-300"])
def test_orbit_bit_equal_to_jax(center, bits, entries, force_python):
    mine = orbit.compute_orbit(*center, bits, entries,
                               force_python=force_python)
    ref = jax_orbit.compute_orbit(*center, bits, entries,
                                  force_python=force_python)
    assert mine.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(mine, ref)
    # the two engines agree with each other too
    np.testing.assert_array_equal(
        mine, orbit.compute_orbit(*center, bits, entries,
                                  force_python=not force_python))


def test_orbit_progress_hook_reports(monkeypatch):
    seen = []
    monkeypatch.setattr(orbit, "progress_hook",
                        lambda done, total: seen.append((done, total)))
    orbit.compute_orbit(*C_I, 128, 401, force_python=True)
    assert seen and all(t == 401 for _, t in seen)


@pytest.mark.parametrize("tier", ["f32", "dd"])
def test_series_skip_matches_jax(orbits, tier):
    center, zoom, iters, bits, _ = TIERS[tier]
    orb = orbits(center, bits, iters + 1)
    dc_max = float(zoom) * 4.0 / 32 * 0.9
    mine = series.compute_series_skip(orb, dc_max)
    ref = jax_series.compute_series_skip(orb, dc_max)
    assert mine.n_skip > 10
    assert (mine.n_skip, mine.a, mine.b, mine.c) == \
        (ref.n_skip, ref.a, ref.b, ref.c)


def test_series_skip_fx_matches_jax(orbits):
    center, zoom, iters, bits, _ = TIERS["fx"]
    orb = orbits(center, bits, iters + 1)
    dc_max = Fraction(zoom) * 4 * Fraction(0.9) / 32
    mine = series.compute_series_skip_fx(orb, dc_max)
    ref = jax_series.compute_series_skip_fx(orb, dc_max)
    assert mine.n_skip > 10
    assert mine == series.SeriesSkipFX(*(getattr(ref, f) for f in (
        "n_skip", "a", "a_e", "b", "b_e", "c", "c_e")))


@pytest.mark.parametrize("zoom", ["1e-6", "1e-12", "1e-20", "1e-50",
                                  "1e-500"])
def test_precision_mode_matches_jax(zoom):
    mode, bits = hp.precision_mode_for_zoom_frac(Fraction(zoom))
    ref_mode, ref_bits = jax_hp.precision_mode_for_zoom_frac(Fraction(zoom))
    assert (mode.name, bits) == (ref_mode.name, ref_bits)


def test_pow2_and_expo_match_jax():
    import jax.numpy as jnp

    k = np.arange(-300, 301, dtype=np.int32)
    mine = perturbation._pow2(torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(mine.view(np.int32),
                                  np.asarray(jax_pert._pow2(jnp.asarray(k)))
                                  .view(np.int32))
    x = np.random.default_rng(3).standard_normal(1000).astype(np.float32)
    x *= np.float32(2.0) ** np.arange(-60, 60, 0.12)[:1000].astype(
        np.float32)
    np.testing.assert_array_equal(
        perturbation._expo(torch.from_numpy(x)).numpy(),
        np.asarray(jax_pert._expo(jnp.asarray(x))))


# ---------------------------------------------------------------------------
# packing: bit-equal to the JAX operands
# ---------------------------------------------------------------------------

def _jax_series(tier, orb, zoom, height):
    dc_max = Fraction(zoom) * 4 * Fraction(0.9) / height
    if tier == "fx":
        return (jax_series.compute_series_skip_fx(orb, dc_max),
                series.compute_series_skip_fx(orb, dc_max))
    return (jax_series.compute_series_skip(orb, float(dc_max)),
            series.compute_series_skip(orb, float(dc_max)))


@pytest.mark.parametrize("band", [False, True], ids=["frame", "band"])
@pytest.mark.parametrize("with_series", [False, True],
                         ids=["no-series", "series"])
@pytest.mark.parametrize("tier", ["f32", "dd", "fx"])
def test_operands_bit_equal_to_jax(orbits, tier, with_series, band):
    center, zoom, iters, bits, opts = TIERS[tier]
    orb = orbits(center, bits, iters + 1)
    W, H = 24, 16
    kw = _view_kw(center, zoom, iters, opts)
    if band:
        kw.update(row0=5.0, map_height=40)
    jax_s = mine_s = None
    if with_series:
        jax_s, mine_s = _jax_series(tier, orb, zoom, kw.get("map_height", H))
        assert mine_s.n_skip > 1
    ops, call_kw = jax_pert.perturbation_fields(
        orb, W, H, float_continuation=False, rebase=True, series=jax_s,
        _build_only=True, **kw)
    params, streams, launch = perturbation.pack_pert_operands(
        orb, W, H, series=mine_s, **kw)
    assert (launch["tier"], launch["family"], launch["spp"]) == (tier,
                                                                 "mandelbrot", 1)
    assert call_kw["dd_delta"] == (tier == "dd")
    assert call_kw["scaled"] == (tier == "fx")
    ref_params = np.asarray(ops[0])
    assert ref_params.shape == (1, perturbation.NQ)
    np.testing.assert_array_equal(params.view(np.int32),
                                  ref_params[0].view(np.int32))
    ref_streams = [np.asarray(ops[i]) for i in (1, 2, 4, 5)]
    assert len(streams) == (2 if tier == "f32" else 4)
    for mine, ref in zip(streams, ref_streams):
        assert mine.dtype == np.float32
        np.testing.assert_array_equal(mine.view(np.int32), ref.view(np.int32))


def test_packing_errors_match_jax(orbits):
    orb = orbits(SEAHORSE, 64, 601)
    kw = _view_kw(SEAHORSE, "1e-6", 600, {})
    with pytest.raises(ValueError, match="max_iter must be < 2"):
        perturbation.pack_pert_operands(orb, 8, 8, **dict(kw,
                                                          max_iter=1 << 24))
    s = series.compute_series_skip(orb, 1e-6 * 4 / 8)
    with pytest.raises(ValueError, match="bailout >= 4"):
        perturbation.pack_pert_operands(orb, 8, 8, series=s, bailout=2.0,
                                        **kw)


@pytest.mark.parametrize("kw,match", [
    # the families, stacked AA, the error ledger and the single pass run
    # (test_family_and_aa_arguments_run, test_torch_exact_dust.py,
    # test_torch_pert_single.py); outside their domain the JAX package's
    # own guards refuse them
    (dict(julia=True, track_err=True), "error ledger"),
    (dict(ship=True, track_err=True), "error ledger"),  # the f32 tier
    (dict(phoenix=True, track_err=True), "error ledger"),
    (dict(aa_spp=2, rebase=False), "requires the rebasing pipeline"),
    (dict(track_err=True), "error ledger"),
    (dict(rebase=False, phoenix=True), "require the rebasing pipeline"),
    (dict(float_continuation=True), "rebasing supersedes"),
], ids=str)
def test_unported_arguments_raise(orbits, kw, match):
    orb = orbits(SEAHORSE, 64, 601)
    args = dict(_view_kw(SEAHORSE, "1e-6", 600, {}),
                float_continuation=False, rebase=True)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        perturbation.perturbation_fields(orb, 8, 8, device="cpu", **args)


@pytest.mark.parametrize("kw", [
    dict(julia=True, julia_z0=(-0.74, 0.13)), dict(ship=True),
    dict(phoenix=True, phoenix_r=-0.5), dict(aa_spp=2),
], ids=str)
def test_family_and_aa_arguments_run(orbits, kw):
    # the arguments that raised before the families and stacked AA were
    # ported now render (any table serves as the orbit here; the families'
    # own orbits are in test_torch_pert_families.py)
    orb = orbits(SEAHORSE, 64, 601)
    args = dict(_view_kw(SEAHORSE, "1e-6", 600, {}),
                float_continuation=False, rebase=True, **kw)
    f = perturbation.perturbation_fields(orb, 8, 6, device="cpu", **args)
    shape = (4, 6, 8) if "aa_spp" in kw else (6, 8)
    assert f["n"].shape == f["zx"].shape == f["rounds_plane"].shape == shape
    assert torch.isfinite(f["zx"]).all() and int(f["passes"]) >= 1


# ---------------------------------------------------------------------------
# the plain K3 against the exact oracle and against the JAX kernel
# ---------------------------------------------------------------------------

def _hp_oracle_counts(cx, cy, zoom, W, H, MI, bits, bail=4.0):
    """Exact per-pixel counts by direct HP iteration (the JAX package's
    engine) with the kernel's mapping dc = step*(p - size/2), step =
    zoom*4/H^2, and count convention n = #{i>=1 : |z_i| <= bail}."""
    step = Fraction(zoom) * 4 / (H * H)
    cx_hp, cy_hp = jax_hp.HPFloat(cx, bits), jax_hp.HPFloat(cy, bits)
    n = np.zeros((H, W), np.int64)
    bail2 = bail * bail
    for py in range(H):
        for px in range(W):
            pcx = cx_hp + jax_hp.HPFloat(step * (Fraction(px)
                                                 - Fraction(W, 2)), bits)
            pcy = cy_hp + jax_hp.HPFloat(step * (Fraction(py)
                                                 - Fraction(H, 2)), bits)
            o = jax_orbit.compute_orbit(pcx, pcy, bits, MI + 1,
                                        escape_mag_sq=bail2)
            zfx, zfy = o[-1]
            escaped = zfx * zfx + zfy * zfy > bail2
            n[py, px] = (len(o) - 2) if escaped else MI
    return n


ORACLE_CASES = {
    # the views of test_deepzoom.py's test_rebase_matches_exact_oracle
    "f32": ("1e-8", 300, 128, {}),
    "dd": ("1e-8", 300, 128, dict(dd_delta=True)),
    "fx": ("1e-50", 400, 300, dict(scaled_delta=True, zoom_frac="1e-50")),
}


@pytest.fixture(scope="module")
def c_i_runs(orbits):
    """The plain K3 and the JAX kernel (interpret mode) on the c = i
    views, 16x12, once per tier."""
    runs = {}

    def get(tier):
        if tier not in runs:
            zoom, MI, bits, opts = ORACLE_CASES[tier]
            orb = orbits(C_I, bits, MI + 1)
            kw = dict(_view_kw(C_I, zoom, MI, opts),
                      float_continuation=False, rebase=True)
            mine = perturbation.perturbation_fields(orb, 16, 12,
                                                    device="cpu", **kw)
            ref = jax_pert.perturbation_fields(orb, 16, 12, **kw)
            runs[tier] = (mine, {k: np.asarray(v) for k, v in ref.items()})
        return runs[tier]

    return get


@pytest.mark.parametrize("tier", ["f32", "dd", "fx"])
def test_rebase_matches_exact_oracle(c_i_runs, tier):
    zoom, MI, bits, _ = ORACLE_CASES[tier]
    mine, _ = c_i_runs(tier)
    n = mine["n"].numpy()
    assert not (mine["want"] > 0.5).any()
    nref = _hp_oracle_counts("0", "1", zoom, 16, 12, MI, bits)
    assert len(np.unique(nref)) > 3
    assert (n == nref).mean() >= 0.95, f"{n}\n{nref}"
    assert np.abs(n - nref).max() <= 1


@pytest.mark.parametrize("tier", ["f32", "dd", "fx"])
def test_plain_matches_jax_interpret(c_i_runs, tier):
    mine, ref = c_i_runs(tier)
    assert int(mine["passes"]) == int(ref["passes"]) > 1
    assert not (mine["want"] > 0.5).any() and not (ref["want"] > 0.5).any()
    n, nref = mine["n"].numpy(), ref["n"]
    assert n.dtype == np.int32 and n.shape == nref.shape == (12, 16)
    same = n == nref
    assert same.mean() >= 0.98 and np.abs(n - nref).max() <= 1
    rtol = 1e-3 if tier == "f32" else 1e-6
    for k in ("zx", "zy"):
        np.testing.assert_allclose(mine[k].numpy()[same], ref[k][same],
                                   rtol=rtol, atol=0)
    # the TPU plane is per tile; its max is the port's max over pixels
    assert float(mine["rounds_plane"].max()) == float(ref["rounds_plane"]
                                                      .max())
    assert not mine["glitch"].any()


def test_rebase_handles_starving_reference(orbits):
    # The reference escapes at 448 iterations; rebasing restarts starved
    # lanes at orbit index 0, so one orbit renders the whole view.
    cx, cy = STARVING
    zoom, W, H, MI, bits = "1e-10", 48, 32, 2500, 128
    orb = orbits(STARVING, bits, MI + 1)
    assert len(orb) < 500
    f = perturbation.perturbation_fields(
        orb, W, H, center_x_dd=dd_from_string(cx),
        center_y_dd=dd_from_string(cy), zoom_dd=dd_from_string(zoom),
        max_iter=MI, float_continuation=False, dd_delta=True, rebase=True,
        device="cpu")
    n = f["n"].numpy()
    assert not (f["want"] > 0.5).any()
    assert int(f["passes"]) > 2  # really multi-round
    nref = _hp_oracle_counts(cx, cy, zoom, W, H, MI, bits)
    assert len(np.unique(nref)) > 100  # rich structure
    assert (n == nref).mean() >= 0.99


@pytest.mark.parametrize("tier", ["f32", "dd", "fx"])
def test_row_band_equals_frame_rows(orbits, tier):
    center, zoom, iters, bits, opts = TIERS[tier]
    orb = orbits(center, bits, iters + 1)
    kw = dict(_view_kw(center, zoom, iters, opts), float_continuation=False,
              rebase=True)
    full = perturbation.perturbation_fields(orb, 20, 14, device="cpu", **kw)
    band = perturbation.perturbation_fields(orb, 20, 5, row0=6.0,
                                            map_height=14, device="cpu",
                                            **kw)
    for k in ("n", "zx", "zy", "want", "rounds_plane"):
        assert torch.equal(band[k], full[k][6:11]), k


def test_max_passes_leaves_want_lanes(orbits):
    cx, cy = STARVING
    orb = orbits(STARVING, 128, 2501)
    kw = dict(center_x_dd=dd_from_string(cx), center_y_dd=dd_from_string(cy),
              zoom_dd=dd_from_string("1e-10"), max_iter=2500,
              float_continuation=False, dd_delta=True, rebase=True)
    f = perturbation.perturbation_fields(orb, 12, 8, max_passes=1,
                                         device="cpu", **kw)
    assert int(f["passes"]) == 1 and (f["want"] > 0.5).any()
    ref = jax_pert.perturbation_fields(orb, 12, 8, max_passes=1, **kw)
    np.testing.assert_array_equal(f["want"].numpy(), np.asarray(ref["want"]))


def test_launch_validation():
    params = np.zeros(perturbation.NQ, np.float32)
    params[perturbation.Q_LIMIT] = 10
    streams = (np.zeros(256, np.float32),) * 2
    kw = dict(tier="f32", width=4, height=4, map_height=4, max_passes=4,
              device="cpu")
    with pytest.raises(ValueError, match="takes 4 orbit streams"):
        perturbation.perturbation_fields_plain(params, streams,
                                               **dict(kw, tier="dd"))
    with pytest.raises(ValueError, match="band rows"):
        perturbation.perturbation_fields_plain(params, streams,
                                               **dict(kw, map_height=3))
    with pytest.raises(ValueError, match="max_passes"):
        perturbation.perturbation_fields_plain(params, streams,
                                               **dict(kw, max_passes=0))
    with pytest.raises(ValueError, match="needs a CUDA device"):
        perturbation.perturbation_fields_cuda(params, streams, **kw)


@pytest.mark.parametrize("tier,family,width", [
    ("f32", "mandelbrot", 2), ("dd", "ship", 4), ("fx", "phoenix", 4),
    ("fx", "julia", 8)])
def test_orbit_table_interleaves_the_streams(tier, family, width):
    # the kernel's table (csrc/pert_kernel.cuh orbit_width, orbit_entry):
    # entry i holds stream k's element i at float k, then zeros
    rng = np.random.default_rng(3)
    n = perturbation.n_streams(tier, family)
    streams = [torch.from_numpy(rng.standard_normal(37).astype(np.float32))
               for _ in range(n)]
    table = perturbation._orbit_table(streams, tier, family)
    assert table.shape == (37, width) and table.is_contiguous()
    assert table.dtype == torch.float32
    for k, s in enumerate(streams):
        assert torch.equal(table[:, k], s)
    assert not table[:, n:].any()
