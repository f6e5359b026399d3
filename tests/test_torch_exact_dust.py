"""The exact-dust tier of the port (K3's Burning Ship error ledger in
``fractalrenderer_tpu_torch/ops/perturbation.py`` and
``models/deep_zoom.render_fields(exact_dust=True)``) against the JAX
package and the exact HP oracle, on the CPU.

- The ledger launch's operands are bit-equal to the JAX
  ``perturbation_fields(..., track_err=True, _build_only=True)`` operands;
  with kernel = plain version on the card (tests/test_torch_cuda.py) this
  is the bit-exact hold on the kernel's ledger instances.
- The plain ledger ``errx`` matches the JAX kernel run in interpret mode
  within 1e-3 (log2 units) on every lane whose iteration ran the same
  arithmetic (counts, zx and zy bit-equal).  Neither CPU library's log2 is
  correctly rounded and the ledger sums up to max_iter such terms, hence
  the tolerance; XLA:CPU contracts multiply-adds, which moves the chaotic
  armada-dust lanes onto other trajectories, so those are held by the
  suspect masks instead: equal except on lanes within 1e-3 of the −8
  threshold.  XLA:CPU also flushes subnormals where PyTorch does not, so
  errx is compared only on lanes whose exact orbit keeps 4|z|² ≥ 2⁻¹²⁶.
  Measured on this repository's CPU runs: errx within 1.6e-5 on those
  lanes, suspect masks equal.
- The JAX package's twin tests hold: the exact-dust windows are 100% equal
  to the HP oracle (192 and 400 bits), with at most 40% of the window
  suspect; the model's info and counts match the JAX model's.
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
from fractalrenderer_tpu.utils.png import read_png
from fractalrenderer_tpu_torch import FractalType, Scene, cli
from fractalrenderer_tpu_torch.models import deep_zoom
from fractalrenderer_tpu_torch.ops import perturbation
from fractalrenderer_tpu_torch.ops.dd import dd_from_string

ARMADA = ("-1.7623025", "-0.028000625")
ANTENNA = ("-2", "0")


def _ship_kw(center, zoom, iters, tier):
    kw = dict(center_x_dd=dd_from_string(center[0]),
              center_y_dd=dd_from_string(center[1]), max_iter=iters,
              ship=True, rebase=True, float_continuation=False,
              track_err=True)
    if tier == "fx":
        kw.update(scaled_delta=True, zoom_frac=zoom)
    else:
        kw.update(dd_delta=True, zoom_dd=dd_from_string(zoom))
    return kw


def _exact_orbits(center, zoom, W, H, MI, bits):
    """Each pixel's exact Burning Ship orbit (the JAX package's engine),
    with the kernel's mapping dc = step·(p − size/2), step = zoom·4/H²."""
    step = Fraction(zoom) * 4 / (H * H)
    cxh, cyh = HPFloat(center[0], bits), HPFloat(center[1], bits)
    out = {}
    for py in range(H):
        for px in range(W):
            pcx = cxh + HPFloat(step * (Fraction(px) - Fraction(W, 2)), bits)
            pcy = cyh + HPFloat(step * (Fraction(py) - Fraction(H, 2)), bits)
            out[py, px] = jax_orbit.compute_orbit(pcx, pcy, bits, MI + 1,
                                                  escape_mag_sq=16.0, kind=1)
    return out


def _oracle_counts(center, zoom, W, H, MI, bits):
    """Exact counts under the kernel's convention n = #{i >= 1 : |z_i| <=
    bail} (interior: MI)."""
    n = np.zeros((H, W), np.int64)
    for (py, px), o in _exact_orbits(center, zoom, W, H, MI, bits).items():
        zfx, zfy = o[-1]
        n[py, px] = (len(o) - 2) if zfx * zfx + zfy * zfy > 16.0 else MI
    return n


# ---------------------------------------------------------------------------
# packing and the plain ledger against the JAX kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["dd", "fx"])
def test_ledger_operands_bit_equal_to_jax(tier):
    center, zoom, iters, bits = ((ARMADA, "1e-10", 400, 192) if tier == "dd"
                                 else (ANTENNA, "1e-40", 600, 320))
    orb = jax_orbit.compute_orbit(*center, bits, iters + 1, kind=1)
    kw = _ship_kw(center, zoom, iters, tier)
    ops, call_kw = jax_pert.perturbation_fields(orb, 24, 9, _build_only=True,
                                                **kw)
    assert call_kw["track_err"] is True
    params, streams, launch = perturbation.pack_pert_operands(orb, 24, 9,
                                                              **kw)
    assert (launch["family"], launch["tier"], launch["form"]) == (
        "ship", tier, "ledger")
    np.testing.assert_array_equal(params.view(np.int32),
                                  np.asarray(ops[0])[0].view(np.int32))
    for mine, k in zip(streams, (1, 2, 4, 5), strict=True):
        np.testing.assert_array_equal(mine.view(np.int32),
                                      np.asarray(ops[k]).view(np.int32))


# (center, zoom, iterations, orbit bits, tier, W, H)
ERRX_CASES = {
    "dd-antenna": (ANTENNA, "1e-10", 300, 128, "dd", 16, 9),
    "fx-antenna": (ANTENNA, "1e-40", 600, 320, "fx", 16, 9),
    "dd-armada": (ARMADA, "1e-10", 150, 192, "dd", 16, 9),
}


@pytest.mark.parametrize("case", list(ERRX_CASES))
def test_errx_matches_jax_interpret(case):
    center, zoom, MI, bits, tier, W, H = ERRX_CASES[case]
    orb = jax_orbit.compute_orbit(*center, bits, MI + 1, kind=1)
    kw = _ship_kw(center, zoom, MI, tier)
    mine = {k: v.numpy() for k, v in perturbation.perturbation_fields(
        orb, W, H, device="cpu", **kw).items()}
    ref = {k: np.asarray(v)
           for k, v in jax_pert.perturbation_fields(orb, W, H, **kw).items()}
    assert mine["errx"].dtype == np.float32 and mine["errx"].shape == (H, W)
    # lanes that ran the same arithmetic, whose exact path stays normal
    same = ((mine["n"] == ref["n"]) & (mine["zx"] == ref["zx"])
            & (mine["zy"] == ref["zy"]))
    if same.all():
        assert int(mine["passes"]) == int(ref["passes"])
    normal = np.zeros((H, W), bool)
    for (py, px), o in _exact_orbits(center, zoom, W, H, MI, bits).items():
        normal[py, px] = (4.0 * (o[1:] ** 2).sum(1)).min() >= 2.0 ** -126
    held = same & normal
    assert held.mean() >= 0.5
    np.testing.assert_allclose(mine["errx"][held], ref["errx"][held],
                               rtol=0, atol=1e-3)
    sus, ref_sus = mine["errx"] > -8.0, ref["errx"] > -8.0
    near = np.abs(ref["errx"] + 8.0) <= 1e-3
    np.testing.assert_array_equal(sus[~near], ref_sus[~near])
    if case == "dd-armada":
        assert sus.any() and not sus.all()  # the dust has suspects


def test_ledger_leaves_the_other_planes_alone():
    # the ledger is an extra plane: n, zx, zy, want and rounds are the
    # rebasing launch's
    orb = jax_orbit.compute_orbit(*ARMADA, 192, 401, kind=1)
    kw = _ship_kw(ARMADA, "1e-10", 400, "dd")
    led = perturbation.perturbation_fields(orb, 12, 9, device="cpu", **kw)
    plain = perturbation.perturbation_fields(
        orb, 12, 9, device="cpu", **dict(kw, track_err=False))
    assert "errx" not in plain
    for k in ("n", "zx", "zy", "want", "rounds_plane"):
        assert torch.equal(led[k], plain[k]), k


# ---------------------------------------------------------------------------
# the exact-dust tier through the model (the JAX package's twin tests)
# ---------------------------------------------------------------------------

def _ship_scene(center, zoom, iters, **kw):
    return Scene(fractal_type=FractalType.DEEP_ZOOM, deep_zoom_ship=True,
                 hp_center_x=center[0], hp_center_y=center[1],
                 hp_zoom=zoom, max_iterations=iters, use_perturbation=True,
                 **kw)


def test_deep_ship_exact_dust_tier():
    # twin of test_deep_ship_exact_dust_tier: the armada dust, where the
    # plain dd tier holds ~93%, pinned to the 192-bit oracle everywhere
    W, H, MI = 12, 8, 400
    s = _ship_scene(ARMADA, "1e-10", MI)
    n, _, _, g, info = deep_zoom.render_fields(s, W, H, exact_dust=True,
                                               device="cpu")
    assert info["precision_bits"] >= 160  # the raised orbit table
    assert not g.any() and info["glitched_pixels_remaining"] == 0
    assert 0 < info["dust_suspect_pixels"] <= int(0.4 * W * H)
    assert info["fallback_pixels"] == info["dust_suspect_pixels"]
    nref = _oracle_counts(ARMADA, "1e-10", W, H, MI, 192)
    np.testing.assert_array_equal(n, nref)
    with pytest.raises(ValueError, match="Burning Ship"):
        deep_zoom.render_fields(
            Scene(fractal_type=FractalType.DEEP_ZOOM, hp_zoom="1e-8",
                  use_perturbation=True), 8, 6, exact_dust=True,
            device="cpu")


def test_deep_ship_exact_dust_scaled_tier():
    # twin of test_deep_ship_exact_dust_scaled_tier: the floatexp ledger
    # at the antenna tip, 1e-40, straddling the boundary
    MI = 1500
    s = _ship_scene(ANTENNA, "1e-40", MI)
    n, _, _, g, info = deep_zoom.render_fields(s, 12, 8, exact_dust=True,
                                               device="cpu")
    assert info["precision_mode"] == "ARBITRARY"
    assert not g.any() and info["glitched_pixels_remaining"] == 0
    nref = _oracle_counts(ANTENNA, "1e-40", 12, 8, MI, 400)
    assert len(np.unique(nref)) >= 5
    np.testing.assert_array_equal(n, nref)
    assert info["dust_suspect_pixels"] <= int(0.4 * 96)


def test_exact_dust_model_matches_jax():
    s = _ship_scene(ARMADA, "1e-10", 300, palette_mode=2)
    js = fr.Scene.from_dict(s.to_dict())
    n, zx, zy, g, info = deep_zoom.render_fields(s, 16, 9, exact_dust=True,
                                                 device="cpu")
    jn, jzx, jzy, jg, jinfo = jax_dz.render_fields(js, 16, 9,
                                                   exact_dust=True)
    for k in ("precision_mode", "precision_bits", "dd_delta", "algorithm",
              "reference_iterations", "references_used",
              "glitched_pixels_remaining"):
        assert info[k] == jinfo[k], k
    # the suspects re-render exactly on both sides; XLA's contraction moves
    # chaotic dust lanes (and with them the rounds they take), so counts
    # and suspect totals are held loosely here and exactly in the oracle
    # twins above
    assert abs(info["dust_suspect_pixels"] - jinfo["dust_suspect_pixels"]) \
        <= 1
    assert (n == np.asarray(jn)).mean() >= 0.9
    assert isinstance(n, np.ndarray) and not g.any()


def test_exact_dust_keeps_suspects_off_the_device_return():
    # keep_device must not return the kernel's planes before the suspects
    # are re-rendered (the JAX model skips that return under exact_dust)
    s = _ship_scene(ARMADA, "1e-10", 300)
    n, *_, info = deep_zoom.render_fields(s, 12, 8, exact_dust=True,
                                          keep_device=True, device="cpu")
    assert info["dust_suspect_pixels"] > 0
    assert "fields_on_device" not in info and isinstance(n, np.ndarray)
    n2, *_ = deep_zoom.render_fields(s, 12, 8, exact_dust=True,
                                     device="cpu")
    np.testing.assert_array_equal(n, n2)


def test_exact_dust_stacked_spp_matches_sequential_samples():
    # --spp 2 --exact-dust: the stacked launch carries the ledger per
    # segment, and each segment's suspects re-render at its own offset
    s = _ship_scene(ARMADA, "1e-10", 200)
    n, *_, info = deep_zoom.render_fields(s, 12, 8, aa_spp=2,
                                          exact_dust=True, device="cpu")
    assert n.shape == (4, 8, 12) and info["fallback_pixels"] > 0
    for smp in range(4):
        off = ((smp % 2) / 2, (smp // 2) / 2)
        ns, *_ = deep_zoom.render_fields(s, 12, 8, offset=off,
                                         exact_dust=True, device="cpu")
        np.testing.assert_array_equal(n[smp], ns)
    img = deep_zoom.render(s.with_(samples_per_pixel=2), 12, 8,
                           exact_dust=True, device="cpu")
    assert img.shape == (8, 12, 3) and bool(torch.isfinite(img).all())


def test_exact_dust_cli_renders_png(tmp_path, capsys):
    from fractalrenderer_tpu_torch import models
    from fractalrenderer_tpu_torch.utils.image import to_export_orientation

    out = str(tmp_path / "dust.png")
    argv = ["render", "--device", "cpu", "--width", "24", "--height", "16",
            "--type", "deep-zoom", "--deep-ship", "--exact-dust",
            "--hp-center-x", ARMADA[0], "--hp-center-y", ARMADA[1],
            "--hp-zoom", "1e-10", "--iters", "200", "--out", out]
    assert cli.main(argv) == 0
    said = capsys.readouterr().out
    assert "HP-fallback, 0 remaining" in said and " 0 HP-fallback" not in said
    scene = cli.scene_from_args(cli.build_parser().parse_args(argv))
    ref = to_export_orientation(models.render(
        scene, 24, 16, device="cpu", quantize=8, exact_dust=True)).numpy()
    np.testing.assert_array_equal(read_png(out), ref)
