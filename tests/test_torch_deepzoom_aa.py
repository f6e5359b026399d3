"""Stacked spp² supersampling of kernel K3 (``aa_spp``), its colouring and
the deep-zoom CLI paths of the Julia, Burning Ship and Phoenix families and
``--spp`` in the port, against the JAX package, on the CPU.

- The stacked operands are bit-equal to the JAX ``_build_only`` operands
  (parameters with Q_ROW0 = 0 and the band's first row in Q_AROW0, and the
  streams), and the launch geometry (spp, band rows, full image height)
  equals the JAX ``aa_stack`` less its tile-padded segment height: a GPU
  block never straddles segments, so the port pads nothing.
- Each stacked segment is bit-equal to a sequential plain render at its
  subpixel offset, and a stacked row band equals the stacked frame's rows.
- The stacked plain K3 matches the JAX kernel in interpret mode as
  test_torch_perturbation.py states (counts equal on ≥ 98%, each within 1;
  zx/zy within rtol 1e-6 where the counts agree in the dd tier).
- The model (stacked and sequential render branches, the stacked HP
  fallback) matches the JAX model: counts equal, images within 1 LSB;
  ``color_avg_device`` is within 1e-5 of the JAX device colorer (CPU libm
  and XLA round log/sqrt an ulp apart, see test_torch_deepzoom.py), and the
  port's three averaging paths give the same bits.
- ``cli render --type deep-zoom`` with ``--deep-julia``, ``--deep-ship``,
  ``--deep-phoenix`` and ``--spp 2`` writes PNGs within 1 LSB of the JAX
  CLI's.
"""
import numpy as np
import pytest
import torch

import fractalrenderer_tpu as fr
from fractalrenderer_tpu.deepzoom import orbit as jax_orbit
from fractalrenderer_tpu.models import deep_zoom as jax_dz
from fractalrenderer_tpu.ops import coloring as jax_coloring
from fractalrenderer_tpu.ops import perturbation as jax_pert
from fractalrenderer_tpu.utils.png import read_png
from fractalrenderer_tpu_torch import FractalType, Scene, cli
from fractalrenderer_tpu_torch.models import deep_zoom
from fractalrenderer_tpu_torch.ops import perturbation
from fractalrenderer_tpu_torch.ops.coloring import ColorParams
from fractalrenderer_tpu_torch.ops.dd import dd_from_string

# the Misiurewicz point c = i: escape-count structure at every depth
C_I = ("0", "1")
JC = ("-0.7", "0.27015")
JZSTAR = (
    "1.484292748140190509759902440314769152069911011656749053313607708428926366189",
    "-0.137230514250178732651450854196740117783619435441039716507673181503075677979")


def _kw(family, tier, center, zoom, iters, bits):
    """(orbit, perturbation_fields keywords) of a Mandelbrot, Julia or
    Phoenix view."""
    cx, cy = center
    if family == "julia":
        orb = jax_orbit.compute_orbit(*JC, bits, iters + 1, z0x=cx, z0y=cy,
                                      emit_rel=True, emit_fx=tier == "fx")
        kw = dict(julia=True, julia_z0=(float(cx), float(cy)),
                  center_x_dd=(0.0, 0.0), center_y_dd=(0.0, 0.0))
        if tier == "fx":
            orb, kw["orbit_exp"] = orb
    else:
        kind = 2 if family == "phoenix" else 0
        orb = jax_orbit.compute_orbit(cx, cy, bits, iters + 1, kind=kind,
                                      rr=-0.5 if kind else 0.0)
        kw = dict(center_x_dd=dd_from_string(cx),
                  center_y_dd=dd_from_string(cy))
        if kind:
            kw.update(phoenix=True, phoenix_r=-0.5)
    kw["max_iter"] = iters
    if tier == "fx":
        kw.update(scaled_delta=True, zoom_frac=zoom)
    else:
        kw.update(zoom_dd=dd_from_string(zoom), dd_delta=tier == "dd")
    return orb, kw


VIEWS = {
    "mandelbrot-dd": ("mandelbrot", "dd", C_I, "1e-8", 300, 128),
    "julia-dd": ("julia", "dd", JZSTAR, "1e-10", 200, 128),
    "julia-fx": ("julia", "fx", JZSTAR, "1e-40", 200, 256),
    "phoenix-f32": ("phoenix", "f32", ("0.5334632772339566", "0.05"), "1e-6",
                    300, 128),
}


@pytest.mark.parametrize("view,spp,band", [
    ("mandelbrot-dd", 2, None), ("mandelbrot-dd", 4, (5, 7)),
    ("julia-fx", 2, (3, 6)), ("phoenix-f32", 4, None),
], ids=str)
def test_stacked_operands_bit_equal_to_jax(view, spp, band):
    orb, kw = _kw(*VIEWS[view])
    kw["aa_spp"] = spp
    W, H = 24, 16
    if band:
        kw.update(row0=float(band[0]), map_height=H)
        H = band[1]
    ops, call_kw = jax_pert.perturbation_fields(
        orb, W, H, float_continuation=False, rebase=True, _build_only=True,
        **kw)
    params, streams, launch = perturbation.pack_pert_operands(orb, W, H,
                                                              **kw)
    np.testing.assert_array_equal(params.view(np.int32),
                                  np.asarray(ops[0])[0].view(np.int32))
    assert params[perturbation.Q_ROW0] == 0.0
    assert params[perturbation.Q_AROW0] == (band[0] if band else 0.0)
    idx = (1, 2, 4, 5, 6, 7)[:len(streams)]
    for mine, k in zip(streams, idx):
        np.testing.assert_array_equal(mine.view(np.int32),
                                      np.asarray(ops[k]).view(np.int32))
    j_spp, _seg_h, aa_h, full_h = call_kw["aa_stack"]
    assert (launch["spp"], launch["height"], launch["map_height"]) == \
        (j_spp, aa_h, full_h)
    assert launch["width"] == call_kw["width"] == W


def test_stacked_packing_guards():
    orb, kw = _kw(*VIEWS["mandelbrot-dd"])
    with pytest.raises(ValueError, match="power of two"):
        perturbation.pack_pert_operands(orb, 8, 6, aa_spp=3, **kw)
    with pytest.raises(ValueError, match="supersedes the offset"):
        perturbation.pack_pert_operands(orb, 8, 6, aa_spp=2,
                                        offset=(0.5, 0.0), **kw)


@pytest.mark.parametrize("view", list(VIEWS))
def test_stacked_segments_equal_sequential_offsets(view):
    # one stacked launch == spp^2 sequential launches at the offsets; a
    # stacked row band == the stacked frame's rows
    orb, kw = _kw(*VIEWS[view])
    kw.update(float_continuation=False, rebase=True, device="cpu")
    W, H = 12, 8
    st = perturbation.perturbation_fields(orb, W, H, aa_spp=2, **kw)
    assert st["n"].shape == (4, H, W)
    assert not (st["want"] > 0.5).any()
    for s in range(4):
        off = ((s % 2) / 2, (s // 2) / 2)
        seq = perturbation.perturbation_fields(orb, W, H, offset=off, **kw)
        for k in ("n", "zx", "zy", "want", "rounds_plane"):
            assert torch.equal(st[k][s], seq[k]), (s, k)
    band = perturbation.perturbation_fields(orb, W, 3, aa_spp=2, row0=4.0,
                                            map_height=H, **kw)
    for k in ("n", "zx", "zy", "rounds_plane"):
        assert torch.equal(band[k], st[k][:, 4:7]), k
    assert int(st["passes"]) == int(st["rounds_plane"].max())


def test_stacked_plain_matches_jax_interpret():
    orb, kw = _kw(*VIEWS["mandelbrot-dd"])
    kw.update(float_continuation=False, rebase=True, aa_spp=2)
    mine = perturbation.perturbation_fields(orb, 16, 10, device="cpu", **kw)
    ref = {k: np.asarray(v) for k, v in
           jax_pert.perturbation_fields(orb, 16, 10, **kw).items()}
    assert int(mine["passes"]) == int(ref["passes"]) > 1
    n, nref = mine["n"].numpy(), ref["n"]
    assert n.shape == nref.shape == (4, 10, 16)
    assert len(np.unique(nref)) > 3
    same = n == nref
    assert same.mean() >= 0.98 and np.abs(n - nref).max() <= 1
    for k in ("zx", "zy"):
        np.testing.assert_allclose(mine[k].numpy()[same], ref[k][same],
                                   rtol=1e-6, atol=0)


def _scene(**kw):
    return Scene(fractal_type=FractalType.DEEP_ZOOM, use_perturbation=True,
                 **kw)


SCENES = {
    "mandelbrot": dict(hp_center_x=C_I[0], hp_center_y=C_I[1],
                       hp_zoom="1e-8", max_iterations=300),
    "julia": dict(deep_zoom_julia=True, julia_c_real=-0.7,
                  julia_c_imag=0.27015, hp_center_x=JZSTAR[0],
                  hp_center_y=JZSTAR[1], hp_zoom="1e-10", max_iterations=200),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_stacked_render_fields_and_render_match_jax(name):
    s = _scene(samples_per_pixel=2, palette_mode=3, **SCENES[name])
    js = fr.Scene.from_dict(s.to_dict())
    W, H = 16, 10
    n, zx, zy, g, info = deep_zoom.render_fields(s, W, H, aa_spp=2,
                                                 device="cpu")
    jn, jzx, jzy, jg, jinfo = jax_dz.render_fields(js, W, H, aa_spp=2)
    assert n.shape == np.asarray(jn).shape == (4, H, W)
    assert len(np.unique(n)) > 3
    assert info["rebase_passes"] == jinfo["rebase_passes"]
    assert info["glitched_pixels_remaining"] == 0 and not g.any()
    np.testing.assert_array_equal(n, np.asarray(jn))
    img, binfo = deep_zoom.render(s, W, H, return_info=True, quantize=8,
                                  device="cpu")
    ref, jbinfo = jax_dz.render(js, W, H, return_info=True, quantize=8)
    assert binfo["aa_batched"] and binfo["aa_samples"] == 4
    assert jbinfo["aa_batched"] and binfo["fields_on_device"]
    lsb = np.abs(img.numpy().astype(np.int64) - np.asarray(ref))
    assert lsb.max() <= 1


def test_stacked_hp_fallback_matches_jax():
    # a pass budget of 1 leaves stacked lanes wanting; the HP fallback
    # addresses them as (sample, y, x) at the sample's subpixel offset
    s = _scene(samples_per_pixel=2, **SCENES["mandelbrot"])
    n, zx, zy, g, info = deep_zoom.render_fields(s, 12, 8, aa_spp=2,
                                                 max_passes=1, device="cpu")
    jn, jzx, jzy, jg, jinfo = jax_dz.render_fields(
        fr.Scene.from_dict(s.to_dict()), 12, 8, aa_spp=2, max_passes=1)
    assert info["fallback_pixels"] == jinfo["fallback_pixels"] > 0
    assert isinstance(n, np.ndarray) and n.shape == (4, 8, 12)
    assert not g.any() and info["glitched_pixels_remaining"] == 0
    np.testing.assert_array_equal(n, np.asarray(jn))
    np.testing.assert_array_equal(zx, np.asarray(jzx))
    full, *_ = deep_zoom.render_fields(s, 12, 8, aa_spp=2, device="cpu")
    assert (n == full).mean() >= 0.95
    # render() colours the fallback's host planes with the same expression
    img = deep_zoom.render(s, 12, 8, max_passes=1, device="cpu")
    assert torch.isfinite(img).all() and img.shape == (8, 12, 3)


def test_sequential_branch_matches_jax():
    # a non-power-of-two spp renders its samples one launch each
    s = _scene(samples_per_pixel=3, **SCENES["julia"])
    img, info = deep_zoom.render(s, 12, 8, return_info=True, quantize=8,
                                 device="cpu")
    ref, jinfo = jax_dz.render(fr.Scene.from_dict(s.to_dict()), 12, 8,
                               return_info=True, quantize=8)
    assert "aa_batched" not in info and "aa_batched" not in jinfo
    lsb = np.abs(img.numpy().astype(np.int64) - np.asarray(ref))
    assert lsb.max() <= 1


def test_color_avg_device_matches_jax_and_the_other_paths():
    rng = np.random.default_rng(11)
    n = rng.integers(0, 121, (4, 10, 14)).astype(np.int32)
    n[:, :2] = 120  # interior rows
    r = rng.uniform(2.0, 60.0, n.shape)
    a = rng.uniform(-np.pi, np.pi, n.shape)
    zx = (r * np.cos(a)).astype(np.float32)
    zy = (r * np.sin(a)).astype(np.float32)
    p = ColorParams(max_iterations=120.0, bailout=4.0, palette_mode=2,
                    color_offset=0.3, color_scale=1.7)
    t = [torch.from_numpy(v) for v in (n, zx, zy)]
    mine = deep_zoom.color_avg_device(*t, p, 4)
    ref = jax_dz.color_avg_device(n, zx, zy, jax_coloring.ColorParams(
        max_iterations=120, bailout=4.0, palette_mode=2, color_offset=0.3,
        color_scale=1.7), 4)
    assert mine.shape == (10, 14, 3) and mine.dtype == torch.float32
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    # host planes (an HP fallback's) and the sequential accumulator give
    # the same bits as the stacked device planes
    assert torch.equal(deep_zoom.color_stacked_samples(n, zx, zy, p, 4,
                                                       "cpu"), mine)
    acc = deep_zoom.SampleAccumulator(p, "cpu")
    for s in range(4):
        acc.add(n[s], t[1][s], zy[s])
    assert torch.equal(acc.average(4), mine)


# ---------------------------------------------------------------------------
# cli render --type deep-zoom: the families and --spp against the JAX CLI
# ---------------------------------------------------------------------------

CLI_CASES = {
    "--deep-julia": ["--deep-julia", "--julia-cr", "-0.7", "--julia-ci",
                     "0.27015", "--hp-center-x", JZSTAR[0], "--hp-center-y",
                     JZSTAR[1], "--hp-zoom", "1e-12", "--iters", "400"],
    "--deep-ship": ["--deep-ship", "--hp-center-x", "-2", "--hp-center-y",
                    "0", "--hp-zoom", "1e-10", "--iters", "300",
                    "--palette", "3"],
    "--deep-phoenix": ["--deep-phoenix", "--phoenix-p", "0",
                       "--phoenix-r", "-0.5", "--hp-center-x",
                       "0.5334632772339566", "--hp-center-y", "0.05",
                       "--hp-zoom", "1e-10", "--iters", "400",
                       "--palette", "2"],
    "--spp 2": ["--spp", "2", "--hp-center-x", C_I[0], "--hp-center-y",
                C_I[1], "--hp-zoom", "1e-8", "--iters", "300"],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_deep_zoom_png_matches_jax_cli(tmp_path, capsys, case):
    from fractalrenderer_tpu import cli as jax_cli

    argv = ["render", "--type", "deep-zoom", "--width", "20", "--height",
            "11", *CLI_CASES[case]]
    out, jout = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    assert cli.main([*argv, "--device", "cpu", "--out", out]) == 0
    said = capsys.readouterr().out
    assert "Rendered 20x11 Deep_Zoom on cpu" in said
    assert "0 HP-fallback, 0 remaining" in said
    assert jax_cli.main([*argv, "--out", jout]) == 0
    img, ref = read_png(out), read_png(jout)
    assert img.shape == ref.shape == (11, 20, 3)
    assert np.abs(img.astype(np.int64) - ref.astype(np.int64)).max() <= 1
    assert 0 < img.mean() < 255
