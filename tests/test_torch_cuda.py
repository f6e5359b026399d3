"""Kernels K1 (csrc/escape.cu), K2 (csrc/dd_escape.cu), K3
(csrc/perturbation.cu) and K4a/K4b (csrc/bulb.cu) on the card against
their plain PyTorch versions on the same card, at edge shapes and options
the main path does not reach.

Contract: counts, z, trap and dz bit-equal (NaN where the plain version
has NaN); the Burning Ship stripe (a sum
of sinf terms) within rtol 1e-3, atol 2e-4·iters (the JAX contract,
test_golden_vs_kernel.py:98-100); fused colour within 1e-5; K3 bit-equal
on n, zx, zy, want and rounds in each family and delta tier and in stacked
launches (each segment also equal to a launch at its offset), on errx too
in the Burning Ship's error-ledger instances, and on n, zx, zy and glitch
in the single-pass Mandelbrot instances (with and without f32 float
continuation, on a band and against a shifted reference), and in the dd
tier at 1e-20, where the products' errors are subnormal; K4a's start
depths and K4b's planes (hit, t, d, esc, normals, AO, msteps, work)
bit-equal in the integer-power and trig instances, at ragged sizes and on
bands; K4b's counters count every DE step and change no output.

Needs an NVIDIA GPU and nvcc; skipped elsewhere.  The GPU machine has no
jax, so run it there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
from fractions import Fraction

import pytest
import torch

from fractalrenderer_tpu_torch.ops import (bulb_kernel, bulb_math, dd,
                                           dd_escape, escape)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


_FAMILY_VIEWS = {
    "mandelbrot": dict(center_x=-0.5, center_y=0.0, zoom=3.0),
    "julia": dict(center_x=0.0, center_y=0.0, zoom=3.0,
                  julia_c=(-0.7, 0.27015)),
    "burning_ship": dict(center_x=-0.5, center_y=-0.6, zoom=2.0,
                         trap_radius=0.5, stripe_density=10.0),
    "phoenix": dict(center_x=0.0, center_y=0.0, zoom=3.0,
                    julia_c=(0.5667, 0.0), phoenix_p=0.1, phoenix_r=-0.5,
                    stripe_density=8.0),
}


def _both(dev, width, height, *, family="mandelbrot", fused=None,
          skip=True, row0=0, map_height=None, max_iter=256, iter_limit=None,
          use_julia=False, track=(), **view):
    view = dict(_FAMILY_VIEWS[family], **view)
    params = escape.pack_params(
        family=family,
        iter_limit=max_iter if iter_limit is None else iter_limit,
        row0=row0, **view)
    kw = dict(width=width, height=height, map_height=map_height or height,
              row0=row0, max_iter_cap=max_iter,
              interior_skip=skip and family == "mandelbrot",
              fused_color=fused, device=dev, family=family,
              use_julia=use_julia, track_trap="trap" in track,
              track_stripe="stripe" in track,
              track_deriv="deriv" in track)
    got = escape.escape_fields_cuda(params, **kw)
    want = escape.escape_fields_plain(params, **kw)
    torch.cuda.synchronize()
    return got, want


def _assert_fields_equal(got, want, names, max_iter):
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name == "stripe":
            torch.testing.assert_close(g, w, rtol=1e-3, atol=2e-4 * max_iter)
        else:
            # dz of interior pixels outside the skipped bulbs can overflow
            # to inf and then NaN; NaN must sit at the same pixels
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True,
                                       msg=f"{name} differs")


@pytest.mark.parametrize("case", [
    dict(width=1, height=1),
    dict(width=33, height=9),
    dict(width=257, height=130, skip=False),
    dict(width=64, height=7, row0=50, map_height=57),
    dict(width=48, height=32, max_iter=96, iter_limit=10 ** 8),
    dict(width=48, height=32, max_iter=512, iter_limit=300),
    dict(width=40, height=30, max_iter=1),
    dict(width=96, height=54, center_x=-0.743643887037151,
         center_y=0.13182590420533, zoom=0.008, max_iter=2048),
    dict(width=50, height=40, center_x=-1.0, center_y=0.0, zoom=0.6,
         bailout=2.0),
], ids=str)
def test_fields_kernel_equals_plain(dev, case):
    (n, zx, zy), (n_p, zx_p, zy_p) = _both(dev, **case)
    assert n.dtype == torch.int32 and n.shape == n_p.shape
    assert torch.equal(n, n_p)
    assert torch.equal(zx, zx_p) and torch.equal(zy, zy_p)


@pytest.mark.parametrize("family,case", [
    ("mandelbrot", dict(width=97, height=61, skip=False,
                        track=("trap", "stripe", "deriv"))),
    ("mandelbrot", dict(width=64, height=9, row0=20, map_height=40,
                        track=("trap", "deriv"))),
    ("mandelbrot", dict(width=80, height=45, skip=True,
                        track=("trap", "deriv"))),
    ("julia", dict(width=97, height=61)),
    ("julia", dict(width=33, height=7, row0=3, map_height=11,
                   julia_c=(-0.123, 0.745), track=("trap", "stripe"))),
    ("julia", dict(width=1, height=1, max_iter=1)),
    ("burning_ship", dict(width=97, height=61, track=("trap", "stripe"))),
    ("burning_ship", dict(width=64, height=13, row0=30, map_height=60,
                          max_iter=512, iter_limit=300,
                          track=("trap", "stripe"))),
    ("burning_ship", dict(width=40, height=30, bailout=2.0,
                          track=("trap",))),
    ("phoenix", dict(width=97, height=61)),
    ("phoenix", dict(width=97, height=61, use_julia=True,
                     julia_c=(0.3, 0.2), track=("trap", "stripe"))),
    ("phoenix", dict(width=50, height=9, row0=5, map_height=31,
                     phoenix_p=0.0, phoenix_r=-0.5)),
], ids=str)
def test_family_fields_kernel_equals_plain(dev, family, case):
    got, want = _both(dev, family=family, **case)
    track = case.get("track", ())
    names = escape.output_names(family, False, "trap" in track,
                                "stripe" in track, "deriv" in track)
    _assert_fields_equal(got, want, names, case.get("max_iter", 256))


@pytest.mark.parametrize("family,fused,extra", [
    ("mandelbrot", (0, 0, False, True), {}),
    ("mandelbrot", (1, 1, False, True), {}),
    ("mandelbrot", (2, 0, True, True), {}),
    ("mandelbrot", (3, 1, False, False), {}),
    ("mandelbrot", (4, 0, False, True), {}),
    ("mandelbrot", (5, 1, True, True), {}),
    ("mandelbrot", (9, 0, False, True), {}),
    ("julia", (0, 0, True, True), {}),
    ("julia", (4, 0, True, False), dict(julia_c=(-0.4, 0.6))),
    ("julia", (9, 0, True, True), {}),
    ("burning_ship", (5, 3, True, True), {}),
    ("burning_ship", (3, 0, True, True), {}),
    ("burning_ship", (8, 1, True, False), {}),
    ("burning_ship", (1, 2, True, True), {}),
    ("phoenix", (2, 0, True, True), {}),
    ("phoenix", (0, 0, True, True), dict(stripe_density=0.0,
                                         phoenix_p=0.0)),
    ("phoenix", (4, 0, True, False), dict(use_julia=True,
                                          julia_c=(0.3, 0.2))),
], ids=str)
def test_fused_kernel_matches_plain(dev, family, fused, extra):
    got, want = _both(dev, 200, 120, family=family, fused=fused,
                      color_offset=0.3, color_scale=1.7, brightness=1.2,
                      saturation=0.8, contrast=1.3, **extra)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)


_SCHEDULE_MODES = {
    # mode: (fused colour, tracked outputs of Mandelbrot, of the others)
    "fused": ((0, 0, True, True), (), ()),
    "fields": (None, ("trap", "deriv"), ("trap", "stripe")),
}


@pytest.mark.parametrize("mode", list(_SCHEDULE_MODES))
@pytest.mark.parametrize("family", list(_FAMILY_VIEWS))
@pytest.mark.parametrize("size", [(1, 1), (65, 33), (100, 7), (31, 40)],
                         ids=str)
def test_escape_schedule_ragged_sizes_equal_plain(dev, family, mode, size):
    # the 32x8 blocks at widths and heights that are not a multiple of
    # them, a frame smaller than one warp, and a band
    fused, *tracks = _SCHEDULE_MODES[mode]
    track = tracks[family != "mandelbrot"]
    for row0, map_height in ((0, None), (5, size[1] + 9)):
        got, want = _both(dev, *size, family=family, fused=fused,
                          track=track, row0=row0, map_height=map_height)
        if fused is None:
            names = escape.output_names(family, False, "trap" in track,
                                        "stripe" in track, "deriv" in track)
            _assert_fields_equal(got, want, names, 256)
        else:
            for g, w in zip(got, want, strict=True):
                torch.testing.assert_close(g, w, rtol=0, atol=1e-5)


def test_escape_back_to_back_launches_equal(dev):
    # launches of different sizes queued back to back on one stream cover
    # their frames exactly
    frames = [(160, 90), (33, 5), (160, 90), (1, 1), (97, 61)]
    params = escape.pack_params(center_x=-0.5, center_y=0.0, zoom=3.0,
                                iter_limit=128)
    outs = []
    for w, h in frames:
        outs.append(escape.escape_fields_cuda(
            params, width=w, height=h, map_height=h, row0=0,
            max_iter_cap=128, interior_skip=True,
            fused_color=(0, 0, False, True), device=dev))
    torch.cuda.synchronize()
    for (w, h), got in zip(frames, outs):
        want = escape.escape_fields_plain(
            params, width=w, height=h, map_height=h, row0=0,
            max_iter_cap=128, interior_skip=True,
            fused_color=(0, 0, False, True), device=dev)
        for g, x in zip(got, want, strict=True):
            torch.testing.assert_close(g, x, rtol=0, atol=1e-5)
    for a, b in zip(outs[0], outs[2], strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fused", [False, True], ids=["fields", "fused"])
@pytest.mark.parametrize("family", list(_FAMILY_VIEWS))
def test_escape_counters_count_every_iteration(dev, family, fused):
    w, h, limit = 97, 61, 200
    params = escape.pack_params(family=family, iter_limit=limit,
                                **_FAMILY_VIEWS[family])
    kw = dict(width=w, height=h, map_height=h, row0=0, max_iter_cap=limit,
              interior_skip=family == "mandelbrot",
              fused_color=(0, 0, True, True) if fused else None,
              device=dev, family=family)
    plain = escape.escape_fields_cuda(params, **kw)
    buf = escape.trips_buffer(w, h, dev)
    got = escape.escape_fields_cuda(params, trips=buf, **kw)
    torch.cuda.synchronize()
    for a, b in zip(plain, got, strict=True):  # the counters change nothing
        assert torch.equal(a, b)
    n = escape.escape_fields_cuda(params, **dict(kw, fused_color=None))[0]
    looped = ~escape.interior_skip_mask(
        params, width=w, height=h, map_height=h, row0=0, device=dev) \
        if family == "mandelbrot" else torch.ones_like(n, dtype=torch.bool)
    c = escape.decode_trips(buf)
    # every loop update of every looped pixel, once
    assert c["lane_iters"] == int(n.clamp(max=limit - 1)[looped].sum())
    assert c["pixels"] == w * h and c["looped"] == int(looped.sum())
    assert c["warps"] == -(-w // 32) * h  # one warp per 32 pixels of a row
    assert c["trips"] * 32 >= c["lane_iters"] and 0 < c["lane_util"] <= 1
    with pytest.raises(ValueError, match="trips buffer"):
        escape.escape_fields_cuda(params, trips=buf[:-1], **kw)


@pytest.mark.parametrize("size", [(1, 1), (65, 33), (100, 7)], ids=str)
def test_dd_counters_count_every_iteration(dev, size):
    w, h = size
    params = dd_escape.pack_dd_params(
        center_x_dd=dd.dd_from_string("-0.743643887037151"),
        center_y_dd=dd.dd_from_string("0.13182590420533"),
        zoom_dd=dd.dd_from_string("1e-9"), iter_limit=600)
    kw = dict(width=w, height=h, map_height=h, row0=0, device=dev)
    plain = dd_escape.dd_escape_fields_cuda(params, **kw)
    buf = dd_escape.trips_buffer(w, h, dev)
    got = dd_escape.dd_escape_fields_cuda(params, trips=buf, **kw)
    torch.cuda.synchronize()
    for a, b in zip(plain, got, strict=True):
        assert torch.equal(a, b)
    c = dd_escape.decode_trips(buf)
    assert c["lane_iters"] == int(got[0].clamp(max=599).sum())
    assert c["pixels"] == c["looped"] == w * h
    with pytest.raises(ValueError, match="trips buffer"):
        dd_escape.dd_escape_fields_cuda(params, trips=buf[:-1], **kw)


def _dd_both(dev, width, height, *, cx="-0.5", cy="0", zoom="3",
             iter_limit=96, bailout=4.0, row0=0, map_height=None,
             offset=(0.0, 0.0)):
    params = dd_escape.pack_dd_params(
        center_x_dd=dd.dd_from_string(cx), center_y_dd=dd.dd_from_string(cy),
        zoom_dd=dd.dd_from_string(zoom), iter_limit=iter_limit,
        bailout=bailout, offset=offset, row0=row0)
    kw = dict(width=width, height=height, map_height=map_height or height,
              row0=row0, device=dev)
    got = dd_escape.dd_escape_fields_cuda(params, **kw)
    want = dd_escape.dd_escape_fields_plain(params, **kw)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("case", [
    dict(width=1, height=1),
    dict(width=65, height=33),
    dict(width=100, height=7, row0=3, map_height=20),
    dict(width=96, height=54, cx="-0.743643887037151",
         cy="0.13182590420533", zoom="1e-9", iter_limit=1500),
    dict(width=64, height=9, row0=20, map_height=40, offset=(0.5, 0.25)),
    dict(width=40, height=30, iter_limit=1),
    dict(width=40, height=30, bailout=2.5, zoom="1e-6",
         cx="-1.7497591451303665", cy="0.0000000000000000"),
], ids=str)
def test_dd_kernel_equals_plain(dev, case):
    got, want = _dd_both(dev, **case)
    for name, g, w in zip(("n", "zx", "zy"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), f"{name} differs"


_PERT_VIEWS = {
    # tier: (center x, center y, zoom, iterations, packing options)
    "f32": ("-0.743643887037151", "0.13182590420533", "1e-6", 800, {}),
    "dd": ("-0.74364388703715158", "0.13182590420531198", "1e-12", 4000,
           dict(dd_delta=True)),
    "fx": ("0", "1", "1e-50", 600, dict(scaled_delta=True,
                                       zoom_frac="1e-50")),
}


def _pert_both(dev, tier, width, height, *, row0=0, map_height=None,
               series=False, max_passes=256):
    from fractalrenderer_tpu_torch.deepzoom.orbit import compute_orbit
    from fractalrenderer_tpu_torch.deepzoom.series import (
        compute_series_skip, compute_series_skip_fx)
    from fractalrenderer_tpu_torch.ops import perturbation

    cx, cy, zoom, iters, kw = _PERT_VIEWS[tier]
    map_height = map_height or height
    orb = compute_orbit(cx, cy, 320 if tier == "fx" else 128, iters + 1)
    skip = None
    if series:
        dc_max = Fraction(zoom) * 4 * 2 / map_height
        skip = (compute_series_skip_fx(orb, dc_max) if tier == "fx"
                else compute_series_skip(orb, float(dc_max)))
    params, streams, launch = perturbation.pack_pert_operands(
        orb, width, height, center_x_dd=dd.dd_from_string(cx),
        center_y_dd=dd.dd_from_string(cy), zoom_dd=dd.dd_from_string(zoom),
        max_iter=iters, series=skip, row0=float(row0),
        map_height=map_height, **kw)
    assert launch["tier"] == tier
    return _launch_both(dev, params, streams, launch, max_passes)


def _launch_both(dev, params, streams, launch, max_passes=256):
    from fractalrenderer_tpu_torch.ops import perturbation

    got = perturbation.perturbation_fields_cuda(
        params, streams, max_passes=max_passes, device=dev, **launch)
    want = perturbation.perturbation_fields_plain(
        params, streams, max_passes=max_passes, device=dev, **launch)
    torch.cuda.synchronize()
    return got, want


def _assert_pert_equal(got, want, label):
    names = ("n", "zx", "zy", "glitch", "want", "rounds")
    for name, g, w in zip(names, got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), f"{label}: {name} differs"


@pytest.mark.parametrize("tier", ["f32", "dd", "fx"])
@pytest.mark.parametrize("case", [
    dict(width=64, height=48),
    dict(width=64, height=48, series=True),
    dict(width=96, height=16, row0=500, map_height=1080),
    dict(width=33, height=7, max_passes=2),
], ids=str)
def test_perturbation_kernel_equals_plain(dev, tier, case):
    got, want = _pert_both(dev, tier, **case)
    _assert_pert_equal(got, want, tier)
    assert int(got[5].max()) >= 2  # the views rebase


# a dd-tier view whose d^2 products have subnormal errors (the needle at
# 1e-20; tests/test_torch_two_prod.py shows the plain version reaches that
# zone there): the kernel's fmaf and the plain version's f64 form agree in
# it too
_SUBNORMAL_VIEW = ("-1.74975914513036646165693", "0", "1e-20", 600)


def test_dd_tier_subnormal_product_errors_kernel_equals_plain(dev):
    from fractalrenderer_tpu_torch.deepzoom.orbit import compute_orbit
    from fractalrenderer_tpu_torch.ops import perturbation

    cx, cy, zoom, iters = _SUBNORMAL_VIEW
    orb = compute_orbit(cx, cy, 256, iters + 1)
    params, streams, launch = perturbation.pack_pert_operands(
        orb, 64, 48, center_x_dd=dd.dd_from_string(cx),
        center_y_dd=dd.dd_from_string(cy), zoom_dd=dd.dd_from_string(zoom),
        max_iter=iters, dd_delta=True)
    assert launch["tier"] == "dd"
    got, want = _launch_both(dev, params, streams, launch)
    _assert_pert_equal(got, want, "dd 1e-20")
    assert int(got[0].min()) < iters and int(got[5].max()) >= 2


_JC = ("-0.7", "0.27015")
# the repelling fixed point of z^2 + c at _JC (tests/test_deepzoom.py)
_JZSTAR = (
    "1.484292748140190509759902440314769152069911011656749053313607708428926366189",
    "-0.137230514250178732651450854196740117783619435441039716507673181503075677979")
_ARMADA = ("-1.7623025", "-0.028000625")
_PHOENIX = ("0.5334632772339566", "0.05")
# the escape-set boundary at r = -0.51 bisected to 1e-54 as
# test_deep_phoenix_floatexp_nondyadic_r_matches_exact_oracle does
_PHOENIX_R051 = (
    "0.5363685622288939118213416621494880258143653450622962128740227946683769",
    "0.05")
# (family, tier): (center, zoom, iterations, orbit bits, phoenix r)
_FAMILY_PERT_VIEWS = {
    ("julia", "f32"): (_JZSTAR, "1e-6", 500, 128, None),
    ("julia", "dd"): (_JZSTAR, "1e-12", 600, 128, None),
    ("julia", "fx"): (_JZSTAR, "1e-50", 400, 320, None),
    ("ship", "f32"): (_ARMADA, "1e-5", 400, 128, None),
    ("ship", "dd"): (_ARMADA, "1e-10", 400, 128, None),
    ("ship", "fx"): (("-2", "0"), "1e-40", 600, 320, None),
    ("phoenix", "f32"): (_PHOENIX, "1e-6", 400, 128, -0.5),
    ("phoenix", "dd"): (_PHOENIX, "1e-10", 400, 128, -0.5),
    ("phoenix", "fx"): (_PHOENIX_R051, "1e-50", 400, 320, -0.51),
}


def _family_operands(family, tier, width, height, **kw):
    """K3 operands of a family view, its orbit as models/deep_zoom.py
    computes it (Julia: the drift from the view centre, floatexp-emitted in
    the floatexp tier; Ship and Phoenix: kind 1 and 2)."""
    from fractalrenderer_tpu_torch.deepzoom.orbit import compute_orbit
    from fractalrenderer_tpu_torch.ops import perturbation

    (cx, cy), zoom, iters, bits, rr = _FAMILY_PERT_VIEWS[family, tier]
    fam = {family: True} if family != "mandelbrot" else {}
    if family == "julia":
        orb = compute_orbit(*_JC, bits, iters + 1, z0x=cx, z0y=cy,
                            emit_rel=True, emit_fx=tier == "fx")
        fam["julia_z0"] = (float(cx), float(cy))
        if tier == "fx":
            orb, fam["orbit_exp"] = orb
    else:
        orb = compute_orbit(cx, cy, bits, iters + 1,
                            kind=1 if family == "ship" else 2,
                            pp=0.0, rr=rr or 0.0)
        if rr is not None:
            fam.update(phoenix_p=0.0, phoenix_r=rr)
    tier_kw = ({"scaled_delta": True} if tier == "fx"
               else {"dd_delta": tier == "dd"})
    return perturbation.pack_pert_operands(
        orb, width, height, center_x_dd=dd.dd_from_string(cx),
        center_y_dd=dd.dd_from_string(cy), zoom_dd=dd.dd_from_string(zoom),
        zoom_frac=zoom, max_iter=iters, **tier_kw, **fam, **kw)


@pytest.mark.parametrize("family,tier", list(_FAMILY_PERT_VIEWS),
                         ids=[f"{f}-{t}" for f, t in _FAMILY_PERT_VIEWS])
def test_family_perturbation_kernel_equals_plain(dev, family, tier):
    params, streams, launch = _family_operands(family, tier, 64, 48)
    assert (launch["family"], launch["tier"]) == (family, tier)
    got, want = _launch_both(dev, params, streams, launch)
    _assert_pert_equal(got, want, f"{family} {tier}")
    assert not bool(got[4].any())  # no lane left wanting
    assert len(torch.unique(got[0])) > 3  # structure in the view


@pytest.mark.parametrize("family,tier,spp,band", [
    ("julia", "dd", 2, None), ("ship", "fx", 2, None),
    ("phoenix", "f32", 4, None), ("julia", "fx", 2, (9, 20)),
], ids=str)
def test_stacked_perturbation_kernel_equals_plain(dev, family, tier, spp,
                                                  band):
    # one launch renders the spp^2 segments; each equals a launch of the
    # kernel at its subpixel offset
    from fractalrenderer_tpu_torch.ops import perturbation

    kw = (dict(row0=float(band[0]), map_height=band[0] + band[1] + 7)
          if band else {})
    height = band[1] if band else 24
    params, streams, launch = _family_operands(family, tier, 40, height,
                                               aa_spp=spp, **kw)
    assert launch["spp"] == spp
    got, want = _launch_both(dev, params, streams, launch)
    _assert_pert_equal(got, want, f"{family} {tier} spp {spp}")
    assert got[0].shape == (spp * spp, height, 40)
    for s in range(spp * spp):
        off = ((s % spp) / spp, (s // spp) / spp)
        sp, ss, sl = _family_operands(family, tier, 40, height, offset=off,
                                      **kw)
        seq = perturbation.perturbation_fields_cuda(
            sp, ss, max_passes=256, device=dev, **sl)
        for name, g, q in zip(("n", "zx", "zy", "glitch", "want", "rounds"),
                              got, seq, strict=True):
            assert torch.equal(g[s], q), f"segment {s}: {name} differs"


_LEDGER_NAMES = ("n", "zx", "zy", "glitch", "want", "rounds", "errx")


@pytest.mark.parametrize("tier,spp,band", [
    ("dd", 1, None), ("fx", 1, None), ("dd", 2, None), ("fx", 1, (9, 20)),
], ids=str)
def test_ledger_kernel_equals_plain(dev, tier, spp, band):
    # the exact-dust instances: every plane, the error ledger included,
    # and one launch counted per call
    from fractalrenderer_tpu_torch.ops import perturbation

    kw = (dict(row0=float(band[0]), map_height=band[0] + band[1] + 7)
          if band else {})
    height = band[1] if band else 24
    params, streams, launch = _family_operands(
        "ship", tier, 40, height, track_err=True,
        **(dict(aa_spp=spp) if spp > 1 else {}), **kw)
    assert launch["form"] == "ledger"
    before = perturbation.perturbation_fields_cuda.launches
    got, want = _launch_both(dev, params, streams, launch)
    assert perturbation.perturbation_fields_cuda.launches == before + 1
    for name, g, w in zip(_LEDGER_NAMES, got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), f"ship {tier} ledger: {name} differs"
    assert torch.isfinite(got[6]).any() and not bool(got[4].any())
    # the ledger's planes besides errx are the rebasing instance's
    plain_launch = dict(launch, form="rebase")
    ref = perturbation.perturbation_fields_cuda(
        params, streams, max_passes=256, device=dev, **plain_launch)
    for name, g, r in zip(_LEDGER_NAMES, got, ref):
        assert torch.equal(g, r), f"ship {tier}: {name} moved with the ledger"


_STARVING = ("-0.77568377", "0.13646737")  # escapes after 448 iterations
# case: (center, zoom, iterations, orbit bits, packing options)
_SINGLE_VIEWS = {
    "f32-cont": (("-0.743643887037151", "0.13182590420533"), "1e-6", 2000,
                 64, dict(float_continuation=True)),
    "f32-cont-starving": (_STARVING, "1e-6", 1500, 64,
                          dict(float_continuation=True)),
    "f32-starving": (_STARVING, "1e-6", 1500, 64, {}),
    "dd-starving": (_STARVING, "1e-10", 2500, 128, dict(dd_delta=True)),
    "fx": (("0", "1"), "1e-50", 600, 320,
           dict(scaled_delta=True, zoom_frac="1e-50")),
}


def _single_operands(case, width, height, **kw):
    from fractalrenderer_tpu_torch.deepzoom.orbit import compute_orbit
    from fractalrenderer_tpu_torch.ops import perturbation

    (cx, cy), zoom, iters, bits, opts = _SINGLE_VIEWS[case]
    orb = compute_orbit(cx, cy, bits, iters + 1)
    return perturbation.pack_pert_operands(
        orb, width, height, center_x_dd=dd.dd_from_string(cx),
        center_y_dd=dd.dd_from_string(cy), zoom_dd=dd.dd_from_string(zoom),
        max_iter=iters, rebase=False, **opts, **kw)


@pytest.mark.parametrize("case,extra", [
    *[(c, {}) for c in _SINGLE_VIEWS],
    ("f32-cont-starving", dict(row0=500.0, map_height=1080)),
    ("dd-starving", dict(ref_shift_x=(2e-12, 0.0), ref_shift_y=(-1e-12, 0.0))),
    ("fx", dict(ref_shift_x_frac="2e-52", ref_shift_y_frac="-1e-52")),
], ids=str)
def test_single_pass_kernel_equals_plain(dev, case, extra):
    # the legacy pipeline's instances: n, zx, zy and the glitch flags
    from fractalrenderer_tpu_torch.ops import perturbation

    params, streams, launch = _single_operands(case, 64, 48, **extra)
    assert launch["form"] == "single"
    assert launch["float_cont"] == ("cont" in case)
    before = perturbation.perturbation_fields_cuda.launches
    got, want = _launch_both(dev, params, streams, launch)
    assert perturbation.perturbation_fields_cuda.launches == before + 1
    for name, g, w in zip(("n", "zx", "zy", "glitch"), got, want,
                          strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), f"{case}: {name} differs"
    assert len(torch.unique(got[0])) > 3
    if "starving" in case and "cont" not in case:
        assert bool(got[3].any())  # lanes outlive the orbit: flagged


def test_launch_counter_counts_kernel_launches(dev):
    # the entry points default to the card
    before = escape.escape_fields_cuda.launches
    f = escape.escape_fields("julia", 16, 8, center_x=0.0, center_y=0.0,
                             zoom=3.0, max_iter=32, julia_c=(-0.7, 0.27))
    assert f["n"].device.type == "cuda"
    assert escape.escape_fields_cuda.launches == before + 1
    before = dd_escape.dd_escape_fields_cuda.launches
    f = dd_escape.dd_escape_fields(16, 8, center_x_dd=(-0.5, 0.0),
                                   center_y_dd=(0.0, 0.0),
                                   zoom_dd=(3.0, 0.0), max_iter=32)
    assert f["n"].device.type == "cuda"
    assert dd_escape.dd_escape_fields_cuda.launches == before + 1
    cone = bulb_kernel.cone_fields_cuda.launches
    march = bulb_kernel.march_fields_cuda.launches
    f = bulb_kernel.march_fields(16, 8, ro=(0.0, 0.0, 3.0), fov=1.0,
                                 power=8.0, max_iter=16, shade=True)
    assert f["ao"].device.type == "cuda"
    assert bulb_kernel.cone_fields_cuda.launches == cone + 1
    assert bulb_kernel.march_fields_cuda.launches == march + 1


def test_kernel_rejects_unported_styles(dev):
    # interior style 2 reads the tracked trap, so the fused kernel refuses
    # it as the JAX kernel does; the pipeline renders it unfused
    import fractalrenderer_tpu_torch as frt

    before = escape.escape_fields_cuda.launches
    scene = frt.Scene(interior_style=2, max_iterations=64)
    img = frt.render(scene, 40, 24, device=dev)
    assert escape.escape_fields_cuda.launches == before + 1
    torch.testing.assert_close(img.cpu(), frt.render(scene, 40, 24,
                                                     device="cpu"),
                               rtol=0, atol=1e-5)


def test_kernel_rejects_fused_trap_glow(dev):
    params = escape.pack_params(center_x=-0.5, center_y=0.0, zoom=3.0,
                                iter_limit=16)
    with pytest.raises(ValueError, match="interior_style 2"):
        escape.escape_fields_cuda(
            params, width=8, height=8, map_height=8, row0=0,
            max_iter_cap=16, interior_skip=False,
            fused_color=(0, 2, False, True), device=dev)


def _bulb_both(dev, width, height, *, power=8.0, time=0.0, row0=0,
               map_height=None, shade=True, stats=True, cone=8,
               int_power="auto", max_iter=64):
    """K4a then K4b on the card and their plain versions on the same
    inputs (K4b's plain version takes the kernel's K4a grid)."""
    p = bulb_math.BulbParams(power=power, time=time).clamped()
    ro, dyn = bulb_math.camera_setup(p)
    params = bulb_kernel.pack_march_params(ro=ro, fov=p.fov, power=dyn,
                                           max_iter=max_iter, row0=row0)
    map_height = map_height or height
    ip = bulb_kernel.resolve_int_power(dyn, int_power)
    tc = None
    if cone:
        cparams = bulb_kernel.pack_cone_params(params, cone, map_height)
        ckw = dict(coarse_w=bulb_kernel.cdiv(width, cone),
                   coarse_h=bulb_kernel.cdiv(height, cone) + 1, width=width,
                   map_height=map_height, int_power=ip, device=dev)
        tc = bulb_kernel.cone_fields_cuda(cparams, **ckw)
        tc_plain = bulb_kernel.cone_fields_plain(cparams, **ckw)
        torch.cuda.synchronize()
        assert torch.equal(tc, tc_plain), "K4a differs from its plain version"
    kw = dict(width=width, height=height, map_height=map_height, cone=cone,
              shade=shade, int_power=ip, stats=stats, device=dev)
    got = bulb_kernel.march_fields_cuda(params, tc, **kw)
    want = bulb_kernel.march_fields_plain(params, tc, **kw)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("case", [
    dict(width=64, height=48),
    dict(width=64, height=48, time=1.0),
    dict(width=64, height=48, power=3.0),
    dict(width=64, height=48, power=16.0),
    dict(width=64, height=48, int_power=None),
    dict(width=64, height=48, shade=False, stats=False),
    dict(width=64, height=48, cone=0, max_iter=24),
    dict(width=33, height=7, power=5.0, time=0.3),
    dict(width=480, height=16, row0=131, map_height=270),
    # every other integer power's template instance (csrc/bulb.cu unrolls
    # each power's exponent chains on its own)
    *[dict(width=64, height=48, power=float(p))
      for p in range(2, 16) if p not in (3, 8)],
], ids=str)
def test_bulb_kernels_equal_plain(dev, case):
    got, want = _bulb_both(dev, **case)
    names = ["hit", "t", "d", "esc"]
    if case.get("shade", True):
        names += ["nx", "ny", "nz", "ao"]
    if case.get("stats", True):
        names += ["msteps", "work"]
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(g, w), f"{name} differs"
    assert 0.0 < float(got[0].mean()) < 1.0  # bulb and sky


_BULB_PLANES = ["hit", "t", "d", "esc", "nx", "ny", "nz", "ao", "msteps",
                "work"]


@pytest.mark.parametrize("case", [
    dict(width=1, height=1),
    dict(width=5, height=3),
    dict(width=37, height=23),
    dict(width=37, height=23, shade=False),
    dict(width=37, height=23, stats=False),
    dict(width=37, height=23, shade=False, stats=False, time=1.0),
    dict(width=37, height=23, power=16.0, cone=0),
    dict(width=37, height=9, row0=29, map_height=64),
    dict(width=37, height=9, row0=29, map_height=64, shade=False,
         stats=False),
], ids=str)
def test_bulb_march_ragged_sizes_equal_plain(dev, case):
    # the pixel queue's padding (ragged right and bottom edges) and bands
    got, want = _bulb_both(dev, **case)
    names = [n for n in _BULB_PLANES
             if (n not in ("nx", "ny", "nz", "ao") or case.get("shade", True))
             and (n not in ("msteps", "work") or case.get("stats", True))]
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        assert torch.equal(g, w), f"{name} differs"


def _bulb_frame(dev, width=160, height=90, **kw):
    p = bulb_math.BulbParams(**kw).clamped()
    ro, dyn = bulb_math.camera_setup(p)
    ip = bulb_kernel.resolve_int_power(dyn)
    params = bulb_kernel.pack_march_params(ro=ro, fov=p.fov, power=dyn,
                                           max_iter=64)
    mkw = dict(width=width, height=height, map_height=height, cone=0,
               shade=True, int_power=ip, stats=True, device=dev)
    return params, ip, mkw


def test_bulb_march_back_to_back_launches_equal(dev):
    # each launch takes a fresh, zeroed queue head: the second launch on
    # the stream runs every pixel again
    params, _, mkw = _bulb_frame(dev)
    first = bulb_kernel.march_fields_cuda(params, None, **mkw)
    second = bulb_kernel.march_fields_cuda(params, None, **mkw)
    torch.cuda.synchronize()
    for name, a, b in zip(_BULB_PLANES, first, second, strict=True):
        assert torch.equal(a, b), name
    assert float(first[-1].sum()) > 0


@pytest.mark.parametrize("kw", [{}, dict(time=1.0), dict(power=16.0)],
                         ids=str)
def test_bulb_march_counters_count_every_de_step(dev, kw):
    params, ip, mkw = _bulb_frame(dev, **kw)
    plain = bulb_kernel.march_fields_cuda(params, None, **mkw)
    buf = bulb_kernel.trips_buffer(ip, 160, 90, dev)
    got = bulb_kernel.march_fields_cuda(params, None, trips=buf, **mkw)
    torch.cuda.synchronize()
    # the counters change no output
    for name, a, b in zip(_BULB_PLANES, plain, got, strict=True):
        assert torch.equal(a, b), name
    c = bulb_kernel.decode_trips(buf)
    assert c["lane_steps"] == int(got[-1].double().sum())
    assert c["pixels"] == 160 * 90
    assert c["step_trips"] <= c["trips"] and c["event_trips"] <= c["trips"]
    assert 0.0 < c["lane_util"] <= 1.0
    blocks, per_sm = bulb_kernel.march_grid(ip, 160, 90, dev)
    assert per_sm >= (3 if ip is None else 4)
    assert buf.shape == (blocks * 8, 10)
    with pytest.raises(ValueError, match="trips buffer"):
        bulb_kernel.march_fields_cuda(params, None, trips=buf[:-1], **mkw)


def test_bulb_render_launches_one_cone_and_one_march_per_sample(
        dev, monkeypatch):
    import fractalrenderer_tpu_torch as frt
    from fractalrenderer_tpu_torch.models import mandelbulb

    scene = frt.Scene(fractal_type=frt.FractalType.MANDELBULB,
                      max_iterations=32, antialiasing_samples=2, time=0.7)
    cone = bulb_kernel.cone_fields_cuda.launches
    march = bulb_kernel.march_fields_cuda.launches
    img = mandelbulb.render(scene, 40, 24)
    assert img.device.type == "cuda"
    assert bulb_kernel.cone_fields_cuda.launches == cone + 4
    assert bulb_kernel.march_fields_cuda.launches == march + 4
    # the same pipeline on the plain versions, on the card: equal
    monkeypatch.setattr(bulb_kernel, "cone_fields_cuda",
                        bulb_kernel.cone_fields_plain)
    monkeypatch.setattr(bulb_kernel, "march_fields_cuda",
                        bulb_kernel.march_fields_plain)
    assert torch.equal(img, mandelbulb.render(scene, 40, 24))


# -- K5 (csrc/peak.cu) and K6 (csrc/probe/compile_probe.cu), and the
# -- diagnostics that need the card

@pytest.mark.parametrize("chains", [1, 2, 4, 8])
def test_fma_peak_equal_plain(dev, chains):
    import numpy as np

    from fractalrenderer_tpu_torch.utils import diag

    # every accumulator >= 0.5, where the plain f64 step is fmaf exactly;
    # 300 x 257 leaves a partial last block
    x = np.random.default_rng(chains).uniform(0.5, 4.0, (300, 257))
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    before = diag.fma_chains_cuda.launches
    got = diag.fma_chains_cuda(x, chains, 64)
    want = diag.fma_chains_plain(x, chains, 64)
    torch.cuda.synchronize()
    assert diag.fma_chains_cuda.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(diag.fma_chains(x, chains, 64), want)


def test_fma_peak_other_chain_counts_raise(dev):
    from fractalrenderer_tpu_torch.utils import diag

    x = torch.ones((8, 8), device=dev)
    before = diag.fma_chains_cuda.launches
    with pytest.raises(ValueError, match="chains"):
        diag.fma_chains_cuda(x, 3, 8)
    assert diag.fma_chains_cuda.launches == before


def test_compile_probe_twice_two_salts(dev):
    from fractalrenderer_tpu_torch.ops import _cuda

    lib_path = _cuda.library_path()
    probes = [_cuda.compile_probe(dev) for _ in range(2)]
    assert probes[0]["salt"] != probes[1]["salt"]
    x = torch.arange(16 * 128, dtype=torch.float32,
                     device=dev).reshape(16, 128) / 7.0
    for p in probes:
        assert 0 < p["build_seconds"] < p["seconds"]
        assert 0 <= p["salt"] < 2 ** 24 and p["salt"] == int(p["salt"])
        got = _cuda.compile_probe_cuda(p["lib"], x)
        assert torch.equal(got, _cuda.compile_probe_plain(x, p["salt"]))
    assert _cuda.library_path() == lib_path


def test_link_bandwidth_pageable_and_pinned(dev):
    from fractalrenderer_tpu_torch.utils import diag

    link = diag.measure_link_bandwidth(mb=8, reps=2, device=dev)
    assert link["mb"] == 8
    for key in ("best_mb_s", "mean_mb_s", "pinned_best_mb_s",
                "pinned_mean_mb_s"):
        assert link[key] > 0, key


def test_device_seconds_of_a_kernel(dev, tmp_path):
    from fractalrenderer_tpu_torch.utils import diag

    x = torch.ones((512, 256), device=dev)
    diag.fma_chains_cuda(x, 8, 256)
    total = diag.measure_device_seconds(
        lambda: diag.fma_chains_cuda(x, 8, 256), str(tmp_path))
    kernels = diag.device_seconds_from_trace(str(tmp_path), lane="kernel")
    assert 0 < kernels <= total < 1.0
    # the one launch's record, by name
    recs = diag.kernel_seconds_from_trace(str(tmp_path))
    peak = [v for k, v in recs.items() if "peak_kernel<8>" in k]
    assert peak == [[1, pytest.approx(kernels)]]


# -- the batch path: a batch of frames is its frames' single renders -------
def _batch_scenes(family):
    """Four off-axis frames of ``family`` whose iteration limit steps
    under a cap (500) that no single render's bucket equals."""
    from fractalrenderer_tpu_torch import FractalType, Scene

    ft = {"mandelbrot": FractalType.MANDELBROT,
          "julia": FractalType.JULIA}[family]
    return [Scene(fractal_type=ft, center_x=-0.3 - 0.05 * k,
                  center_y=0.35 + 0.04 * k, zoom=1.6 / (k + 1),
                  max_iterations=(64, 282, 282, 500)[k],
                  julia_c_real=-0.8, julia_c_imag=0.156) for k in range(4)]


@pytest.mark.parametrize("planar", [False, True],
                         ids=["interleaved", "planar"])
@pytest.mark.parametrize("family", ["mandelbrot", "julia"])
def test_batch_render_fn_equals_single_renders(dev, family, planar):
    import dataclasses

    import numpy as np

    from fractalrenderer_tpu_torch import models
    from fractalrenderer_tpu_torch.models import common

    scenes = _batch_scenes(family)
    conv, clamp = common.family_map()[scenes[0].fractal_type][1:]
    cfg = dataclasses.replace(common.scene_static_cfg(
        scenes[0], 200, 113, family, conv, clamp, device=str(dev)),
        max_iter=500)
    dyns = [common.scene_dyn_params(s) for s in scenes]
    batch = {k: np.asarray([d[k] for d in dyns], np.float32)
             for k in dyns[0]}
    before = escape.escape_fields_cuda.launches
    out = common.batch_render_fn(cfg, quantize=8, planar=planar)(batch)
    torch.cuda.synchronize()
    # one K1 launch per frame, no more
    assert escape.escape_fields_cuda.launches - before == len(scenes)
    assert out.device.type == "cuda" and out.dtype == torch.uint8
    f32 = common.batch_render_fn(cfg)(batch)
    for i, s in enumerate(scenes):
        ref = models.render(s, 200, 113, device=dev, quantize=8)
        got = out[i].permute(1, 2, 0) if planar else out[i]
        assert torch.equal(got, ref), i
        assert torch.equal(f32[i], models.render(s, 200, 113, device=dev)), i


def test_c_sweep_is_one_launch_per_c(dev):
    from fractalrenderer_tpu_torch import FractalType, Scene, models
    from fractalrenderer_tpu_torch.models.julia import render_c_sweep

    s = Scene(fractal_type=FractalType.JULIA, max_iterations=128, zoom=3.0)
    cs = [(-0.9 + 0.02 * k, 0.1 + 0.013 * k) for k in range(6)]
    before = escape.escape_fields_cuda.launches
    out = render_c_sweep(s, cs, 160, 90, device=dev)
    torch.cuda.synchronize()
    assert escape.escape_fields_cuda.launches - before == len(cs)
    for i, (cr, ci) in enumerate(cs):
        ref = models.render(s.with_(julia_c_real=cr, julia_c_imag=ci), 160,
                            90, device=dev)
        assert torch.equal(out[i], ref), i


# ---------------------------------------------------------------------------
# Row bands and giant stills (parallel/) over grids that repeat the card
# ---------------------------------------------------------------------------

def _card_mesh(dev, n):
    from fractalrenderer_tpu_torch.parallel import make_render_mesh

    return make_render_mesh(devices=[dev] * n)


@pytest.mark.parametrize("n", [4, 7])
@pytest.mark.parametrize("kind", ["2d", "bulb", "deep"])
def test_sharded_1080p_equals_whole_frame(dev, kind, n):
    # 4 bands of 270 rows, or 7 of 155 with the last clamped to 150
    from fractalrenderer_tpu_torch import FractalType, Scene, models
    from fractalrenderer_tpu_torch.models import deep_zoom, mandelbulb
    from fractalrenderer_tpu_torch.parallel import render_sharded

    mesh = _card_mesh(dev, n)
    if kind == "2d":
        s = Scene(antialiasing_samples=2, orbit_trap_enabled=True)
        got = render_sharded(s, 1920, 1080, mesh=mesh)
        want = models.render(s, 1920, 1080, device=dev)
    elif kind == "bulb":
        s = Scene(fractal_type=FractalType.MANDELBULB, time=1.0)
        got = mandelbulb.render_sharded(s, 1920, 1080, mesh=mesh)
        want = mandelbulb.render(s, 1920, 1080, device=dev)
    else:
        s = Scene(fractal_type=FractalType.DEEP_ZOOM, use_perturbation=True,
                  hp_center_x="-0.743643887037151",
                  hp_center_y="0.13182590420533", hp_zoom="1e-9",
                  max_iterations=1500, samples_per_pixel=2)
        got = deep_zoom.render(s, 1920, 1080, mesh=mesh, device=dev)
        want = deep_zoom.render(s, 1920, 1080, device=dev)
    assert torch.equal(got.cpu(), want.cpu())


def test_giant_2048_equals_the_whole_render(dev, tmp_path):
    from fractalrenderer_tpu_torch import Scene, models
    from fractalrenderer_tpu_torch.models import common
    from fractalrenderer_tpu_torch.parallel import render_giant_still
    from fractalrenderer_tpu_torch.utils.png import read_png

    s = Scene(max_iterations=512, center_x=-0.745, center_y=0.11,
              zoom=0.05)
    out = str(tmp_path / "g.png")
    before = escape.escape_fields_cuda.launches
    info = render_giant_still(s, 2048, 2048, out, band_rows=300,
                              device=dev)
    assert escape.escape_fields_cuda.launches - before == 7
    assert info["rendered"] == 7 and info["fetch_seconds"] >= 0
    want = common.quantize_image(models.render(s, 2048, 2048, device=dev),
                                 bit_depth=16).flip(0).cpu().numpy()
    got = read_png(out)
    assert (got == want).all()
    # the 2x supersampled giant over a 3-band grid of the card
    out2 = str(tmp_path / "ss.png")
    render_giant_still(s, 1024, 1024, out2, band_rows=200, device=dev,
                       supersample=True, use_mesh=True,
                       mesh=_card_mesh(dev, 3))
    from fractalrenderer_tpu_torch.utils.image import downsample2x

    want2 = common.quantize_image(downsample2x(models.render(
        s, 2048, 2048, device=dev)), bit_depth=16).flip(0).cpu().numpy()
    assert (read_png(out2) == want2).all()


def test_every_wrapper_clamps_the_last_band(dev):
    # 1080 rows in 7 bands (155 rows, the last 150) through each kernel's
    # wrapper at its global row0: the rows of the whole frame
    from fractalrenderer_tpu_torch.ops import perturbation
    from fractalrenderer_tpu_torch.parallel.mesh import row_bands

    W, H = 640, 1080
    bands = row_bands(H, 7)
    assert bands[-1] == (930, 150)
    kw = dict(center_x=-0.5, center_y=0.0, zoom=3.0, max_iter=256,
              interior_skip=True, device=dev)
    whole = escape.escape_fields("mandelbrot", W, H, **kw)["n"]
    got = torch.cat([escape.escape_fields("mandelbrot", W, rows, row0=r0,
                                          map_height=H, **kw)["n"]
                     for r0, rows in bands])
    assert torch.equal(got, whole)
    dkw = dict(center_x_dd=dd.dd_from_string("-0.743643887037151"),
               center_y_dd=dd.dd_from_string("0.13182590420533"),
               zoom_dd=dd.dd_from_string("1e-9"), max_iter=800, device=dev)
    whole = dd_escape.dd_escape_fields(W, H, **dkw)
    parts = [dd_escape.dd_escape_fields(W, rows, row0=r0, map_height=H,
                                        **dkw) for r0, rows in bands]
    for k in ("n", "zx", "zy"):
        assert torch.equal(torch.cat([p[k] for p in parts]), whole[k]), k
    from fractalrenderer_tpu_torch.deepzoom import orbit as om

    cx, cy = "-0.743643887037151", "0.13182590420533"
    orb = om.compute_orbit(cx, cy, 64, 1001)
    pkw = dict(center_x_dd=dd.dd_from_string(cx),
               center_y_dd=dd.dd_from_string(cy),
               zoom_dd=dd.dd_from_string("1e-9"), max_iter=1000,
               rebase=True, float_continuation=False, dd_delta=True,
               device=dev)
    whole = perturbation.perturbation_fields(orb, W, H, **pkw)
    parts = [perturbation.perturbation_fields(orb, W, rows, row0=r0,
                                              map_height=H, **pkw)
             for r0, rows in bands]
    for k in ("n", "zx", "zy", "want"):
        assert torch.equal(torch.cat([p[k] for p in parts]), whole[k]), k
    from fractalrenderer_tpu_torch import FractalType, Scene
    from fractalrenderer_tpu_torch.models import mandelbulb

    s = Scene(fractal_type=FractalType.MANDELBULB)
    fn_dyn = mandelbulb.dyn_params(s)
    whole = mandelbulb.band_render_fn(s, W, H, H, device=dev)(fn_dyn, 0)
    got = torch.cat([mandelbulb.band_render_fn(s, W, rows, H, device=dev)(
        fn_dyn, r0) for r0, rows in bands])
    assert torch.equal(got, whole)


# ---- the live session on the card ----------------------------------------

def _plain_on_card(monkeypatch):
    """Point every kernel wrapper the session reaches at its plain version,
    which then runs on the card (chip_smoke.py's plain_kernels)."""
    from fractalrenderer_tpu_torch.ops import perturbation

    for mod, cuda, plain in (
            (escape, "escape_fields_cuda", "escape_fields_plain"),
            (dd_escape, "dd_escape_fields_cuda", "dd_escape_fields_plain"),
            (perturbation, "perturbation_fields_cuda",
             "perturbation_fields_plain"),
            (bulb_kernel, "cone_fields_cuda", "cone_fields_plain"),
            (bulb_kernel, "march_fields_cuda", "march_fields_plain")):
        monkeypatch.setattr(mod, cuda, getattr(mod, plain))


_LIVE_PATHS = {
    # name: (scene fields, gfx kind or None, rows of the frame compared)
    "planar": (dict(max_iterations=512), "sixel", None),
    "cell": (dict(max_iterations=256, fractal_type="julia"), None, None),
    "deep": (dict(fractal_type="deep_zoom", use_perturbation=True,
                  hp_center_x="-0.74364388703715158",
                  hp_center_y="0.13182590420531198", hp_zoom="1e-12",
                  max_iterations=2000), "sixel", 64),
    "bulb": (dict(fractal_type="mandelbulb", max_iterations=64), "sixel",
             None),
}


@pytest.mark.parametrize("path", list(_LIVE_PATHS))
def test_live_session_frame_equals_plain(dev, monkeypatch, path):
    """One session frame per path on cuda:0 (the sixel pixel session at
    320x240, the half-block one at 80x48), bit-equal to the same dispatch
    with the plain versions on the card; the deep frame's middle 64 rows
    against a 64-row plain band (K3's plain version is launch-bound)."""
    from fractalrenderer_tpu_torch import gfx, live
    from fractalrenderer_tpu_torch.scene import Scene

    fields, kind, band = _LIVE_PATHS[path]
    monkeypatch.setenv("COLUMNS", "40")
    monkeypatch.setenv("LINES", "16")
    scene = Scene.from_dict(fields)
    sess = live.LiveSession(scene, cols=80, rows=24, device=dev)
    if kind:
        sess.enable_gfx(gfx.GfxInfo(kind, None))
    frame = sess.dispatch()
    torch.cuda.synchronize()
    assert frame.device == dev
    with monkeypatch.context() as m:
        _plain_on_card(m)
        if band is None:
            want = sess.dispatch()
        else:
            from fractalrenderer_tpu_torch.models import deep_zoom

            h = sess.height
            r0 = h // 2 - band // 2
            want = deep_zoom.render(scene, sess.width, h, quantize=8,
                                    device=dev, row_band=(r0, band))
            frame = frame[r0:r0 + band]
    assert frame.shape == want.shape and frame.dtype == want.dtype
    assert torch.equal(frame, want), path


def test_two_frames_in_flight_pop_by_their_events(dev, monkeypatch):
    """FRAME_OVERLAP=2 on the card: two planar frames dispatched back to
    back, each with a CUDA event recorded behind it; the oldest is popped
    when its event completes (or when two are in flight), and the fetched
    frames are the frames."""
    from collections import deque

    import numpy as np

    from fractalrenderer_tpu_torch import gfx, live
    from fractalrenderer_tpu_torch.scene import Scene

    monkeypatch.setenv("COLUMNS", "240")
    monkeypatch.setenv("LINES", "68")
    sess = live.LiveSession(Scene(max_iterations=2048), device=dev)
    sess.enable_gfx(gfx.GfxInfo("sixel", None))
    q = deque()
    for k in range(2):
        sess.scene = sess.scene.with_(zoom=2.5 - 0.1 * k)
        f = sess.dispatch()
        ev = live.frame_event(f)
        assert isinstance(ev, torch.cuda.Event)
        q.append((k, f, ev))
    t0, first, ev0 = live.pop_ready(q)       # two in flight: the oldest
    assert t0 == 0 and len(q) == 1
    host = live.fetch(first)                  # waits for its kernels
    assert ev0.query()
    ev1 = q[0][2]
    ev1.synchronize()
    t1, second, _ = live.pop_ready(q)
    assert t1 == 1 and not q
    np.testing.assert_array_equal(host, first.cpu().numpy())
    assert host.shape == (3, 1072, 1920) and host.dtype == np.uint8
    assert not torch.equal(first, second)
