"""The port's escape kernel K1 (plain PyTorch version on CPU) against the
numpy golden reference and the JAX package's Pallas kernel, for the four
families.

Contract:
- against ``reference/golden.py``: 0 iteration-count mismatches and
  bit-equal zx/zy, at every height (not only powers of two); pixels taken
  by the analytic interior skip are exempt from the z comparison and must
  report z = 0; bit-equal traps; the Burning Ship stripe within rtol 1e-3,
  atol 2e-4·iters;
- against the JAX ``escape_fields`` in interpret mode (XLA:CPU contracts
  FMAs, so it is itself not exact): the mismatch fractions of
  test_golden_vs_kernel.py (0.005 at the default view, 0.08 at Seahorse).
"""
import functools

import numpy as np
import pytest
import torch

from fractalrenderer_tpu.ops import escape as jax_escape
from fractalrenderer_tpu.presets import JULIA_PRESETS
from fractalrenderer_tpu.reference import golden
from fractalrenderer_tpu_torch.ops import escape

SEAHORSE = (-0.743643887037151, 0.13182590420533, 0.008)


def _random_view(seed):
    rng = np.random.default_rng(seed)
    return dict(width=int(rng.integers(40, 161)),
                height=int(rng.integers(30, 91)),
                cx=float(rng.uniform(-2.0, 0.5)),
                cy=float(rng.uniform(-1.2, 1.2)),
                zoom=float(10.0 ** rng.uniform(-3.0, 0.5)),
                iters=int(rng.integers(32, 257)))


VIEWS = {
    "default_96x64": dict(width=96, height=64, cx=-0.5, cy=0.0, zoom=3.0,
                          iters=96),
    "default_100x75": dict(width=100, height=75, cx=-0.5, cy=0.0, zoom=3.0,
                           iters=256),
    "seahorse_120x90": dict(width=120, height=90, cx=SEAHORSE[0],
                            cy=SEAHORSE[1], zoom=SEAHORSE[2], iters=256),
    **{f"random_{s}": _random_view(s) for s in range(4)},
}


@functools.lru_cache(maxsize=None)
def _golden(name):
    v = VIEWS[name]
    n, zx, zy, _ = golden.mandelbrot_fields(
        v["width"], v["height"], v["cx"], v["cy"], v["zoom"], v["iters"],
        4.0)
    return n, zx, zy


def _port(v, **kw):
    f = escape.escape_fields(
        "mandelbrot", v["width"], v["height"], center_x=v["cx"],
        center_y=v["cy"], zoom=v["zoom"], max_iter=v["iters"], device="cpu",
        **kw)
    return {k: t.numpy() for k, t in f.items()}


@pytest.mark.parametrize("interior_skip", [False, True])
@pytest.mark.parametrize("name", sorted(VIEWS))
def test_plain_is_bit_exact_vs_golden(name, interior_skip):
    v = VIEWS[name]
    n, zx, zy = _golden(name)
    f = _port(v, interior_skip=interior_skip)
    assert f["n"].dtype == np.int32 and f["zx"].dtype == np.float32
    assert int((f["n"] != n).sum()) == 0
    if interior_skip:
        skipped = escape._cardioid_or_bulb(
            *_mapped(v)).numpy()
        assert (f["n"][skipped] == v["iters"]).all()
        assert (f["zx"][skipped] == 0).all() and (f["zy"][skipped] == 0).all()
        keep = ~skipped
    else:
        keep = np.ones_like(n, bool)
    np.testing.assert_array_equal(f["zx"][keep], zx[keep])
    np.testing.assert_array_equal(f["zy"][keep], zy[keep])


def _mapped(v):
    from fractalrenderer_tpu_torch.ops import mapping

    py, px = torch.meshgrid(torch.arange(v["height"], dtype=torch.float32),
                            torch.arange(v["width"], dtype=torch.float32),
                            indexing="ij")
    return mapping.map_centered(px, py, v["width"], v["height"], v["cx"],
                                v["cy"], v["zoom"], 0.0, 0.0)


def test_interior_skip_takes_pixels_at_default_view():
    # the skip must actually fire on the main path's view
    v = VIEWS["default_100x75"]
    assert int(escape._cardioid_or_bulb(*_mapped(v)).sum()) > 0.1 * 100 * 75


@pytest.mark.parametrize("name,frac", [("default_96x64", 0.005),
                                       ("seahorse_120x90", 0.08)])
def test_plain_close_to_jax_kernel(name, frac):
    v = VIEWS[name]
    f = jax_escape.escape_fields(
        "mandelbrot", v["width"], v["height"], center_x=v["cx"],
        center_y=v["cy"], zoom=v["zoom"], max_iter=v["iters"],
        interior_skip=True)
    mine = _port(v, interior_skip=True)
    assert (mine["n"] != np.asarray(f["n"])).mean() <= frac


def test_partial_sizes_exact():
    # twin of test_partial_tiles: odd sizes, no sentinel leaks
    f = escape.escape_fields("mandelbrot", 37, 23, center_x=-0.5,
                             center_y=0.0, zoom=3.0, max_iter=32,
                             device="cpu")
    n, *_ = golden.mandelbrot_fields(37, 23, -0.5, 0.0, 3.0, 32, 4.0)
    np.testing.assert_array_equal(f["n"].numpy(), n)
    assert f["n"].min() >= 0


def test_iter_limit_dynamic():
    # iter_limit below the static cap freezes n at the limit
    kw = dict(center_x=-0.5, center_y=0.0, zoom=3.0, device="cpu")
    f_lim = escape.escape_fields("mandelbrot", 64, 32, max_iter=128,
                                 iter_limit=40, **kw)
    f_ref = escape.escape_fields("mandelbrot", 64, 32, max_iter=40, **kw)
    assert torch.equal(f_lim["n"], f_ref["n"])
    assert int(f_lim["n"].max()) == 40


def test_oversized_iter_limit_clamps_to_static_cap():
    kw = dict(center_x=-0.5, center_y=0.0, zoom=3.0, max_iter=96,
              device="cpu")
    f = escape.escape_fields("mandelbrot", 32, 16, iter_limit=10 ** 8, **kw)
    assert int(f["n"].max()) == 96
    f2 = escape.escape_fields("mandelbrot", 32, 16, **kw)
    assert torch.equal(f["n"], f2["n"])


def test_iter_limit_inside_bucket_is_exact():
    # twin of the second half of test_iteration_counts_share_compile_bucket
    f = escape.escape_fields("mandelbrot", 48, 32, center_x=-0.5,
                             center_y=0.0, zoom=3.0, max_iter=512,
                             iter_limit=300, device="cpu")
    assert int(f["n"].max()) == 300
    nref, *_ = golden.mandelbrot_fields(48, 32, -0.5, 0.0, 3.0, 300, 4.0)
    np.testing.assert_array_equal(f["n"].numpy(), nref)


def test_row_band_equals_whole_frame_rows():
    kw = dict(center_x=-0.5, center_y=0.0, zoom=3.0, max_iter=64,
              interior_skip=True, device="cpu")
    full = escape.escape_fields("mandelbrot", 40, 30, **kw)
    band = escape.escape_fields("mandelbrot", 40, 10, row0=12, map_height=30,
                                **kw)
    for k in ("n", "zx", "zy"):
        assert torch.equal(band[k], full[k][12:22])


_PACK_CASES = [
    dict(center_x=-0.5, center_y=0.0, zoom=3.0, max_iter=256),
    dict(center_x=-0.743643887037151, center_y=0.13182590420533,
         zoom=0.008, max_iter=1024, bailout=2.5, iter_limit=0.25,
         offset=(0.5, 0.25), row0=270.0),
    dict(center_x=0.1, center_y=-0.3, zoom=1.7, max_iter=512,
         iter_limit=10 ** 8, color_offset=0.37, color_scale=2.5,
         brightness=1.4, saturation=0.6, contrast=1.2),
]


@pytest.mark.parametrize("kw", _PACK_CASES)
def test_pack_params_matches_jax_layout(kw, monkeypatch):
    seen = {}

    def fake_call(params, **static):
        seen["params"] = np.asarray(params)
        return (np.zeros((2, 2), np.int32),) + (np.zeros((2, 2)),) * 2

    monkeypatch.setattr(jax_escape, "_escape_call", fake_call)
    jax_escape.escape_fields("mandelbrot", 2, 2, **kw)
    kw = dict(kw)
    max_iter = kw.pop("max_iter")
    kw.setdefault("iter_limit", max_iter)
    got = escape.pack_params(**kw)
    assert got.dtype == np.float32 and got.shape == (escape.NPARAMS,)
    np.testing.assert_array_equal(got, seen["params"].reshape(-1))
    for name in ("P_CX", "P_LIMIT", "P_ROW0", "P_STRIPE", "NPARAMS"):
        assert getattr(escape, name) == getattr(jax_escape, name)


def test_launch_checks():
    kw = dict(center_x=-0.5, center_y=0.0, zoom=3.0, max_iter=32)
    cpu = dict(kw, device="cpu")
    with pytest.raises(ValueError, match="outside the image height"):
        escape.escape_fields("mandelbrot", 8, 8, row0=4, map_height=8, **cpu)
    with pytest.raises(ValueError, match="2\\^24"):
        escape.escape_fields("mandelbrot", 8, 8, **dict(cpu, max_iter=1 << 24))
    # every family runs now; an unknown one is refused as in the JAX package
    f = escape.escape_fields("julia", 8, 8, **cpu)
    assert f["n"].shape == (8, 8)
    with pytest.raises(ValueError, match="unknown family"):
        escape.escape_fields("newton", 8, 8, **cpu)
    # the JAX asserts: fused + tracking, fused Mandelbrot trap glow
    with pytest.raises(ValueError, match="interior_style 2"):
        escape.escape_fields("mandelbrot", 8, 8, fused_color=(0, 2, False),
                             **cpu)
    with pytest.raises(ValueError, match="trap/stripe/deriv"):
        escape.escape_fields("burning_ship", 8, 8, fused_color=(0, 0, True),
                             track_trap=True, **cpu)
    with pytest.raises(ValueError, match="unsupported device"):
        escape.escape_fields("mandelbrot", 8, 8, device="meta", **kw)


# ---------------------------------------------------------------------------
# The other families and the aux outputs
# ---------------------------------------------------------------------------

ITERS = 96
FAMILY_VIEWS = {
    # (golden function args, port escape_fields kwargs)
    "julia": dict(cx=0.0, cy=0.0, zoom=3.0, julia_c=(-0.7, 0.27015)),
    "burning_ship": dict(cx=-0.5, cy=-0.6, zoom=2.0),
    "phoenix": dict(cx=0.0, cy=0.0, zoom=3.0, julia_c=(0.5667, 0.0),
                    phoenix_p=0.0, phoenix_r=-0.5, use_julia=False),
    "phoenix_julia": dict(cx=0.0, cy=0.0, zoom=3.0, julia_c=(0.3, 0.2),
                          phoenix_p=0.1, phoenix_r=-0.3, use_julia=True),
}


def _golden_family(name, w, h, iters=ITERS):
    v = FAMILY_VIEWS[name]
    if name == "julia":
        return golden.julia_fields(w, h, v["cx"], v["cy"], v["zoom"],
                                   *v["julia_c"], iters, 4.0)
    if name == "burning_ship":
        return golden.burning_ship_fields(w, h, v["cx"], v["cy"], v["zoom"],
                                          iters, 4.0, True, 0.5, True, 10.0,
                                          2)
    return golden.phoenix_fields(w, h, v["cx"], v["cy"], v["zoom"], iters,
                                 v["julia_c"], v["use_julia"],
                                 v["phoenix_p"], v["phoenix_r"])


def _port_family(name, w, h, iters=ITERS, **kw):
    v = dict(FAMILY_VIEWS[name])
    family = "phoenix" if name.startswith("phoenix") else name
    f = escape.escape_fields(family, w, h, center_x=v.pop("cx"),
                             center_y=v.pop("cy"), zoom=v.pop("zoom"),
                             max_iter=iters, device="cpu", **v, **kw)
    return {k: t.numpy() for k, t in f.items()}


@pytest.mark.parametrize("size", [(96, 64), (100, 75)], ids=str)
@pytest.mark.parametrize("name", sorted(FAMILY_VIEWS))
def test_family_plain_is_bit_exact_vs_golden(name, size):
    kw = dict(track_trap=True, track_stripe=True) \
        if name == "burning_ship" else {}
    f = _port_family(name, *size, **kw)
    n, zx, zy = _golden_family(name, *size)[:3]
    assert int((f["n"] != n).sum()) == 0
    np.testing.assert_array_equal(f["zx"], zx)
    np.testing.assert_array_equal(f["zy"], zy)
    if name == "phoenix_julia":  # the pixel is ignored: one orbit for all
        assert (f["n"] == f["n"][0, 0]).all()


@pytest.mark.parametrize("preset", sorted(JULIA_PRESETS))
def test_julia_presets_bit_exact_vs_golden(preset):
    cr, ci = JULIA_PRESETS[preset]
    f = escape.escape_fields("julia", 64, 32, center_x=0.0, center_y=0.0,
                             zoom=3.0, max_iter=64, julia_c=(cr, ci),
                             device="cpu")
    n, zx, zy = golden.julia_fields(64, 32, 0.0, 0.0, 3.0, cr, ci, 64, 4.0)
    np.testing.assert_array_equal(f["n"].numpy(), n)
    np.testing.assert_array_equal(f["zx"].numpy(), zx)
    np.testing.assert_array_equal(f["zy"].numpy(), zy)


@pytest.mark.parametrize("size", [(96, 64), (100, 75)], ids=str)
def test_aux_fields_vs_golden(size):
    # traps bit-exact; the stripe (a sum of sin terms) within the JAX
    # contract rtol 1e-3, atol 2e-4 * iters (test_golden_vs_kernel.py)
    f = _port_family("burning_ship", *size, track_trap=True,
                     track_stripe=True)
    _, _, _, trap, stripe = _golden_family("burning_ship", *size)
    np.testing.assert_array_equal(f["trap"], trap)
    np.testing.assert_allclose(f["stripe"], stripe, rtol=1e-3,
                               atol=2e-4 * ITERS)
    assert np.abs(f["stripe"]).max() > 1.0  # the stripe really accumulates
    w, h = size
    m = escape.escape_fields("mandelbrot", w, h, center_x=-0.5,
                             center_y=0.0, zoom=3.0, max_iter=ITERS,
                             track_trap=True, device="cpu")
    _, _, _, mtrap = golden.mandelbrot_fields(w, h, -0.5, 0.0, 3.0, ITERS,
                                              4.0)
    np.testing.assert_array_equal(m["trap"].numpy(), mtrap)


def test_aux_outputs_follow_the_jax_gating():
    kw = dict(center_x=0.0, center_y=0.0, zoom=3.0, max_iter=32,
              track_trap=True, track_stripe=True, track_deriv=True,
              interior_skip=True)
    # julia/phoenix: constant trap 0 and stripe 0, no dz, no skip
    for family in ("julia", "phoenix"):
        f = escape.escape_fields(family, 24, 16, device="cpu", **kw)
        assert list(f) == ["n", "zx", "zy", "trap", "stripe"]
        assert (f["trap"] == 0).all() and (f["stripe"] == 0).all()
    f = escape.escape_fields("mandelbrot", 24, 16, device="cpu", **kw)
    assert list(f) == ["n", "zx", "zy", "trap", "stripe", "dzx", "dzy"]
    assert (f["stripe"] == 0).all()
    assert torch.isfinite(f["trap"]).all()


@pytest.mark.parametrize("name,frac", [("julia", 0.005),
                                       ("burning_ship", 0.05),
                                       ("phoenix", 0.005)])
def test_family_plain_close_to_jax_kernel(name, frac):
    # the JAX kernel in interpret mode is not count-exact on CPU (XLA:CPU
    # contracts FMAs): the mismatch fractions of test_golden_vs_kernel.py
    v = dict(FAMILY_VIEWS[name])
    kw = dict(center_x=v.pop("cx"), center_y=v.pop("cy"), zoom=v.pop("zoom"),
              max_iter=ITERS, **v)
    if name == "burning_ship":
        kw.update(track_trap=True, track_stripe=True)
    ref = jax_escape.escape_fields(name, W_JAX, H_JAX, **kw)
    mine = escape.escape_fields(name, W_JAX, H_JAX, device="cpu", **kw)
    assert list(mine) == list(ref)
    assert (mine["n"].numpy() != np.asarray(ref["n"])).mean() <= frac


W_JAX, H_JAX = 96, 64


def test_derivative_close_to_jax_kernel():
    # dz compared on pixels where n agrees: XLA:CPU's FMA contraction moves
    # the orbit by ulps, which the derivative amplifies, so the bound is a
    # relative difference <= 1e-2 on >= 99% of them, with inf/NaN at the
    # same pixels
    kw = dict(center_x=-0.5, center_y=0.0, zoom=3.0, max_iter=ITERS,
              track_deriv=True, track_trap=True)
    ref = jax_escape.escape_fields("mandelbrot", W_JAX, H_JAX, **kw)
    mine = escape.escape_fields("mandelbrot", W_JAX, H_JAX, device="cpu",
                                **kw)
    same = mine["n"].numpy() == np.asarray(ref["n"])
    assert same.mean() >= 0.995
    for k in ("dzx", "dzy"):
        a, b = np.asarray(ref[k])[same], mine[k].numpy()[same]
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        fin = np.isfinite(b)
        rel = np.abs(a[fin] - b[fin]) / np.maximum(np.abs(b[fin]), 1e-30)
        assert (rel <= 1e-2).mean() >= 0.99, k
    np.testing.assert_allclose(mine["trap"].numpy()[same],
                               np.asarray(ref["trap"])[same], rtol=1e-4,
                               atol=1e-5)


_FAMILY_PACK_CASES = [
    ("julia", dict(center_x=0.0, center_y=0.0, zoom=3.0, max_iter=256,
                   julia_c=(-0.7, 0.27015), bailout=3.0)),
    ("burning_ship", dict(center_x=-0.5, center_y=-0.6, zoom=2.0,
                          max_iter=512, trap_radius=0.3,
                          stripe_density=12.5, iter_limit=300,
                          offset=(0.001, -0.002))),
    ("phoenix", dict(center_x=0.1, center_y=0.2, zoom=3.0, max_iter=256,
                     julia_c=(0.5667, 0.1), phoenix_p=0.2,
                     phoenix_r=-0.3, bailout=9.0, stripe_density=5.0,
                     color_offset=0.2, brightness=1.3, row0=12.0)),
    ("mandelbrot", dict(center_x=-0.5, center_y=0.0, zoom=3.0, max_iter=256,
                        julia_c=(0.3, 0.3), trap_radius=0.7,
                        phoenix_p=0.5)),
]


@pytest.mark.parametrize("family,kw", _FAMILY_PACK_CASES,
                         ids=[c[0] for c in _FAMILY_PACK_CASES])
def test_pack_params_matches_jax_layout_per_family(family, kw, monkeypatch):
    seen = {}

    def fake_call(params, **static):
        seen["params"] = np.asarray(params)
        seen["static"] = static
        return (np.zeros((2, 2), np.int32),) + (np.zeros((2, 2)),) * 2

    monkeypatch.setattr(jax_escape, "_escape_call", fake_call)
    jax_escape.escape_fields(family, 2, 2, **kw)
    kw = dict(kw)
    max_iter = kw.pop("max_iter")
    kw.setdefault("iter_limit", max_iter)
    got = escape.pack_params(family=family, **kw)
    np.testing.assert_array_equal(got, seen["params"].reshape(-1))


# -- K1's and K2's per-warp counters (csrc/warp_counters.cuh) -------------

def _trips_rows(rows):
    """A trips buffer from (trips, lane_iters, pixels, looped, smid,
    loop_clk, epi_clk, start, loop, end) tuples, the times split into lo/hi
    int32 words."""
    out = []
    for *c, t0, t1, t2 in rows:
        words = []
        for t in (t0, t1, t2):
            lo = np.array([t & 0xFFFFFFFF], np.uint32).view(np.int32)[0]
            words += [int(lo), t >> 32]
        out.append([*c, *words])
    return torch.tensor(out, dtype=torch.int32)


def test_decode_trips_sums_shares_and_residency():
    base = 7 << 32  # times above 2^32 ns: the hi words count
    buf = _trips_rows([
        # three warps on SM 0 and one on SM 1 run from 0 to 100; one warp
        # of SM 1 runs on alone to 400 (the tail: 300 of the 400 ns span)
        (10, 200, 32, 32, 0, 300, 100, base, base + 60, base + 100),
        (10, 100, 32, 20, 0, 300, 100, base, base + 50, base + 100),
        (10, 320, 32, 32, 0, 200, 200, base, base + 50, base + 100),
        (8, 250, 32, 32, 1, 100, 100, base, base + 40, base + 100),
        (40, 600, 16, 16, 1, 900, 100, base, base + 350, base + 400),
        # a warp that finished no pixel: left out
        (3, 0, 0, 0, 2, 5, 5, base, base + 800, base + 900),
    ])
    c = escape.decode_trips(buf)
    assert c["warps"] == 5 and c["sms"] == 2
    assert (c["trips"], c["lane_iters"], c["pixels"],
            c["looped"]) == (78, 1470, 144, 132)
    assert c["lane_util"] == pytest.approx(1470 / (32 * 78))
    assert c["loop_share"] == pytest.approx(1800 / 2400)
    assert c["loop_share_ns"] == pytest.approx(550 / 800)
    assert c["span_ns"] == 400
    assert c["tail_share"] == pytest.approx(300 / 400)
    # 800 warp-ns over 400 ns on 2 SMs; SM 0 holds three warps at once
    assert c["warps_per_sm_mean"] == pytest.approx(1.0)
    assert c["warps_per_sm_peak"] == 3


def test_decode_trips_of_one_wave_without_tail():
    # every warp ends at once: no tail, every lane busy in every trip
    buf = _trips_rows([(5, 160, 32, 32, s, 10, 10, 1000, 1500, 2000)
                       for s in range(4)])
    c = escape.decode_trips(buf)
    assert c["tail_share"] == 0.0 and c["span_ns"] == 1000
    assert c["lane_util"] == 1.0 and c["loop_share"] == 0.5
    assert c["warps_per_sm_mean"] == 1.0 and c["warps_per_sm_peak"] == 1


@pytest.mark.parametrize("bad", [
    dict(shape=(7, len(escape.TRIP_FIELDS))),
    dict(shape=(8, len(escape.TRIP_FIELDS) - 1)),
    dict(shape=(8, len(escape.TRIP_FIELDS)), dtype=torch.float32),
], ids=["rows", "fields", "dtype"])
def test_check_trips_rejects_a_wrong_buffer(bad):
    dev = torch.device("cpu")
    escape.check_trips(None, 8, dev)
    escape.check_trips(torch.zeros((8, len(escape.TRIP_FIELDS)),
                                   dtype=torch.int32), 8, dev)
    buf = torch.zeros(bad["shape"], dtype=bad.get("dtype", torch.int32))
    with pytest.raises(ValueError, match="trips buffer"):
        escape.check_trips(buf, 8, dev)


@pytest.mark.parametrize("size,warps", [((1, 1), 8), ((32, 8), 8),
                                        ((65, 33), 3 * 5 * 8),
                                        ((1920, 1080), 60 * 135 * 8)],
                         ids=str)
def test_trips_buffer_has_a_row_per_warp_of_the_grid(size, warps):
    # one thread per pixel in 32 x 8 blocks: every warp of the grid has a
    # row, those past the field's bottom edge stay zero
    assert escape.launch_warps(*size) == warps
    buf = escape.trips_buffer(*size, device="cpu")
    assert buf.shape == (warps, len(escape.TRIP_FIELDS))
    assert buf.dtype == torch.int32 and not bool(buf.any())
    from fractalrenderer_tpu_torch.ops import dd_escape
    assert dd_escape.trips_buffer is escape.trips_buffer


def _planes(shape=(3, 6, 8), dtype=torch.uint8):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("bad", [
    dict(planes=_planes(dtype=torch.float32)),
    dict(planes=_planes(dtype=torch.int16)),
    dict(planes=_planes((2, 6, 8))),
    dict(planes=_planes((3, 8, 6))),
    dict(planes=_planes((3, 8, 6)).transpose(1, 2)),
    dict(planes=_planes((3, 12, 8))[:, 2:8]),
    dict(planes=_planes(), dev=torch.device("cuda", 0)),
    dict(planes=_planes(), fused=False),
], ids=["f32", "int16", "planes", "rows", "transposed", "band_view",
        "device", "fields"])
def test_check_quantized_rejects_wrong_planes(bad):
    # what the launch would store into is checked without a card
    dev = torch.device("cpu")
    assert escape.check_quantized(None, True, 6, 8, dev) == 0
    assert escape.check_quantized(_planes(), True, 6, 8, dev) == escape.F_Q8
    assert escape.check_quantized(_planes(dtype=torch.uint16), True, 6, 8,
                                  dev) == escape.F_Q16
    with pytest.raises(ValueError, match="quantized planes"):
        escape.check_quantized(bad["planes"], bad.get("fused", True), 6, 8,
                               bad.get("dev", dev))


_QUANTIZED_VIEWS = {
    "mandelbrot": dict(center_x=-0.5, center_y=0.0, zoom=3.0),
    "julia": dict(center_x=0.0, center_y=0.0, zoom=3.0,
                  julia_c=(-0.7, 0.27015)),
    "burning_ship": dict(center_x=-0.5, center_y=-0.6, zoom=2.0),
    "phoenix": dict(center_x=0.0, center_y=0.0, zoom=3.0,
                    julia_c=(0.5667, 0.0), phoenix_p=0.1, phoenix_r=-0.5,
                    stripe_density=8.0),
}


@pytest.mark.parametrize("band", [False, True], ids=["frame", "band"])
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("family", sorted(_QUANTIZED_VIEWS))
def test_plain_quantized_planes_equal_quantize_image(family, bits, band):
    # the plain K1's quantized store is quantize_image of its f32 planes,
    # and the result's planes are views of the tensor it was given
    from fractalrenderer_tpu_torch.ops.coloring import quantize_image

    w, h, full_h, row0 = (48, 10, 30, 12) if band else (48, 30, 30, 0)
    dtype = torch.uint8 if bits == 8 else torch.uint16
    kw = dict(width=w, height=h, map_height=full_h, row0=row0, max_iter=64,
              interior_skip=family == "mandelbrot",
              fused_color=(0, 0, family != "mandelbrot"), color_offset=0.3,
              color_scale=1.7, brightness=1.2, saturation=0.8, contrast=1.3,
              device="cpu", **_QUANTIZED_VIEWS[family])
    f32 = escape.escape_fields(family, **kw)
    q = torch.full((3, h, w), 7, dtype=dtype)
    got = escape.escape_fields(family, quantized=q, **kw)
    want = quantize_image(torch.stack([f32[c] for c in "rgb"]),
                          bit_depth=bits)
    assert torch.equal(q, want)
    assert [got[c].data_ptr() for c in "rgb"] == [p.data_ptr() for p in q]
