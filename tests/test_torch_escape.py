"""The port's escape kernel K1 (plain PyTorch version on CPU) against the
numpy golden reference and the JAX package's Pallas kernel.

Contract:
- against ``reference/golden.py``: 0 iteration-count mismatches and
  bit-equal zx/zy, at every height (not only powers of two); pixels taken
  by the analytic interior skip are exempt from the z comparison and must
  report z = 0;
- against the JAX ``escape_fields`` in interpret mode (XLA:CPU contracts
  FMAs, so it is itself not exact): the mismatch fractions of
  test_golden_vs_kernel.py (0.005 at the default view, 0.08 at Seahorse).
"""
import functools

import numpy as np
import pytest
import torch

from fractalrenderer_tpu.ops import escape as jax_escape
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
        center_y=v["cy"], zoom=v["zoom"], max_iter=v["iters"], **kw)
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
                             center_y=0.0, zoom=3.0, max_iter=32)
    n, *_ = golden.mandelbrot_fields(37, 23, -0.5, 0.0, 3.0, 32, 4.0)
    np.testing.assert_array_equal(f["n"].numpy(), n)
    assert f["n"].min() >= 0


def test_iter_limit_dynamic():
    # iter_limit below the static cap freezes n at the limit
    kw = dict(center_x=-0.5, center_y=0.0, zoom=3.0)
    f_lim = escape.escape_fields("mandelbrot", 64, 32, max_iter=128,
                                 iter_limit=40, **kw)
    f_ref = escape.escape_fields("mandelbrot", 64, 32, max_iter=40, **kw)
    assert torch.equal(f_lim["n"], f_ref["n"])
    assert int(f_lim["n"].max()) == 40


def test_oversized_iter_limit_clamps_to_static_cap():
    kw = dict(center_x=-0.5, center_y=0.0, zoom=3.0, max_iter=96)
    f = escape.escape_fields("mandelbrot", 32, 16, iter_limit=10 ** 8, **kw)
    assert int(f["n"].max()) == 96
    f2 = escape.escape_fields("mandelbrot", 32, 16, **kw)
    assert torch.equal(f["n"], f2["n"])


def test_iter_limit_inside_bucket_is_exact():
    # twin of the second half of test_iteration_counts_share_compile_bucket
    f = escape.escape_fields("mandelbrot", 48, 32, center_x=-0.5,
                             center_y=0.0, zoom=3.0, max_iter=512,
                             iter_limit=300)
    assert int(f["n"].max()) == 300
    nref, *_ = golden.mandelbrot_fields(48, 32, -0.5, 0.0, 3.0, 300, 4.0)
    np.testing.assert_array_equal(f["n"].numpy(), nref)


def test_row_band_equals_whole_frame_rows():
    kw = dict(center_x=-0.5, center_y=0.0, zoom=3.0, max_iter=64,
              interior_skip=True)
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
    with pytest.raises(ValueError, match="outside the image height"):
        escape.escape_fields("mandelbrot", 8, 8, row0=4, map_height=8, **kw)
    with pytest.raises(ValueError, match="2\\^24"):
        escape.escape_fields("mandelbrot", 8, 8, **dict(kw, max_iter=1 << 24))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        escape.escape_fields("julia", 8, 8, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        escape.escape_fields("mandelbrot", 8, 8, fused_color=(0, 2, False),
                             **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        escape.escape_fields("mandelbrot", 8, 8, device="meta", **kw)
