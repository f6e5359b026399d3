"""The port's double-double tier: ops/dd.py, kernel K2's plain version
(ops/dd_escape.py) and models/mandelbrot.render_dd, against the JAX
package.

Contract:
- the plain dd fields are bit-equal to a numpy loop built from the JAX
  package's ops/dd.py with ``xp=numpy``, mirroring dd_escape._make_kernel;
- against the f64 oracle, the count mismatch is < 0.02 at zoom 3 and
  < 0.2 at 1e-9 (test_deepzoom.py:413-451);
- ``pack_dd_params`` equals the 11 floats the JAX ``dd_escape_fields``
  hands to ``_dd_call``; ``dd_from_string`` equals the JAX function;
- ``render_dd`` equals the JAX colour pipeline run on the same fields
  within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fractalrenderer_tpu as fr
import fractalrenderer_tpu_torch as frt
from fractalrenderer_tpu.ops import coloring as jax_coloring
from fractalrenderer_tpu.ops import dd as jax_dd
from fractalrenderer_tpu.ops import dd_escape as jax_dd_escape
from fractalrenderer_tpu_torch.models.mandelbrot import render_dd
from fractalrenderer_tpu_torch.ops import dd, dd_escape

SEAHORSE = ("-0.743643887037151", "0.13182590420533")
HP_STRINGS = ["0", "-0.5", "3", "1e-9", "1e-12", SEAHORSE[0], SEAHORSE[1],
              "-1.74975914513036646165693",
              "0.0000000000000000000000000000000000000123",
              "123456789.987654321", "1e-45", "-7e-46", "3.4e38", "1e39"]


@pytest.mark.parametrize("s", HP_STRINGS)
def test_dd_from_string_matches_jax(s):
    assert dd.dd_from_string(s) == jax_dd.dd_from_string(s)


@pytest.mark.parametrize("v", [0.1, -0.743643887037151, 1e-9, 3.0, -1e-40])
def test_dd_from_double_matches_jax(v):
    assert dd.dd_from_double(v) == jax_dd.dd_from_double(v)


def test_dd_ops_match_jax_numpy():
    rng = np.random.default_rng(5)
    f = np.float32
    a = (rng.uniform(-2, 2, 512).astype(f), rng.uniform(-1e-8, 1e-8,
                                                          512).astype(f))
    b = (rng.uniform(-2, 2, 512).astype(f), rng.uniform(-1e-8, 1e-8,
                                                          512).astype(f))
    s = rng.uniform(-3, 3, 512).astype(f)
    ta, tb = (tuple(map(torch.from_numpy, a)), tuple(map(torch.from_numpy, b)))
    ts = torch.from_numpy(s)
    pairs = [
        (dd.two_sum(ta[0], tb[0]), jax_dd.two_sum(np, a[0], b[0])),
        (dd.split(ta[0]), jax_dd.split(np, a[0])),
        (dd.two_prod(ta[0], tb[0]), jax_dd.two_prod(np, a[0], b[0])),
        (dd.dd_add(ta, tb), jax_dd.dd_add(np, a, b)),
        (dd.dd_add_float(ta, ts), jax_dd.dd_add_float(np, a, s)),
        (dd.dd_mul_float(ta, ts), jax_dd.dd_mul_float(np, a, s)),
        (dd.dd_mul(ta, tb), jax_dd.dd_mul(np, a, b)),
        (dd.dd_sub(ta, tb), jax_dd.dd_sub(np, a, b)),
        (dd.ddc_square_add(ta, tb, tb, ta)[0],
         jax_dd.ddc_square_add(np, a, b, b, a)[0]),
        (dd.ddc_square_add(ta, tb, tb, ta)[1],
         jax_dd.ddc_square_add(np, a, b, b, a)[1]),
        ((dd.ddc_mag2(ta, tb),), (jax_dd.ddc_mag2(np, a, b),)),
    ]
    for got, want in pairs:
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), w)


def _numpy_dd_loop(params, width, height):
    """dd_escape._make_kernel with the JAX package's ops/dd.py on numpy."""
    p = params
    f32 = np.float32
    px, py = np.meshgrid(np.arange(width, dtype=f32),
                         np.arange(height, dtype=f32) + p[10])
    ux = (px + p[8] - f32(0.5) * f32(width)) / f32(height)
    uy = (py + p[9] - f32(0.5) * f32(height)) / f32(height)
    zoom = (p[4], p[5])
    cr = jax_dd.dd_add(np, (p[0], p[1]), jax_dd.dd_mul_float(np, zoom, ux))
    ci = jax_dd.dd_add(np, (p[2], p[3]), jax_dd.dd_mul_float(np, zoom, uy))
    zr, zi, mag = cr, ci, jax_dd.ddc_mag2(np, cr, ci)
    nf = np.zeros((height, width), f32)
    limit = int(p[6])
    for _ in range(1, limit):
        alive = mag <= p[7]
        if not alive.any():
            break
        nf += alive
        nzr, nzi = jax_dd.ddc_square_add(np, zr, zi, cr, ci)
        zr = tuple(np.where(alive, u, v) for u, v in zip(nzr, zr))
        zi = tuple(np.where(alive, u, v) for u, v in zip(nzi, zi))
        mag = np.where(alive, jax_dd.ddc_mag2(np, zr, zi), mag)
    n = np.where(mag <= p[7], limit, nf.astype(np.int32))
    return n, zr[0] + zr[1], zi[0] + zi[1]


@pytest.mark.parametrize("view", [
    dict(cx="-0.5", cy="0", zoom="3", iters=96, w=64, h=40),
    dict(cx=SEAHORSE[0], cy=SEAHORSE[1], zoom="1e-9", iters=1500, w=48,
         h=27),
    dict(cx="-1.74975914513036646165693", cy="0", zoom="1e-7", iters=400,
         w=37, h=23, bailout=2.5),
], ids=["default", "seahorse_1e-9", "needle_1e-7"])
def test_plain_dd_fields_bit_equal_to_numpy_dd_loop(view):
    params = dd_escape.pack_dd_params(
        center_x_dd=dd.dd_from_string(view["cx"]),
        center_y_dd=dd.dd_from_string(view["cy"]),
        zoom_dd=dd.dd_from_string(view["zoom"]), iter_limit=view["iters"],
        bailout=view.get("bailout", 4.0))
    n, zx, zy = dd_escape.dd_escape_fields_plain(
        params, width=view["w"], height=view["h"], map_height=view["h"],
        row0=0, device="cpu")
    want = _numpy_dd_loop(params, view["w"], view["h"])
    assert n.dtype == torch.int32
    np.testing.assert_array_equal(n.numpy(), want[0])
    np.testing.assert_array_equal(zx.numpy(), want[1])
    np.testing.assert_array_equal(zy.numpy(), want[2])


def test_row_band_equals_whole_frame_rows():
    kw = dict(center_x_dd=dd.dd_from_string(SEAHORSE[0]),
              center_y_dd=dd.dd_from_string(SEAHORSE[1]),
              zoom_dd=dd.dd_from_string("1e-6"), max_iter=300,
              device="cpu")
    full = dd_escape.dd_escape_fields(40, 30, **kw)
    band = dd_escape.dd_escape_fields(40, 10, row0=12, map_height=30, **kw)
    for k in ("n", "zx", "zy"):
        assert torch.equal(band[k], full[k][12:22])


def _f64_oracle(cx, cy, zoom, width, height, max_iter):
    from test_deepzoom import _f64_mandelbrot_counts

    return _f64_mandelbrot_counts(cx, cy, zoom, width, height, max_iter)


@pytest.mark.parametrize("cx,cy,zoom,w,h,mi,frac", [
    (-0.5, 0.0, 3.0, 64, 32, 96, 0.02),
    (-0.743643887037151, 0.13182590420533, 1e-9, 48, 32, 1500, 0.2),
])
def test_dd_counts_close_to_f64_oracle(cx, cy, zoom, w, h, mi, frac):
    oracle = _f64_oracle(cx, cy, zoom, w, h, mi)
    f = dd_escape.dd_escape_fields(
        w, h, center_x_dd=dd.dd_from_string(repr(cx)),
        center_y_dd=dd.dd_from_string(repr(cy)),
        zoom_dd=dd.dd_from_string(repr(zoom)), max_iter=mi, device="cpu")
    assert (f["n"].numpy() != oracle).mean() < frac


@pytest.mark.parametrize("kw", [
    dict(cx=SEAHORSE[0], cy=SEAHORSE[1], zoom="1e-9", max_iter=1500),
    dict(cx="-0.5", cy="0", zoom="3", max_iter=96, bailout=2.5,
         iter_limit=40.7),
    dict(cx="0.25", cy="-1e-30", zoom="2.5e-11", max_iter=256,
         offset=(0.5, 0.25), row0=270.0, iter_limit=0),
], ids=["seahorse", "limit_40", "band"])
def test_pack_dd_params_matches_jax(kw, monkeypatch):
    seen = {}

    def fake_call(params, **static):
        seen["params"] = np.asarray(params)
        return (np.zeros((2, 2), np.int32),) + (np.zeros((2, 2)),) * 2

    monkeypatch.setattr(jax_dd_escape, "_dd_call", fake_call)
    kw = dict(kw)
    hp = {k: jax_dd.dd_from_string(kw.pop(k)) for k in ("cx", "cy", "zoom")}
    jax_dd_escape.dd_escape_fields(2, 2, center_x_dd=hp["cx"],
                                   center_y_dd=hp["cy"], zoom_dd=hp["zoom"],
                                   **kw)
    max_iter = kw.pop("max_iter")
    kw.setdefault("iter_limit", max_iter)
    got = dd_escape.pack_dd_params(center_x_dd=hp["cx"],
                                   center_y_dd=hp["cy"], zoom_dd=hp["zoom"],
                                   **kw)
    assert got.dtype == np.float32 and got.shape == (dd_escape.ND,)
    np.testing.assert_array_equal(got, seen["params"].reshape(-1))


def test_dd_launch_checks():
    kw = dict(center_x_dd=(-0.5, 0.0), center_y_dd=(0.0, 0.0),
              zoom_dd=(3.0, 0.0))
    with pytest.raises(ValueError, match="2\\^24"):
        dd_escape.dd_escape_fields(8, 8, max_iter=1 << 24, device="cpu",
                                   **kw)
    with pytest.raises(ValueError, match="outside the image height"):
        dd_escape.dd_escape_fields(8, 8, max_iter=8, row0=4, map_height=8,
                                   device="cpu", **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        dd_escape.dd_escape_fields(8, 8, max_iter=8, device="meta", **kw)


def test_k2_trips_buffer_rows_follow_the_kernel_grid():
    # K2 shares K1's counters: one row per warp of its 32 x 8 blocks, row
    # ((block_y * blocks_x + block_x) * 8 + thread_y) as warp_row writes
    # it.  Fill a buffer as the kernel would from the plain version's n
    # plane and decode it: the lane iterations are the frame's loop updates
    w, h, iters = 65, 33, 300
    params = dd_escape.pack_dd_params(
        center_x_dd=dd.dd_from_string(SEAHORSE[0]),
        center_y_dd=dd.dd_from_string(SEAHORSE[1]),
        zoom_dd=dd.dd_from_string("1e-6"), iter_limit=iters)
    n = dd_escape.dd_escape_fields_plain(params, width=w, height=h,
                                         map_height=h, row0=0,
                                         device="cpu")[0].numpy()
    updates = np.minimum(n, iters - 1).astype(np.int64)
    buf = dd_escape.trips_buffer(w, h, "cpu")
    assert buf.shape == (dd_escape.launch_warps(w, h),
                         len(dd_escape.TRIP_FIELDS)) == (120, 13)
    col = {f: i for i, f in enumerate(dd_escape.TRIP_FIELDS)}
    blocks_x = -(-w // 32)
    for y in range(h):
        for bx in range(blocks_x):
            lanes = updates[y, 32 * bx:32 * bx + 32]
            row = ((y // 8) * blocks_x + bx) * 8 + y % 8
            assert not buf[row].any()  # each warp has a row of its own
            for f, v in (("trips", lanes.max()), ("lane_iters", lanes.sum()),
                         ("pixels", len(lanes)), ("looped", len(lanes)),
                         ("end_lo", 1)):
                buf[row, col[f]] = int(v)
    c = dd_escape.decode_trips(buf)
    assert c["warps"] == h * blocks_x and c["pixels"] == w * h
    assert c["lane_iters"] == int(updates.sum())
    issued = sum(int(updates[y, x:x + 32].max()) for y in range(h)
                 for x in range(0, w, 32))
    assert c["trips"] == issued
    assert c["lane_util"] == pytest.approx(updates.sum() / (32 * issued))


@pytest.mark.parametrize("scene_kw", [
    dict(hp_zoom="1e-9", max_iterations=1500, center_x=-0.743643887037151,
         center_y=0.13182590420533),
    dict(interior_style=2, orbit_trap_enabled=True, stripe_enabled=True,
         palette_mode=4, color_offset=0.3, color_brightness=1.3,
         color_saturation=0.7, max_iterations=80),
    dict(interior_style=1, max_iterations=300, color_scale=2.0),
], ids=["seahorse_1e-9", "style2_traps_ignored", "style1"])
def test_render_dd_matches_jax_colour_pipeline_on_the_same_fields(scene_kw):
    w, h = 48, 27
    jscene = fr.Scene(**scene_kw)
    scene = frt.Scene.from_json(jscene.to_json())
    img = render_dd(scene, w, h, device="cpu")
    assert img.shape == (h, w, 3) and img.dtype == torch.float32
    # the JAX colour pipeline of render_dd on the port's fields
    f = dd_escape.dd_escape_fields(
        w, h, center_x_dd=dd.dd_from_string(
            jscene.hp_center_x or repr(jscene.center_x)),
        center_y_dd=dd.dd_from_string(
            jscene.hp_center_y or repr(jscene.center_y)),
        zoom_dd=dd.dd_from_string(jscene.hp_zoom or repr(jscene.zoom)),
        max_iter=jscene.max_iterations, bailout=jscene.bailout,
        device="cpu")
    p = jax_coloring.ColorParams(
        max_iterations=jscene.max_iterations, bailout=jscene.bailout,
        palette_mode=jscene.palette_mode, color_offset=jscene.color_offset,
        color_scale=jscene.color_scale, interior_style=jscene.interior_style)
    zx = jnp.asarray(f["zx"].numpy())
    color = jax_coloring.color_mandelbrot(
        jnp, jnp.asarray(f["n"].numpy()), zx, jnp.asarray(f["zy"].numpy()),
        jnp.full_like(zx, 1e20), p)
    want = np.asarray(jax_coloring.post_chain(
        jnp, color, jscene.color_brightness, jscene.color_saturation,
        jscene.color_contrast))
    np.testing.assert_allclose(img.numpy(), want, rtol=0, atol=1e-5)


def test_render_dd_close_to_jax_render_dd():
    from fractalrenderer_tpu.models.mandelbrot import render_dd as jax_render

    kw = dict(hp_zoom="1e-7", max_iterations=400,
              center_x=-0.743643887037151, center_y=0.13182590420533)
    img = render_dd(frt.Scene(**kw), 40, 24, device="cpu").numpy()
    ref = jax_render(fr.Scene(**kw), 40, 24)
    bad = (np.abs(img - ref) > 2e-2).any(axis=-1)
    assert bad.mean() < 0.05, f"bad colour fraction {bad.mean()}"
