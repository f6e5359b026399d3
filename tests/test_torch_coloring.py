"""The port's palettes, Mandelbrot colouring and post chain against the JAX
package's functions run with ``xp=numpy``, on seeded inputs.  Tolerance:
atol 1e-5, the colour contract of test_golden_vs_kernel.py (torch and numpy
log/pow differ by up to ~2.5e-7 relative)."""
import numpy as np
import pytest
import torch

from fractalrenderer_tpu.ops import coloring as jax_coloring
from fractalrenderer_tpu.ops import palettes as jax_palettes
from fractalrenderer_tpu_torch.ops import coloring, escape, palettes

ATOL = 1e-5

PALETTES = ([("classic", m) for m in range(6)]
            + [("enhanced", m) for m in range(10)])


def _t(seed, shape=(48, 64)):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5, 2.5, shape).astype(np.float32)


@pytest.mark.parametrize("family,mode", PALETTES)
def test_palette_matches_jax(family, mode):
    t = _t(mode)
    want = jax_palettes.palette_color_planar(np, t, mode, family)
    got = palettes.palette_color_planar(torch.from_numpy(t), mode, family)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL)


def _kernel_palette(tab, t):
    """numpy f32 emulation of csrc/escape.cu:palette_rgb reading the flat
    table: proves the table layout and segment search the kernel uses."""
    f = np.float32
    t = t - np.floor(t)
    kind = int(tab[palettes.T_KIND])
    if kind == 1:
        t = np.power(t, tab[palettes.T_EXPO])
    elif kind == 2:
        t = np.minimum(np.maximum(t, f(0)), f(1))
        t = t * t * (f(3) - f(2) * t)
    elif kind == 3:
        t = t - np.floor(t)
    elif kind == 4:
        t = np.power(t - np.floor(t), tab[palettes.T_EXPO])
    if tab[palettes.T_GRAY]:
        return t, t, t
    col = tab[palettes.T_COL:palettes.T_COL + 15].reshape(5, 3)
    hi = tab[palettes.T_HI:palettes.T_HI + 4]
    seg = np.full(t.shape, 4)
    for i in reversed(range(4)):
        seg = np.where(t < hi[i], i, seg)
    s = np.minimum(seg, 3)
    frac = (t - tab[palettes.T_LO + s]) / tab[palettes.T_SPAN + s]
    out = []
    for ch in range(3):
        mix = col[s, ch] * (f(1) - frac) + col[s + 1, ch] * frac
        out.append(np.where(seg == 4, col[4, ch], mix).astype(np.float32))
    return tuple(out)


@pytest.mark.parametrize("family,mode", PALETTES)
def test_palette_table_reproduces_palette(family, mode):
    tab = palettes.palette_table(mode, family)
    assert tab.dtype == np.float32 and tab.shape == (palettes.TABLE_LEN,)
    t = _t(100 + mode)
    got = _kernel_palette(tab, t)
    want = palettes.palette_color_planar(torch.from_numpy(t), mode, family)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=ATOL)


def test_palette_table_folds_spans_in_double():
    # 0.6 - 0.4 folded in double then rounded differs from the f32
    # difference the kernel would compute from the bounds
    tab = palettes.palette_table(0, "classic")
    span = tab[palettes.T_SPAN + 2]
    assert span == np.float32(0.6 - 0.4)
    assert span != np.float32(0.6) - np.float32(0.4)


def _fields(seed, shape=(40, 56), max_iter=96):
    rng = np.random.default_rng(seed)
    n = rng.integers(0, max_iter + 1, shape).astype(np.int32)
    ang = rng.uniform(0, 2 * np.pi, shape)
    mag = rng.uniform(0.5, 40.0, shape)
    return (n, (mag * np.cos(ang)).astype(np.float32),
            (mag * np.sin(ang)).astype(np.float32))


@pytest.mark.parametrize("palette,style,clamp", [
    (0, 0, False), (1, 1, False), (2, 0, True), (3, 1, False),
    (4, 0, False), (5, 1, True)])
def test_color_and_post_chain_match_jax(palette, style, clamp):
    rng = np.random.default_rng(palette)
    f = np.float32
    max_iter = f(96)
    coff, cscale = f(rng.uniform(0, 1)), f(rng.uniform(0.5, 3))
    bri, sat, con = (f(rng.uniform(0.05, 1.5)), f(rng.uniform(-0.2, 1.5)),
                     f(rng.uniform(0.05, 1.5)))
    n, zx, zy = _fields(palette)
    jp = jax_coloring.ColorParams(max_iterations=max_iter, bailout=4.0,
                                  palette_mode=palette, color_offset=coff,
                                  color_scale=cscale, interior_style=style)
    want = jax_coloring.color_mandelbrot_planar(
        np, n, zx, zy, np.full_like(zx, 1e20), jp)
    want_post = jax_coloring.post_chain_planar(np, *want, bri, sat, con,
                                               clamp_mins=clamp)
    tp = coloring.ColorParams(max_iterations=torch.tensor(max_iter),
                              palette_mode=palette,
                              color_offset=torch.tensor(coff),
                              color_scale=torch.tensor(cscale),
                              interior_style=style)
    got = coloring.color_mandelbrot_planar(
        torch.from_numpy(n), torch.from_numpy(zx), torch.from_numpy(zy), tp)
    got_post = coloring.post_chain_planar(
        *got, torch.tensor(bri), torch.tensor(sat), torch.tensor(con),
        clamp_mins=clamp)
    for g, w in zip(got + got_post, tuple(want) + tuple(want_post)):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL)


@pytest.mark.parametrize("fused", [(0, 0, False, True), (3, 1, False, True),
                                   (4, 0, True, True), (2, 1, False, False)])
def test_fused_plain_equals_fields_then_color(fused):
    # twin of test_fused_coloring_matches_unfused on the plain path
    base = dict(center_x=-0.5, center_y=0.0, zoom=3.0, max_iter=96,
                interior_skip=True)
    col = dict(color_offset=0.25, color_scale=2.0, brightness=1.05,
               saturation=1.2, contrast=1.1)
    f = escape.escape_fields("mandelbrot", 96, 80, **base)
    g = escape.escape_fields("mandelbrot", 96, 80, fused_color=fused,
                             **base, **col)
    p = coloring.ColorParams(max_iterations=96.0,
                             palette_mode=fused[0],
                             color_offset=col["color_offset"],
                             color_scale=col["color_scale"],
                             interior_style=fused[1])
    rgb = coloring.color_mandelbrot_planar(f["n"], f["zx"], f["zy"], p)
    if fused[3]:
        rgb = coloring.post_chain_planar(*rgb, col["brightness"],
                                         col["saturation"], col["contrast"],
                                         clamp_mins=fused[2])
    for c, want in zip("rgb", rgb):
        np.testing.assert_allclose(g[c].numpy(), want.numpy(), rtol=0,
                                   atol=ATOL)


def test_color_table_constants():
    tab = escape.color_table(3)
    np.testing.assert_array_equal(tab[:palettes.TABLE_LEN],
                                  palettes.palette_table(3, "classic"))
    assert tab[escape.T_INV_GAMMA] == np.float32(1.0 / 2.2)
    assert tab[escape.T_LOG2] == np.float32(np.log(2.0))


def test_interior_style_2_is_rejected():
    p = coloring.ColorParams(max_iterations=8.0, palette_mode=0,
                             color_offset=0.0, color_scale=1.0,
                             interior_style=2)
    z = torch.zeros(2, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        coloring.color_mandelbrot_planar(torch.zeros(2, 2, dtype=torch.int32),
                                         z, z, p)
