"""The port's palettes, the colouring of the four families and the post
chain against the JAX package's functions run with ``xp=numpy``, on seeded
inputs.  Tolerance:
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
                              bailout=torch.tensor(f(4.0)),
                              palette_mode=palette,
                              color_offset=torch.tensor(coff),
                              color_scale=torch.tensor(cscale),
                              interior_style=style)
    got = coloring.color_mandelbrot_planar(
        torch.from_numpy(n), torch.from_numpy(zx), torch.from_numpy(zy),
        torch.full((40, 56), 1e20), tp)
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
                interior_skip=True, device="cpu")
    col = dict(color_offset=0.25, color_scale=2.0, brightness=1.05,
               saturation=1.2, contrast=1.1)
    f = escape.escape_fields("mandelbrot", 96, 80, **base)
    g = escape.escape_fields("mandelbrot", 96, 80, fused_color=fused,
                             **base, **col)
    p = coloring.ColorParams(max_iterations=96.0, bailout=4.0,
                             palette_mode=fused[0],
                             color_offset=col["color_offset"],
                             color_scale=col["color_scale"],
                             interior_style=fused[1])
    rgb = coloring.color_mandelbrot_planar(
        f["n"], f["zx"], f["zy"], torch.full_like(f["zx"], 1e20), p)
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


def test_color_table_enhanced_family():
    tab = escape.color_table(4, "enhanced")
    np.testing.assert_array_equal(tab[:palettes.TABLE_LEN],
                                  palettes.palette_table(4, "enhanced"))
    assert escape.PALETTE_FAMILY == {"mandelbrot": "classic",
                                     "julia": "enhanced",
                                     "burning_ship": "enhanced",
                                     "phoenix": "classic"}


# ---------------------------------------------------------------------------
# The other families' colouring, traps, stripes and the stacked glue
# ---------------------------------------------------------------------------

def _params(seed, style=0, palette=None, trap=False, stripe=False,
            control=None):
    """The same colour parameters for both packages: f32 scalars (numpy
    f32 for the JAX functions, 0-dim tensors for the port)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    vals = dict(max_iterations=f(96), bailout=f(rng.uniform(2.0, 6.0)),
                color_offset=f(rng.uniform(0, 1)),
                color_scale=f(rng.uniform(0.5, 3)),
                orbit_trap_radius=f(rng.uniform(0.2, 0.9)),
                stripe_density=f(rng.uniform(3, 12)),
                phoenix_stripe_control=f(rng.uniform(1, 10)
                                         if control is None else control))
    static = dict(palette_mode=seed % 6 if palette is None else palette,
                  interior_style=style, orbit_trap_enabled=trap,
                  stripe_enabled=stripe)
    jp = jax_coloring.ColorParams(**vals, **static)
    tp = coloring.ColorParams(**{k: torch.tensor(v) for k, v in vals.items()},
                              **static)
    return jp, tp


def _aux(seed, shape=(40, 56)):
    rng = np.random.default_rng(seed + 1000)
    return (rng.uniform(0, 1.5, shape).astype(np.float32),
            rng.uniform(-40, 40, shape).astype(np.float32))


def _close(got, want, atol=ATOL):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol)


@pytest.mark.parametrize("style,trap,stripe", [
    (0, True, False), (1, False, True), (2, False, False), (2, True, True),
    (0, True, True)])
def test_mandelbrot_traps_stripes_and_glow_match_jax(style, trap, stripe):
    n, zx, zy = _fields(10 + style)
    min_trap, _ = _aux(style)
    jp, tp = _params(style, style=style, trap=trap, stripe=stripe)
    want = jax_coloring.color_mandelbrot_planar(np, n, zx, zy, min_trap, jp)
    got = coloring.color_mandelbrot_planar(
        *map(torch.from_numpy, (n, zx, zy, min_trap)), tp)
    _close(got, want)


@pytest.mark.parametrize("palette", [0, 3, 6, 9])
def test_julia_coloring_matches_jax(palette):
    n, zx, zy = _fields(20 + palette)
    jp, tp = _params(palette, palette=palette)
    want = jax_coloring.color_julia_planar(np, n, zx, zy, jp)
    got = coloring.color_julia_planar(*map(torch.from_numpy, (n, zx, zy)),
                                      tp)
    _close(got, want)
    stacked = coloring.color_julia(*map(torch.from_numpy, (n, zx, zy)), tp)
    assert torch.equal(stacked, torch.stack(got, -1))


@pytest.mark.parametrize("style,trap,stripe", [
    (0, False, False), (1, True, False), (1, False, False), (2, False, True),
    (2, True, False), (3, False, False), (3, True, True)])
def test_burning_ship_coloring_matches_jax(style, trap, stripe):
    n, zx, zy = _fields(30 + style)
    min_trap, stripe_acc = _aux(30 + style)
    jp, tp = _params(30 + style, style=style, palette=7, trap=trap,
                     stripe=stripe)
    want = jax_coloring.color_burning_ship_planar(np, n, zx, zy, min_trap,
                                                  stripe_acc, jp)
    got = coloring.color_burning_ship_planar(
        *map(torch.from_numpy, (n, zx, zy, min_trap, stripe_acc)), tp)
    _close(got, want)


@pytest.mark.parametrize("palette,control", [(0, 8.0), (2, 0.5), (4, 30.0),
                                             (5, 0.011)])
def test_phoenix_coloring_matches_jax(palette, control):
    # both sides take the polynomial atan2 (ops/trig.py)
    n, zx, zy = _fields(40 + palette)
    jp, tp = _params(palette, palette=palette, control=control)
    want = jax_coloring.color_phoenix_planar(np, n, zx, zy, jp)
    got = coloring.color_phoenix_planar(*map(torch.from_numpy, (n, zx, zy)),
                                        tp)
    _close(got, want)


@pytest.mark.parametrize("control", [0.0, 0.01, -3.0])
def test_phoenix_weighted_form_equals_base_when_gate_is_shut(control):
    # the gate control > 0.01 is folded into the weight: w = 0 must give
    # the base colour exactly (the JAX golden path's static branch)
    n, zx, zy = _fields(50)
    _, tp = _params(50, palette=1, control=control)
    got = coloring.color_phoenix_planar(*map(torch.from_numpy, (n, zx, zy)),
                                        tp)
    max_iter = tp.max_iterations
    smooth = coloring.smooth_nu_loglog(torch.from_numpy(n),
                                       torch.from_numpy(zx),
                                       torch.from_numpy(zy), max_iter)
    t = torch.pow(torch.clamp_min(smooth / max_iter, 0.0),
                  coloring.PHOENIX_POW)
    base = palettes.palette_color_planar(t, 1, "classic")
    for g, b in zip(got, base):
        assert torch.equal(g, b)


def test_smooth_nu_bailout_matches_jax():
    n, zx, zy = _fields(60)
    for bailout in (np.float32(2.0), np.float32(4.0), np.float32(37.5)):
        want = jax_coloring.smooth_nu_bailout(np, n, zx, zy, np.float32(96),
                                              bailout)
        got = coloring.smooth_nu_bailout(
            *map(torch.from_numpy, (n, zx, zy)), torch.tensor(96.0),
            torch.tensor(bailout))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-5)


@pytest.mark.parametrize("clamp", [False, True])
def test_stacked_post_chain_matches_jax(clamp):
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 1, (24, 32, 3)).astype(np.float32)
    f = np.float32
    bri, sat, con = f(0.05), f(-0.3), f(1.4)
    want = jax_coloring.post_chain_traced(np, img, bri, sat, con,
                                          clamp_mins=clamp)
    got = coloring.post_chain_traced(torch.from_numpy(img),
                                     torch.tensor(bri), torch.tensor(sat),
                                     torch.tensor(con), clamp_mins=clamp)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    planar = coloring.post_chain_planar(
        *torch.from_numpy(img).unbind(-1), torch.tensor(bri),
        torch.tensor(sat), torch.tensor(con), clamp_mins=clamp)
    assert torch.equal(got, torch.stack(planar, -1))
    # render_dd's chain takes Python floats, as the JAX post_chain does
    want = jax_coloring.post_chain(np, img, 1.3, 0.7, 1.2, clamp_mins=clamp)
    got = coloring.post_chain(torch.from_numpy(img), 1.3, 0.7, 1.2,
                              clamp_mins=clamp)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_distance_estimate_matches_jax():
    n, zx, zy = _fields(70)
    rng = np.random.default_rng(71)
    dzx = rng.uniform(-1e3, 1e3, zx.shape).astype(np.float32)
    dzy = rng.uniform(-1e3, 1e3, zx.shape).astype(np.float32)
    want = jax_coloring.distance_estimate(np, n, zx, zy, dzx, dzy, 96)
    got = coloring.distance_estimate(
        *map(torch.from_numpy, (n, zx, zy, dzx, dzy)), 96)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    assert (got.numpy()[n >= 96] == 0).all()


# twins of test_fused_coloring_matches_unfused (test_golden_vs_kernel.py)
_FUSED_TWINS = [
    ("mandelbrot", {}),
    ("mandelbrot", dict(fused=(3, 1, False), color_offset=0.25,
                        color_scale=2.0)),
    ("julia", dict(fused=(4, 0, True), julia_c=(-0.7, 0.27015),
                   use_julia=True, cx=0.0, cy=0.0, zoom=3.0)),
    ("burning_ship", dict(fused=(5, 3, True), cx=-0.5, cy=-0.6, zoom=2.0,
                          color_offset=0.1, color_scale=1.5)),
    ("phoenix", dict(fused=(2, 0, True), cx=0.0, cy=0.0, zoom=3.0,
                     phoenix_p=0.1, phoenix_r=-0.4, stripe_density=8.0,
                     color_offset=0.05, color_scale=1.2)),
    ("phoenix", dict(fused=(0, 0, True), cx=0.0, cy=0.0, zoom=3.0,
                     phoenix_p=0.0, phoenix_r=-0.5, stripe_density=0.0)),
]


@pytest.mark.parametrize("family,kw", _FUSED_TWINS, ids=[
    f"{fam}-{i}" for i, (fam, _) in enumerate(_FUSED_TWINS)])
def test_fused_coloring_matches_unfused(family, kw):
    kw = dict(kw)
    fused = kw.pop("fused", (0, 0, False))
    base = dict(center_x=kw.pop("cx", -0.5), center_y=kw.pop("cy", 0.0),
                zoom=kw.pop("zoom", 3.0), max_iter=96, bailout=4.0,
                device="cpu")
    coff = kw.pop("color_offset", 0.0)
    cscale = kw.pop("color_scale", 1.0)
    bri, sat, con = 1.05, 1.2, 1.1
    w, h = 96, 80
    f = escape.escape_fields(family, w, h, **base, **kw)
    p = coloring.ColorParams(
        max_iterations=float(base["max_iter"]), bailout=base["bailout"],
        palette_mode=fused[0], color_offset=coff, color_scale=cscale,
        interior_style=fused[1],
        phoenix_stripe_control=kw.get("stripe_density", 10.0))

    def color_unfused():
        if family == "mandelbrot":
            return coloring.color_mandelbrot(
                f["n"], f["zx"], f["zy"], torch.full_like(f["zx"], 1e20), p)
        if family == "burning_ship":
            return coloring.color_burning_ship(
                f["n"], f["zx"], f["zy"], torch.full_like(f["zx"], 1e10),
                torch.zeros_like(f["zx"]), p)
        if family == "phoenix":
            return coloring.color_phoenix(f["n"], f["zx"], f["zy"], p)
        return coloring.color_julia(f["n"], f["zx"], f["zy"], p)

    raw = color_unfused()
    ref = coloring.post_chain_traced(raw, bri, sat, con,
                                     clamp_mins=fused[2])
    col = dict(color_offset=coff, color_scale=cscale, brightness=bri,
               saturation=sat, contrast=con)
    g = escape.escape_fields(family, w, h, fused_color=fused, **col,
                             **base, **kw)
    img = torch.stack([g[c] for c in "rgb"], -1)
    np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=0, atol=ATOL)
    # with_post=False (the AA>1 sample-plane mode): the pre-post-chain colour
    g2 = escape.escape_fields(family, w, h, fused_color=fused + (False,),
                              **col, **base, **kw)
    img2 = torch.stack([g2[c] for c in "rgb"], -1)
    np.testing.assert_allclose(img2.numpy(), raw.numpy(), rtol=0, atol=ATOL)


def test_interior_style_2_matches_jax():
    # trap glow: the interior takes the palette at offset + 0.3·exp(-6t/r)
    n, zx, zy = _fields(80)
    min_trap, _ = _aux(80)
    jp, tp = _params(80, style=2)
    want = jax_coloring.color_mandelbrot_planar(np, n, zx, zy, min_trap, jp)
    got = coloring.color_mandelbrot_planar(
        *map(torch.from_numpy, (n, zx, zy, min_trap)), tp)
    _close(got, want)
    interior = n >= 96
    assert interior.any()
    # the glow is not the style-0 exterior colour
    jp0, tp0 = _params(80, style=0)
    plain = coloring.color_mandelbrot_planar(
        *map(torch.from_numpy, (n, zx, zy, min_trap)), tp0)
    assert not torch.equal(got[0][torch.from_numpy(interior)],
                           plain[0][torch.from_numpy(interior)])
