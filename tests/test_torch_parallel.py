"""The port's row bands and giant stills (``parallel/``) for the 2D
families: twins of tests/test_parallel.py on a CPU grid of 8 (the JAX
tests' 8 virtual devices), ``make_render_mesh(devices=[cpu] * 8)``, or 2
frame groups of 4.

Every sharded or banded result is bit-equal to the port's whole-frame
render, over even and uneven band splits (the last band clamped to the
image).  One CPU-only exception, measured in
test_sharded_cpu_colour_on_ragged_bands: PyTorch's CPU pow, log and atan2
run whole vector blocks of a tensor through a vectorized routine and the
tail through a scalar one, which differ by an ulp, and the plain colour
and post chain use them; so where a band's element count is not a
multiple of the block, a few of its tail pixels can be a few ulps off on
the CPU (the fields stay bit-equal).  On the card every element takes the
same routine, and tests/test_torch_cuda.py holds those bands bit-equal.
The bit-equal tests below have whole blocks in every band.  Against the JAX package on the same scene: iteration counts of the
bands equal to ``reference/golden.py``; colours within 1e-5 of the golden
render (which is exact); the JAX sharded render and the JAX giant's PNG
within 1 LSB (or |diff| <= 2e-2 in f32) except on under 1% of pixels,
the bound of test_golden_vs_kernel.py and test_torch_render.py: the JAX
render on the CPU is not count-exact (XLA contracts mul+add into FMA).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import fractalrenderer_tpu as fr
from fractalrenderer_tpu import cli as jax_cli
from fractalrenderer_tpu.parallel import mesh as jax_mesh
from fractalrenderer_tpu.parallel import tiled as jax_tiled
from fractalrenderer_tpu.reference import golden
from fractalrenderer_tpu.utils.png import read_png as jax_read_png
from fractalrenderer_tpu_torch import FractalType, Scene, cli, models
from fractalrenderer_tpu_torch.anim.keyframes import Animation, Keyframe
from fractalrenderer_tpu_torch.anim.renderer import AnimationRenderer
from fractalrenderer_tpu_torch.models import common
from fractalrenderer_tpu_torch.ops import escape
from fractalrenderer_tpu_torch.parallel import (make_render_mesh,
                                                render_frames_sharded,
                                                render_giant_still,
                                                render_sharded)
from fractalrenderer_tpu_torch.parallel.mesh import pad_to_multiple, row_bands
from fractalrenderer_tpu_torch.utils.image import downsample2x
from fractalrenderer_tpu_torch.utils.png import read_png, write_png

CPU = torch.device("cpu")

# each 2D family's view (golden function arguments follow from it)
FAMILY_SCENES = {
    "mandelbrot": Scene(max_iterations=48),
    "julia": Scene(fractal_type=FractalType.JULIA, max_iterations=48,
                   zoom=3.0),
    "burning_ship": Scene(fractal_type=FractalType.BURNING_SHIP,
                          center_x=-0.5, center_y=-0.6, zoom=2.0,
                          max_iterations=48),
    "phoenix": Scene(fractal_type=FractalType.PHOENIX, max_iterations=48),
}


def _mesh(frames=1, n=8):
    return make_render_mesh(devices=[CPU] * n, frames=frames)


def _jax_scene(scene):
    return fr.Scene.from_dict(scene.to_dict())


def _png_pixels(img, bit_depth):
    """An f32 render as the PNG writer stores it (quantized, flipped)."""
    return common.quantize_image(img, bit_depth=bit_depth).numpy()[::-1]


def _near_jax(mine, theirs, lsb=1):
    """``mine`` within ``lsb`` of the JAX package's ``theirs`` but on
    under 1% of pixels."""
    assert mine.shape == theirs.shape and mine.dtype == theirs.dtype
    d = np.abs(mine.astype(np.float64) - theirs.astype(np.float64))
    bad = (d > lsb).any(axis=-1)
    assert bad.mean() < 0.01, f"{bad.mean():.4f} of pixels past {lsb}"


def test_mesh_construction():
    m = _mesh()
    assert m.shape == {"frames": 1, "rows": 8}
    m2 = _mesh(frames=2)
    assert m2.shape == {"frames": 2, "rows": 4}
    assert m2.shape == dict(jax_mesh.make_render_mesh(frames=2).shape)
    assert all(d == CPU for row in m2.devices for d in row)
    with pytest.raises(ValueError):
        _mesh(frames=3)
    assert make_render_mesh(4, devices=[CPU] * 8).shape["rows"] == 4
    with pytest.raises(ValueError):
        make_render_mesh(9, devices=[CPU] * 8)
    for n, m in ((50, 8), (48, 8), (1, 3), (0, 4)):
        assert pad_to_multiple(n, m) == jax_mesh.pad_to_multiple(n, m)


def test_mesh_needs_a_cuda_device_or_devices(monkeypatch):
    # no CUDA device and no devices=: a raise, never a CPU grid
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_render_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_sharded(Scene(max_iterations=8), 16, 8)


@pytest.mark.parametrize("height,n", [(50, 8), (48, 8), (10, 8), (7, 1),
                                      (90, 7)])
def test_row_bands_cover_the_image_once(height, n):
    bands = row_bands(height, n)
    band_h = pad_to_multiple(height, n) // n
    assert bands[0][0] == 0 and len(bands) <= n
    for (r0, rows), (r1, _) in zip(bands, bands[1:]):
        assert rows == band_h and r1 == r0 + rows
    assert bands[-1][0] + bands[-1][1] == height and bands[-1][1] >= 1


def test_sharded_matches_single_device():
    s = Scene(max_iterations=48)
    W, H = 96, 48
    single = models.render(s, W, H, device="cpu")
    sharded = render_sharded(s, W, H, mesh=_mesh())
    assert sharded.shape == single.shape and sharded.device == CPU
    # the same kernel arithmetic on each band's global rows: bit-equal
    assert torch.equal(sharded, single)
    np.testing.assert_allclose(sharded.numpy(),
                               fr.render_numpy(_jax_scene(s), W, H),
                               rtol=0, atol=1e-5)
    _near_jax(sharded.numpy(),
              jax_tiled.render_sharded(_jax_scene(s), W, H), lsb=2e-2)


def test_sharded_height_not_divisible():
    s = Scene(max_iterations=32)
    W, H = 64, 50  # 50 rows over 8 devices: 7-row bands, the last 1 row
    single = models.render(s, W, H, device="cpu")
    sharded = render_sharded(s, W, H, mesh=_mesh())
    assert sharded.shape == (H, W, 3)
    assert torch.equal(sharded, single)
    _near_jax(sharded.numpy(),
              jax_tiled.render_sharded(_jax_scene(s), W, H), lsb=2e-2)


def test_sharded_julia():
    s = Scene(fractal_type=FractalType.JULIA, max_iterations=32, zoom=3.0)
    out = render_sharded(s, 64, 32, mesh=_mesh())
    assert torch.equal(out, models.render(s, 64, 32, device="cpu"))
    _near_jax(out.numpy(), jax_tiled.render_sharded(_jax_scene(s), 64, 32),
              lsb=2e-2)


@pytest.mark.parametrize("family", sorted(FAMILY_SCENES))
def test_sharded_families_match_single_and_golden(family):
    # uneven bands (50 rows over 8) in every 2D family; colours within the
    # colour contract of the exact golden render
    s = FAMILY_SCENES[family]
    out = render_sharded(s, 64, 50, mesh=_mesh())
    assert torch.equal(out, models.render(s, 64, 50, device="cpu"))
    np.testing.assert_allclose(out.numpy(),
                               golden.render_scene(_jax_scene(s), 64, 50),
                               rtol=0, atol=1e-5)


# the CPU's vector-tail bound (module docstring): a few ulps of colours in
# [0, 1] after the post chain amplifies one op's ulp
CPU_TAIL_ATOL = 1e-6


@pytest.mark.parametrize("family", sorted(FAMILY_SCENES))
def test_sharded_cpu_colour_on_ragged_bands(family):
    # 91 rows over 7 bands of 13 at width 45: 585-element planes, not a
    # whole number of vector blocks; the fields are the whole frame's rows
    # bit for bit, the colour within CPU_TAIL_ATOL on under 1% of pixels
    s = FAMILY_SCENES[family].with_(antialiasing_samples=2)
    W, H = 45, 91
    julia_c = (s.julia_c_real, s.julia_c_imag)
    kw = dict(center_x=s.center_x, center_y=s.center_y, zoom=s.zoom,
              max_iter=s.max_iterations, julia_c=julia_c,
              phoenix_p=s.phoenix_p, phoenix_r=s.phoenix_r,
              use_julia=s.use_julia_set, map_height=H, device="cpu")
    whole = escape.escape_fields(family, W, H, **kw)
    parts = [escape.escape_fields(family, W, rows, row0=r0, **kw)
             for r0, rows in row_bands(H, 7)]
    for k in whole:
        assert torch.equal(torch.cat([p[k] for p in parts]), whole[k]), k
    d = (render_sharded(s, W, H, mesh=_mesh(n=7))
         - models.render(s, W, H, device="cpu")).abs()
    assert float(d.max()) <= CPU_TAIL_ATOL
    assert (d > 0).any(axis=-1).float().mean() < 0.01


@pytest.mark.parametrize("family", sorted(FAMILY_SCENES))
def test_band_counts_equal_golden(family):
    # the kernel launches a sharded render makes, one per band at its
    # global row0, give the golden counts of the whole image
    s = FAMILY_SCENES[family]
    W, H = 64, 50
    julia_c = (s.julia_c_real, s.julia_c_imag)
    kw = dict(center_x=s.center_x, center_y=s.center_y, zoom=s.zoom,
              max_iter=s.max_iterations, julia_c=julia_c,
              phoenix_p=s.phoenix_p, phoenix_r=s.phoenix_r,
              use_julia=s.use_julia_set, map_height=H, device="cpu")
    n = torch.cat([escape.escape_fields(family, W, rows, row0=r0, **kw)["n"]
                   for r0, rows in row_bands(H, 8)]).numpy()
    g = {"mandelbrot": lambda: golden.mandelbrot_fields(
             W, H, s.center_x, s.center_y, s.zoom, s.max_iterations,
             s.bailout),
         "julia": lambda: golden.julia_fields(
             W, H, s.center_x, s.center_y, s.zoom, *julia_c,
             s.max_iterations, s.bailout),
         "burning_ship": lambda: golden.burning_ship_fields(
             W, H, s.center_x, s.center_y, s.zoom, s.max_iterations,
             s.bailout, False, 0.5, False, 10.0, 0),
         "phoenix": lambda: golden.phoenix_fields(
             W, H, s.center_x, s.center_y, s.zoom, s.max_iterations,
             julia_c, s.use_julia_set, s.phoenix_p, s.phoenix_r)}[family]()
    np.testing.assert_array_equal(n, g[0])


@pytest.mark.parametrize("depth", [8, 16])
def test_sharded_quantized_matches_single_bytes(depth):
    # quantize=8/16 quantizes INSIDE each band on its device: the bytes
    # equal the single-device quantized export exactly
    s = Scene(max_iterations=48)
    W, H = 96, 48
    out = render_sharded(s, W, H, mesh=_mesh(), quantize=depth)
    assert out.dtype == (torch.uint8 if depth == 8 else torch.uint16)
    ref = models.render(s, W, H, device="cpu", quantize=depth)
    assert torch.equal(out, ref)
    theirs = jax_tiled.render_sharded(_jax_scene(s), W, H, quantize=depth)
    _near_jax(out.numpy(), theirs)


def test_frames_sharded_quantized_bytes():
    scenes = [Scene(max_iterations=32, zoom=z) for z in (3.0, 1.5, 0.8, 0.5)]
    mesh = _mesh(frames=2)
    out = render_frames_sharded(scenes, 64, 32, mesh, quantize=8)
    assert out.dtype == torch.uint8 and out.shape == (4, 32, 64, 3)
    f32 = render_frames_sharded(scenes, 64, 32, mesh)
    assert torch.equal(out, common.quantize_image(f32, bit_depth=8))
    theirs = jax_tiled.render_frames_sharded(
        [_jax_scene(s) for s in scenes], 64, 32,
        jax_mesh.make_render_mesh(frames=2), quantize=8)
    _near_jax(out.numpy(), theirs)


def test_frames_sharded():
    scenes = [Scene(max_iterations=32, zoom=z) for z in (3.0, 1.5, 0.8, 0.5)]
    out = render_frames_sharded(scenes, 64, 32, _mesh(frames=2))
    assert out.shape == (4, 32, 64, 3)
    for i, s in enumerate(scenes):
        # one cap for the batch (all 32 here), as the single render's
        assert torch.equal(out[i], models.render(s, 64, 32, device="cpu"))
    # an odd count over 2 groups, and an uneven row split (30 rows over 4)
    scenes3 = [Scene(max_iterations=20, zoom=z) for z in (2.0, 1.0, 0.7)]
    out3 = render_frames_sharded(scenes3, 40, 30, _mesh(frames=2),
                                 cap=40)
    for i, s in enumerate(scenes3):
        cfg = dataclasses.replace(common.scene_static_cfg(
            s, 40, 30, "mandelbrot", "centered", False, device="cpu"),
            max_iter=40)
        assert torch.equal(out3[i], common.render_fn(cfg)(
            common.scene_dyn_params(s)))


def test_giant_still_resume(tmp_path):
    s = Scene(max_iterations=24)
    out = str(tmp_path / "big.png")
    info = render_giant_still(s, 96, 80, out, band_rows=32, bit_depth=8,
                              dpi=None, device="cpu")
    assert info["bands"] == 3 and info["rendered"] == 3
    assert info["out"] == out and info["tile_dir"] == out + ".tiles"
    for k in ("fetch_seconds", "deflate_seconds", "tile_seconds"):
        assert info[k] >= 0
    img = read_png(out)
    assert img.shape == (80, 96, 3)
    # resume: all bands skipped
    info2 = render_giant_still(s, 96, 80, out, band_rows=32, bit_depth=8,
                               dpi=None, device="cpu")
    assert info2["skipped"] == 3 and info2["rendered"] == 0
    np.testing.assert_array_equal(read_png(out), img)
    # band-streamed output equals a monolithic render (flipped at export)
    np.testing.assert_array_equal(
        img, _png_pixels(models.render(s, 96, 80, device="cpu"), 8))
    theirs = str(tmp_path / "jax.png")
    jax_tiled.render_giant_still(_jax_scene(s), 96, 80, theirs,
                                 band_rows=32, bit_depth=8, dpi=None)
    _near_jax(img, jax_read_png(theirs))


def test_giant_still_resume_bad_tiles(tmp_path):
    """Corrupt / wrong-shaped resume tiles re-render instead of aborting."""
    s = Scene(max_iterations=24)
    out = str(tmp_path / "big.png")
    render_giant_still(s, 96, 80, out, band_rows=32, bit_depth=8, dpi=None,
                       device="cpu")
    ref = read_png(out)
    tile_dir = out + ".tiles"
    # band 0: truncated/garbage bytes (simulates a crash mid-write)
    with open(os.path.join(tile_dir, "band_00000.png"), "wb") as fp:
        fp.write(b"\x89PNG\r\n\x1a\nnot a real png")
    # band 1: decodable but wrong shape (foreign file)
    write_png(os.path.join(tile_dir, "band_00001.png"),
              np.zeros((4, 4, 3), np.uint8), bit_depth=8)
    info = render_giant_still(s, 96, 80, out, band_rows=32, bit_depth=8,
                              dpi=None, device="cpu")
    assert info["rendered"] == 2 and info["skipped"] == 1
    np.testing.assert_array_equal(read_png(out), ref)


def test_giant_still_scene_change_invalidates(tmp_path):
    s1 = Scene(max_iterations=24)
    out = str(tmp_path / "big.png")
    render_giant_still(s1, 64, 40, out, band_rows=20, bit_depth=8, dpi=None,
                       device="cpu")
    s2 = s1.with_(zoom=1.0)
    info = render_giant_still(s2, 64, 40, out, band_rows=20, bit_depth=8,
                              dpi=None, device="cpu")
    assert info["rendered"] == 2  # stale tiles discarded, re-rendered
    np.testing.assert_array_equal(
        read_png(out), _png_pixels(models.render(s2, 64, 40, device="cpu"),
                                   8))


def test_giant_still_sharded_mesh(tmp_path):
    s = Scene(max_iterations=24)
    out = str(tmp_path / "mesh.png")
    info = render_giant_still(s, 64, 64, out, band_rows=32, bit_depth=8,
                              dpi=None, use_mesh=True, mesh=_mesh(),
                              device="cpu")
    assert info["rendered"] == 2
    img = read_png(out)
    np.testing.assert_array_equal(
        img, _png_pixels(models.render(s, 64, 64, device="cpu"), 8))
    theirs = str(tmp_path / "jax.png")
    jax_tiled.render_giant_still(_jax_scene(s), 64, 64, theirs,
                                 band_rows=32, bit_depth=8, dpi=None,
                                 use_mesh=True)
    _near_jax(img, jax_read_png(theirs))


def test_giant_still_supersample(tmp_path):
    # banded 2x-supersampled export == downsampling a monolithic 2x render
    # (the downsample expression is the same f32 on both paths), for the
    # plain and the mesh band producers
    s = Scene(max_iterations=24)
    out = str(tmp_path / "ss.png")
    render_giant_still(s, 64, 48, out, band_rows=16, bit_depth=8, dpi=None,
                       supersample=True, device="cpu")
    ref8 = _png_pixels(downsample2x(models.render(s, 128, 96, device="cpu")),
                       8)
    np.testing.assert_array_equal(read_png(out), ref8)

    out2 = str(tmp_path / "ss_mesh.png")
    render_giant_still(s, 64, 48, out2, band_rows=16, bit_depth=8, dpi=None,
                       supersample=True, use_mesh=True, mesh=_mesh(),
                       device="cpu")
    np.testing.assert_array_equal(read_png(out2), ref8)
    theirs = str(tmp_path / "jax.png")
    jax_tiled.render_giant_still(_jax_scene(s), 64, 48, theirs,
                                 band_rows=16, bit_depth=8, dpi=None,
                                 supersample=True)
    _near_jax(ref8, jax_read_png(theirs))


def test_export_print_banded_delegation(tmp_path, monkeypatch):
    # oversized print exports stream through the banded exporter; the
    # delegated output equals the one-pass path bit for bit
    one = str(tmp_path / "one.png")
    banded = str(tmp_path / "banded.png")
    argv = ["export-print", "--device", "cpu", "--width", "96", "--height",
            "64", "--iters", "32", "--supersample", "--downsample"]
    assert cli.main(argv + ["--out", one]) == 0
    monkeypatch.setattr(cli, "_BANDED_EXPORT_PIXELS", 1000)
    assert cli.main(argv + ["--out", banded]) == 0
    np.testing.assert_array_equal(read_png(one), read_png(banded))
    # delegated export-print cleans up its resume tiles on success
    assert not os.path.exists(banded + ".tiles")
    theirs = str(tmp_path / "jax.png")
    monkeypatch.setattr(jax_cli, "_BANDED_EXPORT_PIXELS", 1000)
    jax_argv = [a for a in argv if a not in ("--device", "cpu")]
    assert jax_cli.main(jax_argv + ["--out", theirs]) == 0
    _near_jax(read_png(banded), jax_read_png(theirs))


def test_giant_still_validates_scene(tmp_path):
    # the banded and monolithic forms of the same export repair a
    # degenerate scene alike (compute_effect_manager.h:335-345)
    s = Scene(max_iterations=24, zoom=0.0)  # degenerate: repaired to 2.5
    out = str(tmp_path / "v.png")
    render_giant_still(s, 64, 40, out, band_rows=20, bit_depth=8, dpi=None,
                       device="cpu")
    np.testing.assert_array_equal(
        read_png(out), _png_pixels(models.render(s, 64, 40, device="cpu"),
                                   8))


def test_giant_still_geometry_fuzz(tmp_path):
    # random geometries (odd sizes, uneven bands, supersample) across the
    # band producers equal the monolithic render exactly — guards the
    # band/downsample index arithmetic
    rng = np.random.default_rng(20260817)
    scenes = {
        "mandelbrot": Scene(max_iterations=16),
        "julia": Scene(fractal_type=FractalType.JULIA, max_iterations=16),
        "mandelbulb": Scene(fractal_type=FractalType.MANDELBULB,
                            max_iterations=12),
    }
    for k in range(6):
        name = ("mandelbrot", "julia", "mandelbulb")[k % 3]
        s = scenes[name]
        w = int(rng.integers(20, 70))
        h = int(rng.integers(20, 70))
        band = int(rng.integers(7, 40))
        ss = bool(rng.integers(0, 2))
        out = str(tmp_path / f"f{k}.png")
        render_giant_still(s, w, h, out, band_rows=band, bit_depth=8,
                           dpi=None, supersample=ss, resume=False,
                           device="cpu")
        ref = models.render(s, w * 2 if ss else w, h * 2 if ss else h,
                            device="cpu")
        if ss:
            ref = downsample2x(ref)
        np.testing.assert_array_equal(read_png(out), _png_pixels(ref, 8),
                                      err_msg=f"{name} {w}x{h} band={band} "
                                              f"ss={ss}")


def test_animation_renderer_mesh_equals_single(tmp_path):
    # AnimationRenderer(mesh=...) splits frame batches over the
    # ('frames', 'rows') grid; frames are bit-identical to the
    # single-device batch path
    a = Animation(duration=6.0, target_fps=1, export_width=64,
                  export_height=32)
    a.keyframes.append(Keyframe(0.0, Scene(max_iterations=24, zoom=2.5)))
    a.keyframes.append(Keyframe(6.0, Scene(max_iterations=48, zoom=0.4)))
    single_dir = str(tmp_path / "single")
    mesh_dir = str(tmp_path / "mesh")
    assert AnimationRenderer(batch_size=4, device="cpu").start_render(
        a, single_dir)
    assert AnimationRenderer(batch_size=4, device="cpu",
                             mesh=_mesh(frames=2)).start_render(a, mesh_dir)
    frames = sorted(os.listdir(single_dir))
    assert frames == sorted(os.listdir(mesh_dir)) and len(frames) == 6
    for f in frames:
        np.testing.assert_array_equal(read_png(os.path.join(single_dir, f)),
                                      read_png(os.path.join(mesh_dir, f)))


def test_giant_verb_writes_the_whole_render(tmp_path, capsys):
    out = str(tmp_path / "g.png")
    argv = ["giant", "--device", "cpu", "--width", "64", "--height", "40",
            "--band-rows", "16", "--iters", "24", "--bit-depth", "8",
            "--out", out]
    assert cli.main(argv) == 0
    said = capsys.readouterr().out
    assert "3 bands rendered, 0 resumed" in said
    want = _png_pixels(models.render(Scene(max_iterations=24), 64, 40,
                                     device="cpu"), 8)
    np.testing.assert_array_equal(read_png(out), want)
    assert cli.main(argv) == 0  # resumed from its tiles
    assert "0 bands rendered, 3 resumed" in capsys.readouterr().out
    assert cli.main([*argv, "--no-resume", "--mesh"]) == 0
    assert "3 bands rendered, 0 resumed" in capsys.readouterr().out
    np.testing.assert_array_equal(read_png(out), want)


def test_giant_verb_matches_the_jax_cli(tmp_path):
    mine, ref = str(tmp_path / "mine.png"), str(tmp_path / "ref.png")
    flags = ["--width", "48", "--height", "30", "--band-rows", "7",
             "--iters", "32", "--supersample", "--type", "julia"]
    assert cli.main(["giant", "--device", "cpu", *flags,
                     "--tile-dir", str(tmp_path / "t"), "--out", mine]) == 0
    assert jax_cli.main(["giant", *flags, "--out", ref]) == 0
    a, b = read_png(mine), jax_read_png(ref)
    assert a.dtype == np.uint16 and a.shape == (30, 48, 3)
    _near_jax(a, b)
    assert os.path.exists(str(tmp_path / "t" / "manifest.json"))


@pytest.mark.parametrize("argv,err", [
    (["--band-rows", "0"], "bad --band-rows"),
    (["--width", "0"], "bad render size"),
])
def test_giant_verb_bad_sizes_exit_2(tmp_path, capsys, argv, err):
    out = tmp_path / "g.png"
    rc = cli.main(["giant", "--device", "cpu", "--width", "16", "--height",
                   "8", *argv, "--out", str(out)])
    assert rc == 2 and err in capsys.readouterr().err
    assert not out.exists()


def test_sharded_render_verb_equals_render(tmp_path):
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    flags = ["render", "--device", "cpu", "--width", "48", "--height", "30",
             "--iters", "40", "--bit-depth", "16"]
    assert cli.main([*flags, "--out", a]) == 0
    assert cli.main([*flags, "--sharded", "--out", b]) == 0
    np.testing.assert_array_equal(read_png(a), read_png(b))
