"""The port's CPU golden reference (``reference/golden.py``) against the JAX
package's (``fractalrenderer_tpu/reference/golden.py``) on the same scenes:
the four 2D families' fields (counts and z equal), their colours within
1e-5, and ``render --golden`` PNGs within 1 LSB of the JAX golden."""
import json

import numpy as np
import pytest
import torch

import fractalrenderer_tpu as fr
from fractalrenderer_tpu.reference import golden as jax_golden
from fractalrenderer_tpu.utils.png import _prepare_rows, read_png
from fractalrenderer_tpu_torch import Scene, cli
from fractalrenderer_tpu_torch.reference import golden

W, H = 160, 90

# (fields function, its arguments after width and height) of every family,
# one AA offset each (the uv convention's offsets are in raw units)
FIELDS = [
    ("mandelbrot_fields", (-0.5, 0.0, 3.0, 256, 2.0)),
    ("mandelbrot_fields", (-0.743643887037151, 0.13182590420533, 0.008,
                           600, 2.0, (0.5, 0.25))),
    ("julia_fields", (0.0, 0.0, 3.0, -0.7, 0.27015, 256, 2.0,
                      (0.0015625, -0.0015625))),
    ("burning_ship_fields", (-0.5, -0.6, 2.0, 256, 2.0, True, 0.5, True,
                             10.0, 2)),
    ("phoenix_fields", (0.0, 0.0, 3.0, 128, (0.5667, 0.0), False, 0.0,
                        -0.5)),
    # Julia mode: one uniform count, the reference's quirk (phoenix.comp
    # ignores the pixel there)
    ("phoenix_fields", (0.0, 0.0, 3.0, 128, (0.3, 0.2), True, 0.1, -0.4)),
]


@pytest.mark.parametrize("fn,args", FIELDS,
                         ids=[f"{f}-{i}" for i, (f, _) in enumerate(FIELDS)])
def test_fields_equal_jax_golden(fn, args):
    got = getattr(golden, fn)(W, H, *args)
    want = getattr(jax_golden, fn)(W, H, *args)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[0], want[0])  # the counts
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


# scenes of every family, with the options each colouring reads
SCENES = [
    dict(fractal_type="mandelbrot"),
    dict(fractal_type="mandelbrot", antialiasing_samples=2,
         orbit_trap_enabled=True, interior_style=2, stripe_enabled=True,
         palette_mode=3, color_offset=0.25, color_scale=2.0),
    dict(fractal_type="julia", antialiasing_samples=2, palette_mode=7),
    dict(fractal_type="burning_ship", center_x=-0.5, center_y=-0.6,
         zoom=2.0, orbit_trap_enabled=True, stripe_enabled=True,
         interior_style=2),
    dict(fractal_type="burning_ship", center_x=-0.5, center_y=-0.6,
         zoom=2.0, interior_style=3, color_brightness=0.05),
    dict(fractal_type="phoenix", max_iterations=64),
    dict(fractal_type="phoenix", max_iterations=64, antialiasing_samples=2,
         stripe_density=8.0, phoenix_p=0.1, phoenix_r=-0.4),
    dict(fractal_type="phoenix", max_iterations=64, use_julia_set=True,
         julia_c_real=0.3, julia_c_imag=0.2, stripe_density=0.0),
]


def _scenes(kw):
    jax_scene = fr.Scene.from_dict(kw)
    return Scene.from_dict(json.loads(jax_scene.to_json())), jax_scene


@pytest.mark.parametrize("kw", SCENES, ids=[str(i) for i in
                                            range(len(SCENES))])
def test_render_scene_colours_within_1e5_of_jax_golden(kw):
    scene, jax_scene = _scenes(kw)
    got = golden.render_scene(scene, W, H)
    want = jax_golden.render_scene(jax_scene, W, H)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("ftype", ["mandelbulb", "deep_zoom"])
def test_render_scene_raises_for_the_other_types(ftype):
    scene, _ = _scenes(dict(fractal_type=ftype))
    with pytest.raises(NotImplementedError, match="golden render"):
        golden.render_scene(scene, 8, 4)


def _png_pixels(img, bit_depth):
    rows = _prepare_rows(np.ascontiguousarray(img[::-1]), bit_depth)
    if bit_depth == 16:
        rows = rows.view(">u2")
    return rows.reshape(img.shape).astype(np.int64)


@pytest.mark.parametrize("extra,bit_depth", [
    ([], 8), ([], 16), (["--type", "julia", "--aa", "2"], 8),
    (["--type", "burning-ship", "--orbit-trap", "--stripes",
      "--interior-style", "2", "--center", "-0.5", "-0.6", "--zoom", "2"],
     8),
    (["--type", "phoenix", "--iters", "64"], 16),
], ids=["default-8", "default-16", "julia-aa2", "ship-options",
        "phoenix-16"])
def test_render_golden_png_within_1_lsb_of_jax_golden(tmp_path, capsys,
                                                      extra, bit_depth):
    from fractalrenderer_tpu import cli as jax_cli

    out = str(tmp_path / "g.png")
    argv = ["render", "--golden", "--width", str(W), "--height", str(H),
            "--bit-depth", str(bit_depth), *extra, "--out", out]
    assert cli.main(argv) == 0
    assert "on the CPU golden reference" in capsys.readouterr().out
    img = read_png(out)
    assert img.dtype == (np.uint8 if bit_depth == 8 else np.uint16)
    jax_scene = jax_cli.scene_from_args(jax_cli.build_parser().parse_args(
        argv))
    want = _png_pixels(jax_golden.render_scene(jax_scene, W, H), bit_depth)
    assert np.abs(img.astype(np.int64) - want).max() <= 1


def test_render_golden_needs_no_cuda(tmp_path, monkeypatch):
    # the golden is the CPU reference: no device is asked for
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "g.png"
    assert cli.main(["render", "--golden", "--width", "16", "--height", "8",
                     "--iters", "32", "--out", str(out)]) == 0
    assert read_png(str(out)).shape == (8, 16, 3)


def test_render_golden_of_a_3d_type_exits_2(tmp_path, capsys):
    out = tmp_path / "g.png"
    assert cli.main(["render", "--golden", "--type", "mandelbulb",
                     "--width", "16", "--height", "8", "--out",
                     str(out)]) == 2
    err = capsys.readouterr().err.strip()
    assert err.startswith("error: golden render for") and "\n" not in err
    assert not out.exists()
