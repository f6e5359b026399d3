"""The port's batched Julia c sweep (``models/julia.render_c_sweep`` on
``models/common.batch_render_fn``) and its ``sweep`` verb on the CPU
device: twins of tests/test_golden_vs_kernel.py's test_julia_c_sweep_batch
and tests/test_cli.py's test_sweep_cli, each run through the port and the
JAX package on the same seed-made inputs.

On the port a sweep entry equals the single render of its c bit for bit
(the JAX test can only ask that on its TPU).  Against the numpy golden
render every pixel agrees within atol 1e-5; against the JAX functions
(interpret mode, whose CPU FMA contraction moves some counts) the bound of
test_torch_render.py applies: |diff| > 2e-2 on < 1% of pixels, read on
PNGs as 5 LSB of 255.
"""
import os

import numpy as np
import pytest
import torch

import fractalrenderer_tpu as fr
from fractalrenderer_tpu import cli as jax_cli
from fractalrenderer_tpu.models import julia as jax_julia
from fractalrenderer_tpu.utils.png import read_png
from fractalrenderer_tpu_torch import FractalType, Scene, cli, models
from fractalrenderer_tpu_torch.models import julia
from fractalrenderer_tpu_torch.presets import JULIA_PRESETS

W, H = 48, 24


def _c_values(seed, n):
    """``n`` c values from ``seed``, around the interesting region."""
    rng = np.random.default_rng(seed)
    return [(float(a), float(b)) for a, b in
            zip(rng.uniform(-0.9, 0.4, n), rng.uniform(-0.7, 0.7, n))]


def _bad_fraction(a, b, tol):
    return (np.abs(a.astype(np.float64) - b.astype(np.float64))
            > tol).any(axis=-1).mean()


def test_julia_c_sweep_batch():
    # BASELINE config #2: one K1 launch per c; on the port every entry is
    # the single render of its c, bit for bit
    s = Scene(fractal_type=FractalType.JULIA, max_iterations=32, zoom=3.0)
    cs = list(JULIA_PRESETS.values())
    out = julia.render_c_sweep(s, cs, W, H, device="cpu")
    assert out.shape == (len(cs), H, W, 3) and out.dtype == torch.float32
    for i, (cr, ci) in enumerate(cs):
        ref = models.render(s.with_(julia_c_real=cr, julia_c_imag=ci), W, H,
                            device="cpu")
        assert torch.equal(out[i], ref), i


@pytest.mark.parametrize("seed", [0, 1])
def test_c_sweep_matches_golden(seed):
    kw = dict(max_iterations=64, zoom=2.5, center_x=0.11, center_y=-0.07,
              palette_mode=seed + 2)
    cs = _c_values(seed, 4)
    out = julia.render_c_sweep(Scene(fractal_type=FractalType.JULIA, **kw),
                               cs, W, H, device="cpu").numpy()
    for i, (cr, ci) in enumerate(cs):
        ref = fr.render_numpy(fr.Scene(fractal_type=fr.FractalType.JULIA,
                                       julia_c_real=cr, julia_c_imag=ci,
                                       **kw), W, H)
        np.testing.assert_allclose(out[i], ref, rtol=0, atol=1e-5)


def test_c_sweep_close_to_jax():
    kw = dict(max_iterations=48, zoom=3.0, center_x=0.05, center_y=0.12)
    cs = _c_values(7, 5)
    out = julia.render_c_sweep(Scene(fractal_type=FractalType.JULIA, **kw),
                               cs, W, H, device="cpu").numpy()
    ref = np.asarray(jax_julia.render_c_sweep(
        fr.Scene(fractal_type=fr.FractalType.JULIA, **kw), cs, W, H))
    assert out.shape == ref.shape
    for i in range(len(cs)):
        assert _bad_fraction(out[i], ref[i], 2e-2) < 0.01, i


def test_c_sweep_rounds_c_like_a_single_render():
    # the batch holds f32 c values; a single render rounds its Python
    # floats the same way, so c values that differ below f32 give the
    # same frame
    s = Scene(fractal_type=FractalType.JULIA, max_iterations=40, zoom=2.0)
    c = (-0.7 + 1e-12, 0.27015 - 1e-12)
    out = julia.render_c_sweep(s, [c, (-0.7, 0.27015)], 32, 18,
                               device="cpu")
    assert torch.equal(out[0], out[1])


def test_sweep_cli(tmp_path):
    out_dir = str(tmp_path / "sw")
    rc = cli.main(["sweep", "--device", "cpu", "--width", "32", "--height",
                   "16", "--iters", "16", "--count", "3", "--out-dir",
                   out_dir])
    assert rc == 0
    assert sorted(os.listdir(out_dir)) == ["sweep_000.png", "sweep_001.png",
                                           "sweep_002.png"]


@pytest.mark.parametrize("argv", [
    ["--count", "4"],
    ["--count", "3", "--c-start=-0.8,0.156", "--c-end=0.285,0.01",
     "--center", "0.1", "-0.05", "--zoom", "2.2", "--palette", "5"],
], ids=["defaults", "off-axis"])
def test_sweep_cli_matches_jax_cli(tmp_path, capsys, argv):
    # the same command through both CLIs: the same files and metadata,
    # pixels within 5 LSB on < 1% of them
    common = ["--width", "48", "--height", "27", "--iters", "64", *argv]
    mine, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    assert cli.main(["sweep", "--device", "cpu", *common, "--out-dir",
                     mine]) == 0
    assert "Rendered" in capsys.readouterr().out
    assert jax_cli.main(["sweep", *common, "--out-dir", ref]) == 0
    names = sorted(os.listdir(mine))
    assert names == sorted(os.listdir(ref))
    for name in names:
        a, b = (os.path.join(d, name) for d in (mine, ref))
        pa, pb = read_png(a), read_png(b)
        assert pa.shape == (27, 48, 3) and pa.dtype == np.uint8
        assert _bad_fraction(pa, pb, 5) < 0.01, name
        # the tEXt chunk names the same c
        ta, tb = (open(p, "rb").read() for p in (a, b))
        ca = ta[ta.index(b"Julia c"):].split(b"\x00")[1][:40]
        assert ca == tb[tb.index(b"Julia c"):].split(b"\x00")[1][:40]


def test_sweep_cli_pixels_are_the_flipped_frames(tmp_path):
    # an off-axis view, so a flip applied twice or not at all shows
    from fractalrenderer_tpu_torch.utils.image import to_export_orientation

    argv = ["--width", "40", "--height", "22", "--iters", "48",
            "--center", "0.2", "0.15", "--zoom", "2.0", "--count", "2"]
    out_dir = str(tmp_path / "sw")
    assert cli.main(["sweep", "--device", "cpu", *argv, "--out-dir",
                     out_dir]) == 0
    args = cli.build_parser().parse_args(["sweep", *argv])
    scene = cli.scene_from_args(args).with_(fractal_type=FractalType.JULIA)
    cs = [(-0.9, 0.1), (-0.6, 0.3)]
    frames = julia.render_c_sweep(scene, cs, 40, 22, device="cpu")
    for k in range(2):
        img = np.clip(to_export_orientation(frames[k]).numpy(), 0, 1)
        want = (img * 255.0 + 0.5).astype(np.uint8)
        got = read_png(os.path.join(out_dir, f"sweep_{k:03d}.png"))
        np.testing.assert_array_equal(got, want)
        assert not np.array_equal(got, want[::-1])


def test_sweep_cli_refuses_cuda_without_cuda(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["sweep", "--width", "16", "--height", "8", "--out-dir",
                   str(tmp_path / "x")])
    assert rc == 2
    assert "CUDA is not available" in capsys.readouterr().err
    assert not (tmp_path / "x").exists()


def test_sweep_flags_match_jax_cli():
    # the JAX sweep parser's flags and defaults, plus --device
    def flags(parser):
        sp = parser._subparsers._group_actions[0].choices["sweep"]
        return {a.dest: a.default for a in sp._actions
                if a.dest not in ("help", "cpu", "device")}

    assert flags(cli.build_parser()) == flags(jax_cli.build_parser())
