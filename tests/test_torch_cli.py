"""The port's CLI ``render`` verb on the CPU device (the four families with
their options, ``--precision dd`` and ``--type deep-zoom``; ``--type
mandelbulb`` is in test_torch_bulb.py, the deep-zoom families and ``--spp``
in test_torch_deepzoom_aa.py), and its rejection of everything not ported
yet (exit code 2, one line on stderr)."""
import json
import os

import numpy as np
import pytest
import torch

import fractalrenderer_tpu as fr
from fractalrenderer_tpu.utils.png import _prepare_rows, read_png
from fractalrenderer_tpu_torch import cli


def _golden_png_pixels(scene, w, h, bit_depth):
    ref = fr.render_numpy(scene, w, h)[::-1]
    rows = _prepare_rows(ref, bit_depth)
    if bit_depth == 16:
        rows = rows.view(">u2")
    return rows.reshape(h, w, 3).astype(np.int64)


@pytest.mark.parametrize("bit_depth", [8, 16])
def test_render_png_matches_golden(tmp_path, capsys, bit_depth):
    out = str(tmp_path / "m.png")
    rc = cli.main(["render", "--device", "cpu", "--width", "96", "--height",
                   "64", "--bit-depth", str(bit_depth), "--out", out])
    assert rc == 0
    assert "Rendered 96x64 Mandelbrot on cpu" in capsys.readouterr().out
    img = read_png(out)
    assert img.shape == (64, 96, 3)
    assert img.dtype == (np.uint8 if bit_depth == 8 else np.uint16)
    want = _golden_png_pixels(fr.Scene(), 96, 64, bit_depth)
    assert np.abs(img.astype(np.int64) - want).max() <= 1


def test_render_preset_and_metadata(tmp_path):
    out = str(tmp_path / "sea.png")
    rc = cli.main(["render", "--device", "cpu", "--preset", "Seahorse Valley",
                   "--width", "32", "--height", "16", "--iters", "64",
                   "--out", out])
    assert rc == 0
    raw = open(out, "rb").read()
    assert b"Zoom\x000.008000000" in raw
    assert b"Software\x00fractalrenderer_tpu_torch" in raw
    scene = fr.presets.find_preset("Seahorse Valley").apply(fr.Scene())
    want = _golden_png_pixels(scene.with_(max_iterations=64), 32, 16, 8)
    assert np.abs(read_png(out).astype(np.int64) - want).max() <= 1


def test_render_scene_file_written_by_jax(tmp_path, capsys):
    sf = tmp_path / "s.json"
    scene = fr.Scene(palette_mode=3, interior_style=1, color_offset=0.25,
                     color_scale=2.0, max_iterations=48)
    sf.write_text(scene.to_json())
    out = str(tmp_path / "s.png")
    rc = cli.main(["render", "--device", "cpu", "--scene", str(sf),
                   "--width", "40", "--height", "24", "--debug",
                   "--out", out])
    assert rc == 0
    assert "palette=3" in capsys.readouterr().err
    want = _golden_png_pixels(scene, 40, 24, 8)
    assert np.abs(read_png(out).astype(np.int64) - want).max() <= 1


UNPORTED = [
    ["--type", "deep-zoom", "--spp", "2", "--exact-dust"],
    ["--type", "deep-zoom", "--deep-ship", "--sharded"],
    ["--sharded"], ["--exact-dust"], ["--width", "0"],
    # the JAX CLI's own refusal: dd is the Mandelbrot kernel
    ["--precision", "dd", "--type", "julia"],
]

# deep-zoom options the port refuses → what its message names: the ROADMAP
# item of the unported --sharded, or (the JAX CLI's own guard) the Burning
# Ship tier that --exact-dust belongs to.  The families, --spp and
# --deep-ship --exact-dust render (test_torch_deepzoom_aa.py,
# test_torch_exact_dust.py).
DEEP_ZOOM_UNPORTED = [
    (["--deep-julia", "--exact-dust"], "Burning Ship dust tier"),
    (["--deep-julia", "--sharded"], "ROADMAP Queue 1 item 8"),
    (["--deep-phoenix", "--sharded"], "ROADMAP Queue 1 item 8"),
    (["--spp", "2", "--exact-dust"], "Burning Ship dust tier"),
    (["--spp", "4", "--sharded"], "ROADMAP Queue 1 item 8"),
    (["--exact-dust"], "Burning Ship dust tier"),
]

# every family option of the render verb, alone and combined
FAMILY_OPTIONS = [
    ["--aa", "2"], ["--orbit-trap"], ["--stripes"],
    ["--interior-style", "2"], ["--type", "julia"],
    ["--type", "burning-ship"], ["--type", "phoenix"],
    ["--julia-preset", "San Marco"],
    ["--type", "phoenix", "--use-julia-set", "--julia-cr", "0.3",
     "--julia-ci", "0.2"],
    ["--type", "burning-ship", "--orbit-trap", "--stripes",
     "--interior-style", "2", "--center", "-0.5", "-0.6", "--zoom", "2"],
    ["--type", "julia", "--julia-preset", "Douady's Rabbit", "--aa", "4",
     "--palette", "7"],
]


def _jax_scene(argv):
    from fractalrenderer_tpu import cli as jax_cli

    return jax_cli.scene_from_args(jax_cli.build_parser().parse_args(
        ["render", *argv]))


@pytest.mark.parametrize("extra", FAMILY_OPTIONS, ids=" ".join)
def test_family_options_render_png_matches_golden(tmp_path, capsys, extra):
    out = str(tmp_path / "f.png")
    rc = cli.main(["render", "--device", "cpu", "--width", "40", "--height",
                   "24", "--iters", "64", *extra, "--out", out])
    assert rc == 0, capsys.readouterr().err
    img = read_png(out)
    assert img.shape == (24, 40, 3)
    want = _golden_png_pixels(_jax_scene(["--iters", "64", *extra]), 40, 24,
                              8)
    assert np.abs(img.astype(np.int64) - want).max() <= 1


@pytest.mark.parametrize("extra", [
    ["--precision", "dd"],
    ["--precision", "dd", "--preset", "Seahorse Valley", "--hp-zoom",
     "1e-7", "--iters", "300", "--bit-depth", "16"],
], ids=" ".join)
def test_precision_dd_renders_png(tmp_path, extra):
    from fractalrenderer_tpu_torch.models.mandelbrot import render_dd

    out = str(tmp_path / "dd.png")
    rc = cli.main(["render", "--device", "cpu", "--width", "40", "--height",
                   "24", *extra, "--out", out])
    assert rc == 0
    bit_depth = 16 if "16" in extra else 8
    scene = cli.scene_from_args(cli.build_parser().parse_args(
        ["render", *extra]))
    ref = render_dd(scene, 40, 24, device="cpu").numpy()[::-1]
    rows = _prepare_rows(ref, bit_depth)
    if bit_depth == 16:
        rows = rows.view(">u2")
    want = rows.reshape(24, 40, 3).astype(np.int64)
    assert np.abs(read_png(out).astype(np.int64) - want).max() == 0


@pytest.mark.parametrize("extra", UNPORTED, ids=" ".join)
def test_unported_render_options_exit_2(tmp_path, capsys, extra):
    out = tmp_path / "x.png"
    rc = cli.main(["render", "--device", "cpu", "--width", "16", "--height",
                   "8", *extra, "--out", str(out)])
    assert rc == 2
    err = capsys.readouterr().err.strip()
    assert err.startswith("error:") and "\n" not in err
    assert not out.exists()


@pytest.mark.parametrize("extra,item", DEEP_ZOOM_UNPORTED,
                         ids=[" ".join(e) for e, _ in DEEP_ZOOM_UNPORTED])
def test_deep_zoom_unported_options_name_their_item(tmp_path, capsys, extra,
                                                    item):
    out = tmp_path / "x.png"
    rc = cli.main(["render", "--device", "cpu", "--type", "deep-zoom",
                   "--width", "16", "--height", "8", *extra,
                   "--out", str(out)])
    assert rc == 2
    err = capsys.readouterr().err.strip()
    assert err.startswith("error:") and "\n" not in err
    assert item in err
    assert not out.exists()


DEEP_ZOOM_VIEW = ["--type", "deep-zoom", "--hp-center-x",
                  "0.245670923653024", "--hp-center-y", "0.580340963154017",
                  "--hp-zoom", "1e-9", "--iters", "400"]


@pytest.mark.parametrize("extra", [[], ["--series", "--palette", "2",
                                        "--bit-depth", "16"]],
                         ids=["default", "series palette 2 16-bit"])
def test_deep_zoom_renders_png(tmp_path, capsys, extra):
    from fractalrenderer_tpu_torch import models
    from fractalrenderer_tpu_torch.utils.image import to_export_orientation

    out = str(tmp_path / "dz.png")
    argv = ["render", "--device", "cpu", "--width", "48", "--height", "32",
            *DEEP_ZOOM_VIEW, *extra, "--out", out]
    rc = cli.main(argv)
    assert rc == 0
    said = capsys.readouterr()
    assert "Rendered 48x32 Deep_Zoom on cpu" in said.out
    assert "0 HP-fallback, 0 remaining" in said.out
    bit_depth = 16 if "16" in extra else 8
    img = read_png(out)
    assert img.shape == (32, 48, 3)
    scene = cli.scene_from_args(cli.build_parser().parse_args(argv))
    ref = to_export_orientation(models.render(
        scene, 48, 32, device="cpu", quantize=bit_depth)).numpy()
    assert ref.dtype == img.dtype
    np.testing.assert_array_equal(img, ref)
    assert 0 < img.mean() < (255 if bit_depth == 8 else 65535)


@pytest.mark.parametrize("verb", sorted(cli._UNPORTED_VERBS))
def test_unported_verbs_exit_2(capsys, verb):
    rc = cli.main([verb, "--out", "x", "positional"])
    assert rc == 2
    err = capsys.readouterr().err.strip()
    assert err.startswith("error:") and "not ported yet" in err


def test_cuda_device_without_cuda_exits_2(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["render", "--width", "16", "--height", "8", "--out",
                   str(tmp_path / "x.png")])
    assert rc == 2
    assert "CUDA is not available" in capsys.readouterr().err


def test_unknown_render_flag_is_an_argparse_error():
    with pytest.raises(SystemExit) as e:
        cli.main(["render", "--device", "cpu", "--no-such-flag"])
    assert e.value.code == 2


def test_scene_args_match_jax_cli():
    # the port keeps the JAX CLI's scene flags, so a command line written
    # for one parses in the other
    from fractalrenderer_tpu import cli as jax_cli

    argv = ["render", "--preset", "Triple Spiral", "--palette", "2",
            "--iters", "77", "--center", "0.1", "0.2", "--brightness", "1.3"]
    mine = cli.scene_from_args(cli.build_parser().parse_args(argv))
    ref = jax_cli.scene_from_args(jax_cli.build_parser().parse_args(argv))
    assert json.loads(mine.to_json()) == json.loads(ref.to_json())


def test_presets_and_info(capsys):
    # twin of tests/test_cli.py::test_presets_and_info
    assert cli.main(["presets"]) == 0
    out = capsys.readouterr().out
    assert "Seahorse Valley" in out and "Douady's Rabbit" in out
    assert "40x60 @ 300 DPI" in out
    assert cli.main(["info"]) == 0
    out = capsys.readouterr().out
    assert "fractalrenderer_tpu_torch" in out and "backend" in out


def test_presets_prints_the_jax_clis_tables(capsys):
    from fractalrenderer_tpu import cli as jax_cli

    assert jax_cli.main(["presets"]) == 0
    want = capsys.readouterr().out
    assert cli.main(["presets"]) == 0
    assert capsys.readouterr().out == want


def test_info_reports_nvcc_and_the_kernel_library(capsys, tmp_path,
                                                  monkeypatch):
    from fractalrenderer_tpu_torch.ops import _cuda

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_cuda, "find_nvcc", no_nvcc)
    monkeypatch.setenv("FRACTAL_TORCH_BUILD_DIR", str(tmp_path))
    assert cli.main(["info"]) == 0
    out = capsys.readouterr().out
    assert f"torch {torch.__version__}" in out
    assert "nvcc: NOT FOUND: kernels cannot build" in out
    assert f"kernel library: not built ({tmp_path}" in out
    open(_cuda.library_path(), "w").close()
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\necho 'nvcc: NVIDIA (R) Cuda compiler "
                    "driver'\necho 'Cuda compilation tools, release 12.9'\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_cuda, "find_nvcc", lambda: str(nvcc))
    assert cli.main(["info"]) == 0
    out = capsys.readouterr().out
    assert f"nvcc: {nvcc} (Cuda compilation tools, release 12.9)" in out
    assert f"kernel library: built ({tmp_path}" in out
    assert sorted(os.listdir(tmp_path)) == [
        "bin", os.path.basename(_cuda.library_path())]
