"""The port's import boundary and its device dispatch: it loads neither jax
nor the JAX package, its kernel-build module imports without a CUDA
toolkit, and a CUDA device never falls back to the CPU path (K1, K2 and
K3; the live session's in test_torch_live.py)."""
import os
import subprocess
import sys

import pytest
import torch

import fractalrenderer_tpu_torch as frt
from fractalrenderer_tpu_torch.ops import _cuda, escape

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import fractalrenderer_tpu_torch
import fractalrenderer_tpu_torch.anim
import fractalrenderer_tpu_torch.anim.franim
import fractalrenderer_tpu_torch.anim.keyframes
import fractalrenderer_tpu_torch.anim.qtpng
import fractalrenderer_tpu_torch.anim.renderer
import fractalrenderer_tpu_torch.anim.video
import fractalrenderer_tpu_torch.bench_all
import fractalrenderer_tpu_torch.cli
import fractalrenderer_tpu_torch.deepzoom
import fractalrenderer_tpu_torch.deepzoom.hp
import fractalrenderer_tpu_torch.deepzoom.manager
import fractalrenderer_tpu_torch.deepzoom.orbit
import fractalrenderer_tpu_torch.deepzoom.series
import fractalrenderer_tpu_torch.gfx
import fractalrenderer_tpu_torch.live
import fractalrenderer_tpu_torch.models.burning_ship
import fractalrenderer_tpu_torch.models.deep_zoom
import fractalrenderer_tpu_torch.models.julia
import fractalrenderer_tpu_torch.models.mandelbrot
import fractalrenderer_tpu_torch.models.phoenix
import fractalrenderer_tpu_torch.ops._cuda
import fractalrenderer_tpu_torch.ops.coloring
import fractalrenderer_tpu_torch.ops.dd
import fractalrenderer_tpu_torch.ops.dd_escape
import fractalrenderer_tpu_torch.ops.escape
import fractalrenderer_tpu_torch.ops.perturbation
import fractalrenderer_tpu_torch.ops.trig
import fractalrenderer_tpu_torch.parallel
import fractalrenderer_tpu_torch.parallel.mesh
import fractalrenderer_tpu_torch.parallel.tiled
import fractalrenderer_tpu_torch.reference.golden
import fractalrenderer_tpu_torch.utils.native_build
import fractalrenderer_tpu_torch.utils.png
import fractalrenderer_tpu_torch.viewer
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "fractalrenderer_tpu")]
print(",".join(sorted(bad)))
"""


def test_import_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == ""


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_cuda, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.build()
    assert not (tmp_path / "build").exists()


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(_cuda, "CSRC_DIR", str(tmp_path))
    first = _cuda.library_path()
    assert first == _cuda.library_path()
    (tmp_path / "k.cu").write_text("// v2\n")
    assert _cuda.library_path() != first
    assert os.path.dirname(first) == _cuda.BUILD_DIR


def test_kernel_sources_ship_in_the_package():
    assert [os.path.basename(s) for s in _cuda.sources()] == [
        "bulb.cu", "dd.cuh", "dd_escape.cu", "escape.cu", "floatexp.cuh",
        "peak.cu", "pert_julia.cu", "pert_kernel.cuh", "pert_phoenix.cu",
        "pert_ship.cu", "perturbation.cu", "warp_counters.cuh"]


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = escape.escape_fields_cuda.launches
    kw = dict(center_x=-0.5, center_y=0.0, zoom=3.0, max_iter=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        escape.escape_fields("mandelbrot", 8, 8, device="cuda", **kw)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        frt.render(frt.Scene(max_iterations=16), 8, 8, device="cuda")
    assert escape.escape_fields_cuda.launches == before


@pytest.mark.parametrize("scene", [
    dict(fractal_type=frt.FractalType.JULIA, antialiasing_samples=2),
    dict(fractal_type=frt.FractalType.BURNING_SHIP, orbit_trap_enabled=True),
    dict(fractal_type=frt.FractalType.PHOENIX),
], ids=["julia_aa2", "ship_unfused", "phoenix"])
def test_cuda_device_never_falls_back(monkeypatch, scene):
    # every branch of the pipeline reaches a kernel wrapper that raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        frt.render(frt.Scene(max_iterations=16, **scene), 8, 8,
                   device="cuda")


def test_batch_paths_on_cuda_never_fall_back(monkeypatch, tmp_path):
    # the batch pipeline, the c sweep and the animation renderer raise on a
    # CUDA device without CUDA, before any launch or file
    from fractalrenderer_tpu_torch.anim import AnimationRenderer
    from fractalrenderer_tpu_torch.anim.keyframes import Animation, Keyframe
    from fractalrenderer_tpu_torch.models import common, julia

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = escape.escape_fields_cuda.launches
    scene = frt.Scene(max_iterations=16)
    cfg = common.scene_static_cfg(scene, 8, 8, "mandelbrot", "centered",
                                  False)
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        common.batch_render_fn(cfg, quantize=8, planar=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        julia.render_c_sweep(scene, [(0.1, 0.2)], 8, 8)
    a = Animation(duration=2.0, target_fps=1, export_width=8,
                  export_height=8)
    a.keyframes += [Keyframe(0.0, scene), Keyframe(2.0, scene)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AnimationRenderer().start_render(a, str(tmp_path / "f"))
    assert not os.listdir(tmp_path / "f")
    assert escape.escape_fields_cuda.launches == before


def test_band_paths_on_cuda_never_fall_back(monkeypatch, tmp_path):
    # the row-band renders and the giant still raise on a CUDA device
    # without CUDA, before any launch or file
    from fractalrenderer_tpu_torch.parallel import (make_render_mesh,
                                                    render_giant_still,
                                                    render_sharded)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = escape.escape_fields_cuda.launches
    scene = frt.Scene(max_iterations=16)
    mesh = make_render_mesh(devices=["cuda:0"] * 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_sharded(scene, 8, 8, mesh=mesh)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_sharded(frt.Scene(fractal_type=frt.FractalType.MANDELBULB),
                       8, 8, mesh=mesh)
    out = tmp_path / "g.png"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_giant_still(scene, 8, 8, str(out), band_rows=4)
    assert not os.listdir(tmp_path)
    assert escape.escape_fields_cuda.launches == before


def test_dd_cuda_device_without_cuda_raises(monkeypatch):
    from fractalrenderer_tpu_torch.models.mandelbrot import render_dd
    from fractalrenderer_tpu_torch.ops import dd_escape

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = dd_escape.dd_escape_fields_cuda.launches
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_dd(frt.Scene(max_iterations=16), 8, 8, device="cuda")
    params = dd_escape.pack_dd_params(center_x_dd=(0.0, 0.0),
                                      center_y_dd=(0.0, 0.0),
                                      zoom_dd=(3.0, 0.0), iter_limit=8)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        dd_escape.dd_escape_fields_cuda(params, width=4, height=4,
                                        map_height=4, row0=0, device="cpu")
    assert dd_escape.dd_escape_fields_cuda.launches == before


def test_perturbation_cuda_device_without_cuda_raises(monkeypatch):
    from fractalrenderer_tpu_torch.models import deep_zoom
    from fractalrenderer_tpu_torch.ops import perturbation

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = perturbation.perturbation_fields_cuda.launches
    scene = frt.Scene(fractal_type=frt.FractalType.DEEP_ZOOM,
                      hp_center_x="0", hp_center_y="1", hp_zoom="1e-9",
                      max_iterations=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        deep_zoom.render(scene, 8, 8, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        frt.render(scene, 8, 8, device="cuda")
    assert perturbation.perturbation_fields_cuda.launches == before
    img = frt.render(scene, 8, 4, device="cpu")
    assert img.device.type == "cpu" and img.shape == (4, 8, 3)
    assert perturbation.perturbation_fields_cuda.launches == before


def test_cpu_path_launches_no_kernel():
    from fractalrenderer_tpu_torch.models.mandelbrot import render_dd
    from fractalrenderer_tpu_torch.ops import dd_escape

    before = escape.escape_fields_cuda.launches
    before_dd = dd_escape.dd_escape_fields_cuda.launches
    img = frt.render(frt.Scene(max_iterations=16), 8, 4, device="cpu")
    assert img.device.type == "cpu"
    img = frt.render(frt.Scene(max_iterations=16, antialiasing_samples=2,
                               fractal_type=frt.FractalType.BURNING_SHIP,
                               orbit_trap_enabled=True), 8, 4, device="cpu")
    assert img.device.type == "cpu"
    assert render_dd(frt.Scene(max_iterations=16), 8, 4,
                     device="cpu").device.type == "cpu"
    assert escape.escape_fields_cuda.launches == before
    assert dd_escape.dd_escape_fields_cuda.launches == before_dd
