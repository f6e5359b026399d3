"""The band seam between ``parallel/`` and the models.

``models.band_renderer(scene, W, H, device=...)`` gives ``fn(row0, rows)``
for every kind; rows from uneven bands, joined, are ``models.render``'s
image bit for bit (the bulb's shading glue within the CPU tail tolerance
of test_torch_parallel_deep.py, 1e-6).  The import direction is ``cli`` →
``parallel/tiled`` → ``models`` → ``ops`` and ``parallel/mesh``, and
nothing under ``parallel/`` tests the fractal kind.
"""
import ast
import os

import pytest
import torch

from fractalrenderer_tpu_torch import FractalType, Scene, models

PKG = os.path.join(os.path.dirname(__file__), os.pardir,
                   "fractalrenderer_tpu_torch")
KINDS = {
    "mandelbrot": dict(antialiasing_samples=2, orbit_trap_enabled=True),
    "julia": dict(fractal_type=FractalType.JULIA),
    "burning_ship": dict(fractal_type=FractalType.BURNING_SHIP,
                         stripe_enabled=True, interior_style=2),
    "phoenix": dict(fractal_type=FractalType.PHOENIX),
    "mandelbulb": dict(fractal_type=FractalType.MANDELBULB,
                       max_iterations=10, time=1.0),
    "deep_zoom": dict(fractal_type=FractalType.DEEP_ZOOM,
                      use_perturbation=True,
                      hp_center_x="-0.743643887037151",
                      hp_center_y="0.13182590420533", hp_zoom="1e-8",
                      max_iterations=300),
}


@pytest.mark.parametrize("kind", list(KINDS))
def test_band_renderer_rows_equal_the_whole_render(kind):
    s = Scene(**{"max_iterations": 64, **KINDS[kind]})
    W, H = 64, 22  # whole vector blocks in every band (the CPU tail)
    fn = models.band_renderer(s, W, H, device="cpu")
    parts = [fn(row0, rows) for row0, rows in ((0, 5), (5, 9), (14, 8))]
    assert [p.shape for p in parts] == [(5, W, 3), (9, W, 3), (8, W, 3)]
    assert all(p.dtype == torch.float32 for p in parts)
    got = torch.cat(parts)
    want = models.render(s, W, H, device="cpu")
    if kind == "mandelbulb":
        assert float((got - want).abs().max()) <= 1e-6
    else:
        assert torch.equal(got, want)


def _sources(sub):
    names = os.listdir(os.path.join(PKG, sub))
    return sorted(f"{sub}/{n}" for n in names if n.endswith(".py"))


def _tree(rel):
    path = os.path.join(PKG, rel)
    return ast.parse(open(path).read(), path)


def _imports(rel):
    """The absolute module names a file imports (``from a import b``
    gives both a and a.b), relative imports resolved."""
    pkg = ["fractalrenderer_tpu_torch", *rel.split("/")[:-1]]
    for node in ast.walk(_tree(rel)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = pkg[:len(pkg) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            yield mod
            yield from (f"{mod}.{a.name}" for a in node.names)


@pytest.mark.parametrize("rel", _sources("models"))
def test_models_do_not_import_parallel_tiled(rel):
    names = set(_imports(rel))
    assert "fractalrenderer_tpu_torch.parallel.tiled" not in names
    assert "fractalrenderer_tpu_torch.parallel.render_sharded" not in names


@pytest.mark.parametrize("rel", _sources("parallel"))
def test_parallel_never_tests_the_fractal_kind(rel):
    kinds = [n.attr for n in ast.walk(_tree(rel))
             if isinstance(n, ast.Attribute)
             and isinstance(n.value, ast.Name) and n.value.id == "FractalType"]
    assert kinds == []
    if rel == "parallel/mesh.py":
        assert not any(m.startswith("fractalrenderer_tpu_torch.models")
                       for m in _imports(rel))
