"""Nothing under benchmark/ imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the plain reference imports nothing of the port."""
import ast
import os
import subprocess
import sys

import pytest

from small_cells import ROOT

BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "fractalrenderer_tpu"}


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_anywhere(path):
    assert not set(_top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_port(path):
    names = set(_top_level_imports(path))
    assert not names & (FORBIDDEN | {"fractalrenderer_tpu_torch"})
    assert "import_module" not in open(path).read()


def test_the_harness_and_the_port_load_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.harness.core as core, benchmark.control\n"
        "from benchmark.harness.spec import load_module\n"
        "for d in ('anim_batch', 'deep_frames'): load_module('drivers', d)\n"
        "import fractalrenderer_tpu_torch.models.common, "
        "fractalrenderer_tpu_torch.models.deep_zoom, "
        "fractalrenderer_tpu_torch.models\n"
        "print(core.forbidden_modules())\n") % ROOT
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
