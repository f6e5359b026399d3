"""The lower-precision control comes out as not correct: the plain
reference computed in the precision below the configuration's, put in the
program's place (benchmark/control.py).  On the CPU at a small size, and,
marked ``cuda``, on the card at the cells' own size."""
import pytest
import torch

from small_cells import ANIM, DEEP, small
from benchmark.control import run_control
from benchmark.harness.spec import load_cell


def _small_control(name):
    if name == ANIM:
        return small(ANIM)
    # f32 deltas part from double-double ones only over long orbits: the
    # cell's own view and zooms with 3000 iterations, at 32 x 18
    c = load_cell(DEEP)
    return small(DEEP, export_width=32, export_height=18,
                 max_iterations=3000, center_x=c.config["center_x"],
                 center_y=c.config["center_y"],
                 zoom_from=c.traffic["zoom_from"],
                 zoom_to=c.traffic["zoom_to"])


@pytest.mark.parametrize("name", [ANIM, DEEP])
@pytest.mark.parametrize("seed", [2, 2 ** 31 + 40])
def test_control_fails_small(name, seed):
    r = run_control(_small_control(name), seed, "cpu")
    assert r["fails"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [ANIM, DEEP])
def test_control_fails_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for seed in (31, 32, 33):
        r = run_control(load_cell(name), seed, "cuda:0")
        assert r["fails"], r["checks"]
