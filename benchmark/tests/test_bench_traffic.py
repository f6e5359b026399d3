"""The generator: one seed gives the same inputs, another seed other ones,
every seed the same number of frames at the same sizes."""
import pytest

from small_cells import ANIM, DEEP
from benchmark.harness import spec
from benchmark.harness.traffic import generate

SEEDS = (0, 7, 2 ** 31 + 11, 3 * 2 ** 32 + 5)


@pytest.mark.parametrize("name", [ANIM, DEEP])
def test_same_seed_same_inputs(name):
    c = spec.load_cell(name)
    for s in SEEDS:
        a = generate(c.traffic, c.config, c.checks, s)
        b = generate(c.traffic, c.config, c.checks, s)
        assert a == b


@pytest.mark.parametrize("name", [ANIM, DEEP])
def test_other_seed_other_inputs(name):
    c = spec.load_cell(name)
    runs = [generate(c.traffic, c.config, c.checks, s) for s in SEEDS]
    for i in range(len(runs)):
        for j in range(i + 1, len(runs)):
            assert runs[i].frames != runs[j].frames
            assert (runs[i].order, runs[i].sample) != (runs[j].order,
                                                       runs[j].sample)


@pytest.mark.parametrize("name", [ANIM, DEEP])
def test_every_seed_the_same_work_shape(name):
    c = spec.load_cell(name)
    n = int(c.traffic["frames"])
    iters = None
    for s in SEEDS:
        t = generate(c.traffic, c.config, c.checks, s)
        assert sorted(t.order) == list(range(n))
        assert len(t.sample) == int(c.checks["sample_frames"])
        assert set(t.sample) <= set(range(n))
        its = [f["max_iterations"] for f in t.frames]
        assert iters is None or its == iters
        iters = its


def test_anim_path_ends():
    c = spec.load_cell(ANIM)
    t = generate(c.traffic, c.config, c.checks, 5)
    k1, k2 = c.traffic["keyframes"]
    assert t.frames[0]["zoom"] == k1["zoom"]
    assert t.frames[0]["max_iterations"] == 256
    assert t.frames[-1]["max_iterations"] == 1024
    # the end centre moves by at most 1% of the end view; the last frame
    # lies one frame's step short of the end
    last = t.frames[-1]
    step = abs(k1["center_x"] - k2["center_x"]) / c.traffic["frames"]
    assert abs(last["center_x"] - k2["center_x"]) <= (0.01 * k2["zoom"]
                                                      + step * 1.01)
    assert abs(last["zoom"] / k2["zoom"] - 1) < 0.02


def test_deep_path_is_geometric_about_one_centre():
    from fractions import Fraction

    c = spec.load_cell(DEEP)
    t = generate(c.traffic, c.config, c.checks, 9)
    zs = [float(Fraction(f["hp_zoom"])) for f in t.frames]
    assert zs[0] == pytest.approx(1e-11) and zs[-1] == pytest.approx(1e-13)
    ratios = [b / a for a, b in zip(zs, zs[1:])]
    assert max(ratios) == pytest.approx(min(ratios), rel=1e-9)
    assert len({(f["hp_center_x"], f["hp_center_y"]) for f in t.frames}) == 1
    view = 4 * 1e-13 / int(c.config["export_height"])
    cx = float(Fraction(t.frames[0]["hp_center_x"]))
    assert abs(cx - float(Fraction(c.config["center_x"]))) <= 0.25 * view
