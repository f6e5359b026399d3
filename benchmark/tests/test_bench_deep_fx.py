"""The cell ``deep_zoom_fx.floor_export`` cut to a size the CPU holds (the
same files; the frame, the pass, the iterations and the sample made
small): it runs through the window correct, its traced run reads its
counter, a planted fault and the double-double control read not correct,
a frame in another tier stops the run, the window computes no orbit, and
the driver refuses a configuration it does not run.  Marked ``cuda``: the
control fails at the cell's own size on the card."""
import pytest
import torch

from benchmark.control import run_control
from benchmark.harness import core, spec
from benchmark.harness.traffic import generate

CELL = "deep_zoom_fx.floor_export"


def small_fx(**over) -> spec.Cell:
    c = spec.load_cell(CELL)
    c.config.update(export_width=32, export_height=18, max_iterations=1200)
    c.traffic.update(frames=4)
    c.checks.update(sample_frames=2, row_stride=4)
    for k, v in over.items():
        for d in (c.config, c.traffic, c.checks):
            if k in d:
                d[k] = v
    return c


def test_the_small_cell_is_correct():
    r = core.run(small_fx(), 2 ** 31 + 17, 0.05, False, device="cpu")
    assert r["correct"] is True, r["checks"]
    assert sorted(r["metrics"]) == ["frame_p95_ms", "frames_per_s",
                                    "setup_s"]


def test_the_small_cell_traces():
    r = core.run(small_fx(export_width=16, export_height=9, frames=3), 5,
                 0.05, True, device="cpu")
    assert r["correct"] is True, r["checks"]
    # the CPU has no device trace: the counter alone reads
    assert r["metrics"]["rebase_passes_per_frame"]["value"] >= 2
    assert "k3fx_roofline" not in r["metrics"]


def test_a_planted_fault_is_not_correct(monkeypatch):
    from fractalrenderer_tpu_torch import models

    render = models.render

    def altered(*a, **k):
        img, info = render(*a, **k)
        img = img.clone()
        img[:, 3, 0] ^= 1  # one channel of one column, in every row
        return img, info
    monkeypatch.setattr(models, "render", altered)
    r = core.run(small_fx(), 2 ** 31 + 17, 0.05, False, device="cpu")
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("seed", [2, 2 ** 31 + 40])
def test_the_dd_control_fails(seed):
    r = run_control(small_fx(), seed, "cpu")
    assert r["fails"], r["checks"]


def test_a_frame_in_another_tier_stops_the_run(monkeypatch):
    from fractalrenderer_tpu_torch import models

    render = models.render

    def other_tier(*a, **k):
        img, info = render(*a, **k)
        return img, dict(info, scaled_delta=False, dd_delta=True)
    monkeypatch.setattr(models, "render", other_tier)
    with pytest.raises(RuntimeError, match="dd deltas"):
        core.run(small_fx(), 3, 0.05, False, device="cpu")


def test_the_window_computes_no_orbit(monkeypatch):
    from fractalrenderer_tpu_torch.deepzoom import orbit

    cell = small_fx(frames=6, zoom_from="1e-290", zoom_to="1e-326")
    tr = generate(cell.traffic, cell.config, cell.checks, 11)
    drv = cell.module("drivers", "deep_fx_frames").Driver(
        cell.config, cell.traffic, cell.checks, tr, 11, "cpu")
    assert len(drv.buckets()) == 2  # 1e-290 and 1e-326 take other bits
    drv.setup()

    def refused(*a, **k):
        raise AssertionError("an orbit computed after set-up")
    monkeypatch.setattr(orbit, "compute_orbit", refused)
    for unit in drv.units:
        drv.outputs(unit, drv.submit(unit))


@pytest.mark.parametrize("key,value", [("precision", "dd"),
                                       ("quantize_bits", 16),
                                       ("fractal", "mandelbrot")])
def test_a_configuration_the_driver_does_not_run_is_refused(key, value):
    cell = small_fx()
    cell.config[key] = value
    with pytest.raises(ValueError):
        core.run(cell, 1, 0.05, False, device="cpu")


@pytest.mark.cuda
def test_the_control_fails_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for seed in (31, 32, 33):
        r = run_control(spec.load_cell(CELL), seed, "cuda:0")
        assert r["fails"], r["checks"]
