"""The Julia c-sweep cell (``julia_f32.c_sweep``) on the CPU: the cell cut
to a small size through the window and the control, a planted fault, a
configuration the driver does not run, K1's work count against a count by
hand, and the three per-layer readers on synthetic traces."""
import os

import numpy as np
import pytest
import torch

import small_cells  # noqa: F401  (puts the repository on sys.path)
from benchmark.control import run_control
from benchmark.harness import core, peaks, spec, tracing
from benchmark.harness.spec import load_module
from benchmark.harness.traffic import generate
from benchmark.reference import plain_julia
from test_bench_tracing import GLUE, K1, synthetic

SWEEP = "julia_f32.c_sweep"
US = 1e-6


def small_sweep(**over) -> spec.Cell:
    """The sweep cell cut to the CPU: 48 x 27 frames, a cap of 300, a pass
    of 16 c values (4 a leg) in sweeps of 4, 3 frames sampled."""
    c = spec.load_cell(SWEEP)
    c.config.update(export_width=48, export_height=27, max_iterations=300)
    c.traffic.update(per_leg=4, sweep_size=4)
    c.checks.update(sample_frames=3)
    for k, v in over.items():
        for d in (c.config, c.traffic, c.checks):
            if k in d:
                d[k] = v
    return c


def _driver(cell, seed):
    tr = generate(cell.traffic, cell.config, cell.checks, seed,
                  cell.bench_dir)
    drv = cell.module("drivers", cell.traffic["driver"]).Driver(
        cell.config, cell.traffic, cell.checks, tr, seed, "cpu")
    return tr, drv


# -- the small cell through the window and the control -----------------------

@pytest.mark.parametrize("seed", [3, 2 ** 31 + 70])
def test_small_cell_is_correct(seed):
    r = core.run(small_sweep(), seed, 0.05, False, device="cpu")
    assert r["correct"] is True, r["checks"]
    assert sorted(r["metrics"]) == ["frames_per_s.batch", "setup_s"]
    assert r["checks"]["lsb_max"]["value"] == 0.0
    assert r["checks"]["off_share"]["value"] == 0.0
    assert r["attempted"] >= 4


def test_small_cell_traces():
    r = core.run(small_sweep(), 8, 0.05, True, device="cpu")
    assert r["correct"] is True
    # no card: no device records or spans on its clock; the host clock's
    # and the program counter's metrics read (two copies a 2x2 AA frame)
    assert sorted(r["metrics"]) == ["dispatch_ms_per_frame",
                                    "param_uploads_per_frame"]
    assert r["metrics"]["param_uploads_per_frame"]["value"] == 2.0


@pytest.mark.parametrize("seed", [2, 2 ** 31 + 40])
def test_small_control_fails(seed):
    r = run_control(small_sweep(), seed, "cpu")
    assert set(r["fails"]) == {"lsb_max", "off_share"}, r["checks"]


def test_answer_altered_is_not_correct(monkeypatch):
    from fractalrenderer_tpu_torch.models import julia

    sweep = julia.render_c_sweep

    def altered(*a, **k):
        out = sweep(*a, **k)
        out[:, 13, 20, 1] += 0.25
        return out
    monkeypatch.setattr(julia, "render_c_sweep", altered)
    r = core.run(small_sweep(), 2 ** 31 + 21, 0.05, False, device="cpu")
    assert r["correct"] is False


@pytest.mark.parametrize("key,value", [
    ("fractal", "mandelbrot"), ("precision", "dd"), ("aa", 1),
    ("palette_mode", 3)], ids=lambda v: str(v))
def test_a_configuration_the_driver_does_not_run_is_refused(key, value):
    cell = small_sweep()
    cell.config[key] = value
    with pytest.raises(ValueError):
        core.run(cell, 1, 0.05, False, device="cpu")


def test_the_configurations_keys_are_read():
    docs = {"name", "deployment", "source", "guarantees", "assumed"}
    cell = spec.load_cell(SWEEP)
    src = "".join(open(os.path.join(cell.bench_dir, d, f"{m}.py")).read()
                  for d, m in (("drivers", cell.traffic["driver"]),
                               ("paths", cell.traffic["path"])))
    for key in set(cell.config) - docs:
        assert f'"{key}"' in src, key


def test_units_are_sweeps_of_consecutive_c_values():
    cell = spec.load_cell(SWEEP)
    tr, drv = _driver(cell, 2 ** 31 + 3)
    assert [len(u) for u in drv.units] == [16] * 4
    assert [f for u in drv.units for f in u] == tr.order


# -- K1's work ---------------------------------------------------------------

def _hand_updates(config, c, w, h, limit):
    """K1's loop updates of one frame, counted pixel by pixel in numpy
    f32 scalars: each sample's applied updates after the peeled first."""
    f = np.float32
    aa = int(config["aa"])
    so = (1.0 / w) / aa
    offs = [(sx * so - so * (aa - 1) * 0.5, sy * so - so * (aa - 1) * 0.5)
            for sx in range(aa) for sy in range(aa)]
    cx, cy, zoom = f(config["center_x"]), f(config["center_y"]), \
        f(config["zoom"])
    cr, ci = f(c[0]), f(c[1])
    bail2 = f(config["bailout"]) * f(config["bailout"])
    total = 0
    for ox, oy in offs:
        for py in range(h):
            for px in range(w):
                ux = (f(px) + f(ox) - f(0.5) * f(w)) / f(h)
                uy = (f(py) + f(oy) - f(0.5) * f(h)) / f(h)
                x, y = cx + ux * zoom, cy + uy * zoom
                x, y = x * x - y * y + cr, (f(2.0) * x) * y + ci
                for _ in range(1, limit):
                    if x * x + y * y > bail2:
                        break
                    x, y = x * x - y * y + cr, (f(2.0) * x) * y + ci
                    total += 1
    return total


def test_k1_work_equals_a_hand_count():
    w, h = 12, 7
    cell = small_sweep(export_width=w, export_height=h, max_iterations=40,
                       sample_frames=2)
    tr, drv = _driver(cell, 9)
    _, work = drv.check(drv.control_outputs(tr.sample))
    for f in tr.sample:
        c = (tr.frames[f]["c_real"], tr.frames[f]["c_imag"])
        assert work[f]["updates"] == _hand_updates(cell.config, c, w, h, 40)
        assert work[f]["bytes"] == 4 * 3 * w * h
        assert work[f]["samples"] == 4
        # the control renders no frame of the program: nothing counted
        assert work[f]["param_uploads"] is None


# -- the per-layer readers ---------------------------------------------------

# two sweep frames of 4 samples in the stretch (to 500 us), K1's records
# of a third past it
KERNELS = [(K1, 20, 10), (K1, 31, 11), (GLUE, 43, 2), (K1, 46, 9),
           (K1, 56, 10), (GLUE, 70, 30),
           (K1, 120, 12), (K1, 133, 12), (K1, 146, 12), (K1, 159, 12),
           (GLUE, 175, 28), (K1, 600, 10)]
SPANS = [
    ("dispatch", 5, 400),
    ("batch.frame", 10, 100), ("batch.glue", 40, 3), ("batch.post", 60, 20),
    ("inner", 62, 5),
    ("batch.frame", 115, 100), ("batch.post", 172, 25),
]


def _ctx(frames=(0, 1), spans=SPANS, work=None, kernels=KERNELS):
    tr = tracing.parse_trace(synthetic(kernels, extra_spans=spans))
    return {"trace": tr, "span": (0.0, 500 * US),
            "stretch_frames": list(frames), "work": work or {}}


def _read(name, ctx):
    return load_module("metrics", name).read(ctx)


def _work(updates, samples=4, uploads=2.0):
    return {"updates": updates, "bytes": 24883200, "samples": samples,
            "param_uploads": uploads}


def test_k1_sweep_roofline_by_hand():
    work = {0: _work(1.2e9), 1: _work(0.7e9)}
    got = _read("k1_sweep_roofline", _ctx(work=work))
    least = sum(peaks.least_seconds(w["updates"] * 8, w["bytes"])
                for w in work.values())
    assert got == pytest.approx(100 * least / ((40 + 48) * US))
    # only the sampled frame's four records
    got = _read("k1_sweep_roofline", _ctx(work={1: work[1]}))
    assert got == pytest.approx(100 * peaks.least_seconds(
        0.7e9 * 8, 24883200) / (48 * US))
    # records that do not pair up with the frames' samples
    assert _read("k1_sweep_roofline", _ctx(work={0: _work(1e9, 2)})) is None
    assert _read("k1_sweep_roofline", _ctx(frames=[0], work=work)) is None


def test_batch_post_and_param_uploads_by_hand():
    # batch.post's self time leaves out the nested 5 us
    post = (20 - 5) + 25
    assert _read("batch_post_ms_per_frame", _ctx()) == pytest.approx(
        post / 2 * 1e-3)
    work = {0: _work(1e9), 1: _work(1e9)}
    assert _read("param_uploads_per_frame", _ctx(work=work)) == 2.0
    assert _read("param_uploads_per_frame",
                 _ctx(work={0: _work(1e9, uploads=0.0)})) == 0.0


@pytest.mark.parametrize("name", ["k1_sweep_roofline",
                                  "batch_post_ms_per_frame",
                                  "param_uploads_per_frame"])
def test_nothing_to_read_gives_none(name):
    ctx = _ctx(work={0: _work(1e9, uploads=None)})
    assert _read(name, dict(ctx, trace=None)) is None
    if name == "batch_post_ms_per_frame":
        # a program that opens no batch.post (the parent of the span)
        spans = [s for s in SPANS if s[0] != "batch.post"]
        assert _read(name, _ctx(spans=spans)) is None
    if name == "param_uploads_per_frame":
        # a program without the counter
        assert _read(name, ctx) is None
        assert _read(name, dict(ctx, work={})) is None


@pytest.mark.cuda
def test_control_fails_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    r = run_control(spec.load_cell(SWEEP), 34, "cuda:0")
    assert set(r["fails"]) == {"lsb_max", "off_share"}, r["checks"]


def test_reference_bucket_is_the_programs():
    from fractalrenderer_tpu_torch.models import common

    for n in (1, 255, 256, 300, 1024, 1025, 5000, 1 << 25):
        assert plain_julia.iter_bucket(n) == common._iter_bucket(n)
