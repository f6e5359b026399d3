"""The Mandelbulb export cell (``mandelbulb_p8.orbit_export``) on the CPU:
the plain bulb reference against the port's render, the orbit path, the
cell cut to a small size through the window and the control, a
configuration the driver does not run, a planted fault, K4b's work count
and the three per-layer readers on synthetic traces."""
import os

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import small_cells  # noqa: F401  (puts the repository on sys.path)
from benchmark.control import run_control
from benchmark.harness import core, peaks, spec, tracing
from benchmark.harness.spec import load_module
from benchmark.harness.traffic import generate
from benchmark.reference import bulb
from test_bench_tracing import GLUE, synthetic

BULB = "mandelbulb_p8.orbit_export"
K4A = "void bulb_cone_kernel<0>(ConeParams, int, int, int, int, float*)"
K4B = "void bulb_march_kernel<0>(MarchParams, float const*, int, int)"
US = 1e-6


def small_bulb(**over) -> spec.Cell:
    """The bulb cell cut to the CPU: a 48 x 27 frame, 32 iterations, a
    pass of 6 frames, 2 sampled, every 4th row."""
    c = spec.load_cell(BULB)
    c.config.update(export_width=48, export_height=27, max_iterations=32)
    c.traffic.update(frames=6)
    c.checks.update(sample_frames=2, row_stride=4)
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


def _port_frame(config, time, w, h):
    from fractalrenderer_tpu_torch import models
    from fractalrenderer_tpu_torch.scene import FractalType, Scene

    s = Scene(fractal_type=FractalType.MANDELBULB,
              max_iterations=config["max_iterations"], time=time)
    return models.render(s, w, h, device="cpu", quantize=8)


# -- the reference against the port ----------------------------------------

@pytest.mark.parametrize("time,int_power", [(1.3, None), (0.0, 8)])
def test_reference_equals_the_port(time, int_power):
    # a trig-instance time and t = 0 (the integer power 8's trig-free
    # step), every row of a 64 x 36 frame at the configuration's 256
    # iterations: bit for bit (the reference repeats the program's
    # operations; the CPU's sqrt is the f64 root rounded once, as there)
    w, h = 64, 36
    c = dict(spec.load_cell(BULB).config, time=time,
             power=8.0)
    _, dyn = bulb.camera_setup({k: np.float32(c[k]) for k in (
        "camera_distance", "rotation_y", "power", "time",
        "rotation_speed")})
    assert bulb.int_power_of(dyn) == int_power
    (img, planes), = bulb.frames([c], range(h), w, h, "cpu")
    assert torch.equal(img, _port_frame(c, time, w, h))
    assert 0 < int(planes["hit"].sum()) < w * h


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 13])
def test_sampled_rows_of_several_frames_equal_the_port(seed):
    # the driver's gathered march (three frames' sampled rows in one
    # call) at 160 x 90 against each frame rendered whole
    w, h = 160, 90
    cell = small_bulb(export_width=w, export_height=h, max_iterations=64,
                      sample_frames=3, row_stride=7)
    tr, drv = _driver(cell, seed)
    ref = drv.reference_rows(tr.sample)
    for f in tr.sample:
        got = _port_frame(cell.config, tr.frames[f]["time"], w, h)
        assert torch.equal(got[drv.rows], ref[f][0])


# -- the orbit path ----------------------------------------------------------

def _dyn(time):
    c = spec.load_cell(BULB).config
    p = {k: np.float32(c[k]) for k in ("camera_distance", "rotation_y",
                                       "rotation_speed")}
    p["power"] = np.float32(c["mandelbulb_power"])
    p["time"] = np.float32(time)
    ro, power = bulb.camera_setup(p)
    return float(np.hypot(ro[0], ro[2])), power


@pytest.mark.parametrize("seed", [0, 17, 2 ** 31 + 5, 4 * 10 ** 9 + 1])
def test_orbit_path(seed):
    cell = spec.load_cell(BULB)
    tr = generate(cell.traffic, cell.config, cell.checks, seed)
    assert len(tr.frames) == 378
    times = [f["time"] for f in tr.frames]
    assert 0.0 <= times[0] < 4 * np.pi
    assert np.allclose(np.diff(times), 1 / 30)
    dist, power = zip(*(_dyn(t) for t in times))
    # every frame's dynamic power is off the integers: K4b's trig step
    assert all(bulb.int_power_of(p) is None for p in power)
    # one whole period of the distance pulse: 3 (1 +- 0.3)
    assert min(dist) < 2.1005 and max(dist) > 3.8995
    # the same seed gives the same frames and order, another seed others
    again = generate(cell.traffic, cell.config, cell.checks, seed)
    assert again.frames == tr.frames and again.order == tr.order
    other = generate(cell.traffic, cell.config, cell.checks, seed + 1)
    assert other.frames != tr.frames


# -- the small cell through the window and the control -----------------------

@pytest.mark.parametrize("seed", [3, 2 ** 31 + 70])
def test_small_cell_is_correct(seed):
    r = core.run(small_bulb(), seed, 0.05, False, device="cpu")
    assert r["correct"] is True, r["checks"]
    assert sorted(r["metrics"]) == ["frames_per_s.batch", "setup_s"]
    assert r["checks"]["lsb_max"]["value"] == 0.0
    assert r["checks"]["off_share"]["value"] == 0.0


def test_small_cell_traces():
    r = core.run(small_bulb(), 8, 0.05, True, device="cpu")
    assert r["correct"] is True
    # no card: no device records for the per-layer readers
    assert r["metrics"] == {}


@pytest.mark.parametrize("seed", [2, 2 ** 31 + 40])
def test_small_control_fails(seed):
    r = run_control(small_bulb(), seed, "cpu")
    assert set(r["fails"]) == {"lsb_max", "off_share"}, r["checks"]


def test_answer_altered_is_not_correct(monkeypatch):
    from fractalrenderer_tpu_torch import models

    render = models.render

    def altered(*a, **k):
        out = render(*a, **k).clone()
        out.view(-1)[out.numel() // 3] ^= 0x80
        return out
    monkeypatch.setattr(models, "render", altered)
    r = core.run(small_bulb(), 2 ** 31 + 21, 0.05, False, device="cpu")
    assert r["correct"] is False


@pytest.mark.parametrize("key,value", [
    ("fractal", "mandelbrot"), ("precision", "dd"), ("quantize_bits", 16),
    ("aa", 2), ("rotation_speed", 0.5), ("palette_mode", 3)],
    ids=lambda v: str(v))
def test_a_configuration_the_driver_does_not_run_is_refused(key, value):
    cell = small_bulb()
    cell.config[key] = value
    with pytest.raises(ValueError):
        core.run(cell, 1, 0.05, False, device="cpu")


def test_the_configurations_keys_are_read():
    docs = {"name", "deployment", "source", "guarantees", "assumed"}
    cell = spec.load_cell(BULB)
    src = "".join(open(os.path.join(cell.bench_dir, d, f"{m}.py")).read()
                  for d, m in (("drivers", cell.traffic["driver"]),
                               ("paths", cell.traffic["path"])))
    for key in set(cell.config) - docs:
        assert f'"{key}"' in src, key


# -- K4b's work --------------------------------------------------------------

# f32 operations as k4b_roofline counts them; a select, a compare, a
# constant and a cast count none
ONE = {"add", "sub", "mul", "div", "neg", "__radd__", "__rsub__",
       "__rmul__", "__rtruediv__", "sqrt", "pow", "sin", "cos", "abs",
       "clamp_min", "clamp_max", "maximum", "minimum"}


class _Count(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", "")
        # (the CPU's square root runs in f64, rounded once to f32)
        if isinstance(out, torch.Tensor) and out.is_floating_point():
            self.n += {"clamp": 2}.get(name, name in ONE)
        return out


def test_step_ops_count_the_plain_step():
    # one polynomial-trig DE step with its carried |z|, as the reference
    # writes it (the escape index and the orbit counter are integers)
    one = torch.full((1,), 0.7)
    orb = bulb._Orbits(one * 0.3, one * -0.2, one * 0.5)
    act = torch.ones((1,), dtype=torch.bool)
    with _Count() as c:
        orb.step(act, torch.full((1,), 8.3), 256, None)
    assert c.n == load_module("metrics", "k4b_roofline").STEP_OPS == 76


def test_k4b_work_equals_the_port_plain_stats():
    # every row sampled: the driver's steps and hits are the port's plain
    # K4b work plane and hit count over the whole frame
    from fractalrenderer_tpu_torch.ops import bulb_kernel, bulb_math

    w, h = 40, 24
    cell = small_bulb(export_width=w, export_height=h, row_stride=1)
    tr, drv = _driver(cell, 9)
    _, work = drv.check(drv.control_outputs(tr.sample))
    for f in tr.sample:
        p = bulb_math.BulbParams(max_iterations=32,
                                 time=np.float32(tr.frames[f]["time"]))
        ro, dyn = bulb_math.camera_setup(p.clamped())
        fld = bulb_kernel.march_fields(w, h, ro=ro, fov=np.float32(1.0),
                                       power=dyn, max_iter=32, shade=True,
                                       stats=True, device="cpu")
        assert work[f]["steps"] == int(fld["work"].sum())
        assert work[f]["hits"] == int(fld["hit"].sum())
        assert work[f]["bytes"] == 3 * w * h


# -- the per-layer readers ---------------------------------------------------

# two bulb frames in the stretch (to 500 us), a third past it
KERNELS = [(GLUE, 20, 10), (K4A, 40, 5), (GLUE, 46, 2), (K4B, 50, 100),
           (GLUE, 160, 30), (GLUE, 210, 10), (K4A, 230, 5), (K4B, 240, 80),
           (GLUE, 330, 20), (K4B, 600, 90)]
SPANS = [
    ("dispatch", 5, 400),
    ("bulb.frame", 10, 190),
    ("bulb.prepare", 10, 20), ("bulb.prepare", 32, 4),
    ("k4b.launch", 37, 1), ("k4a.launch", 38, 5), ("k4b.launch", 44, 6),
    ("bulb.shade", 150, 20), ("bulb.post", 171, 3), ("bulb.post", 175, 10),
    ("inner", 176, 4),
    ("bulb.frame", 205, 190),
    ("bulb.prepare", 205, 10), ("k4b.launch", 216, 1),
    ("k4a.launch", 218, 6), ("k4b.launch", 225, 9), ("bulb.shade", 300, 25),
    ("bulb.post", 330, 15),
    ("bulb.frame", 600, 100), ("bulb.prepare", 600, 50),
]


def _ctx(frames=(0, 1), spans=SPANS, work=None):
    tr = tracing.parse_trace(synthetic(KERNELS, extra_spans=spans))
    return {"trace": tr, "span": (0.0, 500 * US),
            "stretch_frames": list(frames), "work": work or {}}


def _read(name, ctx):
    return load_module("metrics", name).read(ctx)


def test_bulb_glue_and_host_metrics():
    glue = 10 + 2 + 30 + 10 + 20
    assert _read("bulb_glue_ms_per_frame", _ctx()) == pytest.approx(
        glue / 2 * 1e-3)
    # bulb.post's self time leaves out the nested 4 us
    host = (20 + 4 + 1 + 5 + 6 + 20 + 3 + 10 - 4) \
        + (10 + 1 + 6 + 9 + 25 + 15)
    assert _read("bulb_host_ms_per_frame", _ctx()) == pytest.approx(
        host / 2 * 1e-3)


def test_k4b_roofline_by_hand():
    m = load_module("metrics", "k4b_roofline")
    work = {0: {"steps": 4e6, "hits": 1e4, "bytes": 6220800},
            1: {"steps": 9e6, "hits": 3e4, "bytes": 6220800}}
    got = m.read(_ctx(work=work))
    least = sum(peaks.least_seconds(w["steps"] * 76 + w["hits"] * 228,
                                    w["bytes"]) for w in work.values())
    assert got == pytest.approx(100 * least / (180 * US))
    # a frame of the stretch not sampled: only the sampled one's record
    got = m.read(_ctx(work={1: work[1]}))
    assert got == pytest.approx(100 * peaks.least_seconds(
        9e6 * 76 + 3e4 * 228, 6220800) / (80 * US))
    # records and frames that do not pair up
    assert m.read(_ctx(frames=[0], work=work)) is None


@pytest.mark.parametrize("name", ["k4b_roofline", "bulb_glue_ms_per_frame",
                                  "bulb_host_ms_per_frame"])
def test_nothing_to_read_gives_none(name):
    ctx = _ctx(work={0: {"steps": 1.0, "hits": 0.0, "bytes": 1}})
    assert _read(name, dict(ctx, trace=None)) is None
    if name == "bulb_host_ms_per_frame":
        # a program without the bulb's spans: the harness's alone
        assert _read(name, _ctx(spans=[("dispatch", 5, 400)])) is None
        assert _read(name, dict(ctx, stretch_frames=[])) is None


@pytest.mark.cuda
def test_control_fails_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    r = run_control(spec.load_cell(BULB), 34, "cuda:0")
    assert set(r["fails"]) == {"lsb_max", "off_share"}, r["checks"]
