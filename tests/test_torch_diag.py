"""The port's diagnostics (fractalrenderer_tpu_torch/utils/diag.py) on the
CPU: the parameter-layout selfcheck against the CUDA sources, the plain
versions of kernels K5 (the FP32 peak probe) and K6 (the fresh-compile
probe) against the JAX package's Pallas bodies in interpret mode, and the
profiler's device-seconds reader.  The kernels themselves run in
test_torch_cuda.py on the card."""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fractalrenderer_tpu_torch.ops import _cuda, dd_escape, escape, \
    perturbation
from fractalrenderer_tpu_torch.utils import diag


# -- params_layout_selfcheck ---------------------------------------------

def test_params_layout_selfcheck_passes():
    assert diag.params_layout_selfcheck() is True


def test_selfcheck_catches_a_reordered_trip_field(monkeypatch):
    # K1's and K2's counters share one layout, held against the CUDA enum
    fields = list(escape.TRIP_FIELDS)
    fields[0], fields[1] = fields[1], fields[0]
    monkeypatch.setattr(escape, "TRIP_FIELDS", tuple(fields))
    with pytest.raises(AssertionError, match="warp_counters.cuh"):
        diag.params_layout_selfcheck()


@pytest.mark.parametrize("module,a,b,where", [
    (escape, "P_CX", "P_CY", "escape.cu"),
    (escape, "P_BRIGHT", "P_SAT", "escape.cu"),
    (dd_escape, "D_CXH", "D_CXL", "dd_escape.cu"),
    (perturbation, "Q_AR", "Q_AI", "pert_kernel.cuh"),
], ids=["escape_cx_cy", "escape_bright_sat", "dd_cx", "pert_ar_ai"])
def test_selfcheck_catches_a_swapped_python_constant(monkeypatch, module, a,
                                                     b, where):
    # the swap keeps the Python indices dense, so only the CUDA half sees it
    va, vb = getattr(module, a), getattr(module, b)
    monkeypatch.setattr(module, a, vb)
    monkeypatch.setattr(module, b, va)
    with pytest.raises(AssertionError, match=where):
        diag.params_layout_selfcheck()


@pytest.mark.parametrize("src,old,new", [
    ("pert_kernel.cuh", "Q_AR, Q_AI,", "Q_AI, Q_AR,"),
    ("escape.cu", "P_STRIPE = 18", "P_STRIPE = 11"),
    ("dd_escape.cu", "kND = 11", "kND = 12"),
    ("warp_counters.cuh", "T_PIXELS, T_LOOPED,", "T_LOOPED, T_PIXELS,"),
    ("warp_counters.cuh", "kTripFields = 13", "kTripFields = 14"),
    ("escape.cu", '#include "warp_counters.cuh"', '#include "dd.cuh"'),
    ("dd_escape.cu", '#include "warp_counters.cuh"', ""),
], ids=["enum_order", "escape_value", "dd_count", "trips_order",
        "trips_count", "escape_counters", "dd_counters"])
def test_selfcheck_catches_an_edited_cuda_source(tmp_path, monkeypatch, src,
                                                 old, new):
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC_DIR, csrc)
    text = (csrc / src).read_text()
    assert old in text
    (csrc / src).write_text(text.replace(old, new, 1))
    monkeypatch.setattr(_cuda, "CSRC_DIR", str(csrc))
    with pytest.raises(AssertionError, match=src):
        diag.params_layout_selfcheck()


# -- K5: the FP32 peak probe ----------------------------------------------

def _jax_peak(x: np.ndarray, chains: int, k: int) -> np.ndarray:
    """The JAX probe's kernel body (fractalrenderer_tpu/utils/diag.py
    measure_vpu_peak), with its 256 x 128 VMEM BlockSpec, in interpret
    mode."""
    th, tw = 256, 128
    gh, gw = x.shape[0] // th, x.shape[1] // tw

    def kernel(x_ref, o_ref):
        a = x_ref[:, :]
        accs = tuple(a + jnp.float32(i) for i in range(chains))

        def body(_, accs):
            return tuple(acc * jnp.float32(1.000001) + jnp.float32(0.5)
                         for acc in accs)

        accs = jax.lax.fori_loop(0, k, body, accs)
        s = accs[0]
        for acc in accs[1:]:
            s = s + acc
        o_ref[:, :] = s

    spec = pl.BlockSpec((th, tw), lambda i, j: (i, j),
                        memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        kernel, grid=(gh, gw), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(jnp.asarray(x))
    return np.asarray(out)


def _numpy_peak(x: np.ndarray, chains: int, k: int) -> np.ndarray:
    """The recurrence in numpy: each step in float64, rounded to f32."""
    m = np.float64(np.float32(1.000001))
    accs = [x + np.float32(i) for i in range(chains)]
    for _ in range(k):
        accs = [(a.astype(np.float64) * m + 0.5).astype(np.float32)
                for a in accs]
    s = accs[0]
    for a in accs[1:]:
        s = s + a
    return s


def test_fma_chains_plain_against_jax_interpret():
    # chains 8, k 50 on a 2 x 2 grid of the JAX probe's 256 x 128 tiles;
    # XLA:CPU may contract acc * m + 0.5 into an FMA or not, so 1e-5
    x = np.ones((512, 256), np.float32)
    want = _jax_peak(x, 8, 50)
    got = diag.fma_chains_plain(torch.from_numpy(x), 8, 50).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("chains", diag.PEAK_CHAINS)
def test_fma_chains_plain_bit_equal_to_float64_recurrence(chains):
    x = np.random.default_rng(chains).uniform(0.5, 8.0, (64, 96))
    x = x.astype(np.float32)
    got = diag.fma_chains_plain(torch.from_numpy(x), chains, 50).numpy()
    want = _numpy_peak(x, chains, 50)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_fma_chains_step_is_a_fused_multiply_add():
    # one step from acc is acc * m + 0.5 rounded once; the unfused f32
    # product-then-sum rounds twice and differs on some of these inputs
    from fractions import Fraction

    x = np.random.default_rng(7).uniform(0.5, 4.0, 4096).astype(np.float32)
    got = diag.fma_chains_plain(torch.from_numpy(x), 1, 1).numpy()
    m = Fraction(float(np.float32(1.000001)))
    for xi, gi in zip(x[:64], got[:64]):
        exact = Fraction(float(xi)) * m + Fraction(1, 2)
        # the nearest f32 to the exact value: no f32 is closer than gi
        lo = np.nextafter(gi, np.float32(0))
        hi = np.nextafter(gi, np.float32(np.inf))
        err = abs(Fraction(float(gi)) - exact)
        assert err <= abs(Fraction(float(lo)) - exact)
        assert err <= abs(Fraction(float(hi)) - exact)
    unfused = x * np.float32(1.000001) + np.float32(0.5)
    assert (unfused != got).any()


def test_fma_chains_dispatch_and_refusals():
    x = torch.ones((16, 8))
    before = diag.fma_chains_cuda.launches
    assert torch.equal(diag.fma_chains(x, 2, 3),
                       diag.fma_chains_plain(x, 2, 3))
    with pytest.raises(ValueError, match="chains"):
        diag.fma_chains_plain(x, 3, 3)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        diag.fma_chains_cuda(x, 8, 3)
    assert diag.fma_chains_cuda.launches == before


def test_measure_vpu_peak_keys(monkeypatch):
    # the shape cut so the plain version is quick; a CPU number, no peak
    monkeypatch.setattr(diag, "PEAK_SHAPE", (32, 16))
    out = diag.measure_vpu_peak(chains=2, k=4, device="cpu")
    assert set(out) == {"seconds", "gflops_f32"}
    assert out["seconds"] > 0 and out["gflops_f32"] > 0


# -- K6: the fresh-compile probe ------------------------------------------

def _jax_probe(x: np.ndarray, salt: float) -> np.ndarray:
    """The JAX probe's kernel body (bench_all.py bench_cold_start), two
    (8, 128) VMEM blocks, in interpret mode."""
    def kernel(x_ref, o_ref):
        o_ref[:, :] = x_ref[:, :] * jnp.float32(salt) + 1.0

    spec = pl.BlockSpec((8, 128), lambda i: (i, 0), memory_space=pltpu.VMEM)
    return np.asarray(pl.pallas_call(
        kernel, grid=(2,), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((16, 128), jnp.float32),
        interpret=True)(jnp.asarray(x)))


@pytest.mark.parametrize("salt", [0.0, 12345.0, float(2 ** 24 - 1)])
def test_compile_probe_plain_bit_equal_to_jax_interpret(salt):
    x = np.ones((16, 128), np.float32)
    got = _cuda.compile_probe_plain(torch.from_numpy(x), salt).numpy()
    np.testing.assert_array_equal(got, _jax_probe(x, salt))
    np.testing.assert_array_equal(got, np.float32(salt) + np.float32(1))


def test_compile_probe_source_stays_out_of_the_library():
    assert os.path.isfile(_cuda.PROBE_SRC)
    assert _cuda.PROBE_SRC not in _cuda.sources()
    assert "FR_PROBE_SALT" in open(_cuda.PROBE_SRC).read()


def test_compile_probe_needs_a_card_and_nvcc(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="needs a CUDA device"):
        _cuda.compile_probe("cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        _cuda.compile_probe_cuda(None, torch.ones((16, 128)))
    before = _cuda.compile_probe_cuda.launches
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _cuda.compile_probe("cuda")
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("FRACTAL_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.build_compile_probe(1.0)
    assert not (tmp_path / "build").exists()
    assert _cuda.compile_probe_cuda.launches == before


def test_build_dir_is_read_at_call_time(tmp_path, monkeypatch):
    monkeypatch.delenv("FRACTAL_TORCH_BUILD_DIR", raising=False)
    default = _cuda.library_path()
    assert os.path.dirname(default) == _cuda.BUILD_DIR
    monkeypatch.setenv("FRACTAL_TORCH_BUILD_DIR", str(tmp_path))
    assert _cuda.build_dir() == str(tmp_path)
    moved = _cuda.library_path()
    assert os.path.dirname(moved) == str(tmp_path)
    assert os.path.basename(moved) == os.path.basename(default)


# -- device seconds from a trace -------------------------------------------

def _write_trace(path, events):
    with open(path, "w") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)


def _x(cat, ts, dur, pid, tid=7, device=None, name="k", corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
         "ts": ts, "dur": dur, "args": {}}
    if device is not None:
        e["args"]["device"] = device
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def test_device_seconds_busiest_device(tmp_path):
    events = [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": "GPU 0"}},
        _x("kernel", 100, 300, 0, device=0),
        _x("kernel", 500, 200, 0, device=0),
        _x("gpu_memcpy", 800, 50, 0, device=0),
        _x("gpu_memset", 900, 10, 0, device=0),
        _x("kernel", 100, 400, 1, device=1),
        _x("gpu_memcpy", 600, 100, 1, device=1),
        # host events never count on a device lane
        _x("cpu_op", 0, 5000, 4242, tid=4242),
        _x("cuda_runtime", 90, 20, 4242, tid=4242),
    ]
    _write_trace(tmp_path / "a.pt.trace.json", events)
    total = diag.device_seconds_from_trace(str(tmp_path))
    kernels = diag.device_seconds_from_trace(str(tmp_path), lane="kernel")
    assert total == pytest.approx(560e-6)  # device 0: 300+200+50+10
    assert kernels == pytest.approx(500e-6)  # device 0 or 1: 500, 400
    assert kernels <= total


def test_device_seconds_reads_the_newest_trace(tmp_path):
    _write_trace(tmp_path / "old.pt.trace.json",
                 [_x("kernel", 0, 999, 0, device=0)])
    os.utime(tmp_path / "old.pt.trace.json", (1, 1))
    sub = tmp_path / "run2"
    sub.mkdir()
    _write_trace(sub / "new.pt.trace.json", [_x("kernel", 0, 5, 0, device=0)])
    assert diag.device_seconds_from_trace(str(tmp_path)) == \
        pytest.approx(5e-6)


def test_device_seconds_cpu_fallback_counts_top_level_ops(tmp_path):
    events = [_x("cpu_op", 0, 100, 1, tid=1), _x("cpu_op", 10, 50, 1, tid=1),
              _x("cpu_op", 200, 30, 1, tid=1), _x("cpu_op", 0, 40, 1, tid=2)]
    _write_trace(tmp_path / "c.pt.trace.json", events)
    assert diag.device_seconds_from_trace(str(tmp_path), device="cpu") == \
        pytest.approx(170e-6)
    # a card's run never falls back to host time
    with pytest.raises(diag.NoDeviceEvents):
        diag.device_seconds_from_trace(str(tmp_path))


def test_device_seconds_refusals(tmp_path):
    with pytest.raises(FileNotFoundError):
        diag.device_seconds_from_trace(str(tmp_path))
    _write_trace(tmp_path / "e.pt.trace.json", [])
    with pytest.raises(ValueError, match="nothing executed"):
        diag.device_seconds_from_trace(str(tmp_path), device="cpu")
    with pytest.raises(diag.NoDeviceEvents):
        diag.device_seconds_from_trace(str(tmp_path))
    with pytest.raises(ValueError, match="lane"):
        diag.device_seconds_from_trace(str(tmp_path), lane="XLA Ops")
    _write_trace(tmp_path / "e.pt.trace.json",
                 [_x("cuda_runtime", 0, 5, 9, tid=9),
                  _x("cpu_op", 0, 50, 9, tid=9)])
    with pytest.raises(diag.NoDeviceEvents):
        diag.device_seconds_from_trace(str(tmp_path))
    # a CPU run reads its operators whatever else the trace holds
    assert diag.device_seconds_from_trace(str(tmp_path), device="cpu") == \
        pytest.approx(50e-6)


def _launches(records):
    """A card's trace: one cudaLaunchKernel and one cudaMemcpyAsync on the
    host per (kernel, copy) pair, each device record sharing its launch's
    correlation id; ``records`` picks the device records kept."""
    host = [_x("cuda_runtime", 10 * i, 5, 9, tid=9, name=n, corr=c)
            for i, (n, c) in enumerate([("cudaLaunchKernel", 1),
                                        ("cudaMemcpyAsync", 2),
                                        ("cudaLaunchKernel", 3),
                                        ("cudaStreamSynchronize", 4)])]
    dev = {1: _x("kernel", 100, 300, 0, device=0, name="a", corr=1),
           2: _x("gpu_memcpy", 400, 20, 0, device=0, name="m", corr=2),
           3: _x("kernel", 500, 100, 0, device=0, name="a", corr=3)}
    return host + [dev[c] for c in records]


def test_device_seconds_refuses_a_trace_that_lost_part_of_the_run(tmp_path):
    _write_trace(tmp_path / "l.pt.trace.json", _launches([1, 2, 3]))
    assert diag.device_seconds_from_trace(str(tmp_path)) == \
        pytest.approx(420e-6)
    for kept in ([1, 2], [1, 3], [2, 3]):
        _write_trace(tmp_path / "l.pt.trace.json", _launches(kept))
        with pytest.raises(diag.NoDeviceEvents, match="1 of 3"):
            diag.device_seconds_from_trace(str(tmp_path))
        with pytest.raises(diag.NoDeviceEvents, match="1 of 3"):
            diag.device_seconds_from_trace(str(tmp_path), lane="kernel")


def test_kernel_seconds_from_trace_by_name(tmp_path):
    events = _launches([1, 2, 3]) + [
        _x("cuda_runtime", 50, 5, 9, tid=9, name="cudaLaunchKernel",
           corr=5),
        _x("kernel", 700, 50, 0, device=0, name="b", corr=5)]
    _write_trace(tmp_path / "k.pt.trace.json", events)
    assert diag.kernel_seconds_from_trace(str(tmp_path)) == {
        "a": [2, pytest.approx(400e-6)], "b": [1, pytest.approx(50e-6)]}
    _write_trace(tmp_path / "k.pt.trace.json", _launches([1, 2]))
    with pytest.raises(diag.NoDeviceEvents):
        diag.kernel_seconds_from_trace(str(tmp_path))


def test_kernel_records_from_trace_in_launch_order(tmp_path):
    # the records are written out of order; they come back by start time,
    # copies left out
    events = _launches([3, 2, 1]) + [
        _x("cuda_runtime", 50, 5, 9, tid=9, name="cudaLaunchKernel",
           corr=5),
        _x("kernel", 50, 7, 0, device=0, name="b", corr=5)]
    _write_trace(tmp_path / "k.pt.trace.json", events)
    assert diag.kernel_records_from_trace(str(tmp_path)) == [
        ("b", pytest.approx(7e-6)), ("a", pytest.approx(300e-6)),
        ("a", pytest.approx(100e-6))]
    _write_trace(tmp_path / "k.pt.trace.json", _launches([1, 3]))
    with pytest.raises(diag.NoDeviceEvents):
        diag.kernel_records_from_trace(str(tmp_path))


def test_device_events_from_trace_in_order_with_copies(tmp_path):
    _write_trace(tmp_path / "d.pt.trace.json", _launches([3, 2, 1]))
    assert diag.device_events_from_trace(str(tmp_path)) == [
        ("a", "kernel", pytest.approx(100e-6), pytest.approx(300e-6)),
        ("m", "gpu_memcpy", pytest.approx(400e-6), pytest.approx(20e-6)),
        ("a", "kernel", pytest.approx(500e-6), pytest.approx(100e-6))]
    _write_trace(tmp_path / "d.pt.trace.json", _launches([2, 3]))
    with pytest.raises(diag.NoDeviceEvents):
        diag.device_events_from_trace(str(tmp_path))


@pytest.mark.parametrize("events,busy,window", [
    ([], 0.0, 0.0),
    ([("a", "kernel", 1.0, 0.5)], 0.5, 0.5),
    # a gap: idle share 1 - 0.4 / 1.0
    ([("a", "kernel", 0.0, 0.2), ("b", "kernel", 0.8, 0.2)], 0.4, 1.0),
    # overlapping and nested events count their union once, in any order
    ([("c", "gpu_memcpy", 0.5, 0.1), ("a", "kernel", 0.0, 0.4),
      ("b", "kernel", 0.3, 0.3), ("d", "kernel", 0.35, 0.05)], 0.6, 0.6),
], ids=["none", "one", "gap", "overlap"])
def test_busy_and_window(events, busy, window):
    b, w = diag.busy_and_window(events)
    assert b == pytest.approx(busy) and w == pytest.approx(window)


def test_measure_device_seconds_of_a_cpu_op(tmp_path):
    x = torch.ones((256, 256))
    s = diag.measure_device_seconds(lambda: (x @ x).sum(), device="cpu")
    assert s > 0
    s2 = diag.measure_device_seconds(lambda: (x @ x).sum(), str(tmp_path),
                                     device="cpu")
    assert s2 > 0 and list(tmp_path.glob("*.pt.trace.json"))


def test_trace_without_a_directory_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with diag.trace(None):
        torch.ones(4).sum()
    assert not list(tmp_path.iterdir())


def test_link_bandwidth_needs_a_card():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        diag.measure_link_bandwidth(mb=1, reps=1, device="cpu")


def test_measure_device_seconds_takes_a_trace_again_without_device_events(
        monkeypatch):
    calls, runs = [], []

    def flaky(d, device):
        assert device == "cpu"
        calls.append(d)
        if len(calls) < 3:
            raise diag.NoDeviceEvents("no kernel in the trace")
        return 0.25

    pads = []
    real_trace = diag.trace

    def trace(d, pad_s, device):
        pads.append(pad_s)
        return real_trace(d, pad_s, device)

    monkeypatch.setattr(diag, "device_seconds_from_trace", flaky)
    monkeypatch.setattr(diag, "trace", trace)
    before = diag.measure_device_seconds.retries
    assert diag.measure_device_seconds(lambda: runs.append(1),
                                       device="cpu") == 0.25
    assert len(runs) == 3 and diag.measure_device_seconds.retries == before + 2
    # each attempt pads its session longer than the one before
    assert pads == list(diag.TRACE_PADS_S) and pads == sorted(set(pads))

    def never(d, device):
        raise diag.NoDeviceEvents("no kernel in the trace")

    monkeypatch.setattr(diag, "device_seconds_from_trace", never)
    monkeypatch.setattr(diag, "TRACE_PADS_S", (0.0, 0.0))
    with pytest.raises(diag.NoDeviceEvents):
        diag.measure_device_seconds(lambda: runs.append(1), device="cpu")
    assert len(runs) == 5
