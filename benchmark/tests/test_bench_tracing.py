"""The frozen trace arithmetic and the per-layer readers on a synthetic
trace: the idle share, sums by name pattern, the roofline shares by hand,
and a lost device record flagged."""
import pytest

import small_cells  # noqa: F401  (puts the repository on sys.path)
from benchmark.harness import peaks, tracing
from benchmark.harness.spec import load_module

K1 = "void escape_kernel<0, true, false>(Params, ColorTable, int)"
K2 = "void dd_escape_kernel<true>(DDParams, int)"
K3 = "void pert_kernel<0, 1, 0>(PertParams, PertArgs)"
GLUE = "void at::native::vectorized_elementwise_kernel<4, add>(int)"


def _x(name, cat, ts_us, dur_us, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts_us, "dur": dur_us,
         "pid": 0, "tid": 0}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic(kernels, lose=None, extra_spans=()):
    """A trace of ``kernels`` [(name, start us, dur us)], each launched by
    a cudaLaunchKernel of its own correlation id, inside a 'stretch'
    annotation from 0 to 1000 us."""
    ev = [_x("stretch", "user_annotation", 0, 1000)]
    ev += [_x(n, "user_annotation", a, d) for n, a, d in extra_spans]
    for i, (name, ts, dur) in enumerate(kernels):
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", ts - 5, 3, i))
        if i != lose:
            ev.append(_x(name, "kernel", ts, dur, i))
    return {"traceEvents": ev}


LAYOUT = [(K1, 100, 50), (GLUE, 150, 25), (K1, 300, 100), (GLUE, 400, 25),
          (GLUE, 410, 40)]


def test_busy_window_and_idle_share():
    tr = tracing.parse_trace(synthetic(LAYOUT))
    busy, window = tracing.busy_and_window(tr.events)
    # union: 100-175 and 300-450 (the two glue records overlap 410-425)
    assert busy == pytest.approx(225e-6)
    assert window == pytest.approx(350e-6)
    ctx = {"trace": tr, "span": (0.0, 1000e-6)}
    idle = load_module("metrics", "device_idle_share").read(ctx)
    assert idle == pytest.approx(100 * (1 - 225 / 1000))


def test_sums_by_name_pattern():
    tr = tracing.parse_trace(synthetic(LAYOUT + [(K2, 500, 10),
                                                 (K3, 600, 70)]))
    k1 = tracing.kernel_records(tr.events, r"(?<!dd_)escape_kernel")
    assert [d for _, d in k1] == pytest.approx([50e-6, 100e-6])
    k3 = tracing.kernel_records(tr.events, r"pert_kernel")
    assert [d for _, d in k3] == pytest.approx([70e-6])
    by = dict(tracing.seconds_by_name(tr.events))
    assert by[GLUE] == pytest.approx(90e-6)
    ctx = {"trace": tr, "span": (0.0, 1000e-6), "stretch_frames": [0, 1]}
    glue = load_module("metrics", "glue_ms_per_frame").read(ctx)
    # every record but K1's and K3's, K2's among them, per frame
    assert glue == pytest.approx(1e3 * (90e-6 + 10e-6) / 2)


def test_lost_device_record_is_flagged():
    with pytest.raises(tracing.LostRecords):
        tracing.parse_trace(synthetic(LAYOUT, lose=2))
    with pytest.raises(tracing.LostRecords):
        tracing.parse_trace({"traceEvents": [
            _x("cudaLaunchKernel", "cuda_runtime", 0, 1, 0)]})


def test_idle_gaps_are_labelled_by_the_open_span():
    tr = tracing.parse_trace(synthetic(
        LAYOUT, extra_spans=[("dispatch", 180, 100), ("wait", 460, 500)]))
    gaps = tracing.idle_gaps(tr.events, tr.spans, 0.0, 1000e-6)
    assert gaps[0] == ("wait", pytest.approx(550e-6))
    assert ("dispatch", pytest.approx(125e-6)) in gaps
    assert ("stretch", pytest.approx(100e-6)) in gaps  # before the first


def test_k1_roofline_by_hand():
    tr = tracing.parse_trace(synthetic(LAYOUT))
    work = {7: {"updates": 1_000_000, "bytes": 6_220_800},
            9: {"updates": 50_000_000, "bytes": 6_220_800}}
    ctx = {"trace": tr, "span": (0.0, 1000e-6), "stretch_frames": [7, 9],
           "work": work}
    got = load_module("metrics", "k1_roofline").read(ctx)
    least = (max(8e6 / 67e12, 6_220_800 / 3.35e12)
             + max(400e6 / 67e12, 6_220_800 / 3.35e12))
    assert got == pytest.approx(100 * least / 150e-6)
    # a frame without a work count is left out, with its record
    ctx["work"] = {9: work[9]}
    got = load_module("metrics", "k1_roofline").read(ctx)
    assert got == pytest.approx(100 * max(400e6 / 67e12, 6_220_800
                                          / 3.35e12) / 100e-6)
    # records that do not match the frames one for one give nothing
    ctx["stretch_frames"] = [7]
    assert load_module("metrics", "k1_roofline").read(ctx) is None
    ctx["trace"] = None
    assert load_module("metrics", "k1_roofline").read(ctx) is None


def test_k3_roofline_by_hand():
    tr = tracing.parse_trace(synthetic([(K3, 100, 400), (GLUE, 500, 10)]))
    ctx = {"trace": tr, "span": (0.0, 1000e-6), "stretch_frames": [3],
           "work": {3: {"steps": 2e8, "bytes": 100}}}
    got = load_module("metrics", "k3_roofline").read(ctx)
    assert got == pytest.approx(100 * 2e8 * 165 / 67e12 / 400e-6)
    assert peaks.least_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_dispatch_per_frame():
    m = load_module("metrics", "dispatch_ms_per_frame")
    assert m.read({"dispatch_s": 0.5, "dispatch_frames": 2000}) \
        == pytest.approx(0.25)
    assert m.read({"dispatch_s": 0.0, "dispatch_frames": 0}) is None
