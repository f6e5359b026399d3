"""The per-layer metrics that read the program's own stage spans and
counters, on synthetic traces: self times with nested children, spans
outside the stretch left out, nothing read from a program without the
spans, and the idle gaps labelled by the innermost program stage."""
import sys
import types

import pytest

import small_cells  # noqa: F401  (puts the repository on sys.path)
from benchmark.harness import spans, tracing
from benchmark.harness.spec import load_module
from test_bench_tracing import K1, K3, GLUE, synthetic

US = 1e-6

# two batch frames inside the harness's dispatch, a third past the
# stretch's end (500 us here); each frame: three k1.prepare, k1.launch,
# batch.glue; frame 0's first k1.prepare (10-70 us) holds three inner
# spans, two of them overlapping, that cover 40 us of it
BATCH_SPANS = [
    ("dispatch", 5, 400),
    ("batch.frame", 10, 190),
    ("k1.prepare", 10, 60), ("inner", 15, 20), ("inner", 30, 15),
    ("inner", 50, 10),
    ("k1.prepare", 70, 10), ("k1.prepare", 85, 10),
    ("k1.launch", 100, 20), ("batch.glue", 130, 50),
    ("batch.frame", 200, 190),
    ("k1.prepare", 200, 20), ("k1.prepare", 225, 10),
    ("k1.prepare", 240, 10), ("k1.launch", 260, 30),
    ("batch.glue", 300, 60),
    ("batch.frame", 600, 100), ("k1.prepare", 600, 50),
    ("k1.launch", 650, 20), ("batch.glue", 680, 10),
]
BATCH_KERNELS = [(K1, 125, 5), (GLUE, 185, 5), (K1, 295, 5), (GLUE, 365, 5)]

DEEP_SPANS = [
    ("dispatch", 5, 450),
    ("deep.frame", 10, 440),
    ("deep.prepare", 10, 100), ("deep.orbit", 20, 60),
    ("k3.prepare", 115, 10), ("k3.prepare", 130, 5),
    ("deep.upload", 140, 10), ("k3.launch", 155, 15),
    ("deep.readback", 175, 200), ("deep.readback", 380, 5),
    ("deep.colour", 390, 20), ("deep.colour", 415, 10),
    ("deep.frame", 700, 100), ("deep.prepare", 700, 30),
    ("deep.readback", 740, 10),
]
DEEP_KERNELS = [(K3, 172, 190), (GLUE, 395, 10)]


def _ctx(kernels, extra, frames, hi=500):
    tr = tracing.parse_trace(synthetic(kernels, extra_spans=extra))
    return {"trace": tr, "span": (0.0, hi * US), "stretch_frames": frames}


def _read(name, ctx):
    return load_module("metrics", name).read(ctx)


def test_self_time_leaves_out_nested_spans():
    tr = tracing.parse_trace(synthetic(BATCH_KERNELS,
                                       extra_spans=BATCH_SPANS))
    got = spans.self_seconds(sorted(tr.spans, key=lambda s: (s[1], -s[2])),
                             ["k1.prepare"])
    # frame 0: 60 - 40 covered + 10 + 10; frame 1: 20 + 10 + 10; frame 2:
    # 50
    assert got == pytest.approx((40 + 40 + 50) * US)
    # a span's children are not its parent: batch.frame's self time is
    # what its stages leave uncovered
    frame = spans.self_seconds(
        sorted(tr.spans, key=lambda s: (s[1], -s[2])), ["batch.frame"])
    assert frame == pytest.approx(((190 - 60 - 10 - 10 - 20 - 50)
                                   + (190 - 20 - 10 - 10 - 30 - 60)
                                   + (100 - 50 - 20 - 10)) * US)


@pytest.mark.parametrize("name,ms", [
    ("k1_prepare_ms_per_frame", (40 + 40) / 2 * 1e-3),
    ("k1_launch_ms_per_frame", (20 + 30) / 2 * 1e-3),
    ("glue_launch_ms_per_frame", (50 + 60) / 2 * 1e-3),
])
def test_batch_stage_metrics(name, ms):
    ctx = _ctx(BATCH_KERNELS, BATCH_SPANS, [0, 1])
    # the third frame starts past the stretch and is not read
    assert _read(name, ctx) == pytest.approx(ms)


def test_deep_metrics():
    ctx = _ctx(DEEP_KERNELS, DEEP_SPANS, [4])
    # deep.prepare's self time leaves out the orbit's 60 us
    host = (100 - 60) + 10 + 5 + 10 + 15 + 20 + 10
    assert _read("deep_host_ms_per_frame", ctx) == pytest.approx(
        host * 1e-3)
    assert _read("readbacks_per_frame", ctx) == 2.0
    ctx["stretch_frames"] = [4, 5]
    assert _read("readbacks_per_frame", ctx) == 1.0


@pytest.mark.parametrize("name", [
    "k1_prepare_ms_per_frame", "k1_launch_ms_per_frame",
    "glue_launch_ms_per_frame", "deep_host_ms_per_frame",
    "readbacks_per_frame"])
def test_nothing_to_read_gives_none(name):
    # a program without the spans: the harness's annotations alone
    ctx = _ctx(BATCH_KERNELS, [("dispatch", 5, 400)], [0, 1])
    assert _read(name, ctx) is None
    # no trace (the CPU, or records lost), or no frames
    assert _read(name, dict(ctx, trace=None)) is None
    full = _ctx(BATCH_KERNELS, BATCH_SPANS + DEEP_SPANS, [])
    assert _read(name, full) is None


def test_upload_kb_per_frame_reads_the_program_counters(monkeypatch):
    pert = "fractalrenderer_tpu_torch.ops.perturbation"
    deep = "fractalrenderer_tpu_torch.models.deep_zoom"

    def counted(**attrs):
        return types.SimpleNamespace(**attrs)

    monkeypatch.setitem(sys.modules, pert, types.SimpleNamespace(
        perturbation_fields_cuda=counted(upload_bytes=3 * 262144)))
    monkeypatch.setitem(sys.modules, deep, types.SimpleNamespace(
        render=counted(frames=3)))
    m = load_module("metrics", "upload_kb_per_frame")
    assert m.read({}) == pytest.approx(256.0)
    # a program without the counters, or before any frame
    monkeypatch.setitem(sys.modules, deep, types.SimpleNamespace(
        render=counted(frames=0)))
    assert m.read({}) is None
    monkeypatch.setitem(sys.modules, deep, types.SimpleNamespace(
        render=counted()))
    assert m.read({}) is None
    monkeypatch.delitem(sys.modules, pert)
    assert m.read({}) is None


def test_idle_gaps_name_the_innermost_program_stage():
    tr = tracing.parse_trace(synthetic(BATCH_KERNELS,
                                       extra_spans=BATCH_SPANS))
    gaps = dict((round(d / US), label) for label, d in tracing.idle_gaps(
        tr.events, tr.spans, 0.0, 500 * US))
    # 0-125: mid 62.5 lies in frame 0's k1.prepare, past its last inner
    # span (50-60), 130-185: batch.glue, 190-295: mid 242.5
    # in frame 1's k1.prepare, 300-365: batch.glue, 370-500: mid 435, no
    # program span (the stretch)
    assert gaps == {125: "k1.prepare", 55: "batch.glue", 105: "k1.prepare",
                    65: "batch.glue", 130: "stretch"}
