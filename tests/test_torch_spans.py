"""The program's stage spans (``utils.diag.span``) and counters in the
export paths: the batch path (``models/common.batch_render_fn``, with
``batch.post`` and ``band_render_fn.param_uploads`` in its multi-sample
and unfused frames), the
deep zoom (``models/deep_zoom.render``) and the Mandelbulb
(``models/mandelbulb.render``).

On the CPU: each frame's stages come out as ``user_annotation`` events of a
profiler session, nested under the frame's span in the order they run;
the rendered bytes do not depend on a session; ``render.frames`` counts
frames; the ``animate`` and ``zoom-path`` verbs write a trace with the
spans under ``--profile``.  On the card (``cuda``): the wrappers' own
spans (``k1.launch``, ``k3.launch``, ``deep.upload`` and their part of
``k1.prepare`` and ``k3.prepare``) and ``upload_bytes``.  The card's tests
import no JAX, so they run there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py -q
"""
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fractalrenderer_tpu_torch import FractalType, Scene, cli
from fractalrenderer_tpu_torch.models import common, deep_zoom, mandelbulb
from fractalrenderer_tpu_torch.ops import bulb_kernel, perturbation
from fractalrenderer_tpu_torch.utils import diag

BENIGN = ("0.245670923653024", "0.580340963154017")
FRAMES = ("batch.frame", "deep.frame", "bulb.frame")
# a CPU bulb frame's stages: the camera and the glue's vector, the ray grid,
# the march vector, K4a, K4b, the shading, then the AA sum, the post chain
# and the quantize
BULB_STAGES = ["bulb.prepare", "bulb.prepare", "k4b.launch", "k4a.launch",
               "k4b.launch", "bulb.shade", "bulb.post", "bulb.post",
               "bulb.post"]


def _spans(prof, tmp_path):
    """The session's annotations (name, start, end), sorted by start, the
    enclosing one first."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return _annotations(json.loads(path.read_text()))


def _annotations(raw):
    ev = [e for e in raw["traceEvents"]
          if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in ev),
                  key=lambda s: (s[1], -s[2]))


def _inside(s, t):
    return t is not s and s[1] <= t[1] and t[2] <= s[2]


def _children(spans, parent):
    """The names of the spans nested directly in ``parent``, in order."""
    inner = [t for t in spans if _inside(parent, t)]
    return [t[0] for t in inner
            if not any(_inside(u, t) for u in inner)]


def _top(spans):
    """The names of the spans nested in no other, in order."""
    return [t[0] for t in spans if not any(_inside(u, t) for u in spans)]


def _frames(spans, frame):
    """The frame spans, after checking that every stage lies in one but
    the batch path's chunk-level k1.prepare (the parameter columns)."""
    chunk = ["k1.prepare"] if frame == "batch.frame" else []
    assert _top(spans) == chunk + [frame] * _top(spans).count(frame)
    return [s for s in spans if s[0] == frame]


def _batch(quantize, planar, device="cpu", frames=2):
    s = Scene(max_iterations=48)
    cfg = common.scene_static_cfg(s, 32, 24, "mandelbrot", "centered",
                                  False, device=str(device))
    dyn = common.scene_dyn_params(s)
    zooms = np.linspace(3.0, 1.5, frames)
    batch = {k: np.asarray([v] * frames, np.float32) for k, v in dyn.items()}
    batch["zoom"] = zooms.astype(np.float32)
    return common.batch_render_fn(cfg, quantize=quantize, planar=planar), \
        batch


def _deep_scene(zoom="1e-9", iters=300, **kw):
    return Scene(fractal_type=FractalType.DEEP_ZOOM, hp_center_x=BENIGN[0],
                 hp_center_y=BENIGN[1], hp_zoom=zoom, max_iterations=iters,
                 use_perturbation=True, **kw)


def _deep_frames(device="cpu", n=2, **kw):
    cache = {}
    return [deep_zoom.render(_deep_scene(z), 24, 16, orbit_cache=cache,
                             quantize=8, device=device, **kw)
            for z in ("1e-9", "5e-10")[:n]]


def _bulb_frames(device="cpu", times=(1.3, 0.0)):
    """Bulb frames at the trig instance's time and at t = 0 (the integer
    power's)."""
    return [mandelbulb.render(Scene(fractal_type=FractalType.MANDELBULB,
                                    max_iterations=16, time=t), 24, 16,
                              device=device, quantize=8) for t in times]


@pytest.mark.parametrize("quantize,planar,stages", [
    (8, True, ["k1.prepare", "k1.prepare", "batch.glue"]),
    (8, False, ["k1.prepare", "k1.prepare", "batch.glue", "batch.glue"]),
    (0, False, ["k1.prepare", "k1.prepare", "batch.glue"]),
], ids=["planar_u8", "interleaved_u8", "f32"])
def test_batch_frames_nest_their_stages(tmp_path, quantize, planar, stages):
    fn, batch = _batch(quantize, planar)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(batch)
    spans = _spans(prof, tmp_path)
    frames = _frames(spans, "batch.frame")
    assert len(frames) == 2
    for f in frames:
        assert _children(spans, f) == stages


def _batch_of(scene, device="cpu", frames=2):
    """A batch of ``frames`` frames of ``scene``'s static configuration
    (its family's fused or unfused branch, its AA) at 32 x 24."""
    fam, conv, clamp = common.family_map()[scene.fractal_type]
    cfg = common.scene_static_cfg(scene, 32, 24, fam, conv, clamp,
                                  device=str(device))
    dyn = common.scene_dyn_params(scene)
    batch = {k: np.asarray([v] * frames, np.float32) for k, v in dyn.items()}
    batch["zoom"] = np.linspace(3.0, 1.5, frames).astype(np.float32)
    return common.batch_render_fn(cfg), batch


# a fused multi-sample frame (Julia at 2x2 AA), an unfused one (the
# Mandelbrot orbit trap) and fused single-sample ones: the spans
# batch.post opens in each frame, and the host-scalar copies a frame adds
# to band_render_fn.param_uploads
POST_CASES = {
    "julia_aa2": (dict(fractal_type=FractalType.JULIA,
                       antialiasing_samples=2), 1, 2),
    "unfused": (dict(orbit_trap_enabled=True), 1, 3),
    "unfused_aa2": (dict(orbit_trap_enabled=True,
                         antialiasing_samples=2), 1, 3),
    "julia_aa1": (dict(fractal_type=FractalType.JULIA), 0, 0),
    "mandelbrot_aa1": ({}, 0, 0),
}


@pytest.mark.parametrize("case", list(POST_CASES))
def test_batch_post_opens_in_multi_sample_and_unfused_frames(tmp_path,
                                                             case):
    kw, posts, _ = POST_CASES[case]
    fn, batch = _batch_of(Scene(max_iterations=48, **kw))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(batch)
    spans = _spans(prof, tmp_path)
    frames = _frames(spans, "batch.frame")
    assert len(frames) == 2
    for f in frames:
        kids = _children(spans, f)
        assert kids.count("batch.post") == posts
        if posts:  # the frame's last stage, after every sample
            assert kids[-1] == "batch.post"


@pytest.mark.parametrize("case", list(POST_CASES))
def test_param_uploads_count_a_frames_scalar_copies(case):
    kw, _, per_frame = POST_CASES[case]
    fn, batch = _batch_of(Scene(max_iterations=48, **kw), frames=3)
    before = common.band_render_fn.param_uploads
    fn(batch)
    assert common.band_render_fn.param_uploads - before == 3 * per_frame


def test_planar_frames_copy_no_scalars():
    fn, batch = _batch(8, True)
    before = common.band_render_fn.param_uploads
    fn(batch)
    assert common.band_render_fn.param_uploads == before


def test_deep_frames_nest_their_stages(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _deep_frames()
    spans = _spans(prof, tmp_path)
    frames = _frames(spans, "deep.frame")
    assert len(frames) == 2
    stages = ["deep.prepare", "k3.prepare", "deep.readback",
              "deep.readback", "deep.colour", "deep.colour"]
    for f in frames:
        assert _children(spans, f) == stages
    # the orbit is computed on the first frame's cache miss only, inside
    # its preparation
    orbits = [s for s in spans if s[0] == "deep.orbit"]
    assert len(orbits) == 1
    prep = next(s for s in spans if s[0] == "deep.prepare")
    assert _inside(prep, orbits[0]) and _inside(frames[0], prep)


def test_hp_fallback_and_its_reads_are_spans(tmp_path):
    # secondary references off: every starved lane takes the HP fallback,
    # and the legacy pipeline reads the planes back to the host
    s = _deep_scene("1e-9", 400)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        *_, info = deep_zoom.render_fields(s, 32, 24, max_references=1,
                                           rebasing=False, device="cpu")
    assert info["fallback_pixels"] > 0
    names = [t[0] for t in _spans(prof, tmp_path)]
    assert names.count("deep.hp_fallback") == 1
    # the flag count, then n, zx, zy and the flags themselves
    assert names.count("deep.readback") == 5


def test_bulb_frames_nest_their_stages(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _bulb_frames()
    spans = _spans(prof, tmp_path)
    frames = _frames(spans, "bulb.frame")
    assert len(frames) == 2
    for f in frames:
        assert _children(spans, f) == BULB_STAGES


def test_bulb_spans_are_the_shared_no_op_without_a_session(monkeypatch):
    # no session records: every span is the one shared object, and the
    # frame opens no record_function
    assert all(diag.span(n) is diag._NO_SPAN
               for n in ["bulb.frame"] + BULB_STAGES)

    def no_record(name):
        raise AssertionError(f"span {name} recorded without a session")
    monkeypatch.setattr(torch.profiler, "record_function", no_record)
    _bulb_frames(times=(1.3,))


@pytest.mark.parametrize("path", ["batch", "deep", "bulb"])
def test_bytes_equal_with_a_session_on_and_off(path):
    if path == "batch":
        fn, batch = _batch(8, True)
        run = lambda: [fn(batch)]  # noqa: E731
    elif path == "bulb":
        run = _bulb_frames
    else:
        run = _deep_frames
    off = run()
    with profile(activities=[ProfilerActivity.CPU]):
        on = run()
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_render_counts_its_frames():
    before = deep_zoom.render.frames
    _deep_frames()
    assert deep_zoom.render.frames == before + 2
    # the spp^2 samples of a stacked frame are one frame
    deep_zoom.render(_deep_scene(samples_per_pixel=2), 12, 8, device="cpu")
    assert deep_zoom.render.frames == before + 3


def test_bulb_render_counts_its_frames():
    before = mandelbulb.render.frames
    _bulb_frames()
    assert mandelbulb.render.frames == before + 2
    # an f32 frame (no quantize) is a frame too
    mandelbulb.render(Scene(fractal_type=FractalType.MANDELBULB,
                            max_iterations=8), 8, 6, device="cpu")
    assert mandelbulb.render.frames == before + 3


def test_cpu_path_uploads_nothing():
    before = perturbation.perturbation_fields_cuda.upload_bytes
    _deep_frames()
    assert perturbation.perturbation_fields_cuda.upload_bytes == before


def test_upload_bytes_counts_host_arrays_and_foreign_tensors():
    dev = torch.device("cpu")
    streams = [np.zeros(16, np.float32), torch.zeros(16),
               torch.zeros(8, device="meta")]
    assert perturbation._upload_bytes(streams, dev) == 64 + 0 + 32


def _trace_file(d):
    files = [f for f in os.listdir(d) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(os.path.join(d, files[0])) as f:
        return _annotations(json.load(f))


def test_zoom_path_profile_writes_the_spans(tmp_path):
    prof = tmp_path / "prof"
    assert cli.main(["zoom-path", "--device", "cpu", "--preset-zoom",
                     "Seahorse", "--frames", "2", "--width", "24",
                     "--height", "12", "--iters", "150", "--out-dir",
                     str(tmp_path / "zp"), "--profile", str(prof)]) == 0
    names = [s[0] for s in _trace_file(prof)]
    assert names.count("deep.frame") == 2 and "deep.prepare" in names


def test_animate_profile_writes_the_spans(tmp_path):
    prof = tmp_path / "prof"
    argv = ["animate", "--device", "cpu", "--zoom-to", "0.5", "--duration",
            "3", "--fps", "1", "--width", "32", "--height", "16", "--iters",
            "16"]
    assert cli.main(argv + ["--out-dir", str(tmp_path / "a"), "--profile",
                            str(prof)]) == 0
    names = [s[0] for s in _trace_file(prof)]
    assert names.count("batch.frame") == 3 and "k1.prepare" in names
    # without the flag, no trace
    assert cli.main(argv + ["--out-dir", str(tmp_path / "b")]) == 0
    assert sorted(os.listdir(tmp_path)) == ["a", "b", "prof"]


# -- on the card ----------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_spans(run, tmp_path):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return _spans(prof, tmp_path)


@pytest.mark.cuda
def test_card_batch_frames_nest_the_wrappers_stages(tmp_path, dev):
    fn, batch = _batch(8, True, device=dev)
    fn(batch)  # build and load the library outside the session
    spans = _card_spans(lambda: fn(batch), tmp_path)
    frames = _frames(spans, "batch.frame")
    assert len(frames) == 2
    for f in frames:  # K1 stores the quantized planes: no glue
        assert _children(spans, f) == ["k1.prepare", "k1.prepare",
                                       "k1.prepare", "k1.launch"]


@pytest.mark.cuda
def test_card_multi_sample_frames_nest_the_post_stage(tmp_path, dev):
    # four K1 launches, each sample's stack and sum, then the average and
    # post chain with the frame's two synchronising scalar copies
    fn, batch = _batch_of(Scene(fractal_type=FractalType.JULIA,
                                antialiasing_samples=2, max_iterations=48),
                          device=dev)
    fn(batch)  # build and load the library outside the session
    before = common.band_render_fn.param_uploads
    spans = _card_spans(lambda: fn(batch), tmp_path)
    assert common.band_render_fn.param_uploads - before == 2 * 2
    frames = _frames(spans, "batch.frame")
    assert len(frames) == 2
    sample = ["k1.prepare", "k1.prepare", "k1.launch", "batch.glue"]
    for f in frames:
        assert _children(spans, f) == ["k1.prepare"] + sample * 4 \
            + ["batch.post"]


@pytest.mark.cuda
def test_card_deep_frames_nest_the_wrappers_stages(tmp_path, dev):
    _deep_frames(dev, n=1)
    spans = _card_spans(lambda: _deep_frames(dev), tmp_path)
    frames = _frames(spans, "deep.frame")
    assert len(frames) == 2
    for f in frames:
        assert _children(spans, f) == [
            "deep.prepare", "k3.prepare", "k3.prepare", "deep.upload",
            "k3.launch", "deep.readback", "deep.readback", "deep.colour",
            "deep.colour"]


@pytest.mark.cuda
def test_card_bulb_frames_nest_the_wrappers_stages(tmp_path, dev):
    _bulb_frames(dev, times=(1.3,))
    spans = _card_spans(lambda: _bulb_frames(dev), tmp_path)
    frames = _frames(spans, "bulb.frame")
    assert len(frames) == 2
    for f in frames:  # the camera, K4a, K4b, then K4c stores the frame
        assert _children(spans, f) == ["bulb.prepare", "k4b.launch",
                                       "k4a.launch", "k4b.launch",
                                       "bulb.shade"]


@pytest.mark.cuda
def test_card_trig_launches_count_the_trig_instance_alone(dev):
    launches = bulb_kernel.march_fields_cuda.launches
    trig = bulb_kernel.march_fields_cuda.trig_launches
    # t = 1.3: power 8.38, the trig step; t = 0: power 8, the integer one
    _bulb_frames(dev, times=(1.3, 0.0, 2.0))
    torch.cuda.synchronize()
    assert bulb_kernel.march_fields_cuda.launches == launches + 3
    assert bulb_kernel.march_fields_cuda.trig_launches == trig + 2


@pytest.mark.cuda
def test_card_upload_bytes_grow_by_the_orbit_streams(dev):
    cache = {}
    before = perturbation.perturbation_fields_cuda.upload_bytes
    deep_zoom.render(_deep_scene(), 24, 16, orbit_cache=cache, device=dev)
    # dd deltas at 1e-9: four f32 streams (re, im and their lo parts), each
    # the orbit's 301 entries padded to the 512-entry bucket, copied by the
    # orbit's first frame; the next frames read its table on the card
    streams = 4 * 512 * 4
    assert perturbation.perturbation_fields_cuda.upload_bytes \
        == before + streams
    for z in ("1e-9", "5e-10"):
        deep_zoom.render(_deep_scene(z), 24, 16, orbit_cache=cache,
                         device=dev)
    assert perturbation.perturbation_fields_cuda.upload_bytes \
        == before + streams


@pytest.mark.cuda
def test_card_bytes_equal_with_a_session_on_and_off(dev):
    fn, batch = _batch(8, True, device=dev)
    off = [fn(batch)] + _deep_frames(dev) + _bulb_frames(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = [fn(batch)] + _deep_frames(dev) + _bulb_frames(dev)
        torch.cuda.synchronize()
    for a, b in zip(on, off):
        assert torch.equal(a, b)
