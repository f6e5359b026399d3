"""The port's bench entry points (fractalrenderer_tpu_torch/bench_all.py and
bench.py) on the CPU device, at small frames with the iterations cut: each
config's row carries the JAX rows' keys (bench_all.py at the repository
root), config 8 drives the live session on a pty and raises when no frame
lands, a failing config is recorded and fails the exit code, and neither
module loads JAX.
The numbers are CPU numbers; the card's come from chip_smoke.py."""
import json
import os
import subprocess
import sys

import pytest
import torch

from fractalrenderer_tpu_torch import bench, bench_all
from fractalrenderer_tpu_torch.ops import escape

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX rows' keys (bench_all.py at the repository root)
JAX_KEYS = {
    0: {"config", "first_process_s", "first_visible_frame_s",
        "preview_served_first", "cached_process_s", "cached_visible_frame_s",
        "compile_service_fresh_trivial_s", "cache_dir"},
    1: {"config", "ms_per_frame", "mpix_s", "timing_method",
        "useful_iters_per_s", "issued_iters_per_s", "issued_over_useful",
        "vpu_peak_gflops_f32"},
    2: {"config", "ms_per_batch", "mpix_s", "timing_method"},
    3: {"config", "seconds", "fps", "timing_method"},
    4: {"config", "seconds", "cold_seconds_incl_compile", "algorithm",
        "rebase_passes", "seconds_with_series_skip",
        "series_skip_iterations", "seconds_spp2_stacked",
        "spp2_vs_spp1_ratio", "references_used", "glitched_pixels_initial",
        "glitched_pixels_remaining", "device_s_series_off",
        "device_s_series_on"},
    5: {"config", "seconds", "mpix_s_end_to_end", "device_band_seconds_mean",
        "device_band_seconds_spread", "device_render_mpix_s",
        "fetch_blocked_seconds", "bytes_over_link", "png_bytes"},
    6: {"config", "seconds", "mpix_s", "timing_method"},
    7: {"config", "seconds", "precision_mode", "rebase_passes",
        "glitched_pixels_remaining"},
    8: {"config", "sixel_encode_ms", "kitty_png_encode_ms", "f32_mandelbrot",
        "deep_zoom_1e-12"},
}
SMALL = {
    1: dict(width=64, height=36, iters=64, frames=2),
    2: dict(width=32, height=18, iters=32, batches=1),
    3: dict(width=32, height=18, frames=6),
    4: dict(width=24, height=16, iters=200),
    5: dict(width=64, height=48, band_rows=16),
    6: dict(width=12, height=8, iters=8),
    7: dict(width=24, height=16, iters=100),
    8: dict(cols=12, lines=5, iters=32, keys=2, deep_iters=64,
            deep_keys=2),
}


@pytest.fixture
def one_thread_children(monkeypatch):
    # config 8's CLI children render on the CPU here: one intra-op thread
    # each keeps a loaded test host from starving their frames
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.mark.parametrize("num", sorted(SMALL))
def test_config_rows_carry_the_jax_keys(num, one_thread_children):
    row = bench_all.CONFIGS[num](device="cpu", **SMALL[num])
    assert JAX_KEYS[num] <= set(row), JAX_KEYS[num] - set(row)
    json.dumps(row)  # one JSON line
    if "timing_method" in row:
        assert row["timing_method"] == "torch_profiler"
    for key in ("ms_per_frame", "ms_per_batch", "seconds",
                "device_s_series_off"):
        if key in row:
            assert row[key] > 0, key


def test_config1_roofline_on_the_cpu():
    row = bench_all.bench_mandelbrot_1080p(device="cpu", **SMALL[1])
    # the peak is a card's number: none on the CPU, and no percentages
    assert row["vpu_peak_gflops_f32"] is None and row["reason"] == "cpu"
    assert not any(k.startswith("pct_peak") for k in row)
    # a warp issues at least what its lanes need (skipped lanes in neither)
    assert row["issued_over_useful"] >= 1


def test_config4_reports_rounds_per_pixel():
    row = bench_all.bench_deep_zoom(device="cpu", **SMALL[4])
    assert "rounds_per_tile" not in row
    rp = row["rounds_per_pixel"]
    assert set(rp) == {"mean", "p50", "p95", "max", "pixels_over_half_max",
                       "pixels"}
    assert rp["pixels"] == 24 * 16
    assert 1 <= rp["p50"] <= rp["p95"] <= rp["max"] == row["rebase_passes"]
    assert row["glitched_pixels_remaining"] == 0
    assert row["series_skip_iterations"] > 0


def test_config3_frames_are_the_jax_benchs():
    # the root bench's two keyframes and 30 fps, interpolated as the JAX
    # animation renderer does
    from fractalrenderer_tpu.anim.keyframes import (Animation,
                                                    InterpolationType,
                                                    Keyframe)
    from fractalrenderer_tpu.scene import Scene

    anim = Animation(duration=300 / 30.0, target_fps=30)
    anim.keyframes.append(Keyframe(0.0, Scene(zoom=2.5, max_iterations=256),
                                   InterpolationType.LINEAR))
    anim.keyframes.append(Keyframe(anim.duration,
                                   Scene(center_x=-0.743643887037151,
                                         center_y=0.13182590420533,
                                         zoom=0.008, max_iterations=1024),
                                   InterpolationType.LINEAR))
    mine = bench_all.animation_frames(300)
    assert len(mine) == 300
    for f, s in enumerate(mine):
        ref = anim.interpolate(anim.frame_time(f))
        assert json.loads(s.to_json()) == json.loads(ref.to_json()), f
    assert {s.max_iterations for s in mine} == {256, 640, 1024}


def test_config3_on_the_cpu_reports_the_frames_work():
    row = bench_all.bench_animation(device="cpu", **SMALL[3])
    assert row["frames"] == 6 and row["iteration_cap"] == 1024
    # records and the idle share are a card's numbers
    assert row["k1_records_ms"] is None and row["idle_share"] is None
    assert row["reason"] == "cpu"
    u = row["useful_iters"]
    assert 0 <= u["min"] <= u["p50"] <= u["max"] and u["sum"] > 0
    assert row["useful_over_main_path"] == pytest.approx(
        u["mean"] / row["main_path_useful_iters"])
    # the path crosses the main cardioid: a frame wholly inside the skip
    # loops on no pixel
    assert 0 < row["frames_all_interior"] < 6 and u["min"] == 0


def test_animation_lane_records_and_idle_shares():
    # three frames: K1 then two glue kernels each, the host's gaps between
    # them; frame 1 lies wholly inside the interior skip
    k1 = "void escape_kernel<0, true, false>(Params, ...)"
    events = [("memset", "gpu_memset", 0.0, 1.0)]
    for start, k1_ms in ((1.0, 4.0), (10.0, 1.0), (14.0, 2.0)):
        events += [(k1, "kernel", start, k1_ms),
                   ("stack", "kernel", start + k1_ms, 1.0),
                   ("add", "kernel", start + k1_ms + 1.0, 1.0)]
    events.append(("copy", "gpu_memcpy", 19.0, 1.0))
    lane = bench_all.animation_lane(events, [False, True, False])
    assert lane["k1_records_ms"] == {"sum": 7e3, "mean": 7e3 / 3,
                                     "p50": 2e3, "min": 1e3, "max": 4e3}
    assert lane["k1_floor_ms"] == 1e3 and lane["frames_under_2x_floor"] == 1
    # busy 1 + (6 + 3 + 4) + 1 = 15 of a 20 s window
    assert lane["busy_s"] == pytest.approx(15.0)
    assert lane["window_s"] == pytest.approx(20.0)
    assert lane["idle_share"] == pytest.approx(0.25)
    assert lane["window_fps"] == pytest.approx(3 / 20)
    # frame 1's span 10-14 holds 3 s of work; frames 0 and 2 span 1-10 and
    # 14-20 with 6 and 4 + 1 s
    assert lane["idle_share_all_interior"] == pytest.approx(0.25)
    assert lane["idle_share_other"] == pytest.approx(1 - 11 / 15)
    assert lane["device_events_per_frame"] == pytest.approx(11 / 3)
    with pytest.raises(RuntimeError, match="2 K1 records for 3 frames"):
        bench_all.animation_lane(events[:-4], [False, True, False])


def test_config0_two_fresh_processes(tmp_path):
    row = bench_all.bench_cold_start(width=32, height=18, iters=16,
                                     device="cpu")
    assert JAX_KEYS[0] <= set(row)
    assert row["preview_served_first"] is False
    assert 0 < row["first_visible_frame_s"] <= row["first_process_s"]
    assert 0 < row["cached_visible_frame_s"] <= row["cached_process_s"]
    # no fresh-compile probe off the card, and no kernel built
    assert row["compile_service_fresh_trivial_s"] is None
    assert row["reason"] == "cpu" and row["kernels_built_cold"] == []
    assert not os.path.exists(row["cache_dir"])


def test_issued_iterations_per_warp():
    n = torch.zeros((2, 40), dtype=torch.int32)
    n[0, 3] = 10      # warp (row 0, cols 0-31): max 10
    n[0, 35] = 4      # warp (row 0, cols 32-39 and 24 pad lanes): max 4
    n[1, :] = 7       # both warps of row 1: max 7, but lane 0 is skipped
    n[1, 32:] = 0
    n[1, 32] = 100    # skipped: never enters the loop
    skipped = torch.zeros_like(n, dtype=torch.bool)
    skipped[1, 32] = True
    assert bench_all.issued_iterations(n, skipped) == 32 * (10 + 4 + 7)


def test_interior_skip_mask_is_the_plain_kernels_skip():
    w, h = 96, 64
    params = escape.pack_params(center_x=-0.5, center_y=0.0, zoom=3.0,
                                iter_limit=64)
    frame = dict(width=w, height=h, map_height=h, row0=0)
    mask = escape.interior_skip_mask(params, device="cpu", **frame)
    assert mask.shape == (h, w) and 0 < int(mask.sum()) < w * h
    n, zx, zy = escape.escape_fields_plain(
        params, max_iter_cap=64, interior_skip=True, fused_color=None,
        device="cpu", **frame)
    n0 = escape.escape_fields_plain(
        params, max_iter_cap=64, interior_skip=False, fused_color=None,
        device="cpu", **frame)[0]
    assert torch.equal(n, n0)
    assert bool((zx[mask] == 0).all() and (zy[mask] == 0).all())
    assert bool((n[mask] == 64).all())


def test_main_runs_every_config_and_writes_only_out(tmp_path, capsys,
                                                   monkeypatch):
    # every config of the JAX bench is ported (0-8): none is refused, and
    # with all skipped only the link probe's row is printed
    assert sorted(bench_all.CONFIGS) == list(range(9))
    assert not hasattr(bench_all, "NOT_PORTED")
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "rows.json"
    rc = bench_all.main(["--device", "cpu", "--skip", "0,1,2,3,4,5,6,7,8",
                         "--out", str(out)])
    assert rc == 0
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    assert len(lines) == 1 and "skipped" in lines[0]["link_probe"]
    saved = json.loads(out.read_text())
    assert saved["card"] == "cpu" and "config8" not in saved
    assert sorted(os.listdir(tmp_path)) == ["rows.json"]


def test_config8_latencies_and_encodes(one_thread_children):
    # the pty run of config 8 (keys as the JAX row's, each latency case
    # with n, p50 and p95 of its keys) on a 12x5-cell terminal
    row = bench_all.bench_live_latency(device="cpu", **SMALL[8])
    assert row["config"] == "live_latency_12x5_sixel"
    assert row["frame_px"] == [96, 64]
    for case in ("f32_mandelbrot", "deep_zoom_1e-12"):
        lat = row[case]
        assert lat["n"] == 2 and 0 < lat["p50_ms"] <= lat["p95_ms"]
        assert lat["first_frame_s"] > 0 and lat["frame_bytes"] > 1000
    assert row["sixel_encode_ms"] > 0 and row["kitty_png_encode_ms"] > 0
    assert row["pty_mb_s"] > 0


def test_config8_raises_when_no_frame_lands():
    # a session that never draws (here: --device cuda without CUDA, which
    # exits 2 at once) is an error with the child's stderr, not a row
    with pytest.raises(RuntimeError, match="no first frame") as e:
        bench_all.pty_latency(torch.device("cuda", 0), None, keys=1,
                              iters=16, cols=20, lines=8)
    assert "CUDA is not available" in str(e.value)


def test_percentiles_take_the_jax_rows_indices():
    lat = bench_all._percentiles([0.004, 0.001, 0.003, 0.002])
    assert lat == {"n": 4, "p50_ms": pytest.approx(3.0),
                   "p95_ms": pytest.approx(4.0)}


def test_config5_giant_is_the_whole_render(tmp_path):
    # the giant still the config streams equals the monolithic render of
    # its scene (16-bit, flipped at export); the device seconds of three
    # bands, the worker and fetch seconds and the sizes are reported
    from fractalrenderer_tpu_torch import Scene, models
    from fractalrenderer_tpu_torch.ops.coloring import quantize_image
    from fractalrenderer_tpu_torch.utils.png import read_png

    out = str(tmp_path / "g.png")
    row = bench_all.bench_giant(64, 48, 16, device="cpu", out_path=out)
    assert row["config"] == "giant_64x48_16bit" and row["bands"] == 3
    assert len(row["device_band_seconds_spread"]) == 3
    assert row["bytes_over_link"] == 64 * 48 * 6
    assert row["png_bytes"] == os.path.getsize(out)
    assert "link_probe_mb_s" not in row  # no link on the CPU
    want = quantize_image(models.render(Scene(max_iterations=256), 64,
                                        48, device="cpu"),
                          bit_depth=16).numpy()[::-1]
    assert (read_png(out) == want).all()


def test_quick_runs_config5_at_4096(monkeypatch, capsys):
    seen = {}

    def fake(device, **kw):
        seen.update(kw)
        return {"config": "giant"}

    monkeypatch.setitem(bench_all.CONFIGS, 5, fake)
    rc = bench_all.main(["--device", "cpu", "--quick", "--skip",
                         "0,1,2,3,4,6,7,8"])
    assert rc == 0 and seen == {"width": 4096, "height": 4096}
    capsys.readouterr()


def test_main_records_a_failing_config_and_exits_1(capsys, monkeypatch):
    def broken(device):
        raise RuntimeError("boom")

    ran = []
    monkeypatch.setitem(bench_all.CONFIGS, 2, broken)
    monkeypatch.setitem(bench_all.CONFIGS, 7, lambda device: ran.append(7)
                        or {"config": "stub"})
    rc = bench_all.main(["--device", "cpu", "--skip", "0,1,3,4,5,6,8"])
    assert rc == 1 and ran == [7]
    rows = [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]
    assert rows[0]["config2"]["error"] == "RuntimeError: boom"
    assert rows[0]["config2"]["card"] == "cpu"
    assert rows[1]["config7"]["config"] == "stub"
    assert rows[1]["config7"]["wall_incl_compile_s"] >= 0


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_all.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_all.bench_julia_sweep(device="cuda")
    assert bench_all.card(torch.device("cpu")) == "cpu"


def test_headline_record_keys():
    rec = bench.headline(width=32, height=18, iters=32, frames=2,
                         bulb_iters=8, dz_iters=100, device="cpu")
    # the keys of the JAX record (bench.py at the repository root), + card
    assert set(rec) == {
        "metric", "value", "unit", "vs_baseline", "iters_per_sec",
        "mean_iters_per_pixel", "timing_method", "mandelbulb_1080p_ms",
        "mandelbulb_mpix_s", "julia_sweep16_ms_per_batch",
        "julia_sweep16_mpix_s", "julia_timing_method",
        "deepzoom_1e12_10k_1080p_s", "deepzoom_rebase_passes",
        "deepzoom_glitched_remaining", "deepzoom_timing_method", "card"}
    assert rec["metric"] == "mandelbrot_1080p_256iter_render"
    assert rec["unit"] == "Mpix/s/chip" and rec["card"] == "cpu"
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 1000)
    assert rec["iters_per_sec"] == pytest.approx(
        rec["value"] * 1e6 * rec["mean_iters_per_pixel"])
    assert rec["deepzoom_glitched_remaining"] == 0


_PROBE = """
import sys
import fractalrenderer_tpu_torch.bench
import fractalrenderer_tpu_torch.bench_all
import fractalrenderer_tpu_torch.utils.diag
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "fractalrenderer_tpu")]
print(",".join(sorted(bad)))
"""


def test_bench_modules_load_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == ""


def test_config_sizes_default_to_the_jax_workloads():
    import inspect

    def defaults(fn):
        return {k: v.default for k, v in
                inspect.signature(fn).parameters.items()
                if v.default is not inspect.Parameter.empty}

    assert defaults(bench_all.bench_mandelbrot_1080p) == dict(
        width=1920, height=1080, iters=256, frames=64, device="cuda")
    assert defaults(bench_all.bench_deep_zoom)["iters"] == 10000
    assert defaults(bench_all.bench_scaled_deep_zoom) == dict(
        width=960, height=540, iters=2000, device="cuda")
    assert defaults(bench.headline)["bulb_iters"] == 100
    assert bench_all.K1_WARP == 32  # csrc/escape.cu's block(32, 8)
