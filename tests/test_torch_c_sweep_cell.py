"""The Julia c sweep at 2x2 AA on the port's normal path,
``models.julia.render_c_sweep``, against the benchmark's plain Julia
reference (``benchmark/reference/plain_julia.py``): each sample's counts
bit for bit, the uint8 frames within the cell ``julia_f32.c_sweep``'s
limits, each entry equal to the single render of its c; and the cell's c
path around the upstream's presets (``benchmark/paths/julia_presets.py``).

On the card (``cuda``): a 1080p band of a sweep frame equals the
reference's within the same limits.  The card's tests import no JAX, so
they run there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_c_sweep_cell.py -q
"""
import os

import pytest
import torch

from benchmark.harness import compare, spec
from benchmark.harness.traffic import generate
from benchmark.reference import plain_julia
from fractalrenderer_tpu_torch import FractalType, Scene, models
from fractalrenderer_tpu_torch.models import julia
from fractalrenderer_tpu_torch.ops import escape, mapping
from fractalrenderer_tpu_torch.presets import JULIA_PRESETS

CELL = "julia_f32.c_sweep"
W, H, CAP = 48, 27, 300


def _cell():
    return spec.load_cell(CELL)


def _scene(config, max_iterations):
    return Scene(fractal_type=FractalType.JULIA,
                 center_x=config["center_x"], center_y=config["center_y"],
                 zoom=config["zoom"], max_iterations=max_iterations,
                 bailout=config["bailout"],
                 antialiasing_samples=config["aa"],
                 palette_mode=config["palette_mode"],
                 color_offset=config["color_offset"],
                 color_scale=config["color_scale"],
                 color_brightness=config["brightness"],
                 color_saturation=config["saturation"],
                 color_contrast=config["contrast"])


def _view(config, c, max_iterations):
    return {"center_x": config["center_x"], "center_y": config["center_y"],
            "zoom": config["zoom"], "bailout": config["bailout"],
            "iter_limit": max_iterations, "c_real": c[0], "c_imag": c[1],
            "color_offset": config["color_offset"],
            "color_scale": config["color_scale"],
            "brightness": config["brightness"],
            "saturation": config["saturation"],
            "contrast": config["contrast"]}


def _port_counts(scene, c, width, height, rows, device):
    """The program's count plane of each AA sample (K1's fields instance,
    or its plain version on the CPU) over ``rows``, stacked."""
    cap = plain_julia.iter_bucket(scene.max_iterations)
    out = []
    for off in mapping.aa_offsets_uv(scene.antialiasing_samples, width):
        f = escape.escape_fields(
            "julia", width, len(rows), center_x=scene.center_x,
            center_y=scene.center_y, zoom=scene.zoom, max_iter=cap,
            bailout=scene.bailout, offset=off, julia_c=c,
            iter_limit=float(scene.max_iterations), row0=rows[0],
            map_height=height, device=device)
        out.append(f["n"])
    return torch.stack(out)


def _within_limits(got_f32, ref_u8, checks):
    acc = compare.Diff()
    acc.add(plain_julia.quantize8(got_f32).permute(2, 0, 1), ref_u8)
    nums = compare.checks(acc, checks)
    return all(v["value"] <= v["limit"] for v in nums.values()), nums


def _four_cs():
    """A jittered preset (the pass's first leg starts there), a c of the
    second and one of the third leg, and an unjittered preset."""
    cell = _cell()
    tr = generate(cell.traffic, cell.config, cell.checks, 2 ** 31 + 11)
    fr = tr.frames
    return [(fr[i]["c_real"], fr[i]["c_imag"]) for i in (0, 21, 42)] \
        + [JULIA_PRESETS["San Marco"]]


def test_sweep_equals_the_reference_and_single_renders():
    cell = _cell()
    cfg = cell.config
    scene = _scene(cfg, CAP)
    cs = _four_cs()
    out = julia.render_c_sweep(scene, cs, W, H, device="cpu")
    assert out.shape == (4, H, W, 3) and out.dtype == torch.float32
    cap = plain_julia.iter_bucket(CAP)
    for i, c in enumerate(cs):
        ref, _, n, limit_f = plain_julia.frame(
            W, H, range(H), _view(cfg, c, CAP), cfg["aa"], cap, "cpu")
        assert limit_f == CAP and n.shape == (4, H, W)
        assert torch.equal(_port_counts(scene, c, W, H, list(range(H)),
                                        "cpu"), n), i
        ok, nums = _within_limits(out[i], ref, cell.checks)
        assert ok, (i, nums)
        single = models.render(scene.with_(julia_c_real=c[0],
                                           julia_c_imag=c[1]), W, H,
                               device="cpu")
        assert torch.equal(out[i], single), i
    # the frames have interior and exterior: every count from 0 to the cap
    assert int(n.min()) < 5 and int(n.max()) == CAP


def test_a_lower_precision_loop_is_outside_the_limits():
    cell = _cell()
    cfg = cell.config
    c = _four_cs()[1]
    out = julia.render_c_sweep(_scene(cfg, CAP), [c], W, H, device="cpu")
    _, img, _, _ = plain_julia.frame(W, H, range(H), _view(cfg, c, CAP),
                                     cfg["aa"], plain_julia.iter_bucket(CAP),
                                     "cpu", torch.bfloat16)
    ref = plain_julia.quantize8(img).permute(2, 0, 1)
    ok, nums = _within_limits(out[0], ref, cell.checks)
    assert not ok, nums


@pytest.mark.parametrize("seed", [0, 9, 2 ** 31 + 5, 4 * 10 ** 9 + 1])
def test_the_c_path_loops_through_the_presets(seed):
    cell = _cell()
    t = cell.traffic
    tr = generate(t, cell.config, cell.checks, seed)
    assert len(tr.frames) == 64 and sorted(tr.order) == list(range(64))
    presets = [(p["c_real"], p["c_imag"]) for p in t["presets"]]
    assert presets[0] == JULIA_PRESETS["Dendritic"]
    assert {p["name"] for p in t["presets"]} <= set(JULIA_PRESETS)
    jit = t["seed"]["jitter"]
    starts = [(tr.frames[16 * i]["c_real"], tr.frames[16 * i]["c_imag"])
              for i in range(4)]
    for (sr, si), (pr, pi) in zip(starts, presets):
        assert abs(sr - pr) <= jit and abs(si - pi) <= jit
        assert (sr, si) != (pr, pi)
    # each leg evenly spaced towards the next jittered preset, end excluded
    for i in range(4):
        a, b = starts[i], starts[(i + 1) % 4]
        for j in range(16):
            f = tr.frames[16 * i + j]
            assert f["c_real"] == pytest.approx(a[0] + (b[0] - a[0]) * j / 16)
            assert f["c_imag"] == pytest.approx(a[1] + (b[1] - a[1]) * j / 16)
    again = generate(t, cell.config, cell.checks, seed)
    assert again.frames == tr.frames and again.order == tr.order
    assert again.sample == tr.sample and len(tr.sample) == 6
    other = generate(t, cell.config, cell.checks, seed + 1)
    assert other.frames != tr.frames


def test_the_cell_files_are_where_the_harness_finds_them():
    cell = _cell()
    assert cell.config["fractal"] == "julia" and cell.chips == 1
    assert cell.config["aa"] == 2 and cell.config["max_iterations"] == 1024
    assert cell.traffic["driver"] == "julia_sweep"
    for kind, name in (("paths", "julia_presets"), ("drivers", "julia_sweep"),
                       ("metrics", "k1_sweep_roofline"),
                       ("metrics", "batch_post_ms_per_frame"),
                       ("metrics", "param_uploads_per_frame")):
        assert os.path.isfile(os.path.join(cell.bench_dir, kind,
                                           f"{name}.py"))


@pytest.mark.cuda
def test_a_1080p_band_on_the_card_equals_the_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    cell = _cell()
    cfg = cell.config
    w, h, iters = cfg["export_width"], cfg["export_height"], \
        cfg["max_iterations"]
    scene = _scene(cfg, iters)
    rows = list(range(500, 532))
    cs = _four_cs()[:2]
    out = julia.render_c_sweep(scene, cs, w, h, device=dev)
    for i, c in enumerate(cs):
        ref, _, n, _ = plain_julia.frame(
            w, h, rows, _view(cfg, c, iters), cfg["aa"],
            plain_julia.iter_bucket(iters), dev)
        assert torch.equal(_port_counts(scene, c, w, h, rows, dev), n), i
        ok, nums = _within_limits(out[i][rows], ref, cell.checks)
        assert ok, (i, nums)
