"""The deep zoom past the f64 floor (the ARBITRARY tier's floatexp deltas)
on the port's normal path, ``models.render`` with a shared reference
orbit, against the benchmark's plain floatexp reference
(``benchmark/reference/deep_fx.py``) bit for bit in uint8 and against an
exact Python-integer oracle on the counts; the exact-decimal zoom path
of the cell ``deep_zoom_fx.floor_export``, its orbit's bits buckets, the
span ``k3.fx_scale`` and the counter ``render.rebase_passes``.

On the card (``cuda``): a 1080p frame's band equals the reference's.  The
card's tests import no JAX, so they run there without the suite's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_deep_fx.py -q
"""
import json
import os
from decimal import Decimal, localcontext
from fractions import Fraction

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import spec
from benchmark.harness.traffic import generate
from benchmark.paths import exact_zoom
from benchmark.reference import deep_fx
from fractalrenderer_tpu_torch import FractalType, Scene, models
from fractalrenderer_tpu_torch.deepzoom.hp import precision_mode_for_zoom_frac
from fractalrenderer_tpu_torch.models import deep_zoom

CELL = "deep_zoom_fx.floor_export"
W, H, MI = 24, 16, 1200


def _view(zoom: str, width: int, height: int):
    """A reference point jittered off c = i by a fraction of the view, and
    a scene centre 2.5 and -1.25 pixels from it (so the shift is not 0),
    as exact decimal strings."""
    with localcontext() as ctx:
        ctx.prec = 400
        view = Decimal(4) * Decimal(zoom) / height
        step = view / height
        ref = (Decimal(0) + view * Decimal("0.2137"),
               Decimal(1) - view * Decimal("0.1713"))
        ctr = (ref[0] + step * Decimal("2.5"), ref[1] - step * Decimal("1.25"))
        return tuple(map(str, ref)), tuple(map(str, ctr))


def _scene(center, zoom, iters):
    return Scene(fractal_type=FractalType.DEEP_ZOOM, hp_center_x=center[0],
                 hp_center_y=center[1], hp_zoom=zoom, max_iterations=iters,
                 use_perturbation=True, use_series_approximation=False)


def _render(scene, ref, width, height, device="cpu", cache=None):
    return models.render(scene, width, height, device=device, quantize=8,
                         ref_center=ref,
                         orbit_cache={} if cache is None else cache,
                         rebasing=True, max_passes=256, return_info=True)


def _oracle_counts(center, zoom, width, height, max_iter, bits):
    """Exact per-pixel counts by direct iteration in Python integers
    (fixed point with ``bits`` fraction bits) with the kernel's mapping
    and count convention: n = #{i >= 1 : |z_i| <= 4}, the limit inside."""
    step = Fraction(zoom) * 4 / (height * height)
    one = 1 << bits
    bail = 16 * one * one
    n = np.zeros((height, width), np.int64)
    for py in range(height):
        for px in range(width):
            cr = round((Fraction(center[0])
                        + step * (Fraction(px) - Fraction(width, 2))) * one)
            ci = round((Fraction(center[1])
                        + step * (Fraction(py) - Fraction(height, 2))) * one)
            zr = zi = 0
            k = max_iter
            for i in range(max_iter + 1):
                if zr * zr + zi * zi > bail:
                    k = i - 1
                    break
                zr, zi = (((zr * zr - zi * zi) >> bits) + cr,
                          ((2 * zr * zi) >> bits) + ci)
            n[py, px] = k
    return n


@pytest.mark.parametrize("zoom", ["1e-306", "1e-318", "1e-326"])
def test_fx_frames_equal_the_reference_and_the_oracle(zoom):
    ref, ctr = _view(zoom, W, H)
    img, info = _render(_scene(ctr, zoom, MI), ref, W, H)
    assert info["scaled_delta"] and info["precision_mode"] == "ARBITRARY"
    assert info["fallback_pixels"] == 0 and info["rebase_passes"] >= 2
    bits = deep_fx.orbit_bits(Fraction(zoom))
    assert info["precision_bits"] == bits
    [(want, n)] = deep_fx.frames(
        [(Fraction(zoom), list(range(H)))], tuple(map(Fraction, ctr)),
        tuple(map(Fraction, ref)), W, H, MI, 4.0, 0.0, 1.0, 0, "cpu", 256)
    assert img.dtype == torch.uint8 and torch.equal(img, want)
    exact = _oracle_counts(ctr, zoom, W, H, MI, bits)
    assert len(np.unique(exact)) > 10  # the frame has structure
    assert (n.numpy() == exact).mean() >= 0.95


def test_a_zoom_that_reads_zero_as_a_double_renders():
    # below 4.9e-324 the zoom is 0.0 as a double; the pixel step is far
    # below the smallest subnormal
    zoom = "3e-325"
    assert float(Fraction(zoom)) == 0.0
    ref, ctr = _view(zoom, 12, 8)
    img, info = _render(_scene(ctr, zoom, 1000), ref, 12, 8)
    assert info["scaled_delta"] and info["precision_bits"] == 1216
    assert len(torch.unique(img.reshape(-1, 3), dim=0)) > 3


def test_exact_zoom_keeps_the_jitter_and_states_every_zoom():
    t = {"frames": 48, "zoom_from": "1e-312", "zoom_to": "1e-326",
         "seed": {"jitter": 0.25}}
    cfg = {"export_height": 1080, "center_x": "0", "center_y": "1",
           "max_iterations": 10000}
    frames = exact_zoom.frames(t, cfg, np.random.default_rng(2 ** 31 + 5))
    zs = [f["hp_zoom"] for f in frames]
    assert zs[0] == "1e-312" and zs[-1] == "1e-326" and len(zs) == 48
    ratios = [Fraction(a) / Fraction(b) for a, b in zip(zs, zs[1:])]
    assert all(abs(float(r) - 10 ** (14 / 47)) < 1e-12 for r in ratios)
    # stated in decimal at 34 digits: no zoom went through a double
    assert all(len(Decimal(z).as_tuple().digits) <= 34 for z in zs)
    assert sum(Fraction(z) < Fraction("4.9e-324") for z in zs) >= 8
    view = 4 * Fraction(zs[-1]) / 1080
    dx = Fraction(frames[0]["hp_center_x"]) / view
    dy = (Fraction(frames[0]["hp_center_y"]) - 1) / view
    assert 0 < abs(dx) <= Fraction(1, 4) and 0 < abs(dy) <= Fraction(1, 4)
    assert len({(f["hp_center_x"], f["hp_center_y"]) for f in frames}) == 1
    # another seed moves the centre elsewhere
    other = exact_zoom.frames(t, cfg, np.random.default_rng(7))
    assert other[0]["hp_center_y"] != frames[0]["hp_center_y"]


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 3])
def test_the_pass_bits_land_in_the_buckets_set_up_warms(seed):
    cell = spec.load_cell(CELL)
    tr = generate(cell.traffic, cell.config, cell.checks, seed)
    drv = cell.module("drivers", "deep_fx_frames").Driver(
        cell.config, cell.traffic, cell.checks, tr, seed, "cpu")
    warmed = set(drv.buckets())
    for f in tr.frames:
        _, bits = precision_mode_for_zoom_frac(Fraction(f["hp_zoom"]))
        bits = -(-bits // 64) * 64
        assert bits == deep_fx.orbit_bits(Fraction(f["hp_zoom"]))
        assert bits in warmed


def _span_names(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    raw = json.loads(path.read_text())
    return [e["name"] for e in raw["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


@pytest.mark.parametrize("zoom,tier", [("1e-318", "fx"), ("1e-12", "dd")])
def test_the_fx_scale_span_opens_in_fx_frames_only(zoom, tier, tmp_path):
    ref, ctr = _view(zoom, 12, 8)
    scene = _scene(ctr, zoom, 400)
    cache = {}
    _render(scene, ref, 12, 8, cache=cache)  # the orbit, outside the session
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, info = _render(scene, ref, 12, 8, cache=cache)
    names = _span_names(prof, tmp_path)
    assert info["scaled_delta"] == (tier == "fx")
    assert names.count("k3.fx_scale") == (1 if tier == "fx" else 0)
    assert "k3.prepare" in names and "deep.orbit" not in names


def test_rebase_passes_counts_every_frame():
    before_p, before_f = deep_zoom.render.rebase_passes, \
        deep_zoom.render.frames
    cache, total = {}, 0
    for zoom in ("1e-318", "5e-319"):
        ref, ctr = _view("1e-318", 12, 8)
        _, info = _render(_scene(ctr, zoom, 1000), ref, 12, 8, cache=cache)
        total += info["rebase_passes"]
    assert total >= 4
    assert deep_zoom.render.rebase_passes - before_p == total
    assert deep_zoom.render.frames - before_f == 2


@pytest.mark.cuda
def test_a_1080p_band_on_the_card_equals_the_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    zoom, rows = "1e-320", list(range(500, 532))
    ref, ctr = _view(zoom, 1920, 1080)
    img, info = _render(_scene(ctr, zoom, 10000), ref, 1920, 1080,
                        device="cuda:0")
    assert info["scaled_delta"] and info["fallback_pixels"] == 0
    [(want, _)] = deep_fx.frames(
        [(Fraction(zoom), rows)], tuple(map(Fraction, ctr)),
        tuple(map(Fraction, ref)), 1920, 1080, 10000, 4.0, 0.0, 1.0, 0,
        "cuda:0", 256)
    assert torch.equal(img[rows], want)


def test_the_cell_files_are_where_the_harness_finds_them():
    cell = spec.load_cell(CELL)
    assert cell.config["precision"] == "fx" and cell.chips == 1
    assert cell.traffic["driver"] == "deep_fx_frames"
    for kind, name in (("paths", "exact_zoom"), ("drivers", "deep_fx_frames"),
                       ("metrics", "k3fx_roofline"),
                       ("metrics", "fx_scale_ms_per_frame"),
                       ("metrics", "rebase_passes_per_frame")):
        assert os.path.isfile(os.path.join(cell.bench_dir, kind,
                                           f"{name}.py"))
