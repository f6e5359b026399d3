#!/usr/bin/env python3
"""One-GPU smoke run of the PyTorch + CUDA port (fractalrenderer_tpu_torch).

Run from the repository root on a machine with an NVIDIA GPU and the CUDA
toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch version on the card, drives the main path (``cli render`` of a
1920x1080 Mandelbrot frame) and times kernel against plain version with
CUDA events.  Each phase prints one line; any failure raises, so the exit
code is non-zero and no result line is printed.  On success the last three
lines are the card's name and power limit, a JSON line describing each
kernel, and ``{"ok": true, "device": {...}}``.  Imports no JAX.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
W, H, ITERS = 1920, 1080, 256
SEAHORSE = dict(center_x=-0.743643887037151, center_y=0.13182590420533,
                zoom=0.008, max_iter=1024)
COLOR_ATOL = 1e-5  # the colour contract of the reference's own tests


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def read_png_rgb8(path: str):
    """Decode the port's own PNGs (8-bit RGB, filter type 0 on every row)."""
    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos, idat, width = 8, b"", None
    while pos < len(data):
        (length,), tag = struct.unpack(">I", data[pos:pos + 4]), \
            data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            width, height, depth, ctype = struct.unpack(">IIBB",
                                                        payload[:10])
            assert (depth, ctype) == (8, 2), (depth, ctype)
        elif tag == b"IDAT":
            idat += payload
    rows = np.frombuffer(zlib.decompress(idat), np.uint8)
    rows = rows.reshape(height, 1 + width * 3)
    assert (rows[:, 0] == 0).all(), "unexpected PNG row filter"
    return rows[:, 1:].reshape(height, width, 3)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, by CUDA
    events on the current stream (after one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "fractalrenderer_tpu_torch")):
        print("error: run chip_smoke.py from a checkout of the repository "
              "(fractalrenderer_tpu_torch/ is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from fractalrenderer_tpu_torch import Scene, cli, models
    from fractalrenderer_tpu_torch.models import common
    from fractalrenderer_tpu_torch.ops import _cuda, escape
    from fractalrenderer_tpu_torch.utils import png
    from fractalrenderer_tpu_torch.utils.image import to_export_orientation

    assert not any(m == "jax" or m.startswith(("jax.", "fractalrenderer_tpu."))
                   or m == "fractalrenderer_tpu" for m in sys.modules), \
        "the port imported JAX or the JAX package"
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    # -- build ---------------------------------------------------------------
    t0 = time.monotonic()
    _cuda.load_library()
    build_s = time.monotonic() - t0
    log = _cuda.library_path()[:-3] + ".log"
    ptxas = ""
    if os.path.exists(log):
        with open(log) as f:
            ptxas = " | ".join(" ".join(ln.split()[2:]) for ln in f
                               if "registers" in ln or "stack frame" in ln)
    print(f"build: {build_s:.2f} s ({ptxas or 'no ptxas report'})",
          flush=True)

    def launch(impl, width, height, fused=None, skip=True, row0=0,
               map_height=None, max_iter=ITERS, **view):
        view = dict(dict(center_x=-0.5, center_y=0.0, zoom=3.0), **view)
        params = escape.pack_params(iter_limit=max_iter, row0=row0, **view)
        outs = impl(params, width=width, height=height,
                    map_height=map_height or height, row0=row0,
                    max_iter_cap=max_iter, interior_skip=skip,
                    fused_color=fused, device=dev)
        torch.cuda.synchronize()
        return outs

    # -- fields: counts and z bit-exact against the plain version ------------
    cases = [
        (f"{W}x{H}x{ITERS} default", dict(width=W, height=H)),
        (f"{W}x{H} seahorse x{SEAHORSE['max_iter']}",
         dict(width=W, height=H, **SEAHORSE)),
        ("1000x563x256 default", dict(width=1000, height=563)),
        ("1000x563x256 no skip", dict(width=1000, height=563, skip=False)),
    ]
    for name, kw in cases:
        n_k, zx_k, zy_k = launch(escape.escape_fields_cuda, **kw)
        n_p, zx_p, zy_p = launch(escape.escape_fields_plain, **kw)
        mism = int((n_k != n_p).sum())
        assert mism == 0, f"{name}: {mism} iteration-count mismatches"
        assert torch.equal(zx_k, zx_p) and torch.equal(zy_k, zy_p), \
            f"{name}: zx/zy not bit-equal"
        print(f"fields {name}: 0 count mismatches, zx/zy bit-equal "
              f"(n mean {n_k.float().mean().item():.2f})", flush=True)
    # a row band equals the same rows of the whole frame
    r0, r1 = H // 4, H // 2
    full = launch(escape.escape_fields_cuda, W, H)
    band = launch(escape.escape_fields_cuda, W, r1 - r0, row0=r0,
                  map_height=H)
    for a, b in zip(band, full):
        assert torch.equal(a, b[r0:r1]), "row band != whole-frame rows"
    print(f"fields band rows {r0}-{r1} of {H}: equal to the whole frame",
          flush=True)

    # -- fused colour against the plain version --------------------------------
    max_err = 0.0
    for name, fused, extra in (
            ("default", (0, 0, False, True), {}),
            ("palette 3, interior 1, offset .25, scale 2", (3, 1, False, True),
             dict(color_offset=0.25, color_scale=2.0)),
            ("palette 4, clamp floors", (4, 0, True, True),
             dict(brightness=0.05, saturation=-0.5, contrast=1.3)),
            ("palette 2, interior 1, no post chain", (2, 1, False, False),
             {})):
        rgb_k = torch.stack(launch(escape.escape_fields_cuda, W, H,
                                   fused=fused, **extra))
        rgb_p = torch.stack(launch(escape.escape_fields_plain, W, H,
                                   fused=fused, **extra))
        assert torch.isfinite(rgb_k).all(), f"fused {name}: non-finite"
        err = (rgb_k - rgb_p).abs().max().item()
        q_k = common.quantize_image(rgb_k, bit_depth=8).int()
        q_p = common.quantize_image(rgb_p, bit_depth=8).int()
        lsb = (q_k - q_p).abs().max().item()
        assert err <= COLOR_ATOL, f"fused {name}: max |diff| {err}"
        assert lsb <= 1, f"fused {name}: uint8 differs by {lsb} LSB"
        max_err = max(max_err, err)
        print(f"fused {name}: max |diff| {err:.3g}, uint8 max "
              f"{lsb} LSB", flush=True)

    # -- main path: cli render, default 1920x1080 frame ------------------------
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "frame.png")
        escape.escape_fields_cuda.launches = 0
        t0 = time.monotonic()
        rc = cli.main(["render", "--width", str(W), "--height", str(H),
                       "--out", out])
        wall = time.monotonic() - t0
        launches = escape.escape_fields_cuda.launches
        assert rc == 0, f"cli render exited {rc}"
        assert launches > 0, "the main path did not launch the CUDA kernel"
        img = read_png_rgb8(out)
    assert img.shape == (H, W, 3), img.shape
    scene = Scene()
    ref = common.quantize_image(torch.stack(launch(
        escape.escape_fields_plain, W, H, fused=(0, 0, False, True),
        brightness=scene.color_brightness,
        saturation=scene.color_saturation, contrast=scene.color_contrast),
        dim=-1), bit_depth=8).flip(0).cpu().numpy()
    lsb = int(np.abs(img.astype(np.int32) - ref.astype(np.int32)).max())
    assert lsb <= 1, f"PNG differs from the plain render by {lsb} LSB"
    assert 0 < img.mean() < 255, "degenerate image"
    print(f"main path: cli render {W}x{H} -> PNG {img.shape}, kernel "
          f"launches {launches}, {wall * 1e3:.1f} ms wall (first call), "
          f"max {lsb} LSB from the plain render", flush=True)

    # -- where a warm main-path frame's host time goes -------------------------
    stages = {"render+quantize": [], "flip+fetch": [], "png write": [],
              "cli render": []}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "frame.png")
        for _ in range(5):
            t0 = time.perf_counter()
            img = models.render(scene, W, H, device=dev, quantize=8)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            host = to_export_orientation(img).cpu().numpy()
            t2 = time.perf_counter()
            png.write_png(out, host)
            t3 = time.perf_counter()
            stages["render+quantize"].append(t1 - t0)
            stages["flip+fetch"].append(t2 - t1)
            stages["png write"].append(t3 - t2)
        for _ in range(3):
            with contextlib.redirect_stdout(io.StringIO()):
                t0 = time.perf_counter()
                assert cli.main(["render", "--out", out]) == 0
                stages["cli render"].append(time.perf_counter() - t0)
    print("main path, warm, host clock, median ms: " + ", ".join(
        f"{k} {statistics.median(v) * 1e3:.2f}" for k, v in stages.items()),
        flush=True)

    # -- time per 1080p frame --------------------------------------------------
    params = escape.pack_params(center_x=-0.5, center_y=0.0, zoom=3.0,
                                iter_limit=ITERS)
    frame = dict(width=W, height=H, map_height=H, row0=0,
                 max_iter_cap=ITERS, interior_skip=True, device=dev)
    fused = (0, 0, False, True)
    ms = {}
    for label, impl, reps in (("plain", escape.escape_fields_plain, 3),
                              ("kernel", escape.escape_fields_cuda, 50),
                              ("kernel", escape.escape_fields_cuda, 50),
                              ("plain", escape.escape_fields_plain, 3)):
        t = cuda_ms(lambda: impl(params, fused_color=fused, **frame), reps)
        ms.setdefault(label, []).append(t)
    fields_ms = cuda_ms(lambda: escape.escape_fields_cuda(
        params, fused_color=None, **frame), 50)
    k_ms = statistics.median(ms["kernel"])
    p_ms = statistics.median(ms["plain"])
    print(f"time per {W}x{H}x{ITERS} frame: kernel fused {k_ms:.4f} ms "
          f"(runs {ms['kernel']}), kernel fields {fields_ms:.4f} ms, plain "
          f"fused {p_ms:.3f} ms (runs {ms['plain']}); "
          f"{W * H / k_ms / 1e3:.0f} Mpix/s", flush=True)

    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "escape_mandelbrot", "route": "cuda",
        "source": "fractalrenderer_tpu_torch/csrc/escape.cu",
        "replaces": "fractalrenderer_tpu/ops/escape.py:155",
        "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
