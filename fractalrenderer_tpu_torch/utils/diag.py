"""Diagnostics and observability (the port's counterpart of
``fractalrenderer_tpu/utils/diag.py``):

- scene_debug_summary: debug_print_fractal_state (vk_engine.h:198-214)
- validate_scene: the NaN/zero repair clamps the reference applies while
  packing push constants (compute_effect_manager.h:335-345)
- params_layout_selfcheck: verify_push_constant_layout (vk_engine.cpp:
  420-446) — the Python packers' index constants against the CUDA
  sources' own
- span: a named stage of the program on the profiler's clock, a no-op
  when no profiler session records
- trace, device_seconds_from_trace, measure_device_seconds: device time
  from a torch.profiler trace
- measure_link_bandwidth: the device-to-host copy rate, pageable and
  pinned
- measure_vpu_peak: the measured FP32 peak, kernel K5 (csrc/peak.cu), with
  its plain version fma_chains_plain
"""
from __future__ import annotations

import contextlib
import glob
import json
import math
import os
import re
import tempfile
import time
from typing import Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

from ..scene import Scene


def scene_debug_summary(scene: Scene) -> str:
    lines = [
        "=== Scene ===",
        f"type={scene.fractal_type.display_name}",
        f"center=({scene.center_x!r}, {scene.center_y!r}) zoom={scene.zoom!r}",
        f"iterations={scene.max_iterations} bailout={scene.bailout} "
        f"aa={scene.antialiasing_samples}",
        f"palette={scene.palette_mode} offset={scene.color_offset} "
        f"scale={scene.color_scale}",
        f"effects: interior={scene.interior_style} "
        f"trap={scene.orbit_trap_enabled}@{scene.orbit_trap_radius} "
        f"stripes={scene.stripe_enabled}@{scene.stripe_density}",
        f"enhance: b={scene.color_brightness} s={scene.color_saturation} "
        f"c={scene.color_contrast}",
    ]
    if scene.fractal_type.name == "JULIA" or scene.use_julia_set:
        lines.append(f"julia c = {scene.julia_c_real} + {scene.julia_c_imag}i")
    if scene.fractal_type.name == "PHOENIX":
        lines.append(f"phoenix p={scene.phoenix_p} r={scene.phoenix_r} "
                     f"julia_mode={scene.use_julia_set}")
    if scene.fractal_type.name == "MANDELBULB":
        lines.append(f"bulb power={scene.mandelbulb_power} "
                     f"cam={scene.camera_distance} rot={scene.rotation_y} "
                     f"fov={scene.fov} time={scene.time}")
    if scene.hp_center_x or scene.hp_zoom:
        lines.append(f"hp: x={scene.hp_center_x} y={scene.hp_center_y} "
                     f"zoom={scene.hp_zoom}")
    return "\n".join(lines)


def validate_scene(scene: Scene) -> Scene:
    """Repair degenerate values the way the reference does before packing
    push constants (compute_effect_manager.h:335-345): zero/NaN/inf zoom →
    default, degenerate bailout → default."""
    fixes = {}
    z = scene.zoom
    if not math.isfinite(z) or z == 0.0:
        fixes["zoom"] = 3.0
    b = scene.bailout
    if not math.isfinite(b) or b <= 0.0:
        fixes["bailout"] = 4.0
    if scene.max_iterations < 1:
        fixes["max_iterations"] = 1
    return scene.with_(**fixes) if fixes else scene


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"parameter layout: {what}")


def _cuda_constants(path: str, prefix: str, count: str) -> dict:
    """``NAME = value`` of the ``constexpr int`` statements of a CUDA
    source, for the names that start with ``prefix`` and for ``count``."""
    with open(path) as f:
        src = f.read()
    out = {}
    for stmt in re.findall(r"constexpr int ([^;]*);", src):
        for name, val in re.findall(r"\b(\w+)\s*=\s*(\d+)", stmt):
            if name.startswith(prefix) or name == count:
                out[name] = int(val)
    return out


def _cuda_enum(path: str, prefix: str) -> list:
    """The names of the first ``enum { ... }`` of a CUDA source whose
    names start with ``prefix``, in order."""
    with open(path) as f:
        src = f.read()
    for body in re.findall(r"enum\s*\{([^}]*)\}", src):
        names = re.findall(r"\b(\w+)\b", body)
        if names and all(n.startswith(prefix) for n in names):
            return names
    raise AssertionError(f"parameter layout: no {prefix}* enum in {path}")


def params_layout_selfcheck() -> bool:
    """Cross-module layout assertion (analog of the reference's
    verify_push_constant_layout memory self-check): the JAX package's
    asserts on the port's index constants, and the same constants as the
    CUDA sources define them (``csrc/escape.cu`` ``P_*`` and ``F_*``,
    ``csrc/dd_escape.cu`` ``kND``/``D_*``, the ``Q_*`` enum of
    ``csrc/pert_kernel.cuh``, the ``T_*`` enums of K4b's counters in
    ``csrc/bulb.cu`` and of K1's and K2's in ``csrc/warp_counters.cuh``,
    K4c's ``S_*`` shade vector in ``csrc/bulb.cu``,
    which both sources include), so a packer and its kernel cannot drift
    apart.  The row0 slots of K1 and K2 are launch arguments there, not
    constants.  Raises AssertionError on a mismatch."""
    from ..ops import (_cuda, bulb_kernel, bulb_shade, dd_escape, escape,
                       perturbation)

    _require(escape.NPARAMS == 19, "escape.NPARAMS")
    _require(escape.P_ROW0 == 11, "escape.P_ROW0")
    esc = {n: getattr(escape, n) for n in (
        "P_CX", "P_CY", "P_ZOOM", "P_OFFX", "P_OFFY", "P_BAIL2", "P_LIMIT",
        "P_A0", "P_A1", "P_A2", "P_A3", "P_ROW0", "P_COFF", "P_CSCALE",
        "P_BRIGHT", "P_SAT", "P_CONTRAST", "P_BAILOUT", "P_STRIPE")}
    _require(sorted(esc.values()) == list(range(escape.NPARAMS)),
             "escape P_* not dense and unique")
    pert = {f"Q_{n}": getattr(perturbation, f"Q_{n}") for n in (
        "CXH", "CXL", "CYH", "CYL", "PSH", "PSL", "LIMIT", "BAIL2", "REFLEN",
        "GLITCH_TOL", "SHIFTXH", "SHIFTXL", "SHIFTYH", "SHIFTYL", "OFFX",
        "OFFY", "AR", "AI", "BR", "BI", "CR", "CI", "NSKIP", "ROW0",
        "ARL", "AIL", "BRL", "BIL", "CRL", "CIL", "SEXP", "M0", "FIRST",
        "Z0XH", "Z0XL", "Z0YH", "Z0YL", "PP", "RR", "SE0", "AROW0")}
    _require(sorted(pert.values()) == list(range(perturbation.NQ)),
             "perturbation Q_* not dense and unique")
    ddp = {f"D_{n}": getattr(dd_escape, f"D_{n}") for n in (
        "CXH", "CXL", "CYH", "CYL", "ZH", "ZL", "LIMIT", "BAIL2", "OFFX",
        "OFFY", "ROW0")}
    _require(sorted(ddp.values()) == list(range(dd_escape.ND)),
             "dd_escape D_* not dense and unique")

    # the kernels' side of the same layouts
    src = _cuda.CSRC_DIR
    for path, prefix, py, count, n, launch_arg in (
            ("escape.cu", "P_", esc, "kNParams", escape.NPARAMS, "P_ROW0"),
            ("dd_escape.cu", "D_", ddp, "kND", dd_escape.ND, "D_ROW0")):
        cu = _cuda_constants(os.path.join(src, path), prefix, count)
        _require(cu.pop(count, None) == n, f"{path} {count} != {n}")
        _require(set(cu) == set(py) - {launch_arg},
                 f"{path} names {sorted(set(cu) ^ (set(py) - {launch_arg}))}")
        for name, val in cu.items():
            _require(py[name] == val, f"{path} {name} = {val}, the Python "
                     f"packer's is {py[name]}")
    # K1's launch flags
    flags = {n: getattr(escape, n) for n in dir(escape) if n.startswith("F_")}
    _require(_cuda_constants(os.path.join(src, "escape.cu"), "F_", "")
             == flags, "escape.cu F_* flags differ from ops/escape")
    cuh = os.path.join(src, "pert_kernel.cuh")
    _require(_cuda_constants(cuh, "Q_", "kNQ").get("kNQ") == perturbation.NQ,
             f"pert_kernel.cuh kNQ != {perturbation.NQ}")
    enum = _cuda_enum(cuh, "Q_")
    _require(enum == sorted(pert, key=pert.get),
             "pert_kernel.cuh Q_* enum order differs from ops/perturbation")
    # K4b's per-warp counters: the T_* enum of csrc/bulb.cu
    bulb = os.path.join(src, "bulb.cu")
    trips = [f"T_{n.upper()}" for n in bulb_kernel.TRIP_FIELDS]
    _require(_cuda_enum(bulb, "T_") == trips,
             "bulb.cu T_* enum differs from bulb_kernel.TRIP_FIELDS")
    _require(_cuda_constants(bulb, "T_", "kTripFields").get("kTripFields")
             == len(trips), "bulb.cu kTripFields != len(TRIP_FIELDS)")
    # K4c's shade vector: the S_* enum of csrc/bulb.cu
    shade = sorted((n for n in dir(bulb_shade) if n.startswith("S_")),
                   key=lambda n: getattr(bulb_shade, n))
    _require([getattr(bulb_shade, n) for n in shade]
             == list(range(bulb_shade.NS)), "bulb_shade S_* not dense")
    _require(_cuda_enum(bulb, "S_") == shade,
             "bulb.cu S_* enum differs from ops/bulb_shade")
    _require(_cuda_constants(bulb, "S_", "kNS").get("kNS") == bulb_shade.NS,
             "bulb.cu kNS != bulb_shade.NS")
    # K1's and K2's: the T_* enum of csrc/warp_counters.cuh
    wc = os.path.join(src, "warp_counters.cuh")
    trips = [f"T_{n.upper()}" for n in escape.TRIP_FIELDS]
    _require(_cuda_enum(wc, "T_") == trips,
             "warp_counters.cuh T_* enum differs from escape.TRIP_FIELDS")
    _require(_cuda_constants(wc, "T_", "kTripFields").get("kTripFields")
             == len(trips), "warp_counters.cuh kTripFields != "
             "len(TRIP_FIELDS)")
    _require(dd_escape.TRIP_FIELDS is escape.TRIP_FIELDS,
             "dd_escape.TRIP_FIELDS is not K1's layout")
    for path in ("escape.cu", "dd_escape.cu"):
        with open(os.path.join(src, path)) as f:
            text = f.read()
        _require('#include "warp_counters.cuh"' in text,
                 f"{path} does not include warp_counters.cuh")
    return True


# the span of a stage when no profiler session records: shared, reentrant
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks a stage of the program, ``name``, as a
    ``torch.profiler.record_function`` span while a profiler session
    records (an operator's ``trace``, the benchmark's traced stretch), so
    the stage lies on the clock of the card's records in the exported
    trace.  With no session recording it returns one shared no-op object:
    the hot path pays one flag test.  Names carry their layer as a prefix
    (``batch.``, ``k1.``, ``deep.``, ``k3.``); the README lists them."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


class NoDeviceEvents(ValueError):
    """A trace of a card's run that lacks device events: none at all (the
    profiler did not reach the card's activity API), or none for some of
    the launches and copies the host made in it."""


_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}  # Kineto's names
# the host calls that put work on the card: each has a device event with
# its correlation id in a whole trace
_ENQUEUES = re.compile(r"Launch(Kernel|CooperativeKernel)|Memcpy|Memset")


# Host seconds a trace of the card spans before and after the work, one
# entry per attempt of measure_device_seconds.  On the H100 (torch 2.11,
# CUDA 12.8) a short session taken late in a process can come back with
# its CUDA calls but without its kernels and copies, while sessions padded
# by 1.5 s on each side keep them (PERF.md §7)
TRACE_PADS_S = (0.05, 1.5, 3.0)


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, pad_s: float = TRACE_PADS_S[0],
          device="cuda"):
    """Profile the enclosed work with torch.profiler (CPU activity, and
    CUDA activity when ``device`` is a card) and write a chrome trace into
    ``log_dir`` (the counterpart of the JAX package's jax.profiler
    wrapper).  On a card the session starts after the queued work and spans
    ``pad_s`` more host seconds on each side of the enclosed work (no
    device work there), and waits for the card before it stops."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = _on_card(device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        if cuda:
            time.sleep(pad_s)
        yield
        if cuda:
            torch.cuda.synchronize(device)
            time.sleep(pad_s)
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{os.getpid()}_{time.time_ns()}.pt.trace.json"))


def _top_level_seconds(events) -> float:
    """Seconds of the events not nested in another one of their thread."""
    total, by_thread = 0.0, {}
    for e in events:
        by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for evs in by_thread.values():
        end = -math.inf
        for e in sorted(evs, key=lambda e: (e["ts"], -e.get("dur", 0))):
            if e["ts"] >= end:
                total += e.get("dur", 0)
                end = e["ts"] + e.get("dur", 0)
    return total / 1e6


def _correlation(e):
    return (e.get("args") or {}).get("correlation")


def device_seconds_from_trace(log_dir: str, lane: str = "device",
                              device="cuda") -> float:
    """Device-side seconds recorded in the newest torch.profiler chrome
    trace (``*.pt.trace.json``) under ``log_dir``.

    For a card's run (``device`` "cuda"): ``lane="device"`` sums every
    device event (kernels, copies, memsets), ``lane="kernel"`` the kernels
    alone (the counterpart of the JAX package's per-op "XLA Ops" lane); the
    sum is per device, and the busiest device's is returned (devices run
    concurrently, so their sum would over-report).  Host gaps between
    launches are not counted.  Raises NoDeviceEvents when the trace holds
    no device event, or when a launch, copy or memset the host made in it
    has no device event of its correlation id (the trace lost part of the
    run).  For a CPU run (``device`` "cpu") it sums the top-level CPU
    operator events, as the JAX package falls back to its CPU client's
    threads; ValueError when there are none."""
    if lane not in ("device", "kernel"):
        raise ValueError(f"lane must be 'device' or 'kernel', got {lane!r}")
    paths = glob.glob(os.path.join(log_dir, "**", "*.pt.trace.json"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no *.pt.trace.json under {log_dir}")
    with open(max(paths, key=os.path.getmtime)) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X"]
    if not _on_card(device):
        seconds = _top_level_seconds(
            [e for e in events if e.get("cat") == "cpu_op"])
        if seconds == 0:
            raise ValueError(f"trace under {log_dir} has no CPU operator "
                             "events: nothing executed inside the trace")
        return seconds
    on_device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    enqueued = {_correlation(e) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and _ENQUEUES.search(e.get("name", ""))}
    lost = enqueued - {_correlation(e) for e in on_device}
    if not on_device or lost:
        cats = {}
        for e in events:
            cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
        raise NoDeviceEvents(
            f"trace under {log_dir} of a card's run: {len(lost)} of "
            f"{len(enqueued)} launches and copies have no device event "
            f"(events by category: {cats})")
    cats = {"kernel"} if lane == "kernel" else _DEVICE_CATS
    per_device = {}
    for e in on_device:
        if e.get("cat") in cats:
            dev = (e.get("args") or {}).get("device", e.get("pid"))
            per_device[dev] = per_device.get(dev, 0.0) + e.get("dur", 0)
    return max(per_device.values(), default=0.0) / 1e6


def device_events_from_trace(log_dir: str) -> list:
    """``[(name, category, start seconds, seconds), ...]`` of every device
    event (kernel, copy, memset) of the newest trace under ``log_dir`` (a
    card's run), in the order the card ran them; raises as
    device_seconds_from_trace does."""
    device_seconds_from_trace(log_dir)  # the same checks
    paths = glob.glob(os.path.join(log_dir, "**", "*.pt.trace.json"),
                      recursive=True)
    with open(max(paths, key=os.path.getmtime)) as f:
        events = json.load(f).get("traceEvents", [])
    on_device = [e for e in events
                 if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    return [(e.get("name", ""), e["cat"], e.get("ts", 0) / 1e6,
             e.get("dur", 0) / 1e6)
            for e in sorted(on_device, key=lambda e: e.get("ts", 0))]


def busy_and_window(events) -> tuple:
    """(busy seconds, window seconds) of device ``events`` (as
    device_events_from_trace gives them): the union of their intervals,
    and the span from the first one's start to the last one's end.  The
    idle share of the window is 1 - busy / window."""
    busy, end, first, last = 0.0, -math.inf, math.inf, -math.inf
    for _, _, start, dur in sorted(events, key=lambda e: e[2]):
        busy += max(0.0, start + dur - max(start, end))
        end = max(end, start + dur)
        first, last = min(first, start), max(last, start + dur)
    return busy, (last - first if events else 0.0)


def kernel_records_from_trace(log_dir: str) -> list:
    """``[(kernel name, seconds), ...]`` of every kernel record of the
    newest trace under ``log_dir`` (a card's run), in the order the card
    ran them."""
    return [(name, dur) for name, cat, _, dur
            in device_events_from_trace(log_dir) if cat == "kernel"]


def kernel_seconds_from_trace(log_dir: str) -> dict:
    """``{kernel name: [launches, seconds]}`` of the newest trace under
    ``log_dir`` (a card's run), for a breakdown of its device lane."""
    out = {}
    for name, seconds in kernel_records_from_trace(log_dir):
        k = out.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += seconds
    return out


def measure_device_seconds(run, log_dir: Optional[str] = None,
                           device="cuda") -> float:
    """Execute ``run()`` under a profiler trace and return the device-side
    seconds it spent on ``device`` (device_seconds_from_trace; the trace
    waits for the card).  Traces into a temporary directory by default.
    A trace of a card's run that came back without all its device events
    (NoDeviceEvents: on the H100 a short profiler session late in a process
    returns the CUDA calls but no kernel) is taken again with the next,
    longer pad of ``TRACE_PADS_S``, and the last one's failure raises;
    ``measure_device_seconds.retries`` counts the runs taken again."""
    for attempt, pad in enumerate(TRACE_PADS_S):
        ctx = (contextlib.nullcontext(log_dir) if log_dir is not None
               else tempfile.TemporaryDirectory())
        with ctx as d:
            with trace(d, pad, device):
                run()
            try:
                return device_seconds_from_trace(d, device=device)
            except NoDeviceEvents:
                if attempt + 1 == len(TRACE_PADS_S):
                    raise
        measure_device_seconds.retries += 1


measure_device_seconds.retries = 0


def measure_link_bandwidth(mb: int = 64, reps: int = 3,
                           device="cuda") -> dict:
    """Timed raw device-to-host copy of one ``mb``-MiB uint8 buffer that the
    card computed: the link rate that bounds a fetched frame (the
    reference's analog is its synchronous staging-buffer readback,
    vk_engine.cpp:1939-2003).  ``best_mb_s``/``mean_mb_s`` over ``reps``
    copies into fresh pageable memory (``tensor.cpu()``, as the CLI fetches
    a frame), ``pinned_best_mb_s``/``pinned_mean_mb_s`` into one pinned
    buffer.  Needs a CUDA device."""
    from ..ops._cuda import cuda_device

    dev = cuda_device(device)
    n = mb * 1024 * 1024
    x = torch.arange(n, dtype=torch.int32, device=dev).to(torch.uint8)
    pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    out = {"mb": mb}
    for key, copy in (("", lambda: x.cpu()),
                      ("pinned_", lambda: pinned.copy_(x))):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            host = copy()
            times.append(time.perf_counter() - t0)
        if host.numel() != n or int(host[n - 1]) != (n - 1) % 256:
            raise RuntimeError("link probe: the copy is not the buffer")
        out[f"{key}best_mb_s"] = n / min(times) / 1e6
        out[f"{key}mean_mb_s"] = n * len(times) / sum(times) / 1e6
    return out


PEAK_CHAINS = (1, 2, 4, 8)  # K5's instances


def _check_chains(chains: int) -> None:
    if chains not in PEAK_CHAINS:
        raise ValueError(f"chains must be one of {PEAK_CHAINS}, got {chains}")


def fma_chains_plain(x: torch.Tensor, chains: int, k: int) -> torch.Tensor:
    """K5 as plain PyTorch on ``x``'s device: ``chains`` accumulators
    ``x + i``, each taking ``k`` steps of ``acc * 1.000001f + 0.5f`` as one
    fused multiply-add, summed in chain order.  Each step runs in float64
    and rounds once to float32: for acc >= 0.5 the product of two 24-bit
    significands plus 0.5 fits in 53 bits, so the f64 step is exact and its
    one rounding is exactly fmaf's.  The probe's input is all ones (every
    acc >= 1), so the kernel is bit-equal to this."""
    _check_chains(chains)
    m = float(np.float32(1.000001))
    acc = torch.stack([x + float(i) for i in range(chains)])
    for _ in range(k):
        acc = (acc.double() * m + 0.5).float()
    s = acc[0]
    for a in acc[1:]:
        s = s + a
    return s


def fma_chains_cuda(x: torch.Tensor, chains: int, k: int) -> torch.Tensor:
    """Launch K5 (``csrc/peak.cu``) on the contiguous f32 CUDA tensor ``x``
    (same results as fma_chains_plain).  Counts its launches in
    ``fma_chains_cuda.launches``."""
    from ..ops import _cuda

    _check_chains(chains)
    dev = _cuda.cuda_device(x.device)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"K5 takes a contiguous f32 tensor, got {x.dtype}")
    if not 0 < x.numel() < 2 ** 31 or k < 0:
        raise ValueError(f"K5: bad size {x.numel()} or k {k}")
    lib = _cuda.load_library()
    with torch.cuda.device(dev):
        out = torch.empty_like(x)
        rc = lib.fr_fma_peak(x.data_ptr(), out.data_ptr(), x.numel(), int(k),
                             int(chains),
                             torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(lib, rc, "fma peak")
    fma_chains_cuda.launches += 1
    return out


fma_chains_cuda.launches = 0


def fma_chains(x: torch.Tensor, chains: int, k: int) -> torch.Tensor:
    """K5 on ``x``'s device: the plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return fma_chains_plain(x, chains, k)
    return fma_chains_cuda(x, chains, k)


PEAK_SHAPE = (2048, 1024)  # the TPU probe's 8 x 8 tiles of 256 x 128


def measure_vpu_peak(chains: int = 8, k: int = 2000,
                     device="cuda") -> dict:
    """Empirical FP32 peak, the rate the escape, dd, perturbation and march
    kernels' issued work is read against (f32 on the FP32 units; the tensor
    cores play no part).  On the H100 it measures the SMs' FP32 FMA rate:
    kernel K5 runs ``chains`` independent FMA chains of ``k`` steps over a
    2048 x 1024 array, timed by device seconds (best of 3).  Keeps the JAX
    package's name and keys (there the TPU's vector unit): ``seconds`` and
    ``gflops_f32`` for flops = 2 k chains N."""
    x = torch.ones(PEAK_SHAPE, dtype=torch.float32, device=device)
    fma_chains(x, chains, k)  # first launch: library load

    def r():
        float(fma_chains(x, chains, k)[0, 0])

    s = min(measure_device_seconds(r, device=device) for _ in range(3))
    flops = 2 * k * chains * x.numel()
    return {"seconds": s, "gflops_f32": flops / s / 1e9}
