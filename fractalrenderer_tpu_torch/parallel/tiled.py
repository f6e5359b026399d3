"""Row bands across devices and progressive giant stills (the port's
counterpart of ``fractalrenderer_tpu/parallel/tiled.py``).

BASELINE config #5: a 16K×16K still in a gather-free row-band
decomposition.  Each band renders on its own device from its global first
row and the full image's mapping height (every kernel wrapper takes both),
so no device reads anything another device wrote; the only traffic between
devices is the final assembly on the host.  Every kind renders its bands
through one seam, ``models.band_renderer``, so nothing here depends on the
fractal kind; only ``render_frames_sharded``, the 2D batch, calls
``models/common`` itself.

The JAX package traces one ``shard_map`` program over its mesh.  Here each
band is dispatched to its device in turn, every band before the first
fetch, so distinct devices render at once.  The JAX package pads the image
to whole bands and trims the padding; here the last band's height is
clamped to the image instead (the wrappers refuse rows outside it), which
gives the same pixels, since a pixel's value depends only on its global
row.

Giant stills additionally stream through the host: the image is rendered in
row bands, each band written as a PNG tile on disk; an interrupted export
resumes by skipping completed tiles; the final PNG is assembled from bands
deflated in worker threads without ever materializing the full image
(utils/png.ParallelPNGWriter).  This replaces the reference's single
4GB-staging-buffer print export (vk_engine.cpp:1939-2003), which cannot
exceed one GPU allocation.
"""
from __future__ import annotations

import concurrent.futures as futures
import dataclasses
import json
import os
import shutil
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import models
from ..models import common
from ..ops.coloring import quantize_image
from ..scene import Scene
from ..utils import png
from ..utils.image import downsample2x
from .mesh import (RenderMesh, make_render_mesh, pad_to_multiple, row_bands,
                   to_host)

# zlib level of the giant's final IDAT chunks (the resume tiles take 1)
_FINAL_LEVEL = 3


def _band_renderers(scene: Scene, width: int, height: int, devices,
                    orbit_cache: Optional[Dict] = None) -> Dict:
    """One ``models.band_renderer`` per distinct device of a job, all
    sharing one orbit cache (so a deep zoom computes its orbit once)."""
    cache = {} if orbit_cache is None else orbit_cache
    return {d: models.band_renderer(scene, width, height, device=d,
                                    orbit_cache=cache) for d in devices}


def render_sharded(scene: Scene, width: int, height: int,
                   mesh: Optional[RenderMesh] = None,
                   quantize: int = 0) -> torch.Tensor:
    """Render one frame of any kind with its rows split across the mesh's
    'rows' axis (gather-free: each device computes its band through
    ``models.band_renderer``) and return it on the host as an (H, W, 3)
    tensor.

    ``quantize``: 8/16 quantizes INSIDE each band, on its device (the PNG
    writer's exact clip/scale/round), so each fetch moves 1-2 B per channel
    instead of 4 — byte-identical files to the single-device quantized
    path."""
    if mesh is None:
        mesh = make_render_mesh()
    devs = mesh.devices[0]
    fns = _band_renderers(scene, width, height, devs)
    parts = []
    for dev, (row0, rows) in zip(devs, row_bands(height, len(devs))):
        out = fns[dev](row0, rows)
        if quantize:
            out = quantize_image(out, bit_depth=quantize)
        parts.append(out)
    return to_host(parts)


def render_frames_sharded(scenes, width: int, height: int,
                          mesh: Optional[RenderMesh] = None,
                          cap: Optional[int] = None,
                          quantize: int = 0) -> torch.Tensor:
    """Batch of frames over ('frames', 'rows'): data-parallel frames × row
    bands (BASELINE configs #2/#3 across devices), returned on the host as
    an (N, H, W, 3) tensor.  All scenes must share a static config;
    iteration counts may differ.  ``cap`` overrides the iteration bound
    (callers rendering many chunks of one sequence pass the sequence-wide
    max, so every chunk renders under one cap).  ``quantize``: 8/16
    quantizes inside each band on its device, so the fetch moves uint
    instead of f32.  Frames go to the frame groups in contiguous runs, as
    the JAX package's batch splits over its 'frames' axis."""
    if mesh is None:
        mesh = make_render_mesh(frames=1)
    fam, conv, clamp = common.family_map()[scenes[0].fractal_type]
    if cap is None:
        cap = max(s.max_iterations for s in scenes)
    cfg = dataclasses.replace(
        common.scene_static_cfg(scenes[0], width, height, fam, conv, clamp),
        max_iter=cap)
    per_group = pad_to_multiple(len(scenes), mesh.shape["frames"]) \
        // mesh.shape["frames"]
    groups = []
    for devs in mesh.devices:
        groups.append([(row0, common.band_render_fn(
                           dataclasses.replace(cfg, device=str(dev)), rows,
                           height))
                       for dev, (row0, rows)
                       in zip(devs, row_bands(height, len(devs)))])
    frames = []
    for i, s in enumerate(scenes):
        dyn = common.scene_dyn_params(s)
        parts = []
        for row0, fn in groups[i // per_group]:
            out = fn(dyn, row0)
            if quantize:
                out = quantize_image(out, bit_depth=quantize)
            parts.append(out)
        frames.append(parts)
    return torch.stack([to_host(parts) for parts in frames])


# ---------------------------------------------------------------------------
# Progressive / resumable giant stills
# ---------------------------------------------------------------------------

class _Fetches:
    """Device-to-host copies of bands in flight: each band's parts are
    copied into one host tensor (pinned where a part is on a card) on a
    copy stream of the part's device, and an event per copy tells the
    drain when the rows have landed — the port's form of the JAX
    package's ``copy_to_host_async``."""

    def __init__(self):
        self._streams = {}

    def start(self, parts: List[torch.Tensor]):
        """(host tensor, events) of a band whose parts are in row order."""
        rows = sum(p.shape[0] for p in parts)
        on_card = any(p.device.type == "cuda" for p in parts)
        host = torch.empty((rows, *parts[0].shape[1:]), dtype=parts[0].dtype,
                           pin_memory=on_card)
        events, r = [], 0
        for p in parts:
            dst = host[r:r + p.shape[0]]
            r += p.shape[0]
            if p.device.type != "cuda":
                dst.copy_(p)
                continue
            s = self._streams.get(p.device)
            if s is None:
                s = self._streams[p.device] = torch.cuda.Stream(p.device)
            s.wait_stream(torch.cuda.current_stream(p.device))
            with torch.cuda.stream(s):
                dst.copy_(p, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(s)
            # the band's memory must outlive the copy queued on ``s``
            p.record_stream(s)
            events.append(ev)
        return host, events


def render_giant_still(scene: Scene, width: int, height: int, out_path: str,
                       band_rows: int = 512, tile_dir: Optional[str] = None,
                       resume: bool = True, bit_depth: int = 16,
                       dpi: Optional[float] = 300.0,
                       mesh: Optional[RenderMesh] = None,
                       use_mesh: bool = False,
                       supersample: bool = False,
                       extra_metadata: Optional[Dict] = None,
                       orbit_cache: Optional[Dict] = None,
                       keep_tiles: bool = True,
                       progress_cb=None, device="cuda") -> Dict:
    """Stream a huge still to disk in row bands (config #5) rendered on
    ``device``, or with ``use_mesh`` split across the mesh's rows.

    Each band is rendered, written as ``band_%05d.png`` in ``tile_dir``,
    and assembled into one PNG by streaming scanlines — peak host memory is
    about two bands plus the deflate queue.  With ``resume``, completed
    bands are skipped on restart (manifest.json tracks geometry).

    Every fractal family is supported, matching the reference's
    print-export of whatever fractal is active (vk_engine.cpp:1796-2232):
    each band renders through ``models.band_renderer``, one per device
    for the job; a deep zoom's bands share one reference orbit
    (``orbit_cache``, or a fresh one).

    ``supersample``: render each band at 2x and 2x2-box-downsample before
    quantizing — the banded form of export-print's --supersample
    --downsample (bit-identical to downsampling a monolithic 2x render),
    for print exports too large to materialize at 2x in one pass.

    Returns {"bands", "rendered", "skipped", "fetch_seconds" (host time
    blocked on device-to-host copies), "deflate_seconds" and
    "tile_seconds" (worker seconds deflating the final IDAT chunks and
    writing the tiles), "tile_dir", "out"}.
    """
    from ..utils.diag import validate_scene

    # Repair degenerate scenes exactly like the one-pass renderers do
    # (compute_effect_manager.h:335-345) — export-print's banded
    # delegation must not behave differently above the size threshold.
    scene = validate_scene(scene)
    dev = torch.device(device)
    if dev.type == "cuda":
        from ..ops._cuda import cuda_device

        dev = cuda_device(dev)  # raises before any file is touched
    if use_mesh and mesh is None:
        mesh = make_render_mesh()
    tile_dir = tile_dir or out_path + ".tiles"
    os.makedirs(tile_dir, exist_ok=True)
    manifest_path = os.path.join(tile_dir, "manifest.json")
    manifest = {"width": width, "height": height, "band_rows": band_rows,
                "bit_depth": bit_depth, "supersample": bool(supersample),
                "scene": scene.to_dict()}
    if resume and os.path.exists(manifest_path):
        try:
            with open(manifest_path) as f:
                old = json.load(f)
        except ValueError:
            old = {}  # truncated by a crash mid-write — treat as stale
        if {k: old.get(k) for k in manifest} != manifest:
            # stale tiles from a different job (other geometry, scene, or
            # bit depth — resumed tiles feed the final PNG verbatim, so a
            # depth mismatch would corrupt it) — start over
            for f in os.listdir(tile_dir):
                os.remove(os.path.join(tile_dir, f))
    # atomic write: a crash mid-dump must not wedge later resumes
    tmp_manifest = manifest_path + ".tmp"
    with open(tmp_manifest, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp_manifest, manifest_path)

    n_bands = -(-height // band_rows)
    rendered = 0
    skipped = 0
    # Supersampled exports render bands at 2x geometry and box-downsample
    # back to output rows before quantizing; every row index below is in
    # OUTPUT rows, scaled by ``ss`` where it meets the render-resolution
    # map, so 2x2 pairs never straddle a band edge.
    ss = 2 if supersample else 1
    devs = mesh.devices[0] if use_mesh else (dev,)
    fns = _band_renderers(scene, width * ss, height * ss, devs, orbit_cache)

    def render_rows(d, row0: int, rows: int) -> torch.Tensor:
        # rendered, downsampled and quantized on the band's device (the PNG
        # writer's clip/scale/truncate), so the link carries uint16/uint8
        # instead of f32 RGB
        img = fns[d](row0 * ss, rows * ss)
        return quantize_image(downsample2x(img) if supersample else img,
                              bit_depth=bit_depth)

    def produce_band(row0: int, rows: int) -> List[torch.Tensor]:
        if not use_mesh:
            return [render_rows(dev, row0, rows)]
        # the band's rows split over the mesh's devices
        return [render_rows(d, row0 + r, n)
                for d, (r, n) in zip(devs, row_bands(rows, len(devs)))]

    # Fully pipelined export: bands render in FINAL scanline order
    # (reversed — export orientation is a vertical flip), dispatching band
    # k+1 and starting its device->host copy before blocking on band k;
    # resume tiles AND the final PNG's IDAT chunks deflate in worker
    # threads (pigz-style independently-deflated full-flush chunks,
    # utils.png.ParallelPNGWriter) while later bands render.  End-to-end
    # wall time tracks max(render+transfer, deflate/threads) instead of
    # their sum.
    def timed(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        return out, time.perf_counter() - t0

    def encode_band(band_np, tile_path):
        # write tiles atomically so a crash never leaves a bad tile.  Tiles
        # are TRANSIENT resume artifacts (deleted after a successful
        # assembly unless keep_tiles): level-1 deflate, so they cost the
        # workers less than the final IDAT's own deflate
        tmp = tile_path + ".tmp"
        png.write_png(tmp, band_np, bit_depth=bit_depth, compress_level=1)
        os.replace(tmp, tile_path)

    meta = {"Software": "fractalrenderer_tpu_torch (giant still)",
            **scene.metadata_summary(), **(extra_metadata or {})}
    fetches = _Fetches()
    out_tmp = out_path + ".tmp"
    done_ct = 0
    fetch_s = deflate_s = tile_s = 0.0
    with open(out_tmp, "wb") as fp, \
            png.ParallelPNGWriter(fp, width, height, bit_depth=bit_depth,
                                  channels=3, metadata=meta, dpi=dpi) as w, \
            futures.ThreadPoolExecutor(max_workers=4) as pool:
        inflight = []       # (host tensor, events, tile path)
        tile_futures = []
        final_q = []        # (n_rows, deflate future, raw bytes) in order

        def flush_final(block=False):
            nonlocal deflate_s
            while final_q and (block or final_q[0][1].done()):
                n_rows_, fut_, raw_ = final_q.pop(0)
                payload, secs = fut_.result()
                deflate_s += secs
                w.write_deflated(n_rows_, payload, raw_)

        def emit(band_np):
            # band_np is in render orientation; the final PNG wants the
            # export flip.  Called strictly in final scanline order.
            nonlocal done_ct
            raw = png.band_raw_bytes(band_np[::-1], bit_depth)
            final_q.append((band_np.shape[0],
                            pool.submit(timed, png.deflate_chunk, raw,
                                        _FINAL_LEVEL), raw))
            flush_final()
            done_ct += 1
            if progress_cb:
                progress_cb(done_ct, n_bands)

        def drain_one():
            nonlocal rendered, fetch_s
            host, events, tile_path = inflight.pop(0)
            t0 = time.perf_counter()
            for ev in events:
                ev.synchronize()
            fetch_s += time.perf_counter() - t0
            band_np = host.numpy()
            tile_futures.append(pool.submit(timed, encode_band, band_np,
                                            tile_path))
            rendered += 1
            emit(band_np)

        for b in reversed(range(n_bands)):  # final scanline order
            tile_path = os.path.join(tile_dir, f"band_{b:05d}.png")
            rows = min(band_rows, height - b * band_rows)
            if resume and os.path.exists(tile_path):
                # an unreadable or wrong-shaped tile (truncated write,
                # foreign file) must re-render its band, not abort the
                # whole export with a decode error
                try:
                    tile = png.read_png(tile_path)
                except Exception:
                    tile = None
                want_dt = np.uint8 if bit_depth == 8 else np.uint16
                if tile is not None and tile.shape == (rows, width, 3) \
                        and tile.dtype == want_dt:
                    while inflight:  # keep emit() ordering
                        drain_one()
                    skipped += 1
                    emit(tile)
                    continue
            host, events = fetches.start(produce_band(b * band_rows, rows))
            inflight.append((host, events, tile_path))
            if len(inflight) >= 2:
                drain_one()
        while inflight:
            drain_one()
        flush_final(block=True)
        for fut in tile_futures:
            tile_s += fut.result()[1]  # surfaces any tile-encode error
    os.replace(out_tmp, out_path)
    if not keep_tiles:
        # the tiles are an interrupted-run resume aid; callers that asked
        # for a single PNG (export-print) drop them once assembly succeeded
        shutil.rmtree(tile_dir, ignore_errors=True)
    return {"bands": n_bands, "rendered": rendered, "skipped": skipped,
            "fetch_seconds": fetch_s, "deflate_seconds": deflate_s,
            "tile_seconds": tile_s, "tile_dir": tile_dir, "out": out_path}
