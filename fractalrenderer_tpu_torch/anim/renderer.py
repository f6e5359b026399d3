"""Animation rendering — the batched replacement for the reference's
synchronous frame loop (src/animation_renderer.{h,cpp}); the port's
counterpart of ``fractalrenderer_tpu/anim/renderer.py``.

The reference renders one frame at a time on the GPU with a device-wait per
frame (animation_renderer.cpp:75-127).  Here frames are interpolated up
front, grouped by static render configuration (size / AA / palette /
toggles; iteration counts stay dynamic under the group's cap), and rendered
in batches of ``batch_size`` frames (models.common.batch_render_fn: one K1
launch per frame on one stream, each quantized on the device into its slot
of the batch), fetched once per batch; PNG encoding runs on the host
between batches; with a mesh, each batch splits over its devices
(parallel.render_frames_sharded).  Mandelbulb and deep-zoom frames take the
per-frame model path.  Progress/ETA and cancellation mirror the reference's
RenderProgress (animation_renderer.h:20-29) and cancel flag (:90).
"""
from __future__ import annotations

import dataclasses
import enum
import os
import time as _time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..models import common
from ..scene import Scene
from ..utils import png
from ..utils.image import to_export_orientation
from .keyframes import Animation

_FAMILY = common.family_map()

_PNG_IEND = b"IEND\xaeB`\x82"


def _frame_complete(path: str, width: int, height: int,
                    bit_depth: int) -> bool:
    """A frame PNG counts as done only when fully written (ends with the
    IEND chunk) AND its IHDR matches the current render settings — a frame
    truncated by a crash/cancel, or left over from a run at a different
    size/depth, is re-rendered."""
    try:
        with open(path, "rb") as f:
            head = f.read(25)  # 8 sig + 8 IHDR hdr + 4 W + 4 H + 1 depth
            if len(head) < 25:
                return False
            w = int.from_bytes(head[16:20], "big")
            h = int.from_bytes(head[20:24], "big")
            if (w, h, head[24]) != (width, height, bit_depth):
                return False
            f.seek(-8, os.SEEK_END)
            return f.read(8) == _PNG_IEND
    except OSError:
        return False


class RenderStatus(enum.Enum):
    IDLE = 0
    RENDERING = 1
    COMPLETE = 2
    CANCELLED = 3
    ERROR = 4


@dataclass
class RenderProgress:
    """animation_renderer.h:20-29."""

    status: RenderStatus = RenderStatus.IDLE
    current_frame: int = 0
    total_frames: int = 0
    progress: float = 0.0
    elapsed_time: float = 0.0
    estimated_time_remaining: float = 0.0
    current_status: str = ""


@dataclass
class _Group:
    cfg: common.StaticCfg
    frame_indices: List[int] = field(default_factory=list)
    dyns: List[dict] = field(default_factory=list)
    scenes: List[Scene] = field(default_factory=list)


def _static_key(scene: Scene, width: int, height: int, cap: int,
                device="cuda"):
    fam, conv, clamp = _FAMILY[scene.fractal_type]
    cfg = common.scene_static_cfg(scene, width, height, fam, conv, clamp,
                                  device=str(device))
    return dataclasses.replace(cfg, max_iter=cap)


def _write_frame(path: str, img: torch.Tensor, bit_depth: int) -> None:
    png.write_png(path, to_export_orientation(img).numpy(),
                  bit_depth=bit_depth)


class AnimationRenderer:
    """Drives interpolate → batched render → PNG sequence (and optionally
    video encode) on ``device``.  Not thread-safe; poll ``progress`` from
    callbacks."""

    def __init__(self, batch_size: int = 8, device="cuda", mesh=None):
        """``mesh``: a parallel.RenderMesh with ('frames', 'rows') axes (see
        parallel.make_render_mesh) — 2D-family frame batches then render
        data-parallel across its devices via render_frames_sharded instead
        of one after another on ``device``."""
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.mesh = mesh
        self.progress = RenderProgress()
        self._cancel = False
        self.on_frame_complete: Optional[Callable[[int, int], None]] = None
        self.on_render_complete: Optional[Callable[[str], None]] = None
        self.on_render_error: Optional[Callable[[str], None]] = None

    def cancel_render(self):
        self._cancel = True

    def is_rendering(self) -> bool:
        return self.progress.status == RenderStatus.RENDERING

    # ------------------------------------------------------------------
    def start_render(self, animation: Animation, output_folder: str,
                     width: Optional[int] = None,
                     height: Optional[int] = None,
                     bit_depth: int = 8, resume: bool = False) -> bool:
        """``resume=True`` skips frames whose PNG already exists complete
        in ``output_folder`` — checkpoint/resume for interrupted sequence
        renders (the reference restarts from frame zero,
        animation_renderer.cpp:75)."""
        if len(animation.keyframes) < 2:  # animation_renderer.cpp:37-43
            if self.on_render_error:
                self.on_render_error("Need at least 2 keyframes to render")
            return False

        width = width or animation.export_width
        height = height or animation.export_height
        total = animation.total_frames
        self.progress = RenderProgress(status=RenderStatus.RENDERING,
                                       total_frames=total,
                                       current_status="Initializing...")
        self._cancel = False
        os.makedirs(output_folder, exist_ok=True)
        start = _time.monotonic()

        # Interpolate every frame up front (pure host work, trivial cost)
        scenes = [animation.interpolate(animation.frame_time(f))
                  for f in range(total)]
        if not scenes:
            self.progress.status = RenderStatus.COMPLETE
            return True
        cap = max(s.max_iterations for s in scenes)
        skip = set()
        if resume:
            skip = {f for f in range(total) if _frame_complete(
                os.path.join(output_folder, f"frame_{f:06d}.png"),
                width, height, bit_depth)}

        # Mandelbulb / deep-zoom frames take the per-frame model path (3D
        # raymarch and perturbation don't fit the 2D batch pipeline).  A
        # .franim may mix families across keyframes (extra.fractal_type per
        # keyframe), so route per-frame if ANY frame is outside the 2D set.
        if any(s.fractal_type not in _FAMILY for s in scenes):
            from .. import models
            from ..scene import FractalType

            # Deep-zoom sequences share ONE reference orbit at the deepest
            # frame's center via the shift mechanism (plus a cache for any
            # repeats) instead of recomputing per frame.
            dz_scenes = [s for s in scenes
                         if s.fractal_type == FractalType.DEEP_ZOOM]
            dz_kw = {}
            if dz_scenes:
                from fractions import Fraction

                def _z(sc):
                    return abs(Fraction(str(sc.hp_zoom if sc.hp_zoom
                                             is not None else sc.zoom)))

                deepest = min(dz_scenes, key=_z)
                rcx = deepest.hp_center_x if deepest.hp_center_x is not None \
                    else repr(deepest.center_x)
                rcy = deepest.hp_center_y if deepest.hp_center_y is not None \
                    else repr(deepest.center_y)
                dz_kw = dict(ref_center=(str(rcx), str(rcy)),
                             orbit_cache={})

            for f, sc in enumerate(scenes):
                if self._cancel:
                    self.progress.status = RenderStatus.CANCELLED
                    return False
                if f in skip:
                    self.progress.current_frame = f
                    self.progress.progress = (f + 1) / total
                    continue
                if sc.fractal_type == FractalType.MANDELBULB:
                    # the reference drives the bulb's animation clock from
                    # the frame time (vk_engine render_animation_frame
                    # passes time into the dispatch)
                    sc = sc.with_(time=animation.frame_time(f))
                # frames quantize to the PNG bit depth on the device (same
                # expression as the PNG writer — byte-identical files,
                # 1-2 B/channel fetched instead of 4)
                kw = dz_kw if sc.fractal_type == FractalType.DEEP_ZOOM \
                    else {}
                img = models.render(sc, width, height, device=self.device,
                                    quantize=bit_depth, **kw).cpu()
                path = os.path.join(output_folder, f"frame_{f:06d}.png")
                _write_frame(path, img, bit_depth)
                self.progress.current_frame = f
                self.progress.progress = (f + 1) / total
                self.progress.elapsed_time = _time.monotonic() - start
                if self.on_frame_complete:
                    self.on_frame_complete(f, total)
            self.progress.status = RenderStatus.COMPLETE
            if self.on_render_complete:
                self.on_render_complete(output_folder)
            return True

        # Group consecutive frames by static config; palette switches /
        # toggle changes start a new group.
        groups: List[_Group] = []
        for f, s in enumerate(scenes):
            if f in skip:
                continue
            cfg = _static_key(s, width, height, cap, self.device)
            dyn = common.scene_dyn_params(s)
            if not groups or groups[-1].cfg != cfg:
                groups.append(_Group(cfg))
            groups[-1].frame_indices.append(f)
            groups[-1].dyns.append(dyn)
            groups[-1].scenes.append(s)

        done = len(skip)
        rendered_this_run = 0
        for g in groups:
            # batches quantize on the device (PNG-writer expression, so the
            # files are byte-identical) — a 1080p 8-frame batch fetches
            # 50 MB of uint8 instead of 200 MB of f32; fused configs come
            # back PLANAR (B, 3, H, W), skipping the device-side channel
            # interleave
            q = bit_depth if bit_depth in (8, 16) else 0
            planar = bool(q) and common.planar_export_ok(g.cfg)
            fn = None if self.mesh is not None else common.batch_render_fn(
                g.cfg, quantize=q, planar=planar)
            for i in range(0, len(g.dyns), self.batch_size):
                if self._cancel:
                    self.progress.status = RenderStatus.CANCELLED
                    return False
                chunk = g.dyns[i:i + self.batch_size]
                idxs = g.frame_indices[i:i + self.batch_size]
                if self.mesh is not None:
                    from ..parallel import render_frames_sharded

                    # padded to the batch size, as the JAX path pads it, so
                    # every chunk splits over the frame groups alike;
                    # quantized inside each band on its device, so the
                    # fetch moves uint bytes
                    sc = g.scenes[i:i + self.batch_size]
                    sc = sc + [sc[-1]] * (self.batch_size - len(sc))
                    imgs = render_frames_sharded(
                        sc, width, height, mesh=self.mesh, cap=cap,
                        quantize=q)[:len(chunk)]
                else:
                    # only the chunk's real frames: the JAX path pads the
                    # last chunk to keep one compiled shape, which the port
                    # has not
                    batch = {k: np.asarray([d[k] for d in chunk], np.float32)
                             for k in chunk[0]}
                    imgs = fn(batch).cpu()  # one fetch per chunk
                    if planar:  # (B, 3, H, W) -> (B, H, W, 3) on the host
                        imgs = imgs.permute(0, 2, 3, 1)
                for img, fidx in zip(imgs, idxs):
                    path = os.path.join(output_folder,
                                        f"frame_{fidx:06d}.png")
                    _write_frame(path, img, bit_depth)
                    done += 1
                    rendered_this_run += 1
                    self.progress.current_frame = fidx
                    self.progress.progress = done / total
                    self.progress.elapsed_time = _time.monotonic() - start
                    avg = self.progress.elapsed_time / rendered_this_run
                    self.progress.estimated_time_remaining = (
                        avg * (total - done))
                    self.progress.current_status = (
                        f"Rendering frame {done}/{total}")
                    if self.on_frame_complete:
                        self.on_frame_complete(fidx, total)

        self.progress.status = RenderStatus.COMPLETE
        self.progress.progress = 1.0
        if self.on_render_complete:
            self.on_render_complete(output_folder)
        return True

    # ------------------------------------------------------------------
    def render_and_encode(self, animation: Animation, output_folder: str,
                          video_settings=None,
                          width: Optional[int] = None,
                          height: Optional[int] = None,
                          resume: bool = False) -> bool:
        """animation_renderer.cpp:155-189 — render frames then chain into
        the video encoder."""
        from . import video

        if not self.start_render(animation, output_folder, width, height,
                                 resume=resume):
            return False
        settings = video_settings or video.VideoEncodeSettings(
            output_filename=os.path.join(output_folder, "animation.mp4"),
            fps=animation.target_fps)
        enc = video.VideoEncoder()
        return enc.encode(output_folder, settings)


def render_animation_frames(animation: Animation,
                            frames: Optional[List[int]] = None,
                            width: Optional[int] = None,
                            height: Optional[int] = None,
                            device="cuda") -> torch.Tensor:
    """Render selected frames to an (N, H, W, 3) f32 tensor on ``device``
    (no disk IO) — handy for tests and notebooks."""
    width = width or animation.export_width
    height = height or animation.export_height
    total = animation.total_frames
    frames = list(range(total)) if frames is None else frames
    scenes = [animation.interpolate(animation.frame_time(f)) for f in frames]
    cap = max(s.max_iterations for s in scenes)
    out = torch.empty((len(scenes), height, width, 3), dtype=torch.float32,
                      device=device)
    for i, s in enumerate(scenes):
        cfg = _static_key(s, width, height, cap, device)
        common.band_render_fn(cfg, height, height)(
            common.scene_dyn_params(s), 0, out=out[i])
    return out
