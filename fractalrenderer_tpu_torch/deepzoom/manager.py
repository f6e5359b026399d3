"""Deep-zoom session manager (the port's copy of
``fractalrenderer_tpu/deepzoom/manager.py``, framework-free) — port of
DeepZoomManager / DeepZoomState (src/deep_zoom_system.{h,cpp}) minus the
Vulkan buffer plumbing (the orbit upload is just an array handed to the
perturbation kernel here).

Covers: precision-mode escalation, zoom-depth levels, render-time estimate,
zoom-path keyframe animation with log-space zoom interpolation, coordinate
export, and the three preset zoom targets.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..presets import DEEP_ZOOM_PRESETS, ZoomTarget
from ..scene import Scene
from . import orbit as orbit_mod
from .hp import PrecisionMode, precision_mode_for_zoom


@dataclass
class ZoomKeyframe:
    """deep_zoom_system.h ZoomKeyframe."""

    center_x: float
    center_y: float
    zoom: float
    duration: float = 5.0


@dataclass
class DeepZoomState:
    """deep_zoom_system.h:94-125."""

    center_x: float = -0.5
    center_y: float = 0.0
    zoom: float = 2.0
    max_iterations: int = 1000
    use_perturbation: bool = True
    use_series_approximation: bool = False
    series_order: int = 3
    samples_per_pixel: int = 1
    precision_mode: PrecisionMode = PrecisionMode.DOUBLE
    precision_bits: int = 64
    high_precision_enabled: bool = False
    reference_iterations: int = 0
    zoom_depth_level: int = 0
    estimated_render_time: float = 0.0
    zoom_animating: bool = False
    zoom_progress: float = 0.0
    # high-precision coordinate strings (when zooming past f64)
    hp_center_x: Optional[str] = None
    hp_center_y: Optional[str] = None


class DeepZoomManager:
    """Functional-core equivalent of the reference manager: owns a
    DeepZoomState, computes/caches the reference orbit, and drives zoom-path
    animation."""

    def __init__(self, state: Optional[DeepZoomState] = None):
        self.state = state or DeepZoomState()
        self.reference_orbit: Optional[np.ndarray] = None
        self._zoom_path: List[ZoomKeyframe] = []
        self._current_keyframe = 0
        self._animation_time = 0.0

    # ------------------------------------------------------------------
    def update_precision_mode(self) -> None:
        """deep_zoom_system.cpp:226-260."""
        mode, bits = precision_mode_for_zoom(self.state.zoom)
        self.state.precision_mode = mode
        self.state.precision_bits = bits
        self.state.high_precision_enabled = mode != PrecisionMode.DOUBLE

    def update(self, delta_time: float) -> None:
        """deep_zoom_system.cpp:178-203 — depth level + render estimate."""
        if self.state.zoom_animating:
            self._update_animation(delta_time)
        z = self.state.zoom
        if z > 1e-6:
            self.state.zoom_depth_level = 0
        elif z > 1e-10:
            self.state.zoom_depth_level = 1
        elif z > 1e-14:
            self.state.zoom_depth_level = 2
        else:
            self.state.zoom_depth_level = 3
        self.state.estimated_render_time = (
            self.state.max_iterations * 0.001 * self.state.samples_per_pixel
            * (1.0 + self.state.zoom_depth_level * 0.5))

    def compute_reference_orbit(self, force_python: bool = False
                                ) -> Optional[np.ndarray]:
        """deep_zoom_system.cpp:363-448."""
        if not self.state.use_perturbation:
            return None
        self.update_precision_mode()
        cx = self.state.hp_center_x or self.state.center_x
        cy = self.state.hp_center_y or self.state.center_y
        self.reference_orbit = orbit_mod.compute_orbit(
            cx, cy, self.state.precision_bits, self.state.max_iterations,
            force_python=force_python)
        self.state.reference_iterations = len(self.reference_orbit)
        return self.reference_orbit

    # -- zoom animation (deep_zoom_system.cpp:454-559) -------------------
    def play_zoom_path(self, path: List[ZoomKeyframe]) -> None:
        self._zoom_path = list(path)
        self._current_keyframe = 0
        self._animation_time = 0.0
        self.state.zoom_animating = bool(path)
        self.state.zoom_progress = 0.0

    def zoom_to(self, target_x: float, target_y: float, target_zoom: float,
                duration: float = 5.0) -> None:
        start = ZoomKeyframe(self.state.center_x, self.state.center_y,
                             self.state.zoom, 0.0)
        end = ZoomKeyframe(target_x, target_y, target_zoom, duration)
        self.play_zoom_path([start, end])

    def play_preset(self, target: ZoomTarget) -> None:
        self.zoom_to(target.center_x, target.center_y, target.zoom,
                     target.duration)

    def _update_animation(self, delta_time: float) -> None:
        if not self._zoom_path or self._current_keyframe >= len(self._zoom_path):
            self.state.zoom_animating = False
            return
        self._animation_time += delta_time
        kf = self._zoom_path[self._current_keyframe]
        if self._animation_time >= kf.duration:
            self.state.center_x = kf.center_x
            self.state.center_y = kf.center_y
            self.state.zoom = kf.zoom
            self._current_keyframe += 1
            self._animation_time = 0.0
            self.compute_reference_orbit()
            if self._current_keyframe >= len(self._zoom_path):
                self.state.zoom_animating = False
                self.state.zoom_progress = 1.0
        else:
            t = self._animation_time / kf.duration
            self._interpolate_to_keyframe(self._current_keyframe, t)
            total = sum(k.duration for k in self._zoom_path)
            elapsed = sum(k.duration
                          for k in self._zoom_path[:self._current_keyframe])
            elapsed += self._animation_time
            self.state.zoom_progress = elapsed / total if total > 0 else 1.0

    def _interpolate_to_keyframe(self, index: int, t: float) -> None:
        """Linear center, log-space zoom (deep_zoom_system.cpp:536-559)."""
        if index <= 0 or index >= len(self._zoom_path):
            return
        prev = self._zoom_path[index - 1]
        cur = self._zoom_path[index]
        self.state.center_x = prev.center_x + t * (cur.center_x - prev.center_x)
        self.state.center_y = prev.center_y + t * (cur.center_y - prev.center_y)
        lp, lc = math.log(prev.zoom), math.log(cur.zoom)
        self.state.zoom = math.exp(lp + t * (lc - lp))

    # ------------------------------------------------------------------
    def export_coordinates(self) -> str:
        """deep_zoom_system.cpp:561-569.  High-precision strings win over
        the f64 fields when present — past ~1e-16 the f64 round-trip would
        not reproduce the view (and past ~1e-308 the float zoom is 0)."""
        cx = self.state.hp_center_x \
            if getattr(self.state, "hp_center_x", None) else \
            f"{self.state.center_x:.17e}"
        cy = self.state.hp_center_y \
            if getattr(self.state, "hp_center_y", None) else \
            f"{self.state.center_y:.17e}"
        zm = self.state.hp_zoom \
            if getattr(self.state, "hp_zoom", None) else \
            f"{self.state.zoom:.17e}"
        return (f"Center X: {cx}\n"
                f"Center Y: {cy}\n"
                f"Zoom: {zm}\n"
                f"Iterations: {self.state.max_iterations}\n")

    def to_scene(self, base: Optional[Scene] = None) -> Scene:
        from ..scene import FractalType

        s = base or Scene()
        return s.with_(
            fractal_type=FractalType.DEEP_ZOOM,
            center_x=self.state.center_x, center_y=self.state.center_y,
            zoom=self.state.zoom, max_iterations=self.state.max_iterations,
            use_perturbation=self.state.use_perturbation,
            samples_per_pixel=self.state.samples_per_pixel,
            hp_center_x=self.state.hp_center_x,
            hp_center_y=self.state.hp_center_y,
        )


def preset_zoom_path(name: str) -> List[ZoomKeyframe]:
    """The three preset zoom sequences (deep_zoom_system.cpp:575-602)."""
    for tgt in DEEP_ZOOM_PRESETS:
        if tgt.name.lower().startswith(name.lower()):
            return [ZoomKeyframe(-0.5, 0.0, 2.0, 0.0),
                    ZoomKeyframe(tgt.center_x, tgt.center_y, tgt.zoom,
                                 tgt.duration)]
    raise KeyError(name)
