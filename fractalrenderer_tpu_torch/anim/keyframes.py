"""Keyframe timeline and interpolation — port of src/animation_system.{h,cpp}.

The reference mutates a shared FractalState from a playback clock; here the
timeline is data and ``interpolate(animation, t) -> Scene`` is a pure
function, which is what lets frames render as batches (anim/renderer.py).

Interpolation semantics (animation_system.cpp:82-181):
- linear center, log-space zoom (:131-145), stepped max_iterations
  (:147-161: t<0.33 → key1, <0.67 → midpoint, else key2), linear color
  params, palette switch at t=0.5, easing chosen by the *second* keyframe.
- bailout / AA / orbit trap are taken from key1 (:175-178).

One deliberate deviation: the reference builds the result from a
default-constructed FractalState, which silently resets fields it does not
interpolate (julia c, phoenix p/r, stripe settings) to their defaults mid-
animation.  We inherit those fields from key1's scene instead, so animating
a Julia set keeps its c parameter.

The PyTorch port's own copy of ``fractalrenderer_tpu/anim/keyframes.py`` (that
package imports jax on import, so the port cannot share it); the two
stay line for line the same below this docstring.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple

from ..scene import Scene


class InterpolationType(enum.IntEnum):
    """animation_system.h:8-14."""

    LINEAR = 0
    EASE_IN_OUT = 1
    EASE_IN = 2
    EASE_OUT = 3
    EXPONENTIAL = 4


def _frac_log(fr) -> float:
    """ln of a positive Fraction whose magnitude may be far outside f64
    range: split off the power of two, log the [0.5, 2) mantissa."""
    e = fr.numerator.bit_length() - fr.denominator.bit_length()
    m = fr / (1 << e) if e >= 0 else fr * (1 << -e)
    return e * math.log(2.0) + math.log(float(m))


def ease_in_out(t: float) -> float:
    # animation_system.cpp:200-204
    return 2.0 * t * t if t < 0.5 else 1.0 - (-2.0 * t + 2.0) ** 2 / 2.0


def ease_in(t: float) -> float:
    return t * t


def ease_out(t: float) -> float:
    return 1.0 - (1.0 - t) * (1.0 - t)


def apply_easing(t: float, kind: InterpolationType) -> float:
    if kind == InterpolationType.EASE_IN_OUT:
        return ease_in_out(t)
    if kind == InterpolationType.EASE_IN:
        return ease_in(t)
    if kind == InterpolationType.EASE_OUT:
        return ease_out(t)
    if kind == InterpolationType.EXPONENTIAL:
        return t * t
    return t


@dataclass(frozen=True)
class Keyframe:
    time: float
    scene: Scene
    interp_type: InterpolationType = InterpolationType.EASE_IN_OUT


@dataclass
class Animation:
    """animation_system.h:24-35."""

    name: str = ""
    description: str = ""
    keyframes: List[Keyframe] = field(default_factory=list)
    duration: float = 10.0
    loop: bool = False
    target_fps: int = 60
    export_width: int = 1920
    export_height: int = 1080

    # -- keyframe management (animation_system.cpp:12-38) ---------------
    def add_keyframe(self, time: float, scene: Scene,
                     interp_type: InterpolationType = InterpolationType.EASE_IN_OUT
                     ) -> "Animation":
        self.keyframes.append(Keyframe(time, scene, interp_type))
        self.keyframes.sort(key=lambda k: k.time)
        if time > self.duration:
            self.duration = time + 1.0
        return self

    def remove_keyframe(self, index: int) -> None:
        if 0 <= index < len(self.keyframes):
            del self.keyframes[index]

    def update_keyframe(self, index: int, scene: Scene) -> None:
        if 0 <= index < len(self.keyframes):
            kf = self.keyframes[index]
            self.keyframes[index] = Keyframe(kf.time, scene, kf.interp_type)
            self.keyframes.sort(key=lambda k: k.time)

    def clear_keyframes(self) -> None:
        self.keyframes.clear()
        self.duration = 0.0

    @property
    def total_frames(self) -> int:
        # animation_renderer.cpp:48
        return int(self.duration * self.target_fps)

    def frame_time(self, frame: int) -> float:
        # animation_renderer.cpp:80
        return frame / float(self.target_fps)

    # -- interpolation ----------------------------------------------------
    def find_keyframe_pair(self, time: float) -> Tuple[int, int]:
        # animation_system.cpp:183-197; times before the first keyframe
        # take the FIRST segment (t clamps to 0 → hold the first scene),
        # times after the last take the last segment (t clamps to 1).
        kfs = self.keyframes
        if time <= kfs[0].time:
            return 0, 1
        for i in range(len(kfs) - 1):
            if kfs[i].time <= time <= kfs[i + 1].time:
                return i, i + 1
        return len(kfs) - 2, len(kfs) - 1

    def interpolate(self, time: float,
                    fallback: Optional[Scene] = None) -> Scene:
        # animation_system.cpp:82-181
        kfs = self.keyframes
        if not kfs:
            return fallback if fallback is not None else Scene()
        if len(kfs) == 1:
            return kfs[0].scene
        time = min(max(time, 0.0), self.duration)
        i1, i2 = self.find_keyframe_pair(time)
        k1, k2 = kfs[i1], kfs[i2]

        dt = k2.time - k1.time
        if dt < 0.001:  # :96-100
            return k1.scene
        # clamp BEFORE easing: a timeline whose keyframes don't span
        # [0, duration] would otherwise extrapolate (eased t outside [0,1]
        # is non-monotonic, e.g. ease_in_out(1.5) = 0.5)
        t = min(max((time - k1.time) / dt, 0.0), 1.0)
        t = apply_easing(t, k2.interp_type)

        s1, s2 = k1.scene, k2.scene

        # zoom: log-space when both positive (:131-145)
        if s1.zoom > 0.0 and s2.zoom > 0.0:
            zoom = math.exp(math.log(s1.zoom)
                            + t * (math.log(s2.zoom) - math.log(s1.zoom)))
        else:
            zoom = s1.zoom + t * (s2.zoom - s1.zoom)
        zoom = max(0.000001, zoom)

        # stepped iterations (:147-161)
        if t < 0.33:
            iter_t = 0.0
        elif t < 0.67:
            iter_t = 0.5
        else:
            iter_t = 1.0
        max_iterations = int(s1.max_iterations
                             + iter_t * (s2.max_iterations - s1.max_iterations))

        def lin(a, b):
            return a + t * (b - a)

        # High-precision view interpolation: deep-zoom scenes carry exact
        # decimal/fraction strings that the renderer PREFERS over the f64
        # fields — inheriting them unchanged from key1 would freeze every
        # frame at key1's view.  Centers lerp in exact rationals; zoom
        # interpolates in log space (f64 relative precision on the ratio —
        # the same relative precision the f64 path has).
        hp_fields = {}
        if any(v is not None for v in (
                s1.hp_center_x, s1.hp_center_y, s1.hp_zoom,
                s2.hp_center_x, s2.hp_center_y, s2.hp_zoom)):
            from fractions import Fraction

            tf = Fraction(t)

            def ends(hp1, hp2, f1, f2):
                a = Fraction(hp1) if hp1 is not None else Fraction(f1)
                b = Fraction(hp2) if hp2 is not None else Fraction(f2)
                return a, b

            x1, x2 = ends(s1.hp_center_x, s2.hp_center_x,
                          s1.center_x, s2.center_x)
            y1, y2 = ends(s1.hp_center_y, s2.hp_center_y,
                          s1.center_y, s2.center_y)
            z1, z2 = ends(s1.hp_zoom, s2.hp_zoom, s1.zoom, s2.zoom)
            hp_fields["hp_center_x"] = str(x1 + tf * (x2 - x1))
            hp_fields["hp_center_y"] = str(y1 + tf * (y2 - y1))
            if z1 > 0 and z2 > 0:
                # z_t = z1 * (z2/z1)^t, computed so only the RATIO (whose
                # magnitude is bounded by the keyframe span) goes through
                # floats — z1/z2 themselves may be far below f64 range
                ln_ratio = _frac_log(z2 / z1)
                e = t * ln_ratio / math.log(2.0)
                k = math.floor(e)
                zt = z1 * Fraction(2.0 ** (e - k))
                zt = zt * (1 << int(k)) if k >= 0 \
                    else zt / (1 << int(-k))
                hp_fields["hp_zoom"] = str(zt)
            else:
                hp_fields["hp_zoom"] = str(z1 + tf * (z2 - z1))

        return replace(
            s1,  # non-interpolated fields inherited from key1 (see docstring)
            center_x=lin(s1.center_x, s2.center_x),
            center_y=lin(s1.center_y, s2.center_y),
            zoom=zoom,
            max_iterations=max_iterations,
            color_offset=lin(s1.color_offset, s2.color_offset),
            color_scale=lin(s1.color_scale, s2.color_scale),
            color_brightness=lin(s1.color_brightness, s2.color_brightness),
            color_saturation=lin(s1.color_saturation, s2.color_saturation),
            color_contrast=lin(s1.color_contrast, s2.color_contrast),
            palette_mode=s1.palette_mode if t < 0.5 else s2.palette_mode,
            rotation_y=lin(s1.rotation_y, s2.rotation_y),
            camera_distance=lin(s1.camera_distance, s2.camera_distance),
            mandelbulb_power=lin(s1.mandelbulb_power, s2.mandelbulb_power),
            # bailout / AA / orbit trap from key1 (:175-178)
            bailout=s1.bailout,
            antialiasing_samples=s1.antialiasing_samples,
            orbit_trap_enabled=s1.orbit_trap_enabled,
            orbit_trap_radius=s1.orbit_trap_radius,
            **hp_fields,
        )


class Playback:
    """Interactive playback clock (animation_system.cpp:40-80) for driving a
    viewer or stepping through an animation without rendering."""

    def __init__(self, animation: Animation):
        self.animation = animation
        self.playing = False
        self.current_time = 0.0

    def play(self):
        if len(self.animation.keyframes) >= 2:
            self.playing = True

    def pause(self):
        self.playing = False

    def stop(self):
        self.playing = False
        self.current_time = 0.0

    def seek(self, time: float):
        self.current_time = min(max(time, 0.0), self.animation.duration)

    def update(self, delta_time: float) -> Optional[Scene]:
        if not self.playing or len(self.animation.keyframes) < 2:
            return None
        self.current_time += delta_time
        if self.current_time >= self.animation.duration:
            if self.animation.loop:
                self.current_time = math.fmod(self.current_time,
                                              self.animation.duration)
            else:
                self.current_time = self.animation.duration
                self.playing = False
        return self.animation.interpolate(self.current_time)
