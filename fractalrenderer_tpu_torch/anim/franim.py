"""`.franim` JSON animation files, format-compatible with the reference
(animation_system.cpp:221-313; sample file FractalRenderer/.franim).

The reference serializes exactly these keyframe fields: time, interp_type,
center_x/y, zoom, max_iterations, palette_mode, color_offset/scale,
color_brightness/saturation/contrast, rotation_y, camera_distance,
mandelbulb_power, bailout, antialiasing_samples, orbit_trap_enabled,
orbit_trap_radius — we write the same set (so our files load in the
reference) plus an optional ``extra`` block with fields the reference does
not persist (fractal type, julia c, phoenix p/r, …), which the reference's
nlohmann parser ignores.

The PyTorch port's own copy of ``fractalrenderer_tpu/anim/franim.py`` (that
package imports jax on import, so the port cannot share it); the two
stay line for line the same below this docstring, so a ``.franim`` written
by either package loads in the other.
"""
from __future__ import annotations

import json

from ..scene import Scene
from .keyframes import Animation, InterpolationType, Keyframe

_REFERENCE_FIELDS = (
    "center_x", "center_y", "zoom", "max_iterations", "palette_mode",
    "color_offset", "color_scale", "color_brightness", "color_saturation",
    "color_contrast", "rotation_y", "camera_distance", "mandelbulb_power",
    "bailout", "antialiasing_samples", "orbit_trap_enabled",
    "orbit_trap_radius",
)

_EXTRA_FIELDS = (
    "fractal_type", "julia_c_real", "julia_c_imag", "phoenix_p", "phoenix_r",
    "use_julia_set", "interior_style", "stripe_enabled", "stripe_density",
    # deep-zoom state: the hp strings are the authoritative view past f64
    # precision — dropping them would collapse a reloaded deep animation
    # onto the (rounded) f64 coordinates
    "hp_center_x", "hp_center_y", "hp_zoom", "use_perturbation",
    "use_series_approximation", "deep_zoom_julia", "deep_zoom_ship",
    "deep_zoom_phoenix",
)


def animation_to_dict(anim: Animation) -> dict:
    d = {
        "name": anim.name,
        "description": anim.description,
        "duration": anim.duration,
        "loop": anim.loop,
        "target_fps": anim.target_fps,
        "export_width": anim.export_width,
        "export_height": anim.export_height,
        "keyframes": [],
    }
    for kf in anim.keyframes:
        sd = kf.scene.to_dict()
        kd = {"time": kf.time, "interp_type": int(kf.interp_type)}
        for f in _REFERENCE_FIELDS:
            kd[f] = sd[f]
        extra = {f: sd[f] for f in _EXTRA_FIELDS if f in sd}
        if extra:
            kd["extra"] = extra
        d["keyframes"].append(kd)
    return d


def animation_from_dict(d: dict) -> Animation:
    # Untrusted input: structural surprises must be ValueError (the
    # caller surfaces it as a message), never an AttributeError from
    # deep inside — the reference's nlohmann parse throws the analog
    # (animation_system.cpp:272-313 wraps load in try/catch).
    if not isinstance(d, dict):
        raise ValueError(
            f".franim JSON must be an object, got {type(d).__name__}")
    kfs = d.get("keyframes", [])
    if not isinstance(kfs, list) \
            or not all(isinstance(k, dict) for k in kfs):
        raise ValueError(".franim 'keyframes' must be a list of objects")
    try:
        anim = Animation(
            name=str(d.get("name", "")),
            description=str(d.get("description", "")),
            duration=float(d.get("duration", 10.0)),
            loop=bool(d.get("loop", False)),
            target_fps=int(d.get("target_fps", 60)),
            export_width=int(d.get("export_width", 1920)),
            export_height=int(d.get("export_height", 1080)),
        )
        for kd in kfs:
            extra = kd.get("extra", {})
            if not isinstance(extra, dict):
                raise ValueError(".franim keyframe 'extra' must be an "
                                 "object")
            # Scene.from_dict validates field names and value types
            # (and parses extra's fractal_type string)
            scene = Scene.from_dict(
                {**{f: kd[f] for f in _REFERENCE_FIELDS if f in kd},
                 **extra})
            anim.keyframes.append(Keyframe(
                time=float(kd["time"]),
                scene=scene,
                interp_type=InterpolationType(
                    int(kd.get("interp_type", 1))),
            ))
    except KeyError as e:
        raise ValueError(f".franim keyframe missing field {e}") from None
    except TypeError as e:
        raise ValueError(f"malformed .franim value: {e}") from None
    anim.keyframes.sort(key=lambda k: k.time)
    return anim


def save(anim: Animation, path: str) -> None:
    with open(path, "w") as f:
        json.dump(animation_to_dict(anim), f, indent=4, sort_keys=True)


def load(path: str) -> Animation:
    with open(path) as f:
        return animation_from_dict(json.load(f))
