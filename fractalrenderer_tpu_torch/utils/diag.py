"""Scene diagnostics (the port's counterpart of the framework-free half of
``fractalrenderer_tpu/utils/diag.py``):

- scene_debug_summary: debug_print_fractal_state (vk_engine.h:198-214)
- validate_scene: the NaN/zero repair clamps the reference applies while
  packing push constants (compute_effect_manager.h:335-345)
"""
from __future__ import annotations

import math

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
