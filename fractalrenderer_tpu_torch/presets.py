"""Curated preset locations and parameter tables (the PyTorch port's copy of
``fractalrenderer_tpu/presets.py``).

Ports every preset table in the reference:
- Mandelbrot/Burning Ship location presets: src/fractal_state.h:171-189
- Julia c-parameter presets: src/ui_manager.cpp:1255-1260
- Mandelbulb power presets: src/ui_manager.cpp:1319-1324
- Phoenix p/r presets: src/ui_manager.cpp:1405-1410
- Deep-zoom targets: src/deep_zoom_system.cpp:575-602
- Print-size presets: src/ui_manager.cpp:595-611
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from .scene import FractalType, Scene


@dataclass(frozen=True)
class LocationPreset:
    name: str
    fractal_type: FractalType
    center_x: float
    center_y: float
    zoom: float
    iterations: int

    def apply(self, scene: Scene) -> Scene:
        return scene.with_(
            fractal_type=self.fractal_type,
            center_x=self.center_x,
            center_y=self.center_y,
            zoom=self.zoom,
            max_iterations=self.iterations,
        )


MANDELBROT_PRESETS = (
    LocationPreset("Overview", FractalType.MANDELBROT, -0.5, 0.0, 2.5, 256),
    LocationPreset("Seahorse Valley", FractalType.MANDELBROT,
                   -0.743643887037151, 0.13182590420533, 0.008, 1024),
    LocationPreset("Elephant Valley", FractalType.MANDELBROT, 0.257, 0.0, 0.015, 768),
    LocationPreset("Triple Spiral", FractalType.MANDELBROT, -0.088, 0.654, 0.02, 512),
    LocationPreset("Mini Mandelbrot", FractalType.MANDELBROT, -1.7497, 0.00001, 0.0005, 1024),
    LocationPreset("Spiral Galaxy", FractalType.MANDELBROT, -0.7453, 0.1127, 0.01, 768),
)

BURNING_SHIP_PRESETS = (
    LocationPreset("The Main Ship", FractalType.BURNING_SHIP, -0.5, -0.6, 2.0, 256),
    LocationPreset("The Bow", FractalType.BURNING_SHIP, -1.755, -0.03, 0.02, 768),
    LocationPreset("Ship Antenna", FractalType.BURNING_SHIP, -1.7497, -0.0375, 0.005, 1024),
    LocationPreset("Crystal Cavern", FractalType.BURNING_SHIP, -1.7540, -0.0280, 0.015, 768),
    LocationPreset("Deep Tendrils", FractalType.BURNING_SHIP, -1.749, 0.0, 0.001, 1536),
)

# Julia c presets (src/ui_manager.cpp:1255-1260)
JULIA_PRESETS: Dict[str, Tuple[float, float]] = {
    "Dendritic": (-0.4, 0.6),
    "Siegel Disk": (-0.391, -0.587),
    "Douady's Rabbit": (-0.123, 0.745),
    "San Marco": (-0.75, 0.0),
}

# Mandelbulb power presets (src/ui_manager.cpp:1319-1324)
MANDELBULB_POWER_PRESETS: Dict[str, float] = {
    "Classic (8)": 8.0,
    "Smooth (4)": 4.0,
    "Spiky (12)": 12.0,
    "Extreme (16)": 16.0,
}

# Phoenix (p, r) presets (src/ui_manager.cpp:1405-1410)
PHOENIX_PRESETS: Dict[str, Tuple[float, float]] = {
    "Classic Phoenix": (0.0, -0.5),
    "Swirl": (0.2, -0.3),
    "Tendrils": (-0.1, -0.8),
    "Chaos": (0.3, -0.6),
}


@dataclass(frozen=True)
class ZoomTarget:
    """A deep-zoom destination (src/deep_zoom_system.h ZoomKeyframe)."""

    name: str
    center_x: float
    center_y: float
    zoom: float
    duration: float


# src/deep_zoom_system.cpp:575-602
DEEP_ZOOM_PRESETS = (
    ZoomTarget("Seahorse Valley Deep", -0.743643887037151, 0.13182590420533, 1e-6, 5.0),
    ZoomTarget("Elephant Valley Deep", -0.7453526, 0.1133189, 1e-8, 7.0),
    ZoomTarget("Mini Mandelbrot Deep", -0.74364990, 0.13188204, 1e-10, 10.0),
)

# Print-size presets at 300 DPI (src/ui_manager.cpp:595-611)
PRINT_SIZE_PRESETS: Dict[str, Tuple[int, int]] = {
    "8x10 @ 300 DPI": (2400, 3000),
    "11x14 @ 300 DPI": (3300, 4200),
    "16x20 @ 300 DPI": (4800, 6000),
    "24x36 @ 300 DPI": (7200, 10800),
    "40x60 @ 300 DPI": (12000, 18000),
}

# Animation export resolution presets (src/ui_manager.cpp:1040-1058)
RESOLUTION_PRESETS: Dict[str, Tuple[int, int]] = {
    "1080p": (1920, 1080),
    "1440p": (2560, 1440),
    "4K": (3840, 2160),
    "720p": (1280, 720),
}


def find_preset(name: str) -> LocationPreset:
    key = name.strip().lower()
    for p in MANDELBROT_PRESETS + BURNING_SHIP_PRESETS:
        if p.name.lower() == key:
            return p
    raise KeyError(f"no preset named {name!r}")
