"""Functional scene description — the replacement for the reference's
mutable ``FractalState`` (reference: src/fractal_state.h:16-162).

The PyTorch port's own copy of ``fractalrenderer_tpu/scene.py`` (that package
imports jax on import, so the port cannot share it); the two must stay
field-for-field identical so a scene JSON written by either loads in the
other.

The reference keeps one mutable struct that the UI pokes at and a dirty flag to
trigger re-renders.  Here the scene is a frozen dataclass: rendering is a pure
function of (scene, width, height) and re-rendering is just another call.

Field defaults mirror src/fractal_state.h:18-91 exactly so that a user of the
reference gets identical first-render output.
"""
from __future__ import annotations

import dataclasses
import enum
import json
from dataclasses import dataclass, replace
from typing import Optional


class FractalType(enum.Enum):
    """Mirrors the reference enum (src/fractal_state.h:6-14)."""

    MANDELBROT = 0
    JULIA = 1
    BURNING_SHIP = 2
    MANDELBULB = 3
    PHOENIX = 4
    DEEP_ZOOM = 5

    @property
    def display_name(self) -> str:
        # src/fractal_state.h:156-161
        return {
            FractalType.MANDELBROT: "Mandelbrot",
            FractalType.JULIA: "Julia Set",
            FractalType.BURNING_SHIP: "Burning Ship",
            FractalType.MANDELBULB: "Mandelbulb",
            FractalType.PHOENIX: "Phoenix",
            FractalType.DEEP_ZOOM: "Deep_Zoom",
        }[self]

    @staticmethod
    def parse(name: str) -> "FractalType":
        key = name.strip().lower().replace("-", "_").replace(" ", "_")
        aliases = {
            "mandelbrot": FractalType.MANDELBROT,
            "julia": FractalType.JULIA,
            "julia_set": FractalType.JULIA,
            "burning_ship": FractalType.BURNING_SHIP,
            "burningship": FractalType.BURNING_SHIP,
            "mandelbulb": FractalType.MANDELBULB,
            "phoenix": FractalType.PHOENIX,
            "deep_zoom": FractalType.DEEP_ZOOM,
            "deepzoom": FractalType.DEEP_ZOOM,
        }
        if key not in aliases:
            raise ValueError(f"unknown fractal type: {name!r}")
        return aliases[key]


class InteriorStyle(enum.IntEnum):
    """Interior coloring styles (shaders/mandelbrot.comp:182-188,
    shaders/burning_ship.comp:259-292)."""

    DEFAULT = 0       # mandelbrot: palette at t; burning ship: black
    BLACK = 1         # mandelbrot: black; burning ship: orbit-trap coloring
    TRAP_GLOW = 2     # mandelbrot: trap glow; burning ship: stripe coloring
    DISTANCE = 3      # burning ship: distance estimate


@dataclass(frozen=True)
class Scene:
    """Complete, immutable description of one fractal frame.

    Defaults follow src/fractal_state.h:18-91.  ``center_*``/``zoom`` are
    Python floats (doubles) like the reference; kernels consume them in f32
    (the reference's shaders receive vec4 f32 push constants too —
    src/compute_effect_manager.h:11-17), while the deep-zoom path splits them
    into double-double hi/lo pairs.
    """

    fractal_type: FractalType = FractalType.MANDELBROT

    # View (src/fractal_state.h:18-21)
    center_x: float = -0.5
    center_y: float = 0.0
    zoom: float = 3.0
    max_iterations: int = 256

    # 3D camera (src/fractal_state.h:24-26)
    camera_distance: float = 3.0
    rotation_y: float = 0.0
    fov: float = 1.0

    # Julia (src/fractal_state.h:29-30)
    julia_c_real: float = -0.7
    julia_c_imag: float = 0.27015

    # Mandelbulb (src/fractal_state.h:33)
    mandelbulb_power: float = 8.0

    # Rendering (src/fractal_state.h:36-37)
    bailout: float = 4.0
    antialiasing_samples: int = 1

    # Coloring (src/fractal_state.h:40-44)
    palette_mode: int = 0
    color_offset: float = 0.0
    color_scale: float = 1.0

    # Advanced effects (src/fractal_state.h:47-52)
    interior_style: int = 0
    orbit_trap_enabled: bool = False
    orbit_trap_radius: float = 0.5
    stripe_enabled: bool = False
    stripe_density: float = 10.0

    # Color enhancement (src/fractal_state.h:77-79)
    color_brightness: float = 1.0
    color_saturation: float = 1.0
    color_contrast: float = 1.0

    # Phoenix (src/fractal_state.h:82-84)
    phoenix_p: float = 0.0
    phoenix_r: float = -0.5
    use_julia_set: bool = False

    # Deep zoom (src/fractal_state.h:87-91)
    # deep_zoom_julia (beyond reference): deep-zoom the Julia set of
    # (julia_c_real, julia_c_imag) — the reference only deep-zooms the
    # Mandelbrot set
    deep_zoom_julia: bool = False
    # deep_zoom_ship (beyond reference): deep-zoom the Burning Ship via
    # diffabs perturbation
    deep_zoom_ship: bool = False
    # deep_zoom_phoenix (beyond reference): deep-zoom the Phoenix set via
    # two-term-recurrence perturbation (uses phoenix_p / phoenix_r)
    deep_zoom_phoenix: bool = False
    use_perturbation: bool = False
    reference_iterations: int = 0
    use_series_approximation: bool = False
    series_order: int = 3
    samples_per_pixel: int = 1

    # Mandelbulb animation clock (shader `time` input)
    time: float = 0.0

    # High-precision coordinates as decimal strings (replaces the reference's
    # embedded MPFR HighPrecisionCoords, src/fractal_state.h:96-132).  When
    # set, the deep-zoom path parses these with arbitrary precision instead of
    # the double-valued center_x/center_y/zoom.
    hp_center_x: Optional[str] = None
    hp_center_y: Optional[str] = None
    hp_zoom: Optional[str] = None

    # ------------------------------------------------------------------
    def with_(self, **kw) -> "Scene":
        return replace(self, **kw)

    def reset(self) -> "Scene":
        """Default Mandelbrot view (src/fractal_state.h:135-153).

        Note the reference's reset() sets zoom=1.5 (not the construction
        default 3.0) — mirrored here.
        """
        return self.with_(
            center_x=-0.5, center_y=0.0, zoom=1.5, max_iterations=256,
            camera_distance=3.0, rotation_y=0.0,
            color_brightness=1.0, color_saturation=1.0, color_contrast=1.0,
            hp_center_x=None, hp_center_y=None, hp_zoom=None,
        )

    # -- camera helpers (replace the reference's input-handler math) ----
    def zoomed(self, zoom_in: bool) -> "Scene":
        """Wheel zoom + auto-iteration scaling (src/vk_engine.cpp:1731-1756)."""
        factor = 0.8 if zoom_in else 1.25
        zoom = self.zoom * factor
        return self.with_(zoom=zoom, max_iterations=_auto_iterations_wheel(zoom))

    def zoom_to_point(self, px: float, py: float, width: int, height: int,
                      zoom_in: bool) -> "Scene":
        """Zoom keeping the world point under (px, py) fixed
        (src/vk_engine.cpp:1758-1794)."""
        if width == 0 or height == 0:
            return self
        aspect = width / height
        nx = px / width - 0.5
        ny = py / height - 0.5
        wx = self.center_x + nx * self.zoom * aspect
        wy = self.center_y + ny * self.zoom
        factor = 0.7 if zoom_in else 1.4
        zoom = self.zoom * factor
        return self.with_(
            zoom=zoom,
            center_x=wx - nx * zoom * aspect,
            center_y=wy - ny * zoom,
            max_iterations=_auto_iterations_point(zoom),
        )

    # -- high-precision camera (beyond the reference: its navigation math
    # is f64, so interactive moves die at ~1e-15; these operate on the hp
    # decimal strings with exact rationals, valid at ANY depth) ----------
    def _hp_coords_frac(self):
        from fractions import Fraction

        cx = Fraction(str(self.hp_center_x)) if self.hp_center_x is not None \
            else Fraction(repr(self.center_x))
        cy = Fraction(str(self.hp_center_y)) if self.hp_center_y is not None \
            else Fraction(repr(self.center_y))
        zm = Fraction(str(self.hp_zoom)) if self.hp_zoom is not None \
            else Fraction(repr(self.zoom))
        return cx, cy, zm

    @staticmethod
    def _frac_str(fr, digits: int) -> str:
        sign = "-" if fr < 0 else ""
        fr = abs(fr)
        ip = fr.numerator // fr.denominator
        rem = fr - ip
        dec = (rem.numerator * 10 ** digits) // rem.denominator
        return f"{sign}{ip}.{str(dec).zfill(digits)}"

    @staticmethod
    def _hp_digits(zoom_fr) -> int:
        # enough decimal places for dd-relative precision at depth
        if zoom_fr == 0:
            return 40
        d = (abs(zoom_fr.denominator).bit_length()
             - abs(zoom_fr.numerator).bit_length())
        return max(40, int(d * 0.30103) + 25)

    def hp_zoomed(self, zoom_in: bool) -> "Scene":
        """Exact-rational wheel zoom about the center — deep-zoom-safe
        variant of zoomed()."""
        from fractions import Fraction

        cx, cy, zm = self._hp_coords_frac()
        zm = zm * (Fraction(4, 5) if zoom_in else Fraction(5, 4))
        digs = self._hp_digits(zm)
        zf = float(zm) if zm < Fraction(10) ** 300 else 0.0
        return self.with_(
            hp_center_x=self._frac_str(cx, digs),
            hp_center_y=self._frac_str(cy, digs),
            hp_zoom=self._frac_str(zm, digs),
            zoom=(zf if zf > 0 else self.zoom),
            max_iterations=max(self.max_iterations,
                               _auto_iterations_wheel(zf if zf > 0
                                                      else 0.0)))

    def hp_panned(self, vx: float, vy: float) -> "Scene":
        """Exact-rational pan by VIEW-relative offsets (center +=
        zoom * v) — the deep-zoom-safe variant of a float center shift;
        at depths below f64 range the float zoom is 0 and a plain
        center_x += pan silently stops moving."""
        from fractions import Fraction

        cx, cy, zm = self._hp_coords_frac()
        cx += zm * Fraction(repr(float(vx)))
        cy += zm * Fraction(repr(float(vy)))
        digs = self._hp_digits(zm)
        fx, fy = float(cx), float(cy)
        return self.with_(
            hp_center_x=self._frac_str(cx, digs),
            hp_center_y=self._frac_str(cy, digs),
            center_x=fx, center_y=fy)

    def hp_zoom_to_point(self, px: float, py: float, width: int,
                         height: int, zoom_in: bool) -> "Scene":
        """Zoom keeping the world point under (px, py) fixed, in exact
        rationals over the DEEP-ZOOM mapping (view spans 4*zoom
        vertically; dc = zoom*4/h^2 * (p - size/2))."""
        from fractions import Fraction

        if width == 0 or height == 0:
            return self
        cx, cy, zm = self._hp_coords_frac()
        step = zm * 4 / (height * height)
        nxp = Fraction(px) - Fraction(width, 2)
        nyp = Fraction(py) - Fraction(height, 2)
        wx = cx + step * nxp
        wy = cy + step * nyp
        f = Fraction(7, 10) if zoom_in else Fraction(7, 5)
        zm2 = zm * f
        step2 = zm2 * 4 / (height * height)
        cx2 = wx - step2 * nxp
        cy2 = wy - step2 * nyp
        digs = self._hp_digits(zm2)
        zf = float(zm2) if zm2 < Fraction(10) ** 300 else 0.0
        return self.with_(
            hp_center_x=self._frac_str(cx2, digs),
            hp_center_y=self._frac_str(cy2, digs),
            hp_zoom=self._frac_str(zm2, digs),
            zoom=(zf if zf > 0 else self.zoom),
            max_iterations=max(self.max_iterations,
                               _auto_iterations_point(zf if zf > 0
                                                      else 0.0)))

    # -- (de)serialization ----------------------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fractal_type"] = self.fractal_type.name.lower()
        return {k: v for k, v in d.items() if v is not None}

    @staticmethod
    def from_dict(d: dict) -> "Scene":
        """Construct from untrusted JSON data: unknown fields and
        wrong-typed values (e.g. an object where a float belongs) raise
        ValueError here instead of a shape/type error deep inside a
        later render (the reference validates its parsed inputs the same
        way, ui_manager.cpp:100-129)."""
        if not isinstance(d, dict):
            raise ValueError(
                f"scene JSON must be an object, got {type(d).__name__}")
        d = dict(d)
        if "fractal_type" in d:
            d["fractal_type"] = FractalType.parse(str(d["fractal_type"]))
        fields = {f.name: f.type for f in dataclasses.fields(Scene)}
        unknown = set(d) - set(fields)
        if unknown:
            raise ValueError(f"unknown scene fields: {sorted(unknown)}")
        for k, v in d.items():
            t = fields[k]
            try:
                if t == "float":
                    d[k] = float(v)
                elif t == "int":
                    d[k] = int(v)
                elif t == "bool":
                    d[k] = bool(v)
                elif "str" in t and v is not None \
                        and not isinstance(v, str):
                    # hp fields: numbers are fine (stringified), anything
                    # structured is not
                    if isinstance(v, (int, float)):
                        d[k] = repr(v)
                    else:
                        raise TypeError
            except (TypeError, ValueError):
                raise ValueError(
                    f"scene field {k!r} expects {t}, got {v!r}") from None
        return Scene(**d)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @staticmethod
    def from_json(s: str) -> "Scene":
        return Scene.from_dict(json.loads(s))

    def metadata_summary(self) -> dict:
        """Reproducibility metadata embedded in PNG exports
        (src/vk_engine.cpp:2180-2186)."""
        return {
            "Center": f"({self.center_x}, {self.center_y})",
            "Zoom": f"{self.zoom:.9f}",
            "Iterations": str(self.max_iterations),
            "Palette": str(self.palette_mode),
            "Orbit Trap": "Enabled" if self.orbit_trap_enabled else "Disabled",
        }


def _auto_iterations_wheel(zoom: float) -> int:
    # src/vk_engine.cpp:1739-1753
    if zoom < 0.01:
        return 2048
    if zoom < 0.1:
        return 1536
    if zoom < 1.0:
        return 1024
    if zoom < 10.0:
        return 512
    return 256


def _auto_iterations_point(zoom: float) -> int:
    # src/vk_engine.cpp:1778-1792
    if zoom < 0.00001:
        return 2048
    if zoom < 0.0001:
        return 1536
    if zoom < 0.001:
        return 1024
    if zoom < 0.01:
        return 512
    return 384
