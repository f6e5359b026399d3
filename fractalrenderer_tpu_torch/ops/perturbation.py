"""Perturbation deep zoom, kernel K3 (the port's counterpart of
``fractalrenderer_tpu/ops/perturbation.py``): the Mandelbrot, Julia,
Burning Ship and Phoenix families with per-pixel (Zhuoran) rebasing, the
series-skip start (Mandelbrot) and stacked spp² supersampling, in the three
delta tiers of the rebasing pipeline; the Burning Ship's exact-dust error
ledger; and the single-pass non-rebasing form of the legacy pipeline
(Mandelbrot).

Every pixel iterates its delta δ against one reference orbit Z
(``deepzoom/orbit.py``), in f32 (tier ``"f32"``), in double-double (``"dd"``,
``dd_delta``) or in floatexp (``"fx"``, ``scaled_delta``: a dd mantissa and
an i32 exponent, past the f32 exponent range):

- Mandelbrot: δ ← 2Zδ + δ² + δc;
- Julia: δ ← 2Zδ + δ², against a drift table D = Z − Z0 (Z = Z0 + D; the
  floatexp tier reads D as a mantissa and a per-entry exponent);
- Burning Ship: the diffabs recurrence (|X + d| − |X| by sign cases);
- Phoenix: δ ← 2Zδ + δ² + δc + p·δ + r·δ_prev, with a second per-lane
  state δ_prev.

A lane whose full value drops below |δ| (Julia: |D + δ| below |δ|), or that
reaches the end of the orbit with budget left, rebases (δ ← Z + δ, Julia
δ ← D + δ, Phoenix δ_prev ← Z_i + δ_i) and at once restarts at orbit index
0, up to ``max_passes`` rounds; a lane still wanting a rebase after that
leaves ``want`` = 1 for the caller's HP fallback (models/deep_zoom.py).
The TPU kernel runs these rounds per tile; each lane's iteration sequence is
the same, and the ``rounds`` plane is per pixel here (its max is the TPU's
``passes``).  Stacked supersampling (``aa_spp`` 2 or 4) renders spp²
subpixel segments of the frame (or of a row band) in one launch, each
mapped exactly as a sequential render at its offset.

Three forms of the launch (``FORMS``):

- ``"rebase"``: the rebasing loop above;
- ``"ledger"`` (``track_err``, Burning Ship dd and floatexp tiers): the same,
  plus a per-lane log2 bound ``errx`` on the carried delta's absolute
  error, errx ← max(errx + log2|2z|, log2|δ'| − 48) each step, carried
  through rebases (the model re-renders lanes with errx > −8 in HP);
- ``"single"`` (``rebase=False``, Mandelbrot): one pass to min(limit, orbit
  end) without rebasing; a lane is flagged (``glitch``) where |z|² <
  glitch_tol·|Z|² (Pauldelbrot) or where it outlives the orbit, unless
  ``float_continuation`` (f32 tier) iterates it on as z ← z² + c in f32.
  The TPU kernel advances its tile's shared orbit index in whole chunks of
  ``CHUNK``, so a continuing lane resumes at n0 + CHUNK·⌈(end − n0)/CHUNK⌉;
  the port follows that index.

- ``pack_pert_operands`` builds the 41-float parameter vector, the orbit
  streams and the launch geometry exactly as the JAX
  ``perturbation_fields`` builds its operands;
- ``perturbation_fields_cuda`` launches the hand-written CUDA kernel
  (csrc/perturbation.cu and csrc/pert_*.cu) on the current stream;
- ``perturbation_fields_plain`` is the same per-lane computation as plain
  PyTorch elementwise ops, each lane with its own orbit index;
- ``perturbation_fields`` (the JAX signature, with ``device``) takes the
  plain version for a CPU device only; for a CUDA device it launches the
  kernel or raises.

The multi-pass rebase form (``rebase_inkernel=False``), the JAX package's
oracle, is not ported and raises NotImplementedError.
"""
from __future__ import annotations

import functools
import math
from fractions import Fraction
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.diag import span
from . import dd

# Parameter vector layout, identical to the JAX package's
# (fractalrenderer_tpu/ops/perturbation.py:49-54).
(Q_CXH, Q_CXL, Q_CYH, Q_CYL, Q_PSH, Q_PSL, Q_LIMIT, Q_BAIL2, Q_REFLEN,
 Q_GLITCH_TOL, Q_SHIFTXH, Q_SHIFTXL, Q_SHIFTYH, Q_SHIFTYL, Q_OFFX,
 Q_OFFY, Q_AR, Q_AI, Q_BR, Q_BI, Q_CR, Q_CI, Q_NSKIP, Q_ROW0,
 Q_ARL, Q_AIL, Q_BRL, Q_BIL, Q_CRL, Q_CIL, Q_SEXP, Q_M0, Q_FIRST,
 Q_Z0XH, Q_Z0XL, Q_Z0YH, Q_Z0YL, Q_PP, Q_RR, Q_SE0, Q_AROW0) = range(41)
NQ = 41

# The JAX package buckets the orbit length up to a power of two (>= 256) no
# larger than this, and stores longer orbits whole; Q_REFLEN is the orbit
# length clamped to that bucket, so the port computes it the same way.  The
# Julia floatexp tier ships 6 streams instead of 4 and its bucket shrinks in
# proportion (perturbation.py:1620-1621).
ORBIT_BUCKET_MAX = 32768
JULIA_FX_BUCKET_MAX = ORBIT_BUCKET_MAX * 4 // 6

# exponent of an exact floatexp zero (far below any real scale, safe from
# i32 overflow when doubled)
E_ZERO = -(1 << 24)

TIERS = ("f32", "dd", "fx")  # the kernel's tier ids, in order
FAMILIES = ("mandelbrot", "julia", "ship", "phoenix")  # its family ids
FORMS = ("rebase", "ledger", "single")  # its form ids
CHUNK = 16  # the JAX kernel's orbit-index chunk (perturbation_fields chunk)

_EARLY_EXIT_EVERY = 16  # plain path: test for live lanes this often
_MAX_HEIGHT = 65535 * 8  # CUDA grid.y limit for the (32, 8) blocks

DD = Tuple[float, float]


def family_of(julia: bool = False, ship: bool = False,
              phoenix: bool = False) -> str:
    """The family name of the JAX package's three flags."""
    if julia + ship + phoenix > 1:
        raise ValueError("julia/ship/phoenix are mutually exclusive families")
    return ("julia" if julia else "ship" if ship
            else "phoenix" if phoenix else "mandelbrot")


def n_streams(tier: str, family: str) -> int:
    """Orbit streams of a launch: re/im hi (2), + lo parts for dd/floatexp
    (4), + per-entry drift exponents for the Julia floatexp tier (6)."""
    if tier == "f32":
        return 2
    return 6 if (tier == "fx" and family == "julia") else 4


# ---------------------------------------------------------------------------
# Host side: the operands of one launch
# ---------------------------------------------------------------------------

def _series_f32_representable(s) -> bool:
    """The non-floatexp tiers ship the raw f64 series coefficients as f32;
    past 1e36 (chaotic references at QUAD depths) they would turn into
    inf/NaN, so such a series is dropped (the skip is an optimisation)."""
    vals = (s.a.real, s.a.imag, s.b.real, s.b.imag, s.c.real, s.c.imag)
    return all(abs(v) < 1e36 and v == v for v in vals)


def _fx_streams(vals: np.ndarray, exps: Optional[np.ndarray] = None):
    """A drift table as floatexp streams (perturbation.py:1654-1663):
    mantissa hi and lo as f32 and the exponent as an exact f32 integer
    (E_ZERO for a zero entry); frexp unless the exponents come along."""
    if exps is None:
        m, e = np.frexp(vals)  # D = m * 2^e, |m| in [0.5, 1)
    else:
        m, e = vals, exps.astype(np.int64)
    hi = m.astype(np.float32)
    lo = (m - hi.astype(np.float64)).astype(np.float32)
    ex = np.where(m == 0.0, float(E_ZERO),
                  e.astype(np.float64)).astype(np.float32)
    return hi, lo, ex


def _orbit_streams(orbit: np.ndarray, orbit_exp: Optional[np.ndarray],
                   L: int, cap: int, julia_fx: bool, lo: bool):
    """The orbit's first ``L`` entries as K3's streams of length ``cap``:
    re and im as f32, with ``lo`` the lo parts of the f64 values, and for
    the Julia floatexp tier (``julia_fx``) the floatexp split of the drift
    with its exponents."""
    orbit_re = np.zeros(cap, np.float32)
    orbit_im = np.zeros(cap, np.float32)
    if julia_fx:
        orbit_re_lo = np.zeros(cap, np.float32)
        orbit_im_lo = np.zeros(cap, np.float32)
        orbit_re_ex = np.full(cap, float(E_ZERO), np.float32)
        orbit_im_ex = np.full(cap, float(E_ZERO), np.float32)
        (orbit_re[:L], orbit_re_lo[:L], orbit_re_ex[:L]) = _fx_streams(
            orbit[:L, 0], None if orbit_exp is None else orbit_exp[:L, 0])
        (orbit_im[:L], orbit_im_lo[:L], orbit_im_ex[:L]) = _fx_streams(
            orbit[:L, 1], None if orbit_exp is None else orbit_exp[:L, 1])
        streams = (orbit_re, orbit_im, orbit_re_lo, orbit_im_lo,
                   orbit_re_ex, orbit_im_ex)
    else:
        orbit_re[:L] = orbit[:L, 0].astype(np.float32)
        orbit_im[:L] = orbit[:L, 1].astype(np.float32)
        streams = (orbit_re, orbit_im)
        if lo:
            # hi/lo split of the f64 orbit: the dd/floatexp loops need dd Z
            orbit_re_lo = np.zeros(cap, np.float32)
            orbit_im_lo = np.zeros(cap, np.float32)
            orbit_re_lo[:L] = (orbit[:L, 0] - orbit_re[:L]
                               .astype(np.float64)).astype(np.float32)
            orbit_im_lo[:L] = (orbit[:L, 1] - orbit_im[:L]
                               .astype(np.float64)).astype(np.float32)
            streams += (orbit_re_lo, orbit_im_lo)
    return streams


def pack_pert_operands(orbit: np.ndarray, width: int, height: int, *,
                       center_x_dd: DD, center_y_dd: DD,
                       zoom_dd: DD = (0.0, 0.0), max_iter: int,
                       bailout: float = 4.0, glitch_tol: float = 1e-6,
                       ref_shift_x: DD = (0.0, 0.0),
                       ref_shift_y: DD = (0.0, 0.0),
                       offset: Tuple[float, float] = (0.0, 0.0),
                       iter_limit=None, series=None, row0=0.0,
                       map_height: Optional[int] = None,
                       dd_delta: bool = False, scaled_delta: bool = False,
                       zoom_frac: Union[str, Fraction, None] = None,
                       ref_shift_x_frac: Union[str, Fraction, None] = None,
                       ref_shift_y_frac: Union[str, Fraction, None] = None,
                       julia: bool = False, julia_z0=None,
                       ship: bool = False, phoenix: bool = False,
                       phoenix_p: float = 0.0, phoenix_r: float = 0.0,
                       aa_spp: int = 1,
                       orbit_exp: Optional[np.ndarray] = None,
                       rebase: bool = True,
                       float_continuation: bool = False,
                       track_err: bool = False, orbit_store=None
                       ) -> Tuple[np.ndarray, Tuple[np.ndarray, ...], dict]:
    """The parameters (NQ,) f32, the orbit streams and the launch geometry
    of one K3 launch, packed as the JAX ``perturbation_fields`` packs its
    operands (perturbation.py:1444-1808): the exact rational step
    zoom·4/map_h² (map_h the logical image height, also under stacked AA),
    the 2^s pre-scale of the floatexp tier, the series coefficients in
    either form, the Julia start Z0 and the Phoenix coefficients.  Streams:
    re and im of the orbit (or Julia drift) as f32, plus the lo parts of
    the f64 values (dd and floatexp tiers), plus the drift exponents (Julia
    floatexp), each ``cap`` long and zero (exponent E_ZERO) past the orbit;
    the single pass's |Z|² table is not shipped (the kernel squares the f32
    streams, the same bits).  The geometry is a dict of the launch's
    ``tier``, ``family``, ``form``, ``float_cont``, ``width``, ``height``
    (the band's rows), ``map_height`` (the full image's) and ``spp``.
    ``orbit_store``: None, or what the caller keeps beside ``orbit`` across
    launches (models/deep_zoom.py), an object with ``get(name, build)``
    that returns the value kept under ``name`` or keeps ``build()``'s: the
    streams are then packed once per layout (their count and length).
    Raises ValueError where the JAX package asserts: the families and
    stacked AA need ``rebase``; float continuation is the single pass's f32
    tier; ``track_err`` is the Burning Ship dd / floatexp rebasing
    ledger."""
    family = family_of(julia, ship, phoenix)
    aa_spp = int(aa_spp)
    if family != "mandelbrot" and (float_continuation or not rebase):
        raise ValueError("the non-Mandelbrot families require the rebasing "
                         "pipeline (rebase=True, float_continuation=False)")
    if aa_spp > 1 and not rebase:
        raise ValueError("aa_spp > 1 requires the rebasing pipeline")
    if float_continuation:
        if rebase:
            raise ValueError("rebasing supersedes float continuation")
        if scaled_delta or dd_delta:
            raise ValueError("float continuation is the f32 tier's (it is "
                             "meaningless at dd and scaled-delta depths)")
    if track_err and not (ship and (dd_delta or scaled_delta) and rebase):
        raise ValueError("track_err is the ship dd/scaled-tier error ledger "
                         "(rebase in-kernel)")
    if scaled_delta:
        if dd_delta:
            raise ValueError("scaled_delta supersedes dd_delta")
        if series is not None and series.n_skip > 1:
            from ..deepzoom.series import SeriesSkipFX

            if not isinstance(series, SeriesSkipFX):
                raise ValueError("scaled-delta series skip requires "
                                 "SeriesSkipFX (compute_series_skip_fx)")
    if family != "mandelbrot" and series is not None and series.n_skip > 1:
        raise ValueError("series skip is Mandelbrot-only")
    if aa_spp > 1:
        if aa_spp & (aa_spp - 1):
            raise ValueError("aa_spp must be a power of two (exact dyadic "
                             "offsets)")
        if tuple(offset) != (0.0, 0.0):
            raise ValueError("aa_spp supersedes the offset parameter")
    if julia and julia_z0 is None:
        raise ValueError("julia mode requires julia_z0")
    if iter_limit is None:
        iter_limit = max_iter
    map_h = int(map_height if map_height is not None else height)
    # exact per-pixel step = zoom * 4 / map_height^2
    if zoom_frac is not None:
        zoom_fr = Fraction(zoom_frac)
    else:
        zoom_fr = Fraction(zoom_dd[0]) + Fraction(zoom_dd[1])
    if julia and scaled_delta and orbit_exp is None \
            and 0 < zoom_fr < Fraction(1, 10 ** 290):
        # a plain f64-emitted drift table ends near 1e-308; drifts at pixel
        # scale below that collapse to 0 (perturbation.py:1561-1569)
        raise ValueError(
            "deep-zoom julia below ~1e-290 needs the floatexp drift "
            "emission: compute_orbit(emit_fx=True) + orbit_exp=")
    if orbit_exp is not None and not (julia and scaled_delta):
        raise ValueError(
            "orbit_exp is only valid with julia=True and scaled_delta="
            "True (the floatexp drift-table path); pass a plain f64 "
            "orbit table otherwise")
    step_fr = zoom_fr * 4 / (map_h * map_h)
    s_exp = 0
    if scaled_delta:
        if step_fr == 0:
            raise ValueError("scaled_delta requires a nonzero zoom")
        with span("k3.fx_scale"):
            # scale so step' ~ 2^-14: delta-c mantissas land in [2^-14, ~2]
            s_exp = -14 - (step_fr.numerator.bit_length()
                           - step_fr.denominator.bit_length())
            two_s = Fraction(2) ** s_exp
            step_dd = dd.dd_from_fraction(step_fr * two_s)
            sh_x = Fraction(ref_shift_x_frac) \
                if ref_shift_x_frac is not None else Fraction(0)
            sh_y = Fraction(ref_shift_y_frac) \
                if ref_shift_y_frac is not None else Fraction(0)
            ref_shift_x = dd.dd_from_fraction(sh_x * two_s)
            ref_shift_y = dd.dd_from_fraction(sh_y * two_s)
    else:
        step_dd = dd.dd_from_fraction(step_fr)
    if max_iter >= 1 << 24:
        # per-pixel counters (and LIMIT/REFLEN params) are f32: n+1 == n
        # past 2^24, which would wedge the interior latch
        raise ValueError("max_iter must be < 2^24 (f32 counter precision)")
    if int(iter_limit) >= 1 << 24:
        raise ValueError("iter_limit must be < 2^24 (f32 counter "
                         "precision)")
    if series is not None and max(bailout, 2.0) < 4.0:
        raise ValueError(
            "series skip requires bailout >= 4 (its escape-exactness "
            "proof needs |z| <= |Z| + |delta| < bailout over the skipped "
            "range; see deepzoom/series.py)")
    bailout = max(2.0, float(bailout))  # comp:114

    julia_fx = julia and scaled_delta
    bucket_max = JULIA_FX_BUCKET_MAX if julia_fx else ORBIT_BUCKET_MAX
    if max_iter + 1 > bucket_max:
        cap = int(max(max_iter + 1, 2))
    else:
        b = 256
        while b < max_iter + 1:
            b *= 2
        cap = int(min(b, bucket_max))
    L = int(min(len(orbit), cap))
    tier = "fx" if scaled_delta else ("dd" if dd_delta else "f32")

    def pack():
        return _orbit_streams(orbit, orbit_exp, L, cap, julia_fx,
                              tier != "f32")

    streams = pack() if orbit_store is None else orbit_store.get(
        ("k3.streams", n_streams(tier, family), cap), pack)

    params = np.zeros(NQ, np.float32)
    params[Q_CXH], params[Q_CXL] = center_x_dd
    params[Q_CYH], params[Q_CYL] = center_y_dd
    params[Q_PSH], params[Q_PSL] = step_dd
    params[Q_SEXP] = s_exp
    params[Q_LIMIT] = max(1, int(iter_limit))
    params[Q_BAIL2] = bailout * bailout
    params[Q_REFLEN] = L
    params[Q_GLITCH_TOL] = glitch_tol
    params[Q_SHIFTXH], params[Q_SHIFTXL] = ref_shift_x
    params[Q_SHIFTYH], params[Q_SHIFTYL] = ref_shift_y
    params[Q_OFFX], params[Q_OFFY] = offset

    def put_dd(hi_idx, lo_idx, value):
        params[hi_idx], params[lo_idx] = dd.dd_from_double(value)

    if series is not None and 1 < series.n_skip < L and scaled_delta:
        # floatexp coefficients pre-aligned to a shared exponent e0, so the
        # kernel's dd Horner over the scaled dc mantissa (= dc·2^s) yields
        # the delta mantissa at exponent e0 (perturbation.py:1750-1774)
        fx = [(series.a, series.a_e, 1), (series.b, series.b_e, 2),
              (series.c, series.c_e, 3)]
        e0 = max(e - k * s_exp for m, e, k in fx if m != 0)
        slots = ((Q_AR, Q_ARL, Q_AI, Q_AIL), (Q_BR, Q_BRL, Q_BI, Q_BIL),
                 (Q_CR, Q_CRL, Q_CI, Q_CIL))
        for (m, e, k), (rh, rl, ih, il) in zip(fx, slots):
            d = (e - k * s_exp) - e0
            if m == 0 or d < -1070:
                continue  # zeros are the params default
            put_dd(rh, rl, math.ldexp(m.real, d))
            put_dd(ih, il, math.ldexp(m.imag, d))
        params[Q_NSKIP] = series.n_skip
        params[Q_SE0] = e0
    elif series is not None and 1 < series.n_skip < L \
            and _series_f32_representable(series):
        put_dd(Q_AR, Q_ARL, series.a.real)
        put_dd(Q_AI, Q_AIL, series.a.imag)
        put_dd(Q_BR, Q_BRL, series.b.real)
        put_dd(Q_BI, Q_BIL, series.b.imag)
        put_dd(Q_CR, Q_CRL, series.c.real)
        put_dd(Q_CI, Q_CIL, series.c.imag)
        params[Q_NSKIP] = series.n_skip
    else:
        # Julia iterates from index 0 (delta_0 = dc references Z_0, the
        # view center); the others peel update 0 (delta_1 = dc, Z_0 = 0).
        # Floatexp: A'=1 at e0=-s reduces the Horner to dc_m · 2^-s exactly
        params[Q_AR], params[Q_NSKIP] = 1.0, (0.0 if julia else 1.0)
        params[Q_SE0] = -s_exp
    params[Q_FIRST] = 1.0
    if julia:
        # the orbit tables hold the drift D = Z - Z0, so Z0 comes from the
        # caller
        put_dd(Q_Z0XH, Q_Z0XL, float(julia_z0[0]))
        put_dd(Q_Z0YH, Q_Z0YL, float(julia_z0[1]))
    params[Q_PP] = phoenix_p
    params[Q_RR] = phoenix_r
    if aa_spp > 1:
        # the stacked map is self-contained (segments start at stacked row
        # 0); the band's global first row enters the mapping via Q_AROW0
        params[Q_ROW0] = 0.0
        params[Q_AROW0] = row0
    else:
        params[Q_ROW0] = row0
    form = "single" if not rebase else ("ledger" if track_err else "rebase")
    launch = dict(tier=tier, family=family, form=form,
                  float_cont=bool(float_continuation), width=int(width),
                  height=int(height), map_height=map_h, spp=aa_spp)
    return params, streams, launch


# ---------------------------------------------------------------------------
# The launch: plain PyTorch version and CUDA kernel
# ---------------------------------------------------------------------------

def _check_launch(params: np.ndarray, streams: Sequence, tier: str,
                  family: str, form: str, float_cont: bool, width: int,
                  height: int, map_height: int, max_passes: int,
                  spp: int) -> Tuple[int, int, int, int]:
    """Validate a launch; returns (limit, ref_len, n0, row0)."""
    if tier not in TIERS:
        raise ValueError(f"tier must be one of {TIERS}, got {tier!r}")
    if family not in FAMILIES:
        raise ValueError(f"family must be one of {FAMILIES}, got {family!r}")
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    if form == "ledger" and (family, tier) not in (("ship", "dd"),
                                                   ("ship", "fx")):
        raise ValueError("the error ledger is the Burning Ship dd and "
                         f"floatexp tiers', not {family} {tier}")
    if form == "single" and (family != "mandelbrot" or spp != 1):
        raise ValueError("the single pass is Mandelbrot's, one sample")
    if float_cont and (form != "single" or tier != "f32"):
        raise ValueError("float continuation is the single pass's f32 "
                         "tier's")
    if params.dtype != np.float32 or params.shape != (NQ,):
        raise ValueError(f"params must be float32 of shape ({NQ},), got "
                         f"{params.dtype} {params.shape}")
    want_streams = n_streams(tier, family)
    if len(streams) != want_streams:
        raise ValueError(f"tier {tier!r} of the {family} family takes "
                         f"{want_streams} orbit streams, got {len(streams)}")
    lengths = {tuple(s.shape) for s in streams}
    if len(lengths) != 1 or len(next(iter(lengths))) != 1:
        raise ValueError(f"orbit streams must be 1-D of one length, got "
                         f"{sorted(lengths)}")
    cap = next(iter(lengths))[0]
    if any(s.dtype not in (np.float32, torch.float32) for s in streams):
        raise ValueError("orbit streams must be float32")
    if spp < 1 or spp & (spp - 1) or spp > 64:
        raise ValueError(f"spp must be a power of two in [1, 64], got {spp}")
    if width < 1 or height < 1:
        raise ValueError(f"bad field size {width}x{height}")
    if height > _MAX_HEIGHT or width * height * spp * spp >= 1 << 31:
        raise ValueError(f"field size {width}x{height} (spp {spp}) is too "
                         "large")
    row0 = int(params[Q_AROW0] if spp > 1 else params[Q_ROW0])
    if row0 < 0 or row0 + height > map_height:
        raise ValueError(f"band rows [{row0}, {row0 + height}) fall outside "
                         f"the image height {map_height}")
    limit = int(params[Q_LIMIT])
    if not 1 <= limit < 1 << 24:
        raise ValueError("the iteration limit must be in [1, 2^24)")
    if not 1 <= max_passes < 1 << 31:
        raise ValueError(f"max_passes must be >= 1, got {max_passes}")
    ref_len, n0 = int(params[Q_REFLEN]), int(params[Q_NSKIP])
    if not (0 <= ref_len <= cap and 0 <= n0 < cap):
        raise ValueError(f"orbit length {ref_len} / start index {n0} do not "
                         f"fit streams of length {cap}")
    return limit, ref_len, n0, row0


def _device_streams(streams: Sequence, dev: torch.device):
    return [s.to(dev) if isinstance(s, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(s)).to(dev)
            for s in streams]


def _upload_bytes(streams: Sequence, dev: torch.device) -> int:
    """The bytes _device_streams copies to ``dev``: every host array, and
    every tensor on another device."""
    total = 0
    for s in streams:
        if not isinstance(s, torch.Tensor):
            total += np.asarray(s).nbytes
        elif s.device != dev:
            total += s.numel() * s.element_size()
    return total


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2^k as f32 for an int32 tensor k through the exponent field (0
    below 2^-126, 2^127 above): exact, unlike exp2."""
    kc = torch.clamp(k, -126, 127)
    f = ((kc + 127) << 23).view(torch.float32)
    return torch.where(k < -126, torch.zeros_like(f), f)


def _expo(x: torch.Tensor) -> torch.Tensor:
    """floor(log2 |x|) of a normal f32 from its exponent field (-127 for
    0)."""
    return ((x.view(torch.int32) >> 23) & 0xFF) - 127


def _scl(v, f):
    return v[0] * f, v[1] * f


def _cmul_dd(ar, ai, br, bi):
    return (dd.dd_sub(dd.dd_mul(ar, br), dd.dd_mul(ai, bi)),
            dd.dd_add(dd.dd_mul(ar, bi), dd.dd_mul(ai, br)))


def _select(cond, a, b):
    """torch.where over a dd pair."""
    return torch.where(cond, a[0], b[0]), torch.where(cond, a[1], b[1])


# ---- floatexp arithmetic (perturbation.py:110-205) --------------------------
# A real floatexp ("rfe") x = (m, ex) is dd_value(m)·2^ex; a complex one
# ("cfe") (mr, mi, ex) shares one exponent between its components.  Exponent
# E_ZERO marks an exact zero.  Exponents are int32 tensors.

def _rfe_norm(m, ex):
    """Renormalise: mantissa hi -> [1, 2) (or exact zero -> E_ZERO)."""
    zero = m[0] == 0.0
    k = torch.where(zero, 0, _expo(m[0]))
    f = _pow2(-k)
    nex = torch.where(zero, E_ZERO, torch.clamp(ex + k, E_ZERO, 1 << 24))
    return (m[0] * f, m[1] * f), nex


def _rfe_from_dd(hi, lo):
    return _rfe_norm((hi, lo), 0)


def _rfe_add(a, b):
    (ma, ea), (mb, eb) = a, b
    em = torch.maximum(ea, eb)
    m = dd.dd_add(_scl(ma, _pow2(ea - em)), _scl(mb, _pow2(eb - em)))
    return _rfe_norm(m, em)


def _rfe_mul(a, b):
    (ma, ea), (mb, eb) = a, b
    return _rfe_norm(dd.dd_mul(ma, mb), ea + eb)


def _rfe_neg(a):
    m, ex = a
    return (-m[0], -m[1]), ex


def _rfe_scale_pow2(a, k):
    """Exact multiply by 2^k (E_ZERO stays absorbing)."""
    m, ex = a
    return m, torch.where(ex == E_ZERO, ex, ex + k)


def _rfe_select(cond, a, b):
    return _select(cond, a[0], b[0]), torch.where(cond, a[1], b[1])


def _rfe_to_f32(a):
    m, ex = a
    return dd.dd_to_float(m) * _pow2(ex)


def _cfe_norm(mr, mi, ex):
    mag = torch.maximum(torch.abs(mr[0]), torch.abs(mi[0]))
    zero = mag == 0.0
    k = torch.where(zero, 0, _expo(mag))
    f = _pow2(-k)
    nex = torch.where(zero, E_ZERO, torch.clamp(ex + k, E_ZERO, 1 << 24))
    return _scl(mr, f), _scl(mi, f), nex


def _cfe_from_rr(x, y):
    """Join two real floatexps into one complex floatexp."""
    (mx, ex_), (my, ey) = x, y
    em = torch.maximum(ex_, ey)
    return _cfe_norm(_scl(mx, _pow2(ex_ - em)), _scl(my, _pow2(ey - em)), em)


def _cfe_add(a, b):
    ar, ai, ea = a
    br, bi, eb = b
    em = torch.maximum(ea, eb)
    fa, fb = _pow2(ea - em), _pow2(eb - em)
    return _cfe_norm(dd.dd_add(_scl(ar, fa), _scl(br, fb)),
                     dd.dd_add(_scl(ai, fa), _scl(bi, fb)), em)


def _cfe_mul(a, b):
    ar, ai, ea = a
    br, bi, eb = b
    mr, mi = _cmul_dd(ar, ai, br, bi)
    return _cfe_norm(mr, mi, ea + eb)


def _cfe_mag2_lt(a, b):
    """|a|^2 < |b|^2 for complex floatexps (hi-mantissa precision)."""
    ar, ai, ea = a
    br, bi, eb = b
    ma = ar[0] * ar[0] + ai[0] * ai[0]
    mb = br[0] * br[0] + bi[0] * bi[0]
    em = torch.maximum(ea, eb)
    return ma * _pow2(2 * (ea - em)) < mb * _pow2(2 * (eb - em))


# ---- Burning Ship diffabs (perturbation.py:208-242) -------------------------

def _diffabs(X, d):
    """|X+d| - |X| by sign cases (exact in the four cases)."""
    s = X + d
    return torch.where(X >= 0, torch.where(s >= 0, d, -(2.0 * X + d)),
                       torch.where(s >= 0, 2.0 * X + d, -d))


def _dd_sign_nonneg(v):
    """Sign of a dd value at full dd accuracy: the hi part decides unless
    it is exactly 0, then the lo part does."""
    return (v[0] > 0.0) | ((v[0] == 0.0) & (v[1] >= 0.0))


def _dd_diffabs(X, d):
    """dd |X+d| - |X|, the signs of X and X+d decided at dd accuracy."""
    t = dd.dd_add((X[0] * 2.0, X[1] * 2.0), d)
    s = dd.dd_add(X, d)
    xpos = _dd_sign_nonneg(X)
    spos = _dd_sign_nonneg(s)
    hi = torch.where(xpos, torch.where(spos, d[0], -t[0]),
                     torch.where(spos, t[0], -d[0]))
    lo = torch.where(xpos, torch.where(spos, d[1], -t[1]),
                     torch.where(spos, t[1], -d[1]))
    return hi, lo


def _abs_dd(v, pos):
    return torch.where(pos, v[0], -v[0]), torch.where(pos, v[1], -v[1])


def perturbation_fields_plain(params: np.ndarray, streams: Sequence, *,
                              tier: str, family: str = "mandelbrot",
                              form: str = "rebase", float_cont: bool = False,
                              width: int, height: int, map_height: int,
                              max_passes: int, spp: int = 1,
                              device) -> Tuple[torch.Tensor, ...]:
    """K3 as plain PyTorch ops on ``device``: returns (n, zx, zy, glitch,
    want, rounds) for the rebasing form, the same and errx for the ledger,
    and (n, zx, zy, glitch) for the single pass, each (height, width), or
    (spp², height, width) for a stacked launch.  The CPU path of
    perturbation_fields, and the comparator of the CUDA kernel on the
    card.  Each lane keeps its own orbit index (a gather per orbit read)
    and restarts at index 0 at the step after it raises ``want``, as a
    kernel thread does."""
    limit, ref_len, n0, row0 = _check_launch(params, streams, tier, family,
                                             form, float_cont, width, height,
                                             map_height, max_passes, spp)
    single, ledger = form == "single", form == "ledger"
    dev = torch.device(device)
    f32, i32 = torch.float32, torch.int32
    nseg = spp * spp
    shape = (nseg * height, width)
    p = torch.from_numpy(params).to(dev)
    st = _device_streams(streams, dev)
    ore, oim = st[0], st[1]
    orl, oil = (st[2], st[3]) if len(st) >= 4 else (None, None)
    last = ore.shape[0] - 1
    # the single pass stops at the budget too
    pert_end = min(limit, ref_len - 1) if single else ref_len - 1
    limit_f, bail2 = p[Q_LIMIT], p[Q_BAIL2]
    s_exp = int(params[Q_SEXP])
    julia, ship, phoenix = (family == "julia", family == "ship",
                            family == "phoenix")
    pp, rr = p[Q_PP], p[Q_RR]
    z0x, z0y = (p[Q_Z0XH], p[Q_Z0XL]), (p[Q_Z0YH], p[Q_Z0YL])

    def bc(v):
        return v.expand(shape).contiguous()

    # dc = step * (pixel - size/2 + offset) + shift, in dd; a stacked
    # launch's segment s maps at offset ((s mod spp)/spp, (s div spp)/spp)
    r = torch.arange(nseg * height, dtype=i32, device=dev)
    seg = r // height
    rows = (r - seg * height + row0).to(f32)
    cols = torch.arange(width, dtype=i32, device=dev).to(f32)
    half_w = torch.tensor(width * 0.5, dtype=f32, device=dev)
    half_h = torch.tensor(map_height * 0.5, dtype=f32, device=dev)
    if spp > 1:
        fspp = torch.tensor(float(spp), dtype=f32, device=dev)
        offx, offy = (seg % spp).to(f32) / fspp, (seg // spp).to(f32) / fspp
    else:
        offx, offy = p[Q_OFFX].expand(r.shape), p[Q_OFFY].expand(r.shape)
    nx = ((cols - half_w)[None, :] + offx[:, None]).contiguous()
    ny = ((rows - half_h) + offy)[:, None].expand(shape).contiguous()
    step = (p[Q_PSH], p[Q_PSL])
    dcx = dd.dd_add(dd.dd_mul_float(step, nx), (p[Q_SHIFTXH], p[Q_SHIFTXL]))
    dcy = dd.dd_add(dd.dd_mul_float(step, ny), (p[Q_SHIFTYH], p[Q_SHIFTYL]))
    delta_r, delta_i = dd.dd_to_float(dcx), dd.dd_to_float(dcy)

    # series initial delta d_{n0} = ((C dc + B) dc + A) dc
    if tier == "f32":
        hr, hi = p[Q_CR], p[Q_CI]
        hr, hi = (hr * delta_r - hi * delta_i + p[Q_BR],
                  hr * delta_i + hi * delta_r + p[Q_BI])
        hr, hi = (hr * delta_r - hi * delta_i + p[Q_AR],
                  hr * delta_i + hi * delta_r + p[Q_AI])
        dr = hr * delta_r - hi * delta_i
        di = hr * delta_i + hi * delta_r
        z1r, z1i = dr, di
        pr, pi = torch.zeros_like(dr), torch.zeros_like(di)
    else:
        tr, tj = _cmul_dd((p[Q_CR], p[Q_CRL]), (p[Q_CI], p[Q_CIL]), dcx, dcy)
        tr = dd.dd_add(tr, (p[Q_BR], p[Q_BRL]))
        tj = dd.dd_add(tj, (p[Q_BI], p[Q_BIL]))
        tr, tj = _cmul_dd(tr, tj, dcx, dcy)
        tr = dd.dd_add(tr, (p[Q_AR], p[Q_ARL]))
        tj = dd.dd_add(tj, (p[Q_AI], p[Q_AIL]))
        dzr, dzi = _cmul_dd(tr, tj, dcx, dcy)
        if tier == "fx":
            # the Horner value sits at exponent Q_SE0: renormalise
            mag0 = torch.maximum(torch.abs(dzr[0]), torch.abs(dzi[0]))
            zero0 = mag0 == 0.0
            k0 = torch.where(zero0, 0, _expo(mag0))
            f0 = _pow2(-k0)
            dzr, dzi = _scl(dzr, f0), _scl(dzi, f0)
            ex = torch.where(zero0, E_ZERO, torch.clamp(
                k0 + int(params[Q_SE0]), E_ZERO, 1 << 24)).to(i32)
            dfac0 = _pow2(ex)
            z1r = dd.dd_to_float(dzr) * dfac0
            z1i = dd.dd_to_float(dzi) * dfac0
            pex = torch.full(shape, E_ZERO, dtype=i32, device=dev)
        else:
            z1r, z1i = dd.dd_to_float(dzr), dd.dd_to_float(dzi)
        zeros = torch.zeros(shape, dtype=f32, device=dev)
        pzr, pzi = (zeros, zeros), (zeros, zeros)  # Phoenix delta_prev
    # the full start value z_{n0} = Z_{n0} + d_{n0}; Julia: Z0 + D + d
    if julia and tier == "fx":
        rex, iex = st[4], st[5]
        d0r = _rfe_norm((bc(ore[n0]), bc(orl[n0])), bc(rex[n0].to(i32)))
        d0i = _rfe_norm((bc(oim[n0]), bc(oil[n0])), bc(iex[n0].to(i32)))
        zfr = z0x[0] + (z0x[1] + _rfe_to_f32(_rfe_add(d0r, (dzr, ex))))
        zfi = z0y[0] + (z0y[1] + _rfe_to_f32(_rfe_add(d0i, (dzi, ex))))
        # Z0 as a floatexp, the same every step
        z0fe = (_rfe_from_dd(bc(z0x[0]), bc(z0x[1])),
                _rfe_from_dd(bc(z0y[0]), bc(z0y[1])))
    elif julia:
        zfr = z0x[0] + (z0x[1] + (ore[n0] + z1r))
        zfi = z0y[0] + (z0y[1] + (oim[n0] + z1i))
    else:
        zfr = ore[n0] + z1r
        zfi = oim[n0] + z1i
    if ship and tier == "fx":
        # the true delta-c as real floatexps (mantissa dc·2^s, exponent -s)
        dcfe_x = _rfe_norm(dcx, -s_exp)
        dcfe_y = _rfe_norm(dcy, -s_exp)
    zfr, zfi = bc(zfr), bc(zfi)
    nf = torch.full(shape, float(n0 - 1), dtype=f32, device=dev)
    i = torch.full(shape, n0, dtype=torch.int64, device=dev)
    want = torch.zeros(shape, dtype=torch.bool, device=dev)
    never = want  # the single pass's rebase test
    glitch = torch.zeros(shape, dtype=torch.bool, device=dev)
    rounds = torch.ones(shape, dtype=i32, device=dev)
    errx = None
    if ledger:
        # starts at the dd compose floor of the initial delta, 2^-48
        # relative; log2(f32(1e-76) = 0) is -inf, as on the TPU
        tiny = torch.tensor(1e-38, dtype=f32, device=dev)
        fzero = torch.zeros((), dtype=f32, device=dev)
        dmag0 = 0.5 * torch.log2(torch.maximum(
            dzr[0] * dzr[0] + dzi[0] * dzi[0], fzero))
        errx = (torch.where(ex == E_ZERO, -200.0, (dmag0 + ex.to(f32)) - 48.0)
                if tier == "fx" else dmag0 - 48.0)

    def wants(cond):
        """The rebase test of the step's alive lanes (never in the single
        pass)."""
        return never if single else alive & cond & (nf < limit_f)

    step_no = 0
    while True:
        # a lane that raised want last step starts its next round at once
        restart = want & (rounds < max_passes)
        i = torch.where(restart, 0, i)
        rounds = rounds + restart.to(i32)
        want = want & ~restart
        mag2 = zfr * zfr + zfi * zfi
        alive = (mag2 <= bail2) & (i < pert_end) & ~want & (nf < limit_f)
        if step_no % _EARLY_EXIT_EVERY == 0 and not bool(alive.any()):
            break
        step_no += 1
        nf = nf + alive.to(f32)
        ic, ip = i.clamp(max=last), (i + 1).clamp(max=last)
        zr, zi, zr1, zi1 = ore[ic], oim[ic], ore[ip], oim[ip]
        ends = (i + 1) >= pert_end
        if tier == "f32":
            if julia:  # tables hold D = Z - Z0
                zr, zi = z0x[0] + zr, z0y[0] + zi
            if ship:
                # x' = x^2-y^2+cx, y' = 2|xy|+cy with a = |X+dx| = |X|+da:
                #   dx' = da(2|X|+da) - db(2|Y|+db) + dcx
                #   dy' = 2(|X| db + |Y| da + da db) + dcy
                da, db = _diffabs(zr, dr), _diffabs(zi, di)
                aa, bb = torch.abs(zr), torch.abs(zi)
                ndr = da * (2.0 * aa + da) - db * (2.0 * bb + db) + delta_r
                ndi = 2.0 * (aa * db + bb * da + da * db) + delta_i
            else:
                t1r = 2.0 * (zr * dr - zi * di)
                t1i = 2.0 * (zr * di + zi * dr)
                t2r = dr * dr - di * di
                t2i = (2.0 * dr) * di
                if phoenix:
                    ndr = t1r + t2r + delta_r + pp * dr + rr * pr
                    ndi = t1i + t2i + delta_i + pp * di + rr * pi
                elif julia:
                    ndr, ndi = t1r + t2r, t1i + t2i
                else:
                    ndr = t1r + t2r + delta_r
                    ndi = t1i + t2i + delta_i
            # Julia: rel = D_{i+1} + d, the rebased delta and the Zhuoran
            # distance to Z0; the others: rel is z_full
            relr, reli = zr1 + ndr, zi1 + ndi
            if julia:
                nzfr, nzfi = z0x[0] + relr, z0y[0] + reli
            else:
                nzfr, nzfi = relr, reli
            zm2 = relr * relr + reli * reli
            dm2 = ndr * ndr + ndi * ndi
            want_now = wants((zm2 < dm2) | ends)
            ndr = torch.where(want_now, relr, ndr)
            ndi = torch.where(want_now, reli, ndi)
            if phoenix:
                # delta_prev advances to the old delta; a rebased lane gets
                # the absolute z_i (Z_{-1} = 0)
                pr = torch.where(alive, torch.where(want_now, zr + dr, dr),
                                 pr)
                pi = torch.where(alive, torch.where(want_now, zi + di, di),
                                 pi)
            dr = torch.where(alive, ndr, dr)
            di = torch.where(alive, ndi, di)
        else:
            zrl, zil, zrl1, zil1 = orl[ic], oil[ic], orl[ip], oil[ip]
            X, Y = (zr, zrl), (zi, zil)
            if tier == "dd":
                ndr, ndi = _dd_step(family, dzr, dzi, pzr, pzi, X, Y, dcx,
                                    dcy, z0x, z0y, pp, rr)
                rel_r = (zr1 + ndr[0]) + (zrl1 + ndr[1])
                rel_i = (zi1 + ndi[0]) + (zil1 + ndi[1])
                if julia:
                    nzfr = z0x[0] + (z0x[1] + rel_r)
                    nzfi = z0y[0] + (z0y[1] + rel_i)
                else:
                    nzfr, nzfi = rel_r, rel_i
                zm2 = rel_r * rel_r + rel_i * rel_i
                dm2 = ndr[0] * ndr[0] + ndi[0] * ndi[0]
                want_now = wants((zm2 < dm2) | ends)
                # rebase: d <- Z_{i+1} + d (Julia: D_{i+1} + d), in dd
                ndr = _select(want_now, dd.dd_add((zr1, zrl1), ndr), ndr)
                ndi = _select(want_now, dd.dd_add((zi1, zil1), ndi), ndi)
                if ledger:
                    # the error grows by |2z| (z from the hi parts before
                    # the step), floored at 2^-48 of the new delta
                    fxr, fxi = zr + dzr[0], zi + dzi[0]
                    amp = 0.5 * torch.log2(torch.maximum(
                        4.0 * (fxr * fxr + fxi * fxi), tiny))
                    flo = 0.5 * torch.log2(torch.maximum(
                        ndr[0] * ndr[0] + ndi[0] * ndi[0], fzero)) - 48.0
                    errx = torch.where(alive, torch.maximum(errx + amp, flo),
                                       errx)
                if phoenix:
                    pzr = _select(alive, _select(
                        want_now, dd.dd_add(X, dzr), dzr), pzr)
                    pzi = _select(alive, _select(
                        want_now, dd.dd_add(Y, dzi), dzi), pzi)
                new_ex = None
            else:
                if julia:
                    dr_ = _rfe_norm(X, st[4][ic].to(i32))
                    di_ = _rfe_norm(Y, st[5][ic].to(i32))
                    nmr, nmi, nex = _fx_julia_step(dzr, dzi, ex, dr_, di_,
                                                   z0fe)
                    # rel = D_{i+1} + d in floatexp; z_full = Z0 + rel; the
                    # Zhuoran metric |rel| < |d| at full floatexp precision
                    d1r = _rfe_norm((zr1, zrl1), st[4][ip].to(i32))
                    d1i = _rfe_norm((zi1, zil1), st[5][ip].to(i32))
                    rel_r = _rfe_add(d1r, (nmr, nex))
                    rel_i = _rfe_add(d1i, (nmi, nex))
                    rel_c = _cfe_from_rr(rel_r, rel_i)
                    nzfr = z0x[0] + (z0x[1] + _rfe_to_f32(rel_r))
                    nzfi = z0y[0] + (z0y[1] + _rfe_to_f32(rel_i))
                    want_now = wants(
                        _cfe_mag2_lt(rel_c, (nmr, nmi, nex)) | ends)
                    ndr = _select(want_now, rel_c[0], nmr)
                    ndi = _select(want_now, rel_c[1], nmi)
                    new_ex = torch.where(want_now, rel_c[2], nex)
                else:
                    if ship:
                        nmr, nmi, nex = _fx_ship_step(dzr, dzi, ex, X, Y,
                                                      dcfe_x, dcfe_y)
                    else:
                        nmr, nmi, nex = _fx_aligned_step(
                            dzr, dzi, ex, X, Y, dcx, dcy, s_exp,
                            (pzr, pzi, pex) if phoenix else None, pp, rr,
                            float(params[Q_RR]) == 0.0)
                    # z_full = Z + m 2^ex; Zhuoran test; rebase to exponent 0
                    dfac = _pow2(nex)
                    nzfr = (zr1 + nmr[0] * dfac) + (zrl1 + nmr[1] * dfac)
                    nzfi = (zi1 + nmi[0] * dfac) + (zil1 + nmi[1] * dfac)
                    zm2 = nzfr * nzfr + nzfi * nzfi
                    dm2 = (nmr[0] * nmr[0] + nmi[0] * nmi[0]) \
                        * _pow2(nex + nex)
                    want_now = wants((zm2 < dm2) | ends)
                    ndr = _select(want_now,
                                  dd.dd_add((zr1, zrl1), _scl(nmr, dfac)), nmr)
                    ndi = _select(want_now,
                                  dd.dd_add((zi1, zil1), _scl(nmi, dfac)), nmi)
                    new_ex = torch.where(want_now, 0, nex)
                    if ledger:
                        # |2z| from the full z before the step; the floor
                        # from the new (rebased) delta, none for a zero
                        amp = 0.5 * torch.log2(torch.maximum(4.0 * mag2,
                                                             tiny))
                        dmag = 0.5 * torch.log2(torch.maximum(
                            ndr[0] * ndr[0] + ndi[0] * ndi[0], fzero))
                        flo = torch.where(new_ex == E_ZERO, -1e9,
                                          (dmag + new_ex.to(f32)) - 48.0)
                        errx = torch.where(
                            alive, torch.maximum(errx + amp, flo), errx)
                    if phoenix:
                        # delta_prev advances to the old delta; a rebased
                        # lane gets the absolute z_i (dd, exponent 0)
                        dfo = _pow2(ex)
                        pzr = _select(alive, _select(
                            want_now, dd.dd_add(X, _scl(dzr, dfo)), dzr), pzr)
                        pzi = _select(alive, _select(
                            want_now, dd.dd_add(Y, _scl(dzi, dfo)), dzi), pzi)
                        pex = torch.where(alive, torch.where(want_now, 0, ex),
                                          pex)
            dzr = _select(alive, ndr, dzr)
            dzi = _select(alive, ndi, dzi)
            if new_ex is not None:
                ex = torch.where(alive, new_ex, ex)
        if single:
            # the Pauldelbrot flag against |Z_{i+1}|^2 of the f32 streams
            glitch = glitch | (alive & (
                nzfr * nzfr + nzfi * nzfi
                < p[Q_GLITCH_TOL] * (zr1 * zr1 + zi1 * zi1)))
        zfr = torch.where(alive, nzfr, zfr)
        zfi = torch.where(alive, nzfi, zfi)
        want = want | want_now
        i = i + alive.to(torch.int64)

    interior = nf >= limit_f  # the budget ran out
    if single:
        # a lane alive at the orbit's end: flagged for a secondary
        # reference, or (float continuation) on in f32 from the chunk grid
        # of the JAX kernel's shared orbit index
        if float_cont:
            c_r = dd.dd_to_float(dd.dd_add((p[Q_CXH], p[Q_CXL]), dcx))
            c_i = dd.dd_to_float(dd.dd_add((p[Q_CYH], p[Q_CYL]), dcy))
            i1 = n0 + CHUNK * -(-max(pert_end - n0, 0) // CHUNK)
            for k in range(i1, limit):
                alive = zfr * zfr + zfi * zfi <= bail2
                if (k - i1) % _EARLY_EXIT_EVERY == 0 \
                        and not bool(alive.any()):
                    break
                nf = nf + alive.to(f32)
                x = zfr * zfr - zfi * zfi + c_r
                y = (2.0 * zfr) * zfi + c_i
                zfr = torch.where(alive, x, zfr)
                zfi = torch.where(alive, y, zfi)
        elif pert_end < limit:
            glitch = glitch | (zfr * zfr + zfi * zfi <= bail2)
        interior = zfr * zfr + zfi * zfi <= bail2

    lim = torch.tensor(limit, dtype=i32, device=dev)
    n = torch.where(interior, lim, torch.clamp_min(nf, 0.0).to(i32))
    if single:
        outs = (n, zfr, zfi, glitch.to(f32))
    else:
        outs = (n, zfr, zfi, torch.zeros(shape, dtype=f32, device=dev),
                want.to(f32), rounds.to(f32)) + ((errx,) if ledger else ())
    if spp > 1:
        outs = tuple(o.view(nseg, height, width) for o in outs)
    return outs


def _dd_step(family, dzr, dzi, pzr, pzi, X, Y, dcx, dcy, z0x, z0y, pp, rr):
    """The dd tier's new delta (perturbation.py:931-995), before the
    rebase test."""
    if family == "ship":
        da, db = _dd_diffabs(X, dzr), _dd_diffabs(Y, dzi)
        a2 = _scl(_abs_dd(X, _dd_sign_nonneg(X)), 2.0)
        b2 = _scl(_abs_dd(Y, _dd_sign_nonneg(Y)), 2.0)
        ndr = dd.dd_add(dd.dd_sub(dd.dd_mul(da, dd.dd_add(a2, da)),
                                  dd.dd_mul(db, dd.dd_add(b2, db))), dcx)
        # 2(|X| db + |Y| da + da db) == A2*db + B2*da + 2*da*db
        t2 = dd.dd_add(dd.dd_add(dd.dd_mul(_scl(a2, 0.5), db),
                                 dd.dd_mul(_scl(b2, 0.5), da)),
                       dd.dd_mul(da, db))
        return ndr, dd.dd_add(_scl(t2, 2.0), dcy)
    if family == "julia":  # Z = Z0 + D
        z2r = _scl(dd.dd_add(z0x, X), 2.0)
        z2i = _scl(dd.dd_add(z0y, Y), 2.0)
    else:
        z2r, z2i = _scl(X, 2.0), _scl(Y, 2.0)
    # d <- 2Z d + d^2 (+ dc), all components dd
    t1r = dd.dd_sub(dd.dd_mul(dzr, z2r), dd.dd_mul(dzi, z2i))
    t1i = dd.dd_add(dd.dd_mul(dzi, z2r), dd.dd_mul(dzr, z2i))
    sq_r = dd.dd_sub(dd.dd_mul(dzr, dzr), dd.dd_mul(dzi, dzi))
    sq_i = _scl(dd.dd_mul(dzr, dzi), 2.0)
    ndr, ndi = dd.dd_add(t1r, sq_r), dd.dd_add(t1i, sq_i)
    if family != "julia":
        ndr, ndi = dd.dd_add(ndr, dcx), dd.dd_add(ndi, dcy)
    if family == "phoenix":
        # dd_mul_float keeps the two-prod error term of p·d and r·d_prev
        ndr = dd.dd_add(ndr, dd.dd_add(dd.dd_mul_float(dzr, pp),
                                       dd.dd_mul_float(pzr, rr)))
        ndi = dd.dd_add(ndi, dd.dd_add(dd.dd_mul_float(dzi, pp),
                                       dd.dd_mul_float(pzi, rr)))
    return ndr, ndi


def _fx_julia_step(mr, mi, ex, dr_, di_, z0fe):
    """Julia floatexp: d <- 2Z d + d^2 entirely in floatexp, Z = Z0 + D
    (perturbation.py:692-712)."""
    zc = _cfe_from_rr(_rfe_add(z0fe[0], dr_), _rfe_add(z0fe[1], di_))
    zc2 = (zc[0], zc[1], torch.where(zc[2] == E_ZERO, zc[2], zc[2] + 1))
    d = (mr, mi, ex)
    return _cfe_add(_cfe_mul(d, zc2), _cfe_mul(d, d))


def _fx_ship_step(mr, mi, ex, X, Y, dcfe_x, dcfe_y):
    """Burning Ship floatexp diffabs (perturbation.py:713-756): da is ±d
    away from the axes and ±(2X + d) on a sign straddle, each a floatexp
    at its own scale."""
    dxfe, dyfe = (mr, ex), (mi, ex)
    xpos, ypos = _dd_sign_nonneg(X), _dd_sign_nonneg(Y)
    abs_x = _rfe_from_dd(*_abs_dd(X, xpos))
    abs_y = _rfe_from_dd(*_abs_dd(Y, ypos))
    ux = _rfe_add(_rfe_from_dd(X[0] * 2.0, X[1] * 2.0), dxfe)
    uy = _rfe_add(_rfe_from_dd(Y[0] * 2.0, Y[1] * 2.0), dyfe)
    sx = _rfe_add(_rfe_from_dd(X[0], X[1]), dxfe)[0][0] >= 0
    sy = _rfe_add(_rfe_from_dd(Y[0], Y[1]), dyfe)[0][0] >= 0
    da = _rfe_select(xpos, _rfe_select(sx, dxfe, _rfe_neg(ux)),
                     _rfe_select(sx, ux, _rfe_neg(dxfe)))
    db = _rfe_select(ypos, _rfe_select(sy, dyfe, _rfe_neg(uy)),
                     _rfe_select(sy, uy, _rfe_neg(dyfe)))
    a2, b2 = _rfe_scale_pow2(abs_x, 1), _rfe_scale_pow2(abs_y, 1)
    # dx' = da(2|X|+da) - db(2|Y|+db) + dcx
    # dy' = 2(|X| db + |Y| da + da db) + dcy
    dxp = _rfe_add(_rfe_add(_rfe_mul(da, _rfe_add(a2, da)),
                            _rfe_neg(_rfe_mul(db, _rfe_add(b2, db)))), dcfe_x)
    dyp = _rfe_add(_rfe_scale_pow2(_rfe_add(
        _rfe_add(_rfe_mul(abs_x, db), _rfe_mul(abs_y, da)),
        _rfe_mul(da, db)), 1), dcfe_y)
    return _cfe_from_rr(dxp, dyp)


def _fx_aligned_step(mr, mi, ex, X, Y, dcx, dcy, s_exp, prev, pp, rr,
                     r_is_zero):
    """Mandelbrot / Phoenix floatexp (perturbation.py:764-816): the terms
    at exponents ex, 2ex, -s (and ex, pex for Phoenix's p·d and r·d_prev)
    aligned to their max by exact powers of two, then renormalised."""
    z2r, z2i = _scl(X, 2.0), _scl(Y, 2.0)
    t1r = dd.dd_sub(dd.dd_mul(mr, z2r), dd.dd_mul(mi, z2i))
    t1i = dd.dd_add(dd.dd_mul(mi, z2r), dd.dd_mul(mr, z2i))
    sq_r = dd.dd_sub(dd.dd_mul(mr, mr), dd.dd_mul(mi, mi))
    sq_i = _scl(dd.dd_mul(mr, mi), 2.0)
    e2 = ex + ex
    emax = torch.clamp_min(torch.maximum(ex, e2), -s_exp)
    if prev is not None:
        # a stale pex must not shift the real terms down when r = 0
        pzr, pzi, pex = prev
        emax = torch.maximum(emax, torch.full_like(pex, E_ZERO)
                             if r_is_zero else pex)
    fa, fb = _pow2(ex - emax), _pow2(e2 - emax)
    nmr = dd.dd_add(_scl(t1r, fa), _scl(sq_r, fb))
    nmi = dd.dd_add(_scl(t1i, fa), _scl(sq_i, fb))
    fc = _pow2(-s_exp - emax)
    nmr = dd.dd_add(nmr, _scl(dcx, fc))
    nmi = dd.dd_add(nmi, _scl(dcy, fc))
    if prev is not None:
        # dd_mul_float keeps the two-prod error term of p·d and r·d_prev
        nmr = dd.dd_add(nmr, _scl(dd.dd_mul_float(mr, pp), fa))
        nmi = dd.dd_add(nmi, _scl(dd.dd_mul_float(mi, pp), fa))
        fr = _pow2(pex - emax)
        nmr = dd.dd_add(nmr, _scl(dd.dd_mul_float(pzr, rr), fr))
        nmi = dd.dd_add(nmi, _scl(dd.dd_mul_float(pzi, rr), fr))
    return _cfe_norm(nmr, nmi, emax)


def _orbit_table(streams: Sequence, tier: str, family: str) -> torch.Tensor:
    """The kernel's orbit table: the streams interleaved, one entry per
    index (csrc/pert_kernel.cuh orbit_width: f32 2 floats, dd and floatexp
    4, the Julia floatexp 8 with its two exponent streams and two zeros),
    on the streams' device.  A new tensor, so its start is as aligned as
    the allocator's blocks, past the 16 bytes the kernel's vector loads
    need."""
    width = 8 if (tier, family) == ("fx", "julia") else len(streams)
    cols = list(streams) + [torch.zeros_like(streams[0])] * (width
                                                              - len(streams))
    return torch.stack(cols, dim=1)


def _upload_table(streams: Sequence, tier: str, family: str,
                  dev: torch.device) -> torch.Tensor:
    """The orbit table of ``streams`` on ``dev``, its copies counted in
    ``perturbation_fields_cuda.upload_bytes``."""
    perturbation_fields_cuda.upload_bytes += _upload_bytes(streams, dev)
    return _orbit_table(_device_streams(streams, dev), tier, family)


def perturbation_fields_cuda(params: np.ndarray, streams: Sequence, *,
                             tier: str, family: str = "mandelbrot",
                             form: str = "rebase", float_cont: bool = False,
                             width: int, height: int, map_height: int,
                             max_passes: int, spp: int = 1,
                             device, orbit_store=None
                             ) -> Tuple[torch.Tensor, ...]:
    """Launch the CUDA kernel K3 on ``device`` (same signature and results
    as perturbation_fields_plain; ``streams`` may be numpy arrays or
    tensors already on the device).  One launch per call, stacked spp²
    segments included; counts its launches in
    ``perturbation_fields_cuda.launches`` and the bytes it copies to the
    card in ``perturbation_fields_cuda.upload_bytes``.  ``orbit_store``
    (pack_pert_operands') keeps the orbit table of each layout on each
    device and stream, built from the first launch's ``streams``: a later
    launch there copies nothing.  Its checks run in the span
    ``k3.prepare``, the table's lookup, or the orbit's copy and
    interleave, in ``deep.upload``, the launch in ``k3.launch``."""
    from . import _cuda

    with span("k3.prepare"):
        _check_launch(params, streams, tier, family, form, float_cont, width,
                      height, map_height, max_passes, spp)
        dev = _cuda.cuda_device(device)
        params = np.ascontiguousarray(params)
        lib = _cuda.load_library()
        nseg = spp * spp
        single = form == "single"
    with torch.cuda.device(dev):
        with span("deep.upload"):
            if orbit_store is None:
                orbit = _upload_table(streams, tier, family, dev)
            else:
                # one table per stream: the launches that read it queue
                # behind the interleave that wrote it, and the allocator
                # frees it for that stream alone
                orbit = orbit_store.get(
                    ("k3.table", len(streams), len(streams[0]), dev,
                     torch.cuda.current_stream(dev).cuda_stream),
                    lambda: _upload_table(streams, tier, family, dev))
        with span("k3.launch"):
            shape = (nseg * height, width)
            n = torch.empty(shape, dtype=torch.int32, device=dev)

            def plane(written=True):
                return (torch.empty if written else torch.zeros)(
                    shape, dtype=torch.float32, device=dev)

            # the rebasing forms leave glitch at 0; the single pass writes
            # no want or rounds, only the ledger writes errx
            zx, zy, glitch = plane(), plane(), plane(single)
            want, rounds = (None, None) if single else (plane(), plane())
            errx = plane() if form == "ledger" else None
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.fr_perturbation(
                FAMILIES.index(family), TIERS.index(tier), FORMS.index(form),
                params.ctypes.data, orbit.data_ptr(), width,
                height, map_height, max_passes, spp, int(float_cont),
                *(None if q is None else q.data_ptr()
                  for q in (n, zx, zy, glitch, want, rounds, errx)), stream)
            _cuda.check(lib, rc, "perturbation")
    perturbation_fields_cuda.launches += 1
    outs = ((n, zx, zy, glitch) if single
            else (n, zx, zy, glitch, want, rounds)
            + ((errx,) if errx is not None else ()))
    if spp > 1:
        outs = tuple(o.view(nseg, height, width) for o in outs)
    return outs


perturbation_fields_cuda.launches = 0
perturbation_fields_cuda.upload_bytes = 0


def perturbation_fields(orbit: np.ndarray, width: int, height: int, *,
                        center_x_dd: DD, center_y_dd: DD,
                        zoom_dd: DD = (0.0, 0.0), max_iter: int,
                        bailout: float = 4.0, glitch_tol: float = 1e-6,
                        ref_shift_x: DD = (0.0, 0.0),
                        ref_shift_y: DD = (0.0, 0.0),
                        offset: Tuple[float, float] = (0.0, 0.0),
                        iter_limit=None, float_continuation: bool = True,
                        series=None, row0=0.0,
                        map_height: Optional[int] = None,
                        dd_delta: bool = False, scaled_delta: bool = False,
                        zoom_frac: Union[str, Fraction, None] = None,
                        ref_shift_x_frac: Union[str, Fraction, None] = None,
                        ref_shift_y_frac: Union[str, Fraction, None] = None,
                        rebase: bool = False, max_passes: int = 256,
                        rebase_inkernel: bool = True, julia: bool = False,
                        julia_z0=None, ship: bool = False,
                        phoenix: bool = False, phoenix_p: float = 0.0,
                        phoenix_r: float = 0.0, aa_spp: int = 1,
                        orbit_exp: Optional[np.ndarray] = None,
                        track_err: bool = False, orbit_store=None,
                        device="cuda") -> Dict[str, torch.Tensor]:
    """Perturbation fields on ``device`` against a precomputed reference
    orbit ((L, 2) float64 from deepzoom.orbit; Julia: the drift table, with
    ``orbit_exp`` its exponents in the floatexp tier), with the JAX
    signature.  The rebasing path (``rebase=True, float_continuation=
    False``) of every family returns {"n", "zx", "zy", "glitch", "want",
    "passes", "rounds_plane"}, and "errx" with ``track_err`` (Burning Ship
    dd / floatexp); with ``aa_spp`` > 1 the planes are (aa_spp², height,
    width).  ``passes`` is the most rounds any pixel took, ``rounds_plane``
    the per-pixel rounds.  ``rebase=False`` (Mandelbrot) runs the single
    pass and returns {"n", "zx", "zy", "glitch"}.  ``orbit_store``
    (pack_pert_operands') keeps the orbit's streams, and on a CUDA device
    its table, for the launches to come against the same orbit.  The
    packing runs in the span ``k3.prepare``, the floatexp tier's pre-scale
    of the step and the shift in ``k3.fx_scale`` inside it."""
    if rebase and not rebase_inkernel:
        raise NotImplementedError("the multi-pass rebase form is the JAX "
                                  "package's oracle and is not ported")
    with span("k3.prepare"):
        params, streams, launch = pack_pert_operands(
            orbit, width, height, center_x_dd=center_x_dd,
            center_y_dd=center_y_dd, zoom_dd=zoom_dd, max_iter=max_iter,
            bailout=bailout, glitch_tol=glitch_tol,
            ref_shift_x=ref_shift_x, ref_shift_y=ref_shift_y, offset=offset,
            iter_limit=iter_limit, series=series, row0=row0,
            map_height=map_height, dd_delta=dd_delta,
            scaled_delta=scaled_delta, zoom_frac=zoom_frac,
            ref_shift_x_frac=ref_shift_x_frac,
            ref_shift_y_frac=ref_shift_y_frac,
            julia=julia, julia_z0=julia_z0, ship=ship, phoenix=phoenix,
            phoenix_p=phoenix_p, phoenix_r=phoenix_r, aa_spp=aa_spp,
            orbit_exp=orbit_exp, rebase=rebase,
            float_continuation=float_continuation, track_err=track_err,
            orbit_store=orbit_store)
        dev = torch.device(device)
        if dev.type == "cpu":
            impl = perturbation_fields_plain
        elif dev.type == "cuda":
            impl = functools.partial(perturbation_fields_cuda,
                                     orbit_store=orbit_store)
        else:
            raise ValueError(f"unsupported device {dev}")
    outs = impl(params, streams, max_passes=int(max_passes), device=dev,
                **launch)
    res = dict(zip(("n", "zx", "zy", "glitch"), outs))
    if rebase:
        res.update(want=outs[4], passes=outs[5].max().to(torch.int32),
                   rounds_plane=outs[5])
        if track_err:
            res["errx"] = outs[6]
    return res
