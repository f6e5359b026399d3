"""k4b_roofline: kernel K4b's share of its roofline (%), over the sampled
frames of the traced stretch: the least time the card could take for the
work those frames need, over K4b's kernel records of those frames.

Work (frozen here; never recounted when the kernel changes):

- operations: the DE iterations the frame's pixels need (the march, the
  escape-index recovery and the 11 normal and AO taps, each lane's
  ``work`` in the plain reference's march over the sampled rows, scaled
  to the frame by its rows over the sampled rows), times STEP_OPS; plus
  the pixels that hit, scaled the same way, times HIT_OPS;
- STEP_OPS, the f32 operations of one polynomial-trig DE step as written
  (reference/bulb.py ``de_step`` and the carried |z| of ``_Orbits.step``;
  every add, subtract, negation, multiply, divide, square root, min, max,
  abs and math-library call one, a two-sided clamp two, selects and
  compares none): the clamp of r and zz / r with its clamp (4), acos (26:
  the clamp, 1 - x^2 and its clamp and root, 6, and atan2, 20: |x|, y / x,
  atan 17 (|t|, the clamped reciprocal 2, t^2, the 5 Horner steps 10, the
  product, pi/2 - r and the sign 3), the quadrant's add), atan2 of phi
  (20), power - 1, r^(p-1) and dr' (5), r^p (1), theta p and phi p (2),
  the sines, cosines and the new z (12), and the new |z| (6): 76;
- HIT_OPS, a hit pixel's normal and AO evaluations besides their DE steps
  (the march's tap events as written): each of the 11 taps' start |p| (6)
  and DE (6), 132; the normal's differences, length and divides (13); the
  8 AO terms, exp(-10 d) and the sums (32); the tap positions (3 normal
  offsets, 8 x 6 along the normal): 228;
- bytes: the finished uint8 frame, written once.

The records are K4b's (the pattern below), one per frame in the order the
frames were dispatched."""
from benchmark.harness import peaks, tracing

STEP_OPS = 4 + 26 + 20 + 5 + 1 + 2 + 12 + 6
HIT_OPS = 11 * (6 + 6) + 13 + 8 * 4 + 3 + 8 * 6
PATTERN = r"bulb_march_kernel"


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    lo, hi = ctx["span"]
    recs = tracing.kernel_records(
        [e for e in tr.events if lo <= e[2] <= hi], PATTERN)
    frames = ctx["stretch_frames"]
    if len(recs) != len(frames):
        return None
    least = took = 0.0
    for f, (_, dur) in zip(frames, recs):
        w = ctx["work"].get(f)
        if w is None:
            continue
        least += peaks.least_seconds(
            w["steps"] * STEP_OPS + w["hits"] * HIT_OPS, w["bytes"])
        took += dur
    return 100.0 * least / took if took else None
