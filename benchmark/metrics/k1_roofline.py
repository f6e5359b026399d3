"""k1_roofline: kernel K1's share of its roofline (%), over the sampled
frames of the traced stretch: the least time the card could take for the
work those frames need, over K1's kernel records of those frames.

Work (frozen here; never recounted when the kernel changes):

- operations: the loop updates the frame needs, min(n, limit - 1) summed
  over the pixels outside the analytic cardioid and period-2 bulb, n from
  the plain reference's count plane; times UPDATE_OPS, the f32 operations
  of one update of the recurrence as written (mandelbrot.comp): |z|^2 =
  x^2 + y^2 (1 add; the squares come from the previous update), x' = x^2
  - y^2 + cx (2 adds), y' = (2x)y + cy (2 muls, 1 add), and the next
  update's squares x'^2, y'^2 (2 muls): 8;
- bytes: the finished uint8 frame, written once.

The records are K1's (the pattern below), one per frame in the order the
frames were dispatched."""
from benchmark.harness import peaks, tracing

UPDATE_OPS = 8
PATTERN = r"(?<!dd_)escape_kernel"


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
        least += peaks.least_seconds(w["updates"] * UPDATE_OPS, w["bytes"])
        took += dur
    return 100.0 * least / took if took else None
