"""k1_sweep_roofline: kernel K1's share of its roofline (%) in the Julia
c sweep, over the sampled frames of the traced stretch: the least time the
card could take for the work those frames need, over K1's kernel records
of those frames.

Work (frozen here; never recounted when the kernel changes):

- operations: each sample's loop updates, min(n, limit - 1) summed over
  every pixel (a Julia frame has no interior skip), n from the plain
  reference's per-sample count planes, summed over the frame's samples;
  times UPDATE_OPS, the f32 operations of one update of z^2 + c as
  written (julia.comp:240-246): |z|^2 = x^2 + y^2 (1 add; the squares
  come from the previous update), x' = x^2 - y^2 + cx (2 adds),
  y' = (2x)y + cy (2 muls, 1 add), and the next update's squares x'^2,
  y'^2 (2 muls): 8;
- bytes: the finished f32 (H, W, 3) frame, written once.

The records are K1's (the pattern below), one a sample, so the work's
``samples`` per frame, in the order the frames were dispatched; None where
they do not pair up with the stretch's frames."""
from benchmark.harness import peaks, tracing

UPDATE_OPS = 8
PATTERN = r"(?<!dd_)escape_kernel"


def read(ctx):
    tr = ctx["trace"]
    frames = ctx["stretch_frames"]
    if tr is None or not frames:
        return None
    per = {w.get("samples") for w in ctx["work"].values()}
    if len(per) != 1 or None in per:
        return None
    s = per.pop()
    lo, hi = ctx["span"]
    recs = tracing.kernel_records(
        [e for e in tr.events if lo <= e[2] <= hi], PATTERN)
    if len(recs) != s * len(frames):
        return None
    least = took = 0.0
    for i, f in enumerate(frames):
        w = ctx["work"].get(f)
        if w is None:
            continue
        least += peaks.least_seconds(w["updates"] * UPDATE_OPS, w["bytes"])
        took += sum(dur for _, dur in recs[i * s:(i + 1) * s])
    return 100.0 * least / took if took else None
