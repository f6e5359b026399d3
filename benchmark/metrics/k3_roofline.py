"""k3_roofline: kernel K3's share of its roofline (%), over the sampled
frames of the traced stretch: the least time the card could take for the
work those frames need, over K3's kernel records of those frames.

Work (frozen here; never recounted when the kernel changes):

- operations: the delta steps the frame needs, n - (n0 - 1) per pixel
  (n0 = 1 with the series off, so n), n from the plain reference's count
  planes over the sampled rows, scaled to the frame by its rows over the
  sampled rows; times STEP_OPS, the f32 operations of one double-double
  step of d <- 2 Z d + d^2 + dc with its rebase test, as written
  (ops/perturbation.py's plain dd step): 7 dd products of 10 (the exact
  product, a mul and a fused multiply-add counted as 2, 3; the two cross
  products and their sum, 3; the add to the error term and the
  renormalisation, 4), 7 dd sums of 11 (two-sum 6, the low parts' sum and
  its add 2, the renormalisation 3), 6 exact doublings of dd parts (2Z
  and 2 d_re d_im), the full value z = Z + d (6 adds) and the squared
  magnitudes of z and d (6): 70 + 77 + 6 + 6 + 6 = 165;
- bytes: the finished uint8 frame, written once.

The records are K3's (the pattern below), one per frame in the order the
frames were dispatched."""
from benchmark.harness import peaks, tracing

STEP_OPS = 7 * 10 + 7 * 11 + 6 + 6 + 6
PATTERN = r"pert_kernel"


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
        least += peaks.least_seconds(w["steps"] * STEP_OPS, w["bytes"])
        took += dur
    return 100.0 * least / took if took else None
