"""k3fx_roofline: kernel K3's floatexp instance's share of its roofline
(%), over the sampled frames of the traced stretch: the least time the
card could take for the work those frames need, over K3's kernel records
of those frames.

Work (frozen here; never recounted when the kernel changes):

- operations: the delta steps the frame needs, n per pixel with the
  series off, n from the plain reference's count planes over the sampled
  rows, scaled to the frame by its rows over the sampled rows; times
  STEP_OPS, the f32 and integer operations of one floatexp Mandelbrot step
  of d <- 2 Z d + d^2 + dc with its rebase test, as written
  (ops/perturbation.py's plain ``_fx_aligned_step`` and its branch of the
  loop), counted as ``k3_roofline`` counts the dd step: 7 dd products of
  10 (70); 7 dd sums of 11 (the three of 2Zd and d^2, the two that align
  them, the two that add dc: 77); 6 exact doublings (2Z, 2 d_re d_im);
  12 products that align the terms by powers of two; the exponents' 24
  (2ex, the max of ex, 2ex and -s, three differences, three 2^k of 6
  each: clamp 2, the shift 2, the test and select 2); the renormalisation
  of 23 (max |m| 3, its zero test 1, its exponent field 4, 2^-k 7, the new
  exponent 4, the two mantissas 4); the rebase test's 30 (2^ex 6, the full
  value Z + m 2^ex 10, |z|^2 3, |d|^2 scaled by 2^2ex 11): 70 + 77 + 6 +
  12 + 24 + 23 + 30 = 242;
- bytes: the finished uint8 frame, written once.

The records are K3's (the pattern below), one per frame in the order the
frames were dispatched."""
from benchmark.harness import peaks, tracing

STEP_OPS = 7 * 10 + 7 * 11 + 6 + 12 + 24 + 23 + 30
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
