"""The program's own stage spans in the traced stretch (the
``record_function`` spans that ``fractalrenderer_tpu_torch.utils.diag.span``
opens while a profiler session records), for the per-layer metrics that
read them: self times and counts per frame.

A span's self time is its duration less the part of it that the spans
nested in it cover.  A metric reads only the spans that start inside the
stretch, and reads nothing (None) from a program that opens no frame span
there, so a checkout without the spans reports no value rather than 0.
"""
from __future__ import annotations

import bisect
from typing import Iterable, Optional

# the span that holds one frame's stages, by path
FRAME_SPANS = ("batch.frame", "deep.frame")


def _in_stretch(ctx):
    """The stretch's spans (name, start s, end s) sorted by start, or None
    where the run has no trace or the program opened no frame span in
    it."""
    tr = ctx["trace"]
    if tr is None or not ctx["stretch_frames"]:
        return None
    lo, hi = ctx["span"]
    spans = sorted((s for s in tr.spans if lo <= s[1] <= hi),
                   key=lambda s: (s[1], -s[2]))
    if not any(s[0] in FRAME_SPANS for s in spans):
        return None
    return spans


def _covered(intervals) -> float:
    """Seconds of the union of ``intervals`` [(start, end), ...]."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        total += max(0.0, b - max(a, end))
        end = max(end, b)
    return total


def self_seconds(spans, names: Iterable[str]) -> float:
    """Sum over the spans named in ``names`` of their self time: each
    span's duration less the union of the spans nested in it (those that
    start and end inside it and are shorter).  ``spans`` sorted by
    start."""
    names = set(names)
    starts = [s[1] for s in spans]
    total = 0.0
    for i, (name, a, b) in enumerate(spans):
        if name not in names:
            continue
        j = bisect.bisect_left(starts, a)
        k = bisect.bisect_right(starts, b)
        kids = [(s[1], s[2]) for m, s in enumerate(spans[j:k], j)
                if m != i and s[2] <= b and s[2] - s[1] < b - a]
        total += (b - a) - _covered(kids)
    return total


def ms_per_frame(ctx, names: Iterable[str]) -> Optional[float]:
    """Self time of the spans named in ``names`` over the stretch, per
    frame of the stretch (ms); None where the program opened no frame
    span."""
    spans = _in_stretch(ctx)
    if spans is None:
        return None
    return 1e3 * self_seconds(spans, names) / len(ctx["stretch_frames"])


def count_per_frame(ctx, name: str) -> Optional[float]:
    """The spans named ``name`` in the stretch, per frame of the stretch;
    None where the program opened no frame span."""
    spans = _in_stretch(ctx)
    if spans is None:
        return None
    return sum(s[0] == name for s in spans) / len(ctx["stretch_frames"])
