"""Device events from a torch.profiler chrome trace, and the arithmetic
the per-layer metrics read from them.

Frozen copy of the trace arithmetic of ``fractalrenderer_tpu_torch/utils/
diag.py`` at commit f3d0ace5ea09 (``device_seconds_from_trace``'s check for
lost device records, ``device_events_from_trace``, ``busy_and_window``,
``kernel_records_from_trace``), changed only to read an exported trace
file's events instead of the newest file of a directory, and to keep the
host annotations (``record_function`` spans) that label the idle gaps.
The benchmark never imports the program's copy: a later change to it must
not move the yardstick.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import List, Tuple

_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}  # Kineto's names
# the host calls that put work on the card: each has a device event with
# its correlation id in a whole trace
_ENQUEUES = re.compile(r"Launch(Kernel|CooperativeKernel)|Memcpy|Memset")

# (name, category, start s, seconds)
Event = Tuple[str, str, float, float]


class LostRecords(ValueError):
    """A trace of a card's run that lacks device events: none at all, or
    none for some of the launches and copies the host made in it."""


@dataclass
class Trace:
    """The device events of a trace in the order the card ran them, and the
    host annotations ``(name, start s, end s)``."""

    events: List[Event] = field(default_factory=list)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)


def _correlation(e):
    return (e.get("args") or {}).get("correlation")


def parse_trace(raw: dict) -> Trace:
    """The device events and host annotations of a chrome trace (the dict
    ``export_chrome_trace`` writes).  Raises LostRecords when the trace
    holds no device event, or when a launch, copy or memset the host made
    in it has no device event of its correlation id."""
    events = [e for e in raw.get("traceEvents", []) if e.get("ph") == "X"]
    on_device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    enqueued = {_correlation(e) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and _ENQUEUES.search(e.get("name", ""))}
    lost = enqueued - {_correlation(e) for e in on_device}
    if not on_device or lost:
        raise LostRecords(f"{len(lost)} of {len(enqueued)} launches and "
                          f"copies have no device event "
                          f"({len(on_device)} device events)")
    dev = [(e.get("name", ""), e["cat"], e.get("ts", 0) / 1e6,
            e.get("dur", 0) / 1e6)
           for e in sorted(on_device, key=lambda e: e.get("ts", 0))]
    spans = [(e.get("name", ""), e.get("ts", 0) / 1e6,
              (e.get("ts", 0) + e.get("dur", 0)) / 1e6)
             for e in events if e.get("cat") == "user_annotation"]
    return Trace(dev, spans)


def busy_and_window(events) -> tuple:
    """(busy seconds, window seconds) of device ``events``: the union of
    their intervals, and the span from the first one's start to the last
    one's end.  The idle share of the window is 1 - busy / window."""
    busy, end, first, last = 0.0, -math.inf, math.inf, -math.inf
    for _, _, start, dur in sorted(events, key=lambda e: e[2]):
        busy += max(0.0, start + dur - max(start, end))
        end = max(end, start + dur)
        first, last = min(first, start), max(last, start + dur)
    return busy, (last - first if events else 0.0)


def kernel_records(events, pattern: str) -> List[Tuple[float, float]]:
    """``[(start s, seconds), ...]`` of the kernel records whose name
    matches the regular expression ``pattern``, in the order the card ran
    them."""
    rx = re.compile(pattern)
    return [(start, dur) for name, cat, start, dur in events
            if cat == "kernel" and rx.search(name)]


def seconds_by_name(events) -> List[Tuple[str, float]]:
    """Device seconds summed by event name, largest first."""
    out = {}
    for name, _, _, dur in events:
        out[name] = out.get(name, 0.0) + dur
    return sorted(out.items(), key=lambda kv: -kv[1])


def idle_gaps(events, spans, lo: float, hi: float):
    """The device's idle gaps inside [lo, hi], longest first, each labelled
    by the innermost host annotation open at the gap's middle:
    ``[(label, seconds), ...]``."""
    gaps, end = [], lo
    for _, _, start, dur in sorted(events, key=lambda e: e[2]):
        if start > end:
            gaps.append((end, start))
        end = max(end, start + dur)
    if hi > end:
        gaps.append((end, hi))
    out = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        open_ = [s for s in spans if s[1] <= mid <= s[2]]
        label = min(open_, key=lambda s: s[2] - s[1])[0] if open_ else "none"
        out.append((label, b - a))
    return sorted(out, key=lambda g: -g[1])
