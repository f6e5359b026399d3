"""bulb_glue_ms_per_frame: the card's time in everything a bulb frame
launches besides its cone prepass (K4a) and its march (K4b) — the ray
grid, the hit and sky shading, the AA sum, the post chain, the quantize,
the march queue's zeroed head, copies and memsets — per frame of the
traced stretch (ms).  Reads the stretch's device events; which records are
K4a or K4b is the name pattern below."""
import re

BULB_KERNELS = re.compile(r"bulb_(cone|march)_kernel")


def read(ctx):
    tr = ctx["trace"]
    frames = ctx["stretch_frames"]
    if tr is None or not frames:
        return None
    lo, hi = ctx["span"]
    glue = sum(dur for name, _, start, dur in tr.events
               if lo <= start <= hi and not BULB_KERNELS.search(name))
    return 1e3 * glue / len(frames)
