"""glue_ms_per_frame: the card's time in everything a frame launches
besides its escape kernel (K1) or perturbation kernel (K3) — colour,
quantize, planes zeroed, stacks, copies and memsets — per frame of the
traced stretch (ms).  Reads the stretch's device events; which records are
K1 or K3 is the name pattern below."""
import re

MAIN_KERNELS = re.compile(r"(?<!dd_)escape_kernel|pert_kernel")


def read(ctx):
    tr = ctx["trace"]
    frames = ctx["stretch_frames"]
    if tr is None or not frames:
        return None
    lo, hi = ctx["span"]
    glue = sum(dur for name, _, start, dur in tr.events
               if lo <= start <= hi and not MAIN_KERNELS.search(name))
    return 1e3 * glue / len(frames)
