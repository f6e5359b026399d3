"""rebase_passes_per_frame: the rebase rounds of a deep frame's most
restarted pixel, on average over the process's frames (set-up, window and
traced stretch): the program's counters
``models.deep_zoom.render.rebase_passes`` (the sum over frames of the
``passes`` each frame's render reads back) over
``models.deep_zoom.render.frames``.  None where the program has no such
counter."""
import sys


def read(ctx):
    deep = sys.modules.get("fractalrenderer_tpu_torch.models.deep_zoom")
    render = getattr(deep, "render", None)
    passes = getattr(render, "rebase_passes", None)
    frames = getattr(render, "frames", None)
    if passes is None or not frames:
        return None
    return passes / frames
