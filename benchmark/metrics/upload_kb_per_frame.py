"""upload_kb_per_frame: the bytes K3's wrapper copies to the card per deep
frame (KiB): the program's counters ``perturbation_fields_cuda.upload_bytes``
over ``models.deep_zoom.render.frames``, over every frame of the process
(set-up, window and traced stretch).  Every frame of the cell renders
against one cached orbit, so each uploads the same bytes and the ratio is
each frame's figure.  None where the program has no such counters."""
import sys


def read(ctx):
    pert = sys.modules.get("fractalrenderer_tpu_torch.ops.perturbation")
    deep = sys.modules.get("fractalrenderer_tpu_torch.models.deep_zoom")
    uploaded = getattr(getattr(pert, "perturbation_fields_cuda", None),
                       "upload_bytes", None)
    frames = getattr(getattr(deep, "render", None), "frames", None)
    if uploaded is None or not frames:
        return None
    return uploaded / frames / 1024
