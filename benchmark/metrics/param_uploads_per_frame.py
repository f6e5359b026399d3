"""param_uploads_per_frame: the copies of a 2D frame's host scalars to
the card, per warm frame: the growth of the program's counter
``models.common.band_render_fn.param_uploads`` (one per
``torch.tensor(..., device=)`` of the frame's scalars, on the card a
synchronising pageable copy) over the frames rendered after set-up,
which the driver reads into each sampled frame's work.  0 means a warm
frame copies nothing.  None where the program has no such counter."""


def read(ctx):
    vals = {w.get("param_uploads") for w in ctx["work"].values()}
    if len(vals) != 1 or None in vals:
        return None
    return float(vals.pop())
