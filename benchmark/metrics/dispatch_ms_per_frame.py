"""dispatch_ms_per_frame: the host's time inside the batch path's call for
a chunk of frames (``batch_render_fn``'s function, which returns before
the card finishes), per frame (ms), over the window's untraced chunks.
The harness's host clock around each call, which holds the program's work
alone: the driver builds each chunk's parameter columns in set-up."""


def read(ctx):
    if not ctx["dispatch_frames"]:
        return None
    return 1e3 * ctx["dispatch_s"] / ctx["dispatch_frames"]
