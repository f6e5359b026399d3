"""batch_post_ms_per_frame: the host's time in a 2D frame's sample
average and post chain, per frame of the traced stretch (ms): the self
time of the program's ``batch.post`` spans (``band_render_fn``'s copy of
the frame's scalars, the average's divisor, the divide, the post chain's
launches and the copy into the frame's slot; on the card the two copies
wait for the frame's queued launches).  None where the program opened no
such span in the stretch.  Reads the stretch's program spans."""
from benchmark.harness import spans

NAME = "batch.post"


def read(ctx):
    if not spans.count_per_frame(ctx, NAME):
        return None
    return spans.ms_per_frame(ctx, (NAME,))
