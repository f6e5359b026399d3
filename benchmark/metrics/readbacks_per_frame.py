"""readbacks_per_frame: the host's synchronising reads of the card's
results per deep frame of the traced stretch: the program's
``deep.readback`` spans (one per read that waits for the card) over the
stretch's frames.  Reads the stretch's program spans."""
from benchmark.harness import spans


def read(ctx):
    return spans.count_per_frame(ctx, "deep.readback")
