"""glue_launch_ms_per_frame: the host's time launching the batch path's
glue, per frame of the traced stretch (ms): the self time of the program's
``batch.glue`` spans (the planes' stack and the quantize).  The glue's
time on the card is ``glue_ms_per_frame.batch``.  Reads the stretch's
program spans."""
from benchmark.harness import spans


def read(ctx):
    return spans.ms_per_frame(ctx, ("batch.glue",))
