"""k1_launch_ms_per_frame: the host's time in K1's launch block, per frame
of the traced stretch (ms): the self time of the program's ``k1.launch``
spans (the output planes' allocation and the ``fr_escape`` call).  Reads
the stretch's program spans."""
from benchmark.harness import spans


def read(ctx):
    return spans.ms_per_frame(ctx, ("k1.launch",))
