"""fx_scale_ms_per_frame: the host's exact-rational work of the floatexp
tier per deep frame of the traced stretch (ms): the self time of the
program's ``k3.fx_scale`` spans (the pixel step's 2^s pre-scale, the
shift times 2^s and their rounding to f32 pairs), nested in
``k3.prepare``.  None where the program opened no such span in the
stretch.  Reads the stretch's program spans."""
from benchmark.harness import spans

NAME = "k3.fx_scale"


def read(ctx):
    if not spans.count_per_frame(ctx, NAME):
        return None
    return spans.ms_per_frame(ctx, (NAME,))
