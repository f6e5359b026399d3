"""k1_prepare_ms_per_frame: the host's time preparing K1's launches, per
frame of the traced stretch (ms): the self time of the program's
``k1.prepare`` spans (the batch loop's parameter dict and output slot,
``escape_fields``' ``pack_params``, and the CUDA wrapper's checks, flags
and ``color_table``).  Reads the stretch's program spans."""
from benchmark.harness import spans


def read(ctx):
    return spans.ms_per_frame(ctx, ("k1.prepare",))
