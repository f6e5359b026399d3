"""deep_host_ms_per_frame: the host's work on a deep frame that the card
waits for, per frame of the traced stretch (ms): the self time of the
program's ``deep.prepare`` (precision, the orbit cache's key, the shift
strings, the series), ``k3.prepare`` (the dd packing and the launch's
checks), ``deep.upload`` (the orbit's copy and interleave), ``k3.launch``
and ``deep.colour`` spans.  The glitch read-back waits for K3, so this work
lies between one frame's K3 and the next.  Reads the stretch's program
spans."""
from benchmark.harness import spans

STAGES = ("deep.prepare", "k3.prepare", "deep.upload", "k3.launch",
          "deep.colour")


def read(ctx):
    return spans.ms_per_frame(ctx, STAGES)
