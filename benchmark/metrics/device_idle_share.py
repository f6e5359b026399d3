"""device_idle_share: the share of the traced stretch in which no kernel,
copy or memset ran on the card, 1 - busy / window (%): the host's part of
the frame time.  Reads the stretch's device events."""
from benchmark.harness import tracing


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    lo, hi = ctx["span"]
    busy, _ = tracing.busy_and_window(
        [e for e in tr.events if lo <= e[2] <= hi])
    return 100.0 * (1.0 - busy / (hi - lo))
