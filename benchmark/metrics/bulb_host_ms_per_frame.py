"""bulb_host_ms_per_frame: the host's work on a bulb frame, per frame of
the traced stretch (ms): the self time of the program's ``bulb.prepare``
(the camera, the scalar tensors, the ray grid and its directions),
``k4a.launch`` (the cone vector and K4a's call), ``k4b.launch`` (the march
vector, its checks and K4b's call), ``bulb.shade`` (``shade_hit``,
``sky_color`` and the select) and ``bulb.post`` (the AA sum, the post
chain and the quantize) spans.  Reads the stretch's program spans; None
where the program opens no ``bulb.frame`` span in the stretch (the
harness's ``spans.ms_per_frame`` looks for the batch and deep frame spans
alone, so this reader finds the bulb's itself)."""
from benchmark.harness import spans

STAGES = ("bulb.prepare", "k4a.launch", "k4b.launch", "bulb.shade",
          "bulb.post")
FRAME = "bulb.frame"


def read(ctx):
    tr = ctx["trace"]
    frames = ctx["stretch_frames"]
    if tr is None or not frames:
        return None
    lo, hi = ctx["span"]
    inside = sorted((s for s in tr.spans if lo <= s[1] <= hi),
                    key=lambda s: (s[1], -s[2]))
    if not any(s[0] == FRAME for s in inside):
        return None
    return 1e3 * spans.self_seconds(inside, STAGES) / len(frames)
