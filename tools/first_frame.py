#!/usr/bin/env python3
"""A fresh process's first main-path frame on the card, split into its
stages (bench config 0's warm first frame: the kernels already built).

    python3 tools/first_frame.py [--runs N]

Builds the port's kernels once, then starts ``N`` fresh Python processes,
each of which renders the default scene at 1920x1080 on the card and
writes its PNG, and prints one line of stage seconds per process:
interpreter start, the imports of torch and of the package, CUDA start
(the context and a first launch), library load (the built kernels),
render (quantized on the card, its first launches), flip + fetch, PNG,
and the process's wall time.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One fresh process's frame; argv[1] is the parent's clock when it started
# the process, argv[2] the PNG path.
FIRST_FRAME = r"""
import json, sys, time
t = {"start": time.time() - float(sys.argv[1])}
t0 = time.perf_counter()
import torch
tt = time.perf_counter()
from fractalrenderer_tpu_torch import Scene, models
from fractalrenderer_tpu_torch.ops import _cuda
from fractalrenderer_tpu_torch.utils import png
from fractalrenderer_tpu_torch.utils.image import to_export_orientation
t1 = time.perf_counter()
dev = torch.device("cuda", 0)
torch.zeros(1, device=dev).sum().item()
t2 = time.perf_counter()
_cuda.load_library()
t3 = time.perf_counter()
img = models.render(Scene(), 1920, 1080, device=dev, quantize=8)
torch.cuda.synchronize()
t4 = time.perf_counter()
host = to_export_orientation(img).cpu().numpy()
t5 = time.perf_counter()
png.write_png(sys.argv[2], host)
t6 = time.perf_counter()
t.update(import_torch=tt - t0, import_package=t1 - tt, cuda_start=t2 - t1,
         library_load=t3 - t2,
         render=t4 - t3, flip_fetch=t5 - t4, png=t6 - t5)
print(json.dumps(t))
"""


def first_frame_split(runs: int = 1) -> None:
    """The warm first frame of ``runs`` fresh processes, stage by stage:
    interpreter start, the imports of torch and of the package, CUDA start
    (the context and a first launch), library load (the built kernels), render
    (1920x1080 quantized on the card, its first launches), flip + fetch,
    PNG; and the process's wall time."""
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for _ in range(runs):
            t0 = time.time()
            out = subprocess.run(
                [sys.executable, "-c", FIRST_FRAME, repr(t0),
                 os.path.join(tmp, "f.png")], cwd=ROOT, capture_output=True,
                text=True, timeout=300)
            wall = time.time() - t0
            assert out.returncode == 0, out.stderr[-2000:]
            row = json.loads(out.stdout.strip().splitlines()[-1])
            rows.append(dict(row, wall=wall))
    print("a fresh process's first main-path frame, kernels built, s: "
          + "; ".join(", ".join(f"{k} {v:.3f}" for k, v in r.items())
                      for r in rows), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from fractalrenderer_tpu_torch.ops import _cuda

    _cuda.load_library()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0], flush=True)
    first_frame_split(args.runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
