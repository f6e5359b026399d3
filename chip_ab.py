#!/usr/bin/env python3
"""Time the port's K2 and K3 kernels of this checkout against those of
another commit, in turns, on one card.

    python3 chip_ab.py OTHER_ROOT [--reps 3] [--out FILE]

OTHER_ROOT holds the other commit's ``fractalrenderer_tpu_torch/`` package,
for example from ``git archive <commit> fractalrenderer_tpu_torch | tar -x
-C _parent/`` (``_parent/`` is git-ignored).  Each side runs in processes
of its own, which import that side's package (its wrappers, its C
interface, its kernels, built into its own ``_build/``), in the order
other, this, this, other.  A process packs every case's operands (the
cases, views and sizes are this checkout's chip_smoke.py's: K2 at the
Seahorse 1e-9 view, and every K3 instance at its main frame, config 4
series off and on and its stacked spp-2 launch, the families, the ledger
and the single pass), then launches each case once to warm up and
``--reps`` times, each launch timed by CUDA events, then ``--reps`` times
more under the profiler, whose kernel records give the kernel's own
device time per launch (the events also hold the wrapper's host work and
its glue kernels).  A case's line gives each side's kernel time (the mean
of its two processes' means, each beside it), its event median and runs,
the ratio this / other of the kernel times, and whether the two sides'
output planes are bit-identical.  The
card's name and power limit come first, then the two builds' ptxas
reports (registers / stack frame bytes / spill bytes per instance) side by
side; a spill in this checkout's build fails the run.  With ``--out``
everything is also written as one JSON object.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
TURNS = ("other", "this", "this", "other")


def chip_smoke():
    """This checkout's chip_smoke.py (its cases and helpers), whichever
    package the process imports."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_cases", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cases(cs, dev):
    """(instance, label, the launch as a function of nothing) of every
    case, its operands on the card."""
    import torch

    from fractalrenderer_tpu_torch.ops import dd, dd_escape, perturbation

    v = cs.DD_VIEW
    dd_params = dd_escape.pack_dd_params(
        center_x_dd=dd.dd_from_string(v["cx"]),
        center_y_dd=dd.dd_from_string(v["cy"]),
        zoom_dd=dd.dd_from_string(v["zoom"]), iter_limit=v["iters"])
    yield ("dd_escape_mandelbrot", f"Seahorse {v['zoom']} x{v['iters']}",
           lambda: dd_escape.dd_escape_fields_cuda(
               dd_params, width=cs.W, height=cs.H, map_height=cs.H, row0=0,
               device=dev))

    def pert(view, width, height, series=False, **extra):
        orb, kw, _ = cs.pert_setup(view, width, height, series,
                                   exact_dust=extra.get("track_err", False))
        params, streams, launch = perturbation.pack_pert_operands(
            orb, width, height, **kw, **extra)
        streams = [torch.from_numpy(a).to(dev) for a in streams]
        return lambda: perturbation.perturbation_fields_cuda(
            params, streams, max_passes=256, device=dev, **launch)

    for name, label, view, w, h, series in cs.PERT_CASES:
        yield name, label, pert(view, w, h, series)
    yield (cs.STACKED, "config 4 (1e-12 x10000), 4 segments in one launch",
           pert("config4", cs.W, cs.H, aa_spp=2))
    for name, label, view, w, h, extra in cs.FORM_CASES:
        yield name, label, pert(view, w, h, **extra)


def worker(root: str, reps: int) -> dict:
    """One side's process: build and load ``root``'s kernels, then time
    every case; returns its ptxas report and, per case, its event runs,
    its kernel's mean device ms per launch and the sha256 of its output
    planes."""
    sys.path.insert(0, root)
    import torch

    import fractalrenderer_tpu_torch as pkg
    from fractalrenderer_tpu_torch.ops import _cuda
    from fractalrenderer_tpu_torch.utils import diag

    assert os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__))) \
        == os.path.abspath(root), (pkg.__file__, root)
    cs = chip_smoke()
    dev = torch.device("cuda", 0)
    _cuda.load_library()
    with open(_cuda.library_path()[:-3] + ".log") as f:
        report = cs.ptxas_report(f.read())
    rows = []
    for name, label, launch in cases(cs, dev):
        outs = launch()
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for o in outs:
            digest.update(o.cpu().numpy().tobytes())
        runs = [cs.cuda_event_ms(launch)[1] for _ in range(reps)]
        with tempfile.TemporaryDirectory() as d:
            diag.measure_device_seconds(
                lambda: [launch() for _ in range(reps)], d, dev)
            recs = diag.kernel_seconds_from_trace(d)
        ours = [v for k, v in recs.items()
                if "pert_kernel" in k or "dd_escape_kernel" in k]
        assert sum(v[0] for v in ours) == reps, recs
        rows.append(dict(name=name, label=label, runs=runs,
                         kernel_ms=sum(v[1] for v in ours) / reps * 1e3,
                         sha256=digest.hexdigest()))
    return dict(root=root, ptxas=report, cases=rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_root")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out")
    ap.add_argument("--worker", help=argparse.SUPPRESS)  # a side's process
    args = ap.parse_args()
    if args.worker:
        result = worker(args.other_root, args.reps)
        with open(args.worker, "w") as f:
            json.dump(result, f)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    other = os.path.abspath(args.other_root)
    if not os.path.isdir(os.path.join(other, "fractalrenderer_tpu_torch")):
        print(f"error: {other} holds no fractalrenderer_tpu_torch/",
              file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0], flush=True)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for k, side in enumerate(TURNS):
            path = os.path.join(tmp, f"{k}.json")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            other if side == "other" else HERE,
                            "--reps", str(args.reps), "--worker", path],
                           check=True)
            with open(path) as f:
                results.append(json.load(f))
    reports = {side: r["ptxas"] for side, r in zip(TURNS, results)}
    assert all(r["spill"] == 0 for r in reports["this"].values()), \
        f"local-memory spills: {reports['this']}"
    names = sorted(n for n in reports["this"]
                   if n.startswith(("pert_", "dd_escape")))
    print("ptxas registers/stack frame bytes/spill bytes, other -> this: "
          + ", ".join(
              f"{n} " + " -> ".join(
                  "{regs}/{stack}/{spill}".format(**r[n]) if n in r else "-"
                  for r in (reports["other"], reports["this"]))
              for n in names), flush=True)
    rows = []
    for i, case in enumerate(results[0]["cases"]):
        turns = [r["cases"][i] for r in results]
        assert len({t["name"] for t in turns}) == 1, turns
        runs = {side: [] for side in ("other", "this")}
        kernel = {side: [] for side in ("other", "this")}
        for side, t in zip(TURNS, turns):
            runs[side] += t["runs"]
            kernel[side].append(t["kernel_ms"])
        med = {k: statistics.median(v) for k, v in runs.items()}
        kms = {k: statistics.mean(v) for k, v in kernel.items()}
        same = len({t["sha256"] for t in turns}) == 1
        rows.append(dict(name=case["name"], label=case["label"],
                         other_kernel_ms=kms["other"],
                         this_kernel_ms=kms["this"],
                         ratio=kms["this"] / kms["other"],
                         other_kernel_runs=kernel["other"],
                         this_kernel_runs=kernel["this"],
                         other_event_ms=med["other"],
                         this_event_ms=med["this"],
                         other_event_runs=runs["other"],
                         this_event_runs=runs["this"],
                         outputs_identical=same))
        print(f"{case['name']} {case['label']}: kernel other "
              f"{kms['other']:.3f} ms {[round(t, 3) for t in kernel['other']]}"
              f", this {kms['this']:.3f} ms "
              f"{[round(t, 3) for t in kernel['this']]}, this / other "
              f"{kms['this'] / kms['other']:.3f}; CUDA events other "
              f"{med['other']:.3f} ms (runs "
              f"{[round(t, 3) for t in runs['other']]}), this "
              f"{med['this']:.3f} ms (runs "
              f"{[round(t, 3) for t in runs['this']]}); output planes "
              + ("bit-identical" if same else "DIFFER") + " between the "
              "two sides", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(ptxas=reports, cases=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
