"""A later cell is new files and entries only: a configuration, a traffic
mix with a camera path and a driver of new names, a per-layer metric, each
found by name, run through the window and the control with no file of
the harness edited.  And a configuration that states what a driver does
not run is refused, never run as another."""
import json
import os
import shutil

import pytest

from small_cells import ANIM, DEEP, small
from benchmark.control import run_control
from benchmark.harness import core, spec
from benchmark.harness.traffic import generate

PATH = '''
def frames(t, config, rng):
    shift = float(rng.uniform(0.0, 1.0))
    return [{"x": shift + f} for f in range(int(t["frames"]))]
'''

DRIVER = '''
import torch

from benchmark.harness import compare


class Driver:
    def __init__(self, config, traffic, checks, tr, seed, device):
        self.tr, self.checks, self.n = tr, checks, int(config["n"])
        self.units = [(f,) for f in tr.order]

    def setup(self):
        self.scale = 2.0

    def submit(self, unit):
        x = self.tr.frames[unit[0]]["x"]
        return torch.full((self.n,), x) * self.scale

    def wait(self, handle):
        pass

    def outputs(self, unit, handle):
        return [(unit[0], (handle * 100).to(torch.int64).to(torch.uint8))]

    def release(self):
        pass

    def reference(self, f, scale=2.0):
        x = self.tr.frames[f]["x"]
        return (torch.full((self.n,), x) * scale * 100).to(
            torch.int64).to(torch.uint8)

    def control_outputs(self, frames):
        return {f: self.reference(f, 2.01) for f in frames}

    def check(self, kept):
        acc = compare.Diff()
        for f in sorted(kept):
            acc.add(kept[f], self.reference(f))
        return compare.checks(acc, self.checks), {f: {} for f in kept}
'''

METRIC = '''
def read(ctx):
    return float(len(ctx["stretch_frames"])) or None
'''


def _tree(tmp_path):
    """A checkout with the benchmark as it is, plus one cell of new names
    added as new files and new entries only."""
    b = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH_DIR, b, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    files = {
        "configs/toy.json": json.dumps({"n": 64}),
        "traffic/ramp.json": json.dumps({
            "driver": "toy_driver", "path": "ramp", "frames": 5,
            "seed": {"rotate": True}}),
        "checks/toy.ramp.json": json.dumps({
            "sample_frames": 3,
            "lsb_max": {"limit": 0}, "off_share": {"limit": 0}}),
        "paths/ramp.py": PATH, "drivers/toy_driver.py": DRIVER,
        "metrics/toy_frames.py": METRIC}
    for rel, text in files.items():
        assert not (b / rel).exists()
        (b / rel).write_text(text)
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "toy",
                             "file": "benchmark/configs/toy.json"})
    bench["workloads"].append({"name": "toy.ramp", "config": "toy",
                               "traffic": "ramp", "chips": 1})
    bench["end_to_end"].insert(0, {"name": "frames_per_s.toy",
                                   "unit": "frames/s",
                                   "workloads": ["toy.ramp"]})
    bench["per_layer"] += [
        {"name": "dispatch_ms_per_frame.toy", "unit": "ms",
         "workloads": ["toy.ramp"]},
        {"name": "toy_frames", "unit": "frames", "workloads": ["toy.ramp"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return spec.load_cell("toy.ramp", str(tmp_path / "BENCHMARK.json"))


def test_a_cell_of_new_files_runs(tmp_path):
    cell = _tree(tmp_path)
    assert cell.bench_dir == str(tmp_path / "benchmark")
    r = core.run(cell, 2 ** 31 + 9, 0.05, False, device="cpu")
    assert r["correct"] is True and r["attempted"] >= 5, r["checks"]
    assert sorted(r["metrics"]) == ["frames_per_s.toy", "setup_s"]
    assert r["metrics"]["frames_per_s.toy"]["value"] > 0


def test_a_cell_of_new_files_traces(tmp_path):
    r = core.run(_tree(tmp_path), 12, 0.05, True, device="cpu")
    # a metric of a new name found by its quantity's reader, and a new
    # reader found by its own name, reading the traced pass's frames
    assert sorted(r["metrics"]) == ["dispatch_ms_per_frame.toy",
                                    "toy_frames"]
    assert r["metrics"]["toy_frames"] == {"value": 5.0, "unit": "frames"}


def test_a_cell_of_new_files_has_a_control(tmp_path):
    cell = _tree(tmp_path)
    tr = generate(cell.traffic, cell.config, cell.checks, 4, cell.bench_dir)
    assert len(tr.frames) == 5 and len(tr.sample) == 3
    assert run_control(cell, 4, "cpu")["fails"]


def test_a_metric_reader_is_found_by_name(tmp_path):
    cell = _tree(tmp_path)
    ctx = {"stretch_frames": [0, 1]}
    assert cell.module("metrics", "toy_frames").read(ctx) == 2.0
    assert spec.quantity("frames_per_s.batch") == "frames_per_s"
    with pytest.raises(FileNotFoundError):
        cell.module("drivers", "no_such_driver")


REFUSED = [
    (ANIM, "quantize_bits", 16), (ANIM, "precision", "dd"),
    (ANIM, "fractal", "julia"), (DEEP, "quantize_bits", 16),
    (DEEP, "precision", "fx"), (DEEP, "fractal", "mandelbrot"),
]


@pytest.mark.parametrize("name,key,value", REFUSED,
                         ids=lambda v: str(v))
def test_a_configuration_the_driver_does_not_run_is_refused(name, key,
                                                             value):
    cell = small(name)
    cell.config[key] = value
    with pytest.raises(ValueError):
        core.run(cell, 1, 0.05, False, device="cpu")


def test_a_frame_in_another_precision_stops_the_run(monkeypatch):
    from fractalrenderer_tpu_torch import models

    render = models.render

    def other_tier(*a, **k):
        img, info = render(*a, **k)
        return img, dict(info, dd_delta=False)
    monkeypatch.setattr(models, "render", other_tier)
    with pytest.raises(RuntimeError, match="f32 deltas"):
        core.run(small(DEEP), 2, 0.05, False, device="cpu")


def test_the_configurations_keys_are_read():
    """Every key of a configuration file is one its driver or path reads,
    or one that documents it."""
    docs = {"name", "deployment", "source", "guarantees", "assumed"}
    for name, drv in ((ANIM, "anim_batch"), (DEEP, "deep_frames")):
        cell = spec.load_cell(name)
        src = "".join(open(os.path.join(cell.bench_dir, d, f"{m}.py")).read()
                      for d, m in (("drivers", drv),
                                   ("paths", cell.traffic["path"])))
        for key in set(cell.config) - docs:
            assert f'"{key}"' in src, (name, key)
