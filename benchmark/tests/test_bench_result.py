"""The shape of a run's last line, and the runs that must print none: no
card, too few cards, a directory with the benchmark but not the port."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from small_cells import ANIM, DEEP, ROOT, small
from benchmark.harness import core

DEVICE_KEYS = ["platform", "kind", "count", "memory_peak_bytes"]


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_shape(trace):
    cell = small(ANIM)
    r = core.run(cell, 2 ** 31 + 3, 0.2, bool(trace), device="cpu")
    keys = list(r)
    assert keys[:3] == ["correct", "attempted", "failed"]
    assert keys[-1] == "checks"
    assert {"metrics", "device"} <= set(keys)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert list(r["device"])[:4] == DEVICE_KEYS
    want = ([m["name"] for m in cell.end_to_end] if not trace
            else ["dispatch_ms_per_frame"])  # no device trace on the CPU
    assert sorted(r["metrics"]) == sorted(want)
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


def test_e2e_metrics_follow_the_cell():
    names = [m["name"] for m in small(DEEP).end_to_end]
    assert sorted(names) == ["frame_p95_ms", "frames_per_s", "setup_s"]
    names = [m["name"] for m in small(ANIM).end_to_end]
    assert sorted(names) == ["frames_per_s.batch", "setup_s"]


def test_main_prints_the_checks_last(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cell = small(ANIM)
    monkeypatch.setattr(core.spec, "load_cell", lambda name: cell)
    run = core.run
    monkeypatch.setattr(core, "run", lambda *a, **k: run(
        *a, **dict(k, device="cpu")))
    assert core.main(["--workload", ANIM, "--seed", "5", "--seconds",
                      "0.2", "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    tail = err.strip().splitlines()[-2:]
    assert [t.split(":")[0] for t in tail] == ["check lsb_max",
                                               "check off_share"]


def test_too_few_cards_prints_nothing(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert core.main(["--workload", ANIM, "--seed", "1", "--seconds", "1",
                      "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def _run(cwd):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", DEEP, "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, env=env, timeout=300)


def test_no_card_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_without_the_port_prints_nothing(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
