"""A run with the timed path broken underneath comes out not correct: the
look for a card skipped, the program's plain versions on the CPU, each
fault the cell can have planted in the port's entry."""
import pytest
import torch

from small_cells import ANIM, DEEP, small
from benchmark.harness import core


def _stale(fn):
    """A step that hands back its previous result unchanged."""
    last = []

    def broken(*a, **k):
        out = fn(*a, **k)
        if last:
            return last[0]
        last.append(out)
        return out
    return broken


def _alter_one_value(out):
    out = out.clone()
    flat = out.view(-1)
    flat[flat.numel() // 3] ^= 0x80  # one value's top bit flipped
    return out


ANIM_FAULTS = {
    "state_unchanged": lambda fn: _stale(fn),
    # the second half of each chunk left out: those slots never written
    "half_batch_left_out": lambda fn: lambda batch: _half(fn, batch),
    "answer_altered": lambda fn: lambda batch: torch.stack(
        [_alter_one_value(f) for f in fn(batch)]),
}


def _half(fn, batch):
    b = len(next(iter(batch.values())))
    keep = max(b // 2, 1)
    out = fn({k: v[:keep] for k, v in batch.items()})
    full = torch.zeros((b,) + tuple(out.shape[1:]), dtype=out.dtype)
    full[:keep] = out
    return full


@pytest.mark.parametrize("fault", sorted(ANIM_FAULTS))
def test_anim_faults_are_not_correct(fault, monkeypatch):
    from fractalrenderer_tpu_torch.models import common

    make = common.batch_render_fn
    monkeypatch.setattr(common, "batch_render_fn", lambda *a, **k:
                        ANIM_FAULTS[fault](make(*a, **k)))
    r = core.run(small(ANIM), 2 ** 31 + 21, 0.3, False, device="cpu")
    assert r["correct"] is False, r["checks"]


def test_anim_unbroken_is_correct():
    r = core.run(small(ANIM), 2 ** 31 + 21, 0.3, False, device="cpu")
    assert r["correct"] is True, r["checks"]


def _column_altered(img):
    img = img.clone()
    img[:, 5, 1] ^= 1  # one channel of one column, in every row
    return img


def _rows_left_out(img):
    img = img.clone()
    img[img.shape[0] // 2:] = 0
    return img


def _on_image(fault):
    """``fault`` applied to the image of a render that may come back with
    its info."""
    def apply(out):
        if isinstance(out, tuple):
            return (fault(out[0]),) + out[1:]
        return fault(out)
    return apply


DEEP_FAULTS = {
    "state_unchanged": lambda fn: _stale(fn),
    "half_rows_left_out": lambda fn: lambda *a, **k: _on_image(
        _rows_left_out)(fn(*a, **k)),
    "answer_altered": lambda fn: lambda *a, **k: _on_image(
        _column_altered)(fn(*a, **k)),
}


@pytest.mark.parametrize("fault", sorted(DEEP_FAULTS))
def test_deep_faults_are_not_correct(fault, monkeypatch):
    from fractalrenderer_tpu_torch import models

    make = models.render
    monkeypatch.setattr(models, "render", DEEP_FAULTS[fault](make))
    cell = small(DEEP, frames=4)
    r = core.run(cell, 2 ** 31 + 5, 0.3, False, device="cpu")
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("name", [ANIM, DEEP])
def test_wait_covers_every_stream(name, monkeypatch):
    """A unit counts as finished once the whole card has finished, not its
    current stream alone: work the program puts on a side stream is
    waited for too."""
    from benchmark.harness.traffic import generate

    cell = small(name)
    tr = generate(cell.traffic, cell.config, cell.checks, 3, cell.bench_dir)
    drv = cell.module("drivers", cell.traffic["driver"]).Driver(
        cell.config, cell.traffic, cell.checks, tr, 3, "cuda:0")
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: 1 / 0)
    drv.wait(None)
    assert calls == [torch.device("cuda:0")]


@pytest.mark.cuda
def test_side_stream_renderer_does_not_raise_the_rate():
    """A batch path that renders on a side stream and returns at once is
    timed to the end of its work: the window's rate stays under what the
    side stream's work allows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmark.harness.traffic import generate

    cell = small(ANIM)
    tr = generate(cell.traffic, cell.config, cell.checks, 4, cell.bench_dir)
    drv = cell.module("drivers", cell.traffic["driver"]).Driver(
        cell.config, cell.traffic, cell.checks, tr, 4, "cuda:0")
    drv.setup()
    side = torch.cuda.Stream()
    # ~20 ms of spinning on the side stream per chunk, calibrated here
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    torch.cuda._sleep(10 ** 7)
    t1.record()
    t1.synchronize()
    cycles = int(10 ** 7 * 20.0 / t0.elapsed_time(t1))
    render = drv.fn

    def on_side_stream(batch):
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            torch.cuda._sleep(cycles)
            return render(batch)
    drv.fn = on_side_stream
    win = core.measure(drv, drv.units, 1.0, False, "cuda:0", set())
    per_chunk = win.seconds / (win.frames / len(drv.units[0]))
    assert per_chunk >= 0.015, per_chunk
