"""Kernel K1 (csrc/escape.cu) on the card against its plain PyTorch version
on the same card, at edge shapes and options the main path does not reach.

Needs an NVIDIA GPU and nvcc; skipped elsewhere.  The GPU machine has no
jax, so run it there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import pytest
import torch

from fractalrenderer_tpu_torch.ops import escape

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _both(dev, width, height, *, fused=None, skip=True, row0=0,
          map_height=None, max_iter=256, iter_limit=None, **view):
    view = dict(dict(center_x=-0.5, center_y=0.0, zoom=3.0), **view)
    params = escape.pack_params(
        iter_limit=max_iter if iter_limit is None else iter_limit,
        row0=row0, **view)
    kw = dict(width=width, height=height, map_height=map_height or height,
              row0=row0, max_iter_cap=max_iter, interior_skip=skip,
              fused_color=fused, device=dev)
    got = escape.escape_fields_cuda(params, **kw)
    want = escape.escape_fields_plain(params, **kw)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("case", [
    dict(width=1, height=1),
    dict(width=33, height=9),
    dict(width=257, height=130, skip=False),
    dict(width=64, height=7, row0=50, map_height=57),
    dict(width=48, height=32, max_iter=96, iter_limit=10 ** 8),
    dict(width=48, height=32, max_iter=512, iter_limit=300),
    dict(width=40, height=30, max_iter=1),
    dict(width=96, height=54, center_x=-0.743643887037151,
         center_y=0.13182590420533, zoom=0.008, max_iter=2048),
    dict(width=50, height=40, center_x=-1.0, center_y=0.0, zoom=0.6,
         bailout=2.0),
], ids=str)
def test_fields_kernel_equals_plain(dev, case):
    (n, zx, zy), (n_p, zx_p, zy_p) = _both(dev, **case)
    assert n.dtype == torch.int32 and n.shape == n_p.shape
    assert torch.equal(n, n_p)
    assert torch.equal(zx, zx_p) and torch.equal(zy, zy_p)


@pytest.mark.parametrize("fused", [
    (0, 0, False, True), (1, 1, False, True), (2, 0, True, True),
    (3, 1, False, False), (4, 0, False, True), (5, 1, True, True),
    (9, 0, False, True),
], ids=str)
def test_fused_kernel_matches_plain(dev, fused):
    got, want = _both(dev, 200, 120, fused=fused, color_offset=0.3,
                      color_scale=1.7, brightness=1.2, saturation=0.8,
                      contrast=1.3)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)


def test_launch_counter_counts_kernel_launches(dev):
    before = escape.escape_fields_cuda.launches
    f = escape.escape_fields("mandelbrot", 16, 8, center_x=-0.5,
                             center_y=0.0, zoom=3.0, max_iter=32,
                             device=dev)
    assert f["n"].device.type == "cuda"
    assert escape.escape_fields_cuda.launches == before + 1


def test_kernel_rejects_unported_styles(dev):
    params = escape.pack_params(center_x=-0.5, center_y=0.0, zoom=3.0,
                                iter_limit=16)
    with pytest.raises(NotImplementedError):
        escape.escape_fields_cuda(
            params, width=8, height=8, map_height=8, row0=0,
            max_iter_cap=16, interior_skip=False,
            fused_color=(0, 2, False, True), device=dev)
