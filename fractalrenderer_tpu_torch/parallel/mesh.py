"""Device grids for band rendering (the port's counterpart of
``fractalrenderer_tpu/parallel/mesh.py``).

The reference is strictly single-GPU/single-queue (SURVEY.md §2.4).  The
scaling axes are:

- ``rows``: the image's row-block axis — a gather-free spatial decomposition
  (each device owns a contiguous horizontal band; nothing crosses devices
  but the final assembly on the host).
- ``frames``: the animation/batch axis — Julia c-sweeps and .franim frames
  split trivially.

The JAX package builds a ``jax.sharding.Mesh`` and lets ``shard_map``
place each band.  Here a :class:`RenderMesh` is a plain (frames × rows) grid
of ``torch.device`` s, and the callers in ``parallel/tiled.py`` dispatch
each band to its device themselves.  A grid may repeat one device (one
card, or the CPU in the tests): the bands then run one after another on it,
and the decomposition is the same.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class RenderMesh:
    """A (frames × rows) grid of devices: ``devices[f][r]``."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict:
        return {"frames": len(self.devices), "rows": len(self.devices[0])}


def make_render_mesh(n_devices: Optional[int] = None, frames: int = 1,
                     devices: Optional[Sequence] = None) -> RenderMesh:
    """Build a (frames, rows) grid over ``devices`` (default: every visible
    CUDA device; none raises).  With frames=1 the grid is purely spatial.
    ``devices`` may repeat a device, e.g. ``[torch.device("cpu")] * 8``."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("make_render_mesh: no CUDA device is visible "
                               "(pass devices=[...] for another grid)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"{n} devices requested, {len(devs)} given")
    devs = devs[:n]
    if n % frames != 0:
        raise ValueError(f"{n} devices not divisible by frames={frames}")
    rows = n // frames
    return RenderMesh(tuple(tuple(devs[f * rows:(f + 1) * rows])
                            for f in range(frames)))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def row_bands(height: int, n_rows: int) -> List[Tuple[int, int]]:
    """(row0, rows) of each of ``n_rows`` devices' bands of a
    ``height``-row image: the JAX package's padded band height
    ceil(height / n_rows), with the last bands clamped to the image (and
    left out where they start past it), since every wrapper refuses rows
    outside the image.  A pixel depends only on its global row, so the
    rows are those of the padded decomposition."""
    band_h = pad_to_multiple(height, n_rows) // n_rows
    return [(r0, min(band_h, height - r0))
            for r0 in range(0, band_h * n_rows, band_h) if r0 < height]
