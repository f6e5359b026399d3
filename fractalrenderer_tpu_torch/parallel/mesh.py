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

:func:`perturbation_fields_sharded` is the row split at the level of K3's
field planes, which ``models/deep_zoom.render_fields(mesh=)`` takes; this
module imports no model.
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


def to_host(parts: List[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """Concatenate band tensors on the host, each fetched from its
    device."""
    return torch.cat([p.cpu() for p in parts], dim=dim)


def perturbation_fields_sharded(orbit, width, height, *, mesh=None,
                                keep_device: bool = False, **pert_kw):
    """Row-band perturbation deep zoom: one reference orbit (small and
    read-only) serves every band; each device computes its band's deltas —
    still gather-free.  Same signature and result as
    ops.perturbation.perturbation_fields, but for ``device``, which the
    mesh gives; ``passes`` is the most any band took.

    A ``row0``/``map_height`` band of a taller image (``render_fields(
    row_band=...)``) composes with the per-device bands; with ``aa_spp``
    each device renders the spp² segment stack of its own band (the
    Q_AROW0 mapping of ops/perturbation.py).

    ``keep_device``: where every band sits on one device, the planes are
    joined there, so callers colour and quantize on the device and fetch
    only uint RGB; otherwise they are joined on the host."""
    from ..ops.perturbation import perturbation_fields

    if mesh is None:
        mesh = make_render_mesh()
    devs = mesh.devices[0]
    row0_base = int(pert_kw.pop("row0", 0))
    map_h = int(pert_kw.pop("map_height", height))
    bands, used = [], set()
    for dev, (r0, rows) in zip(devs, row_bands(height, len(devs))):
        bands.append(perturbation_fields(orbit, width, rows,
                                         row0=float(row0_base + r0),
                                         map_height=map_h, device=dev,
                                         **pert_kw))
        used.add(dev)
    on_one = keep_device and len(used) == 1

    def join(key):
        parts = [b[key] for b in bands]
        # planes are (rows, W), or (spp², rows, W) stacked
        return torch.cat(parts, dim=-2) if on_one else to_host(parts, -2)

    res = {k: join(k) for k in bands[0] if k != "passes"}
    if "passes" in bands[0]:
        res["passes"] = max(int(b["passes"]) for b in bands)
    return res
