"""Constant f32 tensors on a device, built once and shared.

The tensor glue divides by f32 tensors (CUDA divides exactly only by a
tensor, not by a Python scalar's rounded reciprocal) and mixes with fixed
colour vectors.  ``torch.tensor(v, device=)`` copies its value from
pageable host memory, and on a CUDA device that copy waits until the
stream drains, so a frame that built its constants afresh could not queue
its glue behind a running kernel.  :func:`f32` builds each (value,
device) once; every later call hands out the same tensor.  Nothing may
write into a tensor it returns.
"""
from __future__ import annotations

import torch

_CACHE: dict = {}


def f32(value, device) -> torch.Tensor:
    """``torch.tensor(value, dtype=torch.float32, device=device)``: 0-dim
    for a number, shape (n,) for a sequence of n numbers.  Built on the
    first call for that value and device, the same tensor afterwards (read
    only).  A CUDA device without an index means the current one.  Counts
    its builds in ``f32.builds``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    # float.hex keeps -0.0 apart from 0.0, which compare and hash equal
    if isinstance(value, (tuple, list)):
        key = dev, tuple(float(v).hex() for v in value)
    else:
        key = dev, float(value).hex()
    t = _CACHE.get(key)
    if t is None:
        t = torch.tensor(value, dtype=torch.float32, device=dev)
        _CACHE[key] = t
        f32.builds += 1
    return t


f32.builds = 0
