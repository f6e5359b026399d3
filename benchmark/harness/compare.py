"""The comparison that decides ``correct``: uint8 frames against the plain
reference's, channel value by channel value.

- ``lsb_max``: the largest difference of one channel value, in units of the
  last bit (0-255);
- ``off_share``: the share of the compared channel values that differ at
  all.

Each is held against its limit in ``checks/<workload>.json``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

NUMBERS = ("lsb_max", "off_share")


@dataclass
class Diff:
    lsb_max: int = 0
    off: int = 0
    values: int = 0

    def add(self, got: torch.Tensor, want: torch.Tensor) -> None:
        if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
            raise ValueError(f"frame {tuple(got.shape)} {got.dtype} against "
                             f"the reference's {tuple(want.shape)} "
                             f"{want.dtype}")
        d = (got.to(want.device).to(torch.int16)
             - want.to(torch.int16)).abs()
        self.lsb_max = max(self.lsb_max, int(d.max()))
        self.off += int((d > 0).sum())
        self.values += d.numel()

    def numbers(self) -> dict:
        return {"lsb_max": float(self.lsb_max),
                "off_share": self.off / max(self.values, 1)}


def checks(diff: Diff, limits: dict) -> dict:
    """``{name: {"value": v, "limit": l}}`` of the numbers compared."""
    nums = diff.numbers()
    return {k: {"value": nums[k], "limit": float(limits[k]["limit"])}
            for k in NUMBERS}
