"""Image orientation helper."""
from __future__ import annotations

import torch


def to_export_orientation(img: torch.Tensor) -> torch.Tensor:
    """Flip vertically for file export.

    Render arrays use row 0 = lowest imaginary coordinate (uv.y = 0, the
    shaders' storage-image layout); every reference export path flips Y
    before writing (vk_engine.cpp:1359, :1687, :2063), so saved images have
    the imaginary axis pointing up.  Apply this exactly once, at the
    file-writing boundary.
    """
    return torch.flip(img, dims=(0,))
