"""Host-side image helpers (the port's counterpart of
``fractalrenderer_tpu/utils/image.py``), on tensors of any device."""
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


def downsample2x(img: torch.Tensor) -> torch.Tensor:
    """2×2 box downsample (optional post-step for supersampled exports —
    the reference writes the 2× image as-is; this is an extra).  The JAX
    package's sum order, so the same f32 image gives the same bits."""
    h, w = img.shape[0] & ~1, img.shape[1] & ~1
    img = img[:h, :w]
    return (img[0::2, 0::2] + img[1::2, 0::2] + img[0::2, 1::2]
            + img[1::2, 1::2]) * 0.25
