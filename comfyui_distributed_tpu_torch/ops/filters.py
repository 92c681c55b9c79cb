"""Image-space filters.

Counterpart of comfyui_distributed_tpu/ops/filters.py: `gaussian_blur`,
which builds SAG's degraded input (ops/samplers.py::sag_cfg_model).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_blur(image: torch.Tensor, radius: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of [B, H, W, C] over a 2r+1 window with
    reflect padding (the edge sample not repeated, as jnp.pad's
    "reflect"); the horizontal pass first, as the JAX package runs it."""
    r = max(1, int(radius))
    xs = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-(xs**2) / (2.0 * max(float(sigma), 1e-6) ** 2))
    k /= k.sum()
    b, h, w, c = image.shape
    kern = torch.from_numpy(k).to(device=image.device, dtype=image.dtype)
    planes = image.permute(0, 3, 1, 2).reshape(b * c, 1, h, w)
    planes = F.pad(planes, (r, r, r, r), mode="reflect")
    planes = F.conv2d(planes, kern.view(1, 1, 1, -1))
    planes = F.conv2d(planes, kern.view(1, 1, -1, 1))
    return planes.reshape(b, c, h, w).permute(0, 2, 3, 1)
