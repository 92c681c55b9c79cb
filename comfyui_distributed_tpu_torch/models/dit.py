"""Rotary position tables shared by the transformer families.

The port's own copy of the rope helpers of comfyui_distributed_tpu/
models/dit.py that the Flux MMDiT (models/mmdit.py) uses: the per-axis
cos/sin table and the adjacent-pair rotation. The tables are computed in
numpy (float64) from static shapes, as the JAX package computes them at
trace time. The video DiT itself comes with the video slice.
"""

from __future__ import annotations

import numpy as np
import torch


def _axis_freqs(dim: int, length: int, theta: float = 10000.0) -> np.ndarray:
    """[length, dim/2, 2] cos/sin table for one rope axis."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2) / dim))
    t = np.arange(length)
    freqs = np.outer(t, inv)
    return np.stack([np.cos(freqs), np.sin(freqs)], axis=-1)


def apply_rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x: [B, N, H, D]; freqs: [N, D/2, 2] (adjacent-pair rotation), in
    f32; the result in x's dtype."""
    xf = x.float().reshape(*x.shape[:-1], -1, 2)
    cos = freqs[None, :, None, :, 0]
    sin = freqs[None, :, None, :, 1]
    out = torch.stack(
        [xf[..., 0] * cos - xf[..., 1] * sin, xf[..., 0] * sin + xf[..., 1] * cos], dim=-1
    )
    return out.reshape(x.shape).to(x.dtype)
