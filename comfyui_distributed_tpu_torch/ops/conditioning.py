"""Structured conditioning, as far as the SDXL upscale path carries it.

Counterpart of comfyui_distributed_tpu/ops/conditioning.py with the
fields this slice uses: the text context and the pooled vector. The
SDXL size override (CLIPTextEncodeSDXL) and the spatial payloads
(ControlNet hints, masks, areas, GLIGEN boxes, reference latents) come
with the slices that produce them, and with them the per-tile cropping
that `crop_to_tile` does for them in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass
class Conditioning:
    """One conditioning entry.

    context: [B, T, D] text tokens.
    pooled: [B, width] pooled text vector (SDXL adm conditioning).
    """

    context: torch.Tensor
    pooled: Optional[torch.Tensor] = None

    def clone(self) -> "Conditioning":
        # tensors are never written in place, so a shallow copy suffices
        return dataclasses.replace(self)


def as_conditioning(value: Any) -> Conditioning:
    """Accept a bare context tensor or a Conditioning."""
    if isinstance(value, Conditioning):
        return value
    return Conditioning(context=value)


def crop_to_tile(cond: Conditioning, y: int, x: int, tile_h: int, tile_w: int,
                 image_h: int, image_w: int) -> Conditioning:
    """The conditioning a padded tile at origin (y, x) sees. Text context
    and pooled vectors are not spatial and pass through unchanged."""
    return cond.clone()
