"""Tile grid math for tiled upscaling.

Counterpart of comfyui_distributed_tpu/ops/tiles.py: the grid is worked
out in Python, tiles are windows of a reflect-padded image, and blending
is a feathered weighted average in f32, so the result does not depend on
which tile was produced first (up to float accumulation order). Every
tile has the same shape in both grid modes: uniform grids clamp the
last row/column onto its neighbour; non-uniform grids keep plain
r*tile origins and edge-extend the canvas under the overhang, which
blending crops away. Images are [B, H, W, C].
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Static description of a tiling of an image plane."""

    image_h: int
    image_w: int
    tile_h: int
    tile_w: int
    padding: int
    rows: int
    cols: int
    # (y, x) origins of the unpadded tile regions
    positions: tuple[tuple[int, int], ...]
    # feather-ramp width in pixels (USDU `mask_blur`); 0 = the full
    # padding width. Clamped to the padding ring.
    mask_blur: int = 0
    uniform: bool = True

    @property
    def feather(self) -> int:
        if self.mask_blur > 0:
            return min(self.mask_blur, self.padding)
        return self.padding

    @property
    def num_tiles(self) -> int:
        return self.rows * self.cols

    @property
    def coverage_h(self) -> int:
        """Canvas height the grid covers (≥ image_h when non-uniform edge
        tiles overhang the image)."""
        return max(self.image_h, max(y for y, _ in self.positions) + self.tile_h)

    @property
    def coverage_w(self) -> int:
        return max(self.image_w, max(x for _, x in self.positions) + self.tile_w)

    @property
    def padded_h(self) -> int:
        return self.tile_h + 2 * self.padding

    @property
    def padded_w(self) -> int:
        return self.tile_w + 2 * self.padding


def calculate_tiles(image_h: int, image_w: int, tile_h: int, tile_w: int,
                    padding: int = 32, mask_blur: int = 0, uniform: bool = True) -> TileGrid:
    """Ceil-grid tiling, every tile exactly (tile_h, tile_w)."""
    tile_h = min(tile_h, image_h)
    tile_w = min(tile_w, image_w)
    rows = max(1, math.ceil(image_h / tile_h))
    cols = max(1, math.ceil(image_w / tile_w))
    positions = []
    for r in range(rows):
        y = r * tile_h if not uniform else min(r * tile_h, image_h - tile_h)
        for c in range(cols):
            x = c * tile_w if not uniform else min(c * tile_w, image_w - tile_w)
            positions.append((y, x))
    return TileGrid(
        image_h=image_h, image_w=image_w, tile_h=tile_h, tile_w=tile_w,
        padding=padding, rows=rows, cols=cols, positions=tuple(positions),
        mask_blur=mask_blur, uniform=uniform,
    )


def pad_image_for_grid(images: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """Pad [B, H, W, C] so padded tile windows never clip: edge-extend
    the bottom/right overhang of non-uniform grids FIRST (so the strip
    repeats the true image edge), then a reflect ring of `padding`."""
    p = grid.padding
    extra_h = grid.coverage_h - grid.image_h
    extra_w = grid.coverage_w - grid.image_w
    if p == 0 and extra_h == 0 and extra_w == 0:
        return images
    out = images.permute(0, 3, 1, 2)
    if extra_h or extra_w:
        out = F.pad(out, (0, extra_w, 0, extra_h), mode="replicate")
    if p > 0:
        out = F.pad(out, (p, p, p, p), mode="reflect")
    return out.permute(0, 2, 3, 1)


def extract_tiles(images: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """[B, H, W, C] → [T, B, th+2p, tw+2p, C] padded tiles; origins index
    the padded image, so each window is centred on its tile."""
    padded = pad_image_for_grid(images, grid)
    return torch.stack([
        padded[:, y:y + grid.padded_h, x:x + grid.padded_w, :] for y, x in grid.positions
    ])


@lru_cache(maxsize=64)
def _feather_mask_np(padded_h: int, padded_w: int, padding: int) -> np.ndarray:
    def ramp(n: int, pad: int) -> np.ndarray:
        w = np.ones(n, dtype=np.float64)
        if pad > 0:
            t = (np.arange(pad) + 0.5) / pad  # 0..1 across the ring
            edge = 0.5 - 0.5 * np.cos(np.pi * t)
            w[:pad] = np.maximum(edge, 1e-4)
            w[-pad:] = np.maximum(edge[::-1], 1e-4)
        return w

    return np.outer(ramp(padded_h, padding), ramp(padded_w, padding))


def feather_mask(grid: TileGrid, dtype=torch.float32, device=None) -> torch.Tensor:
    """[th+2p, tw+2p] weights: 1.0 in the core, a raised-cosine falloff
    across the feather ring, strictly positive everywhere."""
    return torch.as_tensor(
        _feather_mask_np(grid.padded_h, grid.padded_w, grid.feather), dtype=dtype, device=device
    )


def blend_tiles(tiles: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """[T, B, th+2p, tw+2p, C] processed tiles → [B, H, W, C]: weighted
    accumulation into a padded f32 canvas and weight map, tile by tile
    (the JAX package's scan formulation), then normalise and crop."""
    _, batch, _, _, channels = tiles.shape
    p = grid.padding
    ph, pw = grid.coverage_h + 2 * p, grid.coverage_w + 2 * p
    mask = feather_mask(grid, dtype=tiles.dtype, device=tiles.device)[None, :, :, None]
    canvas = torch.zeros((batch, ph, pw, channels), dtype=torch.float32, device=tiles.device)
    weights = torch.zeros((1, ph, pw, 1), dtype=torch.float32, device=tiles.device)
    for tile, (y, x) in zip(tiles, grid.positions):
        canvas[:, y:y + grid.padded_h, x:x + grid.padded_w, :] += (tile * mask).float()
        weights[:, y:y + grid.padded_h, x:x + grid.padded_w, :] += mask.float()
    blended = canvas / torch.clamp(weights, min=1e-8)
    return blended[:, p:p + grid.image_h, p:p + grid.image_w, :].to(tiles.dtype)
