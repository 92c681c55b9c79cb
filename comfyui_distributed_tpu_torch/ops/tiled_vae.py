"""Tiled VAE encode and decode.

Counterpart of comfyui_distributed_tpu/ops/tiled_vae.py (USDU's
`tiled_decode`, VAEEncodeTiled, VAEDecodeTiled): the plane is cut into
overlapping tiles with the tile grid of ops/tiles.py, each tile runs
through the whole VAE at the tile's shape, and the results blend with
the feathered weighted average on a grid scaled by the VAE's factor.
GroupNorm statistics are per tile, so the result is close to the full
pass, not equal to it.
"""

from __future__ import annotations

import torch

from . import tiles as tile_ops


def _scaled_grid(grid: tile_ops.TileGrid, h: int, w: int, scale) -> tile_ops.TileGrid:
    """`grid` on a plane of h x w, every length mapped by `scale`."""
    return tile_ops.TileGrid(
        image_h=h, image_w=w, tile_h=scale(grid.tile_h), tile_w=scale(grid.tile_w),
        padding=scale(grid.padding), rows=grid.rows, cols=grid.cols,
        positions=tuple((scale(y), scale(x)) for y, x in grid.positions),
    )


@torch.no_grad()
def decode_tiled(vae, latents: torch.Tensor, tile: int = 64, overlap: int = 8) -> torch.Tensor:
    """[B, h, w, C] latents → [B, H, W, 3] through overlapping latent
    tiles of `tile` (+ `overlap` each side), in latent pixels. A plane
    that fits one tile decodes whole."""
    _, h, w, _ = latents.shape
    if h <= tile and w <= tile:
        return vae.decode(latents)
    grid = tile_ops.calculate_tiles(h, w, min(tile, h), min(tile, w), overlap)
    extracted = tile_ops.extract_tiles(latents, grid)
    decoded = torch.stack([vae.decode(t) for t in extracted])
    factor = decoded.shape[2] // extracted.shape[2]
    return tile_ops.blend_tiles(decoded, _scaled_grid(grid, h * factor, w * factor,
                                                      lambda n: n * factor))


@torch.no_grad()
def encode_tiled(vae, pixels: torch.Tensor, tile: int = 512, overlap: int = 64) -> torch.Tensor:
    """[B, H, W, 3] → [B, h, w, C] through overlapping pixel tiles."""
    _, h, w, _ = pixels.shape
    if h <= tile and w <= tile:
        return vae.encode(pixels)
    grid = tile_ops.calculate_tiles(h, w, min(tile, h), min(tile, w), overlap)
    extracted = tile_ops.extract_tiles(pixels, grid)
    encoded = torch.stack([vae.encode(t) for t in extracted])
    factor = extracted.shape[2] // encoded.shape[2]
    return tile_ops.blend_tiles(encoded, _scaled_grid(grid, h // factor, w // factor,
                                                      lambda n: n // factor))
