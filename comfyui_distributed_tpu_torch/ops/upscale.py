"""Tiled re-diffusion upscaling (Ultimate-SD-Upscale class): the local path.

Counterpart of comfyui_distributed_tpu/ops/upscale.py: resize, cut the
grid into padded tiles, and per tile VAE-encode, noise, sample under
CFG, decode (whole, or in latent tiles with `tiled_decode`); then blend.
Tiles run one after another on one device (the JAX package's scan at
tile batch 1). Conditioning is windowed to each tile: a ControlNet hint
and a mask are resized to the upscaled image, padded like it and sliced
at the tile's origin. The mesh tier is not ported yet.

Per-tile noise comes from a callable `noise(tile_index, shape)` (the
initial noise); where it also has `step_noise(tile_index)`, that gives
the stochastic samplers' step noise. The default, `TileNoise`, draws
each from a `torch.Generator` seeded by (seed, GLOBAL tile index,
stream), so a tile's noise does not depend on which participant runs it
or how tiles are grouped, as the JAX package's keys folded with the tile
index do not. `torch.Generator` and `jax.random` give different numbers;
the tests hand the port the JAX package's own noise through this seam.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F

from ..models import pipeline as pl
from . import samplers as smp
from . import tiles as tile_ops
from .conditioning import Conditioning, as_conditioning
from .resize import resize_image
from .tiled_vae import decode_tiled

NoiseFn = Callable[[int, tuple], torch.Tensor]

def plan_grid(image_h: int, image_w: int, upscale_by: float, tile_w: int, padding: int,
              tile_h: int | None = None, mask_blur: int = 0,
              uniform: bool = True) -> tuple[int, int, tile_ops.TileGrid]:
    """Target size and tile grid; tile geometry is clamped to the image
    and snapped to the VAE factor 8 so latent shapes stay integral."""
    out_h = int(round(image_h * upscale_by / 8)) * 8
    out_w = int(round(image_w * upscale_by / 8)) * 8
    tile_h = tile_h if tile_h is not None else tile_w
    tile_w = max(64, (int(tile_w) // 8) * 8)
    tile_h = max(64, (int(tile_h) // 8) * 8)
    padding = max(8, (padding // 8) * 8)
    grid = tile_ops.calculate_tiles(
        out_h, out_w, tile_h, tile_w, padding, mask_blur=mask_blur, uniform=uniform
    )
    return out_h, out_w, grid


def prepare_upscaled_tiles(image: torch.Tensor, upscale_by: float, tile_w: int, padding: int,
                           upscale_method: str = "bicubic", tile_h: int | None = None,
                           mask_blur: int = 0, uniform: bool = True):
    """Resize, clip to [0, 1], extract: (upscaled, grid, tiles)."""
    b, h, w, c = image.shape
    out_h, out_w, grid = plan_grid(
        h, w, upscale_by, tile_w, padding, tile_h, mask_blur=mask_blur, uniform=uniform
    )
    upscaled = torch.clamp(resize_image(image, out_h, out_w, upscale_method), 0.0, 1.0)
    return upscaled, grid, tile_ops.extract_tiles(upscaled, grid)


def _pad_plane_for_grid(plane: torch.Tensor, grid: tile_ops.TileGrid) -> torch.Tensor:
    """A [B, H, W] or [B, H, W, C] plane padded as the image is
    (tiles.py::pad_image_for_grid: the overhang edge-extended, then the
    reflect ring)."""
    if plane.ndim == 3:
        return tile_ops.pad_image_for_grid(plane[..., None], grid)[..., 0]
    return tile_ops.pad_image_for_grid(plane, grid)


def prep_cond_for_tiles(cond, grid: tile_ops.TileGrid):
    """Conditioning made ready for per-tile windows: a ControlNet hint and
    a mask resized (linear) to the upscaled image and padded like it, so
    `tile_cond` slices them at the tiles' own origins. A list preps per
    entry. An area and inpaint-model concat channels are refused, as in
    the JAX package: neither is windowed per tile, and the full-image
    plane on a tile crop would be wrong coordinates."""
    if isinstance(cond, (list, tuple)):
        return [prep_cond_for_tiles(c, grid) for c in cond]
    c = as_conditioning(cond).clone()
    if c.area is not None:
        raise ValueError("area-restricted conditioning is not supported by the USDU tile "
                         "path; remove the ConditioningSetArea restriction for upscaling")
    if c.concat_latent is not None:
        # the concat plane would need windowing per tile at the bundle's
        # latent scale, which the grid does not know: refused, as in the
        # JAX package, rather than squashed whole into every tile
        raise ValueError("inpaint-model concat conditioning (InpaintModelConditioning) is not "
                         "supported by the USDU tile path; use VAEEncodeForInpaint or "
                         "SetLatentNoiseMask for tiled upscaling")
    if c.control_hint is not None:
        hint = resize_image(c.control_hint, grid.image_h, grid.image_w, "bilinear")
        c.control_hint = _pad_plane_for_grid(hint, grid)
    if c.mask is not None:
        mask = resize_image(c.mask[..., None], grid.image_h, grid.image_w, "bilinear")[..., 0]
        c.mask = _pad_plane_for_grid(mask, grid)
    if c.reference_latents is not None:
        # as the planes above, in latent units: each reference resized to
        # the latent grid the tiles cover and edge-padded by the padding,
        # so a tile's window at (y // 8, x // 8) covers the image region
        # the tile covers
        k = 8
        pk = grid.padding // k
        cov_h, cov_w = grid.coverage_h // k, grid.coverage_w // k
        prepped = []
        for lat in c.reference_latents:
            if tuple(lat.shape[1:3]) != (cov_h, cov_w):
                lat = resize_image(lat, cov_h, cov_w, "bilinear")
            prepped.append(F.pad(lat.permute(0, 3, 1, 2), (pk, pk, pk, pk),
                                 mode="replicate").permute(0, 2, 3, 1))
        c.reference_latents = prepped
    return c


def tile_cond(cond, y: int, x: int, grid: tile_ops.TileGrid):
    """A tile's window of conditioning prepped by `prep_cond_for_tiles`:
    the hint and mask sliced at the tile's origin (y, x) in the padded
    plane, padded tile size."""
    if isinstance(cond, (list, tuple)):
        return [tile_cond(c, y, x, grid) for c in cond]
    if not isinstance(cond, Conditioning):
        return cond
    c = cond.clone()
    if c.control_hint is not None:
        c.control_hint = c.control_hint[:, y:y + grid.padded_h, x:x + grid.padded_w, :]
    if c.mask is not None:
        c.mask = c.mask[:, y:y + grid.padded_h, x:x + grid.padded_w]
    if c.reference_latents is not None:
        k = 8
        th, tw = max(1, grid.padded_h // k), max(1, grid.padded_w // k)
        c.reference_latents = [lat[:, y // k:y // k + th, x // k:x // k + tw, :]
                               for lat in c.reference_latents]
    return c


class TileNoise:
    """A tile's noise by its GLOBAL index: calling it gives the initial
    noise, standard normals from a generator seeded with stream_seed(seed,
    tile index); `step_noise(tile_index)` the stochastic samplers' step
    noise, from one seeded with stream_seed(seed, tile index,
    STEP_STREAM)."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = device

    def _generator(self, *indices: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(smp.stream_seed(self.seed, *indices))
        return gen

    def __call__(self, tile_index: int, shape: tuple) -> torch.Tensor:
        return torch.randn(shape, generator=self._generator(tile_index), device=self.device,
                           dtype=torch.float32)

    def step_noise(self, tile_index: int) -> smp.StepNoise:
        return smp.generator_step_noise(self._generator(tile_index, pl.STEP_STREAM))


class FrameTileNoise(TileNoise):
    """The tile noise of one frame of a batch in dynamic mode, seeded by
    (seed, frame index, tile index, stream): a frame's result does not
    depend on which participant claims it."""

    def __init__(self, seed: int, frame_index: int, device):
        super().__init__(seed, device)
        self.frame_index = int(frame_index)

    def _generator(self, *indices: int) -> torch.Generator:
        return super()._generator(self.frame_index, *indices)


def default_noise(seed: int, device) -> TileNoise:
    """The tiles' noise of `seed` on `device`."""
    return TileNoise(seed, device)


def _process_tile_fn(bundle: pl.PipelineBundle, grid: tile_ops.TileGrid, steps: int,
                     sampler: str, scheduler: str, cfg: float, denoise: float,
                     tiled_decode: bool = False):
    """fn(tile, tile_index, noise, pos, neg, yx) → the processed tile;
    pos/neg prepped by prep_cond_for_tiles. `noise` is the tiles' noise
    (see the module docstring): a stochastic sampler takes its
    `step_noise(tile_index)`. `tiled_decode` decodes the tile's latents
    in tiles (ops/tiled_vae.py, its defaults)."""
    smp.check_sampler_names(sampler, scheduler)
    param = pl.model_schedule_info(bundle)
    sigmas = smp.get_model_sigmas(param, scheduler, steps, denoise=denoise,
                                  flow_shift=pl.flow_shift(bundle))
    model_fn = pl.guided_model(bundle, cfg)

    def fn(tile, tile_index, noise, pos, neg, yx):
        pos_t = tile_cond(pos, yx[0], yx[1], grid)
        neg_t = tile_cond(neg, yx[0], yx[1], grid)
        z = bundle.vae.encode(tile)
        x = smp.noise_latents(param, z, noise(tile_index, tuple(z.shape)).to(z.device), sigmas[0])
        step_noise = getattr(noise, "step_noise", None)
        z_out = smp.sample(model_fn, x, sigmas, (pos_t, neg_t), sampler,
                           step_noise(tile_index) if step_noise is not None else None,
                           flow=param == "flow")
        if tiled_decode:
            return decode_tiled(bundle.vae, z_out)
        return bundle.vae.decode(z_out)

    return fn


@torch.no_grad()
def upscale_single(bundle: pl.PipelineBundle, upscaled: torch.Tensor, pos, neg, seed: int,
                   grid: tile_ops.TileGrid, steps: int, sampler: str, scheduler: str,
                   cfg: float, denoise: float, noise: NoiseFn | None = None,
                   tiled_decode: bool = False) -> torch.Tensor:
    """All tiles processed on the bundle's device, one after another."""
    extracted = tile_ops.extract_tiles(upscaled, grid)  # [T, B, th, tw, C]
    pos = prep_cond_for_tiles(pos, grid)
    neg = prep_cond_for_tiles(neg, grid)
    process = _process_tile_fn(bundle, grid, steps, sampler, scheduler, cfg, denoise,
                               tiled_decode)
    noise = noise or default_noise(seed, bundle.device)
    processed = torch.stack([
        process(tile, g, noise, pos, neg, yx)
        for g, (tile, yx) in enumerate(zip(extracted, grid.positions))
    ])
    return tile_ops.blend_tiles(processed, grid)


@torch.no_grad()
def run_upscale(
    bundle: pl.PipelineBundle,
    image,
    pos,
    neg,
    mesh: Any = None,
    upscale_by: float = 2.0,
    tile: int = 512,
    padding: int = 32,
    steps: int = 20,
    sampler: str = "euler",
    scheduler: str = "karras",
    cfg: float = 7.0,
    denoise: float = 0.35,
    seed: int = 0,
    upscale_method: str = "bicubic",
    tile_h: int | None = None,
    mask_blur: int = 0,
    tiled_decode: bool = False,
    uniform: bool = True,
    noise: NoiseFn | None = None,
) -> torch.Tensor:
    """Full upscale on the bundle's device: resize, then re-diffuse tile
    by tile. `image` is [B, H, W, 3] in [0, 1] (tensor or numpy)."""
    if mesh is not None:
        raise NotImplementedError(
            "the multi-device tile tier is not ported yet (ROADMAP.md, Queue 1 item 6: "
            "the multi-GPU tier)"
        )
    image = torch.as_tensor(image, dtype=torch.float32).to(bundle.device)
    upscaled, grid, _ = prepare_upscaled_tiles(
        image, upscale_by, tile, padding, upscale_method, tile_h,
        mask_blur=mask_blur, uniform=uniform,
    )
    return upscale_single(
        bundle, upscaled, pos, neg, seed, grid, int(steps), sampler, scheduler,
        float(cfg), float(denoise), noise=noise, tiled_decode=bool(tiled_decode),
    )
