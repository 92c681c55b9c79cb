"""Tiled re-diffusion upscaling (Ultimate-SD-Upscale class): the local path.

Counterpart of comfyui_distributed_tpu/ops/upscale.py: resize, cut the
grid into padded tiles, and per tile VAE-encode, noise, sample under
CFG, decode; then blend. Tiles run one after another on one device (the
JAX package's scan at tile batch 1). The mesh tier is not ported yet.

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

import numpy as np
import torch

from ..models import pipeline as pl
from . import samplers as smp
from . import tiles as tile_ops
from .conditioning import Conditioning, as_conditioning

NoiseFn = Callable[[int, tuple], torch.Tensor]

# user-facing upscale_method names → the jax.image.resize kernel the JAX
# package routes them to; "area" is an exact box average
RESIZE_METHODS = {
    "bicubic": "cubic",
    "bilinear": "linear",
    "nearest": "nearest",
    "nearest-exact": "nearest",
    "lanczos": "lanczos3",
}


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _lanczos3(x: np.ndarray) -> np.ndarray:
    radius = 3.0
    y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(x > 1e-3, y / np.where(x != 0, np.pi**2 * x**2, 1), 1.0)
    return np.where(x > radius, 0.0, out)


_KERNELS = {"cubic": _keys_cubic, "linear": _triangle, "lanczos3": _lanczos3}


def _scale_weights(n_in: int, n_out: int, kernel: str) -> np.ndarray:
    """[n_in, n_out] resampling weights of jax.image.resize (scale and
    translate with antialiasing): half-pixel centres, the kernel widened
    by the downscale factor, columns normalised, samples outside the
    input zeroed."""
    scale = n_out / n_in
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    weights = _KERNELS[kernel](x)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, 1),
        0.0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], weights, 0.0).astype(np.float32)


def _area_weights(n_out: int, n_in: int) -> np.ndarray:
    """[n_out, n_in] row-stochastic box weights (adaptive average pool)."""
    scale = n_in / n_out
    w = np.zeros((n_out, n_in), dtype=np.float32)
    for i in range(n_out):
        lo, hi = i * scale, (i + 1) * scale
        for j in range(int(np.floor(lo)), min(int(np.ceil(hi)), n_in)):
            cover = min(hi, j + 1) - max(lo, j)
            if cover > 0:
                w[i, j] = cover
        w[i] /= max(w[i].sum(), 1e-12)
    return w


def resize_image(image: torch.Tensor, out_h: int, out_w: int, method_name: str) -> torch.Tensor:
    """[B, H, W, C] → [B, out_h, out_w, C] with the JAX package's
    sampling for each method name. Unknown names raise; identical sizes
    return the input untouched. F.interpolate is not used: its bicubic
    is the a=-0.75 kernel with other edge handling."""
    if method_name != "area" and method_name not in RESIZE_METHODS:
        raise ValueError(
            f"unknown upscale_method {method_name!r}; use {sorted(RESIZE_METHODS) + ['area']}"
        )
    b, h, w, c = image.shape
    if (h, w) == (out_h, out_w):
        return image
    if method_name == "area":
        wh = torch.from_numpy(_area_weights(out_h, h)).to(image.device)
        ww = torch.from_numpy(_area_weights(out_w, w)).to(image.device)
        return torch.einsum("oh,bhwc,pw->bopc", wh, image.float(), ww)
    kernel = RESIZE_METHODS[method_name]
    if kernel == "nearest":
        from ..models.layers import resize_nearest

        return resize_nearest(image.permute(0, 3, 1, 2), (out_h, out_w)).permute(0, 2, 3, 1)
    out = image.float()
    if h != out_h:
        wh = torch.from_numpy(_scale_weights(h, out_h, kernel)).to(image.device)
        out = torch.einsum("bhwc,ho->bowc", out, wh)
    if w != out_w:
        ww = torch.from_numpy(_scale_weights(w, out_w, kernel)).to(image.device)
        out = torch.einsum("bhwc,wp->bhpc", out, ww)
    return out


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


def prep_cond_for_tiles(cond, grid: tile_ops.TileGrid):
    """Conditioning prepared for per-tile windows. Multi-entry lists are
    not ported; text context and pooled vectors need no preparation."""
    if isinstance(cond, (list, tuple)):
        raise NotImplementedError(
            "multi-entry conditioning (ConditioningCombine) is not ported yet (ROADMAP.md, "
            "Queue 1 item 2: multi-entry and spatial conditioning)"
        )
    return as_conditioning(cond).clone()


def tile_cond(cond: Conditioning, y: int, x: int, grid: tile_ops.TileGrid) -> Conditioning:
    """A tile's window of conditioning prepped by prep_cond_for_tiles."""
    return cond.clone()


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


def default_noise(seed: int, device) -> TileNoise:
    """The tiles' noise of `seed` on `device`."""
    return TileNoise(seed, device)


def _process_tile_fn(bundle: pl.PipelineBundle, grid: tile_ops.TileGrid, steps: int,
                     sampler: str, scheduler: str, cfg: float, denoise: float):
    """fn(tile, tile_index, noise, pos, neg, yx) → the processed tile;
    pos/neg prepped by prep_cond_for_tiles. `noise` is the tiles' noise
    (see the module docstring): a stochastic sampler takes its
    `step_noise(tile_index)`."""
    smp.check_sampler_names(sampler, scheduler)
    param = pl.model_schedule_info(bundle)
    sigmas = smp.get_model_sigmas(param, scheduler, steps, denoise=denoise)
    model_fn = pl.guided_model(bundle, cfg)

    def fn(tile, tile_index, noise, pos, neg, yx):
        pos_t = tile_cond(pos, yx[0], yx[1], grid)
        neg_t = tile_cond(neg, yx[0], yx[1], grid)
        z = bundle.vae.encode(tile)
        x = smp.noise_latents(param, z, noise(tile_index, tuple(z.shape)).to(z.device), sigmas[0])
        step_noise = getattr(noise, "step_noise", None)
        z_out = smp.sample(model_fn, x, sigmas, (pos_t, neg_t), sampler,
                           step_noise(tile_index) if step_noise is not None else None)
        return bundle.vae.decode(z_out)

    return fn


@torch.no_grad()
def upscale_single(bundle: pl.PipelineBundle, upscaled: torch.Tensor, pos, neg, seed: int,
                   grid: tile_ops.TileGrid, steps: int, sampler: str, scheduler: str,
                   cfg: float, denoise: float, noise: NoiseFn | None = None) -> torch.Tensor:
    """All tiles processed on the bundle's device, one after another."""
    extracted = tile_ops.extract_tiles(upscaled, grid)  # [T, B, th, tw, C]
    pos = prep_cond_for_tiles(pos, grid)
    neg = prep_cond_for_tiles(neg, grid)
    process = _process_tile_fn(bundle, grid, steps, sampler, scheduler, cfg, denoise)
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
    if tiled_decode:
        raise NotImplementedError("tiled VAE decode is not ported yet (ROADMAP.md, Queue 1 "
                                  "item 2: tiled VAE)")
    image = torch.as_tensor(image, dtype=torch.float32).to(bundle.device)
    upscaled, grid, _ = prepare_upscaled_tiles(
        image, upscale_by, tile, padding, upscale_method, tile_h,
        mask_blur=mask_blur, uniform=uniform,
    )
    return upscale_single(
        bundle, upscaled, pos, neg, seed, grid, int(steps), sampler, scheduler,
        float(cfg), float(denoise), noise=noise,
    )
