"""Feed-forward super-resolution model (ESRGAN class).

Counterpart of comfyui_distributed_tpu/models/upscaler.py, the model an
upscale workflow runs before the tiles (UpscaleModelLoader,
ImageUpscaleWithModel): a residual conv net whose pixel-shuffled output
is added to a linear resize of the input. The output conv starts at
zero, so a fresh model gives exactly the linear resize; callers that
want its effect seed that conv.

Weights are seeded per name on the target device; submodules carry the
flax names (`models/io.py::from_jax_params`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_image
from .controlnet import name_seed
from .io import random_init_
from .layers import Conv


@dataclasses.dataclass(frozen=True)
class UpscalerConfig:
    scale: int = 4
    channels: int = 64
    num_blocks: int = 6
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class _ResidualBlock(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv(channels, channels, 3, dtype=dtype)
        self.conv2 = Conv(channels, channels, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        return x + 0.2 * self.conv2(F.leaky_relu(self.conv1(x), 0.2))


class SuperResolver(nn.Module):
    """[B, H, W, 3] in [0, 1] → [B, H*scale, W*scale, 3] in [0, 1]."""

    def __init__(self, config: UpscalerConfig):
        super().__init__()
        self.config = cfg = config
        dt = cfg.compute_dtype
        self.head = Conv(3, cfg.channels, 3, dtype=dt)
        for i in range(cfg.num_blocks):
            self.add_module(f"block_{i}", _ResidualBlock(cfg.channels, dt))
        self.tail = Conv(cfg.channels, 3 * cfg.scale * cfg.scale, 3, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, h, w, c = x.shape
        s = cfg.scale
        base = resize_image(x.float(), h * s, w * s, "bilinear")
        feat = self.head((x.to(cfg.compute_dtype) * 2.0 - 1.0).permute(0, 3, 1, 2))
        for i in range(cfg.num_blocks):
            feat = getattr(self, f"block_{i}")(feat)
        feat = self.tail(feat.float()).permute(0, 2, 3, 1).reshape(b, h, w, s, s, c)
        # the JAX package's pixel shuffle: (b, h, w, sy, sx, c) → rows h*s+sy,
        # columns w*s+sx (not F.pixel_shuffle's channel order)
        residual = feat.permute(0, 1, 3, 2, 4, 5).reshape(b, h * s, w * s, c)
        return torch.clamp(base + residual, 0.0, 1.0)


@dataclasses.dataclass
class UpscaleModelBundle:
    """A loaded upscale model (the UPSCALE_MODEL node type)."""

    name: str
    module: SuperResolver
    scale: int
    device: torch.device

    def upscale(self, image: torch.Tensor) -> torch.Tensor:
        return self.module(torch.as_tensor(image, dtype=torch.float32).to(self.device))


def scale_of(name: str) -> int:
    """The scale a model name gives ("4x-generic" → 4), else 4."""
    if name and name[0].isdigit() and "x" in name:
        try:
            return int(name.split("x")[0])
        except ValueError:
            return 4
    return 4


def load_upscale_model(name: str = "4x-generic", seed: int = 0,
                       device="cuda") -> UpscaleModelBundle:
    """An upscale model on `device` (the card unless the caller asks for
    the CPU), its scale parsed from the name, its weights drawn from a
    generator seeded by (seed, name), its output conv zero."""
    device = torch.device(device)
    scale = scale_of(name)
    with torch.device("meta"):
        module = SuperResolver(UpscalerConfig(scale=scale))
    module = module.to_empty(device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(name_seed(seed, name))
    random_init_(module, gen)
    module.tail.weight.data.zero_()
    return UpscaleModelBundle(name=name, module=module.eval().requires_grad_(False),
                              scale=scale, device=device)
