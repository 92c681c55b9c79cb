"""ControlNet-style hint conditioning.

Counterpart of comfyui_distributed_tpu/models/controlnet.py, the role
ControlNet tile plays in the upscale workflow: a pixel-space hint is
encoded by a conv stack to a latent-resolution residual that the UNet
adds after its input conv, scaled by the hint's strength. The output
conv starts at zero, so a fresh ControlNet adds nothing; callers that
want its effect seed that conv.

Weights are seeded, per name, on the target device: every participant
that loads one name holds the same ControlNet. Submodules carry the flax
names, so `models/io.py::from_jax_params` carries a JAX tree across.
"""

from __future__ import annotations

import dataclasses
import zlib

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.samplers import stream_seed
from .io import random_init_
from .layers import Conv


@dataclasses.dataclass(frozen=True)
class ControlNetConfig:
    hint_channels: int = 3
    model_channels: int = 320  # the target UNet's
    downscale: int = 8         # the VAE's spatial factor
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class ControlNetEncoder(nn.Module):
    """[B, H, W, hint_channels] in [0, 1] → [B, H/downscale, W/downscale,
    model_channels] in f32: a 16-channel conv, log2(downscale) stride-2
    convs doubling the width (up to model_channels), a mid conv, each
    with SiLU, in the compute dtype; the output conv in f32."""

    def __init__(self, config: ControlNetConfig):
        super().__init__()
        self.config = cfg = config
        dt = cfg.compute_dtype
        ch = 16
        self.levels = max(0, int(cfg.downscale).bit_length() - 1)
        self.conv_in = Conv(cfg.hint_channels, ch, 3, dtype=dt)
        for i in range(self.levels):
            out = min(ch * 2, cfg.model_channels)
            self.add_module(f"down_{i}", Conv(ch, out, 3, stride=2, dtype=dt))
            ch = out
        self.mid = Conv(ch, ch, 3, dtype=dt)
        self.conv_out = Conv(ch, cfg.model_channels, 3, dtype=torch.float32)

    def forward(self, hint: torch.Tensor) -> torch.Tensor:
        h = (hint.to(self.config.compute_dtype) * 2.0 - 1.0).permute(0, 3, 1, 2)
        h = F.silu(self.conv_in(h))
        for i in range(self.levels):
            h = F.silu(getattr(self, f"down_{i}")(h))
        h = F.silu(self.mid(h))
        return self.conv_out(h.float()).permute(0, 2, 3, 1)


@dataclasses.dataclass
class ControlNetBundle:
    """A loaded ControlNet (the CONTROL_NET node type)."""

    name: str
    module: ControlNetEncoder
    device: torch.device

    def encode(self, hint: torch.Tensor) -> torch.Tensor:
        return self.module(hint.to(self.device))


def name_seed(seed: int, name: str) -> int:
    """The generator seed of a named, seeded model: `seed` with the
    name's CRC-32 folded in."""
    return stream_seed(seed, zlib.crc32(name.encode("utf-8")))


def load_controlnet(name: str = "tile", model_channels: int = 320, downscale: int = 8,
                    seed: int = 0, device="cuda") -> ControlNetBundle:
    """A ControlNet on `device` (the card unless the caller asks for the
    CPU), its weights drawn from a generator seeded by (seed, name), its
    output conv zero."""
    device = torch.device(device)
    with torch.device("meta"):
        module = ControlNetEncoder(ControlNetConfig(model_channels=int(model_channels),
                                                    downscale=int(downscale)))
    module = module.to_empty(device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(name_seed(seed, name))
    random_init_(module, gen)
    module.conv_out.weight.data.zero_()
    return ControlNetBundle(name=name, module=module.eval().requires_grad_(False), device=device)
