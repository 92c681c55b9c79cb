"""KL autoencoder (VAE) for latent diffusion, in PyTorch.

Counterpart of comfyui_distributed_tpu/models/vae.py: 8x spatial
compression, GroupNorm/SiLU ResBlocks (eps 1e-6) with a single-head mid
self-attention, SD quant/post-quant 1x1 convs, and the scaling/shift
factors applied at the latent boundary. Images and latents enter and
leave as [B, H, W, C]; inside, NCHW.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from .layers import Conv, Dense, GroupNorm32, resize_nearest


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    base_channels: int = 128
    channel_mult: Sequence[int] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    scaling_factor: float = 0.18215
    shift_factor: float = 0.0
    use_quant_conv: bool = True
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.channel_mult) - 1)


class _VAEResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels, eps=1e-6)
        self.conv1 = Conv(in_channels, out_channels, 3, dtype=dtype)
        self.norm2 = GroupNorm32(out_channels, eps=1e-6)
        self.conv2 = Conv(out_channels, out_channels, 3, dtype=dtype)
        self.skip = (
            Conv(in_channels, out_channels, 1, dtype=dtype)
            if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class _MidAttention(nn.Module):
    """Single-head self-attention over all latent positions (D = width)."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.q = Dense(channels, channels, dtype=dtype)
        self.k = Dense(channels, channels, dtype=dtype)
        self.v = Dense(channels, channels, dtype=dtype)
        self.proj = Dense(channels, channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        tokens = self.norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        out = dot_product_attention(
            self.q(tokens)[:, :, None, :],
            self.k(tokens)[:, :, None, :],
            self.v(tokens)[:, :, None, :],
        )[:, :, 0, :]
        out = self.proj(out).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return x + out


class Encoder(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = cfg = config
        dt = cfg.compute_dtype
        self.conv_in = Conv(cfg.in_channels, cfg.base_channels, 3, dtype=dt)
        cur = cfg.base_channels
        for level, mult in enumerate(cfg.channel_mult):
            out_ch = cfg.base_channels * mult
            for i in range(cfg.num_res_blocks):
                self.add_module(f"down_{level}_res_{i}", _VAEResBlock(cur, out_ch, dt))
                cur = out_ch
            if level != len(cfg.channel_mult) - 1:
                # flax SAME on a stride-2 conv: pads (0, 1) on even sizes
                self.add_module(f"down_{level}_ds", Conv(cur, cur, 3, stride=2, dtype=dt))
        self.mid_res_0 = _VAEResBlock(cur, cur, dt)
        self.mid_attn = _MidAttention(cur, dt)
        self.mid_res_1 = _VAEResBlock(cur, cur, dt)
        self.norm_out = GroupNorm32(cur, eps=1e-6)
        self.conv_out = Conv(cur, 2 * cfg.latent_channels, 3, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW → NCHW moments
        cfg = self.config
        h = self.conv_in(x)
        for level in range(len(cfg.channel_mult)):
            for i in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{level}_res_{i}")(h)
            if level != len(cfg.channel_mult) - 1:
                h = getattr(self, f"down_{level}_ds")(h)
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        return self.conv_out(F.silu(self.norm_out(h)).float())


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = cfg = config
        dt = cfg.compute_dtype
        cur = cfg.base_channels * cfg.channel_mult[-1]
        self.conv_in = Conv(cfg.latent_channels, cur, 3, dtype=dt)
        self.mid_res_0 = _VAEResBlock(cur, cur, dt)
        self.mid_attn = _MidAttention(cur, dt)
        self.mid_res_1 = _VAEResBlock(cur, cur, dt)
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            out_ch = cfg.base_channels * mult
            for i in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{level}_res_{i}", _VAEResBlock(cur, out_ch, dt))
                cur = out_ch
            if level != 0:
                self.add_module(f"up_{level}_us", Conv(cur, cur, 3, dtype=dt))
        self.norm_out = GroupNorm32(cur, eps=1e-6)
        self.conv_out = Conv(cur, cfg.in_channels, 3, dtype=torch.float32)

    def forward(self, z: torch.Tensor) -> torch.Tensor:  # NCHW latents → NCHW image
        cfg = self.config
        h = self.conv_in(z)
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        for level in reversed(range(len(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                h = getattr(self, f"up_{level}_res_{i}")(h)
            if level != 0:
                h = resize_nearest(h, (h.shape[2] * 2, h.shape[3] * 2))
                h = getattr(self, f"up_{level}_us")(h)
        return self.conv_out(F.silu(self.norm_out(h)).float())


class VAE(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        if config.use_quant_conv:
            lc = config.latent_channels
            self.quant_conv = Conv(2 * lc, 2 * lc, 1, dtype=torch.float32)
            self.post_quant_conv = Conv(lc, lc, 1, dtype=torch.float32)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] in [0, 1] → [B, H/8, W/8, C] scaled latents
        (the posterior mean)."""
        moments = self.encoder((x * 2.0 - 1.0).permute(0, 3, 1, 2))
        if self.config.use_quant_conv:
            moments = self.quant_conv(moments)
        mean = moments[:, : self.config.latent_channels]
        z = (mean - self.config.shift_factor) * self.config.scaling_factor
        return z.permute(0, 2, 3, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """[B, h, w, C] scaled latents → [B, H, W, 3] images in [0, 1]."""
        z = (z / self.config.scaling_factor + self.config.shift_factor).permute(0, 3, 1, 2)
        if self.config.use_quant_conv:
            z = self.post_quant_conv(z)
        x = self.decoder(z)
        return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0).permute(0, 2, 3, 1)
