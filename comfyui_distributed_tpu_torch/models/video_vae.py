"""Causal 3-D video VAE (WAN class), in PyTorch.

Counterpart of comfyui_distributed_tpu/models/video_vae.py: causal 3-D
convolutions (the temporal window looks backward only), 8x spatial and
4x temporal compression with the WAN frame contract T_latent = (T - 1)
/ 4 + 1, RMS-normed residual blocks, single-head per-frame attention in
the middle, 16 latent channels. Submodules carry the flax names
(encoder.down_N.residual_2.conv, conv1_q.conv, ...), so models/io.py::
from_jax_params carries the JAX tree by rule, and `sd_checkpoint.
wan_vae_schedule` maps the official Wan2.1 state dict. Activations are
[B, C, F, H, W] inside; `encode` and `decode` take and give [B, F, H,
W, C] as the JAX module does.

The clip-boundary rules are the JAX module's: a downsampling time conv
passes frame 0 through untouched and its windows start at [x0, x1, x2];
an upsampling time conv emits z0 un-doubled, and z0's slot reads as
zeros in every window.

Whole clip or time chunks. The JAX package runs the whole clip in one
call. The port encodes frame 0 and then chunks of `temporal_downscale`
frames, and decodes one latent frame at a time (the original WAN
streaming order): every causal conv carries the last frames of its
input from one chunk to the next (`_Stream`), so a chunked pass computes
the whole-clip function with a fraction of its memory. At 81 frames of
480x720 the decoder's top level is 2.69e9 elements an activation in f32
(10.75 GB), past where padding and cuDNN's 3-D convolutions take 32-bit
indices; a 4-frame chunk is 1/20 of that. `chunked=False` runs the whole
clip.

`_SpatialAttention` is the JAX module's f32 einsum (no Pallas kernel
there), so it stays plain PyTorch in f32 here.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv


@dataclasses.dataclass(frozen=True)
class VideoVAEConfig:
    base_dim: int = 96
    z_dim: int = 16
    dim_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    # which encoder levels also downsample time; the decoder mirrors them
    temporal_down: tuple[bool, ...] = (False, True, True)
    # per-channel latent normalization (the WAN wrapper's mean and std);
    # None = identity
    latents_mean: tuple[float, ...] | None = None
    latents_std: tuple[float, ...] | None = None
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.dim_mult) - 1)

    @property
    def temporal_downscale(self) -> int:
        return 2 ** sum(self.temporal_down)

    @property
    def latent_channels(self) -> int:
        return self.z_dim


class _Stream:
    """What each causal conv carries from one time chunk to the next, by
    module: None before its first chunk."""

    def __init__(self):
        self.carry: dict[int, torch.Tensor] = {}

    def take(self, module: nn.Module) -> torch.Tensor | None:
        return self.carry.get(id(module))

    def put(self, module: nn.Module, frames: torch.Tensor) -> None:
        self.carry[id(module)] = frames


class _CausalConv3d(nn.Module):
    """Conv3d whose time window looks backward only: (kt - 1) zero frames
    in front (or, in a stream, the previous chunk's last kt - 1 input
    frames), valid in time, SAME spatially."""

    def __init__(self, in_ch: int, out_ch: int, kernel=(3, 3, 3), stride=(1, 1, 1),
                 dtype=torch.float32):
        super().__init__()
        self.kernel = tuple(kernel)
        _, kh, kw = self.kernel
        self.conv = nn.Conv3d(in_ch, out_ch, self.kernel, stride=tuple(stride),
                              padding=(0, kh // 2, kw // 2), dtype=dtype)

    def _valid(self, x: torch.Tensor) -> torch.Tensor:
        """The conv over x [B, C, F, H, W] already padded in time."""
        return self.conv(x)

    def forward(self, x: torch.Tensor, stream: _Stream | None = None) -> torch.Tensor:
        x = x.to(self.conv.weight.dtype)
        back = self.kernel[0] - 1
        if back == 0:
            return self._valid(x)
        before = None if stream is None else stream.take(self)
        if before is None:
            before = x.new_zeros(x.shape[:2] + (back,) + x.shape[3:])
        padded = torch.cat([before, x], dim=2)
        if stream is not None:
            # a copy: a view would keep the whole chunk's input alive
            stream.put(self, padded[:, :, -back:].clone())
        return self._valid(padded)


class _RMSNormChannels(nn.Module):
    """WAN VAE RMS_norm: x over its channel L2 norm * sqrt(C) * gamma."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, ...]
        xf = x.float()
        unit = xf * torch.rsqrt(xf.square().sum(dim=1, keepdim=True) + 1e-12)
        gamma = self.weight.reshape((-1,) + (1,) * (x.ndim - 2))
        return unit * math.sqrt(x.shape[1]) * gamma


def _frames(x: torch.Tensor) -> torch.Tensor:
    """[B, C, F, H, W] → [B F, C, H, W]."""
    b, c, f, h, w = x.shape
    return x.permute(0, 2, 1, 3, 4).reshape(b * f, c, h, w)


def _clip(flat: torch.Tensor, b: int) -> torch.Tensor:
    """[B F, C, H, W] → [B, C, F, H, W]."""
    bf, c, h, w = flat.shape
    return flat.reshape(b, bf // b, c, h, w).permute(0, 2, 1, 3, 4)


class _ResBlock3d(nn.Module):
    """RMS → SiLU → causal conv → RMS → SiLU → causal conv, plus a 1x1x1
    causal shortcut on a channel change (residual.0/2/3/6)."""

    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype):
        super().__init__()
        self.residual_0 = _RMSNormChannels(in_dim)
        self.residual_2 = _CausalConv3d(in_dim, out_dim, dtype=dtype)
        self.residual_3 = _RMSNormChannels(out_dim)
        self.residual_6 = _CausalConv3d(out_dim, out_dim, dtype=dtype)
        self.shortcut = (_CausalConv3d(in_dim, out_dim, kernel=(1, 1, 1), dtype=dtype)
                         if in_dim != out_dim else None)

    def forward(self, x: torch.Tensor, stream: _Stream | None = None) -> torch.Tensor:
        h = self.residual_2(F.silu(self.residual_0(x)), stream)
        h = self.residual_6(F.silu(self.residual_3(h)), stream)
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + h


class _SpatialAttention(nn.Module):
    """Single-head per-frame spatial attention with 1x1 conv qkv and proj,
    in f32."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = _RMSNormChannels(channels)
        self.to_qkv = Conv(channels, 3 * channels, 1, dtype=torch.float32)
        self.proj = Conv(channels, channels, 1, dtype=torch.float32)

    def forward(self, x: torch.Tensor, stream: _Stream | None = None) -> torch.Tensor:
        b, c, f, hh, ww = x.shape
        qkv = self.to_qkv(_frames(self.norm(x))).reshape(b * f, 3, c, hh * ww)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(1))  # [B F, HW, C]
        attn = torch.softmax(torch.einsum("bnc,bmc->bnm", q, k) / math.sqrt(c), dim=-1)
        out = torch.einsum("bnm,bmc->bnc", attn, v).transpose(1, 2).reshape(b * f, c, hh, ww)
        return x + _clip(self.proj(out), b)


def _per_frame_conv(conv: nn.Conv2d, x: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """A Conv2d applied to every frame of x [B, C, F, H, W], as a (1, k, k)
    Conv3d with the same weights. On the card cuDNN's 2-D heuristics took
    a 36.7 GiB workspace for the 384-channel upsampling conv of a 1-2
    frame chunk (PERF.md, WAN findings); its 3-D ones stay under 0.5 GiB
    here."""
    return F.conv3d(x.to(conv.weight.dtype), conv.weight[:, :, None], conv.bias,
                    stride=(1, stride, stride), padding=(0, padding, padding))


class _Downsample(nn.Module):
    """Zero-pad right and bottom, a stride-2 3x3 conv per frame; where
    `temporal`, then a stride-2 causal time conv whose output frame 0 is
    input frame 0 untouched (the original's streaming path caches the
    first chunk and never convolves it). In a stream the first chunk
    takes the whole-clip rule and has an odd length; later chunks have
    an even one and see the previous chunk's last frame."""

    def __init__(self, dim: int, temporal: bool, dtype: torch.dtype):
        super().__init__()
        self.temporal = temporal
        self.resample_1 = nn.Conv2d(dim, dim, 3, dtype=dtype)
        if temporal:
            self.time_conv = _CausalConv3d(dim, dim, kernel=(3, 1, 1), stride=(2, 1, 1),
                                           dtype=dtype)

    def forward(self, x: torch.Tensor, stream: _Stream | None = None) -> torch.Tensor:
        x = _per_frame_conv(self.resample_1, F.pad(x, (0, 1, 0, 1)), stride=2, padding=0)
        if not self.temporal:
            return x
        before = None if stream is None else stream.take(self)
        if stream is not None:
            stream.put(self, x[:, :, -1:].clone())
        if before is None:
            y = self.time_conv(x)
            return torch.cat([x[:, :, :1], y[:, :, 1:]], dim=2)
        if x.shape[2] % 2:
            raise ValueError(f"a later time chunk of {x.shape[2]} frames: downsampling takes "
                             "an even count")
        return self.time_conv._valid(torch.cat([before, x], dim=2))


class _Upsample(nn.Module):
    """Where `temporal`, a 2C time conv whose channel pairs interleave
    into frame pairs doubles frames 1..L-1, while z0 is emitted
    un-doubled and reads as zeros in every window (the original's 'Rep'
    marker); then 2x nearest and a 3x3 conv per frame to dim // 2."""

    def __init__(self, dim: int, temporal: bool, dtype: torch.dtype):
        super().__init__()
        self.temporal = temporal
        self.dim = dim
        if temporal:
            self.time_conv = _CausalConv3d(dim, 2 * dim, kernel=(3, 1, 1), dtype=dtype)
        self.resample_1 = nn.Conv2d(dim, dim // 2, 3, dtype=dtype)

    def forward(self, x: torch.Tensor, stream: _Stream | None = None) -> torch.Tensor:
        if self.temporal:
            first = stream is None or stream.take(self.time_conv) is None
            if first:  # z0 passes through; its slot reads as zeros
                head, rest = x[:, :, :1], x[:, :, 1:]
                t = self.time_conv(torch.cat([torch.zeros_like(head), rest], dim=2), stream)
                t = t[:, :, 1:]
            else:
                head, t = None, self.time_conv(x, stream)
            bb, _, f, hh, ww = t.shape
            doubled = t.reshape(bb, 2, self.dim, f, hh, ww).permute(0, 2, 3, 1, 4, 5)
            doubled = doubled.reshape(bb, self.dim, 2 * f, hh, ww)
            x = doubled if head is None else torch.cat([head.to(doubled.dtype), doubled], dim=2)
        # 2x nearest (jax.image.resize's at an exact 2x repeats each pixel),
        # then the SAME 3x3 conv
        x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
        return _per_frame_conv(self.resample_1, x, stride=1, padding=1)


class VideoEncoder(nn.Module):
    def __init__(self, config: VideoVAEConfig):
        super().__init__()
        self.config = cfg = config
        dt = cfg.compute_dtype
        dims = [cfg.base_dim * m for m in (1,) + tuple(cfg.dim_mult)]
        self.conv1 = _CausalConv3d(3, dims[0], dtype=dt)
        idx, in_dim = 0, dims[0]
        for level in range(len(cfg.dim_mult)):
            out_dim = dims[level + 1]
            for _ in range(cfg.num_res_blocks):
                setattr(self, f"down_{idx}", _ResBlock3d(in_dim, out_dim, dt))
                in_dim = out_dim
                idx += 1
            if level != len(cfg.dim_mult) - 1:
                setattr(self, f"down_{idx}", _Downsample(out_dim, cfg.temporal_down[level], dt))
                idx += 1
        self.depth = idx
        self.middle_0 = _ResBlock3d(dims[-1], dims[-1], dt)
        self.middle_1 = _SpatialAttention(dims[-1])
        self.middle_2 = _ResBlock3d(dims[-1], dims[-1], dt)
        self.head_0 = _RMSNormChannels(dims[-1])
        self.head_2 = _CausalConv3d(dims[-1], 2 * cfg.z_dim, dtype=torch.float32)

    def forward(self, x: torch.Tensor, stream: _Stream | None = None) -> torch.Tensor:
        x = self.conv1(x, stream)
        for i in range(self.depth):
            x = getattr(self, f"down_{i}")(x, stream)
        for name in ("middle_0", "middle_1", "middle_2"):
            x = getattr(self, name)(x, stream)
        return self.head_2(F.silu(self.head_0(x)), stream)


class VideoDecoder(nn.Module):
    def __init__(self, config: VideoVAEConfig):
        super().__init__()
        self.config = cfg = config
        dt = cfg.compute_dtype
        rev = tuple(reversed(cfg.dim_mult))
        dims = [cfg.base_dim * m for m in (rev[0],) + rev]
        temporal_up = tuple(reversed(cfg.temporal_down))
        self.conv1 = _CausalConv3d(cfg.z_dim, dims[0], dtype=dt)
        self.middle_0 = _ResBlock3d(dims[0], dims[0], dt)
        self.middle_1 = _SpatialAttention(dims[0])
        self.middle_2 = _ResBlock3d(dims[0], dims[0], dt)
        idx, in_dim = 0, dims[0]
        for level in range(len(cfg.dim_mult)):
            out_dim = dims[level + 1]
            for _ in range(cfg.num_res_blocks + 1):
                setattr(self, f"up_{idx}", _ResBlock3d(in_dim, out_dim, dt))
                in_dim = out_dim
                idx += 1
            if level != len(cfg.dim_mult) - 1:
                setattr(self, f"up_{idx}", _Upsample(out_dim, temporal_up[level], dt))
                in_dim = out_dim // 2
                idx += 1
        self.depth = idx
        self.head_0 = _RMSNormChannels(dims[-1])
        self.head_2 = _CausalConv3d(dims[-1], 3, dtype=torch.float32)

    def forward(self, z: torch.Tensor, stream: _Stream | None = None) -> torch.Tensor:
        x = self.conv1(z, stream)
        for name in ("middle_0", "middle_1", "middle_2"):
            x = getattr(self, name)(x, stream)
        for i in range(self.depth):
            x = getattr(self, f"up_{i}")(x, stream)
        return self.head_2(F.silu(self.head_0(x)), stream)


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


class VideoVAE(nn.Module):
    """encode: [B, F, H, W, 3] in [0, 1] (F = 4n+1) → [B, (F-1)/4+1, H/8,
    W/8, z]; decode inverts, clipped to [0, 1]. Latents are the
    gaussian's mean, normalised per channel where the config says."""

    def __init__(self, config: VideoVAEConfig):
        super().__init__()
        self.config = cfg = config
        self.encoder = VideoEncoder(cfg)
        self.decoder = VideoDecoder(cfg)
        self.conv1_q = _CausalConv3d(2 * cfg.z_dim, 2 * cfg.z_dim, kernel=(1, 1, 1))
        self.conv2_q = _CausalConv3d(cfg.z_dim, cfg.z_dim, kernel=(1, 1, 1))

    def _norm(self, z: torch.Tensor, inverse: bool) -> torch.Tensor:
        cfg = self.config
        if cfg.latents_mean is None or cfg.latents_std is None:
            return z
        mean = torch.tensor(cfg.latents_mean, dtype=z.dtype, device=z.device)
        std = torch.tensor(cfg.latents_std, dtype=z.dtype, device=z.device)
        return z * std + mean if inverse else (z - mean) / std

    def _encode_chunk(self, x: torch.Tensor, stream: _Stream | None) -> torch.Tensor:
        moments = self.conv1_q(self.encoder(x, stream))
        return _channels_last(moments[:, :self.config.z_dim])

    def encode(self, x: torch.Tensor, chunked: bool = True) -> torch.Tensor:
        tds = self.config.temporal_downscale
        if (x.shape[1] - 1) % tds != 0:
            raise ValueError(
                f"frame count {x.shape[1]} must be {tds}n+1 (WAN causal contract)")
        x = _channels_first(x.float() * 2.0 - 1.0)
        if not chunked:
            return self._norm(self._encode_chunk(x, None), inverse=False)
        stream = _Stream()
        starts = [0] + list(range(1, x.shape[2], tds))
        parts = [self._encode_chunk(x[:, :, s:s + (1 if s == 0 else tds)], stream)
                 for s in starts]
        return self._norm(torch.cat(parts, dim=1), inverse=False)

    def decode(self, z: torch.Tensor, chunked: bool = True) -> torch.Tensor:
        z = _channels_first(self._norm(z.float(), inverse=True))
        if not chunked:
            x = self.decoder(self.conv2_q(z))
        else:
            stream = _Stream()
            x = torch.cat([self.decoder(self.conv2_q(z[:, :, i:i + 1]), stream)
                           for i in range(z.shape[2])], dim=2)
        return torch.clamp((_channels_last(x) + 1.0) / 2.0, 0.0, 1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))
