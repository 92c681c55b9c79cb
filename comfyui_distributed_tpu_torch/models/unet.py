"""Latent-diffusion UNet (SD1.5 / SDXL class) in PyTorch.

Counterpart of comfyui_distributed_tpu/models/unet.py: timestep and
optional pooled-vector (adm) conditioning, down/mid/up ResBlock stacks
with spatial transformers cross-attending to the text context, skip
connections across the U. Latents enter and leave as [B, H, W, C] (the
JAX layout); inside, activations are NCHW for cuDNN's convolutions.

`pag=True` is the PAG perturbed pass: the middle block's self-attention
becomes the identity (out = V through the output projection), and those
calls launch no attention kernel. `control` adds a ControlNet residual
after the input conv. `sag_capture=True` is SAG's capture pass: the
middle block's first self-attention also returns its probabilities (a
plain attention there, as in the JAX package). A config with `freeu`
re-weights the up path's joins (FreeU, FreeU_V2); `UNet.with_freeu`
gives such a UNet over the same parameters.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (
    Conv,
    Dense,
    Downsample,
    GroupNorm32,
    ResBlock,
    SpatialTransformer,
    Upsample,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Sequence[int] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    # transformer depth per resolution level (0 = no attention there)
    transformer_depth: Sequence[int] = (1, 1, 1, 0)
    context_dim: int = 768
    num_heads: int = 8
    # fixed per-head width (SDXL's num_head_channels=64): when set, each
    # level uses out_ch // head_dim heads and num_heads is ignored
    head_dim: Optional[int] = None
    # width of the pooled text + size conditioning vector (0 = none)
    adm_in_channels: int = 0
    parameterization: str = "eps"
    dtype: str = "bfloat16"
    # FreeU patch (b1, b2, s1, s2, v2): backbone-half scaling and a
    # Fourier low-pass of the skip at the model_channels*4 and *2 up-path
    # joins; None = unpatched
    freeu: Optional[tuple] = None

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _fourier_lowpass_scale(x: torch.Tensor, threshold: int, scale: float) -> torch.Tensor:
    """Scale the centred (2*threshold)^2 low-frequency box of an NCHW
    plane's spectrum over H and W (FreeU's Fourier filter), in f32, back
    in x's dtype."""
    xf = torch.fft.fftshift(torch.fft.fftn(x.float(), dim=(2, 3)), dim=(2, 3))
    hh, ww = x.shape[2], x.shape[3]
    crow, ccol = hh // 2, ww // 2
    mask = torch.ones((1, 1, hh, ww), dtype=torch.float32, device=x.device)
    mask[..., max(0, crow - threshold):min(hh, crow + threshold),
         max(0, ccol - threshold):min(ww, ccol + threshold)] = scale
    xf = torch.fft.ifftshift(xf * mask, dim=(2, 3))
    return torch.fft.ifftn(xf, dim=(2, 3)).real.to(x.dtype)


def _apply_freeu(freeu: tuple, ch: int, h: torch.Tensor, skip: torch.Tensor):
    """FreeU at one up-path join (NCHW): the backbone's first half of
    channels scaled by b and the skip's low frequencies by s, keyed on
    the backbone width (model_channels*4 → b1/s1, *2 → b2/s2); v2 scales
    by the normalised per-pixel hidden mean instead of a constant."""
    b1, b2, s1, s2, v2 = freeu
    pair = {ch * 4: (b1, s1), ch * 2: (b2, s2)}.get(h.shape[1])
    if pair is None:
        return h, skip
    b, s = pair
    half = h.shape[1] // 2
    if v2:
        hidden_mean = h.float().mean(dim=1, keepdim=True)
        hmax = hidden_mean.amax(dim=(2, 3), keepdim=True)
        hmin = hidden_mean.amin(dim=(2, 3), keepdim=True)
        hidden_mean = (hidden_mean - hmin) / torch.clamp(hmax - hmin, min=1e-8)
        factor = ((b - 1.0) * hidden_mean + 1.0).to(h.dtype)
    else:
        # the constant in h's dtype, as jnp.asarray(b, h.dtype)
        factor = torch.tensor(b, dtype=h.dtype, device=h.device)
    h = torch.cat([h[:, :half] * factor, h[:, half:]], dim=1)
    return h, _fourier_lowpass_scale(skip, 1, s)


class UNet(nn.Module):
    def __init__(self, config: UNetConfig):
        super().__init__()
        self.config = cfg = config
        dt = cfg.compute_dtype
        ch = cfg.model_channels
        emb_dim = ch * 4

        def heads(width: int) -> tuple[int, int]:
            if cfg.head_dim:
                return width // cfg.head_dim, cfg.head_dim
            return cfg.num_heads, width // cfg.num_heads

        def transformer(width: int, depth: int) -> SpatialTransformer:
            n_heads, hdim = heads(width)
            return SpatialTransformer(width, cfg.context_dim, n_heads, hdim, depth, dt)

        self.time_embed_0 = Dense(ch, emb_dim, dtype=dt)
        self.time_embed_2 = Dense(emb_dim, emb_dim, dtype=dt)
        if cfg.adm_in_channels:
            self.label_embed_0 = Dense(cfg.adm_in_channels, emb_dim, dtype=dt)
            self.label_embed_2 = Dense(emb_dim, emb_dim, dtype=dt)
        self.input_conv = Conv(cfg.in_channels, ch, 3, dtype=dt)

        cur = ch
        skip_chs = [ch]
        last = len(cfg.channel_mult) - 1
        for level, mult in enumerate(cfg.channel_mult):
            out_ch = ch * mult
            for i in range(cfg.num_res_blocks):
                self.add_module(f"down_{level}_res_{i}", ResBlock(cur, out_ch, emb_dim, dt))
                cur = out_ch
                if cfg.transformer_depth[level] > 0:
                    self.add_module(
                        f"down_{level}_attn_{i}",
                        transformer(out_ch, cfg.transformer_depth[level]),
                    )
                skip_chs.append(cur)
            if level != last:
                self.add_module(f"down_{level}_ds", Downsample(cur, dt))
                skip_chs.append(cur)

        self.mid_res_0 = ResBlock(cur, cur, emb_dim, dt)
        self.mid_attn = transformer(cur, max(cfg.transformer_depth[-1], 1))
        self.mid_res_1 = ResBlock(cur, cur, emb_dim, dt)

        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            out_ch = ch * mult
            for i in range(cfg.num_res_blocks + 1):
                self.add_module(
                    f"up_{level}_res_{i}",
                    ResBlock(cur + skip_chs.pop(), out_ch, emb_dim, dt),
                )
                cur = out_ch
                if cfg.transformer_depth[level] > 0:
                    self.add_module(
                        f"up_{level}_attn_{i}",
                        transformer(out_ch, cfg.transformer_depth[level]),
                    )
            if level != 0:
                self.add_module(f"up_{level}_us", Upsample(cur, dt))

        self.out_norm = GroupNorm32(cur)
        # zero-initialised in the JAX package: an untrained UNet predicts 0
        self.out_conv = Conv(cur, cfg.out_channels, 3, dtype=torch.float32)

    def with_freeu(self, freeu: tuple | None) -> "UNet":
        """A UNet with its own FreeU config over this one's submodules and
        parameters (no weight is copied; this UNet is left as it is)."""
        patched = copy.copy(self)
        patched.config = dataclasses.replace(self.config, freeu=freeu)
        return patched

    def forward(
        self,
        x: torch.Tensor,          # [B, H, W, C_in] noisy latents
        timesteps: torch.Tensor,  # [B]
        context: torch.Tensor,    # [B, T, context_dim]
        y: torch.Tensor | None = None,  # [B, adm_in_channels]
        control: torch.Tensor | None = None,  # [B, H, W, model_channels]
        pag: bool = False,  # identity self-attention in the middle block
        sag_capture: bool = False,
    ):
        """→ [B, H, W, C_out] in f32; with `sag_capture`, (that, the
        middle block's first self-attention probabilities [B, heads, N,
        N] in f32, (mid_h, mid_w))."""
        cfg = self.config
        dt = cfg.compute_dtype
        emb = self.time_embed_0(timestep_embedding(timesteps, cfg.model_channels).to(dt))
        emb = self.time_embed_2(F.silu(emb))
        if cfg.adm_in_channels:
            if y is None:
                y = torch.zeros((x.shape[0], cfg.adm_in_channels), dtype=dt, device=x.device)
            label = self.label_embed_2(F.silu(self.label_embed_0(y.to(dt))))
            emb = emb + label

        context = context.to(dt)
        h = self.input_conv(x.to(dt).permute(0, 3, 1, 2))
        if control is not None:
            # the ControlNet residual at latent resolution
            h = h + control.to(dt).permute(0, 3, 1, 2)
        skips = [h]
        last = len(cfg.channel_mult) - 1
        for level in range(len(cfg.channel_mult)):
            for i in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{level}_res_{i}")(h, emb)
                if cfg.transformer_depth[level] > 0:
                    h = getattr(self, f"down_{level}_attn_{i}")(h, context)
                skips.append(h)
            if level != last:
                h = getattr(self, f"down_{level}_ds")(h)
                skips.append(h)

        h = self.mid_res_0(h, emb)
        capture = [] if sag_capture else None
        mid_hw = (h.shape[2], h.shape[3])
        h = self.mid_attn(h, context, pag=pag, capture=capture)
        h = self.mid_res_1(h, emb)

        for level in reversed(range(len(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                skip = skips.pop()
                if cfg.freeu is not None:
                    h, skip = _apply_freeu(cfg.freeu, cfg.model_channels, h, skip)
                h = torch.cat([h, skip], dim=1)
                h = getattr(self, f"up_{level}_res_{i}")(h, emb)
                if cfg.transformer_depth[level] > 0:
                    h = getattr(self, f"up_{level}_attn_{i}")(h, context)
            if level != 0:
                # land exactly on the next skip's size (odd latents do not
                # round-trip through the stride-2 convs)
                h = getattr(self, f"up_{level}_us")(h, tuple(skips[-1].shape[2:]))

        h = F.silu(self.out_norm(h))
        out = self.out_conv(h.float()).permute(0, 2, 3, 1)
        if sag_capture:
            return out, capture[0], mid_hw
        return out
