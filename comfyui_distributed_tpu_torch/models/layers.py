"""Shared neural blocks of the SD model zoo, in PyTorch.

Counterpart of comfyui_distributed_tpu/models/layers.py. Submodules
carry the flax module names (`GroupNorm_0`, `LayerNorm_1`, `Dense_0`,
...) so a flax parameter path maps onto a PyTorch parameter name by rule
(models/io.py::from_jax_params).

Dtypes follow the flax modules: weights of a `Dense`/`Conv` live in the
block's compute dtype and the input is cast to it, which computes what
flax does when it casts f32 parameters at every call; norms run in f32
and hand back the input's dtype. Blocks between `UNet` entry and exit
take NCHW; tokens are [B, N, C]; attention is [B, N, H, D].
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention


class Dense(nn.Linear):
    """flax `nn.Dense(dtype=...)`: the input is cast to the weight dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class Conv(nn.Conv2d):
    """flax `nn.Conv` on NCHW input. `padding="SAME"` pads as flax does:
    for a stride-2 conv on an even size that is (0, 1), not (1, 1)."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding="SAME", dtype=None):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride, padding=0, dtype=dtype)
        self.same = padding == "SAME"
        if not self.same:
            self.padding = (padding, padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype)
        if self.same:
            pads = []
            for size, k, s in zip(x.shape[:1:-1], self.kernel_size[::-1], self.stride[::-1]):
                total = max((-(-size // s) - 1) * s + k - size, 0)
                pads += [total // 2, total - total // 2]
            if pads[0] == pads[1] and pads[2] == pads[3]:
                return F.conv2d(x, self.weight, self.bias, self.stride, (pads[2], pads[0]))
            x = F.pad(x, pads)
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding [B] → [B, dim] in f32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device)
        / half
    )
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class GroupNorm32(nn.Module):
    """GroupNorm in f32 whatever the activation dtype; when the channel
    count is not a multiple of 32 the group count drops to the largest
    divisor below it."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        groups = min(num_groups, channels)
        while channels % groups != 0:
            groups -= 1
        self.GroupNorm_0 = nn.GroupNorm(groups, channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        return self.GroupNorm_0(x.float()).to(x.dtype)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm in f32, eps 1e-5 (torch's default, as SD checkpoints
    expect), returning `dtype`."""

    def __init__(self, width: int, dtype: torch.dtype):
        super().__init__(width, eps=1e-5)
        self.out_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(self.out_dtype)


class AttentionBlock(nn.Module):
    """Multi-head attention over tokens: self-attention when `context`
    is None, cross-attention otherwise."""

    def __init__(self, query_dim: int, context_dim: int, num_heads: int,
                 head_dim: int, dtype: torch.dtype):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.to_q = Dense(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Dense(context_dim, inner, bias=False, dtype=dtype)
        self.to_v = Dense(context_dim, inner, bias=False, dtype=dtype)
        self.to_out = Dense(inner, inner, dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        ctx = x if context is None else context
        q = self.to_q(x)
        k = self.to_k(ctx)
        v = self.to_v(ctx)
        b, n, inner = q.shape
        m = k.shape[1]
        out = dot_product_attention(
            q.view(b, n, self.num_heads, self.head_dim),
            k.view(b, m, self.num_heads, self.head_dim),
            v.view(b, m, self.num_heads, self.head_dim),
        )
        return self.to_out(out.reshape(b, n, inner))


class GEGLU(nn.Module):
    """Value half first, then the gate through exact gelu: the SD
    checkpoint's ff.net.0.proj order."""

    def __init__(self, dim_in: int, dim_out: int, dtype: torch.dtype):
        super().__init__()
        self.Dense_0 = Dense(dim_in, dim_out * 2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        val, gate = self.Dense_0(x).chunk(2, dim=-1)
        return val * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype, mult: int = 4):
        super().__init__()
        self.GEGLU_0 = GEGLU(dim, dim * mult, dtype)
        self.Dense_0 = Dense(dim * mult, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(self.GEGLU_0(x))


class TransformerBlock(nn.Module):
    """Self-attention → cross-attention → feed-forward, pre-LayerNorm."""

    def __init__(self, dim: int, context_dim: int, num_heads: int, head_dim: int,
                 dtype: torch.dtype):
        super().__init__()
        self.LayerNorm_0 = LayerNorm32(dim, dtype)
        self.attn1 = AttentionBlock(dim, dim, num_heads, head_dim, dtype)
        self.LayerNorm_1 = LayerNorm32(dim, dtype)
        self.attn2 = AttentionBlock(dim, context_dim, num_heads, head_dim, dtype)
        self.LayerNorm_2 = LayerNorm32(dim, dtype)
        self.ff = FeedForward(dim, dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None) -> torch.Tensor:
        x = x + self.attn1(self.LayerNorm_0(x))
        x = x + self.attn2(self.LayerNorm_1(x), context)
        return x + self.ff(self.LayerNorm_2(x))


class SpatialTransformer(nn.Module):
    """NCHW → tokens → `depth` transformer blocks → NCHW, plus residual."""

    def __init__(self, channels: int, context_dim: int, num_heads: int, head_dim: int,
                 depth: int, dtype: torch.dtype):
        super().__init__()
        self.norm = GroupNorm32(channels)
        self.proj_in = Dense(channels, channels, dtype=dtype)
        for i in range(depth):
            self.add_module(
                f"block_{i}",
                TransformerBlock(channels, context_dim, num_heads, head_dim, dtype),
            )
        self.depth = depth
        self.proj_out = Dense(channels, channels, dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None) -> torch.Tensor:
        b, c, h, w = x.shape
        tokens = self.proj_in(self.norm(x).permute(0, 2, 3, 1)).reshape(b, h * w, c)
        for i in range(self.depth):
            tokens = getattr(self, f"block_{i}")(tokens, context)
        out = self.proj_out(tokens.reshape(b, h, w, c)).permute(0, 3, 1, 2)
        return out + x


class ResBlock(nn.Module):
    """Conv residual block with timestep-embedding modulation."""

    def __init__(self, in_channels: int, out_channels: int, emb_dim: int, dtype: torch.dtype):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels)
        self.conv1 = Conv(in_channels, out_channels, 3, dtype=dtype)
        self.emb_proj = Dense(emb_dim, out_channels, dtype=dtype)
        self.norm2 = GroupNorm32(out_channels)
        self.conv2 = Conv(out_channels, out_channels, 3, dtype=dtype)
        self.skip = (
            Conv(in_channels, out_channels, 1, dtype=dtype)
            if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.emb_proj(F.silu(emb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class Downsample(nn.Module):
    """Stride-2 3x3 conv with symmetric (1, 1) padding, the SD UNet
    convention (flax SAME would pad (0, 1))."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.op = Conv(channels, channels, 3, stride=2, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest resize of an NCHW tensor with jax.image.resize's sampling:
    output i reads input floor((i + 0.5) * in / out), in f32."""
    for dim, size in ((2, out_hw[0]), (3, out_hw[1])):
        n_in = x.shape[dim]
        if n_in == size:
            continue
        idx = np.floor(
            ((np.arange(size, dtype=np.float32) + 0.5) * n_in / size).astype(np.float32)
        ).astype(np.int64)
        x = x.index_select(dim, torch.from_numpy(idx).to(x.device))
    return x


class Upsample(nn.Module):
    """Nearest resize (2x, or onto `out_hw` so the up path lands on the
    skip connection's size) then a 3x3 conv."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.conv = Conv(channels, channels, 3, dtype=dtype)

    def forward(self, x: torch.Tensor, out_hw: tuple[int, int] | None = None) -> torch.Tensor:
        if out_hw is None:
            out_hw = (x.shape[2] * 2, x.shape[3] * 2)
        return self.conv(resize_nearest(x, out_hw))
