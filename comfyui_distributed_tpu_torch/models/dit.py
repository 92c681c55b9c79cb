"""Video diffusion transformer (WAN class), in PyTorch, and the rotary
position tables the transformer families share.

Counterpart of comfyui_distributed_tpu/models/dit.py, checkpoint-
faithful to the original WAN 2.x layout:

- [B, F, H, W, C] video latents cut into (1, 2, 2) patches, flattened
  (pf, ph, pw, c) as `sd_checkpoint.wan_schedule` reshapes the
  `patch_embedding` conv;
- joint spatio-temporal self-attention with 3-D rotary embeddings (the
  frequency pairs split over frame, height and width as WAN's
  rope_params split them), RMS-normed q and k;
- cross-attention to the text tokens, and in the i2v layout a second
  K/V pair over the CLIP-vision tokens summed into it;
- per-block learned modulation added to one shared 6-way timestep
  projection, and a modulated output head.

Dtypes follow the flax modules: the timestep MLP and projection, the
modulation, every LayerNorm and RMSNorm, the residual adds and the head
run in f32; the linears and attention in the compute dtype (bf16).
Submodules carry the flax names (block_N.self_attn_q, ...), so
models/io.py::from_jax_params carries the JAX tree by rule. Attention
goes through ops/attention.py::dot_product_attention at head dim 128:
two calls a block (three in the i2v layout).

The JAX module's `seq_axis` (ring attention over a frame-sharded mesh)
belongs to the multi-GPU tier and raises here.

The per-axis rope table and the adjacent-pair rotation (`apply_rope`)
serve the Flux MMDiT (models/mmdit.py) too; the WAN blocks rotate with
`rotate_pairs`, the same function in fewer passes. Tables are computed in
numpy (float64) from static shapes, as the JAX package computes them at
trace time.

At WAN's widths the f32 elementwise work between the linears takes a
third of the device time, so the block keeps its passes over the tokens
few, each with the JAX block's single rounding into bf16: a modulated
norm is one f32 layer_norm per batch row whose affine is the modulation
(`_modulated_norm`), the rotation one complex product (`rotate_pairs`),
a gated residual one `addcmul` that rounds as it stores
(`_gated_residual`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from .layers import Dense, RMSNorm, timestep_embedding

_SEQ_AXIS_UNPORTED = ("sequence parallelism (DiTConfig.seq_axis: ring attention over a "
                      "frame-sharded mesh) is not ported yet (ROADMAP.md, Queue 1 step 8: the "
                      "multi-GPU tier)")


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    in_channels: int = 16
    out_channels: int | None = None  # defaults to in_channels
    patch_size: tuple[int, int, int] = (1, 2, 2)  # (frames, h, w)
    hidden_dim: int = 1536
    ffn_dim: int | None = None  # defaults to 4*hidden_dim; WAN uses ~5.8x
    depth: int = 30
    heads: int = 12
    context_dim: int = 4096
    freq_dim: int = 256  # sinusoidal timestep embedding width
    # WAN i2v: the image cross-attention branch over CLIP ViT-H's
    # penultimate tokens; the input carries [noise 16 | mask 4 | cond 16]
    i2v: bool = False
    img_dim: int = 1280  # CLIP ViT-H width
    dtype: str = "bfloat16"
    # the multi-GPU tier's frame sharding (step 8): must stay None
    seq_axis: str | None = None

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def ffn_width(self) -> int:
        return self.ffn_dim if self.ffn_dim is not None else 4 * self.hidden_dim

    @property
    def out_width(self) -> int:
        return self.out_channels if self.out_channels is not None else self.in_channels

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.heads


def _axis_freqs(dim: int, length: int, theta: float = 10000.0) -> np.ndarray:
    """[length, dim/2, 2] cos/sin table for one rope axis."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2) / dim))
    t = np.arange(length)
    freqs = np.outer(t, inv)
    return np.stack([np.cos(freqs), np.sin(freqs)], axis=-1)


def rope_split(head_dim: int) -> tuple[int, int, int]:
    """Frequency pairs per (frame, h, w) axis, WAN's rope_params split: of
    the d/2 pairs, h and w each get (d/2)//3 and the frame axis the rest."""
    pairs = head_dim // 2
    kh = kw = pairs // 3
    return pairs - 2 * kh, kh, kw


def rope_freqs_3d(head_dim: int, grid: tuple[int, int, int]) -> np.ndarray:
    """[N, head_dim/2, 2] rope table (float64) for a (gf, gh, gw) token
    grid in row-major (f, h, w) order."""
    gf, gh, gw = grid
    kt, kh, kw = rope_split(head_dim)
    tf = _axis_freqs(2 * kt, gf)
    th = _axis_freqs(2 * kh, gh)
    tw = _axis_freqs(2 * kw, gw)
    parts = [
        np.broadcast_to(tf[:, None, None], (gf, gh, gw, kt, 2)),
        np.broadcast_to(th[None, :, None], (gf, gh, gw, kh, 2)),
        np.broadcast_to(tw[None, None, :], (gf, gh, gw, kw, 2)),
    ]
    return np.concatenate(parts, axis=3).reshape(gf * gh * gw, head_dim // 2, 2)


def apply_rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x: [B, N, H, D]; freqs: [N, D/2, 2] (adjacent-pair rotation), in
    f32; the result in x's dtype."""
    xf = x.float().reshape(*x.shape[:-1], -1, 2)
    cos = freqs[None, :, None, :, 0]
    sin = freqs[None, :, None, :, 1]
    out = torch.stack(
        [xf[..., 0] * cos - xf[..., 1] * sin, xf[..., 0] * sin + xf[..., 1] * cos], dim=-1
    )
    return out.reshape(x.shape).to(x.dtype)


def rope_rotation(freqs: torch.Tensor) -> torch.Tensor:
    """[N, 1, D/2] complex (cos + i sin) of a [N, D/2, 2] rope table, for
    `rotate_pairs` over [B, N, H, D]."""
    return torch.view_as_complex(freqs.contiguous())[:, None, :]


def rotate_pairs(x: torch.Tensor, rotation: torch.Tensor) -> torch.Tensor:
    """`apply_rope` as one complex product: each adjacent pair (x0, x1) of
    x [B, N, H, D] times cos + i sin is (x0 cos - x1 sin, x0 sin + x1 cos),
    in f32; the result in x's dtype. Three passes over x where the stacked
    form takes nine."""
    pairs = torch.view_as_complex(x.float().reshape(*x.shape[:-1], -1, 2))
    return torch.view_as_real(pairs * rotation).reshape(x.shape).to(x.dtype)


def _gated_residual(x: torch.Tensor, y: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """x + y * gate computed in f32 (the gate's dtype) and rounded once
    into x's dtype: on the card the kernel casts as it stores, one pass
    with no f32 intermediate."""
    return torch.addcmul(x, y, gate, out=torch.empty_like(x))


def _plain_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """flax LayerNorm without scale or bias, in f32."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=eps)


def _modulated_norm(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """`_plain_norm(x) * (1 + scale) + shift` rounded once into x's dtype,
    shift and scale [B, 1, dim] in f32: for each batch row one f32
    layer_norm whose weight and bias are the modulation, stored into x's
    dtype."""
    xf, out = x.float(), torch.empty_like(x)
    for i in range(x.shape[0]):
        out[i] = F.layer_norm(xf[i], x.shape[-1:], 1 + scale[i, 0], shift[i, 0], eps)
    return out


class _AffineNorm(nn.LayerNorm):
    """flax LayerNorm with scale and bias in f32 (`eps` as the flax
    module's), returning `dtype`."""

    def __init__(self, width: int, dtype: torch.dtype, eps: float = 1e-6):
        super().__init__(width, eps=eps)
        self.out_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(self.out_dtype)


class _WanBlock(nn.Module):
    """One WAN block; submodule names mirror the state-dict keys
    (self_attn_q ↔ blocks.N.self_attn.q, ...)."""

    def __init__(self, dim: int, heads: int, ffn_width: int, dtype: torch.dtype, i2v: bool):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        self.i2v = i2v
        self.modulation = nn.Parameter(torch.empty(1, 6, dim))
        for attn in ("self_attn", "cross_attn"):
            for leaf in ("q", "k", "v", "o"):
                setattr(self, f"{attn}_{leaf}", Dense(dim, dim, dtype=dtype))
            setattr(self, f"{attn}_norm_q", RMSNorm(dim))
            setattr(self, f"{attn}_norm_k", RMSNorm(dim))
        if i2v:
            self.cross_attn_k_img = Dense(dim, dim, dtype=dtype)
            self.cross_attn_v_img = Dense(dim, dim, dtype=dtype)
            self.cross_attn_norm_k_img = RMSNorm(dim)
        self.norm3 = _AffineNorm(dim, dtype)
        self.ffn_0 = Dense(dim, ffn_width, dtype=dtype)
        self.ffn_2 = Dense(ffn_width, dim, dtype=dtype)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.dtype).reshape(t.shape[0], t.shape[1], self.heads, -1)

    def forward(self, x: torch.Tensor, e6: torch.Tensor, context: torch.Tensor,
                rotation: torch.Tensor, context_img: torch.Tensor | None = None) -> torch.Tensor:
        """rotation: `rope_rotation` of the token grid's table."""
        b, n, dim = x.shape
        e = self.modulation + e6.float()  # [B, 6, dim]
        sh1, sc1, g1, sh2, sc2, g2 = (e[:, i:i + 1] for i in range(6))

        # self-attention: modulated, RMS q/k norm, rope; the modulation and
        # residual adds in f32 (scale, shift and gate are), cast back
        h = _modulated_norm(x, sh1, sc1)
        q = rotate_pairs(self._heads(self.self_attn_norm_q(self.self_attn_q(h))), rotation)
        k = rotate_pairs(self._heads(self.self_attn_norm_k(self.self_attn_k(h))), rotation)
        v = self._heads(self.self_attn_v(h))
        y = self.self_attn_o(dot_product_attention(q, k, v).reshape(b, n, dim))
        x = _gated_residual(x, y, g1)

        # cross-attention to the text (and the i2v image tokens), affine norm
        h = self.norm3(x)
        qc = self._heads(self.cross_attn_norm_q(self.cross_attn_q(h)))
        kc = self._heads(self.cross_attn_norm_k(self.cross_attn_k(context)))
        vc = self._heads(self.cross_attn_v(context))
        xattn = dot_product_attention(qc, kc, vc).reshape(b, n, dim)
        if self.i2v and context_img is not None:
            ki = self._heads(self.cross_attn_norm_k_img(self.cross_attn_k_img(context_img)))
            vi = self._heads(self.cross_attn_v_img(context_img))
            xattn = xattn + dot_product_attention(qc, ki, vi).reshape(b, n, dim)
        x = x + self.cross_attn_o(xattn)

        # feed-forward, modulated
        h = _modulated_norm(x, sh2, sc2)
        y = self.ffn_2(F.gelu(self.ffn_0(h), approximate="tanh"))
        return _gated_residual(x, y, g2)


class VideoDiT(nn.Module):
    def __init__(self, config: DiTConfig):
        super().__init__()
        self.config = cfg = config
        dt = cfg.compute_dtype
        width = cfg.hidden_dim
        pf, ph, pw = cfg.patch_size
        self.patch_embed = Dense(pf * ph * pw * cfg.in_channels, width, dtype=dt)
        self.time_embed_0 = Dense(cfg.freq_dim, width, dtype=torch.float32)
        self.time_embed_2 = Dense(width, width, dtype=torch.float32)
        self.time_proj = Dense(width, 6 * width, dtype=torch.float32)
        self.text_embed_0 = Dense(cfg.context_dim, width, dtype=dt)
        self.text_embed_2 = Dense(width, width, dtype=dt)
        if cfg.i2v:
            self.img_emb_norm_in = _AffineNorm(cfg.img_dim, dt, eps=1e-5)
            self.img_emb_fc1 = Dense(cfg.img_dim, cfg.img_dim, dtype=dt)
            self.img_emb_fc2 = Dense(cfg.img_dim, width, dtype=dt)
            self.img_emb_norm_out = _AffineNorm(width, dt, eps=1e-5)
        for i in range(cfg.depth):
            setattr(self, f"block_{i}", _WanBlock(width, cfg.heads, cfg.ffn_width, dt, cfg.i2v))
        self.head_modulation = nn.Parameter(torch.empty(1, 2, width))
        self.head = Dense(width, pf * ph * pw * cfg.out_width, dtype=torch.float32)

    @torch.no_grad()
    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                image_embeds: torch.Tensor | None = None) -> torch.Tensor:
        """x [B, F, H, W, C] noisy video latents, timesteps [B] (flow time
        x 1000), context [B, T, context_dim], image_embeds the i2v CLIP
        tokens [B, 257, img_dim] → the velocity [B, F, H, W, out] in f32.
        Inference only: the gated residuals store into new tensors
        (`out=`), which autograd does not record."""
        cfg = self.config
        if cfg.seq_axis is not None:
            raise NotImplementedError(_SEQ_AXIS_UNPORTED)
        dt = cfg.compute_dtype
        b, f, hh, ww, c = x.shape
        pf, ph, pw = cfg.patch_size
        if f % pf or hh % ph or ww % pw:
            raise ValueError(f"latent {f}x{hh}x{ww} is not a multiple of the patch {cfg.patch_size}")
        gf, gh, gw = f // pf, hh // ph, ww // pw
        n = gf * gh * gw

        # 3-D patchify, flattened (pf, ph, pw, c)
        tokens = x.reshape(b, gf, pf, gh, ph, gw, pw, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
        tokens = self.patch_embed(tokens.reshape(b, n, pf * ph * pw * c).to(dt))

        # timestep MLP and the shared 6-way projection, in f32
        e_t = self.time_embed_0(timestep_embedding(timesteps.to(x.device), cfg.freq_dim))
        e_t = self.time_embed_2(F.silu(e_t))
        e6 = self.time_proj(F.silu(e_t)).reshape(b, 6, cfg.hidden_dim)

        context = self.text_embed_0(context.to(dt))
        context = self.text_embed_2(F.gelu(context, approximate="tanh"))

        # i2v image tokens: LN, Linear, GELU, Linear, LN (WAN img_emb)
        context_img = None
        if cfg.i2v and image_embeds is not None:
            h_img = self.img_emb_fc1(self.img_emb_norm_in(image_embeds))
            h_img = self.img_emb_fc2(F.gelu(h_img))
            context_img = self.img_emb_norm_out(h_img)

        rotation = rope_rotation(torch.from_numpy(rope_freqs_3d(cfg.head_dim, (gf, gh, gw))).to(
            device=x.device, dtype=torch.float32))
        for i in range(cfg.depth):
            tokens = getattr(self, f"block_{i}")(tokens, e6, context, rotation, context_img)

        # modulated head: a learned 2-way modulation added to the raw
        # timestep embedding
        e2 = self.head_modulation + e_t[:, None, :]
        shift, scale = e2[:, 0:1], e2[:, 1:2]
        out = self.head(_plain_norm(tokens) * (1 + scale) + shift)
        out = out.reshape(b, gf, gh, gw, pf, ph, pw, cfg.out_width)
        return out.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, f, hh, ww, cfg.out_width)
