"""Image multimodal diffusion transformer (Flux class), in PyTorch.

Counterpart of comfyui_distributed_tpu/models/mmdit.py, checkpoint-
faithful to the published Flux layout:

- 2x2-patchified 16-channel latents and T5 text tokens run as two
  streams through `double_blocks` (their own modulation, attention and
  MLP weights, one joint attention over [txt; img]), then as one stream
  through the fused `single_blocks` (qkv and MLP in one linear pair);
- a per-head RMS norm of q and k over the head dim;
- 3-axis rotary embeddings with a per-axis budget (`axes_dim`, 16/56/56
  of head dim 128): text tokens at position 0 of every axis, image
  tokens at (0, y, x), Kontext reference grids at (1 + i, y, x);
- the conditioning vector = time MLP + CLIP pooled MLP (+ the distilled
  guidance MLP where `guidance_embed`), modulating every block (adaLN)
  and the final layer.

Submodules carry the flax names (double_blocks_N.img_attn_qkv, ...), so
models/io.py::from_jax_params carries the JAX tree by rule and
models/sd_checkpoint.py::flux_schedule maps a Flux state dict. The
modulation and embedder MLPs and the final layer compute in f32 with f32
weights, as the flax modules do (`dtype=float32`); the attention and MLP
linears in the compute dtype. The joint attention is the kernel's D=128
instance on the card (ops/attention.py), 19 + 38 calls an evaluation.

The model predicts rectified-flow velocity v = noise - x0, which is eps
under the samplers' contract (denoised = x - sigma * eps).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from .dit import _axis_freqs, apply_rope
from .layers import Dense, RMSNorm, timestep_embedding


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    in_channels: int = 16          # VAE latent channels
    patch_size: int = 2
    hidden_dim: int = 3072
    double_depth: int = 19
    single_depth: int = 38
    heads: int = 24
    # rope frequency budget per (const, y, x) axis; sums to head_dim
    axes_dim: tuple[int, int, int] = (16, 56, 56)
    context_dim: int = 4096        # T5 hidden width
    vec_dim: int = 768             # CLIP pooled width
    mlp_ratio: float = 4.0
    freq_dim: int = 256            # sinusoidal embedding width
    theta: float = 10000.0
    # guidance-distilled variants (flux-dev) embed the guidance scale
    guidance_embed: bool = True
    guidance_default: float = 3.5
    # rectified flow: flow sigmas and interpolation noising
    parameterization: str = "flow"
    # static timestep shift of the flow schedule (t' = s t / (1 + (s-1) t))
    flow_shift: float = 3.0
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.heads

    @property
    def adm_in_channels(self) -> int:
        """The pooled-text width the model function feeds `vector_in`."""
        return self.vec_dim

    @property
    def mlp_width(self) -> int:
        return int(self.hidden_dim * self.mlp_ratio)


def rope_freqs_image(axes_dim: tuple[int, int, int], txt_len: int, gh: int, gw: int,
                     theta: float = 10000.0, ref_grids: tuple = ()) -> np.ndarray:
    """[txt_len + gh*gw + sum(ref), head_dim/2, 2] cos/sin table (float64):
    text tokens at position 0 of every axis (the identity rotation), image
    tokens at (0, y, x), reference grid i at (1 + i, y, x)."""
    k0, kh, kw = axes_dim[0] // 2, axes_dim[1] // 2, axes_dim[2] // 2
    t0 = _axis_freqs(2 * k0, len(ref_grids) + 1, theta)

    def grid(g_h: int, g_w: int, idx0: int) -> np.ndarray:
        th = _axis_freqs(2 * kh, g_h, theta)
        tw = _axis_freqs(2 * kw, g_w, theta)
        return np.concatenate(
            [
                np.broadcast_to(t0[idx0][None, None], (g_h, g_w, k0, 2)),
                np.broadcast_to(th[:, None], (g_h, g_w, kh, 2)),
                np.broadcast_to(tw[None, :], (g_h, g_w, kw, 2)),
            ],
            axis=2,
        ).reshape(g_h * g_w, -1, 2)

    img = grid(gh, gw, 0)
    pairs = img.shape[1]
    txt = np.broadcast_to(np.stack([np.ones(pairs), np.zeros(pairs)], axis=-1)[None],
                          (txt_len, pairs, 2))
    sections = [txt, img] + [grid(rh, rw, i + 1) for i, (rh, rw) in enumerate(ref_grids)]
    return np.concatenate(sections, axis=0)


class _MLPEmbedder(nn.Module):
    """in_layer → silu → out_layer, in f32 (time_in, vector_in,
    guidance_in)."""

    def __init__(self, in_dim: int, width: int):
        super().__init__()
        self.in_layer = Dense(in_dim, width, dtype=torch.float32)
        self.out_layer = Dense(width, width, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_layer(F.silu(self.in_layer(x.float())))


def _modulation(lin: Dense, vec: torch.Tensor, n: int) -> list[torch.Tensor]:
    """silu(vec) → lin (f32) → n [B, 1, width] chunks."""
    out = lin(F.silu(vec.float()))
    return [c[:, None] for c in out.chunk(n, dim=-1)]


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm without scale or bias (eps 1e-6), in f32."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=1e-6)


class _DoubleBlock(nn.Module):
    """Flux DoubleStreamBlock: separate img/txt streams, one joint
    attention over [txt; img] tokens."""

    def __init__(self, dim: int, heads: int, mlp_width: int, dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        hd = dim // heads
        for s in ("img", "txt"):
            setattr(self, f"{s}_mod_lin", Dense(dim, 6 * dim, dtype=torch.float32))
            setattr(self, f"{s}_attn_qkv", Dense(dim, 3 * dim, dtype=dtype))
            setattr(self, f"{s}_attn_norm_q", RMSNorm(hd))
            setattr(self, f"{s}_attn_norm_k", RMSNorm(hd))
            setattr(self, f"{s}_attn_proj", Dense(dim, dim, dtype=dtype))
            setattr(self, f"{s}_mlp_0", Dense(dim, mlp_width, dtype=dtype))
            setattr(self, f"{s}_mlp_2", Dense(mlp_width, dim, dtype=dtype))

    def _qkv(self, s: str, x: torch.Tensor, shift, scale):
        b, n, dim = x.shape
        h = (_layer_norm(x) * (1 + scale) + shift).to(self.dtype)
        q, k, v = getattr(self, f"{s}_attn_qkv")(h).view(b, n, 3, self.heads, -1).unbind(2)
        q = getattr(self, f"{s}_attn_norm_q")(q).to(self.dtype)
        k = getattr(self, f"{s}_attn_norm_k")(k).to(self.dtype)
        return q, k, v

    def _stream(self, s: str, x, attn, shift2, scale2, gate1, gate2):
        x = x.float() + getattr(self, f"{s}_attn_proj")(attn).float() * gate1
        h = (_layer_norm(x) * (1 + scale2) + shift2).to(self.dtype)
        h = F.gelu(getattr(self, f"{s}_mlp_0")(h), approximate="tanh")
        y = getattr(self, f"{s}_mlp_2")(h)
        return (x + y.float() * gate2).to(self.dtype)

    def forward(self, img, txt, vec, freqs):
        b, ni, dim = img.shape
        nt = txt.shape[1]
        i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = _modulation(self.img_mod_lin, vec, 6)
        t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = _modulation(self.txt_mod_lin, vec, 6)
        iq, ik, iv = self._qkv("img", img, i_sh1, i_sc1)
        tq, tk, tv = self._qkv("txt", txt, t_sh1, t_sc1)
        # joint attention, text tokens first (the Flux token order)
        q = apply_rope(torch.cat([tq, iq], dim=1), freqs)
        k = apply_rope(torch.cat([tk, ik], dim=1), freqs)
        v = torch.cat([tv, iv], dim=1)
        attn = dot_product_attention(q, k, v).reshape(b, nt + ni, dim)
        img = self._stream("img", img, attn[:, nt:], i_sh2, i_sc2, i_g1, i_g2)
        txt = self._stream("txt", txt, attn[:, :nt], t_sh2, t_sc2, t_g1, t_g2)
        return img, txt


class _SingleBlock(nn.Module):
    """Flux SingleStreamBlock: one fused qkv + MLP linear over the
    concatenated [txt; img] stream, and one output linear."""

    def __init__(self, dim: int, heads: int, mlp_width: int, dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        hd = dim // heads
        self.modulation_lin = Dense(dim, 3 * dim, dtype=torch.float32)
        self.linear1 = Dense(dim, 3 * dim + mlp_width, dtype=dtype)
        self.linear2 = Dense(dim + mlp_width, dim, dtype=dtype)
        self.norm_q = RMSNorm(hd)
        self.norm_k = RMSNorm(hd)

    def forward(self, x, vec, freqs):
        b, n, dim = x.shape
        shift, scale, gate = _modulation(self.modulation_lin, vec, 3)
        h = (_layer_norm(x) * (1 + scale) + shift).to(self.dtype)
        fused = self.linear1(h)
        q, k, v = fused[..., :3 * dim].view(b, n, 3, self.heads, -1).unbind(2)
        q = apply_rope(self.norm_q(q).to(self.dtype), freqs)
        k = apply_rope(self.norm_k(k).to(self.dtype), freqs)
        attn = dot_product_attention(q, k, v).reshape(b, n, dim)
        mlp = F.gelu(fused[..., 3 * dim:], approximate="tanh")
        out = self.linear2(torch.cat([attn, mlp], dim=-1))
        return (x.float() + out.float() * gate).to(x.dtype)


def _patchify(arr: torch.Tensor, p: int) -> torch.Tensor:
    """[B, h, w, C] → [B, (h/p)(w/p), C p p], flattened (c, ph, pw) as the
    original rearrange 'b c (h ph) (w pw) -> b (h w) (c ph pw)'."""
    b, h, w, c = arr.shape
    if h % p or w % p:
        raise ValueError(f"latent {h}x{w} is not a multiple of the patch size {p}")
    t = arr.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4)
    return t.reshape(b, (h // p) * (w // p), c * p * p)


class MMDiT(nn.Module):
    def __init__(self, config: MMDiTConfig):
        super().__init__()
        self.config = cfg = config
        dt = cfg.compute_dtype
        width, p = cfg.hidden_dim, cfg.patch_size
        self.img_in = Dense(cfg.in_channels * p * p, width, dtype=dt)
        self.txt_in = Dense(cfg.context_dim, width, dtype=dt)
        self.time_in = _MLPEmbedder(cfg.freq_dim, width)
        if cfg.guidance_embed:
            self.guidance_in = _MLPEmbedder(cfg.freq_dim, width)
        self.vector_in = _MLPEmbedder(cfg.vec_dim, width)
        for i in range(cfg.double_depth):
            setattr(self, f"double_blocks_{i}", _DoubleBlock(width, cfg.heads, cfg.mlp_width, dt))
        for i in range(cfg.single_depth):
            setattr(self, f"single_blocks_{i}", _SingleBlock(width, cfg.heads, cfg.mlp_width, dt))
        self.final_layer_adaLN_lin = Dense(width, 2 * width, dtype=torch.float32)
        self.final_layer_linear = Dense(width, cfg.in_channels * p * p, dtype=torch.float32)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                y: torch.Tensor | None = None, control: torch.Tensor | None = None,
                guidance: torch.Tensor | None = None,
                ref_latents: list | None = None) -> torch.Tensor:
        """x [B, h, w, C] noisy latents, timesteps [B] flow time in [0, 1],
        context [B, T, context_dim] T5 states, y [B, vec_dim] CLIP pooled,
        guidance [B] the distilled guidance scale (the config's default
        where None), ref_latents Kontext's [B, h', w', C] references
        (odd grids edge-padded to the patch) → the velocity [B, h, w, C]
        in f32."""
        cfg = self.config
        if control is not None:
            raise ValueError("Flux-class MMDiT has no ControlNet input path "
                             "(Flux ControlNets are a separate architecture)")
        if sum(cfg.axes_dim) != cfg.head_dim:
            raise ValueError(f"axes_dim {cfg.axes_dim} does not sum to head_dim {cfg.head_dim}")
        b, hh, ww, c = x.shape
        p = cfg.patch_size
        gh, gw = hh // p, ww // p
        ni = gh * gw
        img = self.img_in(_patchify(x, p))
        ref_grids = []
        if ref_latents:
            refs = [img]
            for r in ref_latents:
                r = r.to(device=x.device, dtype=x.dtype)
                pad_h, pad_w = -r.shape[1] % p, -r.shape[2] % p
                if pad_h or pad_w:
                    r = F.pad(r.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h),
                              mode="replicate").permute(0, 2, 3, 1)
                ref_grids.append((r.shape[1] // p, r.shape[2] // p))
                refs.append(self.img_in(_patchify(r, p)))
            img = torch.cat(refs, dim=1)
        txt = self.txt_in(context)
        nt = txt.shape[1]

        vec = self.time_in(timestep_embedding(timesteps.float() * 1000.0, cfg.freq_dim))
        if cfg.guidance_embed:
            g = (torch.full((b,), cfg.guidance_default, dtype=torch.float32, device=x.device)
                 if guidance is None else guidance)
            vec = vec + self.guidance_in(timestep_embedding(g.float() * 1000.0, cfg.freq_dim))
        if y is None:
            y = torch.zeros((b, cfg.vec_dim), dtype=torch.float32, device=x.device)
        vec = vec + self.vector_in(y)

        freqs = torch.from_numpy(
            rope_freqs_image(cfg.axes_dim, nt, gh, gw, cfg.theta, tuple(ref_grids))
        ).to(device=x.device, dtype=torch.float32)
        for i in range(cfg.double_depth):
            img, txt = getattr(self, f"double_blocks_{i}")(img, txt, vec, freqs)
        stream = torch.cat([txt, img], dim=1)
        for i in range(cfg.single_depth):
            stream = getattr(self, f"single_blocks_{i}")(stream, vec, freqs)
        img = stream[:, nt:nt + ni]  # reference tokens are dropped

        shift, scale = _modulation(self.final_layer_adaLN_lin, vec, 2)
        out = self.final_layer_linear(_layer_norm(img) * (1 + scale) + shift)
        out = out.reshape(b, gh, gw, c, p, p).permute(0, 1, 4, 2, 5, 3)
        return out.reshape(b, hh, ww, c)
