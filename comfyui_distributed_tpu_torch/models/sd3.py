"""SD3-class image MMDiT (Stable Diffusion 3 / 3.5), in PyTorch.

Counterpart of comfyui_distributed_tpu/models/sd3.py, checkpoint-faithful
to the published `model.diffusion_model.*` layout:

- 2x2 patches of the 16-channel latents embedded by a stride-2 conv
  (`x_embedder.proj`, here the Dense over (c, ph, pw)-flattened patches
  it equals), plus a LEARNED position table (`pos_embed`, [1, max^2,
  width] f32) cropped around its centre to the latent grid;
- `depth` joint blocks, each an (x, context) pair of streams with their
  own modulation, attention and MLP weights and one joint attention over
  [context; x]; the last block's context side is `pre_only` (qkv and a
  2-way adaLN only) and its context output is dropped;
- SD3.5's per-head RMS norm of q and k (`ln_q`, `ln_k`, eps 1e-6, in
  f32); SD3.5-medium's MMDiT-X: the first `dual_attn_blocks` x streams
  carry a second, image-only attention (`attn2`) and a 9-way adaLN in the
  chunk order (msa, mlp, msa2), its residual added between the joint
  attention's and the MLP's;
- the conditioning vector = time MLP (of t * 1000) + pooled-text MLP
  (CLIP-L ++ CLIP-G), modulating every block and the final layer.

Precision follows the flax modules: the modulation and embedder Dense
layers, the LayerNorms, the residual sums and the final layer in f32 with
f32 weights; the attention and MLP linears in the compute dtype, each
block's streams cast back to it at the block's end. The position table
is added after the patch embedding is cast to the compute dtype.

The joint attention (and MMDiT-X's `attn2`) is the kernel's D=64 instance
on the card (ops/attention.py): `depth + dual_attn_blocks` calls an
evaluation. `skip_layers` bypasses whole joint blocks (skip-layer
guidance's perturbed pass). The model predicts rectified-flow velocity,
which is eps under the samplers' contract (denoised = x - sigma * eps).

Submodules carry the flax names (joint_blocks_N.x_attn_qkv, ...), so
models/io.py::from_jax_params carries the JAX tree by rule and
models/sd_checkpoint.py::sd3_schedule maps a state dict.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from .layers import Dense, RMSNorm, timestep_embedding
from .mmdit import _layer_norm, _modulation, _patchify


@dataclasses.dataclass(frozen=True)
class SD3Config:
    in_channels: int = 16
    patch_size: int = 2
    depth: int = 24                # joint blocks; width = 64 * depth by default
    hidden_dim: int | None = None
    heads: int | None = None       # default depth (head dim 64)
    context_dim: int = 4096        # the T5 width, which the CLIP states are padded to
    pooled_dim: int = 2048         # CLIP-L (768) ++ CLIP-G (1280)
    mlp_ratio: float = 4.0
    freq_dim: int = 256
    pos_embed_max: int = 192       # the position table covers max x max patches
    qk_norm: bool = False          # SD3.5: per-head RMS ln_q / ln_k
    # MMDiT-X: the first N x streams carry attn2 (the published
    # x_block_self_attn_layers are the contiguous range 0..12)
    dual_attn_blocks: int = 0
    parameterization: str = "flow"
    flow_shift: float = 3.0        # the published SD3 sampling shift
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def width(self) -> int:
        return self.hidden_dim if self.hidden_dim is not None else 64 * self.depth

    @property
    def n_heads(self) -> int:
        return self.heads if self.heads is not None else self.depth

    @property
    def head_dim(self) -> int:
        return self.width // self.n_heads

    @property
    def mlp_width(self) -> int:
        return int(self.width * self.mlp_ratio)

    @property
    def adm_in_channels(self) -> int:
        """The pooled-text width the model function feeds `y`."""
        return self.pooled_dim


class _JointBlock(nn.Module):
    """One joint block: context and x streams, one joint attention over
    [context; x]. `pre_only`: the context side has qkv and a 2-way adaLN
    only. `dual_attn`: the x side's MMDiT-X attn2 branch."""

    def __init__(self, dim: int, heads: int, mlp_width: int, dtype: torch.dtype,
                 qk_norm: bool, pre_only: bool, dual_attn: bool):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.pre_only, self.dual_attn, self.qk_norm = pre_only, dual_attn, qk_norm
        hd = dim // heads
        self.ctx_mod_lin = Dense(dim, (2 if pre_only else 6) * dim, dtype=torch.float32)
        self.x_mod_lin = Dense(dim, (9 if dual_attn else 6) * dim, dtype=torch.float32)
        attentions = ("ctx", "x", "x2") if dual_attn else ("ctx", "x")
        for s in attentions:
            setattr(self, f"{s}_attn_qkv", Dense(dim, 3 * dim, dtype=dtype))
            if qk_norm:
                setattr(self, f"{s}_attn_ln_q", RMSNorm(hd))
                setattr(self, f"{s}_attn_ln_k", RMSNorm(hd))
            if not (s == "ctx" and pre_only):
                setattr(self, f"{s}_attn_proj", Dense(dim, dim, dtype=dtype))
        for s in ("x",) if pre_only else ("ctx", "x"):
            setattr(self, f"{s}_mlp_fc1", Dense(dim, mlp_width, dtype=dtype))
            setattr(self, f"{s}_mlp_fc2", Dense(mlp_width, dim, dtype=dtype))

    def _qkv(self, s: str, h: torch.Tensor, shift, scale):
        """The modulated pre-norm of stream input h, then q, k, v [B, N,
        H, D] in the compute dtype (RMS-normed in f32 under qk_norm)."""
        b, n, _ = h.shape
        h = (_layer_norm(h) * (1 + scale) + shift).to(self.dtype)
        q, k, v = getattr(self, f"{s}_attn_qkv")(h).view(b, n, 3, self.heads, -1).unbind(2)
        if self.qk_norm:
            q = getattr(self, f"{s}_attn_ln_q")(q).to(self.dtype)
            k = getattr(self, f"{s}_attn_ln_k")(k).to(self.dtype)
        return q, k, v

    def _post(self, s: str, h, attn, gate1, shift2, scale2, gate2, attn2=None, gate_a2=None):
        """The attention residual(s) and the MLP, summed in f32, cast back
        to the compute dtype."""
        h = h.float() + getattr(self, f"{s}_attn_proj")(attn).float() * gate1
        if attn2 is not None:
            h = h + self.x2_attn_proj(attn2).float() * gate_a2
        y = (_layer_norm(h) * (1 + scale2) + shift2).to(self.dtype)
        y = F.gelu(getattr(self, f"{s}_mlp_fc1")(y), approximate="tanh")
        y = getattr(self, f"{s}_mlp_fc2")(y)
        return (h + y.float() * gate2).to(self.dtype)

    def forward(self, ctx: torch.Tensor, x: torch.Tensor, vec: torch.Tensor):
        b, nx, dim = x.shape
        nc = ctx.shape[1]
        if self.pre_only:
            c_sh1, c_sc1 = _modulation(self.ctx_mod_lin, vec, 2)
        else:
            c_sh1, c_sc1, c_g1, c_sh2, c_sc2, c_g2 = _modulation(self.ctx_mod_lin, vec, 6)
        x_mod = _modulation(self.x_mod_lin, vec, 9 if self.dual_attn else 6)
        x_sh1, x_sc1, x_g1, x_sh2, x_sc2, x_g2 = x_mod[:6]
        cq, ck, cv = self._qkv("ctx", ctx, c_sh1, c_sc1)
        xq, xk, xv = self._qkv("x", x, x_sh1, x_sc1)
        # joint attention, text tokens first
        attn = dot_product_attention(torch.cat([cq, xq], dim=1), torch.cat([ck, xk], dim=1),
                                     torch.cat([cv, xv], dim=1)).reshape(b, nc + nx, dim)
        attn2 = gate_a2 = None
        if self.dual_attn:
            # image-only self-attention on x, modulated on its own
            x2_sh, x2_sc, gate_a2 = x_mod[6:]
            attn2 = dot_product_attention(*self._qkv("x2", x, x2_sh, x2_sc)).reshape(b, nx, dim)
        x = self._post("x", x, attn[:, nc:], x_g1, x_sh2, x_sc2, x_g2, attn2, gate_a2)
        if self.pre_only:
            return None, x
        return self._post("ctx", ctx, attn[:, :nc], c_g1, c_sh2, c_sc2, c_g2), x


class SD3MMDiT(nn.Module):
    def __init__(self, config: SD3Config):
        super().__init__()
        self.config = cfg = config
        dt = cfg.compute_dtype
        width, p = cfg.width, cfg.patch_size
        self.x_embedder_proj = Dense(cfg.in_channels * p * p, width, dtype=dt)
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.pos_embed_max ** 2, width))
        self.context_embedder = Dense(cfg.context_dim, width, dtype=dt)
        self.t_embedder_mlp_0 = Dense(cfg.freq_dim, width, dtype=torch.float32)
        self.t_embedder_mlp_2 = Dense(width, width, dtype=torch.float32)
        self.y_embedder_mlp_0 = Dense(cfg.pooled_dim, width, dtype=torch.float32)
        self.y_embedder_mlp_2 = Dense(width, width, dtype=torch.float32)
        for i in range(cfg.depth):
            setattr(self, f"joint_blocks_{i}", _JointBlock(
                width, cfg.n_heads, cfg.mlp_width, dt, cfg.qk_norm, i == cfg.depth - 1,
                i < cfg.dual_attn_blocks))
        self.final_layer_adaLN_mod_lin = Dense(width, 2 * width, dtype=torch.float32)
        self.final_layer_linear = Dense(width, cfg.in_channels * p * p, dtype=torch.float32)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                y: torch.Tensor | None = None, control: torch.Tensor | None = None,
                guidance: torch.Tensor | None = None, ref_latents: list | None = None,
                skip_layers: tuple = ()) -> torch.Tensor:
        """x [B, h, w, C] noisy latents, timesteps [B] flow time in [0, 1],
        context [B, T, context_dim], y [B, pooled_dim] pooled text (zeros
        where None) → the velocity [B, h, w, C] in f32. `guidance` is
        accepted and unused (SD3 is CFG-guided); a ControlNet residual
        or reference latents raise. The joint blocks in `skip_layers` are
        bypassed."""
        cfg = self.config
        del guidance
        if control is not None:
            raise ValueError("SD3-class MMDiT has no ControlNet input path")
        if ref_latents:
            raise ValueError("reference latents are a Flux-Kontext capability; SD3-class MMDiT "
                             "has no reference token path")
        b, hh, ww, c = x.shape
        p, m, dim = cfg.patch_size, cfg.pos_embed_max, cfg.width
        gh, gw = hh // p, ww // p
        if gh > m or gw > m:
            raise ValueError(f"a {gh}x{gw} patch grid exceeds the position table's {m}x{m}")
        img = self.x_embedder_proj(_patchify(x, p))
        top, left = (m - gh) // 2, (m - gw) // 2
        pos = self.pos_embed.view(m, m, dim)[top:top + gh, left:left + gw]
        img = img + pos.reshape(1, gh * gw, dim).to(img.dtype)
        ctx = self.context_embedder(context)

        vec = self.t_embedder_mlp_2(F.silu(self.t_embedder_mlp_0(
            timestep_embedding(timesteps.float() * 1000.0, cfg.freq_dim))))
        if y is None:
            y = torch.zeros((b, cfg.pooled_dim), dtype=torch.float32, device=x.device)
        vec = vec + self.y_embedder_mlp_2(F.silu(self.y_embedder_mlp_0(y.float())))

        for i in range(cfg.depth):
            if i in skip_layers:
                continue
            ctx_out, img = getattr(self, f"joint_blocks_{i}")(ctx, img, vec)
            if ctx_out is not None:
                ctx = ctx_out

        shift, scale = _modulation(self.final_layer_adaLN_mod_lin, vec, 2)
        out = self.final_layer_linear(_layer_norm(img) * (1 + scale) + shift)
        # the final linear's columns are (ph, pw, c), unlike Flux's (c, ph, pw)
        out = out.reshape(b, gh, gw, p, p, c).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(b, hh, ww, c)
