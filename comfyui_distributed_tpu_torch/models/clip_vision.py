"""CLIP ViT image encoder (WAN i2v's image conditioning), in PyTorch.

Counterpart of comfyui_distributed_tpu/models/clip_vision.py: ViT-H/14
at 224 px (32 layers, width 1280, 16 heads of D=80), HF
CLIPVisionModel layout-faithful (`sd_checkpoint.clip_vision_schedule`).
WAN conditions on the PENULTIMATE hidden states: 31 blocks run, no post
LN, 257 tokens (class token first). Submodules carry the flax names
(block_N.q, LayerNorm_0, pre_ln, ...); the norms run in f32 with the
flax default epsilon 1e-6, the linears and attention in bf16, the
attention through ops/attention.py::dot_product_attention (the kernel's
D=80 instance on the card, one call a block).

Preprocessing is the JAX module's: a non-square or off-size image has
its SHORT side scaled to 224 by jax.image.resize's antialiased cubic
(ops/resize.py; F.interpolate computes another function), then a centre
crop, then the CLIP mean and std.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.resize import resize_image
from .layers import Dense

# CLIP preprocessing constants (OpenAI/open_clip convention)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    layers: int = 32
    heads: int = 16
    mlp_ratio: float = 4.0
    dtype: str = "bfloat16"
    # WAN consumes the penultimate hidden states (no last block, no post
    # LN); False returns the post-LN final hidden states
    penultimate_hidden: bool = True

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


class _Norm(nn.LayerNorm):
    """flax LayerNorm (eps 1e-6, scale and bias) in f32, returning `dtype`."""

    def __init__(self, width: int, dtype: torch.dtype):
        super().__init__(width, eps=1e-6)
        self.out_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(self.out_dtype)


class _ViTBlock(nn.Module):
    def __init__(self, width: int, heads: int, mlp_dim: int, dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.LayerNorm_0 = _Norm(width, dtype)
        self.q = Dense(width, width, dtype=dtype)
        self.k = Dense(width, width, dtype=dtype)
        self.v = Dense(width, width, dtype=dtype)
        self.proj = Dense(width, width, dtype=dtype)
        self.LayerNorm_1 = _Norm(width, dtype)
        self.fc1 = Dense(width, mlp_dim, dtype=dtype)
        self.fc2 = Dense(mlp_dim, width, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, width = x.shape
        h = self.LayerNorm_0(x)
        q, k, v = (lin(h).reshape(b, n, self.heads, -1) for lin in (self.q, self.k, self.v))
        x = x + self.proj(dot_product_attention(q, k, v).reshape(b, n, width))
        return x + self.fc2(F.gelu(self.fc1(self.LayerNorm_1(x))))


def preprocess(images: torch.Tensor, image_size: int) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1] → [B, image_size, image_size, 3] normalised:
    the short side scaled to `image_size` (antialiased cubic), centre
    crop, (x - mean) / std."""
    b, h, w, c = images.shape
    if (h, w) != (image_size, image_size):
        scale = image_size / min(h, w)
        nh, nw = max(image_size, round(h * scale)), max(image_size, round(w * scale))
        images = resize_image(images.float(), nh, nw, "bicubic")
        top, left = (nh - image_size) // 2, (nw - image_size) // 2
        images = images[:, top:top + image_size, left:left + image_size, :]
    mean = torch.tensor(CLIP_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(CLIP_STD, dtype=images.dtype, device=images.device)
    return (images - mean) / std


class ClipVisionEncoder(nn.Module):
    """[B, H, W, 3] image in [0, 1] → [B, tokens, width] hidden states
    (class token first) in the compute dtype."""

    def __init__(self, config: ClipVisionConfig):
        super().__init__()
        self.config = cfg = config
        dt = cfg.compute_dtype
        p = cfg.patch_size
        self.patch_embedding = nn.Conv2d(3, cfg.width, p, stride=p, bias=False, dtype=dt)
        self.class_embedding = nn.Parameter(torch.empty(cfg.width))
        self.position_embedding = nn.Parameter(torch.empty(cfg.tokens, cfg.width))
        self.pre_ln = _Norm(cfg.width, dt)
        mlp_dim = int(cfg.width * cfg.mlp_ratio)
        for i in range(cfg.layers - 1 if cfg.penultimate_hidden else cfg.layers):
            setattr(self, f"block_{i}", _ViTBlock(cfg.width, cfg.heads, mlp_dim, dt))
        if not cfg.penultimate_hidden:
            self.post_ln = _Norm(cfg.width, dt)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        dt = cfg.compute_dtype
        x = preprocess(images, cfg.image_size)
        b = x.shape[0]
        patches = self.patch_embedding(x.to(dt).permute(0, 3, 1, 2))
        patches = patches.flatten(2).transpose(1, 2)  # [B, (h w), width]
        cls = self.class_embedding.to(dt).expand(b, 1, cfg.width)
        tokens = torch.cat([cls, patches], dim=1) + self.position_embedding.to(dt)[None]
        tokens = self.pre_ln(tokens)
        for i in range(cfg.layers - 1 if cfg.penultimate_hidden else cfg.layers):
            tokens = getattr(self, f"block_{i}")(tokens)
        return tokens if cfg.penultimate_hidden else self.post_ln(tokens)


@dataclasses.dataclass
class ClipVisionBundle:
    """A standalone CLIP-vision tower (CLIPVisionLoader's output):
    `encode(images)` → the hidden-state tokens [B, T, width] (class token
    first; the penultimate layer's for the WAN configs)."""

    name: str
    module: ClipVisionEncoder
    device: torch.device

    @torch.no_grad()
    def encode(self, images: torch.Tensor) -> torch.Tensor:
        return self.module(torch.as_tensor(images).to(self.device))


def build_clip_vision(name: str, device, generator: torch.Generator | None
                      ) -> ClipVisionEncoder:
    """A registry CLIP-vision tower on `device`: its weights from
    CDT_CHECKPOINT_DIR/<name>.* where that resolves, else drawn from
    `generator`. The one build path of CLIPVisionLoader and the i2v
    bundle (models/video_pipeline.py), as in the JAX package."""
    from . import sd_checkpoint as sdc
    from .pipeline import _build, _loading
    from .registry import get_config

    path = sdc.find_checkpoint(name)
    module = _build(name, torch.device(device), None if path else generator)
    if path:
        with _loading(path, name), sdc.open_checkpoint(path) as state_dict:
            sdc.load_clip_vision_weights(state_dict, get_config(name), module)
    return module


def load_clip_vision(name: str = "clip-vision-h", seed: int = 0, device="cuda") -> ClipVisionBundle:
    """The standalone tower of CLIPVisionLoader, seeded from `seed` where
    no checkpoint resolves."""
    from .pipeline import _seed_generators

    device = torch.device(device)
    module = build_clip_vision(name, device, _seed_generators(seed, device)(5))
    return ClipVisionBundle(name=name, module=module, device=device)
