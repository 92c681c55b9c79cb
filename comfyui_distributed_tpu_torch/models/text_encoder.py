"""CLIP-class causal text transformer and its tokenizer, in PyTorch.

Counterpart of comfyui_distributed_tpu/models/text_encoder.py: token +
position embeddings, pre-LN causal blocks, a final LayerNorm, pooled
output at the first EOS token (projected for OpenCLIP towers). The
causal attention stays plain PyTorch, as the JAX package computes it
outside its Pallas kernel: at T=77 it is a small explicit product.

Clip-skip: each tower has a configured default (the penultimate block
for SDXL's and SD2's encoders, the full stack for CLIP-L), and `forward`
takes the CLIPSetLastLayer override, `skip_last`, with the JAX package's
semantics. SD2's OpenCLIP-H applies the final LayerNorm to its
penultimate context (`final_ln_on_hidden`); SDXL's encoders do not.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, LayerNorm32


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    vocab_size: int = 49408
    max_length: int = 77
    width: int = 768
    layers: int = 12
    heads: int = 12
    dtype: str = "bfloat16"
    # "quick_gelu" = OpenAI CLIP-L; "gelu" = OpenCLIP bigG (SDXL)
    activation: str = "quick_gelu"
    # SDXL's encoders expose the PENULTIMATE block's hidden states as the
    # context; pooled always comes from the full stack
    penultimate_hidden: bool = False
    # SD2 (OpenCLIP-H) applies the final LayerNorm to the penultimate
    # hidden state it hands out as context; SDXL's encoders do not.
    # Ignored unless penultimate_hidden
    final_ln_on_hidden: bool = False
    # token id padding after EOS; None = pad with EOS (CLIP-L), OpenCLIP
    # towers pad with 0
    pad_token_id: Optional[int] = None
    # OpenCLIP text_projection: pooled = eos_state @ W [width, proj_dim]
    proj_dim: Optional[int] = None

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class Tokenizer:
    """CLIP BPE with BOS/EOS and fixed-length padded output:
    `<bos> tokens[:max-2] <eos>` then padding with `pad_id` (None = EOS)."""

    def __init__(self, max_length: int = 77, pad_id: Optional[int] = None):
        from .clip_bpe import get_bpe

        self.max_length = max_length
        self.bpe = get_bpe()
        self.bos_id = self.bpe.bos_id
        self.eos_id = self.bpe.eos_id
        self.pad_id = self.eos_id if pad_id is None else pad_id

    def encode(self, text: str) -> np.ndarray:
        body = self.bpe.encode_text(text)[: self.max_length - 2]
        ids = [self.bos_id] + body + [self.eos_id]
        out = np.full((self.max_length,), self.pad_id, dtype=np.int32)
        out[: len(ids)] = ids
        return out

    def encode_batch(self, texts: list[str]) -> np.ndarray:
        return np.stack([self.encode(t) for t in texts], axis=0)


class _CausalBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype: torch.dtype, activation: str):
        super().__init__()
        self.heads = heads
        self.activation = activation
        self.LayerNorm_0 = LayerNorm32(width, dtype)
        self.q = Dense(width, width, dtype=dtype)
        self.k = Dense(width, width, dtype=dtype)
        self.v = Dense(width, width, dtype=dtype)
        self.proj = Dense(width, width, dtype=dtype)
        self.LayerNorm_1 = LayerNorm32(width, dtype)
        self.fc1 = Dense(width, width * 4, dtype=dtype)
        self.fc2 = Dense(width * 4, width, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, n, width = x.shape
        hd = width // self.heads
        h = self.LayerNorm_0(x)
        q = self.q(h).view(b, n, self.heads, hd)
        k = self.k(h).view(b, n, self.heads, hd)
        v = self.v(h).view(b, n, self.heads, hd)
        scores = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) / np.sqrt(hd)
        scores = scores.masked_fill(~mask, -1e9)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", probs, v).reshape(b, n, width)
        x = x + self.proj(out)

        h = self.fc1(self.LayerNorm_1(x))
        if self.activation == "quick_gelu":
            h = h * torch.sigmoid(1.702 * h)
        else:
            h = F.gelu(h)
        return x + self.fc2(h)


class TextEncoder(nn.Module):
    def __init__(self, config: TextEncoderConfig):
        super().__init__()
        self.config = cfg = config
        dt = cfg.compute_dtype
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.position_embedding = nn.Parameter(torch.empty(cfg.max_length, cfg.width))
        for i in range(cfg.layers):
            self.add_module(f"block_{i}", _CausalBlock(cfg.width, cfg.heads, dt, cfg.activation))
        self.final_ln = nn.LayerNorm(cfg.width, eps=1e-5)
        if cfg.proj_dim is not None:
            self.text_projection = nn.Parameter(torch.empty(cfg.width, cfg.proj_dim))

    def forward(self, tokens: torch.Tensor, eos_id: int,
                skip_last: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
        """[B, T] token ids → (hidden [B, T, width], pooled [B, width or
        proj_dim]), both f32. `eos_id` marks the pooled position (its
        first occurrence).

        `skip_last` (clip-skip) is how many final blocks the hidden
        output leaves out: None = the configured default (1 for a
        penultimate tower, else 0), 0 = the full stack. The pooled
        vector always comes from the full stack. A tower that natively
        uses the full stack applies the final LayerNorm to the
        intermediate state; a penultimate tower keeps its
        `final_ln_on_hidden`. A skip deeper than the tower falls back to
        the last layer after the final LayerNorm."""
        cfg = self.config
        b, t = tokens.shape
        default_skip = 1 if cfg.penultimate_hidden else 0
        skip = default_skip if skip_last is None else max(int(skip_last), 0)
        force_post_ln = skip >= cfg.layers
        if force_post_ln:
            skip = 0
        x = (self.token_embedding(tokens) + self.position_embedding[None, :t]).to(cfg.compute_dtype)
        causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=tokens.device))
        intermediate = None
        for i in range(cfg.layers):
            if skip and i == cfg.layers - skip:
                intermediate = x
            x = getattr(self, f"block_{i}")(x, causal)
        pre_ln = x.float()
        x = self.final_ln(pre_ln)
        eos_pos = torch.argmax((tokens == eos_id).to(torch.int32), dim=1)
        pooled = x[torch.arange(b, device=tokens.device), eos_pos]
        if cfg.proj_dim is not None:
            pooled = pooled @ self.text_projection
        apply_ln = cfg.final_ln_on_hidden if cfg.penultimate_hidden else True
        if skip:
            hidden = intermediate.float()
            return (self.final_ln(hidden) if apply_ln else hidden), pooled
        return (x if apply_ln or force_post_ln else pre_ln), pooled
