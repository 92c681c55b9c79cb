"""T5-class text encoder (the Flux text encoder), in PyTorch.

Counterpart of comfyui_distributed_tpu/models/t5_encoder.py: relative-
position-bias attention (one table shared across the stack for classic
T5 v1.1, `per_layer_rel_bias=False`; one a layer for UMT5), RMS
pre-norms, gated-GELU feed-forward, no biases, and T5's unscaled
attention logits. The attention stays plain PyTorch (f32 scores plus the
bias, masked keys at -1e9), as the JAX package computes it in `jnp`
outside its Pallas kernel. Real `encoder.block.N.*` state dicts load
through models/sd_checkpoint.py::t5_encoder_schedule.

Tokenization: T5 uses a SentencePiece vocab, a separate asset the port
does not read (no `transformers`, no `sentencepiece`). Prompts tokenize
with the committed CLIP BPE ids, folded into the encoder's vocab, as the
JAX package does without `CDT_T5_SPM`: deterministic on every host,
meaningful with random-init weights only. With `CDT_T5_SPM` set the
tokenizer raises rather than silently using BPE ids.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, RMSNorm


@dataclasses.dataclass(frozen=True)
class T5EncoderConfig:
    vocab_size: int = 256384  # umt5 sentencepiece vocab
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    layers: int = 24
    heads: int = 64
    rel_buckets: int = 32
    rel_max_distance: int = 128
    max_length: int = 512
    pad_id: int = 0
    # UMT5 gives every layer its own relative-position bias table; classic
    # T5 v1.1 (the Flux text encoder) shares layer 0's across the stack
    per_layer_rel_bias: bool = True
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def relative_position_buckets(length: int, num_buckets: int = 32,
                              max_distance: int = 128) -> np.ndarray:
    """[L, L] int32 bidirectional T5 bucket table (query rows, key
    columns)."""
    ctx = np.arange(length)[:, None]
    mem = np.arange(length)[None, :]
    rel = mem - ctx  # key position - query position
    half = num_buckets // 2
    out = np.where(rel > 0, half, 0).astype(np.int64)
    rp = np.abs(rel)
    max_exact = half // 2
    is_small = rp < max_exact
    # log-spaced buckets out to max_distance
    with np.errstate(divide="ignore"):
        large = max_exact + (
            np.log(np.maximum(rp, 1) / max_exact) / np.log(max_distance / max_exact)
            * (half - max_exact)
        ).astype(np.int64)
    large = np.minimum(large, half - 1)
    out += np.where(is_small, rp, large)
    return out.astype(np.int32)


class _T5Block(nn.Module):
    def __init__(self, cfg: T5EncoderConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        inner = cfg.heads * cfg.d_kv
        self.attn_norm = RMSNorm(cfg.d_model)
        self.q = Dense(cfg.d_model, inner, bias=False, dtype=dt)
        self.k = Dense(cfg.d_model, inner, bias=False, dtype=dt)
        self.v = Dense(cfg.d_model, inner, bias=False, dtype=dt)
        self.o = Dense(inner, cfg.d_model, bias=False, dtype=dt)
        if cfg.per_layer_rel_bias:
            self.rel_bias = nn.Embedding(cfg.rel_buckets, cfg.heads, dtype=torch.float32)
        self.ffn_norm = RMSNorm(cfg.d_model)
        self.wi_0 = Dense(cfg.d_model, cfg.d_ff, bias=False, dtype=dt)
        self.wi_1 = Dense(cfg.d_model, cfg.d_ff, bias=False, dtype=dt)
        self.wo = Dense(cfg.d_ff, cfg.d_model, bias=False, dtype=dt)

    def forward(self, x, buckets, key_mask, shared_bias=None):
        cfg = self.cfg
        dt = cfg.compute_dtype
        b, n, _ = x.shape
        h = self.attn_norm(x).to(dt)
        q = self.q(h).view(b, n, cfg.heads, cfg.d_kv)
        k = self.k(h).view(b, n, cfg.heads, cfg.d_kv)
        v = self.v(h).view(b, n, cfg.heads, cfg.d_kv)
        rel_bias = shared_bias if shared_bias is not None else self.rel_bias(buckets)  # [N, N, H]
        # T5: no 1/sqrt(d) scaling (folded into the init)
        scores = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
        scores = scores + rel_bias.permute(2, 0, 1)[None]
        scores = scores.masked_fill(~key_mask[:, None, None, :], -1e9)
        probs = torch.softmax(scores, dim=-1)
        attn = torch.einsum("bhnm,bmhd->bnhd", probs, v.float())
        x = x + self.o(attn.reshape(b, n, -1).to(dt))
        h = self.ffn_norm(x).to(dt)
        gate = F.gelu(self.wi_0(h), approximate="tanh")
        return x + self.wo(gate * self.wi_1(h))


class T5Encoder(nn.Module):
    """tokens [B, N] → (hidden [B, N, d_model] f32 after the final RMS
    norm, pooled [B, d_model]: the mask-weighted mean)."""

    def __init__(self, config: T5EncoderConfig):
        super().__init__()
        self.config = cfg = config
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.d_model, dtype=cfg.compute_dtype)
        if not cfg.per_layer_rel_bias:
            self.rel_bias = nn.Embedding(cfg.rel_buckets, cfg.heads, dtype=torch.float32)
        for i in range(cfg.layers):
            setattr(self, f"block_{i}", _T5Block(cfg))
        self.final_norm = RMSNorm(cfg.d_model)

    def forward(self, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        n = tokens.shape[1]
        key_mask = tokens != cfg.pad_id
        x = self.token_embed(tokens)
        buckets = torch.from_numpy(
            relative_position_buckets(n, cfg.rel_buckets, cfg.rel_max_distance).astype(np.int64)
        ).to(tokens.device)
        shared_bias = None if cfg.per_layer_rel_bias else self.rel_bias(buckets)
        for i in range(cfg.layers):
            x = getattr(self, f"block_{i}")(x, buckets, key_mask, shared_bias)
        hidden = self.final_norm(x)
        denom = torch.clamp(key_mask.sum(dim=1, keepdim=True), min=1)
        pooled = (hidden * key_mask[:, :, None]).sum(dim=1) / denom
        return hidden, pooled


# the environment variable naming a SentencePiece model (JAX package)
SPM_ENV = "CDT_T5_SPM"


class T5Tokenizer:
    """Fixed-length, 0-padded (T5's pad id) ids: the committed CLIP BPE
    of the prompt (at most max_length - 1 ids), then T5's closing </s>
    (id 1), ids past the encoder's vocab folded into [2, vocab_size)."""

    EOS = 1
    # the CLIP BPE emits ids in [0, 49408), past the real T5 vocab (32128)
    BPE_ID_SPACE = 49408

    def __init__(self, max_length: int = 512, spm_path: Optional[str] = None,
                 vocab_size: Optional[int] = None):
        path = spm_path or os.environ.get(SPM_ENV)
        if path:
            raise NotImplementedError(
                f"{SPM_ENV} / spm_path names a SentencePiece model ({path!r}), which the "
                "PyTorch package does not read (no transformers or sentencepiece on its "
                "machines); unset it to tokenize with the CLIP BPE ids, as the JAX package "
                "does without it")
        self.max_length = max_length
        self.vocab_size = vocab_size
        self._warned_overflow = False

    def encode(self, text: str) -> np.ndarray:
        from .clip_bpe import get_bpe

        out = np.zeros((self.max_length,), dtype=np.int32)
        body = get_bpe(None).encode_text(text)[: self.max_length - 1]
        ids = self._fold_into_vocab(body + [self.EOS])
        out[: len(ids)] = ids
        return out

    def _fold_into_vocab(self, ids: list[int]) -> list[int]:
        """Ids past the embedding table remapped into [2, vocab_size)
        (pad 0 and eos 1 kept), with one warning."""
        vs = self.vocab_size
        if vs is None or vs >= self.BPE_ID_SPACE:
            return ids
        if not self._warned_overflow and any(i >= vs for i in ids):
            logging.getLogger("cdt.t5_encoder").warning(
                "T5 tokenizer emits CLIP-BPE ids up to %d but this encoder's vocab_size is %d; "
                "out-of-range ids are folded into the valid range. Conditioning is not "
                "faithful to real checkpoints.", self.BPE_ID_SPACE - 1, vs)
            self._warned_overflow = True
        span = max(vs - 2, 1)
        return [i if i < vs else 2 + (i - 2) % span for i in ids]

    def encode_batch(self, texts: list[str]) -> np.ndarray:
        return np.stack([self.encode(t) for t in texts], axis=0)
