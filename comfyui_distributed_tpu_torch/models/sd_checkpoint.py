"""Single-file SD checkpoints: the key schedules, the file reader and
writer, and the loaders that fill the port's modules.

The port's own copy of the SD-, Flux- and SD3-family parts of
comfyui_distributed_tpu/models/sd_checkpoint.py. A single-file SD1.x,
SD2.x or SDXL checkpoint (`model.diffusion_model.*`, `first_stage_model.*`,
and the text towers under `cond_stage_model.*` or `conditioner.embedders.*`)
loads into the UNet, VAE and text encoders of models/. Flux ships as
separate files: the transformer (`double_blocks.*`, bare or under
`model.diffusion_model.`), the AE (bare `encoder.*` or under
`first_stage_model.`), T5-XXL (`encoder.block.*`, HF layout) and CLIP-L;
`load_flux_weights` fills whichever parts a file carries. An SD3 or
SD3.5 file (`joint_blocks.*`, bare or under `model.diffusion_model.`;
the `*_incl_clips*` single files add `first_stage_model.*` and
`text_encoders.{clip_l,clip_g,t5xxl}.transformer.*`) fills its parts
through `load_sd3_weights`. The WAN stack ships as separate files: the
video DiT (`blocks.N.*`, bare or under `model.diffusion_model.`;
`load_wan_weights`), the Wan2.1 VAE (`encoder.downsamples.N.*`,
`decoder.upsamples.N.*`; `load_wan_vae_weights`) and the CLIP-vision
tower of i2v (HF CLIPVisionModel, `vision_model.*`;
`load_clip_vision_weights`).

Each architecture has an enumerable key schedule, config →
[(sd key prefix, module parameter prefix, kind)], so the mapping is
testable without any checkpoint: tests invert it to write one. An
entry's module path is the JAX package's flax path under models/io.py's
naming rule, and the port keeps torch's layouts, so nearly every tensor
loads as it is stored:

    norm, conv, linear, linear_nobias, embedding, position, param_bare
                  weight (and bias) as stored
    proj          a 1x1 conv [O, I, 1, 1] (SD1.x transformers, the VAE's
                  mid attention) or a linear [O, I] → the Dense [O, I]
    bare_linear_w an nn.Linear text projection [P, W] → the bare
                  [W, P] parameter the encoder uses as x @ proj
    fused_qkv     OpenCLIP's in_proj [3W, W] / [3W] → q, k, v rows
    rms           an RMS norm's `.weight` (T5's layer norms)
    rms_scale     an RMS norm stored as `.scale` (Flux's q/k norms)
    conv2d:p:c    SD3's stride-p patch conv [O, c, p, p] → the Dense
                  [O, c p p] over (c, ph, pw)-flattened patches
    conv3d:pf:ph:pw:c  WAN's patch conv [O, c, pf, ph, pw] → the Dense
                  [O, pf ph pw c] over (pf, ph, pw, c)-flattened patches
    causal3       a Conv3d [O, I, kt, kh, kw], weight and bias as stored
    gamma3, gamma2  the Wan VAE's RMS gamma [C, 1, 1(, 1)] → [C]
    conv_nobias   a conv weight alone, as stored

Loading is strict on the module's side: a parameter no key fills, or a
shape that differs, raises. Keys the schedule does not name
(`model_ema.*`, `position_ids`, `alphas_cumprod`, ...) are ignored.

The reader needs no `safetensors` package: the format is an 8-byte
little-endian header length, a JSON header (dtype, shape, data_offsets,
an optional __metadata__), then raw bytes. Tensors are read through
mmap one at a time and cast straight into the module's parameter on its
device, so no f32 copy of the whole file is made (SDXL in f16 is
6.9 GB). Torch `.ckpt` files go through `torch.load(weights_only=True)`.
A GGUF file (models/gguf.py) is dequantized on the host to f32 whole,
then cast into the modules like any other.
"""

from __future__ import annotations

import contextlib
import json
import math
import mmap
import os
import struct
from collections.abc import Mapping
from typing import Iterable, Iterator

import torch
from torch import nn

# (sd key prefix, module parameter prefix, kind); each entry expands to
# its weight (and bias, where the kind has one)
Entry = tuple[str, str, str]

_NORM = "norm"
_CONV = "conv"
_LINEAR = "linear"
_LINEAR_NOBIAS = "linear_nobias"
_PROJ = "proj"


# --- key schedules --------------------------------------------------------

def _resblock(sd: str, pt: str, has_skip: bool) -> list[Entry]:
    entries = [
        (f"{sd}.in_layers.0", f"{pt}.norm1.GroupNorm_0", _NORM),
        (f"{sd}.in_layers.2", f"{pt}.conv1", _CONV),
        (f"{sd}.emb_layers.1", f"{pt}.emb_proj", _LINEAR),
        (f"{sd}.out_layers.0", f"{pt}.norm2.GroupNorm_0", _NORM),
        (f"{sd}.out_layers.3", f"{pt}.conv2", _CONV),
    ]
    if has_skip:
        entries.append((f"{sd}.skip_connection", f"{pt}.skip", _CONV))
    return entries


def _spatial_transformer(sd: str, pt: str, depth: int) -> list[Entry]:
    entries = [
        (f"{sd}.norm", f"{pt}.norm.GroupNorm_0", _NORM),
        (f"{sd}.proj_in", f"{pt}.proj_in", _PROJ),
    ]
    for i in range(depth):
        tb, pb = f"{sd}.transformer_blocks.{i}", f"{pt}.block_{i}"
        entries += [
            (f"{tb}.norm1", f"{pb}.LayerNorm_0", _NORM),
            (f"{tb}.attn1.to_q", f"{pb}.attn1.to_q", _LINEAR_NOBIAS),
            (f"{tb}.attn1.to_k", f"{pb}.attn1.to_k", _LINEAR_NOBIAS),
            (f"{tb}.attn1.to_v", f"{pb}.attn1.to_v", _LINEAR_NOBIAS),
            (f"{tb}.attn1.to_out.0", f"{pb}.attn1.to_out", _LINEAR),
            (f"{tb}.norm2", f"{pb}.LayerNorm_1", _NORM),
            (f"{tb}.attn2.to_q", f"{pb}.attn2.to_q", _LINEAR_NOBIAS),
            (f"{tb}.attn2.to_k", f"{pb}.attn2.to_k", _LINEAR_NOBIAS),
            (f"{tb}.attn2.to_v", f"{pb}.attn2.to_v", _LINEAR_NOBIAS),
            (f"{tb}.attn2.to_out.0", f"{pb}.attn2.to_out", _LINEAR),
            (f"{tb}.norm3", f"{pb}.LayerNorm_2", _NORM),
            (f"{tb}.ff.net.0.proj", f"{pb}.ff.GEGLU_0.Dense_0", _LINEAR),
            (f"{tb}.ff.net.2", f"{pb}.ff.Dense_0", _LINEAR),
        ]
    entries.append((f"{sd}.proj_out", f"{pt}.proj_out", _PROJ))
    return entries


def unet_schedule(cfg) -> list[Entry]:
    """SD UNet (`model.diffusion_model.*`, the input/middle/output_blocks
    numbering of every SD1.x, SD2.x and SDXL checkpoint) → UNet."""
    p = "model.diffusion_model"
    ch = cfg.model_channels
    entries: list[Entry] = [
        (f"{p}.time_embed.0", "time_embed_0", _LINEAR),
        (f"{p}.time_embed.2", "time_embed_2", _LINEAR),
    ]
    if cfg.adm_in_channels:
        entries += [
            (f"{p}.label_emb.0.0", "label_embed_0", _LINEAR),
            (f"{p}.label_emb.0.2", "label_embed_2", _LINEAR),
        ]
    entries.append((f"{p}.input_blocks.0.0", "input_conv", _CONV))

    # down path
    n = 1
    in_ch = ch
    for level, mult in enumerate(cfg.channel_mult):
        out_ch = ch * mult
        for i in range(cfg.num_res_blocks):
            entries += _resblock(f"{p}.input_blocks.{n}.0", f"down_{level}_res_{i}",
                                 in_ch != out_ch)
            if cfg.transformer_depth[level] > 0:
                entries += _spatial_transformer(f"{p}.input_blocks.{n}.1",
                                                f"down_{level}_attn_{i}",
                                                cfg.transformer_depth[level])
            in_ch = out_ch
            n += 1
        if level != len(cfg.channel_mult) - 1:
            entries.append((f"{p}.input_blocks.{n}.0.op", f"down_{level}_ds.op", _CONV))
            n += 1

    # middle
    mid_depth = max(cfg.transformer_depth[-1], 1)
    entries += _resblock(f"{p}.middle_block.0", "mid_res_0", False)
    entries += _spatial_transformer(f"{p}.middle_block.1", "mid_attn", mid_depth)
    entries += _resblock(f"{p}.middle_block.2", "mid_res_1", False)

    # up path: the skip concat gives every ResBlock a skip_connection
    # except where concat(in) + skip == out
    n = 0
    skip_chs = [ch]
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            skip_chs.append(ch * mult)
        if level != len(cfg.channel_mult) - 1:
            skip_chs.append(ch * mult)
    h_ch = ch * cfg.channel_mult[-1]
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        out_ch = ch * mult
        for i in range(cfg.num_res_blocks + 1):
            concat_ch = h_ch + skip_chs.pop()
            entries += _resblock(f"{p}.output_blocks.{n}.0", f"up_{level}_res_{i}",
                                 concat_ch != out_ch)
            has_attn = cfg.transformer_depth[level] > 0
            if has_attn:
                entries += _spatial_transformer(f"{p}.output_blocks.{n}.1",
                                                f"up_{level}_attn_{i}",
                                                cfg.transformer_depth[level])
            if level != 0 and i == cfg.num_res_blocks:
                idx = 2 if has_attn else 1
                entries.append((f"{p}.output_blocks.{n}.{idx}.conv", f"up_{level}_us.conv",
                                _CONV))
            h_ch = out_ch
            n += 1

    entries += [
        (f"{p}.out.0", "out_norm.GroupNorm_0", _NORM),
        (f"{p}.out.2", "out_conv", _CONV),
    ]
    return entries


def _vae_resblock(sd: str, pt: str, has_skip: bool) -> list[Entry]:
    entries = [
        (f"{sd}.norm1", f"{pt}.norm1.GroupNorm_0", _NORM),
        (f"{sd}.conv1", f"{pt}.conv1", _CONV),
        (f"{sd}.norm2", f"{pt}.norm2.GroupNorm_0", _NORM),
        (f"{sd}.conv2", f"{pt}.conv2", _CONV),
    ]
    if has_skip:
        entries.append((f"{sd}.nin_shortcut", f"{pt}.skip", _CONV))
    return entries


def _vae_mid(sd: str, pt: str) -> list[Entry]:
    return (
        _vae_resblock(f"{sd}.block_1", f"{pt}.mid_res_0", False)
        + [
            (f"{sd}.attn_1.norm", f"{pt}.mid_attn.norm.GroupNorm_0", _NORM),
            (f"{sd}.attn_1.q", f"{pt}.mid_attn.q", _PROJ),
            (f"{sd}.attn_1.k", f"{pt}.mid_attn.k", _PROJ),
            (f"{sd}.attn_1.v", f"{pt}.mid_attn.v", _PROJ),
            (f"{sd}.attn_1.proj_out", f"{pt}.mid_attn.proj", _PROJ),
        ]
        + _vae_resblock(f"{sd}.block_2", f"{pt}.mid_res_1", False)
    )


def vae_schedule(cfg, prefix: str = "first_stage_model") -> list[Entry]:
    """SD AutoencoderKL (`first_stage_model.*`; `prefix=""` for a
    standalone file's bare `encoder.*` / `decoder.*` keys) → VAE."""
    p = f"{prefix}." if prefix else ""
    bc = cfg.base_channels
    entries: list[Entry] = [(f"{p}encoder.conv_in", "encoder.conv_in", _CONV)]
    in_ch = bc
    for level, mult in enumerate(cfg.channel_mult):
        out_ch = bc * mult
        for i in range(cfg.num_res_blocks):
            entries += _vae_resblock(f"{p}encoder.down.{level}.block.{i}",
                                     f"encoder.down_{level}_res_{i}", in_ch != out_ch)
            in_ch = out_ch
        if level != len(cfg.channel_mult) - 1:
            entries.append((f"{p}encoder.down.{level}.downsample.conv",
                            f"encoder.down_{level}_ds", _CONV))
    entries += _vae_mid(f"{p}encoder.mid", "encoder")
    entries += [
        (f"{p}encoder.norm_out", "encoder.norm_out.GroupNorm_0", _NORM),
        (f"{p}encoder.conv_out", "encoder.conv_out", _CONV),
    ]
    if getattr(cfg, "use_quant_conv", True):
        entries += [
            (f"{p}quant_conv", "quant_conv", _CONV),
            (f"{p}post_quant_conv", "post_quant_conv", _CONV),
        ]
    entries.append((f"{p}decoder.conv_in", "decoder.conv_in", _CONV))
    entries += _vae_mid(f"{p}decoder.mid", "decoder")
    in_ch = bc * cfg.channel_mult[-1]
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        out_ch = bc * mult
        for i in range(cfg.num_res_blocks + 1):
            entries += _vae_resblock(f"{p}decoder.up.{level}.block.{i}",
                                     f"decoder.up_{level}_res_{i}", in_ch != out_ch)
            in_ch = out_ch
        if level != 0:
            entries.append((f"{p}decoder.up.{level}.upsample.conv",
                            f"decoder.up_{level}_us", _CONV))
    entries += [
        (f"{p}decoder.norm_out", "decoder.norm_out.GroupNorm_0", _NORM),
        (f"{p}decoder.conv_out", "decoder.conv_out", _CONV),
    ]
    return entries


def text_encoder_schedule(cfg, prefix: str = "cond_stage_model.transformer.text_model",
                          projection_layout: str = "bare") -> list[Entry]:
    """HF-layout CLIP text transformer → TextEncoder. `prefix` is
    `cond_stage_model.transformer.text_model` in SD1.x files and
    `conditioner.embedders.0.transformer.text_model` for SDXL's CLIP-L;
    `projection_layout="linear"` reads text_projection as a sibling
    nn.Linear (HF CLIPTextModelWithProjection) instead of a bare
    parameter."""
    p = prefix
    entries: list[Entry] = [
        (f"{p}.embeddings.token_embedding", "token_embedding", "embedding"),
        (f"{p}.embeddings.position_embedding", "position_embedding", "position"),
    ]
    for i in range(cfg.layers):
        sd, pt = f"{p}.encoder.layers.{i}", f"block_{i}"
        entries += [
            (f"{sd}.layer_norm1", f"{pt}.LayerNorm_0", _NORM),
            (f"{sd}.self_attn.q_proj", f"{pt}.q", _LINEAR),
            (f"{sd}.self_attn.k_proj", f"{pt}.k", _LINEAR),
            (f"{sd}.self_attn.v_proj", f"{pt}.v", _LINEAR),
            (f"{sd}.self_attn.out_proj", f"{pt}.proj", _LINEAR),
            (f"{sd}.layer_norm2", f"{pt}.LayerNorm_1", _NORM),
            (f"{sd}.mlp.fc1", f"{pt}.fc1", _LINEAR),
            (f"{sd}.mlp.fc2", f"{pt}.fc2", _LINEAR),
        ]
    entries.append((f"{p}.final_layer_norm", "final_ln", _NORM))
    if cfg.proj_dim is not None:
        if projection_layout == "linear":
            # a SIBLING of text_model (at the root for bare text_model.* keys)
            if p.endswith(".text_model"):
                base = p[: -len(".text_model")]
            elif p == "text_model":
                base = ""
            else:
                base = p
            key = f"{base}.text_projection" if base else "text_projection"
            entries.append((key, "text_projection", "bare_linear_w"))
        else:
            entries.append((f"{p}.text_projection", "text_projection", "param_bare"))
    return entries


def open_clip_schedule(cfg, prefix: str = "conditioner.embedders.1.model") -> list[Entry]:
    """OpenCLIP-layout text transformer (SDXL's bigG half; SD2.x's tower
    under `cond_stage_model.model`) → TextEncoder: bare positional
    embedding and text_projection, fused qkv in_proj, resblock naming."""
    p = prefix
    entries: list[Entry] = [
        (f"{p}.token_embedding", "token_embedding", "embedding"),
        (f"{p}.positional_embedding", "position_embedding", "param_bare"),
    ]
    for i in range(cfg.layers):
        sd, pt = f"{p}.transformer.resblocks.{i}", f"block_{i}"
        entries += [
            (f"{sd}.ln_1", f"{pt}.LayerNorm_0", _NORM),
            (f"{sd}.attn.in_proj", pt, "fused_qkv"),
            (f"{sd}.attn.out_proj", f"{pt}.proj", _LINEAR),
            (f"{sd}.ln_2", f"{pt}.LayerNorm_1", _NORM),
            (f"{sd}.mlp.c_fc", f"{pt}.fc1", _LINEAR),
            (f"{sd}.mlp.c_proj", f"{pt}.fc2", _LINEAR),
        ]
    entries.append((f"{p}.ln_final", "final_ln", _NORM))
    if cfg.proj_dim is not None:
        entries.append((f"{p}.text_projection", "text_projection", "param_bare"))
    return entries


def t5_encoder_schedule(cfg, prefix: str = "") -> list[Entry]:
    """T5 encoder state dict (HF layout: `shared`, `encoder.block.N.
    layer.{0,1}.*`, the relative_attention_bias of block 0 shared by the
    stack for T5 v1.1, one a block for UMT5) → T5Encoder."""
    p = prefix
    per_layer_bias = getattr(cfg, "per_layer_rel_bias", True)
    entries: list[Entry] = [(f"{p}shared", "token_embed", "embedding")]
    if not per_layer_bias:
        entries.append((f"{p}encoder.block.0.layer.0.SelfAttention.relative_attention_bias",
                        "rel_bias", "embedding"))
    for i in range(cfg.layers):
        sd, pt = f"{p}encoder.block.{i}", f"block_{i}"
        entries += [
            (f"{sd}.layer.0.layer_norm", f"{pt}.attn_norm", "rms"),
            (f"{sd}.layer.0.SelfAttention.q", f"{pt}.q", _LINEAR_NOBIAS),
            (f"{sd}.layer.0.SelfAttention.k", f"{pt}.k", _LINEAR_NOBIAS),
            (f"{sd}.layer.0.SelfAttention.v", f"{pt}.v", _LINEAR_NOBIAS),
            (f"{sd}.layer.0.SelfAttention.o", f"{pt}.o", _LINEAR_NOBIAS),
        ]
        if per_layer_bias:
            entries.append((f"{sd}.layer.0.SelfAttention.relative_attention_bias",
                            f"{pt}.rel_bias", "embedding"))
        entries += [
            (f"{sd}.layer.1.layer_norm", f"{pt}.ffn_norm", "rms"),
            (f"{sd}.layer.1.DenseReluDense.wi_0", f"{pt}.wi_0", _LINEAR_NOBIAS),
            (f"{sd}.layer.1.DenseReluDense.wi_1", f"{pt}.wi_1", _LINEAR_NOBIAS),
            (f"{sd}.layer.1.DenseReluDense.wo", f"{pt}.wo", _LINEAR_NOBIAS),
        ]
    entries.append((f"{p}encoder.final_layer_norm", "final_norm", "rms"))
    return entries


def flux_schedule(cfg, prefix: str = "") -> list[Entry]:
    """Flux transformer state dict (`double_blocks.N.*`, `single_blocks.N.*`,
    `img_in`, `txt_in`, `time_in`, `vector_in`, `guidance_in`,
    `final_layer.*`) → MMDiT. `prefix` is `model.diffusion_model.` for a
    repacked single file; the published flux1-*.safetensors use bare
    keys."""
    p = prefix
    entries: list[Entry] = [
        (f"{p}img_in", "img_in", _LINEAR),
        (f"{p}txt_in", "txt_in", _LINEAR),
        (f"{p}time_in.in_layer", "time_in.in_layer", _LINEAR),
        (f"{p}time_in.out_layer", "time_in.out_layer", _LINEAR),
        (f"{p}vector_in.in_layer", "vector_in.in_layer", _LINEAR),
        (f"{p}vector_in.out_layer", "vector_in.out_layer", _LINEAR),
    ]
    if cfg.guidance_embed:
        entries += [
            (f"{p}guidance_in.in_layer", "guidance_in.in_layer", _LINEAR),
            (f"{p}guidance_in.out_layer", "guidance_in.out_layer", _LINEAR),
        ]
    for i in range(cfg.double_depth):
        sd, pt = f"{p}double_blocks.{i}", f"double_blocks_{i}"
        for s in ("img", "txt"):
            entries += [
                (f"{sd}.{s}_mod.lin", f"{pt}.{s}_mod_lin", _LINEAR),
                (f"{sd}.{s}_attn.qkv", f"{pt}.{s}_attn_qkv", _LINEAR),
                (f"{sd}.{s}_attn.norm.query_norm", f"{pt}.{s}_attn_norm_q", "rms_scale"),
                (f"{sd}.{s}_attn.norm.key_norm", f"{pt}.{s}_attn_norm_k", "rms_scale"),
                (f"{sd}.{s}_attn.proj", f"{pt}.{s}_attn_proj", _LINEAR),
                (f"{sd}.{s}_mlp.0", f"{pt}.{s}_mlp_0", _LINEAR),
                (f"{sd}.{s}_mlp.2", f"{pt}.{s}_mlp_2", _LINEAR),
            ]
    for i in range(cfg.single_depth):
        sd, pt = f"{p}single_blocks.{i}", f"single_blocks_{i}"
        entries += [
            (f"{sd}.modulation.lin", f"{pt}.modulation_lin", _LINEAR),
            (f"{sd}.linear1", f"{pt}.linear1", _LINEAR),
            (f"{sd}.linear2", f"{pt}.linear2", _LINEAR),
            (f"{sd}.norm.query_norm", f"{pt}.norm_q", "rms_scale"),
            (f"{sd}.norm.key_norm", f"{pt}.norm_k", "rms_scale"),
        ]
    entries += [
        (f"{p}final_layer.adaLN_modulation.1", "final_layer_adaLN_lin", _LINEAR),
        (f"{p}final_layer.linear", "final_layer_linear", _LINEAR),
    ]
    return entries


def sd3_schedule(cfg, prefix: str = "model.diffusion_model.") -> list[Entry]:
    """SD3/SD3.5 MMDiT state dict (`joint_blocks.N.{context_block,
    x_block}.*`, `x_embedder.proj`, `pos_embed`, `context_embedder`, the
    `t_embedder`/`y_embedder` MLPs, `final_layer.*`) → SD3MMDiT. The last
    block's context side is pre_only: qkv and a 2-way adaLN, no proj or
    MLP. SD3.5 configs add the per-head RMS ln_q/ln_k; MMDiT-X's first
    `dual_attn_blocks` x_blocks add attn2 (their adaLN linear is 9-way:
    the same key, a wider tensor). `prefix` is empty for a bare
    transformer file."""
    p = prefix
    entries: list[Entry] = [
        (f"{p}x_embedder.proj", "x_embedder_proj", f"conv2d:{cfg.patch_size}:{cfg.in_channels}"),
        (f"{p}pos_embed", "pos_embed", "param_bare"),
        (f"{p}context_embedder", "context_embedder", _LINEAR),
        (f"{p}t_embedder.mlp.0", "t_embedder_mlp_0", _LINEAR),
        (f"{p}t_embedder.mlp.2", "t_embedder_mlp_2", _LINEAR),
        (f"{p}y_embedder.mlp.0", "y_embedder_mlp_0", _LINEAR),
        (f"{p}y_embedder.mlp.2", "y_embedder_mlp_2", _LINEAR),
    ]
    for i in range(cfg.depth):
        sd, pt = f"{p}joint_blocks.{i}", f"joint_blocks_{i}"
        pre_only = i == cfg.depth - 1
        for block, s in (("context_block", "ctx"), ("x_block", "x")):
            entries.append((f"{sd}.{block}.attn.qkv", f"{pt}.{s}_attn_qkv", _LINEAR))
            if cfg.qk_norm:
                entries += [(f"{sd}.{block}.attn.ln_q", f"{pt}.{s}_attn_ln_q", "rms"),
                            (f"{sd}.{block}.attn.ln_k", f"{pt}.{s}_attn_ln_k", "rms")]
            entries.append((f"{sd}.{block}.adaLN_modulation.1", f"{pt}.{s}_mod_lin", _LINEAR))
            if s == "ctx" and pre_only:
                continue
            entries += [
                (f"{sd}.{block}.attn.proj", f"{pt}.{s}_attn_proj", _LINEAR),
                (f"{sd}.{block}.mlp.fc1", f"{pt}.{s}_mlp_fc1", _LINEAR),
                (f"{sd}.{block}.mlp.fc2", f"{pt}.{s}_mlp_fc2", _LINEAR),
            ]
            if s == "x" and i < cfg.dual_attn_blocks:
                entries += [(f"{sd}.x_block.attn2.qkv", f"{pt}.x2_attn_qkv", _LINEAR),
                            (f"{sd}.x_block.attn2.proj", f"{pt}.x2_attn_proj", _LINEAR)]
                if cfg.qk_norm:
                    entries += [(f"{sd}.x_block.attn2.ln_q", f"{pt}.x2_attn_ln_q", "rms"),
                                (f"{sd}.x_block.attn2.ln_k", f"{pt}.x2_attn_ln_k", "rms")]
    entries += [
        (f"{p}final_layer.adaLN_modulation.1", "final_layer_adaLN_mod_lin", _LINEAR),
        (f"{p}final_layer.linear", "final_layer_linear", _LINEAR),
    ]
    return entries


def wan_schedule(cfg, prefix: str = "") -> list[Entry]:
    """WAN 2.x video DiT state dict (`blocks.N.*`, `patch_embedding`,
    `time_embedding`, `time_projection`, `text_embedding`, `head.*`, and
    for i2v `img_emb.proj.*` and the blocks' `k_img`/`v_img`) → VideoDiT.
    `prefix` is `model.diffusion_model.` for a ComfyUI-repacked file."""
    p = prefix
    pf, ph, pw = cfg.patch_size
    entries: list[Entry] = [
        (f"{p}patch_embedding", "patch_embed", f"conv3d:{pf}:{ph}:{pw}:{cfg.in_channels}"),
        (f"{p}text_embedding.0", "text_embed_0", _LINEAR),
        (f"{p}text_embedding.2", "text_embed_2", _LINEAR),
        (f"{p}time_embedding.0", "time_embed_0", _LINEAR),
        (f"{p}time_embedding.2", "time_embed_2", _LINEAR),
        (f"{p}time_projection.1", "time_proj", _LINEAR),
    ]
    for i in range(cfg.depth):
        sd, pt = f"{p}blocks.{i}", f"block_{i}"
        for attn in ("self_attn", "cross_attn"):
            for leaf in ("q", "k", "v", "o"):
                entries.append((f"{sd}.{attn}.{leaf}", f"{pt}.{attn}_{leaf}", _LINEAR))
            for leaf in ("norm_q", "norm_k"):
                entries.append((f"{sd}.{attn}.{leaf}", f"{pt}.{attn}_{leaf}", "rms"))
        if cfg.i2v:
            entries += [
                (f"{sd}.cross_attn.k_img", f"{pt}.cross_attn_k_img", _LINEAR),
                (f"{sd}.cross_attn.v_img", f"{pt}.cross_attn_v_img", _LINEAR),
                (f"{sd}.cross_attn.norm_k_img", f"{pt}.cross_attn_norm_k_img", "rms"),
            ]
        entries += [
            (f"{sd}.norm3", f"{pt}.norm3", _NORM),
            (f"{sd}.ffn.0", f"{pt}.ffn_0", _LINEAR),
            (f"{sd}.ffn.2", f"{pt}.ffn_2", _LINEAR),
            (f"{sd}.modulation", f"{pt}.modulation", "param_bare"),
        ]
    if cfg.i2v:
        entries += [
            (f"{p}img_emb.proj.0", "img_emb_norm_in", _NORM),
            (f"{p}img_emb.proj.1", "img_emb_fc1", _LINEAR),
            (f"{p}img_emb.proj.3", "img_emb_fc2", _LINEAR),
            (f"{p}img_emb.proj.4", "img_emb_norm_out", _NORM),
        ]
    entries += [
        (f"{p}head.head", "head", _LINEAR),
        (f"{p}head.modulation", "head_modulation", "param_bare"),
    ]
    return entries


def _wan_vae_resblock(sd: str, pt: str, in_dim: int, out_dim: int) -> list[Entry]:
    entries = [
        (f"{sd}.residual.0", f"{pt}.residual_0", "gamma3"),
        (f"{sd}.residual.2", f"{pt}.residual_2.conv", "causal3"),
        (f"{sd}.residual.3", f"{pt}.residual_3", "gamma3"),
        (f"{sd}.residual.6", f"{pt}.residual_6.conv", "causal3"),
    ]
    if in_dim != out_dim:
        entries.append((f"{sd}.shortcut", f"{pt}.shortcut.conv", "causal3"))
    return entries


def _wan_vae_attn(sd: str, pt: str) -> list[Entry]:
    return [
        (f"{sd}.norm", f"{pt}.norm", "gamma2"),
        (f"{sd}.to_qkv", f"{pt}.to_qkv", _CONV),
        (f"{sd}.proj", f"{pt}.proj", _CONV),
    ]


def wan_vae_schedule(cfg) -> list[Entry]:
    """Official Wan2.1 VAE state dict → VideoVAE: `encoder.downsamples.N`
    and `decoder.upsamples.N` run over the residual blocks and resamples
    in construction order; the RMS gammas are bare `.gamma` tensors with
    trailing unit dims."""
    entries: list[Entry] = []
    enc_dims = [cfg.base_dim * m for m in (1,) + tuple(cfg.dim_mult)]
    entries.append(("encoder.conv1", "encoder.conv1.conv", "causal3"))
    idx, in_dim = 0, enc_dims[0]
    for level in range(len(cfg.dim_mult)):
        out_dim = enc_dims[level + 1]
        for _ in range(cfg.num_res_blocks):
            entries += _wan_vae_resblock(f"encoder.downsamples.{idx}", f"encoder.down_{idx}",
                                         in_dim, out_dim)
            in_dim = out_dim
            idx += 1
        if level != len(cfg.dim_mult) - 1:
            sd, pt = f"encoder.downsamples.{idx}", f"encoder.down_{idx}"
            entries.append((f"{sd}.resample.1", f"{pt}.resample_1", _CONV))
            if cfg.temporal_down[level]:
                entries.append((f"{sd}.time_conv", f"{pt}.time_conv.conv", "causal3"))
            idx += 1
    top = enc_dims[-1]
    entries += _wan_vae_resblock("encoder.middle.0", "encoder.middle_0", top, top)
    entries += _wan_vae_attn("encoder.middle.1", "encoder.middle_1")
    entries += _wan_vae_resblock("encoder.middle.2", "encoder.middle_2", top, top)
    entries += [
        ("encoder.head.0", "encoder.head_0", "gamma3"),
        ("encoder.head.2", "encoder.head_2.conv", "causal3"),
        ("conv1", "conv1_q.conv", "causal3"),
        ("conv2", "conv2_q.conv", "causal3"),
    ]
    rev = tuple(reversed(cfg.dim_mult))
    dec_dims = [cfg.base_dim * m for m in (rev[0],) + rev]
    temporal_up = tuple(reversed(cfg.temporal_down))
    entries.append(("decoder.conv1", "decoder.conv1.conv", "causal3"))
    top = dec_dims[0]
    entries += _wan_vae_resblock("decoder.middle.0", "decoder.middle_0", top, top)
    entries += _wan_vae_attn("decoder.middle.1", "decoder.middle_1")
    entries += _wan_vae_resblock("decoder.middle.2", "decoder.middle_2", top, top)
    idx, in_dim = 0, dec_dims[0]
    for level in range(len(cfg.dim_mult)):
        out_dim = dec_dims[level + 1]
        for _ in range(cfg.num_res_blocks + 1):
            entries += _wan_vae_resblock(f"decoder.upsamples.{idx}", f"decoder.up_{idx}",
                                         in_dim, out_dim)
            in_dim = out_dim
            idx += 1
        if level != len(cfg.dim_mult) - 1:
            sd, pt = f"decoder.upsamples.{idx}", f"decoder.up_{idx}"
            entries.append((f"{sd}.resample.1", f"{pt}.resample_1", _CONV))
            if temporal_up[level]:
                entries.append((f"{sd}.time_conv", f"{pt}.time_conv.conv", "causal3"))
            idx += 1
            in_dim = out_dim // 2  # an upsample halves the channels
    entries += [
        ("decoder.head.0", "decoder.head_0", "gamma3"),
        ("decoder.head.2", "decoder.head_2.conv", "causal3"),
    ]
    return entries


def clip_vision_schedule(cfg, prefix: str = "vision_model") -> list[Entry]:
    """HF CLIPVisionModel state dict → ClipVisionEncoder (the HF spelling
    `pre_layrnorm`). Penultimate configs leave the last layer and the
    post LN out: those keys go unused."""
    p = prefix
    entries: list[Entry] = [
        (f"{p}.embeddings.class_embedding", "class_embedding", "param_bare"),
        (f"{p}.embeddings.patch_embedding", "patch_embedding", "conv_nobias"),
        (f"{p}.embeddings.position_embedding", "position_embedding", "position"),
        (f"{p}.pre_layrnorm", "pre_ln", _NORM),
    ]
    for i in range(cfg.layers - 1 if cfg.penultimate_hidden else cfg.layers):
        sd, pt = f"{p}.encoder.layers.{i}", f"block_{i}"
        entries += [
            (f"{sd}.layer_norm1", f"{pt}.LayerNorm_0", _NORM),
            (f"{sd}.self_attn.q_proj", f"{pt}.q", _LINEAR),
            (f"{sd}.self_attn.k_proj", f"{pt}.k", _LINEAR),
            (f"{sd}.self_attn.v_proj", f"{pt}.v", _LINEAR),
            (f"{sd}.self_attn.out_proj", f"{pt}.proj", _LINEAR),
            (f"{sd}.layer_norm2", f"{pt}.LayerNorm_1", _NORM),
            (f"{sd}.mlp.fc1", f"{pt}.fc1", _LINEAR),
            (f"{sd}.mlp.fc2", f"{pt}.fc2", _LINEAR),
        ]
    if not cfg.penultimate_hidden:
        entries.append((f"{p}.post_layernorm", "post_ln", _NORM))
    return entries


# --- conversion -----------------------------------------------------------

def _expand(entries: Iterable[Entry]) -> list[tuple[str, str, str]]:
    """Entries → per-tensor (sd key, parameter name, transform)."""
    out: list[tuple[str, str, str]] = []
    for sd, pt, kind in entries:
        if kind in (_NORM, _CONV, _LINEAR):
            out.append((f"{sd}.weight", f"{pt}.weight", "id"))
            out.append((f"{sd}.bias", f"{pt}.bias", "id"))
        elif kind in (_LINEAR_NOBIAS, "embedding"):
            out.append((f"{sd}.weight", f"{pt}.weight", "id"))
        elif kind == _PROJ:
            out.append((f"{sd}.weight", f"{pt}.weight", "proj"))
            out.append((f"{sd}.bias", f"{pt}.bias", "id"))
        elif kind == "position":
            out.append((f"{sd}.weight", pt, "id"))
        elif kind == "param_bare":  # a bare nn.Parameter, no .weight suffix
            out.append((sd, pt, "id"))
        elif kind == "rms":  # an RMS norm's weight
            out.append((f"{sd}.weight", f"{pt}.weight", "id"))
        elif kind == "rms_scale":  # an RMS norm stored as .scale (Flux QKNorm)
            out.append((f"{sd}.scale", f"{pt}.weight", "id"))
        elif kind == "bare_linear_w":  # nn.Linear weight [P, W] → bare [W, P]
            out.append((f"{sd}.weight", pt, "transpose"))
        elif kind.startswith(("conv2d:", "conv3d:")):  # a patch conv → the patchify Dense
            out.append((f"{sd}.weight", f"{pt}.weight", kind))
            out.append((f"{sd}.bias", f"{pt}.bias", "id"))
        elif kind == "causal3":  # a Conv3d, weight and bias as stored
            out.append((f"{sd}.weight", f"{pt}.weight", "id"))
            out.append((f"{sd}.bias", f"{pt}.bias", "id"))
        elif kind in ("gamma3", "gamma2"):  # a bare RMS gamma with unit dims
            out.append((f"{sd}.gamma", f"{pt}.weight", kind))
        elif kind == "conv_nobias":
            out.append((f"{sd}.weight", f"{pt}.weight", "id"))
        elif kind == "fused_qkv":
            for slot, name in enumerate(("q", "k", "v")):
                out.append((f"{sd}_weight", f"{pt}.{name}.weight", f"qkv{slot}"))
                out.append((f"{sd}_bias", f"{pt}.{name}.bias", f"qkv{slot}"))
        else:  # pragma: no cover
            raise ValueError(f"unknown kind {kind}")
    return out


def _transform(value: torch.Tensor, how: str) -> torch.Tensor:
    if how == "proj":
        return value[:, :, 0, 0] if value.ndim == 4 else value  # a 1x1 conv → dense
    if how == "transpose":
        return value.t()
    if how.startswith("conv2d:"):
        return value.reshape(value.shape[0], -1)
    if how.startswith("conv3d:"):  # [O, c, pf, ph, pw] → [O, (pf ph pw c)]
        return value.permute(0, 2, 3, 4, 1).reshape(value.shape[0], -1)
    if how in ("gamma3", "gamma2"):
        return value.reshape(-1)
    if how.startswith("qkv"):
        third = value.shape[0] // 3
        slot = int(how[3])
        return value[slot * third:(slot + 1) * third]
    return value


def convert_state_dict(state_dict: Mapping[str, torch.Tensor], entries: Iterable[Entry]
                       ) -> tuple[dict[str, torch.Tensor], list[str]]:
    """SD state dict → {parameter name: tensor}, plus the sd keys the
    schedule expects and the checkpoint lacks."""
    flat: dict[str, torch.Tensor] = {}
    missing: list[str] = []
    for sd_key, name, how in _expand(entries):
        if sd_key not in state_dict:
            missing.append(sd_key)
            continue
        flat[name] = _transform(state_dict[sd_key], how)
    return flat, missing


def synthesize_state_dict(params: Mapping[str, torch.Tensor], entries: Iterable[Entry]
                          ) -> dict[str, torch.Tensor]:
    """The inverse of convert_state_dict: a module's state dict → an
    SD-layout state dict (projections as linears, OpenCLIP's q/k/v fused
    back into in_proj)."""
    out: dict[str, torch.Tensor] = {}
    fused: dict[str, list] = {}
    for sd_key, name, how in _expand(entries):
        if name not in params:
            raise KeyError(f"the module has no {name} (for {sd_key})")
        value = params[name]
        if how.startswith("qkv"):
            fused.setdefault(sd_key, [None, None, None])[int(how[3])] = value
        elif how.startswith("conv2d:"):
            p, c = (int(n) for n in how.split(":")[1:])
            out[sd_key] = value.reshape(value.shape[0], c, p, p)
        elif how.startswith("conv3d:"):
            pf, ph, pw, c = (int(n) for n in how.split(":")[1:])
            out[sd_key] = value.reshape(value.shape[0], pf, ph, pw, c).permute(0, 4, 1, 2, 3)
        elif how in ("gamma3", "gamma2"):
            out[sd_key] = value.reshape((-1,) + (1,) * (3 if how == "gamma3" else 2))
        else:
            out[sd_key] = value.t() if how == "transpose" else value
    for sd_key, parts in fused.items():
        out[sd_key] = torch.cat(parts, dim=0)
    return out


@torch.no_grad()
def _merge_into_module(state_dict: Mapping[str, torch.Tensor], entries: Iterable[Entry],
                       module: nn.Module, part: str) -> list[str]:
    """Convert `state_dict` through `entries` and copy each tensor into
    `module`'s parameter, cast to its dtype on its device, one at a time
    (the converted tensors are views of the file's). Returns the
    problems: sd keys the checkpoint lacks, parameters no entry fills,
    shapes that differ. The one merge loop every loader shares."""
    converted, missing = convert_state_dict(state_dict, entries)
    problems = [f"{part}: checkpoint lacks {k}" for k in missing]
    for name, dest in module.state_dict().items():
        value = converted.pop(name, None)
        if value is None:
            problems.append(f"{part}: schedule lacks {name}")
        elif tuple(value.shape) != tuple(dest.shape):
            problems.append(f"{part}: shape mismatch {name}: ckpt {tuple(value.shape)} "
                            f"vs model {tuple(dest.shape)}")
        else:
            dest.copy_(value)
    return problems


def _raise_if(problems: list[str], what: str) -> None:
    if problems:
        raise ValueError(f"{what} mapping failed ({len(problems)} problems): "
                         + "; ".join(problems[:12]))


# --- loaders --------------------------------------------------------------

def load_clip_te_weights(state_dict: Mapping[str, torch.Tensor], cfg, module: nn.Module) -> None:
    """A standalone CLIP text-encoder file (clip_l / clip_g releases: HF
    layout, bare `text_model.*` keys, the projection a root-level
    nn.Linear or bare parameter) → `module`, in place."""
    if not any(k.startswith("text_model.") for k in state_dict):
        raise ValueError("unrecognized standalone CLIP layout: expected bare text_model.* "
                         "keys (HF packing); got e.g. " + ", ".join(sorted(state_dict)[:3]))
    entries = text_encoder_schedule(cfg, prefix="text_model", projection_layout="linear")
    if (cfg.proj_dim is not None and "text_projection.weight" not in state_dict
            and "text_projection" in state_dict):
        # the rarer packing: a root-level bare projection parameter
        entries = [("text_projection", pt, "param_bare") if pt == "text_projection"
                   else (sd, pt, how) for sd, pt, how in entries]
    _raise_if(_merge_into_module(state_dict, entries, module, "te"),
              "CLIP text-encoder checkpoint")


def load_vae_weights(state_dict: Mapping[str, torch.Tensor], cfg, module: nn.Module) -> None:
    """A standalone VAE file (bare `encoder.` / `decoder.` keys) or a full
    checkpoint's `first_stage_model.*` → `module`, in place."""
    prefix = ("first_stage_model"
              if any(k.startswith("first_stage_model.") for k in state_dict) else "")
    _raise_if(_merge_into_module(state_dict, vae_schedule(cfg, prefix=prefix), module, "vae"),
              "VAE checkpoint")


def load_t5_weights(state_dict: Mapping[str, torch.Tensor], cfg, module: nn.Module) -> None:
    """A standalone T5 encoder file (t5xxl_*.safetensors: HF layout, bare
    `shared` and `encoder.block.*` keys, or nested under a prefix) →
    `module`, in place."""
    _raise_if(_merge_into_module(state_dict, t5_encoder_schedule(cfg, _t5_prefix(state_dict)),
                                 module, "t5"), "T5 checkpoint")


def _t5_prefix(state_dict: Mapping[str, torch.Tensor]) -> str:
    return next((k[: k.index("encoder.block.")] for k in state_dict
                 if "encoder.block.0.layer.0.SelfAttention.q.weight" in k), "")


def _flux_prefix(state_dict: Mapping[str, torch.Tensor]) -> str:
    nested = any(k.startswith("model.diffusion_model.double_blocks.") for k in state_dict)
    return "model.diffusion_model." if nested else ""


def load_diffusion_weights(state_dict: Mapping[str, torch.Tensor], cfg, module: nn.Module,
                           family: str) -> None:
    """A diffusion-model-only file (UNETLoader's: a published
    flux1-*.safetensors, an SD3.5 transformer repack, an extracted SD
    UNet) → `module`, in place.
    Bare keys and keys under `model.diffusion_model.` both load."""
    if family == "mmdit":
        entries = flux_schedule(cfg, prefix=_flux_prefix(state_dict))
    elif family == "sd3":
        entries = sd3_schedule(cfg, prefix=_sd3_prefix(state_dict))
    else:
        if not any(k.startswith("model.diffusion_model.") for k in state_dict):
            # the UNet schedule names the single-file prefix: bare keys gain it
            state_dict = {f"model.diffusion_model.{k}": v for k, v in state_dict.items()}
        entries = unet_schedule(cfg)
    _raise_if(_merge_into_module(state_dict, entries, module, "unet"),
              "diffusion-model checkpoint")


def load_flux_weights(state_dict: Mapping[str, torch.Tensor], unet_cfg, vae_cfg, te_cfg,
                      modules: dict[str, nn.Module], te2_cfg=None) -> set[str]:
    """A Flux-class file → the parts of `modules` ({'unet', 'vae', 'te'
    (T5), 'te2' (CLIP)}) it carries, in place; the others keep their init.
    Each part the file carries must fill its module strictly. Returns the
    parts filled; a file that carries none raises."""
    schedules: dict[str, list[Entry]] = {}
    prefix = _flux_prefix(state_dict)
    if any(k.startswith(f"{prefix}double_blocks.") for k in state_dict):
        schedules["unet"] = flux_schedule(unet_cfg, prefix=prefix)
    if any(k.startswith("first_stage_model.") for k in state_dict):
        schedules["vae"] = vae_schedule(vae_cfg)
    elif any(k.startswith("encoder.conv_in") for k in state_dict):
        schedules["vae"] = vae_schedule(vae_cfg, prefix="")
    if any("layer.0.SelfAttention.q.weight" in k for k in state_dict):
        schedules["te"] = t5_encoder_schedule(te_cfg, prefix=_t5_prefix(state_dict))
    if te2_cfg is not None and any("text_model.encoder.layers.0" in k for k in state_dict):
        clip_prefix = next(k[: k.index("text_model.encoder.layers.0")] + "text_model"
                           for k in state_dict if "text_model.encoder.layers.0" in k)
        schedules["te2"] = text_encoder_schedule(te2_cfg, prefix=clip_prefix)
    if not schedules:
        raise ValueError("flux checkpoint mapping failed: no mappable part found in the file")
    problems: list[str] = []
    for part, entries in schedules.items():
        problems += _merge_into_module(state_dict, entries, modules[part], part)
    _raise_if(problems, "flux checkpoint")
    return set(schedules)


def _sd3_prefix(state_dict: Mapping[str, torch.Tensor]) -> str:
    nested = any(k.startswith("model.diffusion_model.joint_blocks.") for k in state_dict)
    return "model.diffusion_model." if nested else ""


def load_sd3_weights(state_dict: Mapping[str, torch.Tensor], unet_cfg, vae_cfg, te_cfg,
                     modules: dict[str, nn.Module], te2_cfg=None, te3_cfg=None) -> set[str]:
    """An SD3/SD3.5 file → the parts of `modules` ({'unet', 'vae', 'te'
    (CLIP-L), 'te2' (CLIP-G), 'te3' (T5)}) it carries, in place: the MMDiT
    (bare `joint_blocks.*` or under `model.diffusion_model.`), the VAE
    (`first_stage_model.*`) and, in the `*_incl_clips*` files, the towers
    under `text_encoders.{clip_l,clip_g,t5xxl}.transformer.` (HF packing:
    the CLIP projections are nn.Linear). The others keep their init. Each
    part the file carries must fill its module strictly. Returns the parts
    filled; a file that carries none raises."""
    schedules: dict[str, list[Entry]] = {}
    if any(k.startswith(("joint_blocks.", "model.diffusion_model.joint_blocks."))
           for k in state_dict):
        schedules["unet"] = sd3_schedule(unet_cfg, prefix=_sd3_prefix(state_dict))
    if any(k.startswith("first_stage_model.") for k in state_dict):
        schedules["vae"] = vae_schedule(vae_cfg)
    for part, cfg, tower in (("te", te_cfg, "clip_l"), ("te2", te2_cfg, "clip_g")):
        if cfg is not None and any(k.startswith(f"text_encoders.{tower}.") for k in state_dict):
            schedules[part] = text_encoder_schedule(
                cfg, prefix=f"text_encoders.{tower}.transformer.text_model",
                projection_layout="linear")
    if te3_cfg is not None and any(k.startswith("text_encoders.t5xxl.") for k in state_dict):
        schedules["te3"] = t5_encoder_schedule(te3_cfg, prefix="text_encoders.t5xxl.transformer.")
    if not schedules:
        raise ValueError("sd3 checkpoint mapping failed: no mappable part found in the file")
    problems: list[str] = []
    for part, entries in schedules.items():
        problems += _merge_into_module(state_dict, entries, modules[part], part)
    _raise_if(problems, "sd3 checkpoint")
    return set(schedules)


def _wan_prefix(state_dict: Mapping[str, torch.Tensor]) -> str:
    return ("model.diffusion_model."
            if any(k.startswith("model.diffusion_model.blocks.") for k in state_dict) else "")


def load_wan_weights(state_dict: Mapping[str, torch.Tensor], cfg, module: nn.Module) -> None:
    """A WAN DiT file (the original bare `blocks.N.*` layout or a
    ComfyUI repack under `model.diffusion_model.`) → VideoDiT, in place,
    strictly."""
    problems = _merge_into_module(state_dict, wan_schedule(cfg, prefix=_wan_prefix(state_dict)),
                                  module, "dit")
    _raise_if(problems, "WAN checkpoint")


def load_wan_vae_weights(state_dict: Mapping[str, torch.Tensor], cfg, module: nn.Module) -> None:
    """An official Wan2.1 VAE file → VideoVAE, in place, strictly."""
    _raise_if(_merge_into_module(state_dict, wan_vae_schedule(cfg), module, "video_vae"),
              "WAN VAE checkpoint")


def load_clip_vision_weights(state_dict: Mapping[str, torch.Tensor], cfg,
                             module: nn.Module) -> None:
    """An HF CLIPVisionModel file → ClipVisionEncoder, in place, strictly."""
    _raise_if(_merge_into_module(state_dict, clip_vision_schedule(cfg), module, "clip_vision"),
              "CLIP-vision checkpoint")


# the WAN DiT's keys, bare or in a ComfyUI repack
WAN_MARKERS = ("blocks.0.self_attn.", "model.diffusion_model.blocks.0.self_attn.",
               "patch_embedding.")


def checkpoint_layout(state_dict: Mapping[str, torch.Tensor]) -> str:
    """A single file's layout by its keys: "wan" (a WAN video DiT, bare or
    under `model.diffusion_model.`), "sd3" (an SD3-class MMDiT, bare or
    under `model.diffusion_model.`), "flux" (a Flux transformer, bare or
    under `model.diffusion_model.`, or a T5 encoder), "sdxl"
    (`conditioner.embedders.*`), "sd2" (an OpenCLIP tower under
    `cond_stage_model.model.*`) or "sd1" (HF CLIP)."""
    if any(k.startswith(WAN_MARKERS) for k in state_dict):
        return "wan"
    if any(k.startswith(("joint_blocks.", "model.diffusion_model.joint_blocks."))
           for k in state_dict):
        return "sd3"
    if any(k.startswith(("double_blocks.", "model.diffusion_model.double_blocks."))
           or "encoder.block.0.layer.0.SelfAttention" in k for k in state_dict):
        return "flux"
    if any(k.startswith("conditioner.embedders.") for k in state_dict):
        return "sdxl"
    if any(k.startswith("cond_stage_model.model.") for k in state_dict):
        return "sd2"
    return "sd1"


# the UNet's first conv in a single file, and the registry name a file of
# each family loads as when that conv takes InpaintModelConditioning's 9
# channels (noisy latents 4, mask 1, masked image latents 4)
UNET_CONV_IN = "model.diffusion_model.input_blocks.0.0.weight"
INPAINT_VARIANTS = {"sd15": "sd15-inpaint", "tiny-unet": "tiny-unet-inpaint"}


def sniff_model_name(state_dict: Mapping[str, torch.Tensor], model_name: str) -> str:
    """The registry name a file asked for as `model_name` loads as: its
    inpainting variant (INPAINT_VARIANTS) where the file's UNet conv_in
    takes 9 channels, else `model_name`."""
    conv_in = state_dict.get(UNET_CONV_IN)
    if conv_in is not None and conv_in.ndim == 4 and conv_in.shape[1] == 9:
        return INPAINT_VARIANTS.get(model_name, model_name)
    return model_name


def sd_schedules(layout: str, unet_cfg, vae_cfg, te_cfg, te2_cfg=None) -> dict[str, list[Entry]]:
    """Each part's schedule in a single file of `layout`; te2 (SDXL's
    OpenCLIP bigG half) where `te2_cfg` is given."""
    if layout == "sd2":
        te_entries = open_clip_schedule(te_cfg, prefix="cond_stage_model.model")
    else:
        te_entries = text_encoder_schedule(
            te_cfg, prefix=("conditioner.embedders.0.transformer.text_model" if layout == "sdxl"
                            else "cond_stage_model.transformer.text_model"))
    schedules = {"unet": unet_schedule(unet_cfg), "vae": vae_schedule(vae_cfg),
                 "te": te_entries}
    if te2_cfg is not None:
        schedules["te2"] = open_clip_schedule(te2_cfg)
    return schedules


def load_sd_weights(state_dict: Mapping[str, torch.Tensor], unet_cfg, vae_cfg, te_cfg,
                    modules: dict[str, nn.Module], te2_cfg=None) -> None:
    """A single-file SD1.x, SD2.x or SDXL checkpoint → `modules`
    ({'unet', 'vae', 'te'[, 'te2']}), in place. Strict: every parameter
    must be filled with a matching shape, or ValueError."""
    problems: list[str] = []
    layout = checkpoint_layout(state_dict)
    if layout == "flux":
        raise ValueError("a Flux-class file, not a single-file SD checkpoint: load it as a "
                         "flux-* model (load_pipeline, UNETLoader, VAELoader, the CLIP loaders)")
    if layout == "sd3":
        raise ValueError("an SD3-class file, not a single-file SD checkpoint: load it as an "
                         "sd3-medium, sd35-large or sd35-medium model (load_pipeline, UNETLoader)")
    if layout == "wan":
        raise ValueError("a WAN video DiT file, not a single-file SD checkpoint: load it as a "
                         "wan-* model (load_video_pipeline, VideoCheckpointLoader)")
    schedules = sd_schedules(layout, unet_cfg, vae_cfg, te_cfg,
                             te2_cfg if "te2" in modules else None)
    for part, entries in schedules.items():
        problems += _merge_into_module(state_dict, entries, modules[part], part)
    _raise_if(problems, "checkpoint")


def synthesize_checkpoint(bundle) -> dict[str, torch.Tensor]:
    """A pipeline bundle's weights as the state dict of a single file in
    its family's layout: SDXL's with two towers, SD2.x's where the one
    tower is projected (OpenCLIP), else SD1.x's. The tensors are views of
    the bundle's parameters (fused in_proj and transposes aside)."""
    from .registry import get_config

    te_cfg = get_config(bundle.te_name)
    te2_cfg = None
    if bundle.text_encoder_2 is not None:
        layout, te2_cfg = "sdxl", get_config(bundle.te2_name)
    else:
        layout = "sd2" if te_cfg.proj_dim is not None else "sd1"
    modules = bundle.parts()
    schedules = sd_schedules(layout, get_config(bundle.model_name), bundle.vae.config, te_cfg,
                             te2_cfg)
    out: dict[str, torch.Tensor] = {}
    for part, entries in schedules.items():
        out.update(synthesize_state_dict(modules[part].state_dict(), entries))
    return out


# which text towers a single file carries, by key prefix
TE_MARKERS = {
    "te": ("cond_stage_model.", "conditioner.embedders.0.", "text_encoders.clip_l."),
    "te2": ("conditioner.embedders.1.", "text_encoders.clip_g."),
    "te3": ("text_encoders.t5xxl.",),
}


def supplied_towers(state_dict: Mapping[str, torch.Tensor]) -> set[str]:
    return {part for part, markers in TE_MARKERS.items()
            if any(k.startswith(markers) for k in state_dict)}


# --- files ----------------------------------------------------------------

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {dtype: name for name, dtype in _ST_DTYPES.items()}


class SafetensorsFile(Mapping):
    """A .safetensors file as a read-only mapping, mmapped: each item is a
    tensor viewing the map, read from the page cache when used. Valid
    until `close()`; copy what must outlive it."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        size = os.fstat(self._fh.fileno()).st_size
        if size < 8:
            raise ValueError(f"{path}: {size} bytes, not a safetensors file")
        (header_len,) = struct.unpack("<Q", self._fh.read(8))
        if 8 + header_len > size:
            raise ValueError(f"{path}: header of {header_len} bytes past the end of the file")
        header = json.loads(self._fh.read(header_len))
        header.pop("__metadata__", None)
        self._base = 8 + header_len
        for key, info in header.items():
            start, end = info["data_offsets"]
            if info["dtype"] not in _ST_DTYPES:
                raise ValueError(f"{path}: {key} has dtype {info['dtype']}, not one of "
                                 f"{sorted(_ST_DTYPES)}")
            itemsize = _ST_DTYPES[info["dtype"]].itemsize
            if (end - start != math.prod(info["shape"]) * itemsize or start < 0
                    or self._base + end > size):
                raise ValueError(f"{path}: {key}'s data_offsets {info['data_offsets']} do not "
                                 f"hold its shape {info['shape']}")
        self._header = header
        self.nbytes = size
        self._mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_COPY)

    def __getitem__(self, key: str) -> torch.Tensor:
        info = self._header[key]
        dtype = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        if end == start:
            return torch.empty(info["shape"], dtype=dtype)
        offset = self._base + start
        if offset % dtype.itemsize:  # unaligned: through a copy of the bytes
            flat = torch.frombuffer(bytearray(self._mm[offset:self._base + end]), dtype=dtype)
        else:
            flat = torch.frombuffer(self._mm, dtype=dtype, count=(end - start) // dtype.itemsize,
                                    offset=offset)
        return flat.reshape(info["shape"])

    def __iter__(self) -> Iterator[str]:
        return iter(self._header)

    def __len__(self) -> int:
        return len(self._header)

    def close(self) -> None:
        try:
            self._mm.close()
        except BufferError:
            pass  # a tensor still views the map: it closes with the last one
        self._fh.close()


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str,
                     dtype: torch.dtype | None = None) -> int:
    """Write `tensors` as a .safetensors file, in their order, each cast
    to `dtype` (floating-point tensors only) as it is written; returns
    the file's bytes. Tensors may live on any device."""
    def out_dtype(t: torch.Tensor) -> torch.dtype:
        return dtype if dtype is not None and t.is_floating_point() else t.dtype

    header: dict = {}
    offset = 0
    for key, t in tensors.items():
        nbytes = t.numel() * out_dtype(t).itemsize
        header[key] = {"dtype": _ST_NAMES[out_dtype(t)], "shape": list(t.shape),
                       "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(blob)))
        fh.write(blob)
        for t in tensors.values():
            t = t.detach().to(device="cpu", dtype=out_dtype(t)).contiguous()
            if t.numel():
                fh.write(t.reshape(-1).view(torch.uint8).numpy().data)
    return 8 + len(blob) + offset


def _read_torch_ckpt(path: str) -> dict[str, torch.Tensor]:
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    return {k: v for k, v in raw.items() if isinstance(v, torch.Tensor)}


@contextlib.contextmanager
def open_checkpoint(path: str) -> Iterator[Mapping[str, torch.Tensor]]:
    """A single-file checkpoint (.safetensors mmapped, torch .ckpt
    loaded, .gguf dequantized to f32) as a mapping of tensors."""
    if path.endswith(".gguf"):
        from .gguf import read_gguf

        yield {key: torch.from_numpy(arr) for key, arr in read_gguf(path).items()}
        return
    if path.endswith(".safetensors"):
        reader = SafetensorsFile(path)
        try:
            yield reader
        finally:
            reader.close()
    else:
        yield _read_torch_ckpt(path)


def find_checkpoint(model_name: str) -> str | None:
    """`CDT_CHECKPOINT_DIR/<model_name>.{safetensors,ckpt,gguf}`. The
    variable may name a file instead, which then applies only where its
    stem is `model_name`: a second model loaded in the same process must
    not get its weights. Other file names go through load_pipeline's
    `checkpoint=` argument."""
    root = os.environ.get("CDT_CHECKPOINT_DIR")
    if not root:
        return None
    if os.path.isfile(root):
        stem = os.path.splitext(os.path.basename(root))[0]
        return root if stem == model_name else None
    for ext in (".safetensors", ".ckpt", ".gguf"):
        candidate = os.path.join(root, model_name + ext)
        if os.path.exists(candidate):
            return candidate
    return None
