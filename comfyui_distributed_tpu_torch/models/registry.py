"""Model registry: the named configs the ported slice runs.

The port's own copy of the entries of comfyui_distributed_tpu/models/
registry.py that the ported paths need: `sdxl` with its VAE and two
text encoders (the upscale workflow), `sd15` with the SD VAE and CLIP-L
(the txt2img, two-pass, PAG and inpaint workflows), `sd15-inpaint`
(the 9-channel inpainting UNet of InpaintModelConditioning), `sd21` and
`sd21-base` with OpenCLIP-H (the SD2.1 workflow), `flux-dev` and
`flux-schnell` with T5-XXL, CLIP-L and the 16-channel Flux VAE (the Flux
and Kontext workflows), `sd3-medium`, `sd35-large` and `sd35-medium`
(MMDiT-X) with CLIP-L (projected pooled), CLIP-G, T5-XXL at 77 tokens and
the 16-channel SD3 VAE (the SD3.5 workflows), `wan-1.3b`, `wan-14b` and
`wan-14b-i2v` with the causal `wan-vae` and `clip-vision-h` (the WAN
workflows), and the tiny instances of the same code that the CPU tests
hold against the JAX package. The audio family comes with its slice.
"""

from __future__ import annotations

from typing import Any

from torch import nn

from .clip_vision import ClipVisionConfig, ClipVisionEncoder
from .dit import DiTConfig, VideoDiT
from .mmdit import MMDiT, MMDiTConfig
from .sd3 import SD3Config, SD3MMDiT
from .t5_encoder import T5Encoder, T5EncoderConfig
from .text_encoder import TextEncoder, TextEncoderConfig
from .unet import UNet, UNetConfig
from .vae import VAE, VAEConfig
from .video_vae import VideoVAE, VideoVAEConfig

MODEL_REGISTRY: dict[str, dict[str, Any]] = {
    # SD1.5: 8 heads at every level, so head dims 40, 80 and 160 (the JAX
    # entry's `remat` is a training knob the port does not carry)
    "sd15": {
        "family": "unet",
        "config": UNetConfig(
            model_channels=320,
            channel_mult=(1, 2, 4, 4),
            transformer_depth=(1, 1, 1, 0),
            context_dim=768,
            num_heads=8,
        ),
    },
    # SD1.5 inpainting (the sd-v1-5-inpainting layout): input = the noisy
    # latents (4), then InpaintModelConditioning's mask (1) and masked
    # image latents (4)
    "sd15-inpaint": {
        "family": "unet",
        "config": UNetConfig(
            in_channels=9,
            model_channels=320,
            channel_mult=(1, 2, 4, 4),
            transformer_depth=(1, 1, 1, 0),
            context_dim=768,
            num_heads=8,
        ),
    },
    "sdxl": {
        "family": "unet",
        "config": UNetConfig(
            model_channels=320,
            channel_mult=(1, 2, 4),
            transformer_depth=(0, 2, 10),
            context_dim=2048,
            head_dim=64,  # SDXL num_head_channels convention
            adm_in_channels=2816,
        ),
    },
    # SD2.1-768-v: SD1.x topology with OpenCLIP-H conditioning (context
    # 1024), 64-wide heads, velocity prediction
    "sd21": {
        "family": "unet",
        "config": UNetConfig(
            model_channels=320,
            channel_mult=(1, 2, 4, 4),
            transformer_depth=(1, 1, 1, 0),
            context_dim=1024,
            head_dim=64,
            parameterization="v",
        ),
    },
    # SD2.1-base (512 px): the same network, eps prediction
    "sd21-base": {
        "family": "unet",
        "config": UNetConfig(
            model_channels=320,
            channel_mult=(1, 2, 4, 4),
            transformer_depth=(1, 1, 1, 0),
            context_dim=1024,
            head_dim=64,
        ),
    },
    "tiny-unet": {
        "family": "unet",
        "config": UNetConfig(
            model_channels=32,
            channel_mult=(1, 2),
            num_res_blocks=1,
            transformer_depth=(1, 1),
            context_dim=64,
            num_heads=2,
        ),
    },
    # tiny SDXL-shaped variant: dual text encoders + pooled/size adm
    # conditioning (context 64+96, adm = 96 pooled + 6x256 size embs)
    "tiny-unet-adm": {
        "family": "unet",
        "config": UNetConfig(
            model_channels=32,
            channel_mult=(1, 2),
            num_res_blocks=1,
            transformer_depth=(1, 1),
            context_dim=160,
            num_heads=2,
            adm_in_channels=96 + 6 * 256,
        ),
    },
    # tiny inpaint-model variant (9-channel input): the concat path of
    # InpaintModelConditioning
    "tiny-unet-inpaint": {
        "family": "unet",
        "config": UNetConfig(
            in_channels=9,
            model_channels=32,
            channel_mult=(1, 2),
            num_res_blocks=1,
            transformer_depth=(1, 1),
            context_dim=64,
            num_heads=2,
        ),
    },
    # tiny v-prediction variant: the v → eps conversion on every path
    "tiny-unet-v": {
        "family": "unet",
        "config": UNetConfig(
            model_channels=32,
            channel_mult=(1, 2),
            num_res_blocks=1,
            transformer_depth=(1, 1),
            context_dim=64,
            num_heads=2,
            parameterization="v",
        ),
    },
    # Flux-class MMDiT at the published widths. dev: guidance-distilled,
    # flow shift 3.0 (about the published dynamic shift at 1 MP);
    # schnell: timestep-distilled, no guidance embedding, unshifted
    "flux-dev": {"family": "mmdit", "config": MMDiTConfig()},
    "flux-schnell": {
        "family": "mmdit",
        "config": MMDiTConfig(guidance_embed=False, flow_shift=1.0),
    },
    "tiny-flux": {
        "family": "mmdit",
        "config": MMDiTConfig(
            hidden_dim=32, double_depth=1, single_depth=1, heads=2, axes_dim=(4, 6, 6),
            context_dim=64, vec_dim=64, flow_shift=1.0,
        ),
    },
    # SD3-class MMDiT (joint blocks, a learned position table). SD3-medium
    # (2B): depth 24, so 1536 wide, no QK norm
    "sd3-medium": {"family": "sd3", "config": SD3Config(depth=24)},
    # SD3.5-large (8B): depth 38, 2432 wide, 38 heads, per-head RMS QK norm
    "sd35-large": {
        "family": "sd3",
        "config": SD3Config(depth=38, hidden_dim=2432, heads=38, qk_norm=True),
    },
    # SD3.5-medium (2.5B, MMDiT-X): depth 24, QK norm, a 384-wide position
    # table and a second image-only attention (attn2, 9-way adaLN) in the
    # first 13 x_blocks
    "sd35-medium": {
        "family": "sd3",
        "config": SD3Config(depth=24, qk_norm=True, pos_embed_max=384, dual_attn_blocks=13),
    },
    # tiny MMDiT-X: one dual-attention block and one plain
    "tiny-sd35m": {
        "family": "sd3",
        "config": SD3Config(depth=2, hidden_dim=32, heads=2, context_dim=160, pooled_dim=160,
                            pos_embed_max=32, qk_norm=True, dual_attn_blocks=1,
                            flow_shift=1.0),
    },
    # tiny: context 160 = tiny CLIP-L (64) ++ CLIP-G (96) = the T5 width; the
    # position table covers USDU's padded 96-px tiles (latent 48, patch 2)
    "tiny-sd3": {
        "family": "sd3",
        "config": SD3Config(depth=2, hidden_dim=32, heads=2, context_dim=160, pooled_dim=160,
                            pos_embed_max=32, qk_norm=True, flow_shift=1.0),
    },
    # video DiT backbones (WAN 2.x checkpoint-faithful widths; head dim 128)
    "wan-1.3b": {
        "family": "dit",
        "config": DiTConfig(hidden_dim=1536, ffn_dim=8960, depth=30, heads=12, context_dim=4096),
    },
    "wan-14b": {
        "family": "dit",
        "config": DiTConfig(hidden_dim=5120, ffn_dim=13824, depth=40, heads=40, context_dim=4096),
    },
    "tiny-dit": {
        "family": "dit",
        "config": DiTConfig(hidden_dim=64, depth=2, heads=2, context_dim=64),
    },
    # i2v: [noise 16 | mask 4 | cond latent 16] = 36 input channels, 16 out;
    # the image cross-attention over CLIP ViT-H's penultimate tokens
    "wan-14b-i2v": {
        "family": "dit",
        "config": DiTConfig(hidden_dim=5120, ffn_dim=13824, depth=40, heads=40,
                            context_dim=4096, in_channels=36, out_channels=16, i2v=True),
    },
    "tiny-dit-i2v": {
        "family": "dit",
        "config": DiTConfig(hidden_dim=64, depth=2, heads=2, context_dim=64, in_channels=36,
                            out_channels=16, i2v=True, img_dim=48),
    },
    "vae-sd": {"family": "vae", "config": VAEConfig()},
    # the Flux-class 16-channel AE: (mean - shift) * scale at its boundary,
    # no 1x1 quant convs in the published layout
    "vae-flux": {
        "family": "vae",
        "config": VAEConfig(latent_channels=16, scaling_factor=0.3611, shift_factor=0.1159,
                            use_quant_conv=False),
    },
    "tiny-vae-flux": {
        "family": "vae",
        "config": VAEConfig(base_channels=16, channel_mult=(1, 2), num_res_blocks=1,
                            latent_channels=16, scaling_factor=0.3611, shift_factor=0.1159,
                            use_quant_conv=False),
    },
    # the SD3-class 16-channel AE: scale 1.5305, shift 0.0609, no quant convs
    "vae-sd3": {
        "family": "vae",
        "config": VAEConfig(latent_channels=16, scaling_factor=1.5305, shift_factor=0.0609,
                            use_quant_conv=False),
    },
    "tiny-vae-sd3": {
        "family": "vae",
        "config": VAEConfig(base_channels=16, channel_mult=(1, 2), num_res_blocks=1,
                            latent_channels=16, scaling_factor=1.5305, shift_factor=0.0609,
                            use_quant_conv=False),
    },
    "tiny-vae": {
        "family": "vae",
        "config": VAEConfig(base_channels=16, channel_mult=(1, 2), num_res_blocks=1),
    },
    # a 16-channel per-frame 2D VAE (the tiny video stack's)
    "vae-video": {
        "family": "vae",
        "config": VAEConfig(latent_channels=16, scaling_factor=1.0),
    },
    "tiny-vae-video": {
        "family": "vae",
        "config": VAEConfig(base_channels=16, channel_mult=(1, 2), num_res_blocks=1,
                            latent_channels=16, scaling_factor=1.0),
    },
    # the causal 3D WAN VAE: 8x spatial, 4x temporal, 4n+1 frames; the
    # per-channel constants the official Wan2.1 wrapper normalizes with
    "wan-vae": {
        "family": "video_vae",
        "config": VideoVAEConfig(
            latents_mean=(
                -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653,
                -0.1517, 1.5508, 0.4134, -0.0715, 0.5517, -0.3632,
                -0.1922, -0.9497, 0.2503, -0.2921,
            ),
            latents_std=(
                2.8184, 1.4541, 2.3275, 2.5017, 2.3632, 2.0435,
                3.3086, 3.0723, 2.0365, 1.9887, 2.6244, 2.0905,
                2.3852, 1.4049, 2.5648, 2.7630,
            ),
        ),
    },
    "tiny-video-vae-3d": {
        "family": "video_vae",
        "config": VideoVAEConfig(base_dim=16, dim_mult=(1, 2), num_res_blocks=1,
                                 temporal_down=(True,)),
    },
    # CLIP vision towers (WAN i2v's image conditioning; ViT-H/14)
    "clip-vision-h": {"family": "clip_vision", "config": ClipVisionConfig()},
    "tiny-clip-vision": {
        "family": "clip_vision",
        "config": ClipVisionConfig(image_size=32, patch_size=8, width=48, layers=3, heads=2),
    },
    # single-tower UNets' encoder: the final layer and the final LayerNorm
    "clip-l": {"family": "text_encoder", "config": TextEncoderConfig()},
    "clip-l-sdxl": {
        "family": "text_encoder",
        "config": TextEncoderConfig(penultimate_hidden=True),
    },
    # SD3's CLIP-L half: the penultimate hidden state and a PROJECTED pooled
    # vector (the files bundle CLIPTextModelWithProjection, a 768x768 table)
    "clip-l-sd3": {
        "family": "text_encoder",
        "config": TextEncoderConfig(penultimate_hidden=True, proj_dim=768),
    },
    "clip-g": {
        "family": "text_encoder",
        "config": TextEncoderConfig(
            width=1280, layers=32, heads=20, activation="gelu",
            penultimate_hidden=True, proj_dim=1280,
            pad_token_id=0,  # open_clip.tokenize pads with 0, not EOS
        ),
    },
    # OpenCLIP ViT-H/14 text tower (SD2.x): its penultimate context goes
    # through the final LayerNorm
    "clip-h": {
        "family": "text_encoder",
        "config": TextEncoderConfig(
            width=1024, layers=24, heads=16, activation="gelu",
            penultimate_hidden=True, proj_dim=1024,
            final_ln_on_hidden=True, pad_token_id=0,
        ),
    },
    # classic T5 v1.1 XXL (the Flux text encoder): the stack-shared
    # relative-position bias, the SentencePiece vocab of 32128, 512 tokens
    "t5-xxl": {
        "family": "t5_encoder",
        "config": T5EncoderConfig(vocab_size=32128, d_model=4096, d_ff=10240, layers=24,
                                  heads=64, d_kv=64, per_layer_rel_bias=False),
    },
    # SD3's T5 slot: the same weights, padded to 77 tokens (Flux pads to 512)
    "t5-xxl-sd3": {
        "family": "t5_encoder",
        "config": T5EncoderConfig(vocab_size=32128, d_model=4096, d_ff=10240, layers=24,
                                  heads=64, d_kv=64, per_layer_rel_bias=False, max_length=77),
    },
    # a tiny T5 at the tiny SD3 context width (160 = the tiny CLIP concat)
    "tiny-t5-sd3": {
        "family": "t5_encoder",
        "config": T5EncoderConfig(vocab_size=49408, d_model=160, d_ff=320, layers=2, heads=2,
                                  d_kv=32, max_length=16, per_layer_rel_bias=False),
    },
    # the tiny shared-bias variant (the Flux layout); its vocab covers the
    # CLIP-BPE id space
    "tiny-t5-shared": {
        "family": "t5_encoder",
        "config": T5EncoderConfig(vocab_size=49408, d_model=64, d_ff=128, layers=2, heads=2,
                                  d_kv=32, max_length=16, per_layer_rel_bias=False),
    },
    "tiny-te": {
        "family": "text_encoder",
        "config": TextEncoderConfig(width=64, layers=2, heads=2, max_length=16),
    },
    "tiny-te-l": {
        "family": "text_encoder",
        "config": TextEncoderConfig(
            width=64, layers=2, heads=2, max_length=16, penultimate_hidden=True
        ),
    },
    "tiny-te-g": {
        "family": "text_encoder",
        "config": TextEncoderConfig(
            width=96, layers=2, heads=2, max_length=16, activation="gelu",
            penultimate_hidden=True, proj_dim=96, pad_token_id=0,
        ),
    },
}

# Models conditioned by TWO encoders (SDXL layout): context =
# concat(hidden_1, hidden_2); pooled = projected pooled_2.
DUAL_TEXT_ENCODERS: dict[str, tuple[str, str]] = {
    "sdxl": ("clip-l-sdxl", "clip-g"),
    "tiny-unet-adm": ("tiny-te-l", "tiny-te-g"),
}

# Single-encoder models whose encoder is not CLIP-L (tiny models take
# tiny-te)
DEFAULT_TEXT_ENCODERS: dict[str, str] = {
    "sd21": "clip-h",
    "sd21-base": "clip-h",
}

# Flux-layout conditioning: the hidden states of a T5-class encoder, the
# pooled vector of a CLIP-class one; no concat, no padding
HIDDEN_POOLED_ENCODERS: dict[str, tuple[str, str]] = {
    "flux-dev": ("t5-xxl", "clip-l"),
    "flux-schnell": ("t5-xxl", "clip-l"),
    "tiny-flux": ("tiny-t5-shared", "tiny-te"),
}

# SD3-layout conditioning (CLIP-L, CLIP-G, T5): the CLIP hidden states
# concatenated on features, zero-padded to the T5 width, then joined to the
# T5's on the sequence; pooled = CLIP-L's pooled ++ CLIP-G's
TRIPLE_TEXT_ENCODERS: dict[str, tuple[str, str, str]] = {
    "sd3-medium": ("clip-l-sd3", "clip-g", "t5-xxl-sd3"),
    "sd35-large": ("clip-l-sd3", "clip-g", "t5-xxl-sd3"),
    "sd35-medium": ("clip-l-sd3", "clip-g", "t5-xxl-sd3"),
    "tiny-sd3": ("tiny-te-l", "tiny-te-g", "tiny-t5-sd3"),
    "tiny-sd35m": ("tiny-te-l", "tiny-te-g", "tiny-t5-sd3"),
}

_CONSTRUCTORS = {"unet": UNet, "mmdit": MMDiT, "sd3": SD3MMDiT, "dit": VideoDiT, "vae": VAE,
                 "video_vae": VideoVAE, "text_encoder": TextEncoder, "t5_encoder": T5Encoder,
                 "clip_vision": ClipVisionEncoder}


def _entry(name: str) -> dict[str, Any]:
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


def model_family(name: str) -> str:
    return _entry(name)["family"]


def get_config(name: str) -> Any:
    return _entry(name)["config"]


def create_model(name: str) -> nn.Module:
    """The module for a registry name, parameters uninitialised; build
    it under `torch.device("meta")` to allocate nothing."""
    entry = _entry(name)
    return _CONSTRUCTORS[entry["family"]](entry["config"])
