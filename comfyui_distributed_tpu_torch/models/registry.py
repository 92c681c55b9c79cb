"""Model registry: the named configs the ported slice runs.

The port's own copy of the entries of comfyui_distributed_tpu/models/
registry.py that the ported paths need: `sdxl` with its VAE and two
text encoders (the upscale workflow), `sd15` with the SD VAE and CLIP-L
(the txt2img, two-pass, PAG and inpaint workflows), `sd15-inpaint`
(the 9-channel inpainting UNet of InpaintModelConditioning), `sd21` and
`sd21-base` with OpenCLIP-H (the SD2.1 workflow), and the tiny
instances of the same code that the CPU tests hold against the JAX
package. Other families come with their slices.
"""

from __future__ import annotations

from typing import Any

from torch import nn

from .text_encoder import TextEncoder, TextEncoderConfig
from .unet import UNet, UNetConfig
from .vae import VAE, VAEConfig

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
    "vae-sd": {"family": "vae", "config": VAEConfig()},
    "tiny-vae": {
        "family": "vae",
        "config": VAEConfig(base_channels=16, channel_mult=(1, 2), num_res_blocks=1),
    },
    # single-tower UNets' encoder: the final layer and the final LayerNorm
    "clip-l": {"family": "text_encoder", "config": TextEncoderConfig()},
    "clip-l-sdxl": {
        "family": "text_encoder",
        "config": TextEncoderConfig(penultimate_hidden=True),
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

_CONSTRUCTORS = {"unet": UNet, "vae": VAE, "text_encoder": TextEncoder}


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
