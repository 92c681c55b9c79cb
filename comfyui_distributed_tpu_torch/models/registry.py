"""Model registry: the named configs the ported slice runs.

The port's own copy of the entries of comfyui_distributed_tpu/models/
registry.py that the ported paths need: `sdxl` with its VAE and two
text encoders (the upscale workflow), `sd15` with the SD VAE and CLIP-L
(the txt2img workflow), and the tiny instances of the same code that
the CPU tests hold against the JAX package. Other families come with
their slices.
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
