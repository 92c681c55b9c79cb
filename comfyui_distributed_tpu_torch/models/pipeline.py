"""The model bundle, text conditioning and the guided model function.

Counterpart of the parts of comfyui_distributed_tpu/models/pipeline.py
that the SDXL upscale path runs: `load_pipeline` (seeded random init;
reading real checkpoints comes with a later slice), the dual-tower
SDXL text encoding, and the eps model function with the adm vector
(pooled text + six Fourier size embeddings) under plain CFG. Modules
hold their own parameters, so the functions take the bundle where the
JAX ones take (bundle, params).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import samplers as smp
from ..ops.conditioning import Conditioning
from .io import random_init_
from .layers import timestep_embedding
from .registry import DUAL_TEXT_ENCODERS, create_model, get_config, model_family
from .text_encoder import TextEncoder, Tokenizer
from .unet import UNet
from .vae import VAE


@dataclasses.dataclass
class PipelineBundle:
    """A checkpoint: UNet + VAE + text encoder(s), on one device."""

    model_name: str
    unet: UNet
    vae: VAE
    text_encoder: TextEncoder
    tokenizer: Tokenizer
    device: torch.device
    latent_channels: int = 4
    latent_scale: int = 8  # spatial down factor of the VAE
    # SDXL-class second encoder (context concat + pooled source)
    text_encoder_2: TextEncoder | None = None
    tokenizer_2: Tokenizer | None = None
    te_name: str | None = None
    te2_name: str | None = None


def _family_vae_name(model_name: str) -> str:
    return "tiny-vae" if model_name.startswith("tiny") else "vae-sd"


def _build(name: str, device: torch.device, generator: torch.Generator):
    with torch.device("meta"):
        module = create_model(name)
    module = module.to_empty(device=device)
    random_init_(module, generator)
    return module.eval().requires_grad_(False)


def load_pipeline(model_name: str = "tiny-unet", seed: int = 0, device="cuda") -> PipelineBundle:
    """Build a pipeline with seeded random weights on `device` (the card
    unless the caller asks for the CPU). Each module draws from its own
    generator, seeded from `seed`, on the target device."""
    if model_family(model_name) != "unet":
        raise NotImplementedError(
            f"{model_name!r}: only UNet-family pipelines are ported so far"
        )
    device = torch.device(device)
    if model_name in DUAL_TEXT_ENCODERS:
        te_name, te2_name = DUAL_TEXT_ENCODERS[model_name]
    else:
        te_name, te2_name = ("tiny-te" if model_name.startswith("tiny") else "clip-l"), None
    vae_name = _family_vae_name(model_name)

    def generator(offset: int) -> torch.Generator:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) * 16 + offset)
        return gen

    unet = _build(model_name, device, generator(0))
    # zero-initialised as in the JAX package (its out_conv kernel_init):
    # an untrained UNet predicts eps = 0
    unet.out_conv.weight.zero_()
    vae = _build(vae_name, device, generator(1))
    te = _build(te_name, device, generator(2))
    te_cfg = get_config(te_name)
    vae_cfg = get_config(vae_name)
    te2 = tok2 = None
    if te2_name:
        te2 = _build(te2_name, device, generator(3))
        te2_cfg = get_config(te2_name)
        tok2 = Tokenizer(max_length=te2_cfg.max_length, pad_id=te2_cfg.pad_token_id)
    return PipelineBundle(
        model_name=model_name,
        unet=unet,
        vae=vae,
        text_encoder=te,
        tokenizer=Tokenizer(max_length=te_cfg.max_length, pad_id=te_cfg.pad_token_id),
        device=device,
        latent_channels=vae_cfg.latent_channels,
        latent_scale=vae_cfg.downscale,
        text_encoder_2=te2,
        tokenizer_2=tok2,
        te_name=te_name,
        te2_name=te2_name,
    )


# --- conditioning --------------------------------------------------------

def _encode_tower(encoder: TextEncoder, tokenizer: Tokenizer, texts: list[str], device):
    tokens = torch.as_tensor(tokenizer.encode_batch(texts), dtype=torch.long, device=device)
    return encoder(tokens, eos_id=tokenizer.eos_id)


@torch.no_grad()
def _encode_raw(bundle: PipelineBundle, texts: list[str]):
    """Prompts → (hidden [B, T, context_dim], pooled [B, P]). Dual-tower
    bundles concatenate both hidden states on features and take the
    pooled vector from the second (projected) tower."""
    hidden, pooled = _encode_tower(bundle.text_encoder, bundle.tokenizer, texts, bundle.device)
    if bundle.text_encoder_2 is not None:
        hidden2, pooled = _encode_tower(
            bundle.text_encoder_2, bundle.tokenizer_2, texts, bundle.device
        )
        hidden = torch.cat([hidden.float(), hidden2.float()], dim=-1)
    ctx_dim = get_config(bundle.model_name).context_dim
    if hidden.shape[-1] < ctx_dim:
        hidden = torch.nn.functional.pad(hidden, (0, ctx_dim - hidden.shape[-1]))
    return hidden[..., :ctx_dim], pooled


def encode_text(bundle: PipelineBundle, texts: list[str]) -> torch.Tensor:
    """Prompts → [B, T, context_dim] context."""
    return _encode_raw(bundle, texts)[0]


def encode_text_pooled(bundle: PipelineBundle, texts: list[str]) -> Conditioning:
    """Prompts → Conditioning carrying the pooled vector (SDXL adm)."""
    hidden, pooled = _encode_raw(bundle, texts)
    return Conditioning(context=hidden, pooled=pooled)


# --- model fn ------------------------------------------------------------

def model_schedule_info(bundle: PipelineBundle) -> str:
    """The backbone's parameterization, which picks the sigma table and
    the noising rule; the ported UNets are eps-prediction."""
    param = get_config(bundle.model_name).parameterization
    if param != "eps":
        raise NotImplementedError(f"{param!r}-prediction models are not ported yet")
    return param


def _adm_vector(bundle: PipelineBundle, cond: Conditioning, x: torch.Tensor) -> torch.Tensor | None:
    """The UNet's `y`: pooled text, plus (real SDXL layout) six 256-d
    Fourier size embeddings of (orig_h, orig_w, crop_t, crop_l,
    target_h, target_w) = the latent's pixel size with zero crops, the
    KSampler default; repeated to x's batch."""
    adm = get_config(bundle.model_name).adm_in_channels
    if not adm or cond.pooled is None:
        return None
    pooled = cond.pooled
    if adm - pooled.shape[-1] == 6 * 256:
        h_px = float(x.shape[1] * bundle.latent_scale)
        w_px = float(x.shape[2] * bundle.latent_scale)
        vals = [h_px, w_px, 0.0, 0.0, h_px, w_px]
        size_emb = timestep_embedding(
            torch.tensor(vals, dtype=torch.float32, device=pooled.device), 256
        ).reshape(1, -1)
        pooled = torch.cat(
            [pooled.float(), size_emb.expand(pooled.shape[0], -1)], dim=-1
        )
    elif pooled.shape[-1] < adm:
        pooled = torch.nn.functional.pad(pooled, (0, adm - pooled.shape[-1]))
    else:
        pooled = pooled[..., :adm]
    if pooled.shape[0] != x.shape[0] and x.shape[0] % pooled.shape[0] == 0:
        # repeat, not broadcast: under the CFG concat the second half is
        # the NEGATIVE pooled vector
        pooled = pooled.repeat_interleave(x.shape[0] // pooled.shape[0], dim=0)
    return pooled


def _make_model_fn(bundle: PipelineBundle):
    """eps model function: VP input scaling, sigma → timestep, context
    broadcast to the latent batch, and the adm vector."""

    def model_fn(x: torch.Tensor, sigma_batch: torch.Tensor, cond) -> torch.Tensor:
        context = cond.context if isinstance(cond, Conditioning) else cond
        if context.shape[0] != x.shape[0] and x.shape[0] % context.shape[0] == 0:
            context = context.repeat_interleave(x.shape[0] // context.shape[0], dim=0)
        y = _adm_vector(bundle, cond, x) if isinstance(cond, Conditioning) else None
        c_in = (1.0 / torch.sqrt(sigma_batch**2 + 1.0)).reshape((-1,) + (1,) * (x.ndim - 1))
        out = bundle.unet(x * c_in, smp.sigma_to_timestep(sigma_batch), context, y=y)
        return out.to(x.dtype)

    return model_fn


def guided_model(bundle: PipelineBundle, cfg_scale: float):
    """Plain CFG over the bundle's model. The guidance patches of the
    JAX package (PAG, SAG, PerpNeg, DualCFG, RescaleCFG, SLG) are not
    ported yet; bundles here carry none."""
    return smp.cfg_model(_make_model_fn(bundle), cfg_scale)
