"""The model bundle, text conditioning and the guided model function.

Counterpart of the parts of comfyui_distributed_tpu/models/pipeline.py
that the ported paths run: `load_pipeline` (a single-file SD1.x, SD2.x
or SDXL checkpoint where one resolves, else seeded random init) and
`load_vae`, single-tower (SD1.5, SD2.1) and dual-tower (SDXL) text
encoding with clip-skip, the model function (eps or v prediction, the
adm vector of pooled text and six Fourier size embeddings), CFG with the
PAG patch, and `img2img_latents` / `img2img_latents_advanced`
(KSamplerAdvanced's window) / `txt2img`, each with the inpainting noise
mask. Modules hold their own parameters, so the functions take the
bundle where the JAX ones take (bundle, params). The model function also
takes ControlNet hints (gated by their sampling window), the SDXL size
override of CLIPTextEncodeSDXL, and SAG's capture pass; `guided_model`
composes CFG with one guidance patch: PAG, SAG or RescaleCFG.

Node patches (CLIPSetLastLayer's clip-skip, PerturbedAttentionGuidance's
PAGSpec, SelfAttentionGuidance's SAGSpec, RescaleCFG's multiplier,
FreeU's UNet config) return a new bundle through `dataclasses.replace`:
the modules and their parameters are shared, the bundle a graph executor
caches is never changed.

Noise: `jax.random` and `torch.Generator` give different numbers for one
seed, so the samplers take a `noise` tensor (the initial noise) and a
`step_noise` source (the stochastic samplers' draws); the tests hand
them the JAX package's own. As the JAX package splits its key, the two
are separate streams of the participant's seed: the initial noise
standard normals from a generator seeded with `seed`, the step noise
from one seeded with `stream_seed(seed, STEP_STREAM)`, both on the
bundle's device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch

from ..ops import samplers as smp
from ..ops.conditioning import Conditioning, as_conditioning
from ..ops.resize import resize_image
from ..utils.logging import log
from . import sd_checkpoint as sdc
from .io import random_init_
from .layers import timestep_embedding
from .registry import (
    DEFAULT_TEXT_ENCODERS,
    DUAL_TEXT_ENCODERS,
    create_model,
    get_config,
    model_family,
)
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
    # clip-skip (CLIPSetLastLayer): how many final blocks the towers'
    # hidden output leaves out; None = each tower's configured default
    clip_skip: int | None = None
    # PerturbedAttentionGuidance patch (UNet family); None = no PAG pass
    pag: "PAGSpec | None" = None
    # SelfAttentionGuidance patch (UNet family); None = no SAG
    sag: "SAGSpec | None" = None
    # RescaleCFG patch: the std-rescale multiplier; None = plain CFG
    cfg_rescale: float | None = None

    def parts(self) -> dict[str, torch.nn.Module]:
        """The modules by checkpoint part: unet, vae, te and, for a
        dual-tower bundle, te2."""
        parts = {"unet": self.unet, "vae": self.vae, "te": self.text_encoder}
        if self.text_encoder_2 is not None:
            parts["te2"] = self.text_encoder_2
        return parts


@dataclasses.dataclass(frozen=True)
class PAGSpec:
    """Perturbed-attention guidance: the guided result gains
    scale * (cond - cond with the middle block's self-attention as
    identity)."""

    scale: float = 3.0


@dataclasses.dataclass(frozen=True)
class SAGSpec:
    """Self-attention guidance (Hong et al. 2023): blur the uncond x0
    estimate where the middle block's self-attention concentrates,
    re-noise it, and guide away from that degraded prediction."""

    scale: float = 0.5
    blur_sigma: float = 2.0


@dataclasses.dataclass
class VAEBundle:
    """A standalone VAE (VAELoader's output). It has the attributes the
    VAE-consuming nodes read (`vae`, `device`, `latent_channels`,
    `latent_scale`), so it replaces a checkpoint's VAE wherever one is
    taken."""

    vae: VAE
    device: torch.device
    latent_channels: int = 4
    latent_scale: int = 8


def _family_vae_name(model_name: str) -> str:
    return "tiny-vae" if model_name.startswith("tiny") else "vae-sd"


def _build(name: str, device: torch.device, generator: torch.Generator | None):
    """The module for a registry name on `device`, its parameters drawn
    from `generator`, or left unset for a checkpoint to fill (None)."""
    with torch.device("meta"):
        module = create_model(name)
    module = module.to_empty(device=device)
    if generator is not None:
        random_init_(module, generator)
    return module.eval().requires_grad_(False)


def _seed_generators(seed: int, device: torch.device):
    """The generator of each module's random init: offset 0 the UNet, 1 the
    VAE, 2 and 3 the text towers, each seeded from `seed` on `device`."""

    def generator(offset: int) -> torch.Generator:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) * 16 + offset)
        return gen

    return generator


@contextlib.contextmanager
def _loading(path: str, what: str):
    """Logs a checkpoint file's bytes, seconds and rate once the block
    that reads it has finished."""
    log(f"loading checkpoint {path} for {what}")
    started = time.perf_counter()
    yield
    seconds = time.perf_counter() - started
    size = os.path.getsize(path)
    log(f"loaded {path}: {size} bytes in {seconds:.2f} s ({size / max(seconds, 1e-9) / 1e9:.2f} "
        "GB/s)")


def _load_te_checkpoint(name: str, module: TextEncoder) -> None:
    """Fill a text tower from `CDT_CHECKPOINT_DIR/<name>.*` (a standalone
    CLIP file), where one resolves."""
    path = sdc.find_checkpoint(name)
    if not path:
        return
    with _loading(path, name), sdc.open_checkpoint(path) as state_dict:
        sdc.load_clip_te_weights(state_dict, get_config(name), module)


def load_pipeline(model_name: str = "tiny-unet", seed: int = 0, device="cuda",
                  checkpoint: str | None = None) -> PipelineBundle:
    """Build a pipeline on `device` (the card unless the caller asks for
    the CPU). Its weights come from a single-file SD checkpoint where one
    resolves: `checkpoint`, else `CDT_CHECKPOINT_DIR/<model_name>.*`
    (models/sd_checkpoint.py::find_checkpoint); loading is strict. A text
    tower the file does not carry is filled from
    `CDT_CHECKPOINT_DIR/<encoder name>.*` where that exists. With no
    checkpoint the weights are seeded random: each module draws from its
    own generator, seeded from `seed`, on the target device."""
    if model_family(model_name) != "unet":
        raise NotImplementedError(
            f"{model_name!r}: only UNet-family pipelines are ported so far (ROADMAP.md, "
            "Queue 1 item 5: other model families)"
        )
    device = torch.device(device)
    if model_name in DUAL_TEXT_ENCODERS:
        te_name, te2_name = DUAL_TEXT_ENCODERS[model_name]
    elif model_name in DEFAULT_TEXT_ENCODERS:
        te_name, te2_name = DEFAULT_TEXT_ENCODERS[model_name], None
    else:
        te_name, te2_name = ("tiny-te" if model_name.startswith("tiny") else "clip-l"), None
    vae_name = _family_vae_name(model_name)
    ckpt_path = checkpoint or sdc.find_checkpoint(model_name)
    # a checkpoint fills every parameter: no random draw for it to replace
    generator = _seed_generators(seed, device)
    init = (lambda offset: None) if ckpt_path else generator

    unet = _build(model_name, device, init(0))
    if not ckpt_path:
        # zero-initialised as in the JAX package (its out_conv kernel_init):
        # an untrained UNet predicts eps = 0
        unet.out_conv.weight.zero_()
    vae = _build(vae_name, device, init(1))
    te = _build(te_name, device, init(2))
    te_cfg = get_config(te_name)
    vae_cfg = get_config(vae_name)
    te2 = tok2 = None
    if te2_name:
        te2 = _build(te2_name, device, init(3))
        te2_cfg = get_config(te2_name)
        tok2 = Tokenizer(max_length=te2_cfg.max_length, pad_id=te2_cfg.pad_token_id)

    bundle = PipelineBundle(
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
    supplied: set[str] = set()
    if ckpt_path:
        with _loading(ckpt_path, model_name), sdc.open_checkpoint(ckpt_path) as state_dict:
            sdc.load_sd_weights(state_dict, get_config(model_name), vae_cfg, te_cfg,
                                bundle.parts(),
                                te2_cfg=get_config(te2_name) if te2_name else None)
            supplied = sdc.supplied_towers(state_dict)
    # a separate text-encoder file fills a tower the checkpoint did not
    # carry (a checkpoint's own, fine-tuned towers win)
    for part, name in (("te", te_name), ("te2", te2_name)):
        if name and part not in supplied:
            _load_te_checkpoint(name, bundle.parts()[part])
    return bundle


def load_vae(vae_name: str = "vae-sd", seed: int = 0, device="cuda") -> VAEBundle:
    """A standalone VAE on `device`: real weights where a checkpoint
    resolves (`CDT_CHECKPOINT_DIR/<vae_name>.*`; a
    standalone file's bare `encoder.` / `decoder.` keys or a full
    checkpoint's `first_stage_model.*`), else the seeded random init
    load_pipeline gives its VAE at `seed`."""
    if model_family(vae_name) != "vae":
        raise ValueError(f"{vae_name!r} is not an image-VAE config (family "
                         f"{model_family(vae_name)!r}); use a vae-* registry name")
    device = torch.device(device)
    cfg = get_config(vae_name)
    path = sdc.find_checkpoint(vae_name)
    vae = _build(vae_name, device, None if path else _seed_generators(seed, device)(1))
    if path:
        with _loading(path, vae_name), sdc.open_checkpoint(path) as state_dict:
            sdc.load_vae_weights(state_dict, cfg, vae)
    return VAEBundle(vae=vae, device=device, latent_channels=cfg.latent_channels,
                     latent_scale=cfg.downscale)


# --- conditioning --------------------------------------------------------

def _encode_tower(encoder: TextEncoder, tokenizer: Tokenizer, texts: list[str], device,
                  skip_last: int | None):
    tokens = torch.as_tensor(tokenizer.encode_batch(texts), dtype=torch.long, device=device)
    return encoder(tokens, eos_id=tokenizer.eos_id, skip_last=skip_last)


@torch.no_grad()
def _encode_raw(bundle: PipelineBundle, texts: list[str], texts_2: list[str] | None = None):
    """Prompts → (hidden [B, T, context_dim], pooled [B, P]). Dual-tower
    bundles concatenate both hidden states on features and take the
    pooled vector from the second (projected) tower, which encodes
    `texts_2` where given (CLIPTextEncodeSDXL's text_g), else `texts`.
    The bundle's clip-skip applies to every tower."""
    hidden, pooled = _encode_tower(bundle.text_encoder, bundle.tokenizer, texts, bundle.device,
                                   bundle.clip_skip)
    if bundle.text_encoder_2 is not None:
        hidden2, pooled = _encode_tower(
            bundle.text_encoder_2, bundle.tokenizer_2, texts if texts_2 is None else texts_2,
            bundle.device, bundle.clip_skip
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


def encode_text_pooled_sdxl(bundle: PipelineBundle, texts_g: list[str], texts_l: list[str],
                            size_cond: tuple | None = None) -> Conditioning:
    """CLIPTextEncodeSDXL's encoding: `texts_l` through the first (CLIP-L)
    tower, `texts_g` through the second (CLIP-G), and `size_cond` (the six
    adm size ints) on the Conditioning. With one prompt for both it is
    `encode_text_pooled`."""
    if bundle.text_encoder_2 is None:
        raise ValueError(f"{bundle.model_name}: CLIPTextEncodeSDXL needs a dual-tower "
                         "(SDXL-layout) CLIP bundle")
    hidden, pooled = _encode_raw(bundle, texts_l, texts_g)
    return Conditioning(context=hidden, pooled=pooled, size_cond=size_cond)


# --- model fn ------------------------------------------------------------

def model_schedule_info(bundle: PipelineBundle) -> str:
    """The backbone's parameterization, which picks the sigma table and
    the noising rule: "eps" or "v" (SD2.x-768 class), both on the VP
    table."""
    param = get_config(bundle.model_name).parameterization
    smp.require_vp(param)
    return param


def _adm_vector(bundle: PipelineBundle, cond: Conditioning, x: torch.Tensor) -> torch.Tensor | None:
    """The UNet's `y`: pooled text, plus (real SDXL layout) six 256-d
    Fourier size embeddings of (orig_h, orig_w, crop_t, crop_l,
    target_h, target_w): the entry's `size_cond` (CLIPTextEncodeSDXL),
    else the latent's pixel size with zero crops, the KSampler default;
    repeated to x's batch."""
    adm = get_config(bundle.model_name).adm_in_channels
    if not adm or cond.pooled is None:
        return None
    pooled = cond.pooled
    if adm - pooled.shape[-1] == 6 * 256:
        if cond.size_cond is not None:
            vals = [float(v) for v in cond.size_cond]
        else:
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


def percent_converter(bundle: PipelineBundle):
    """The bundle's sampling-progress percent → sigma converter (the
    timestep windows of conditioning and ControlNet hints)."""
    param = model_schedule_info(bundle)

    def p2s(percent: float) -> float:
        return smp.percent_to_sigma(percent, param)

    return p2s


def _control_residual(cond: Conditioning, x: torch.Tensor, sigma_batch: torch.Tensor,
                      p2s) -> torch.Tensor | None:
    """The entry's ControlNet residual for latents x: the hint's features
    resized (linear) to the latent, broadcast to x's batch, scaled by the
    hint's strength; None without a hint, or outside its window."""
    if cond.control_hint is None or cond.control_net is None:
        return None
    if cond.control_range is not None and not smp.in_window(sigma_batch, cond.control_range,
                                                            p2s):
        return None  # the JAX package multiplies by a zero gate: h + 0
    feats = cond.control_net.encode(cond.control_hint)
    if feats.shape[1] != x.shape[1] or feats.shape[2] != x.shape[2]:
        feats = resize_image(feats, x.shape[1], x.shape[2], "bilinear")
    if feats.shape[0] == 1 and x.shape[0] > 1:
        feats = feats.expand((x.shape[0],) + tuple(feats.shape[1:]))
    return feats * cond.control_strength


def _make_model_fn(bundle: PipelineBundle, pag: bool = False, sag_capture: bool = False):
    """eps model function: VP input scaling, sigma → timestep, context
    broadcast to the latent batch, the adm vector and the ControlNet
    residual. A v-prediction backbone's output is converted to eps. `pag`
    runs the UNet's PAG pass (identity self-attention in the middle
    block). `sag_capture` changes what the function returns: (eps, the
    middle block's self-attention probabilities, (mid_h, mid_w)), the
    form `sag_cfg_model` consumes. The sigma batch may be on the host."""
    is_v = model_schedule_info(bundle) == "v"
    p2s = percent_converter(bundle)

    def model_fn(x: torch.Tensor, sigma_batch: torch.Tensor, cond):
        entry = cond if isinstance(cond, Conditioning) else None
        context = entry.context if entry is not None else cond
        if context.shape[0] != x.shape[0] and x.shape[0] % context.shape[0] == 0:
            context = context.repeat_interleave(x.shape[0] // context.shape[0], dim=0)
        y = control = None
        if entry is not None:
            y = _adm_vector(bundle, entry, x)
            control = _control_residual(entry, x, sigma_batch, p2s)
        t = smp.on_device(smp.sigma_to_timestep(sigma_batch), x)
        sig = smp.on_device(sigma_batch, x).reshape((-1,) + (1,) * (x.ndim - 1))
        c_in = 1.0 / torch.sqrt(sig**2 + 1.0)
        out = bundle.unet(x * c_in, t, context, y=y, control=control, pag=pag,
                          sag_capture=sag_capture)
        if sag_capture:
            out, probs, mid_hw = out
        if is_v:
            # with the VP scalings, denoised = x/(s^2+1) - v*s/sqrt(s^2+1);
            # exactly, for the sampler's denoised = x - s*eps:
            # eps = x*s/(s^2+1) + v/sqrt(s^2+1)
            out = x * (sig / (sig**2 + 1.0)) + out / torch.sqrt(sig**2 + 1.0)
        if sag_capture:
            return out.to(x.dtype), probs, mid_hw
        return out.to(x.dtype)

    return model_fn


def _guidance_patches(bundle: PipelineBundle) -> list[str]:
    """The guidance patch nodes applied to the bundle, by node name."""
    return [name for name, active in (
        ("RescaleCFG", bundle.cfg_rescale is not None),
        ("PerturbedAttentionGuidance", bundle.pag is not None),
        ("SelfAttentionGuidance", bundle.sag is not None),
    ) if active]


def reject_existing_guidance_patches(bundle: PipelineBundle, node_name: str) -> None:
    """A second guidance patch node on one model fails when the graph is
    built, naming the first: their compositions cannot combine."""
    existing = _guidance_patches(bundle)
    if existing:
        raise ValueError(f"{node_name} cannot combine with {existing[0]} on the same model")


def guided_model(bundle: PipelineBundle, cfg_scale: float):
    """CFG over the bundle's model (with the per-entry composition of
    multi-entry conditioning), plus the one guidance patch the bundle
    carries: PAG, SAG or RescaleCFG. A hand-built bundle with two
    raises."""
    patches = _guidance_patches(bundle)
    if len(patches) > 1:
        raise ValueError(f"guidance patches cannot combine on one model: {patches}")
    base_fn = _make_model_fn(bundle)
    p2s = percent_converter(bundle)
    if bundle.pag is not None:
        return smp.pag_cfg_model(base_fn, _make_model_fn(bundle, pag=True), cfg_scale,
                                 float(bundle.pag.scale), p2s=p2s)
    if bundle.sag is not None:
        return smp.sag_cfg_model(base_fn, _make_model_fn(bundle, sag_capture=True), cfg_scale,
                                 float(bundle.sag.scale), float(bundle.sag.blur_sigma), p2s=p2s)
    if bundle.cfg_rescale is not None:
        return smp.rescale_cfg_model(base_fn, cfg_scale, float(bundle.cfg_rescale), p2s=p2s)
    return smp.cfg_model(base_fn, cfg_scale, p2s=p2s)


# --- sampling --------------------------------------------------------------

def default_noise(seed: int, shape: tuple, device) -> torch.Tensor:
    """Standard-normal f32 initial noise from a generator on `device`
    seeded with `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


# the step-noise stream of a participant's seed (stream 0: initial noise)
STEP_STREAM = 1


def default_step_noise(seed: int, device) -> smp.StepNoise:
    """The stochastic samplers' step noise: standard normals drawn in turn
    from a generator on `device` seeded with stream_seed(seed,
    STEP_STREAM)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(smp.stream_seed(seed, STEP_STREAM))
    return smp.generator_step_noise(gen)


def _latents_and_noise(bundle: PipelineBundle, latents, noise, seed: int):
    latents = torch.as_tensor(latents).to(device=bundle.device, dtype=torch.float32)
    if noise is None:
        noise = default_noise(seed, tuple(latents.shape), bundle.device)
    noise = torch.as_tensor(noise).to(device=bundle.device, dtype=torch.float32)
    if noise.shape != latents.shape:
        raise ValueError(f"noise {tuple(noise.shape)} does not match latents {tuple(latents.shape)}")
    return latents, noise


def _masked_sample(bundle: PipelineBundle, cfg_scale: float, param: str, latents: torch.Tensor,
                   noise: torch.Tensor, x: torch.Tensor, sigmas: torch.Tensor, cond,
                   sampler: str, step_noise: smp.StepNoise, noise_mask) -> torch.Tensor:
    """Guidance, the inpainting pin where a noise mask is given, the
    trajectory (with `step_noise` for a stochastic sampler), and the mask
    composite: the sampling core of `img2img_latents` and
    `img2img_latents_advanced`."""
    model = guided_model(bundle, float(cfg_scale))
    if noise_mask is not None:
        mask = torch.clamp(torch.as_tensor(noise_mask).to(bundle.device, torch.float32), 0.0, 1.0)
        model = smp.masked_inpaint_model(model, param, latents, noise, mask)
    cond = tuple(c if isinstance(c, (list, tuple)) else as_conditioning(c) for c in cond)
    out = smp.sample(model, x, sigmas, cond, sampler, step_noise)
    if noise_mask is not None:
        out = out * mask + latents * (1.0 - mask)
    return out


@torch.no_grad()
def img2img_latents(
    bundle: PipelineBundle,
    latents: torch.Tensor,
    context_pos,
    context_neg,
    steps: int = 20,
    sampler: str = "euler",
    scheduler: str = "karras",
    cfg_scale: float = 7.0,
    denoise: float = 0.5,
    seed: int = 0,
    noise: torch.Tensor | None = None,
    noise_mask: torch.Tensor | None = None,
    step_noise: smp.StepNoise | None = None,
) -> torch.Tensor:
    """Latent-space img2img (the JAX package's `img2img_latents`): noise
    the latents to sigma[denoise], sample back down under CFG. From
    zero latents at denoise 1 this is txt2img's sampling. The contexts are
    Conditionings or bare [B, T, D] tensors. Returns f32 latents on the
    bundle's device. `noise` (the latents' shape) replaces
    `default_noise(seed, ...)`, `step_noise` `default_step_noise(seed,
    ...)`. `noise_mask` ([B, h, w, 1], 1 = regenerate) keeps the rest of
    the latents (inpainting)."""
    smp.check_sampler_names(sampler, scheduler)
    param = model_schedule_info(bundle)
    sigmas = smp.get_model_sigmas(param, scheduler, int(steps), denoise=float(denoise))
    latents, noise = _latents_and_noise(bundle, latents, noise, seed)
    x = smp.noise_latents(param, latents, noise, sigmas[0])
    return _masked_sample(bundle, cfg_scale, param, latents, noise, x, sigmas,
                          (context_pos, context_neg), sampler,
                          step_noise or default_step_noise(seed, bundle.device), noise_mask)


def advanced_window_sigmas(parameterization: str, scheduler: str, steps: int,
                           start_at_step: int, end_at_step: int,
                           force_full_denoise: bool) -> torch.Tensor:
    """KSamplerAdvanced's schedule: the full [steps+1] grid windowed to
    [start, end] (both clamped to the grid), with the last sigma forced
    to 0 when the caller wants a full denoise despite stopping early."""
    full = smp.get_model_sigmas(parameterization, scheduler, int(steps))
    start = min(max(int(start_at_step), 0), int(steps))
    end = min(max(int(end_at_step), start), int(steps))
    window = full[start:end + 1].clone()
    if force_full_denoise and window.shape[0] > 1:
        window[-1] = 0.0
    return window


@torch.no_grad()
def img2img_latents_advanced(
    bundle: PipelineBundle,
    latents: torch.Tensor,
    context_pos,
    context_neg,
    steps: int = 20,
    sampler: str = "euler",
    scheduler: str = "karras",
    cfg_scale: float = 7.0,
    seed: int = 0,
    start_at_step: int = 0,
    end_at_step: int = 10000,
    add_noise: bool = True,
    force_full_denoise: bool = True,
    noise_mask: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
    step_noise: smp.StepNoise | None = None,
) -> torch.Tensor:
    """KSamplerAdvanced's core: sample the [start_at_step, end_at_step]
    window of the full schedule. Without `add_noise` (the refine pass of
    a two-pass workflow) the trajectory starts from the latents as given,
    no initial noise is drawn and a masked pin uses zeros; a stochastic
    sampler still draws its step noise. Without `force_full_denoise` the
    output keeps the window's leftover noise."""
    smp.check_sampler_names(sampler, scheduler)
    param = model_schedule_info(bundle)
    window = advanced_window_sigmas(param, scheduler, steps, start_at_step, end_at_step,
                                    force_full_denoise)
    if add_noise:
        latents, noise = _latents_and_noise(bundle, latents, noise, seed)
        x = smp.noise_latents(param, latents, noise, window[0])
    else:
        latents = torch.as_tensor(latents).to(device=bundle.device, dtype=torch.float32)
        noise = torch.zeros_like(latents)
        x = latents
    if window.shape[0] < 2:
        # nothing to sample, but the mask still keeps its region
        if noise_mask is not None:
            mask = torch.clamp(torch.as_tensor(noise_mask).to(bundle.device, torch.float32),
                               0.0, 1.0)
            return x * mask + latents * (1.0 - mask)
        return x
    return _masked_sample(bundle, cfg_scale, param, latents, noise, x, window,
                          (context_pos, context_neg), sampler,
                          step_noise or default_step_noise(seed, bundle.device), noise_mask)


@torch.no_grad()
def txt2img(
    bundle: PipelineBundle,
    prompt: str,
    negative_prompt: str = "",
    height: int = 512,
    width: int = 512,
    steps: int = 20,
    sampler: str = "euler",
    scheduler: str = "karras",
    cfg_scale: float = 7.0,
    seed: int = 0,
    batch: int = 1,
    noise: torch.Tensor | None = None,
    step_noise: smp.StepNoise | None = None,
) -> torch.Tensor:
    """Text → [batch, H, W, 3] images in [0, 1]: `img2img_latents` from
    zero latents at denoise 1, then the VAE decode (the graph's
    EmptyLatentImage → KSampler → VAEDecode)."""
    pos = encode_text_pooled(bundle, [prompt] * batch)
    neg = encode_text_pooled(bundle, [negative_prompt] * batch)
    latents = torch.zeros(
        (batch, height // bundle.latent_scale, width // bundle.latent_scale,
         bundle.latent_channels), device=bundle.device,
    )
    z = img2img_latents(bundle, latents, pos, neg, steps, sampler, scheduler, cfg_scale,
                        1.0, seed, noise, step_noise=step_noise)
    return bundle.vae.decode(z)
