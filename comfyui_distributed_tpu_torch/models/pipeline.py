"""The model bundle, text conditioning and the guided model function.

Counterpart of the parts of comfyui_distributed_tpu/models/pipeline.py
that the ported paths run: `load_pipeline` (a single-file SD1.x, SD2.x
or SDXL checkpoint, a Flux file set or an SD3 file, where one resolves,
else seeded random init), `load_vae`, and the component loaders
`load_unet` and `load_clip` (UNETLoader, CLIPLoader, DualCLIPLoader,
TripleCLIPLoader); single-tower (SD1.5, SD2.1), dual-tower (SDXL), Flux
(T5 context, CLIP pooled) and SD3 (CLIP-L and CLIP-G on features, padded
to the T5 width and joined to the T5's states on the sequence; pooled
CLIP-L ++ CLIP-G) text encoding with clip-skip, the model function (eps
or v prediction with the adm vector of pooled text and six Fourier size
embeddings, or rectified flow: t = sigma, no input scaling, the
distilled guidance and Kontext's reference latents for Flux, the pooled
vector and skip-layer guidance's skipped blocks for SD3), CFG with the
PAG patch, and `img2img_latents` / `img2img_latents_advanced`
(KSamplerAdvanced's window) / `txt2img`, each with the inpainting noise
mask. Modules hold their own parameters, so the functions take the
bundle where the JAX ones take (bundle, params). The model function also
takes ControlNet hints (gated by their sampling window), the SDXL size
override of CLIPTextEncodeSDXL, InpaintModelConditioning's concat
channels (a 9-channel UNet's extra input) and SAG's capture pass;
`guided_model` composes CFG with one guidance patch: PAG, SAG,
RescaleCFG, PerpNeg, DualCFG or SD3.5's skip-layer guidance. `sample_custom_sigmas` runs an explicit
sigma grid (SamplerCustom and SamplerCustomAdvanced).

Node patches (CLIPSetLastLayer's clip-skip, PerturbedAttentionGuidance's
PAGSpec, SelfAttentionGuidance's SAGSpec, RescaleCFG's multiplier,
FreeU's UNet config, PerpNegGuider's PerpNegSpec, DualCFGGuider's
DualCFGSpec, SkipLayerGuidanceSD3's SLGSpec and ModelSamplingFlux's and
ModelSamplingSD3's shift) return a new bundle through
`dataclasses.replace`:
the modules and their parameters are shared, the bundle a graph executor
caches is never changed.

Noise: `jax.random` and `torch.Generator` give different numbers for one
seed, so the samplers take a `noise` tensor (the initial noise) and a
`step_noise` source (the stochastic samplers' draws); the tests hand
them the JAX package's own. As the JAX package splits its key, the two
are separate streams of the participant's seed: the initial noise
standard normals from a generator seeded with `seed`, the step noise
from one seeded with `stream_seed(seed, STEP_STREAM)`, both on the
bundle's device. A batch whose seed behaviour is fixed
(LatentBatchSeedBehavior) repeats batch row 0's initial noise on every
row, as the JAX package does.
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
from .mmdit import MMDiT
from .sd3 import SD3MMDiT
from .registry import (
    DEFAULT_TEXT_ENCODERS,
    DUAL_TEXT_ENCODERS,
    HIDDEN_POOLED_ENCODERS,
    TRIPLE_TEXT_ENCODERS,
    create_model,
    get_config,
    model_family,
)
from .t5_encoder import T5Encoder, T5Tokenizer
from .text_encoder import TextEncoder, Tokenizer
from .unet import UNet
from .vae import VAE

# the families load_pipeline builds a bundle around, as the JAX package's
# does (a video DiT there takes the family VAE and a CLIP tower; its own
# stack is models/video_pipeline.py); a part (a VAE, an encoder, a vision
# tower) raises the JAX package's AttributeError
PORTED_FAMILIES = ("unet", "mmdit", "sd3", "dit")


@dataclasses.dataclass
class PipelineBundle:
    """A checkpoint: diffusion backbone (UNet, Flux MMDiT or SD3 MMDiT) +
    VAE + text encoder(s), on one device. A component loader's bundle
    leaves out what it does not load (UNETLoader: no VAE or encoders; the
    CLIP loaders: no backbone or VAE). A Flux bundle's first encoder is
    the T5 (context), its second the CLIP (pooled); an SD3 bundle's are
    CLIP-L, CLIP-G and the T5 (none in DualCLIPLoader's sd3 layout)."""

    model_name: str
    unet: UNet | MMDiT | SD3MMDiT | None
    vae: VAE | None
    text_encoder: TextEncoder | T5Encoder | None
    tokenizer: Tokenizer | T5Tokenizer | None
    device: torch.device
    latent_channels: int = 4
    latent_scale: int = 8  # spatial down factor of the VAE
    # SDXL-class second encoder (context concat + pooled source)
    text_encoder_2: TextEncoder | None = None
    tokenizer_2: Tokenizer | None = None
    te_name: str | None = None
    te2_name: str | None = None
    # SD3-class third encoder (the T5 of the triple layout)
    text_encoder_3: T5Encoder | None = None
    tokenizer_3: T5Tokenizer | None = None
    te3_name: str | None = None
    # clip-skip (CLIPSetLastLayer): how many final blocks the towers'
    # hidden output leaves out; None = each tower's configured default
    clip_skip: int | None = None
    # PerturbedAttentionGuidance patch (UNet family); None = no PAG pass
    pag: "PAGSpec | None" = None
    # SelfAttentionGuidance patch (UNet family); None = no SAG
    sag: "SAGSpec | None" = None
    # RescaleCFG patch: the std-rescale multiplier; None = plain CFG
    cfg_rescale: float | None = None
    # DualCFGGuider: positives are (cond1, cond2); None = plain CFG
    dual_cfg: "DualCFGSpec | None" = None
    # PerpNegGuider: positives are (positive, negative), the negative
    # slot holds the empty conditioning; None = plain CFG
    perp_neg: "PerpNegSpec | None" = None
    # ModelSamplingDiscrete: "eps" or "v" in place of the config's
    parameterization_override: str | None = None
    # ModelSamplingFlux / ModelSamplingSD3: the flow schedule's shift in
    # place of the config's
    flow_shift_override: float | None = None
    # SkipLayerGuidanceSD3 (SD3 family); None = no skip pass
    slg: "SLGSpec | None" = None

    def parts(self) -> dict[str, torch.nn.Module]:
        """The modules the bundle holds, by checkpoint part: unet, vae, te,
        te2 and te3."""
        parts = {"unet": self.unet, "vae": self.vae, "te": self.text_encoder,
                 "te2": self.text_encoder_2, "te3": self.text_encoder_3}
        return {part: module for part, module in parts.items() if module is not None}


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


@dataclasses.dataclass(frozen=True)
class PerpNegSpec:
    """PerpNegGuider: only the part of the negative orthogonal to the
    positive pushes away (ops/samplers.py::perp_neg_model)."""

    neg_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class DualCFGSpec:
    """DualCFGGuider: cond2 guided against the negative at
    cfg_cond2_negative; the outer cfg_conds is the sampler's cfg
    (ops/samplers.py::dual_cfg_model has the regular and nested forms)."""

    cfg_cond2_negative: float
    nested: bool = False


@dataclasses.dataclass(frozen=True)
class SLGSpec:
    """Skip-layer guidance (SkipLayerGuidanceSD3): the guided result gains
    scale * (cond - cond with the joint blocks `layers` skipped) over a
    sampling-progress window."""

    layers: tuple
    scale: float = 3.0
    start_percent: float = 0.01
    end_percent: float = 0.15


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
    """The default VAE of a diffusion model's family."""
    tiny = model_name.startswith("tiny")
    family = model_family(model_name)
    if family == "mmdit":
        return "tiny-vae-flux" if tiny else "vae-flux"
    if family == "sd3":
        return "tiny-vae-sd3" if tiny else "vae-sd3"
    return "tiny-vae" if tiny else "vae-sd"


def _require_ported_family(model_name: str) -> str:
    family = model_family(model_name)
    if family not in PORTED_FAMILIES:
        raise AttributeError(
            f"'{type(get_config(model_name)).__name__}' object has no attribute 'context_dim': "
            f"{model_name!r} ({family} family) is a part of a pipeline, not a diffusion "
            "backbone")
    return family


def _tokenizer(name: str):
    """The tokenizer of a registry encoder: T5's (folded BPE ids) or CLIP's."""
    cfg = get_config(name)
    if model_family(name) == "t5_encoder":
        return T5Tokenizer(max_length=cfg.max_length, vocab_size=cfg.vocab_size)
    return Tokenizer(max_length=cfg.max_length, pad_id=cfg.pad_token_id)


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
    VAE, 2, 3 and 4 the text towers, each seeded from `seed` on `device`."""

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


def _load_te_checkpoint(name: str, module: TextEncoder | T5Encoder) -> None:
    """Fill a text tower from `CDT_CHECKPOINT_DIR/<name>.*` (a standalone
    CLIP or T5 encoder file), where one resolves."""
    path = sdc.find_checkpoint(name)
    if not path:
        return
    with _loading(path, name), sdc.open_checkpoint(path) as state_dict:
        if model_family(name) == "t5_encoder":
            sdc.load_t5_weights(state_dict, get_config(name), module)
        else:
            sdc.load_clip_te_weights(state_dict, get_config(name), module)


def load_pipeline(model_name: str = "tiny-unet", seed: int = 0, device="cuda",
                  checkpoint: str | None = None) -> PipelineBundle:
    """Build a pipeline on `device` (the card unless the caller asks for
    the CPU). Its weights come from a single-file checkpoint where one
    resolves: `checkpoint`, else `CDT_CHECKPOINT_DIR/<model_name>.*`
    (models/sd_checkpoint.py::find_checkpoint); loading is strict, and a
    file whose UNet takes 9 input channels loads as the family's
    inpainting model (`sniff_model_name`). A Flux or SD3 file fills the
    parts it carries (a published transformer file: the MMDiT only). A text tower
    the file does not carry is filled from
    `CDT_CHECKPOINT_DIR/<encoder name>.*` where that exists. With no
    checkpoint the weights are seeded random: each module draws from its
    own generator, seeded from `seed`, on the target device."""
    device = torch.device(device)
    ckpt_path = checkpoint or sdc.find_checkpoint(model_name)
    with contextlib.ExitStack() as stack:
        state_dict = None
        if ckpt_path:
            stack.enter_context(_loading(ckpt_path, model_name))
            state_dict = stack.enter_context(sdc.open_checkpoint(ckpt_path))
            # a 9-channel conv_in is the inpainting UNet of the family
            model_name = sdc.sniff_model_name(state_dict, model_name)
        bundle, supplied = _assemble(model_name, device, seed, state_dict)
    # a separate text-encoder file fills a tower the checkpoint did not
    # carry (a checkpoint's own, fine-tuned towers win)
    for part, name in (("te", bundle.te_name), ("te2", bundle.te2_name),
                       ("te3", bundle.te3_name)):
        if name and part not in supplied:
            _load_te_checkpoint(name, bundle.parts()[part])
    return bundle


def _assemble(model_name: str, device: torch.device, seed: int, state_dict):
    """load_pipeline's bundle of `model_name` and the towers the checkpoint
    supplied: filled from `state_dict` (an open single-file checkpoint)
    where given, else seeded."""
    family = _require_ported_family(model_name)
    te3_name = None
    if model_name in TRIPLE_TEXT_ENCODERS:
        te_name, te2_name, te3_name = TRIPLE_TEXT_ENCODERS[model_name]
    elif model_name in HIDDEN_POOLED_ENCODERS:
        te_name, te2_name = HIDDEN_POOLED_ENCODERS[model_name]
    elif model_name in DUAL_TEXT_ENCODERS:
        te_name, te2_name = DUAL_TEXT_ENCODERS[model_name]
    elif model_name in DEFAULT_TEXT_ENCODERS:
        te_name, te2_name = DEFAULT_TEXT_ENCODERS[model_name], None
    else:
        te_name, te2_name = ("tiny-te" if model_name.startswith("tiny") else "clip-l"), None
    vae_name = _family_vae_name(model_name)
    # a checkpoint fills every parameter: no random draw for it to replace;
    # a Flux or SD3 file may carry only some parts, and the others are seeded
    generator = _seed_generators(seed, device)
    init = (lambda offset: None) if state_dict is not None and family == "unet" else generator

    unet = _build(model_name, device, init(0))
    if state_dict is None and family == "unet":
        # zero-initialised as in the JAX package (its out_conv kernel_init):
        # an untrained UNet predicts eps = 0
        unet.out_conv.weight.zero_()
    vae = _build(vae_name, device, init(1))
    te = _build(te_name, device, init(2))
    vae_cfg = get_config(vae_name)
    te2 = te3 = None
    if te2_name:
        te2 = _build(te2_name, device, init(3))
    if te3_name:
        te3 = _build(te3_name, device, init(4))

    bundle = PipelineBundle(
        model_name=model_name,
        unet=unet,
        vae=vae,
        text_encoder=te,
        tokenizer=_tokenizer(te_name),
        device=device,
        latent_channels=vae_cfg.latent_channels,
        latent_scale=vae_cfg.downscale,
        text_encoder_2=te2,
        tokenizer_2=_tokenizer(te2_name) if te2_name else None,
        te_name=te_name,
        te2_name=te2_name,
        text_encoder_3=te3,
        tokenizer_3=_tokenizer(te3_name) if te3_name else None,
        te3_name=te3_name,
    )
    supplied: set[str] = set()
    if state_dict is not None and family == "sd3":
        supplied = sdc.load_sd3_weights(state_dict, get_config(model_name), vae_cfg,
                                        get_config(te_name), bundle.parts(),
                                        te2_cfg=get_config(te2_name),
                                        te3_cfg=get_config(te3_name))
    elif state_dict is not None and family == "mmdit":
        supplied = sdc.load_flux_weights(state_dict, get_config(model_name), vae_cfg,
                                         get_config(te_name), bundle.parts(),
                                         te2_cfg=get_config(te2_name))
    elif state_dict is not None:
        sdc.load_sd_weights(state_dict, get_config(model_name), vae_cfg, get_config(te_name),
                            bundle.parts(), te2_cfg=get_config(te2_name) if te2_name else None)
        supplied = sdc.supplied_towers(state_dict)
    return bundle, supplied


def load_unet(model_name: str, seed: int = 0, device="cuda",
              checkpoint: str | None = None) -> PipelineBundle:
    """A backbone-only bundle (UNETLoader: Flux and SD3.5 ship their
    transformer as a file of its own, the VAE and encoders come from
    VAELoader and the CLIP loaders). Weights from `checkpoint`, else
    `CDT_CHECKPOINT_DIR/<model_name>.*` (bare Flux or SD3 keys or the
    `model.diffusion_model.` layout), else the seeded init load_pipeline
    gives its backbone at `seed`. The latent geometry is the family VAE's."""
    family = model_family(model_name)
    if family not in ("unet", "mmdit", "sd3"):
        raise ValueError(f"{model_name!r} (family {family!r}) is not an image diffusion "
                         "backbone; UNETLoader loads unet/mmdit/sd3 models")
    _require_ported_family(model_name)
    device = torch.device(device)
    path = checkpoint or sdc.find_checkpoint(model_name)
    unet = _build(model_name, device, None if path else _seed_generators(seed, device)(0))
    if path:
        with _loading(path, model_name), sdc.open_checkpoint(path) as state_dict:
            sdc.load_diffusion_weights(state_dict, get_config(model_name), unet, family)
    elif family == "unet":
        unet.out_conv.weight.zero_()
    vae_cfg = get_config(_family_vae_name(model_name))
    return PipelineBundle(model_name=model_name, unet=unet, vae=None, text_encoder=None,
                          tokenizer=None, device=device,
                          latent_channels=vae_cfg.latent_channels,
                          latent_scale=vae_cfg.downscale)


def _order_clip_towers(names: list[str]) -> list[str]:
    """(CLIP-L, CLIP-G) by tower width (G is the wider), so the sdxl and
    sd3 layouts take their two names in either order; equal widths keep
    it."""
    if len(names) == 2 and get_config(names[0]).width > get_config(names[1]).width:
        return [names[1], names[0]]
    return list(names)


# the CLIP loaders' layouts → the registry model whose conditioning
# composition the bundle applies (None: the first encoder's own)
_CLIP_LAYOUT_MODELS = {"sd": None, "sdxl": None, "flux": ("tiny-flux", "flux-dev"),
                       "sd3": ("tiny-sd3", "sd3-medium")}


def load_clip(te_names: list[str], layout: str = "sd", seed: int = 0,
              device="cuda") -> PipelineBundle:
    """An encoder-only bundle (CLIPLoader, DualCLIPLoader,
    TripleCLIPLoader): each encoder by registry name, its weights from
    `CDT_CHECKPOINT_DIR/<name>.*` where that resolves, else seeded as
    load_pipeline seeds its towers (the first at generator offset 2, the
    second at 3, the third at 4). `layout`:

      sd    one CLIP tower (hidden and pooled);
      sdxl  CLIP-L + CLIP-G, either order: context concatenated on
            features, pooled from G;
      flux  one T5 and one CLIP, either order: the T5's hidden states,
            the CLIP's pooled vector;
      sd3   CLIP-L + CLIP-G (either order) and at most one T5: the SD3
            composition; without a T5 the CLIP sequence alone, padded to
            the backbone's context width."""
    names = [str(n) for n in te_names]
    expected = {"sd": (1,), "sdxl": (2,), "flux": (2,), "sd3": (2, 3)}
    if layout not in expected:
        raise ValueError(f"unknown CLIP layout {layout!r}; use {sorted(expected)}")
    if len(names) not in expected[layout]:
        raise ValueError(f"layout {layout!r} takes {' or '.join(map(str, expected[layout]))} "
                         f"encoder name(s), got {names}")
    t5s = [n for n in names if model_family(n) == "t5_encoder"]
    clips = [n for n in names if model_family(n) != "t5_encoder"]
    if layout == "flux":
        if len(t5s) != 1 or len(clips) != 1:
            raise ValueError(f"flux layout needs one T5-family and one CLIP-family encoder, "
                             f"got {names}")
        ordered = [t5s[0], clips[0]]  # te = T5, te2 = CLIP
    elif layout == "sd3":
        if len(clips) != 2 or len(t5s) > 1:
            raise ValueError(f"sd3 layout needs two CLIP-family encoders and at most one T5, "
                             f"got {names}")
        ordered = _order_clip_towers(clips) + t5s  # te = L, te2 = G [, te3 = T5]
    else:
        if t5s:
            raise ValueError(f"layout {layout!r} takes CLIP-family encoders only, got {names}")
        ordered = _order_clip_towers(names) if layout == "sdxl" else names
    models = _CLIP_LAYOUT_MODELS[layout]
    if models is None:
        bundle_name = ordered[0]
    else:
        bundle_name = models[0] if all(n.startswith("tiny") for n in ordered) else models[1]
    device = torch.device(device)
    generator = _seed_generators(seed, device)
    encoders = []
    for i, name in enumerate(ordered):
        path = sdc.find_checkpoint(name)
        module = _build(name, device, None if path else generator(2 + i))
        _load_te_checkpoint(name, module)
        encoders.append(module)
    # the slots a layout leaves empty: te2 (sd), te3 (all but sd3's triple)
    names = ordered + [None] * (3 - len(ordered))
    encoders += [None] * (3 - len(encoders))
    tokenizers = [_tokenizer(name) if name else None for name in names]
    return PipelineBundle(
        model_name=bundle_name, unet=None, vae=None, device=device,
        text_encoder=encoders[0], tokenizer=tokenizers[0], te_name=names[0],
        text_encoder_2=encoders[1], tokenizer_2=tokenizers[1], te2_name=names[1],
        text_encoder_3=encoders[2], tokenizer_3=tokenizers[2], te3_name=names[2],
    )


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
def _encode_flux_parts(bundle: PipelineBundle, texts_t5: list[str], texts_clip: list[str]):
    """The Flux layout: the T5's hidden states are the context, the CLIP
    tower's pooled vector the pooled one; no concat, no padding."""
    if bundle.text_encoder_2 is None or bundle.tokenizer_2 is None:
        raise ValueError(f"{bundle.model_name}: Flux bundles need text_encoder_2/tokenizer_2 "
                         "(the CLIP pooled source)")
    tokens = torch.as_tensor(bundle.tokenizer.encode_batch(texts_t5), dtype=torch.long,
                             device=bundle.device)
    hidden, _ = bundle.text_encoder(tokens)
    _, pooled = _encode_tower(bundle.text_encoder_2, bundle.tokenizer_2, texts_clip,
                              bundle.device, bundle.clip_skip)
    return hidden, pooled


@torch.no_grad()
def _encode_sd3(bundle: PipelineBundle, texts: list[str]):
    """The SD3 layout: CLIP-L's and CLIP-G's hidden states concatenated on
    features, zero-padded to the T5's width, then joined to the T5's
    states on the sequence; pooled = CLIP-L's (projected) pooled ++
    CLIP-G's. Without a T5 (DualCLIPLoader type sd3) the CLIP sequence
    alone, padded to the backbone's context width."""
    if bundle.text_encoder_2 is None:
        raise ValueError(f"{bundle.model_name}: sd3 bundles need at least the two CLIP encoders "
                         "(CLIP-L, CLIP-G)")
    h_l, p_l = _encode_tower(bundle.text_encoder, bundle.tokenizer, texts, bundle.device,
                             bundle.clip_skip)
    h_g, p_g = _encode_tower(bundle.text_encoder_2, bundle.tokenizer_2, texts, bundle.device,
                             bundle.clip_skip)
    hidden = torch.cat([h_l.float(), h_g.float()], dim=-1)
    h_t5 = None
    if bundle.text_encoder_3 is not None:
        tokens = torch.as_tensor(bundle.tokenizer_3.encode_batch(texts), dtype=torch.long,
                                 device=bundle.device)
        h_t5 = bundle.text_encoder_3(tokens)[0].float()
        width = h_t5.shape[-1]
    else:
        width = get_config(bundle.model_name).context_dim
    if hidden.shape[-1] < width:
        hidden = torch.nn.functional.pad(hidden, (0, width - hidden.shape[-1]))
    if h_t5 is not None:
        hidden = torch.cat([hidden, h_t5], dim=1)
    return hidden, torch.cat([p_l.float(), p_g.float()], dim=-1)


@torch.no_grad()
def _encode_raw(bundle: PipelineBundle, texts: list[str], texts_2: list[str] | None = None):
    """Prompts → (hidden [B, T, context_dim], pooled [B, P]). Flux bundles
    take `_encode_flux_parts`, SD3 bundles `_encode_sd3` (but for
    CLIPTextEncodeSDXL's two prompts, which take the dual-tower path, as
    in the JAX package). Dual-tower bundles concatenate both hidden
    states on features and take the pooled vector from the second
    (projected) tower, which encodes `texts_2` where given
    (CLIPTextEncodeSDXL's text_g), else `texts`. The bundle's clip-skip
    applies to every CLIP tower."""
    family = model_family(bundle.model_name)
    if family == "mmdit":
        return _encode_flux_parts(bundle, texts, texts)
    if family == "sd3" and texts_2 is None:
        return _encode_sd3(bundle, texts)
    hidden, pooled = _encode_tower(bundle.text_encoder, bundle.tokenizer, texts, bundle.device,
                                   bundle.clip_skip)
    if bundle.text_encoder_2 is not None:
        hidden2, pooled = _encode_tower(
            bundle.text_encoder_2, bundle.tokenizer_2, texts if texts_2 is None else texts_2,
            bundle.device, bundle.clip_skip
        )
        hidden = torch.cat([hidden.float(), hidden2.float()], dim=-1)
    ctx_dim = getattr(get_config(bundle.model_name), "context_dim", hidden.shape[-1])
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


def encode_text_pooled_flux(bundle: PipelineBundle, texts_t5: list[str], texts_clip: list[str],
                            guidance: float | None = None) -> Conditioning:
    """CLIPTextEncodeFlux's encoding: `texts_t5` through the T5 (context),
    `texts_clip` through the CLIP tower (pooled), and the distilled
    guidance on the Conditioning (FluxGuidance's slot). With one prompt
    for both and no guidance it is `encode_text_pooled`."""
    if model_family(bundle.model_name) != "mmdit":
        raise ValueError(f"{bundle.model_name}: CLIPTextEncodeFlux needs a Flux-layout "
                         "(mmdit) bundle")
    hidden, pooled = _encode_flux_parts(bundle, texts_t5, texts_clip)
    return Conditioning(context=hidden, pooled=pooled,
                        guidance=None if guidance is None else float(guidance))


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
    table, or "flow" (Flux, SD3); ModelSamplingDiscrete's override where
    it is set."""
    param = bundle.parameterization_override or get_config(bundle.model_name).parameterization
    smp.require_parameterization(param)
    return param


def flow_shift(bundle: PipelineBundle) -> float:
    """The flow schedule's shift: ModelSamplingFlux's or ModelSamplingSD3's
    override, else the config's (3.0 where a config has none)."""
    if bundle.flow_shift_override is not None:
        return float(bundle.flow_shift_override)
    return float(getattr(get_config(bundle.model_name), "flow_shift", 3.0))


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
    param, shift = model_schedule_info(bundle), flow_shift(bundle)

    def p2s(percent: float) -> float:
        return smp.percent_to_sigma(percent, param, shift)

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


def _concat_channels(concat: torch.Tensor, x_in: torch.Tensor) -> torch.Tensor:
    """InpaintModelConditioning's channels for the scaled latents x_in:
    repeated to its batch and resized (linear) to its grid. They join
    after the VP input scaling: only the noisy latents are scaled."""
    extra = concat.to(device=x_in.device, dtype=x_in.dtype)
    if extra.shape[0] != x_in.shape[0]:
        extra = extra.repeat_interleave(x_in.shape[0] // extra.shape[0], dim=0)
    if tuple(extra.shape[1:3]) != tuple(x_in.shape[1:3]):
        extra = resize_image(extra, x_in.shape[1], x_in.shape[2], "bilinear").to(x_in.dtype)
    return extra


def _flow_model_fn(bundle: PipelineBundle, skip_layers: tuple = ()):
    """The rectified-flow (Flux, SD3) model function: t is sigma, no input
    scaling, the velocity is eps under the samplers' contract; the
    entry's pooled vector, distilled guidance (None: the model's default)
    and Kontext's reference latents go to the MMDiT, and an SD3 MMDiT
    skips the joint blocks `skip_layers` (skip-layer guidance's pass).
    ControlNet hints and concat channels raise: the families have no
    input for them."""
    skip = {"skip_layers": tuple(skip_layers)} if skip_layers else {}

    def model_fn(x: torch.Tensor, sigma_batch: torch.Tensor, cond):
        entry = cond if isinstance(cond, Conditioning) else None
        context = entry.context if entry is not None else cond
        if context.shape[0] != x.shape[0] and x.shape[0] % context.shape[0] == 0:
            context = context.repeat_interleave(x.shape[0] // context.shape[0], dim=0)
        y = g = refs = None
        if entry is not None:
            if entry.control_hint is not None and entry.control_net is not None:
                raise ValueError("ControlNet conditioning is not supported for Flux-class models "
                                 "(Flux ControlNets are a separate architecture)")
            if entry.concat_latent is not None:
                raise ValueError("concat-channel inpaint conditioning (InpaintModelConditioning) "
                                 "applies to SD-class inpaint UNets; flow-family models have no "
                                 "c_concat input")
            y = _adm_vector(bundle, entry, x)
            if entry.guidance is not None:
                g = torch.full((x.shape[0],), float(entry.guidance), dtype=torch.float32,
                               device=x.device)
            if entry.reference_latents:
                refs = [r.to(device=x.device, dtype=x.dtype) for r in entry.reference_latents]
        out = bundle.unet(x, smp.on_device(sigma_batch, x), context, y=y, guidance=g,
                          ref_latents=refs, **skip)
        return out.to(x.dtype)

    return model_fn


def _make_model_fn(bundle: PipelineBundle, pag: bool = False, sag_capture: bool = False,
                   skip_layers: tuple = ()):
    """eps model function: VP input scaling, sigma → timestep, context
    broadcast to the latent batch, the adm vector and the ControlNet
    residual, and an entry's concat channels joined to the scaled input
    (a 9-channel inpaint UNet). A v-prediction backbone's output is
    converted to eps. `pag`
    runs the UNet's PAG pass (identity self-attention in the middle
    block). `sag_capture` changes what the function returns: (eps, the
    middle block's self-attention probabilities, (mid_h, mid_w)), the
    form `sag_cfg_model` consumes. The sigma batch may be on the host.
    A flow model takes `_flow_model_fn`, with `skip_layers`."""
    param = model_schedule_info(bundle)
    if param == "flow":
        return _flow_model_fn(bundle, skip_layers)
    is_v = param == "v"
    p2s = percent_converter(bundle)

    def model_fn(x: torch.Tensor, sigma_batch: torch.Tensor, cond):
        entry = cond if isinstance(cond, Conditioning) else None
        context = entry.context if entry is not None else cond
        if context.shape[0] != x.shape[0] and x.shape[0] % context.shape[0] == 0:
            context = context.repeat_interleave(x.shape[0] // context.shape[0], dim=0)
        y = control = None
        if entry is not None:
            if entry.reference_latents:
                raise ValueError("reference latents are a Flux-Kontext capability; this model "
                                 "family has no reference token path")
            y = _adm_vector(bundle, entry, x)
            control = _control_residual(entry, x, sigma_batch, p2s)
        t = smp.on_device(smp.sigma_to_timestep(sigma_batch), x)
        sig = smp.on_device(sigma_batch, x).reshape((-1,) + (1,) * (x.ndim - 1))
        c_in = 1.0 / torch.sqrt(sig**2 + 1.0)
        x_in = x * c_in
        if entry is not None and entry.concat_latent is not None:
            x_in = torch.cat([x_in, _concat_channels(entry.concat_latent, x_in)], dim=-1)
        out = bundle.unet(x_in, t, context, y=y, control=control, pag=pag,
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
        ("SkipLayerGuidanceSD3", bundle.slg is not None),
        ("RescaleCFG", bundle.cfg_rescale is not None),
        ("DualCFGGuider", bundle.dual_cfg is not None),
        ("PerturbedAttentionGuidance", bundle.pag is not None),
        ("SelfAttentionGuidance", bundle.sag is not None),
        ("PerpNegGuider", bundle.perp_neg is not None),
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
    carries: PAG, SAG, RescaleCFG, PerpNeg or DualCFG (these two take
    their three conditionings as ((a, b), c)) or skip-layer guidance. A
    hand-built bundle with two raises."""
    patches = _guidance_patches(bundle)
    if len(patches) > 1:
        raise ValueError(f"guidance patches cannot combine on one model: {patches}")
    base_fn = _make_model_fn(bundle)
    p2s = percent_converter(bundle)
    if bundle.dual_cfg is not None:
        return smp.dual_cfg_model(base_fn, cfg_scale, float(bundle.dual_cfg.cfg_cond2_negative),
                                  p2s=p2s, nested=bool(bundle.dual_cfg.nested))
    if bundle.perp_neg is not None:
        return smp.perp_neg_model(base_fn, cfg_scale, float(bundle.perp_neg.neg_scale), p2s=p2s)
    if bundle.pag is not None:
        return smp.pag_cfg_model(base_fn, _make_model_fn(bundle, pag=True), cfg_scale,
                                 float(bundle.pag.scale), p2s=p2s)
    if bundle.sag is not None:
        return smp.sag_cfg_model(base_fn, _make_model_fn(bundle, sag_capture=True), cfg_scale,
                                 float(bundle.sag.scale), float(bundle.sag.blur_sigma), p2s=p2s)
    if bundle.cfg_rescale is not None:
        return smp.rescale_cfg_model(base_fn, cfg_scale, float(bundle.cfg_rescale), p2s=p2s)
    if bundle.slg is not None:
        slg = bundle.slg
        return smp.slg_cfg_model(base_fn, _make_model_fn(bundle, skip_layers=slg.layers),
                                 cfg_scale, float(slg.scale), p2s(slg.start_percent),
                                 p2s(slg.end_percent), p2s=p2s)
    return smp.cfg_model(base_fn, cfg_scale, p2s=p2s)


# --- sampling --------------------------------------------------------------

def default_noise(seed: int, shape: tuple, device) -> torch.Tensor:
    """Standard-normal f32 initial noise from a generator on `device`
    seeded with `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def batch_noise(seed: int, shape: tuple, device, fixed: bool = False) -> torch.Tensor:
    """The initial noise of a batch: `default_noise` of its shape, or
    with `fixed` (LatentBatchSeedBehavior "fixed") row 0's noise on
    every row."""
    if not fixed:
        return default_noise(seed, shape, device)
    one = default_noise(seed, (1,) + tuple(shape[1:]), device)
    return one.expand(tuple(shape)).contiguous()


# the step-noise stream of a participant's seed (stream 0: initial noise)
STEP_STREAM = 1


def default_step_noise(seed: int, device) -> smp.StepNoise:
    """The stochastic samplers' step noise: standard normals drawn in turn
    from a generator on `device` seeded with stream_seed(seed,
    STEP_STREAM)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(smp.stream_seed(seed, STEP_STREAM))
    return smp.generator_step_noise(gen)


def _latents_and_noise(bundle: PipelineBundle, latents, noise, seed: int, fixed: bool = False):
    latents = torch.as_tensor(latents).to(device=bundle.device, dtype=torch.float32)
    if noise is None:
        noise = batch_noise(seed, tuple(latents.shape), bundle.device, fixed)
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
    out = smp.sample(model, x, sigmas, cond, sampler, step_noise, flow=param == "flow")
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
    batch_fixed_noise: bool = False,
) -> torch.Tensor:
    """Latent-space img2img (the JAX package's `img2img_latents`): noise
    the latents to sigma[denoise], sample back down under CFG. From
    zero latents at denoise 1 this is txt2img's sampling. The contexts are
    Conditionings or bare [B, T, D] tensors. Returns f32 latents on the
    bundle's device. `noise` (the latents' shape) replaces
    `default_noise(seed, ...)`, `step_noise` `default_step_noise(seed,
    ...)`. `noise_mask` ([B, h, w, 1], 1 = regenerate) keeps the rest of
    the latents (inpainting). `batch_fixed_noise` gives every batch row
    row 0's initial noise (`batch_noise`)."""
    smp.check_sampler_names(sampler, scheduler)
    param = model_schedule_info(bundle)
    sigmas = smp.get_model_sigmas(param, scheduler, int(steps), denoise=float(denoise),
                                  flow_shift=flow_shift(bundle))
    latents, noise = _latents_and_noise(bundle, latents, noise, seed, batch_fixed_noise)
    x = smp.noise_latents(param, latents, noise, sigmas[0])
    return _masked_sample(bundle, cfg_scale, param, latents, noise, x, sigmas,
                          (context_pos, context_neg), sampler,
                          step_noise or default_step_noise(seed, bundle.device), noise_mask)


def advanced_window_sigmas(parameterization: str, scheduler: str, steps: int,
                           start_at_step: int, end_at_step: int,
                           force_full_denoise: bool, shift: float = 3.0) -> torch.Tensor:
    """KSamplerAdvanced's schedule: the full [steps+1] grid (a flow model's
    at `shift`) windowed to [start, end] (both clamped to the grid), with
    the last sigma forced to 0 when the caller wants a full denoise
    despite stopping early."""
    full = smp.get_model_sigmas(parameterization, scheduler, int(steps), flow_shift=shift)
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
    batch_fixed_noise: bool = False,
) -> torch.Tensor:
    """KSamplerAdvanced's core: sample the [start_at_step, end_at_step]
    window of the full schedule. Without `add_noise` (the refine pass of
    a two-pass workflow) the trajectory starts from the latents as given,
    no initial noise is drawn and a masked pin uses zeros; a stochastic
    sampler still draws its step noise. Without `force_full_denoise` the
    output keeps the window's leftover noise."""
    smp.check_sampler_names(sampler, scheduler)
    window = advanced_window_sigmas(model_schedule_info(bundle), scheduler, steps, start_at_step,
                                    end_at_step, force_full_denoise, flow_shift(bundle))
    return _sample_window(bundle, latents, (context_pos, context_neg), window, sampler,
                          cfg_scale, seed, add_noise, noise_mask, batch_fixed_noise, noise,
                          step_noise)[0]


def _sample_window(bundle: PipelineBundle, latents, cond, sigmas: torch.Tensor, sampler: str,
                   cfg_scale: float, seed: int, add_noise: bool, noise_mask, batch_fixed_noise,
                   noise, step_noise):
    """`sampler` over the host grid `sigmas` from the latents, noised to
    its first sigma with `add_noise`, else as they are (a masked pin then
    uses zeros) → (output, the latents on the bundle's device, the mask
    clamped to [0, 1] or None). A grid of one point samples nothing,
    but the mask still keeps its region."""
    param = model_schedule_info(bundle)
    if add_noise:
        latents, noise = _latents_and_noise(bundle, latents, noise, seed, batch_fixed_noise)
        x = smp.noise_latents(param, latents, noise, sigmas[0])
    else:
        latents = torch.as_tensor(latents).to(device=bundle.device, dtype=torch.float32)
        noise = torch.zeros_like(latents)
        x = latents
    mask = None
    if noise_mask is not None:
        mask = torch.clamp(torch.as_tensor(noise_mask).to(bundle.device, torch.float32), 0.0, 1.0)
    if sigmas.shape[0] < 2:
        return (x if mask is None else x * mask + latents * (1.0 - mask)), latents, mask
    out = _masked_sample(bundle, cfg_scale, param, latents, noise, x, sigmas, cond, sampler,
                         step_noise or default_step_noise(seed, bundle.device), noise_mask)
    return out, latents, mask


@torch.no_grad()
def sample_custom_sigmas(
    bundle: PipelineBundle,
    latents: torch.Tensor,
    context_pos,
    context_neg,
    sigmas,
    sampler: str = "euler",
    cfg_scale: float = 1.0,
    seed: int = 0,
    add_noise: bool = True,
    noise_mask: torch.Tensor | None = None,
    batch_fixed_noise: bool = False,
    noise: torch.Tensor | None = None,
    step_noise: smp.StepNoise | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SamplerCustom's and SamplerCustomAdvanced's core: `sampler` over an
    explicit sigma grid (a SIGMAS value) → (output, denoised_output).
    Where the grid stops above sigma 0 (a leftover-noise stage), the
    second is the model's x0 prediction at its last sigma, one more
    guided evaluation; else it is the output. Without `add_noise` the
    trajectory starts from the latents as given and a masked pin uses
    zeros, as in `img2img_latents_advanced`."""
    if sampler not in smp.SAMPLER_NAMES:
        raise ValueError(f"unknown sampler {sampler!r}; use {smp.SAMPLER_NAMES}")
    sigmas = torch.as_tensor(sigmas).detach().to("cpu", torch.float32)
    cond = (context_pos, context_neg)
    out, latents, mask = _sample_window(bundle, latents, cond, sigmas, sampler, cfg_scale, seed,
                                        add_noise, noise_mask, batch_fixed_noise, noise,
                                        step_noise)
    if sigmas.shape[0] < 2:
        return out, out
    last = float(sigmas[-1])
    if last == 0.0:
        return out, out
    model = guided_model(bundle, float(cfg_scale))
    eps = model(out, torch.full((out.shape[0],), last, dtype=torch.float32),
                tuple(c if isinstance(c, (list, tuple)) else as_conditioning(c) for c in cond))
    denoised = out - sigmas[-1] * eps
    if mask is not None:
        denoised = denoised * mask + latents * (1.0 - mask)
    return out, denoised


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
