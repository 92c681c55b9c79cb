"""Video generation pipeline (WAN-class t2v and i2v), in PyTorch.

Counterpart of comfyui_distributed_tpu/models/video_pipeline.py without
its mesh path (`t2v_parallel`, the multi-GPU tier's seed fan-out: step
8) and `t2v_flops` (the cost model of step 7): text → video frames.
Latents are [B, F, h, w, C]. The causal WAN VAE compresses time 4x
(4n+1 frames) and decodes and encodes in time chunks
(models/video_vae.py); the tiny stacks' per-frame 2D VAE decodes frame
by frame.

Noise: the initial noise is standard normals from a generator seeded
with the participant's effective seed on the bundle's device, as the
port's txt2img draws it; the tests hand `t2v` and `i2v` the JAX
package's noise instead.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..ops import samplers as smp
from . import sd_checkpoint as sdc
from .pipeline import _build, _loading, _seed_generators, _tokenizer, default_noise
from .registry import get_config, model_family


@dataclasses.dataclass
class VideoPipelineBundle:
    model_name: str
    dit: Any
    vae: Any
    text_encoder: Any
    tokenizer: Any
    device: torch.device
    latent_channels: int
    latent_scale: int
    flow_shift: float = 3.0
    # i2v: the CLIP-vision tower of the image conditioning (WAN i2v layout)
    clip_vision: Any = None
    # 1 for a per-frame 2D VAE; the causal WAN VAE compresses time 4x with
    # the 4n+1 pixel-frame contract
    temporal_scale: int = 1
    te_name: str | None = None
    vae_name: str | None = None

    def latent_frames(self, frames: int) -> int:
        if self.temporal_scale == 1:
            return frames
        if (frames - 1) % self.temporal_scale != 0:
            raise ValueError(
                f"frame count {frames} must be {self.temporal_scale}n+1 "
                "for this VAE (WAN causal contract)"
            )
        return (frames - 1) // self.temporal_scale + 1

    def parts(self) -> dict[str, torch.nn.Module]:
        """The bundle's modules by the JAX package's params keys."""
        out = {"unet": self.dit, "vae": self.vae, "te": self.text_encoder}
        if self.clip_vision is not None:
            out["clip_vision"] = self.clip_vision
        return out


def default_parts(model_name: str) -> tuple[str, str, str | None]:
    """(VAE, text encoder, CLIP-vision tower or None) a video model is
    built with by default: the causal WAN VAE, CLIP-L and CLIP ViT-H;
    tiny models the per-frame tiny-vae-video, tiny-te and
    tiny-clip-vision."""
    tiny = model_name.startswith("tiny")
    vision = None
    if get_config(model_name).i2v:
        vision = "tiny-clip-vision" if tiny else "clip-vision-h"
    return ("tiny-vae-video" if tiny else "wan-vae"), ("tiny-te" if tiny else "clip-l"), vision


def load_video_pipeline(model_name: str = "tiny-dit", vae_name: str | None = None,
                        te_name: str | None = None, seed: int = 0,
                        checkpoint: str | None = None, device="cuda") -> VideoPipelineBundle:
    """A video pipeline on `device` (the card unless the caller asks for
    the CPU). Non-tiny models take the causal WAN VAE and CLIP-L (77
    tokens, zero-padded to the DiT's 4096-wide context), as in the JAX
    package: a random UMT5-XXL would be ~6B parameters to no purpose. Each
    part loads its own file where one resolves: the DiT from `checkpoint`
    or CDT_CHECKPOINT_DIR/<model_name>.* (`load_wan_weights`), the WAN VAE
    from <vae_name>.*, a T5-family encoder from <te_name>.*, the i2v
    CLIP-vision tower from <its name>.*; else each draws its seeded
    random init from its own generator on the device (offsets: DiT 0,
    VAE 1, text 2, vision 5)."""
    from .clip_vision import build_clip_vision

    device = torch.device(device)
    if model_family(model_name) != "dit":
        raise ValueError(f"{model_name!r} is not a video DiT (family "
                         f"{model_family(model_name)!r})")
    default_vae, default_te, vision = default_parts(model_name)
    vae_name, te_name = vae_name or default_vae, te_name or default_te
    dit_cfg, vae_cfg = get_config(model_name), get_config(vae_name)
    video_vae = model_family(vae_name) == "video_vae"
    generator = _seed_generators(seed, device)

    dit_path = checkpoint or sdc.find_checkpoint(model_name)
    dit = _build(model_name, device, None if dit_path else generator(0))
    if dit_path:
        with _loading(dit_path, model_name), sdc.open_checkpoint(dit_path) as state_dict:
            sdc.load_wan_weights(state_dict, dit_cfg, dit)
    vae_path = sdc.find_checkpoint(vae_name) if video_vae else None
    vae = _build(vae_name, device, None if vae_path else generator(1))
    if vae_path:
        with _loading(vae_path, vae_name), sdc.open_checkpoint(vae_path) as state_dict:
            sdc.load_wan_vae_weights(state_dict, vae_cfg, vae)
    t5 = model_family(te_name) == "t5_encoder"
    te_path = sdc.find_checkpoint(te_name) if t5 else None
    te = _build(te_name, device, None if te_path else generator(2))
    if te_path:
        with _loading(te_path, te_name), sdc.open_checkpoint(te_path) as state_dict:
            sdc.load_t5_weights(state_dict, get_config(te_name), te)
    clip_vision = None if vision is None else build_clip_vision(vision, device, generator(5))
    return VideoPipelineBundle(
        model_name=model_name, dit=dit, vae=vae, text_encoder=te, tokenizer=_tokenizer(te_name),
        device=device, latent_channels=vae_cfg.latent_channels, latent_scale=vae_cfg.downscale,
        clip_vision=clip_vision, temporal_scale=vae_cfg.temporal_downscale if video_vae else 1,
        te_name=te_name, vae_name=vae_name)


@torch.no_grad()
def encode_video_text(bundle: VideoPipelineBundle, texts: list[str]) -> torch.Tensor:
    """[B, T, context_dim] f32 text states: the encoder's hidden states,
    zero-padded (or cut) to the DiT's context width."""
    tokens = torch.as_tensor(bundle.tokenizer.encode_batch(texts), dtype=torch.long,
                             device=bundle.device)
    if model_family(bundle.te_name) == "t5_encoder":
        hidden, _ = bundle.text_encoder(tokens)
    else:
        hidden, _ = bundle.text_encoder(tokens, eos_id=bundle.tokenizer.eos_id)
    ctx_dim = get_config(bundle.model_name).context_dim
    if hidden.shape[-1] < ctx_dim:
        hidden = torch.nn.functional.pad(hidden, (0, ctx_dim - hidden.shape[-1]))
    return hidden[..., :ctx_dim].float()


@torch.no_grad()
def decode_frames(bundle: VideoPipelineBundle, latents: torch.Tensor) -> torch.Tensor:
    """[B, F_lat, h, w, C] latents → [B, F, H, W, 3] frames in [0, 1]: the
    causal 3D VAE expands time 4x (F = 4 (F_lat - 1) + 1), chunked; a
    per-frame 2D VAE decodes frame by frame (F = F_lat)."""
    latents = latents.to(bundle.device)
    if bundle.temporal_scale != 1:
        return bundle.vae.decode(latents)
    b, f = latents.shape[:2]
    frames = bundle.vae.decode(latents.reshape((b * f,) + latents.shape[2:]))
    return frames.reshape((b, f) + frames.shape[1:])


@torch.no_grad()
def encode_frames(bundle: VideoPipelineBundle, frames: torch.Tensor) -> torch.Tensor:
    """[B, F, H, W, 3] → [B, F_lat, h, w, C]: 4x temporal compression for
    the causal 3D VAE (chunked), per frame for a 2D VAE."""
    frames = frames.to(bundle.device)
    if bundle.temporal_scale != 1:
        return bundle.vae.encode(frames)
    b, f = frames.shape[:2]
    z = bundle.vae.encode(frames.reshape((b * f,) + frames.shape[2:]))
    return z.reshape((b, f) + z.shape[1:])


@torch.no_grad()
def encode_image_embeds(bundle: VideoPipelineBundle, image: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] → the CLIP penultimate tokens [B, T, width] (i2v only)."""
    return bundle.clip_vision(image.to(bundle.device))


def _video_model_fn(bundle: VideoPipelineBundle):
    def model_fn(x, t_batch, context):
        return bundle.dit(x, t_batch.to(x.device), context).to(x.dtype)

    return model_fn


def video_noise(bundle: VideoPipelineBundle, seed: int, shape: tuple) -> torch.Tensor:
    """The initial noise of a video: `pipeline.default_noise` on the
    bundle's device."""
    return default_noise(seed, shape, bundle.device)


@torch.no_grad()
def t2v_from_cond(bundle: VideoPipelineBundle, pos: torch.Tensor, neg: torch.Tensor, seed: int,
                  frames: int, height: int, width: int, steps: int, cfg_scale: float,
                  noise: torch.Tensor | None = None) -> torch.Tensor:
    """Sample and decode a video from encoded text: the batch is pos's;
    `noise` [B, F_lat, h, w, C] replaces the seeded draw."""
    lh, lw = height // bundle.latent_scale, width // bundle.latent_scale
    shape = (pos.shape[0], bundle.latent_frames(frames), lh, lw, bundle.latent_channels)
    x = video_noise(bundle, seed, shape) if noise is None else noise.to(bundle.device).float()
    timesteps = smp.get_flow_timesteps(steps, bundle.flow_shift)
    model = smp.cfg_flow_model(_video_model_fn(bundle), float(cfg_scale))
    latents = smp.sample_flow(model, x, timesteps, (pos.to(x.device), neg.to(x.device)))
    return decode_frames(bundle, latents)


def t2v(bundle: VideoPipelineBundle, prompt: str, negative_prompt: str = "", frames: int = 17,
        height: int = 256, width: int = 256, steps: int = 20, cfg_scale: float = 5.0,
        seed: int = 0, batch: int = 1, noise: torch.Tensor | None = None) -> torch.Tensor:
    """Text → video; returns [batch, frames, H, W, 3] in [0, 1]."""
    pos = encode_video_text(bundle, [prompt] * batch)
    neg = encode_video_text(bundle, [negative_prompt] * batch)
    return t2v_from_cond(bundle, pos, neg, seed, frames, height, width, steps, cfg_scale, noise)


@torch.no_grad()
def _i2v_fallback(bundle, ref_latent, pos, neg, noise, frames, steps, cfg_scale):
    """Other video models: latent frame 0 clamped to the reference latent
    along the flow path (masked flow)."""
    b, _, lh, lw, c = ref_latent.shape
    lf = bundle.latent_frames(frames)
    known = torch.cat([ref_latent, ref_latent.new_zeros((b, lf - 1, lh, lw, c))], dim=1)
    mask = ref_latent.new_zeros((1, lf, 1, 1, 1))
    mask[:, 0] = 1.0
    model = smp.cfg_flow_model(_video_model_fn(bundle), cfg_scale)
    latents = smp.sample_flow_masked(model, noise, smp.get_flow_timesteps(steps, bundle.flow_shift),
                                     (pos, neg), known, mask, noise)
    return decode_frames(bundle, latents)


@torch.no_grad()
def _i2v_native(bundle, y, image_embeds, pos, neg, noise, steps, cfg_scale):
    """WAN-i2v-layout sampling: the DiT input is [noise 16 | mask 4 |
    conditioning latent 16] per frame, with image cross-attention over the
    CLIP tokens. `y` is the VAE encoding of the padded PIXEL clip (the
    reference frame and mid-grey blanks), not zero latents."""
    b, lf, lh, lw, _ = y.shape
    mask = y.new_zeros((b, lf, lh, lw, 4))
    mask[:, 0] = 1.0
    cond_channels = torch.cat([mask, y], dim=-1)

    def model_fn(x, t_batch, context):
        # the CFG pass doubles the batch (pos | neg); the image
        # conditioning is the same for both halves
        reps = x.shape[0] // cond_channels.shape[0]
        inp = torch.cat([x, cond_channels.repeat(reps, 1, 1, 1, 1)], dim=-1)
        return bundle.dit(inp, t_batch.to(x.device), context,
                          image_embeds.repeat(reps, 1, 1)).to(x.dtype)

    model = smp.cfg_flow_model(model_fn, cfg_scale)
    latents = smp.sample_flow(model, noise, smp.get_flow_timesteps(steps, bundle.flow_shift),
                              (pos, neg))
    return decode_frames(bundle, latents)


@torch.no_grad()
def i2v(bundle: VideoPipelineBundle, image: torch.Tensor, prompt: str, negative_prompt: str = "",
        frames: int = 17, steps: int = 20, cfg_scale: float = 5.0, seed: int = 0,
        noise: torch.Tensor | None = None) -> torch.Tensor:
    """Image → video from a [B, H, W, 3] first frame; returns [B, frames,
    H, W, 3]. i2v-layout models run WAN's native conditioning (the mask
    and reference-clip latent joined to the input, the CLIP-vision
    tokens); other video models clamp frame 0 along the flow path.
    `noise` replaces the seeded draw."""
    image = torch.as_tensor(image).to(bundle.device).float()
    b = int(image.shape[0])
    pos = encode_video_text(bundle, [prompt] * b)
    neg = encode_video_text(bundle, [negative_prompt] * b)
    cfg_scale = float(cfg_scale)
    if get_config(bundle.model_name).i2v:
        embeds = encode_image_embeds(bundle, image)
        blanks = torch.full((b, frames - 1) + tuple(image.shape[1:]), 0.5, dtype=image.dtype,
                            device=image.device)
        y = encode_frames(bundle, torch.cat([image[:, None], blanks], dim=1))
        x = video_noise(bundle, seed, tuple(y.shape)) if noise is None else noise
        return _i2v_native(bundle, y, embeds, pos, neg, x.to(y.device).float(), steps, cfg_scale)
    ref = encode_frames(bundle, image[:, None])
    lf = bundle.latent_frames(frames)
    shape = (b, lf) + tuple(ref.shape[2:])
    x = video_noise(bundle, seed, shape) if noise is None else noise
    return _i2v_fallback(bundle, ref, pos, neg, x.to(ref.device).float(), frames, steps, cfg_scale)
