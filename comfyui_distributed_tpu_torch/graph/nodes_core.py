"""Core workflow nodes: checkpoint (and a standalone VAE) → clip-skip →
text encode (CLIPTextEncode, CLIPTextEncodeSDXL with its size override,
ConditioningConcat) → empty latent or encode (VAEEncode, VAEEncodeTiled,
VAEEncodeForInpaint, InpaintModelConditioning) → sample (KSampler,
KSamplerAdvanced) → decode (VAEDecode, VAEDecodeTiled), the upscale model
(UpscaleModelLoader, ImageUpscaleWithModel), image load and save; and
the image and latent utilities (batch, crop, pad for outpainting, scale,
invert, blur, sharpen; latent composite, repeat, slice, batch, upscale,
noise mask).

Counterparts of the same-named nodes in comfyui_distributed_tpu/graph/
nodes_core.py. Data contracts:

    MODEL / CLIP / VAE — views over a models.pipeline.PipelineBundle (a
                         VAE may also be VAELoader's VAEBundle)
    CONDITIONING       — ops.conditioning.Conditioning
    LATENT             — {"samples": [B, h, w, C]} dict (ComfyUI parity),
                         optionally with "noise_mask" (1 = regenerate)
    IMAGE              — [B, H, W, C] float tensor in [0, 1]
    MASK               — [B, H, W] float tensor in [0, 1]

A `SeedSpec` flows out of DistributedSeed: the base seed plus, on a
worker of the elastic tier, its index. The JAX package's mesh branch (a
per-participant SeedSpec sampled as one SPMD program) is not ported: the
multi-GPU tier is ROADMAP.md Queue 1 item 6, and such a spec raises.

LoadImage and SaveImage read and write PNG through the port's own codec
(utils/image.py): the machine that runs the card has no PIL. PreviewImage
is the terminal sink a worker's pruned prompt ends in.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..models import pipeline as pl
from ..models.upscaler import load_upscale_model
from ..ops.conditioning import as_conditioning, map_conditioning
from ..ops.filters import gaussian_blur
from ..ops.resize import center_crop_to_aspect, resize_image, resolve_resize_dims, scale_dims
from ..ops.tiled_vae import decode_tiled, encode_tiled
from ..utils import image as img_utils
from .io_dirs import get_output_dir, next_counter, resolve_input_path
from .registry import register_node


_MESH_UNPORTED = ("per-participant seeds on a device mesh are not ported yet (ROADMAP.md, "
                  "Queue 1 item 6: the multi-GPU tier)")


@dataclasses.dataclass(frozen=True)
class SeedSpec:
    """A seed plus how to spread it across participants."""

    base_seed: int
    per_participant: bool = False  # the mesh tier's fan-out: not ported
    worker_index: int = -1         # elastic tier: fixed offset applied

    def effective_seed(self) -> int:
        """The seed this participant samples with: the base seed on the
        master, base + worker_index + 1 on worker i."""
        return self.base_seed + (self.worker_index + 1 if self.worker_index >= 0 else 0)


def resolve_seed(seed: Any) -> SeedSpec:
    if isinstance(seed, SeedSpec):
        return seed
    return SeedSpec(base_seed=int(seed))


def _device(context) -> str:
    return getattr(context, "device", None) or "cuda"


def _get_bundle(context, model_name: str) -> pl.PipelineBundle:
    if model_name not in context.pipelines:
        context.pipelines[model_name] = pl.load_pipeline(model_name, device=_device(context))
    return context.pipelines[model_name]


@register_node
class CheckpointLoaderSimple:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"ckpt_name": ("STRING", {"default": "tiny-unet"})}}

    RETURN_TYPES = ("MODEL", "CLIP", "VAE")
    FUNCTION = "load"

    def load(self, ckpt_name: str, context=None):
        # strip file extensions so ComfyUI workflow values map to registry names
        bundle = _get_bundle(context, os.path.splitext(str(ckpt_name))[0])
        return (bundle, bundle, bundle)


@register_node
class VAELoader:
    """A standalone VAE: a registry VAE name (vae-sd, ...) whose weights
    resolve through CDT_CHECKPOINT_DIR/<name>.{safetensors,ckpt} (a
    standalone file's bare keys or a full checkpoint's first_stage_model
    layout), else its seeded random init. Its output plugs into any VAE
    input in place of the checkpoint's VAE; the USDU node swaps it into
    a copy of the model's bundle (`dataclasses.replace`), so the cached
    bundle keeps its own."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"vae_name": ("STRING", {"default": "vae-sd"})}}

    RETURN_TYPES = ("VAE",)
    FUNCTION = "load_vae"

    def load_vae(self, vae_name: str, context=None):
        # workflows carry file names ("vae-sd.safetensors"): resolve by stem
        return (pl.load_vae(os.path.splitext(str(vae_name))[0], device=_device(context)),)


@register_node
class CLIPTextEncode:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"text": ("STRING", {"default": ""}), "clip": ("CLIP",)}}

    RETURN_TYPES = ("CONDITIONING",)
    FUNCTION = "encode"

    def encode(self, text: str, clip: pl.PipelineBundle, context=None):
        return (pl.encode_text_pooled(clip, [str(text)]),)


@register_node
class CLIPTextEncodeFlux:
    """Flux's two prompts: t5xxl feeds the T5 context, clip_l the CLIP
    pooled vector, and the distilled guidance rides on the conditioning
    as FluxGuidance writes it (pl.encode_text_pooled_flux)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "clip": ("CLIP",),
                "clip_l": ("STRING", {"default": ""}),
                "t5xxl": ("STRING", {"default": ""}),
                "guidance": ("FLOAT", {"default": 3.5}),
            }
        }

    RETURN_TYPES = ("CONDITIONING",)
    FUNCTION = "encode"

    def encode(self, clip, clip_l="", t5xxl="", guidance=3.5, context=None):
        return (pl.encode_text_pooled_flux(clip, [str(t5xxl)], [str(clip_l)],
                                           guidance=float(guidance)),)


@register_node
class CLIPTextEncodeSDXL:
    """SDXL's dual-prompt encoding: text_l through the CLIP-L tower,
    text_g through CLIP-G, and the six size ints on the conditioning as
    the adm size embeddings (orig h/w, crop t/l, target h/w), in place of
    the KSampler default (zero crops, sizes from the latent)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "clip": ("CLIP",),
                "width": ("INT", {"default": 1024}),
                "height": ("INT", {"default": 1024}),
                "crop_w": ("INT", {"default": 0}),
                "crop_h": ("INT", {"default": 0}),
                "target_width": ("INT", {"default": 1024}),
                "target_height": ("INT", {"default": 1024}),
                "text_g": ("STRING", {"default": ""}),
                "text_l": ("STRING", {"default": ""}),
            }
        }

    RETURN_TYPES = ("CONDITIONING",)
    FUNCTION = "encode"

    def encode(self, clip: pl.PipelineBundle, width=1024, height=1024, crop_w=0, crop_h=0,
               target_width=1024, target_height=1024, text_g="", text_l="", context=None):
        size_cond = (int(height), int(width), int(crop_h), int(crop_w), int(target_height),
                     int(target_width))
        return (pl.encode_text_pooled_sdxl(clip, [str(text_g)], [str(text_l)],
                                           size_cond=size_cond),)


@register_node
class ConditioningConcat:
    """The two conditionings' tokens concatenated (the model attends to
    both prompts in one pass); everything else, and every entry of a
    list, from conditioning_to; only the first entry of a `from` list."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "conditioning_to": ("CONDITIONING",),
                "conditioning_from": ("CONDITIONING",),
            }
        }

    RETURN_TYPES = ("CONDITIONING",)
    FUNCTION = "concat"

    def concat(self, conditioning_to, conditioning_from, context=None):
        src = conditioning_from
        if isinstance(src, (list, tuple)):
            src = src[0]
        from_c = as_conditioning(src)

        def patch(to_c):
            to_c.context = torch.cat([to_c.context, from_c.context.to(to_c.context.device)],
                                     dim=1)
            return to_c

        return (map_conditioning(conditioning_to, patch),)


@register_node
class ImageBatch:
    """Two images joined on the batch axis; the second is centre-cropped
    to the first's aspect and resized (bilinear) to its size where they
    differ."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"image1": ("IMAGE",), "image2": ("IMAGE",)}}

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "batch"

    def batch(self, image1, image2, context=None):
        if tuple(image1.shape[1:3]) != tuple(image2.shape[1:3]):
            h, w = image1.shape[1], image1.shape[2]
            (image2,) = center_crop_to_aspect([image2], h, w)
            image2 = resize_image(image2, h, w, "bilinear")
        return (torch.cat([image1, image2.to(image1.device, image1.dtype)], dim=0),)


def _crop_window(h: int, w: int, x, y, width, height, unit: int = 1):
    """(y0, y1, x0, x1) of a crop: the origin clamped into the frame,
    the extent (at least one cell) clamped to what remains; pixel values
    divided by `unit` (8 for latents)."""
    x0 = min(max(int(x) // unit, 0), w - 1)
    y0 = min(max(int(y) // unit, 0), h - 1)
    x1 = min(x0 + max(int(width) // unit, 1), w)
    y1 = min(y0 + max(int(height) // unit, 1), h)
    return y0, y1, x0, x1


@register_node
class ImageCrop:
    """A pixel region: x/y clamp into the frame, width/height to the
    remaining extent."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "image": ("IMAGE",),
                "width": ("INT", {"default": 512}),
                "height": ("INT", {"default": 512}),
                "x": ("INT", {"default": 0}),
                "y": ("INT", {"default": 0}),
            }
        }

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "crop"

    def crop(self, image, width=512, height=512, x=0, y=0, context=None):
        y0, y1, x0, x1 = _crop_window(image.shape[1], image.shape[2], x, y, width, height)
        return (image[:, y0:y1, x0:x1, :],)


@register_node
class LatentComposite:
    """One latent pasted into another at a pixel offset (8 pixels a latent
    cell, the node convention). `feather` pixels of linear ramp blend the
    pasted region's edges that lie inside the destination; ramps of
    opposite edges multiply."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "samples_to": ("LATENT",),
                "samples_from": ("LATENT",),
                "x": ("INT", {"default": 0}),
                "y": ("INT", {"default": 0}),
                "feather": ("INT", {"default": 0}),
            }
        }

    RETURN_TYPES = ("LATENT",)
    FUNCTION = "composite"

    def composite(self, samples_to: dict, samples_from: dict, x=0, y=0, feather=0,
                  context=None):
        dst = samples_to["samples"]
        src = samples_from["samples"].to(dst.device)
        lx, ly = max(int(x), 0) // 8, max(int(y), 0) // 8
        fe = max(int(feather), 0) // 8
        h = min(src.shape[1], dst.shape[1] - ly)
        w = min(src.shape[2], dst.shape[2] - lx)
        out = dict(samples_to)
        if h <= 0 or w <= 0:
            return (out,)
        region = src[:, :h, :w, :]
        if fe > 0:
            ramp_y = torch.ones(h, device=dst.device)
            ramp_x = torch.ones(w, device=dst.device)
            idx_y = torch.arange(h, dtype=torch.float32, device=dst.device)
            idx_x = torch.arange(w, dtype=torch.float32, device=dst.device)
            if ly > 0:
                ramp_y = ramp_y * torch.clamp((idx_y + 1) / fe, 0.0, 1.0)
            if ly + h < dst.shape[1]:
                ramp_y = ramp_y * torch.clamp((h - idx_y) / fe, 0.0, 1.0)
            if lx > 0:
                ramp_x = ramp_x * torch.clamp((idx_x + 1) / fe, 0.0, 1.0)
            if lx + w < dst.shape[2]:
                ramp_x = ramp_x * torch.clamp((w - idx_x) / fe, 0.0, 1.0)
            mask = (ramp_y[:, None] * ramp_x[None, :])[None, :, :, None]
        else:
            mask = 1.0
        patch = dst[:, ly:ly + h, lx:lx + w, :]
        merged = dst.clone()
        merged[:, ly:ly + h, lx:lx + w, :] = region * mask + patch * (1.0 - mask)
        out["samples"] = merged
        return (out,)


def _per_sample_mask(samples: dict):
    """The latent's noise mask where it has one row per sample, else None."""
    mask = samples.get("noise_mask")
    if mask is not None and getattr(mask, "ndim", 0) >= 3 \
            and mask.shape[0] == samples["samples"].shape[0]:
        return mask
    return None


@register_node
class RepeatLatentBatch:
    """The latents repeated `amount` times on the batch axis; a
    per-sample noise mask repeats with them."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"samples": ("LATENT",), "amount": ("INT", {"default": 1})}}

    RETURN_TYPES = ("LATENT",)
    FUNCTION = "repeat"

    def repeat(self, samples: dict, amount=1, context=None):
        n = max(1, int(amount))
        out = dict(samples)
        out["samples"] = torch.cat([samples["samples"]] * n, dim=0)
        mask = _per_sample_mask(samples)
        if mask is not None:
            out["noise_mask"] = torch.cat([mask] * n, dim=0)
        return (out,)


@register_node
class CLIPSetLastLayer:
    """Clip-skip: the conditioning context stops `stop_at_clip_layer`
    blocks from the end of every CLIP tower (-1 = the full stack, -2 =
    the classic "clip skip 2"); the pooled vector keeps the full stack.
    Returns a new bundle: the one the executor caches stays as it is."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "clip": ("CLIP",),
                "stop_at_clip_layer": ("INT", {"default": -1}),
            }
        }

    RETURN_TYPES = ("CLIP",)
    FUNCTION = "set_last_layer"

    def set_last_layer(self, clip: pl.PipelineBundle, stop_at_clip_layer=-1, context=None):
        stop = int(stop_at_clip_layer)
        if stop >= 0:
            raise ValueError(
                "stop_at_clip_layer counts from the end and must be negative (-1 = last layer)"
            )
        return (dataclasses.replace(clip, clip_skip=-stop - 1),)


@register_node
class EmptyLatentImage:
    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "width": ("INT", {"default": 512}),
                "height": ("INT", {"default": 512}),
                "batch_size": ("INT", {"default": 1}),
            }
        }

    RETURN_TYPES = ("LATENT",)
    FUNCTION = "generate"

    def generate(self, width: int, height: int, batch_size: int, context=None):
        # the SD 8x, 4-channel layout; KSampler rebuilds the placeholder
        # for a bundle whose VAE differs
        samples = torch.zeros((int(batch_size), int(height) // 8, int(width) // 8, 4),
                              device=_device(context))
        return ({"samples": samples, "width": int(width), "height": int(height), "empty": True},)


def _mask_to_latent(mask, lh: int, lw: int) -> torch.Tensor:
    """MASK ([H, W], [B, H, W] or [B, H, W, 1]; 1 = regenerate) →
    [B, lh, lw, 1] in [0, 1], resized with jax.image.resize's
    antialiased linear weights (ops/resize.py::resize_image)."""
    m = torch.as_tensor(mask).float()
    if m.ndim == 4:
        m = m[..., 0]
    if m.ndim == 2:
        m = m[None]
    if tuple(m.shape[1:]) != (lh, lw):
        m = resize_image(m[..., None], lh, lw, "bilinear")[..., 0]
    return torch.clamp(m, 0.0, 1.0)[..., None]


def _prep_latents(bundle: pl.PipelineBundle, latent_image: dict):
    """KSampler's and KSamplerAdvanced's input normalisation: a
    placeholder (`empty`) latent is rebuilt to the bundle's latent layout
    if it differs, a noise mask is brought to latent resolution, and the
    extras the output carries forward are collected (the `empty` marker
    is not; a noise mask is, so a chained pass stays masked, and so is
    LatentBatchSeedBehavior's `batch_index_fixed`)."""
    latents = latent_image["samples"]
    if latent_image.get("empty") and "width" in latent_image:
        shape = (latents.shape[0], latent_image["height"] // bundle.latent_scale,
                 latent_image["width"] // bundle.latent_scale, bundle.latent_channels)
        if tuple(latents.shape) != shape:
            latents = torch.zeros(shape, device=bundle.device)
    noise_mask = latent_image.get("noise_mask")
    if noise_mask is not None:
        noise_mask = _mask_to_latent(noise_mask, latents.shape[1], latents.shape[2])
    extras = {k: v for k, v in latent_image.items() if k not in ("samples", "empty")}
    return latents, noise_mask, extras


@register_node
class KSampler:
    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL",),
                "seed": ("INT", {"default": 0}),
                "steps": ("INT", {"default": 20}),
                "cfg": ("FLOAT", {"default": 7.0}),
                "sampler_name": ("STRING", {"default": "euler"}),
                "scheduler": ("STRING", {"default": "karras"}),
                "positive": ("CONDITIONING",),
                "negative": ("CONDITIONING",),
                "latent_image": ("LATENT",),
                "denoise": ("FLOAT", {"default": 1.0}),
            }
        }

    RETURN_TYPES = ("LATENT",)
    FUNCTION = "sample"

    def sample(self, model: pl.PipelineBundle, seed, steps: int, cfg: float, sampler_name: str,
               scheduler: str, positive, negative, latent_image: dict, denoise: float = 1.0,
               context=None):
        spec = resolve_seed(seed)
        if spec.per_participant:
            raise NotImplementedError(_MESH_UNPORTED)
        latents, noise_mask, extras = _prep_latents(model, latent_image)
        out = pl.img2img_latents(
            model, latents, positive, negative, steps=int(steps), sampler=sampler_name,
            scheduler=scheduler, cfg_scale=float(cfg), denoise=float(denoise),
            seed=spec.effective_seed(), noise_mask=noise_mask,
            batch_fixed_noise=bool(latent_image.get("batch_index_fixed", False)),
        )
        return ({**extras, "samples": out},)


def _flag(value, name: str) -> bool:
    value = str(value)
    if value not in ("enable", "disable"):
        raise ValueError(f"{name} must be 'enable' or 'disable'")
    return value == "enable"


@register_node
class KSamplerAdvanced:
    """Windowed-schedule sampler: steps [start_at_step, end_at_step] of
    the full schedule, optionally without adding noise (the refine pass
    of a two-pass workflow, which takes a latent with leftover noise) and
    optionally leaving leftover noise for a later pass
    (return_with_leftover_noise "enable")."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL",),
                "add_noise": ("STRING", {"default": "enable"}),
                "noise_seed": ("INT", {"default": 0}),
                "steps": ("INT", {"default": 20}),
                "cfg": ("FLOAT", {"default": 7.0}),
                "sampler_name": ("STRING", {"default": "euler"}),
                "scheduler": ("STRING", {"default": "karras"}),
                "positive": ("CONDITIONING",),
                "negative": ("CONDITIONING",),
                "latent_image": ("LATENT",),
                "start_at_step": ("INT", {"default": 0}),
                "end_at_step": ("INT", {"default": 10000}),
                "return_with_leftover_noise": ("STRING", {"default": "disable"}),
            }
        }

    RETURN_TYPES = ("LATENT",)
    FUNCTION = "sample"

    def sample(self, model: pl.PipelineBundle, add_noise, noise_seed, steps: int, cfg: float,
               sampler_name: str, scheduler: str, positive, negative, latent_image: dict,
               start_at_step: int = 0, end_at_step: int = 10000,
               return_with_leftover_noise="disable", context=None):
        do_noise = _flag(add_noise, "add_noise")
        force_full = not _flag(return_with_leftover_noise, "return_with_leftover_noise")
        spec = resolve_seed(noise_seed)
        # a pass that adds no noise is deterministic in its input: the JAX
        # package runs it on one device even under a mesh
        if spec.per_participant and do_noise:
            raise NotImplementedError(_MESH_UNPORTED)
        latents, noise_mask, extras = _prep_latents(model, latent_image)
        out = pl.img2img_latents_advanced(
            model, latents, positive, negative, steps=int(steps), sampler=sampler_name,
            scheduler=scheduler, cfg_scale=float(cfg), seed=spec.effective_seed(),
            start_at_step=int(start_at_step), end_at_step=int(end_at_step),
            add_noise=do_noise, force_full_denoise=force_full, noise_mask=noise_mask,
            batch_fixed_noise=bool(latent_image.get("batch_index_fixed", False)),
        )
        return ({**extras, "samples": out},)


@register_node
class VAEDecode:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"samples": ("LATENT",), "vae": ("VAE",)}}

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "decode"

    def decode(self, samples: dict, vae: pl.PipelineBundle, context=None):
        with torch.no_grad():
            return (vae.vae.decode(samples["samples"].to(vae.device)),)


@register_node
class VAEDecodeTiled(VAEDecode):
    """VAEDecode in latent tiles of tile_size / latent_scale (at least
    16) with an eighth of that (at least 4) of overlap each side
    (ops/tiled_vae.py)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "samples": ("LATENT",),
                "vae": ("VAE",),
                "tile_size": ("INT", {"default": 512}),
            }
        }

    FUNCTION = "decode_tiled"

    def decode_tiled(self, samples: dict, vae, tile_size=512, context=None):
        latent_tile = max(16, int(tile_size) // vae.latent_scale)
        return (decode_tiled(vae.vae, samples["samples"].to(vae.device), tile=latent_tile,
                             overlap=max(4, latent_tile // 8)),)


@register_node
class VAEEncode:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"pixels": ("IMAGE",), "vae": ("VAE",)}}

    RETURN_TYPES = ("LATENT",)
    FUNCTION = "encode"

    def encode(self, pixels, vae, context=None):
        with torch.no_grad():
            return ({"samples": vae.vae.encode(torch.as_tensor(pixels).to(vae.device).float())},)


@register_node
class VAEEncodeTiled(VAEEncode):
    """VAEEncode in pixel tiles of tile_size (at least 64) with an eighth
    of that (at least 16) of overlap each side (ops/tiled_vae.py)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "pixels": ("IMAGE",),
                "vae": ("VAE",),
                "tile_size": ("INT", {"default": 512}),
            }
        }

    FUNCTION = "encode_tiled"

    def encode_tiled(self, pixels, vae, tile_size=512, context=None):
        pixel_tile = max(64, int(tile_size))
        pixels = torch.as_tensor(pixels).to(vae.device).float()
        return ({"samples": encode_tiled(vae.vae, pixels, tile=pixel_tile,
                                         overlap=max(16, pixel_tile // 8))},)


def grow_mask(hard: torch.Tensor, g: int) -> torch.Tensor:
    """[B, H, W] 0/1 mask dilated by a g x g max window over [i -
    ceil((g-1)/2), i + floor((g-1)/2)]: for even g one pixel further
    toward -y/-x, as the reference's convolution padding has it, so the
    padding is explicit (a symmetric pool is wrong). The window holds its
    centre and the mask is >= 0, so zeros pad as -inf would."""
    if g <= 0:
        return hard
    lo, hi = g // 2, (g - 1) // 2
    return F.max_pool2d(F.pad(hard[:, None], (lo, hi, lo, hi)), g, stride=1)[:, 0]


@register_node
class VAEEncodeForInpaint:
    """Encode pixels for inpainting: the masked pixels are set to
    mid-gray before the encode, and the mask, grown by `grow_mask_by`
    pixels, rides along at latent resolution as the latent's noise_mask
    (1 = regenerate)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "pixels": ("IMAGE",),
                "vae": ("VAE",),
                "mask": ("MASK",),
            },
            "optional": {"grow_mask_by": ("INT", {"default": 6})},
        }

    RETURN_TYPES = ("LATENT",)
    FUNCTION = "encode"

    def encode(self, pixels, vae: pl.PipelineBundle, mask, grow_mask_by=6, context=None):
        pixels = pixels.to(vae.device).float()
        b, h, w, _ = pixels.shape
        m = torch.as_tensor(mask).to(vae.device).float()
        if m.ndim == 2:
            m = m[None]
        if tuple(m.shape[1:]) != (h, w):
            m = resize_image(m[..., None], h, w, "bilinear")[..., 0]
        # the gray fill takes the un-grown hard mask; only the emitted
        # noise_mask is grown
        hard = (torch.clamp(m, 0.0, 1.0) > 0.5).float()
        grown = grow_mask(hard, int(grow_mask_by))
        neutral = pixels * (1.0 - hard[..., None]) + 0.5 * hard[..., None]
        with torch.no_grad():
            z = vae.vae.encode(neutral)
        return ({
            "samples": z,
            "noise_mask": _mask_to_latent(grown, z.shape[1], z.shape[2]),
            "width": int(w),
            "height": int(h),
        },)


@register_node
class ImagePadForOutpaint:
    """The canvas extended with edge-replicated pixels, and the MASK of
    the new region: 1 there, and inside the original image a squared
    ramp that reaches `feathering` pixels in from each new edge."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "image": ("IMAGE",),
                "left": ("INT", {"default": 0}),
                "top": ("INT", {"default": 0}),
                "right": ("INT", {"default": 0}),
                "bottom": ("INT", {"default": 0}),
                "feathering": ("INT", {"default": 40}),
            }
        }

    RETURN_TYPES = ("IMAGE", "MASK")
    FUNCTION = "expand"

    def expand(self, image, left=0, top=0, right=0, bottom=0, feathering=40, context=None):
        lf, tp, rt, bt = int(left), int(top), int(right), int(bottom)
        fe = int(feathering)
        padded = F.pad(image.permute(0, 3, 1, 2), (lf, rt, tp, bt),
                       mode="replicate").permute(0, 2, 3, 1)
        b, h, w, _ = padded.shape
        mask = np.ones((h, w), np.float32)
        y0, y1, x0, x1 = tp, h - bt, lf, w - rt
        inner = np.zeros((y1 - y0, x1 - x0), np.float32)
        if fe > 0:
            # each original pixel's distance to the nearest new edge
            yy = np.arange(y1 - y0, dtype=np.float32)[:, None]
            xx = np.arange(x1 - x0, dtype=np.float32)[None, :]
            d = np.full(inner.shape, np.inf, np.float32)
            if tp:
                d = np.minimum(d, yy)
            if bt:
                d = np.minimum(d, (y1 - y0 - 1) - yy)
            if lf:
                d = np.minimum(d, xx)
            if rt:
                d = np.minimum(d, (x1 - x0 - 1) - xx)
            inner = (np.clip((fe - d) / fe, 0.0, 1.0) ** 2).astype(np.float32)
        mask[y0:y1, x0:x1] = inner
        mask_t = torch.from_numpy(mask).to(image.device)[None].expand(b, h, w).contiguous()
        return (padded.contiguous(), mask_t)


@register_node
class SetLatentNoiseMask:
    """An inpainting mask attached to latents as their noise_mask."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"samples": ("LATENT",), "mask": ("MASK",)}}

    RETURN_TYPES = ("LATENT",)
    FUNCTION = "set_mask"

    def set_mask(self, samples: dict, mask, context=None):
        z = samples["samples"]
        out = dict(samples)
        out["noise_mask"] = _mask_to_latent(torch.as_tensor(mask).to(z.device), z.shape[1],
                                            z.shape[2])
        return (out,)


def _crop_mode(crop) -> bool:
    """True for crop "center", False for "disabled"; anything else raises."""
    if str(crop) not in ("disabled", "center"):
        raise ValueError(f"unknown crop mode {crop!r}; use disabled|center")
    return str(crop) == "center"


@register_node
class ImageScale:
    """An image resized to (width, height) with ops/resize.py's sampling
    (a 0 side keeps the aspect), optionally centre-cropped to the target
    aspect first, clipped to [0, 1]."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "image": ("IMAGE",),
                "upscale_method": ("STRING", {"default": "bilinear"}),
                "width": ("INT", {"default": 1024}),
                "height": ("INT", {"default": 1024}),
                "crop": ("STRING", {"default": "disabled"}),
            }
        }

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "scale"

    def scale(self, image, upscale_method, width, height, crop="disabled", context=None):
        height, width = resolve_resize_dims(image.shape[1], image.shape[2], int(width),
                                            int(height))
        if _crop_mode(crop):
            (image,) = center_crop_to_aspect([image], height, width)
        out = resize_image(image, height, width, str(upscale_method))
        return (torch.clamp(out, 0.0, 1.0),)


@register_node
class ImageScaleBy:
    """An image resized by a factor (ImageScale at the rounded size)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "image": ("IMAGE",),
                "upscale_method": ("STRING", {"default": "bilinear"}),
                "scale_by": ("FLOAT", {"default": 1.0}),
            }
        }

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "scale"

    def scale(self, image, upscale_method="bilinear", scale_by=1.0, context=None):
        h, w = scale_dims(image.shape[1], image.shape[2], scale_by)
        return ImageScale().scale(image, upscale_method, w, h)


@register_node
class ImageInvert:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"image": ("IMAGE",)}}

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "invert"

    def invert(self, image, context=None):
        return (1.0 - image,)


@register_node
class LatentUpscale:
    """Latents resized to a pixel size (the latent grid is pixels // 8,
    the node convention, whatever the bundle's VAE factor; a 0 side keeps
    the aspect), optionally centre-cropped first; the noise mask
    follows."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "samples": ("LATENT",),
                "upscale_method": ("STRING", {"default": "nearest-exact"}),
                "width": ("INT", {"default": 1024}),
                "height": ("INT", {"default": 1024}),
                "crop": ("STRING", {"default": "disabled"}),
            }
        }

    RETURN_TYPES = ("LATENT",)
    FUNCTION = "upscale"

    def upscale(self, samples: dict, upscale_method="nearest-exact", width=1024, height=1024,
                crop="disabled", context=None):
        z = samples["samples"]
        mask = samples.get("noise_mask")
        h, w = z.shape[1], z.shape[2]
        lh, lw = resolve_resize_dims(h, w, int(width) // 8, int(height) // 8)
        if _crop_mode(crop):
            # the mask joins the crop at the source grid
            if mask is not None:
                mask = _mask_to_latent(torch.as_tensor(mask).to(z.device), h, w)
                z, mask = center_crop_to_aspect([z, mask], lh, lw)
            else:
                (z,) = center_crop_to_aspect([z], lh, lw)
        out = dict(samples)
        out["samples"] = resize_image(z, lh, lw, str(upscale_method))
        out["width"] = lw * 8
        out["height"] = lh * 8
        if mask is not None:
            out["noise_mask"] = _mask_to_latent(torch.as_tensor(mask).to(z.device), lh, lw)
        return (out,)


@register_node
class LatentUpscaleBy:
    """Latents resized by a factor (LatentUpscale at the rounded size)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "samples": ("LATENT",),
                "upscale_method": ("STRING", {"default": "nearest-exact"}),
                "scale_by": ("FLOAT", {"default": 1.5}),
            }
        }

    RETURN_TYPES = ("LATENT",)
    FUNCTION = "upscale"

    def upscale(self, samples: dict, upscale_method="nearest-exact", scale_by=1.5, context=None):
        z = samples["samples"]
        lh, lw = scale_dims(z.shape[1], z.shape[2], scale_by)
        return LatentUpscale().upscale(samples, upscale_method, width=lw * 8, height=lh * 8)


@register_node
class LatentFromBatch:
    """A contiguous run of a latent batch; a per-sample noise mask
    follows."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "samples": ("LATENT",),
                "batch_index": ("INT", {"default": 0}),
                "length": ("INT", {"default": 1}),
            }
        }

    RETURN_TYPES = ("LATENT",)
    FUNCTION = "frombatch"

    def frombatch(self, samples: dict, batch_index=0, length=1, context=None):
        z = samples["samples"]
        b = z.shape[0]
        i0 = min(max(int(batch_index), 0), b - 1)
        i1 = min(i0 + max(int(length), 1), b)
        out = dict(samples)
        out["samples"] = z[i0:i1]
        mask = _per_sample_mask(samples)
        if mask is not None:
            out["noise_mask"] = mask[i0:i1]
        return (out,)


@register_node
class LatentBatch:
    """Two latents joined on the batch axis, the second resized
    (bilinear) to the first's grid where they differ; a noise mask is
    dropped (its rows no longer align)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"samples1": ("LATENT",), "samples2": ("LATENT",)}}

    RETURN_TYPES = ("LATENT",)
    FUNCTION = "batch"

    def batch(self, samples1: dict, samples2: dict, context=None):
        z1, z2 = samples1["samples"], samples2["samples"].to(samples1["samples"].device)
        if tuple(z1.shape[1:3]) != tuple(z2.shape[1:3]):
            z2 = resize_image(z2, z1.shape[1], z1.shape[2], "bilinear")
        out = dict(samples1)
        out["samples"] = torch.cat([z1, z2], dim=0)
        out.pop("noise_mask", None)
        return (out,)


@register_node
class ImageBlur:
    """Gaussian blur (ops/filters.py)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "image": ("IMAGE",),
                "blur_radius": ("INT", {"default": 1}),
                "sigma": ("FLOAT", {"default": 1.0}),
            }
        }

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "blur"

    def blur(self, image, blur_radius=1, sigma=1.0, context=None):
        if int(blur_radius) <= 0:
            return (image,)
        return (gaussian_blur(image, int(blur_radius), float(sigma)),)


@register_node
class ImageSharpen:
    """Unsharp mask: image + alpha * (image - blur), clipped to [0, 1]."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "image": ("IMAGE",),
                "sharpen_radius": ("INT", {"default": 1}),
                "sigma": ("FLOAT", {"default": 1.0}),
                "alpha": ("FLOAT", {"default": 1.0}),
            }
        }

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "sharpen"

    def sharpen(self, image, sharpen_radius=1, sigma=1.0, alpha=1.0, context=None):
        if int(sharpen_radius) <= 0:
            return (image,)
        blurred = gaussian_blur(image, int(sharpen_radius), float(sigma))
        return (torch.clamp(image + float(alpha) * (image - blurred), 0.0, 1.0),)


@register_node
class InpaintModelConditioning:
    """Conditioning for an inpainting checkpoint (sd15-inpaint, a 9-channel
    UNet): the masked pixels set to mid-gray and encoded, the mask and
    those latents joined as the conditioning's concat channels (on both
    sides), the original pixels encoded as the starting latents, and
    the mask optionally riding as the latent's noise_mask."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "positive": ("CONDITIONING",),
                "negative": ("CONDITIONING",),
                "vae": ("VAE",),
                "pixels": ("IMAGE",),
                "mask": ("MASK",),
            },
            "optional": {"noise_mask": ("BOOLEAN", {"default": True})},
        }

    RETURN_TYPES = ("CONDITIONING", "CONDITIONING", "LATENT")
    RETURN_NAMES = ("positive", "negative", "latent")
    FUNCTION = "encode"

    def encode(self, positive, negative, vae, pixels, mask, noise_mask=True, context=None):
        pixels = torch.as_tensor(pixels).to(vae.device).float()
        _, h, w, _ = pixels.shape
        m = torch.as_tensor(mask).to(vae.device).float()
        if m.ndim == 4:
            m = m[..., 0]
        if m.ndim == 2:
            m = m[None]
        if tuple(m.shape[1:]) != (h, w):
            m = resize_image(m[..., None], h, w, "bilinear")[..., 0]
        m = torch.clamp(m, 0.0, 1.0)
        hard = (m > 0.5).float()
        neutral = (pixels - 0.5) * (1.0 - hard[..., None]) + 0.5
        with torch.no_grad():
            z_orig = vae.vae.encode(pixels)
            z_masked = vae.vae.encode(neutral)
        mask_lat = _mask_to_latent(m, z_orig.shape[1], z_orig.shape[2])
        concat = torch.cat([mask_lat.to(z_masked.dtype), z_masked], dim=-1)

        def patch(cond):
            cond.concat_latent = concat
            return cond

        latent = {"samples": z_orig, "width": int(w), "height": int(h)}
        if noise_mask:
            latent["noise_mask"] = mask_lat
        return (map_conditioning(positive, patch), map_conditioning(negative, patch), latent)


@register_node
class LoadImage:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"image": ("STRING", {"default": ""})}}

    RETURN_TYPES = ("IMAGE", "MASK")
    FUNCTION = "load"
    NEVER_CACHE = True  # the file can change between runs

    def load(self, image: str, context=None):
        with open(resolve_input_path(str(image), context), "rb") as fh:
            arr = img_utils.decode_png(fh.read())  # [H, W, 1|3|4] in [0, 1]
        # mask = 1 - alpha (ComfyUI's polarity: transparent → regenerate);
        # no alpha → all zeros
        mask = 1.0 - arr[..., 3] if arr.shape[-1] == 4 else np.zeros(arr.shape[:2], np.float32)
        device = _device(context)
        return (
            torch.from_numpy(np.ascontiguousarray(arr[..., :3]))[None].to(device),
            torch.from_numpy(np.ascontiguousarray(mask))[None].to(device),
        )


@register_node
class SaveImage:
    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "images": ("IMAGE",),
                "filename_prefix": ("STRING", {"default": "output"}),
            }
        }

    RETURN_TYPES = ()
    FUNCTION = "save"
    OUTPUT_NODE = True

    def save(self, images, filename_prefix="output", context=None):
        out_dir = get_output_dir(context)
        os.makedirs(out_dir, exist_ok=True)
        start = next_counter(out_dir, filename_prefix, "png")
        arr = img_utils.ensure_numpy(images)
        saved = []
        for i in range(arr.shape[0]):
            name = f"{filename_prefix}_{start + i:05d}.png"
            with open(os.path.join(out_dir, name), "wb") as fh:
                fh.write(img_utils.encode_png(arr[i], compress_level=4))
            saved.append(name)
        return ({"ui": {"images": saved}, "images": images},)


@register_node
class UpscaleModelLoader:
    """A seeded upscale model by name (its scale from the name, "4x-..."),
    cached in the context under "upscaler:<name>"."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"model_name": ("STRING", {"default": "4x-generic"})}}

    RETURN_TYPES = ("UPSCALE_MODEL",)
    FUNCTION = "load"

    def load(self, model_name: str, context=None):
        key = f"upscaler:{model_name}"
        if key not in context.pipelines:
            context.pipelines[key] = load_upscale_model(str(model_name), device=_device(context))
        return (context.pipelines[key],)


@register_node
class ImageUpscaleWithModel:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"upscale_model": ("UPSCALE_MODEL",), "image": ("IMAGE",)}}

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "upscale"

    def upscale(self, upscale_model, image, context=None):
        with torch.no_grad():
            return (upscale_model.upscale(image),)


@register_node
class PreviewImage:
    """Terminal sink: persists nothing (a worker's pruned prompt ends here)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"images": ("IMAGE",)}}

    RETURN_TYPES = ()
    FUNCTION = "preview"
    OUTPUT_NODE = True

    def preview(self, images, context=None):
        return ({"ui": {"images": []}, "images": images},)
