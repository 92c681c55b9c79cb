"""Core workflow nodes of the upscale, txt2img, two-pass and inpaint
workflows: checkpoint (and a standalone VAE) → clip-skip → text encode
(CLIPTextEncode, CLIPTextEncodeSDXL with its size override,
ConditioningConcat) → empty latent or encode (VAEEncode, VAEEncodeTiled,
VAEEncodeForInpaint) → sample (KSampler, KSamplerAdvanced) → decode
(VAEDecode, VAEDecodeTiled), the upscale model (UpscaleModelLoader,
ImageUpscaleWithModel), image load and save.

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
from ..ops.resize import resize_image
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
    is not; a noise mask is, so a chained pass stays masked). A fixed
    batch seed (LatentBatchSeedBehavior) raises: it is not ported."""
    if latent_image.get("batch_index_fixed"):
        raise NotImplementedError(
            "LatentBatchSeedBehavior 'fixed' is not ported yet (ROADMAP.md, Queue 1 item 2h)"
        )
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
