"""Core workflow nodes of the upscale and txt2img workflows: checkpoint
→ text encode → empty latent → sample → decode, image load and save.

Counterparts of the same-named nodes in comfyui_distributed_tpu/graph/
nodes_core.py. Data contracts:

    MODEL / CLIP / VAE — views over a models.pipeline.PipelineBundle
    CONDITIONING       — ops.conditioning.Conditioning
    LATENT             — {"samples": [B, h, w, C]} dict (ComfyUI parity)
    IMAGE              — [B, H, W, C] float tensor in [0, 1]

A `SeedSpec` flows out of DistributedSeed: the base seed plus, on a
worker of the elastic tier, its index. The JAX package's mesh branch (a
per-participant SeedSpec sampled as one SPMD program) is not ported: the
multi-GPU tier is ROADMAP.md Queue 1 item 2, and such a spec raises.

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

from ..models import pipeline as pl
from ..utils import image as img_utils
from .io_dirs import get_output_dir, next_counter, resolve_input_path
from .registry import register_node


_MESH_UNPORTED = ("per-participant seeds on a device mesh are not ported yet (ROADMAP.md, "
                  "Queue 1 item 2: the multi-GPU tier)")


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
class CLIPTextEncode:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"text": ("STRING", {"default": ""}), "clip": ("CLIP",)}}

    RETURN_TYPES = ("CONDITIONING",)
    FUNCTION = "encode"

    def encode(self, text: str, clip: pl.PipelineBundle, context=None):
        return (pl.encode_text_pooled(clip, [str(text)]),)


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


def _prep_latents(bundle: pl.PipelineBundle, latent_image: dict):
    """KSampler's input normalisation: a placeholder (`empty`) latent is
    rebuilt to the bundle's latent layout if it differs, and the extras
    the output carries forward are collected (the `empty` marker is
    not). A noise mask (inpainting) and a fixed batch seed
    (LatentBatchSeedBehavior) raise: neither is ported."""
    if latent_image.get("noise_mask") is not None:
        raise NotImplementedError(
            "inpainting (a LATENT with noise_mask) is not ported yet (ROADMAP.md, Queue 1 "
            "item 5: the rest of the sampler, guidance and node catalogue)"
        )
    if latent_image.get("batch_index_fixed"):
        raise NotImplementedError(
            "LatentBatchSeedBehavior 'fixed' is not ported yet (ROADMAP.md, Queue 1 item 5)"
        )
    latents = latent_image["samples"]
    if latent_image.get("empty") and "width" in latent_image:
        shape = (latents.shape[0], latent_image["height"] // bundle.latent_scale,
                 latent_image["width"] // bundle.latent_scale, bundle.latent_channels)
        if tuple(latents.shape) != shape:
            latents = torch.zeros(shape, device=bundle.device)
    extras = {k: v for k, v in latent_image.items() if k not in ("samples", "empty")}
    return latents, extras


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
        latents, extras = _prep_latents(model, latent_image)
        out = pl.img2img_latents(
            model, latents, positive, negative, steps=int(steps), sampler=sampler_name,
            scheduler=scheduler, cfg_scale=float(cfg), denoise=float(denoise),
            seed=spec.effective_seed(),
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
