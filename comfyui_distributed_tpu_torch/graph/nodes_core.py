"""Core workflow nodes of the upscale workflow: checkpoint → text
encode, image load and save.

Counterparts of the same-named nodes in comfyui_distributed_tpu/graph/
nodes_core.py. Data contracts:

    MODEL / CLIP / VAE — views over a models.pipeline.PipelineBundle
    CONDITIONING       — ops.conditioning.Conditioning
    IMAGE              — [B, H, W, C] float tensor in [0, 1]

LoadImage and SaveImage read and write PNG through the port's own codec
(utils/image.py): the machine that runs the card has no PIL. PreviewImage
is the terminal sink a worker's pruned prompt ends in.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models import pipeline as pl
from ..utils import image as img_utils
from .io_dirs import get_output_dir, next_counter, resolve_input_path
from .registry import register_node


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
