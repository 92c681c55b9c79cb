"""Video workflow nodes (WAN-class t2v and i2v).

Counterpart of comfyui_distributed_tpu/graph/nodes_video.py: a video
checkpoint loader, the video text encoder, an empty video latent, the
flow-matching video sampler, WanImageToVideo, a frame-sequence saver and
the animated-PNG and animated-WEBP savers. VIDEO_LATENT carries the size
the sampler allocates ({"samples": None, "width", "height", "frames",
"batch_size"}); the samplers return the frames as one IMAGE batch
[B F, H, W, 3], which the DistributedCollector gathers frame by frame.

Per-participant seeds on a device mesh (VideoFlowSampler's SPMD branch)
belong to the multi-GPU tier and raise. SaveAnimatedWEBP writes through
the port's own encoder (utils/webp.py; the card's machine has no PIL,
which the JAX node calls): frames are lossless VP8L whatever `lossless`
says, so `lossless=False` gives the exact pixels in a larger file than
libwebp's lossy one (ROADMAP.md, Queue 3), and `quality` is accepted
for the JAX node's inputs and unused.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..models import video_pipeline as vp
from ..models.registry import MODEL_REGISTRY, get_config
from ..utils import image as img_utils
from ..utils import webp
from ..utils.logging import log
from .io_dirs import get_output_dir, next_counter
from .nodes_core import _MESH_UNPORTED, _device, resolve_seed
from .registry import register_node


def _get_video_bundle(context, model_name: str) -> vp.VideoPipelineBundle:
    cache_key = f"video:{model_name}"
    if cache_key not in context.pipelines:
        log(f"loading video pipeline {model_name!r}")
        context.pipelines[cache_key] = vp.load_video_pipeline(model_name,
                                                              device=_device(context))
    return context.pipelines[cache_key]


def video_model_name(ckpt_name) -> str:
    """A workflow's ckpt_name as a registry name: the name itself where the
    registry has it ("wan-1.3b"), else without its file extension
    ("wan-14b.safetensors"). The JAX node strips an extension always, so
    the bundled distributed-wan.json's "wan-1.3b" loads "wan-1" there."""
    name = str(ckpt_name)
    return name if name in MODEL_REGISTRY else os.path.splitext(name)[0]


def _flat_frames(out):
    """[B, F, H, W, 3] → the IMAGE batch [B F, H, W, 3]."""
    return out.reshape((out.shape[0] * out.shape[1],) + tuple(out.shape[2:]))


@register_node
class VideoCheckpointLoader:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"ckpt_name": ("STRING", {"default": "tiny-dit"})}}

    RETURN_TYPES = ("MODEL", "CLIP", "VAE")
    FUNCTION = "load"

    def load(self, ckpt_name: str, context=None):
        bundle = _get_video_bundle(context, video_model_name(ckpt_name))
        return (bundle, bundle, bundle)


@register_node
class VideoCLIPTextEncode:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"text": ("STRING", {"default": ""}), "clip": ("CLIP",)}}

    RETURN_TYPES = ("CONDITIONING",)
    FUNCTION = "encode"

    def encode(self, text, clip, context=None):
        return (vp.encode_video_text(clip, [str(text)]),)


@register_node
class EmptyVideoLatent:
    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "width": ("INT", {"default": 256}),
                "height": ("INT", {"default": 256}),
                "frames": ("INT", {"default": 17}),
                "batch_size": ("INT", {"default": 1}),
            }
        }

    RETURN_TYPES = ("VIDEO_LATENT",)
    FUNCTION = "generate"

    def generate(self, width, height, frames, batch_size=1, context=None):
        return ({
            "samples": None,  # allocated by the sampler (it knows the model's sizes)
            "width": int(width),
            "height": int(height),
            "frames": int(frames),
            "batch_size": int(batch_size),
        },)


@register_node
class VideoFlowSampler:
    """Flow-matching t2v sampler at the participant's effective seed; the
    batch is the conditioning's."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL",),
                "seed": ("INT", {"default": 0}),
                "steps": ("INT", {"default": 20}),
                "cfg": ("FLOAT", {"default": 5.0}),
                "positive": ("CONDITIONING",),
                "negative": ("CONDITIONING",),
                "latent": ("VIDEO_LATENT",),
            }
        }

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "sample"

    def sample(self, model, seed, steps, cfg, positive, negative, latent, context=None):
        spec = resolve_seed(seed)
        if spec.per_participant:
            raise NotImplementedError(_MESH_UNPORTED)
        out = vp.t2v_from_cond(
            model, positive, negative, spec.effective_seed(), int(latent.get("frames", 17)),
            int(latent.get("height", 256)), int(latent.get("width", 256)), int(steps),
            float(cfg))
        return (_flat_frames(out),)


@register_node
class WanImageToVideo:
    """Image → video (the WAN i2v workflow's role): i2v-layout models run
    the native conditioning (the mask and reference-clip latent joined to
    the input, the CLIP-vision tokens), other video models clamp frame 0
    along the flow path. Fan-out across participants rides the elastic
    tier's per-worker seed offsets."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL",),
                "image": ("IMAGE",),
                "prompt": ("STRING", {"default": ""}),
                "negative_prompt": ("STRING", {"default": ""}),
                "frames": ("INT", {"default": 17}),
                "steps": ("INT", {"default": 20}),
                "cfg": ("FLOAT", {"default": 5.0}),
                "seed": ("INT", {"default": 0}),
            }
        }

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "generate"

    def generate(self, model, image, prompt="", negative_prompt="", frames=17, steps=20,
                 cfg=5.0, seed=0, context=None):
        spec = resolve_seed(seed)
        if spec.per_participant:
            # the JAX node refuses a mesh fan-out; a mesh is the multi-GPU tier
            raise ValueError(
                "WanImageToVideo does not fan out per-participant seeds on a mesh (the i2v "
                "conditioning batch is per reference image); distribute i2v via the elastic "
                "tier's per-worker seed offsets instead")
        n_frames = int(frames)
        if get_config(model.model_name).i2v and n_frames % 4 != 1:
            # the WAN causal VAE's stride; the fallback has none
            raise ValueError(f"frame count must be 4n+1 for i2v-layout models; got {n_frames}")
        out = vp.i2v(model, image, str(prompt), negative_prompt=str(negative_prompt),
                     frames=n_frames, steps=int(steps), cfg_scale=float(cfg),
                     seed=int(spec.effective_seed()))
        return (_flat_frames(out),)


@register_node
class SaveVideoFrames:
    """A frame sequence as numbered PNGs and a manifest (the
    video-combine role, without containers: frames and manifest are the
    portable output)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "images": ("IMAGE",),
                "filename_prefix": ("STRING", {"default": "video"}),
                "fps": ("INT", {"default": 8}),
            }
        }

    RETURN_TYPES = ()
    FUNCTION = "save"
    OUTPUT_NODE = True

    def save(self, images, filename_prefix="video", fps=8, context=None):
        out_dir = get_output_dir(context)
        os.makedirs(out_dir, exist_ok=True)
        arr = img_utils.ensure_numpy(images)
        saved = [f"{filename_prefix}_{i:05d}.png" for i in range(arr.shape[0])]

        def write(i):
            with open(os.path.join(out_dir, saved[i]), "wb") as fh:
                fh.write(img_utils.encode_png(arr[i], compress_level=4))

        # numpy's conversion and zlib release the GIL: the frames encode on
        # every core at once
        with ThreadPoolExecutor(max(1, min(len(saved), os.cpu_count() or 1))) as pool:
            list(pool.map(write, range(len(saved))))
        with open(os.path.join(out_dir, f"{filename_prefix}_manifest.json"), "w") as fh:
            json.dump({"frames": saved, "fps": int(fps)}, fh)
        return ({"ui": {"images": saved, "fps": fps}, "images": images},)


@register_node
class SaveAnimatedPNG:
    """One animated PNG of every frame, looping forever, each shown
    round(1000 / fps) ms; the name counter-scanned like SaveImage's."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "images": ("IMAGE",),
                "filename_prefix": ("STRING", {"default": "animated"}),
                "fps": ("INT", {"default": 8}),
                "compress_level": ("INT", {"default": 4}),
            }
        }

    RETURN_TYPES = ()
    FUNCTION = "save"
    OUTPUT_NODE = True

    def save(self, images, filename_prefix="animated", fps=8, compress_level=4, context=None):
        out_dir = get_output_dir(context)
        os.makedirs(out_dir, exist_ok=True)
        prefix = str(filename_prefix)
        name = f"{prefix}_{next_counter(out_dir, prefix, 'png'):05d}.png"
        frames = img_utils.f32_to_u8(img_utils.ensure_numpy(images))
        duration_ms = int(round(1000.0 / max(int(fps), 1)))
        with open(os.path.join(out_dir, name), "wb") as fh:
            fh.write(img_utils.encode_apng_u8(frames, duration_ms, int(compress_level)))
        return ({"ui": {"images": [name], "fps": int(fps)}, "images": images},)


@register_node
class SaveAnimatedWEBP:
    """One animated WEBP of every frame, looping forever, each shown
    round(1000 / fps) ms; the name counter-scanned like SaveImage's.
    Lossless always (see the module docstring)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "images": ("IMAGE",),
                "filename_prefix": ("STRING", {"default": "animated"}),
                "fps": ("INT", {"default": 8}),
                "lossless": ("BOOLEAN", {"default": True}),
                "quality": ("INT", {"default": 80}),
            }
        }

    RETURN_TYPES = ()
    FUNCTION = "save"
    OUTPUT_NODE = True

    def save(self, images, filename_prefix="animated", fps=8, lossless=True, quality=80,
             context=None):
        out_dir = get_output_dir(context)
        os.makedirs(out_dir, exist_ok=True)
        prefix = str(filename_prefix)
        name = f"{prefix}_{next_counter(out_dir, prefix, 'webp'):05d}.webp"
        frames = img_utils.f32_to_u8(img_utils.ensure_numpy(images))
        if frames.shape[-1] == 1:  # a gray batch, as PIL writes an "L" frame
            frames = np.repeat(frames, 3, axis=-1)
        duration_ms = int(round(1000.0 / max(int(fps), 1)))
        with open(os.path.join(out_dir, name), "wb") as fh:
            fh.write(webp.encode_animated_webp(frames, duration_ms))
        return ({"ui": {"images": [name], "fps": int(fps)}, "images": images},)
