"""UltimateSDUpscaleDistributed node: the local branch.

Counterpart of comfyui_distributed_tpu/graph/nodes_upscale.py with the
same node surface (image + model/conditioning/vae + sampling knobs +
tile geometry in, upscaled image out). With no workers enabled the node
runs ops/upscale.run_upscale on the context's device. The elastic
worker and master branches and the upscale-model pre-pass are not
ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..models import pipeline as pl
from ..ops import upscale as upscale_ops
from ..ops.samplers import SAMPLER_NAMES
from .registry import register_node

_ELASTIC_TODO = (
    "the elastic USDU tier is not ported to the PyTorch package yet "
    "(ROADMAP.md, Queue 1: elastic USDU tier and the HTTP server)"
)


@register_node
class UltimateSDUpscaleDistributed:
    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "image": ("IMAGE",),
                "model": ("MODEL",),
                "positive": ("CONDITIONING",),
                "negative": ("CONDITIONING",),
                "vae": ("VAE",),
                "seed": ("INT", {"default": 0}),
                "steps": ("INT", {"default": 20}),
                "cfg": ("FLOAT", {"default": 7.0}),
                "sampler_name": ("STRING", {"default": "euler"}),
                "scheduler": ("STRING", {"default": "karras"}),
                "denoise": ("FLOAT", {"default": 0.35}),
                "upscale_by": ("FLOAT", {"default": 2.0}),
                "tile_width": ("INT", {"default": 512}),
                "tile_height": ("INT", {"default": 512}),
                "tile_padding": ("INT", {"default": 32}),
            },
            "optional": {
                "upscale_method": ("STRING", {"default": "bicubic"}),
                "mask_blur": ("INT", {"default": 8}),
                "tiled_decode": ("BOOLEAN", {"default": False}),
                "force_uniform_tiles": ("BOOLEAN", {"default": True}),
                "dynamic_threshold": ("INT", {"default": 8}),
                "upscale_model": ("UPSCALE_MODEL", {"default": None}),
            },
            "hidden": {
                "is_worker": ("BOOLEAN", {"default": False}),
                "worker_id": ("STRING", {"default": ""}),
                "master_url": ("STRING", {"default": ""}),
                "job_id": ("STRING", {"default": ""}),
            },
        }

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "run"
    # re-runs on every queue, as the reference's IS_CHANGED = nan does
    NEVER_CACHE = True

    def run(self, image, model: pl.PipelineBundle, positive, negative, vae, seed=0,
            steps=20, cfg=7.0, sampler_name="euler", scheduler="karras", denoise=0.35,
            upscale_by=2.0, tile_width=512, tile_height=512, tile_padding=32,
            upscale_method="bicubic", mask_blur=8, tiled_decode=False,
            force_uniform_tiles=True, dynamic_threshold=8, upscale_model=None,
            is_worker=False, worker_id="", master_url="", job_id="",
            enabled_worker_ids=None, context=None, **_extra: Any):
        seed = getattr(seed, "base_seed", seed)  # accept SeedSpec links
        if sampler_name not in SAMPLER_NAMES:
            raise ValueError(f"unknown sampler {sampler_name!r}")
        if upscale_model is not None:
            raise NotImplementedError(
                "model-based pre-upscale (UpscaleModelLoader) is not ported yet"
            )
        if is_worker or (enabled_worker_ids and getattr(context, "server", None) is not None):
            raise NotImplementedError(_ELASTIC_TODO)
        if vae is not None and vae.vae is not model.vae:
            # a VAE from another bundle replaces the model's for the tile
            # encode/decode (run_upscale reads the VAE off the bundle)
            model = dataclasses.replace(
                model, vae=vae.vae, latent_channels=vae.latent_channels,
                latent_scale=vae.latent_scale,
            )
        out = upscale_ops.run_upscale(
            bundle=model, image=image, pos=positive, neg=negative,
            mesh=getattr(context, "mesh", None),
            upscale_by=float(upscale_by), tile=int(tile_width), tile_h=int(tile_height),
            padding=int(tile_padding), steps=int(steps), sampler=sampler_name,
            scheduler=scheduler, cfg=float(cfg), denoise=float(denoise), seed=int(seed),
            upscale_method=upscale_method, mask_blur=int(mask_blur),
            tiled_decode=bool(tiled_decode), uniform=bool(force_uniform_tiles),
        )
        return (out,)
