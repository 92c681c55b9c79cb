"""UltimateSDUpscaleDistributed node.

Counterpart of comfyui_distributed_tpu/graph/nodes_upscale.py with the
same node surface (image + model/conditioning/vae + sampling knobs +
tile geometry in, upscaled image out) and the same routing:

- no workers enabled → ops/upscale.run_upscale on the context's device,
  wearing the request's adapter plan where the queue route noted one
  (the JAX package's local path drops it);
- a worker's rewritten prompt (is_worker) → graph/usdu_elastic.py::
  run_worker_loop, which pulls tiles from the master over HTTP;
- a master with enabled workers and a server → run_master_elastic.

An image batch of more than one frame and at least `dynamic_threshold`
frames takes dynamic mode instead on both roles (run_worker_dynamic,
run_master_dynamic: whole frames queued, each run by whoever pulls it).
Master and workers decide it alike from the same inputs.

With an `upscale_model`, every participant runs the model on the same
image and resizes it (cubic) to the exact target, and the tiles refine
it at 1x (`pre_upscale`).

The mesh tier is not ported yet and raises with its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..models import pipeline as pl
from ..ops import upscale as upscale_ops
from ..ops.resize import resize_image
from ..ops.samplers import check_sampler_names
from .registry import register_node


def pre_upscale(image, upscale_model, upscale_by: float):
    """The upscale-model pre-pass → (image, upscale_by for the tiles):
    the model's output resized (cubic, jax.image.resize's antialiased
    Keys kernel when it shrinks) to round(side * upscale_by / 8) * 8,
    the tiles then at 1x. Deterministic per model name, so every
    participant makes the same image."""
    _, h, w, _ = image.shape
    target_h = int(round(h * float(upscale_by) / 8)) * 8
    target_w = int(round(w * float(upscale_by) / 8)) * 8
    out = upscale_model.upscale(image)
    if out.shape[1] != target_h or out.shape[2] != target_w:
        out = resize_image(out, target_h, target_w, "bicubic")
    return out, 1.0


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
        check_sampler_names(sampler_name, scheduler)
        if upscale_model is not None:
            image, upscale_by = pre_upscale(image, upscale_model, upscale_by)
        if vae is not None and vae.vae is not model.vae:
            # a VAE from another bundle replaces the model's for the tile
            # encode/decode (run_upscale reads the VAE off the bundle)
            model = dataclasses.replace(
                model, vae=vae.vae, latent_channels=vae.latent_channels,
                latent_scale=vae.latent_scale,
            )
        # mode selection, made alike on master and workers from shared
        # inputs: dynamic (frame queue) for large batches, static (tile
        # queue) otherwise
        dynamic = int(image.shape[0]) > 1 and int(image.shape[0]) >= int(dynamic_threshold)
        enabled = list(enabled_worker_ids or [])
        common = dict(
            bundle=model, image=image, pos=positive, neg=negative,
            upscale_by=float(upscale_by), tile=int(tile_width), tile_h=int(tile_height),
            padding=int(tile_padding), steps=int(steps), sampler=sampler_name,
            scheduler=scheduler, cfg=float(cfg), denoise=float(denoise), seed=int(seed),
            upscale_method=upscale_method, mask_blur=int(mask_blur),
            tiled_decode=bool(tiled_decode), uniform=bool(force_uniform_tiles),
            context=context,
        )
        if is_worker:
            from .usdu_elastic import run_worker_dynamic, run_worker_loop

            worker_fn = run_worker_dynamic if dynamic else run_worker_loop
            worker_fn(job_id=job_id, worker_id=worker_id, master_url=master_url,
                      mesh=getattr(context, "mesh", None), **common)
            return (image,)
        if enabled and getattr(context, "server", None) is not None:
            from .usdu_elastic import run_master_dynamic, run_master_elastic

            master_fn = run_master_dynamic if dynamic else run_master_elastic
            return (master_fn(job_id=job_id, enabled_worker_ids=enabled,
                              mesh=getattr(context, "mesh", None), **common),)
        del common["context"]
        store = getattr(getattr(context, "server", None), "job_store", None)
        wire = store.take_job_adapters(job_id) if store is not None and job_id else []
        if wire:
            from ..adapters import get_adapter_catalog, specs_from_wire
            from .usdu_elastic import patched_bundle

            specs = get_adapter_catalog().resolve(specs_from_wire(wire))
            common["bundle"] = patched_bundle(model, specs, context, "master")
        return (upscale_ops.run_upscale(mesh=getattr(context, "mesh", None), **common),)
