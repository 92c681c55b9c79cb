"""Component loaders and model patch nodes.

The port's own copy of comfyui_distributed_tpu/graph/nodes_loaders.py's
SD, Flux and SD3 nodes, with the JAX nodes' inputs and defaults: the
component loaders Flux and SD3.5 ship for (UNETLoader, CLIPLoader,
DualCLIPLoader of types sdxl, flux and sd3, TripleCLIPLoader),
EmptySD3LatentImage, the schedule patches ModelSamplingDiscrete,
ModelSamplingFlux and ModelSamplingSD3, and the SD model patches
FreeU, FreeU_V2, PerturbedAttentionGuidance, SelfAttentionGuidance and
RescaleCFG. A loader caches its bundle in the context under the JAX
package's keys ("unet:<name>", "clip:<layout>:<names>"). A patch
returns a new bundle through `dataclasses.replace` (the modules and
parameters are shared; FreeU's UNet is a view with its own config,
`UNet.with_freeu`): the bundle the executor caches for the
checkpoint, which other nodes and prompts use, keeps no patch. PAG, SAG
and RescaleCFG compose the guidance, so at most one of them applies to
a model. ModelMergeSimple and CLIPMergeSimple blend two bundles'
parameters into new modules; neither input changes. CLIPVisionLoader
(cached under "clip_vision:<name>") and CLIPVisionEncode run WAN i2v's
image tower (models/clip_vision.py); unCLIPConditioning attaches its
tokens to the conditioning, where a sampler refuses them as the JAX
package does (no backbone has an unCLIP adm head).
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch

from ..models import pipeline as pl
from ..models.registry import MODEL_REGISTRY, model_family
from .nodes_core import _device
from .registry import register_node


def _stem(name: str) -> str:
    """A workflow's file name ('clip_l.safetensors') as a registry name:
    the stem, its underscores made the registry's hyphens where only
    that form is known."""
    base = os.path.splitext(str(name))[0]
    if base in MODEL_REGISTRY:
        return base
    hyphenated = base.replace("_", "-")
    return hyphenated if hyphenated in MODEL_REGISTRY else base


def _cached(context, key: str, load):
    cache = context.pipelines if context is not None else {}
    if key not in cache:
        cache[key] = load()
    return cache[key]


@register_node
class UNETLoader:
    """A diffusion backbone alone (`pl.load_unet`). weight_dtype takes
    ComfyUI's values; the compute dtype is the config's, so anything but
    'default' is accepted and changes nothing."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "unet_name": ("STRING", {"default": "tiny-unet"}),
                "weight_dtype": ("STRING", {"default": "default"}),
            }
        }

    RETURN_TYPES = ("MODEL",)
    FUNCTION = "load_unet"

    def load_unet(self, unet_name, weight_dtype="default", context=None):
        name = _stem(unet_name)
        return (_cached(context, f"unet:{name}",
                        lambda: pl.load_unet(name, device=_device(context))),)


def _load_clip_cached(names: list[str], layout: str, context):
    return _cached(context, f"clip:{layout}:" + ",".join(names),
                   lambda: pl.load_clip(names, layout=layout, device=_device(context)))


# ComfyUI's type values → load_clip layouts
_CLIP_TYPE_MAP = {"stable_diffusion": "sd", "sdxl": "sdxl", "flux": "flux", "sd3": "sd3"}


@register_node
class CLIPLoader:
    """One text encoder (type stable_diffusion)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "clip_name": ("STRING", {"default": "clip-l"}),
                "type": ("STRING", {"default": "stable_diffusion"}),
            }
        }

    RETURN_TYPES = ("CLIP",)
    FUNCTION = "load_clip"

    def load_clip(self, clip_name, type="stable_diffusion", context=None):
        if str(type) != "stable_diffusion":
            raise ValueError("CLIPLoader loads one encoder; type must be 'stable_diffusion' "
                             "(use DualCLIPLoader/TripleCLIPLoader for sdxl/flux/sd3 layouts)")
        return (_load_clip_cached([_stem(clip_name)], "sd", context),)


@register_node
class DualCLIPLoader:
    """Two text encoders: type sdxl (CLIP-L + CLIP-G), flux (a CLIP and a
    T5, either order) or sd3 (CLIP-L + CLIP-G without the T5: the SD3
    composition on the CLIP sequence alone)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "clip_name1": ("STRING", {"default": "clip-l"}),
                "clip_name2": ("STRING", {"default": "clip-g"}),
                "type": ("STRING", {"default": "sdxl"}),
            }
        }

    RETURN_TYPES = ("CLIP",)
    FUNCTION = "load_clip"

    def load_clip(self, clip_name1, clip_name2, type="sdxl", context=None):
        layout = _CLIP_TYPE_MAP.get(str(type))
        if layout is None or layout == "sd":
            raise ValueError(f"DualCLIPLoader type must be sdxl, flux, or sd3; got {type!r}")
        return (_load_clip_cached([_stem(clip_name1), _stem(clip_name2)], layout, context),)


@register_node
class TripleCLIPLoader:
    """SD3's three text encoders: CLIP-L, CLIP-G and the T5 (the CLIPs in
    either order, the T5 found by family)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "clip_name1": ("STRING", {"default": "clip-l-sd3"}),
                "clip_name2": ("STRING", {"default": "clip-g"}),
                "clip_name3": ("STRING", {"default": "t5-xxl-sd3"}),
            }
        }

    RETURN_TYPES = ("CLIP",)
    FUNCTION = "load_clip"

    def load_clip(self, clip_name1, clip_name2, clip_name3, context=None):
        names = [_stem(clip_name1), _stem(clip_name2), _stem(clip_name3)]
        return (_load_clip_cached(names, "sd3", context),)


@register_node
class EmptySD3LatentImage:
    """16-channel empty latents (the SD3/Flux workflows' start), with
    EmptyLatentImage's placeholder marker: KSampler rebuilds them to the
    bundle's latent layout if it differs."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "width": ("INT", {"default": 1024}),
                "height": ("INT", {"default": 1024}),
                "batch_size": ("INT", {"default": 1}),
            }
        }

    RETURN_TYPES = ("LATENT",)
    FUNCTION = "generate"

    def generate(self, width=1024, height=1024, batch_size=1, context=None):
        samples = torch.zeros((int(batch_size), int(height) // 8, int(width) // 8, 16),
                              device=_device(context))
        return ({"samples": samples, "width": int(width), "height": int(height), "empty": True},)


def _require_flow(model: pl.PipelineBundle, node_name: str) -> None:
    if pl.model_schedule_info(model) != "flow":
        raise ValueError(f"{node_name} patches flow-matching models (Flux/SD3 class); "
                         f"{model.model_name!r} is not one")


@register_node
class ModelSamplingSD3:
    """The rectified-flow schedule's shift, set outright (SD3's 3.0 by
    default)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL",),
                "shift": ("FLOAT", {"default": 3.0}),
            }
        }

    RETURN_TYPES = ("MODEL",)
    FUNCTION = "patch"

    def patch(self, model, shift=3.0, context=None):
        _require_flow(model, "ModelSamplingSD3")
        return (dataclasses.replace(model, flow_shift_override=float(shift)),)


@register_node
class ModelSamplingFlux:
    """The resolution-dependent flow shift: mu linear in the image tokens
    (pixels / 16 a side) from base_shift at 256 to max_shift at 4096, the
    shift exp(mu) (Flux's time_shift(mu, t) is the shifted sigma s t / (1
    + (s - 1) t) with s = e^mu)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL",),
                "max_shift": ("FLOAT", {"default": 1.15}),
                "base_shift": ("FLOAT", {"default": 0.5}),
                "width": ("INT", {"default": 1024}),
                "height": ("INT", {"default": 1024}),
            }
        }

    RETURN_TYPES = ("MODEL",)
    FUNCTION = "patch"

    def patch(self, model, max_shift=1.15, base_shift=0.5, width=1024, height=1024,
              context=None):
        _require_flow(model, "ModelSamplingFlux")
        seq = (int(width) // 16) * (int(height) // 16)
        mu = float(base_shift) + (float(max_shift) - float(base_shift)) * (
            (seq - 256) / (4096 - 256))
        return (dataclasses.replace(model, flow_shift_override=math.exp(mu)),)


def _require_unet(model: pl.PipelineBundle, node_name: str, what: str) -> None:
    family = model_family(model.model_name)
    if family != "unet":
        raise ValueError(f"{node_name} {what}; {model.model_name!r} is {family}-family")


def _patch_freeu(model: pl.PipelineBundle, b1, b2, s1, s2, v2: bool):
    _require_unet(model, "FreeU", "patches SD-class UNets (skip-connection joins)")
    freeu = (float(b1), float(b2), float(s1), float(s2), bool(v2))
    return dataclasses.replace(model, unet=model.unet.with_freeu(freeu))


@register_node
class PerturbedAttentionGuidance:
    """PAG (Ahn et al. 2024): each step gains scale * (cond - cond with
    the middle block's self-attention replaced by identity). UNet family
    only."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL",),
                "scale": ("FLOAT", {"default": 3.0}),
            }
        }

    RETURN_TYPES = ("MODEL",)
    FUNCTION = "patch"

    def patch(self, model: pl.PipelineBundle, scale=3.0, context=None):
        _require_unet(model, "PerturbedAttentionGuidance", "patches UNet self-attention")
        pl.reject_existing_guidance_patches(model, "PerturbedAttentionGuidance")
        return (dataclasses.replace(model, pag=pl.PAGSpec(scale=float(scale))),)


@register_node
class FreeU:
    """FreeU: at the model_channels*4 and *2 up-path joins, the first half
    of the backbone's channels scales by b1/b2 and the skip's
    low-frequency Fourier box by s1/s2."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL",),
                "b1": ("FLOAT", {"default": 1.1}),
                "b2": ("FLOAT", {"default": 1.2}),
                "s1": ("FLOAT", {"default": 0.9}),
                "s2": ("FLOAT", {"default": 0.2}),
            }
        }

    RETURN_TYPES = ("MODEL",)
    FUNCTION = "patch"

    def patch(self, model: pl.PipelineBundle, b1=1.1, b2=1.2, s1=0.9, s2=0.2, context=None):
        return (_patch_freeu(model, b1, b2, s1, s2, v2=False),)


@register_node
class FreeU_V2:
    """FreeU v2: the backbone scale follows the normalised per-pixel
    hidden mean instead of a constant."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL",),
                "b1": ("FLOAT", {"default": 1.3}),
                "b2": ("FLOAT", {"default": 1.4}),
                "s1": ("FLOAT", {"default": 0.9}),
                "s2": ("FLOAT", {"default": 0.2}),
            }
        }

    RETURN_TYPES = ("MODEL",)
    FUNCTION = "patch"

    def patch(self, model: pl.PipelineBundle, b1=1.3, b2=1.4, s1=0.9, s2=0.2, context=None):
        return (_patch_freeu(model, b1, b2, s1, s2, v2=True),)


@register_node
class SelfAttentionGuidance:
    """SAG (Hong et al. 2023): blur the uncond x0 estimate where the
    middle block's self-attention concentrates, re-noise it, and guide
    away from the degraded prediction (ops/samplers.py::sag_cfg_model).
    UNet family only."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL",),
                "scale": ("FLOAT", {"default": 0.5}),
                "blur_sigma": ("FLOAT", {"default": 2.0}),
            }
        }

    RETURN_TYPES = ("MODEL",)
    FUNCTION = "patch"

    def patch(self, model: pl.PipelineBundle, scale=0.5, blur_sigma=2.0, context=None):
        _require_unet(model, "SelfAttentionGuidance", "captures UNet middle-block attention")
        pl.reject_existing_guidance_patches(model, "SelfAttentionGuidance")
        spec = pl.SAGSpec(scale=float(scale), blur_sigma=float(blur_sigma))
        return (dataclasses.replace(model, sag=spec),)


@register_node
class RescaleCFG:
    """Std-rescaled guidance: the guided prediction rescaled, in v space,
    to the positive prediction's per-sample std, lerped by `multiplier`
    (ops/samplers.py::rescale_cfg_model)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL",),
                "multiplier": ("FLOAT", {"default": 0.7}),
            }
        }

    RETURN_TYPES = ("MODEL",)
    FUNCTION = "patch"

    def patch(self, model: pl.PipelineBundle, multiplier=0.7, context=None):
        pl.reject_existing_guidance_patches(model, "RescaleCFG")
        return (dataclasses.replace(model, cfg_rescale=float(multiplier)),)


@register_node
class ModelSamplingDiscrete:
    """The VP parameterization the model is sampled with, in place of its
    config's: "eps" or "v_prediction". zsnr rescaling is not implemented
    and raises, as in the JAX package."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL",),
                "sampling": ("STRING", {"default": "eps"}),
                "zsnr": ("BOOLEAN", {"default": False}),
            }
        }

    RETURN_TYPES = ("MODEL",)
    FUNCTION = "patch"

    def patch(self, model: pl.PipelineBundle, sampling="eps", zsnr=False, context=None):
        mapping = {"eps": "eps", "v_prediction": "v"}
        if str(sampling) not in mapping:
            raise ValueError(f"sampling must be one of {sorted(mapping)}; got {sampling!r}")
        if zsnr:
            raise ValueError("zsnr rescaling is not implemented in this framework")
        return (dataclasses.replace(model, parameterization_override=mapping[str(sampling)]),)


@torch.no_grad()
def _merge_modules(m1: torch.nn.Module, m2: torch.nn.Module, ratio: float, what: str):
    """ratio * m1 + (1 - ratio) * m2 over two modules of one architecture
    (the ComfyUI convention: ratio 1.0 is m1), each floating parameter in
    f32 and cast back to m1's dtype, the others kept from m1. A new module
    (models/io.py::with_parameters); neither input changes."""
    from ..models.io import with_parameters

    p1, p2 = dict(m1.named_parameters()), dict(m2.named_parameters())
    if list(p1) != list(p2):
        raise ValueError(f"{what}: parameter trees differ; merging needs two checkpoints of "
                         "the same architecture")
    r = float(ratio)
    merged = {}
    for name, a in p1.items():
        b = p2[name]
        if a.shape != b.shape:
            raise ValueError(f"{what}: shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
        if a.is_floating_point():
            merged[name] = (a.float() * r + b.to(a.device).float() * (1.0 - r)).to(a.dtype)
    return with_parameters(m1, merged)


@register_node
class ModelMergeSimple:
    """Weighted average of two diffusion backbones: ratio weights model1.
    The merged bundle keeps model1's config and patches; only the
    backbone's parameters blend."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "model1": ("MODEL",),
            "model2": ("MODEL",),
            "ratio": ("FLOAT", {"default": 1.0}),
        }}

    RETURN_TYPES = ("MODEL",)
    FUNCTION = "merge"

    def merge(self, model1: pl.PipelineBundle, model2: pl.PipelineBundle, ratio=1.0,
              context=None):
        unet = _merge_modules(model1.unet, model2.unet, ratio, "ModelMergeSimple")
        return (dataclasses.replace(model1, unet=unet),)


@register_node
class CLIPMergeSimple:
    """Weighted average of two text-encoder stacks: each tower clip1
    holds (te, te2, te3) blends with clip2's."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "clip1": ("CLIP",),
            "clip2": ("CLIP",),
            "ratio": ("FLOAT", {"default": 1.0}),
        }}

    RETURN_TYPES = ("CLIP",)
    FUNCTION = "merge"

    def merge(self, clip1: pl.PipelineBundle, clip2: pl.PipelineBundle, ratio=1.0,
              context=None):
        towers = {}
        for part, field in (("te", "text_encoder"), ("te2", "text_encoder_2"),
                            ("te3", "text_encoder_3")):
            mine = getattr(clip1, field)
            if mine is None:
                continue
            theirs = getattr(clip2, field)
            if theirs is None:
                raise ValueError(f"CLIPMergeSimple: clip2 has no {part!r} part")
            towers[field] = _merge_modules(mine, theirs, ratio, f"CLIPMergeSimple[{part}]")
        return (dataclasses.replace(clip1, **towers),)


@register_node
class CLIPVisionLoader:
    """A standalone CLIP-vision tower by registry name (clip-vision-h,
    tiny-clip-vision), its weights from CDT_CHECKPOINT_DIR/<name>.* where
    that resolves, as the i2v bundle's."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"clip_name": ("STRING", {"default": "clip-vision-h"})}}

    RETURN_TYPES = ("CLIP_VISION",)
    FUNCTION = "load_clip"

    def load_clip(self, clip_name: str, context=None):
        from ..models.clip_vision import load_clip_vision

        name = _stem(clip_name)
        return (_cached(context, f"clip_vision:{name}",
                        lambda: load_clip_vision(name, device=_device(context))),)


@dataclasses.dataclass(frozen=True)
class ClipVisionOutput:
    """A CLIP_VISION_OUTPUT value: the hidden-state tokens [B, T, width],
    class token first. No pooled accessor: the towers stop at the
    penultimate layer (no last block, post LN or projection), so a raw
    class token would be a plausible, wrong stand-in for CLIP's pooled
    embedding."""

    tokens: object


@register_node
class CLIPVisionEncode:
    """An image batch through a CLIP-vision tower: the tower's own
    preprocessing is short-side scale and centre crop, so crop 'center'
    only."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "clip_vision": ("CLIP_VISION",),
                "image": ("IMAGE",),
                "crop": ("STRING", {"default": "center"}),
            }
        }

    RETURN_TYPES = ("CLIP_VISION_OUTPUT",)
    FUNCTION = "encode"

    def encode(self, clip_vision, image, crop="center", context=None):
        if str(crop) != "center":
            raise ValueError("only crop='center' is implemented (the tower's preprocessing is "
                             "short-side scale + center crop)")
        return (ClipVisionOutput(tokens=clip_vision.encode(image)),)


@register_node(name="unCLIPConditioning")
class UnCLIPConditioning:
    """CLIP-vision tokens onto the conditioning (ComfyUI's
    unCLIPConditioning shape). No backbone has an unCLIP adm head, so a
    sampler given such conditioning raises (ops/conditioning.py::
    reject_unported) instead of dropping the image condition."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "conditioning": ("CONDITIONING",),
                "clip_vision_output": ("CLIP_VISION_OUTPUT",),
                "strength": ("FLOAT", {"default": 1.0}),
                "noise_augmentation": ("FLOAT", {"default": 0.0}),
            }
        }

    RETURN_TYPES = ("CONDITIONING",)
    FUNCTION = "apply_adm"

    def apply_adm(self, conditioning, clip_vision_output, strength=1.0, noise_augmentation=0.0,
                  context=None):
        from ..ops.conditioning import map_conditioning

        def patch(cond):
            cond.unclip_embeds = clip_vision_output.tokens
            cond.unclip_strength = float(strength)
            cond.unclip_noise_aug = float(noise_augmentation)
            return cond

        return (map_conditioning(conditioning, patch),)
