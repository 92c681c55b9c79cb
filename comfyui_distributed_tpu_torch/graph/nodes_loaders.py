"""Model patch nodes.

The port's own copy of the SD model patches of comfyui_distributed_tpu/
graph/nodes_loaders.py: FreeU, FreeU_V2, PerturbedAttentionGuidance,
SelfAttentionGuidance and RescaleCFG, with the JAX nodes' inputs and
defaults. A patch returns a new bundle through `dataclasses.replace`
(the modules and parameters are shared; FreeU's UNet is a view with its
own config, `UNet.with_freeu`): the bundle the executor caches for the
checkpoint, which other nodes and prompts use, keeps no patch. PAG, SAG
and RescaleCFG compose the guidance, so at most one of them applies to
a model.
"""

from __future__ import annotations

import dataclasses

from ..models import pipeline as pl
from ..models.registry import model_family
from .registry import register_node


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
