"""ControlNet and conditioning nodes of the SD family.

Counterparts of the same-named nodes in comfyui_distributed_tpu/graph/
nodes_controlnet.py, with their inputs and defaults: ControlNetLoader,
ControlNetApply, ControlNetApplyAdvanced (the hint on both sides, gated
to a sampling window), and the conditioning modifiers ConditioningSetArea,
ConditioningSetAreaPercentage, ConditioningCombine, ConditioningAverage,
ConditioningZeroOut, ConditioningSetTimestepRange and ConditioningSetMask.
A modifier applies to every entry of a list (ConditioningCombine's
output). The hint rides on the conditioning and the USDU path windows it
to each tile (ops/upscale.py::prep_cond_for_tiles, tile_cond).

The Flux nodes of that file ride here too: FluxGuidance (the distilled
guidance scale on every entry) and ReferenceLatent (Kontext's reference
latents, which the tile path windows per tile); and SD3.5's
SkipLayerGuidanceSD3, a guidance patch on the model
(models/pipeline.py::SLGSpec, ops/samplers.py::slg_cfg_model).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..models import pipeline as pl
from ..models.controlnet import load_controlnet
from ..models.registry import get_config, model_family
from ..ops.conditioning import as_conditioning, map_conditioning
from .nodes_core import _device
from .registry import register_node


@register_node
class ControlNetLoader:
    """A seeded ControlNet by name, its width and downscale taken from
    `model` where one is wired in (else SD's 320 and 8), cached in the
    context under "controlnet:<name>:<width>:<downscale>"."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {"control_net_name": ("STRING", {"default": "tile"})},
            "optional": {"model": ("MODEL", {"default": None})},
        }

    RETURN_TYPES = ("CONTROL_NET",)
    FUNCTION = "load"

    def load(self, control_net_name: str, model=None, context=None):
        model_channels, downscale = 320, 8
        if model is not None:
            model_channels = get_config(model.model_name).model_channels
            downscale = model.latent_scale
        key = f"controlnet:{control_net_name}:{model_channels}:{downscale}"
        if key not in context.pipelines:
            context.pipelines[key] = load_controlnet(str(control_net_name), model_channels,
                                                     downscale, device=_device(context))
        return (context.pipelines[key],)


def _hint_patch(control_net, image, strength: float, window: tuple | None):
    def patch(cond):
        cond.control_hint = image
        cond.control_strength = float(strength)
        cond.control_net = control_net
        cond.control_range = window
        return cond

    return patch


@register_node
class ControlNetApply:
    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "conditioning": ("CONDITIONING",),
                "control_net": ("CONTROL_NET",),
                "image": ("IMAGE",),
                "strength": ("FLOAT", {"default": 1.0}),
            }
        }

    RETURN_TYPES = ("CONDITIONING",)
    FUNCTION = "apply"

    def apply(self, conditioning, control_net, image, strength=1.0, context=None):
        return (map_conditioning(conditioning, _hint_patch(control_net, image, strength, None)),)


@register_node
class ControlNetApplyAdvanced:
    """The hint on both the positive and the negative, weighted by
    strength, only while sampling progress is in [start_percent,
    end_percent) (resolved against the model's schedule when sampling).
    Strength 0 returns both conditionings untouched."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "positive": ("CONDITIONING",),
                "negative": ("CONDITIONING",),
                "control_net": ("CONTROL_NET",),
                "image": ("IMAGE",),
                "strength": ("FLOAT", {"default": 1.0}),
                "start_percent": ("FLOAT", {"default": 0.0}),
                "end_percent": ("FLOAT", {"default": 1.0}),
            }
        }

    RETURN_TYPES = ("CONDITIONING", "CONDITIONING")
    RETURN_NAMES = ("positive", "negative")
    FUNCTION = "apply"

    def apply(self, positive, negative, control_net, image, strength=1.0, start_percent=0.0,
              end_percent=1.0, context=None):
        if float(strength) == 0.0:
            return (positive, negative)
        patch = _hint_patch(control_net, image, strength,
                            (float(start_percent), float(end_percent)))
        return (map_conditioning(positive, patch), map_conditioning(negative, patch))


@register_node
class ConditioningSetArea:
    """Restrict conditioning to a pixel region: the entry's prediction is
    made on the region's crop and composited by `strength` with the
    entries that overlap it (ops/samplers.py::composite_eps)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "conditioning": ("CONDITIONING",),
                "width": ("INT", {"default": 512}),
                "height": ("INT", {"default": 512}),
                "x": ("INT", {"default": 0}),
                "y": ("INT", {"default": 0}),
                "strength": ("FLOAT", {"default": 1.0}),
            }
        }

    RETURN_TYPES = ("CONDITIONING",)
    FUNCTION = "set_area"

    def set_area(self, conditioning, width, height, x, y, strength=1.0, context=None):
        def patch(cond):
            cond.area = (int(height), int(width), int(y), int(x))
            cond.strength = float(strength)
            return cond

        return (map_conditioning(conditioning, patch),)


@register_node
class ConditioningSetAreaPercentage:
    """An area in frame fractions, resolved against the frame where it is
    known (ops/conditioning.py::resolve_area)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "conditioning": ("CONDITIONING",),
                "width": ("FLOAT", {"default": 1.0}),
                "height": ("FLOAT", {"default": 1.0}),
                "x": ("FLOAT", {"default": 0.0}),
                "y": ("FLOAT", {"default": 0.0}),
                "strength": ("FLOAT", {"default": 1.0}),
            }
        }

    RETURN_TYPES = ("CONDITIONING",)
    FUNCTION = "set_area"

    def set_area(self, conditioning, width=1.0, height=1.0, x=0.0, y=0.0, strength=1.0,
                 context=None):
        def patch(cond):
            cond.area = ("percentage", float(height), float(width), float(y), float(x))
            cond.strength = float(strength)
            return cond

        return (map_conditioning(conditioning, patch),)


def _entries(value) -> list:
    if isinstance(value, (list, tuple)):
        return [as_conditioning(e) for e in value]
    return [as_conditioning(value)]


@register_node
class ConditioningCombine:
    """Two CONDITIONING values as one list of entries, each keeping its
    area, mask, strength and window; the sampler composites their
    predictions."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "conditioning_1": ("CONDITIONING",),
                "conditioning_2": ("CONDITIONING",),
            }
        }

    RETURN_TYPES = ("CONDITIONING",)
    FUNCTION = "combine"

    def combine(self, conditioning_1, conditioning_2, context=None):
        return (_entries(conditioning_1) + _entries(conditioning_2),)


@register_node
class ConditioningAverage:
    """Context and pooled vectors lerped toward conditioning_to by
    conditioning_to_strength, the `from` tokens zero-padded or truncated
    to `to`'s count; everything else from `to`. Each entry of a `to`
    list pairs with the first `from` entry."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "conditioning_to": ("CONDITIONING",),
                "conditioning_from": ("CONDITIONING",),
                "conditioning_to_strength": ("FLOAT", {"default": 1.0}),
            }
        }

    RETURN_TYPES = ("CONDITIONING",)
    FUNCTION = "average"

    def average(self, conditioning_to, conditioning_from, conditioning_to_strength=1.0,
                context=None):
        w = float(conditioning_to_strength)
        src = _entries(conditioning_from)[0]

        def lerp(a, b):
            t = a.shape[1]
            b = b.to(a.device)
            if b.shape[1] < t:
                b = F.pad(b, (0, 0, 0, t - b.shape[1]))
            return a * w + b[:, :t] * (1.0 - w)

        def patch(cond):
            cond.context = lerp(cond.context, src.context)
            if cond.pooled is not None and src.pooled is not None:
                cond.pooled = cond.pooled * w + src.pooled.to(cond.pooled.device) * (1.0 - w)
            return cond

        return (map_conditioning(conditioning_to, patch),)


@register_node
class ConditioningZeroOut:
    """Context and pooled vector zeroed."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"conditioning": ("CONDITIONING",)}}

    RETURN_TYPES = ("CONDITIONING",)
    FUNCTION = "zero_out"

    def zero_out(self, conditioning, context=None):
        def patch(cond):
            cond.context = torch.zeros_like(cond.context)
            if cond.pooled is not None:
                cond.pooled = torch.zeros_like(cond.pooled)
            return cond

        return (map_conditioning(conditioning, patch),)


@register_node
class ConditioningSetTimestepRange:
    """The entry contributes only while sampling progress is in [start,
    end)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "conditioning": ("CONDITIONING",),
                "start": ("FLOAT", {"default": 0.0}),
                "end": ("FLOAT", {"default": 1.0}),
            }
        }

    RETURN_TYPES = ("CONDITIONING",)
    FUNCTION = "set_range"

    def set_range(self, conditioning, start=0.0, end=1.0, context=None):
        if not 0.0 <= float(start) <= 1.0 or not 0.0 <= float(end) <= 1.0:
            raise ValueError("start/end must be sampling percents in [0, 1]")

        def patch(cond):
            cond.timestep_range = (float(start), float(end))
            return cond

        return (map_conditioning(conditioning, patch),)


@register_node
class ConditioningSetMask:
    """A soft spatial restriction of the entry (1 = full weight)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"conditioning": ("CONDITIONING",), "mask": ("MASK",)}}

    RETURN_TYPES = ("CONDITIONING",)
    FUNCTION = "set_mask"

    def set_mask(self, conditioning, mask, context=None):
        def patch(cond):
            cond.mask = mask
            return cond

        return (map_conditioning(conditioning, patch),)


@register_node
class FluxGuidance:
    """The distilled guidance scale a Flux-dev-class model embeds, on
    every entry. It is that model's guidance knob; true CFG (the cfg
    input) doubles the evaluations and is not what it was trained on."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "conditioning": ("CONDITIONING",),
                "guidance": ("FLOAT", {"default": 3.5}),
            }
        }

    RETURN_TYPES = ("CONDITIONING",)
    FUNCTION = "append"

    def append(self, conditioning, guidance, context=None):
        def patch(cond):
            cond.guidance = float(guidance)
            return cond

        return (map_conditioning(conditioning, patch),)


@register_node
class ReferenceLatent:
    """Kontext's reference latents, appended to every entry's list: the
    Flux MMDiT takes them as extra image tokens."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "conditioning": ("CONDITIONING",),
                "latent": ("LATENT",),
            }
        }

    RETURN_TYPES = ("CONDITIONING",)
    FUNCTION = "append"

    def append(self, conditioning, latent, context=None):
        def patch(cond):
            cond.reference_latents = list(cond.reference_latents or []) + [latent["samples"]]
            return cond

        return (map_conditioning(conditioning, patch),)


@register_node
class SkipLayerGuidanceSD3:
    """Skip-layer guidance for SD3-class models: in the [start_percent,
    end_percent] window the guided result gains scale * (cond - cond with
    the listed joint blocks skipped). A muted node (no layers, or scale
    0) passes the model through unchecked; a reversed window raises, as
    does a second guidance patch on the model."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL",),
                "layers": ("STRING", {"default": "7, 8, 9"}),
                "scale": ("FLOAT", {"default": 3.0}),
                "start_percent": ("FLOAT", {"default": 0.01}),
                "end_percent": ("FLOAT", {"default": 0.15}),
            }
        }

    RETURN_TYPES = ("MODEL",)
    FUNCTION = "skip_guidance"

    def skip_guidance(self, model, layers="7, 8, 9", scale=3.0, start_percent=0.01,
                      end_percent=0.15, context=None):
        if model_family(model.model_name) != "sd3":
            raise ValueError(f"SkipLayerGuidanceSD3 applies to SD3-class MMDiT models; "
                             f"{model.model_name!r} is not one")
        pl.reject_existing_guidance_patches(model, "SkipLayerGuidanceSD3")
        depth = get_config(model.model_name).depth
        layer_tuple = tuple(sorted({int(part) for part in str(layers).split(",")
                                    if part.strip()}))
        bad = [i for i in layer_tuple if not 0 <= i < depth]
        if bad:
            raise ValueError(f"skip layers {bad} out of range for depth-{depth} model")
        if not layer_tuple or float(scale) == 0.0:
            return (model,)
        if float(start_percent) > float(end_percent):
            raise ValueError(f"start_percent ({start_percent}) must be <= end_percent "
                             f"({end_percent})")
        spec = pl.SLGSpec(layers=layer_tuple, scale=float(scale),
                          start_percent=float(start_percent), end_percent=float(end_percent))
        return (dataclasses.replace(model, slg=spec),)
