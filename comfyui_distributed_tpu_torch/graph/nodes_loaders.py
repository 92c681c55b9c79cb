"""Model patch nodes.

The port's own copy of the part of comfyui_distributed_tpu/graph/
nodes_loaders.py that the bundled SD workflows reach:
PerturbedAttentionGuidance. A patch returns a new bundle through
`dataclasses.replace` (the modules are shared): the bundle the executor
caches for the checkpoint, which other nodes and prompts use, keeps no
patch.
"""

from __future__ import annotations

import dataclasses

from ..models import pipeline as pl
from ..models.registry import model_family
from .registry import register_node


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
        family = model_family(model.model_name)
        if family != "unet":
            raise ValueError(
                f"PerturbedAttentionGuidance patches UNet self-attention; "
                f"{model.model_name!r} is {family}-family"
            )
        pl.reject_existing_guidance_patches(model, "PerturbedAttentionGuidance")
        return (dataclasses.replace(model, pag=pl.PAGSpec(scale=float(scale))),)
