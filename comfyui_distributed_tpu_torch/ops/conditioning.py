"""Structured conditioning: text context plus spatial and schedule
extras, and the per-tile cropping USDU needs.

Counterpart of comfyui_distributed_tpu/ops/conditioning.py for the SD
family: ControlNet hints, areas (pixels, or ConditioningSetAreaPercentage's
`("percentage", h, w, y, x)` frame fractions), masks, entry strengths,
timestep and ControlNet windows, the SDXL size override and the GLIGEN
boxes. A CONDITIONING value is one entry or the list ConditioningCombine
makes. The JAX package carries a ControlNet's weights as pytree leaves;
here an entry holds the ControlNet bundle itself (a reference to its
module: `clone` copies no weights).

InpaintModelConditioning's concat channels (`concat_latent`: the mask and
the masked image's latents, joined to a 9-channel UNet's input) ride on
the entry and follow its batch slices and area crops; the tile path
refuses them, as the JAX package's does. The Flux fields ride on the
entry too: the distilled `guidance` scale (FluxGuidance,
CLIPTextEncodeFlux) and Kontext's `reference_latents` (ReferenceLatent),
which follow batch slices, tile crops and the CFG batch. unCLIP's image
embeddings (unCLIPConditioning) ride on the entry as in the JAX package,
where no backbone consumes them: sampling such an entry raises the JAX
package's ValueError. Model patches, a field of the JAX package's
Conditioning that none of its nodes sets, are refused where an entry is
sampled (`reject_unported`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from .resize import resize_image

# fields of the JAX package's Conditioning that no node of either package
# sets and no model consumes
UNPORTED_FIELDS = ("model_patches",)


@dataclasses.dataclass
class Conditioning:
    """One conditioning entry.

    context: [B, T, D] text tokens.
    pooled: [B, width] pooled text vector (SDXL adm conditioning).
    control_hint: [B, H, W, C] pixel-space ControlNet hint in [0, 1];
        control_net the ControlNet bundle that encodes it,
        control_strength its weight, control_range the sampling-progress
        window [start, end) it applies in (ControlNetApplyAdvanced).
    area: (h, w, y, x) in pixels, or ("percentage", h, w, y, x).
    mask: [B, H, W] soft restriction.
    strength: the entry's weight in multi-entry composition
        (ConditioningSetArea / SetMask), not the hint's.
    timestep_range: the sampling-progress window [start, end) in which
        the entry contributes (ConditioningSetTimestepRange).
    size_cond: the SDXL adm size override (orig_h, orig_w, crop_t,
        crop_l, target_h, target_w) of CLIPTextEncodeSDXL; None derives
        it from the latent with zero crops.
    gligen_embs / gligen_boxes / gligen_active: GLIGEN position
        conditioning, [N, D] embeddings with latent-unit boxes (h, w, y,
        x); a box off a tile goes inactive, it is not dropped.
    concat_latent: [B, h, w, 1 + C] latent-resolution channels joined to
        the model input after its VP scaling (InpaintModelConditioning:
        the mask, then the masked image's latents).
    reference_latents: Kontext's reference images, a list of [B, h, w, C]
        latents the Flux MMDiT takes as extra image tokens.
    guidance: the distilled guidance scale a Flux-dev-class model
        embeds; None takes the model's default.
    unclip_embeds / unclip_strength / unclip_noise_aug: unCLIPConditioning's
        CLIP-vision tokens [B, T, width] and their weights; no backbone
        has an unCLIP adm head, so sampling them raises.
    """

    context: torch.Tensor
    pooled: Optional[torch.Tensor] = None
    control_hint: Optional[torch.Tensor] = None
    control_strength: float = 1.0
    control_net: Any = None
    control_range: Optional[tuple] = None
    area: Optional[tuple] = None
    mask: Optional[torch.Tensor] = None
    strength: float = 1.0
    timestep_range: Optional[tuple] = None
    size_cond: Optional[tuple] = None
    gligen_embs: Optional[torch.Tensor] = None
    gligen_boxes: Optional[tuple] = None
    gligen_active: Optional[tuple] = None
    concat_latent: Optional[torch.Tensor] = None
    reference_latents: Optional[list] = None
    guidance: Optional[float] = None
    unclip_embeds: Optional[torch.Tensor] = None
    unclip_strength: float = 1.0
    unclip_noise_aug: float = 0.0

    def clone(self) -> "Conditioning":
        # tensors are never written in place, so a shallow copy suffices;
        # control_net stays a reference to the one module
        return dataclasses.replace(self)


# the fields a batch concatenation joins, and the ones two entries must
# share to ride one batched pass (the JAX pytree's leaves and aux data)
TENSOR_FIELDS = ("context", "pooled", "control_hint", "mask", "gligen_embs", "concat_latent",
                 "unclip_embeds")
STATIC_FIELDS = ("control_strength", "control_net", "control_range", "area", "strength",
                 "timestep_range", "size_cond", "gligen_boxes", "gligen_active", "guidance",
                 "unclip_strength", "unclip_noise_aug")
# a list of tensors, each joined on the batch axis like a tensor field
LIST_FIELDS = ("reference_latents",)


def as_conditioning(value: Any) -> Conditioning:
    """Accept a bare context tensor or a Conditioning."""
    if isinstance(value, Conditioning):
        return value
    return Conditioning(context=value)


# the JAX package's error for unCLIP embeds at a sampler
# (comfyui_distributed_tpu/ops/samplers.py::_reject_unsupported_cond)
UNCLIP_UNSUPPORTED = (
    "unCLIP image conditioning (unCLIPConditioning node) reached a model without an unCLIP "
    "adm head — no registered backbone consumes it yet; remove the node or use an "
    "i2v-native path (WAN i2v)")


def reject_unported(entry: Any) -> None:
    """Refuse an entry a sampler must not drop silently (a plausible,
    wrong image): ValueError for unCLIP embeds, which no backbone
    consumes (the JAX package's error); NotImplementedError for model
    patches, which no node sets."""
    if getattr(entry, "unclip_embeds", None) is not None:
        raise ValueError(UNCLIP_UNSUPPORTED)
    for name in UNPORTED_FIELDS:
        if getattr(entry, name, None) is not None:
            raise NotImplementedError(
                f"conditioning field {name!r} is not supported: no node sets it")


def resolve_area(area, image_h: int, image_w: int):
    """An area as pixel ints against a frame: a percentage area resolves
    to int(fraction * side), a pixel area passes through."""
    if area is None:
        return None
    if area[0] == "percentage":
        _tag, fh, fw, fy, fx = area
        return (int(float(fh) * image_h), int(float(fw) * image_w),
                int(float(fy) * image_h), int(float(fx) * image_w))
    return area


def map_conditioning(value: Any, fn) -> Any:
    """Apply an entry transform to a CONDITIONING value, one entry or a
    list of them; `fn` receives a clone and returns the modified entry."""
    if isinstance(value, (list, tuple)):
        return [fn(as_conditioning(v).clone()) for v in value]
    return fn(as_conditioning(value).clone())


def _to_frame(plane: torch.Tensor, image_h: int, image_w: int) -> torch.Tensor:
    """A [B, H, W, C] plane resized (jax.image.resize "linear") to the frame."""
    if plane.shape[1] != image_h or plane.shape[2] != image_w:
        return resize_image(plane, image_h, image_w, "bilinear")
    return plane


def _edge_window(plane: torch.Tensor, y: int, x: int, tile_h: int, tile_w: int) -> torch.Tensor:
    """The [B, tile_h, tile_w, C] window of a [B, H, W, C] plane at (y, x),
    the plane edge-extended where the window leaves it."""
    _, h, w, _ = plane.shape
    pads = (max(0, -x), max(0, x + tile_w - w), max(0, -y), max(0, y + tile_h - h))
    if any(pads):
        plane = F.pad(plane.permute(0, 3, 1, 2), pads, mode="replicate").permute(0, 2, 3, 1)
    y0, x0 = max(y, 0), max(x, 0)
    return plane[:, y0:y0 + tile_h, x0:x0 + tile_w, :]


def crop_to_tile(cond: Conditioning, y: int, x: int, tile_h: int, tile_w: int,
                 image_h: int, image_w: int) -> Conditioning:
    """The conditioning a padded tile at origin (y, x) sees.

    Text context and pooled vectors pass through. A hint or mask is
    resized (linear) to the frame if its size differs, then windowed to
    the tile, edge-extended past the frame. An area is intersected with
    the tile and re-expressed in tile coordinates; where nothing is left
    it becomes None and the entry's control strength 0. GLIGEN boxes
    are intersected in pixels (x8) and marked inactive off the tile."""
    out = cond.clone()
    if cond.control_hint is not None:
        out.control_hint = _edge_window(_to_frame(cond.control_hint, image_h, image_w),
                                        y, x, tile_h, tile_w)
    if cond.mask is not None:
        mask = _to_frame(cond.mask[..., None], image_h, image_w)
        out.mask = _edge_window(mask, y, x, tile_h, tile_w)[..., 0]
    if cond.area is not None:
        ah, aw, ay, ax = resolve_area(cond.area, image_h, image_w)
        top, left = max(ay, y), max(ax, x)
        bottom, right = min(ay + ah, y + tile_h), min(ax + aw, x + tile_w)
        if bottom <= top or right <= left:
            out.area = None
            out.control_strength = 0.0
        else:
            out.area = (bottom - top, right - left, top - y, left - x)
    if cond.gligen_boxes is not None:
        boxes, active = [], []
        for bh, bw, by, bx in cond.gligen_boxes:
            x1, y1 = bx * 8, by * 8
            x2, y2 = x1 + bw * 8, y1 + bh * 8
            ix1, iy1 = max(x1, x), max(y1, y)
            ix2, iy2 = min(x2, x + tile_w), min(y2, y + tile_h)
            if ix1 >= ix2 or iy1 >= iy2:
                boxes.append((0, 0, 0, 0))
                active.append(False)
                continue
            ix1, ix2, iy1, iy2 = ix1 - x, ix2 - x, iy1 - y, iy2 - y
            boxes.append(((iy2 - iy1) // 8, (ix2 - ix1) // 8, iy1 // 8, ix1 // 8))
            active.append(True)
        out.gligen_boxes = tuple(boxes)
        out.gligen_active = tuple(active)
    if cond.reference_latents is not None:
        # each reference resized (linear) to the frame's latent grid,
        # windowed to the tile's latent region, resized to the tile's
        # latent size
        k = 8
        canvas = (image_h // k, image_w // k)
        t_lat = (max(1, tile_h // k), max(1, tile_w // k))
        cropped = []
        for lat in cond.reference_latents:
            if tuple(lat.shape[1:3]) != canvas:
                lat = resize_image(lat, canvas[0], canvas[1], "bilinear")
            y0, x0 = max(0, y) // k, max(0, x) // k
            y1 = min(canvas[0], (y + tile_h) // k)
            x1 = min(canvas[1], (x + tile_w) // k)
            window = lat[:, y0:max(y1, y0 + 1), x0:max(x1, x0 + 1), :]
            cropped.append(resize_image(window, t_lat[0], t_lat[1], "bilinear"))
        out.reference_latents = cropped
    return out


def slice_batch(cond: Conditioning, start: int, size: int) -> Conditioning:
    """The entry for batch indices [start, start + size): every batched
    payload follows; a batch of one broadcasts and stays."""
    out = cond.clone()

    def cut(t):
        if t is None or t.shape[0] == 1:
            return t
        return t[start:start + size]

    out.context = cut(cond.context)
    out.control_hint = cut(cond.control_hint)
    out.mask = cut(cond.mask)
    out.concat_latent = cut(cond.concat_latent)
    if cond.reference_latents is not None:
        out.reference_latents = [cut(lat) for lat in cond.reference_latents]
    return out


def concat_batch(first: Conditioning, *rest: Conditioning) -> Conditioning:
    """The entry of a batch [first; rest...] (CFG's two sides, PerpNeg's
    and DualCFG's three): every tensor field concatenated on the batch
    axis, the static fields `first`'s (the caller checks they agree)."""
    out = first.clone()
    for name in TENSOR_FIELDS:
        a = getattr(first, name)
        setattr(out, name, None if a is None
                else torch.cat([a] + [getattr(c, name) for c in rest], dim=0))
    for name in LIST_FIELDS:
        a = getattr(first, name)
        setattr(out, name, None if a is None
                else [torch.cat(parts, dim=0)
                      for parts in zip(a, *(getattr(c, name) for c in rest))])
    return out
