"""Mask nodes: make, crop, invert, combine, feather, grow and threshold
masks, move them to and from images, and composite images and latents
through them.

Counterpart of comfyui_distributed_tpu/graph/nodes_mask.py, with its
node names and inputs. MASK is [B, H, W] float in [0, 1], 1 = selected
(regenerate); [H, W] and [B, H, W, 1] inputs are accepted. Resizes go
through ops/resize.py, which follows jax.image.resize.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.resize import resize_image
from .registry import register_node


def as_mask(mask) -> torch.Tensor:
    """A MASK input as [B, H, W] float32."""
    m = torch.as_tensor(mask).float()
    if m.ndim == 4:
        m = m[..., 0]
    if m.ndim == 2:
        m = m[None]
    return m


def _broadcast_batch(a: torch.Tensor, b: torch.Tensor):
    """Two batched tensors broadcast to the larger batch."""
    n = max(a.shape[0], b.shape[0])
    return a.expand((n,) + tuple(a.shape[1:])), b.expand((n,) + tuple(b.shape[1:]))


def _resize_mask(m: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return resize_image(m[..., None], h, w, "bilinear")[..., 0]


def composite(destination: torch.Tensor, source: torch.Tensor, x: int, y: int,
              mask: torch.Tensor | None = None, multiplier: int = 1,
              resize_source: bool = False) -> torch.Tensor:
    """`source` pasted over `destination` ([B, H, W, C]) at pixel offset
    (x, y), blended by `mask` (1 = source shows). Offsets may be negative
    (the source hangs off the top or left); `multiplier` converts pixels
    to array cells (8 for latents). A batched mask sets the batch."""
    dest = torch.as_tensor(destination).float()
    src = torch.as_tensor(source).float().to(dest.device)
    if resize_source:
        src = resize_image(src, dest.shape[1], dest.shape[2], "bilinear")
    dest, src = _broadcast_batch(dest, src)
    m = None
    if mask is not None:
        m = as_mask(mask).to(dest.device)
        if m.shape[0] > dest.shape[0]:
            dest = dest.expand((m.shape[0],) + tuple(dest.shape[1:]))
            src = src.expand((m.shape[0],) + tuple(src.shape[1:]))
    dh, dw = dest.shape[1], dest.shape[2]
    sh, sw = src.shape[1], src.shape[2]
    # the pixel offset clamped into the addressable range, then in cells
    x = max(-sw * multiplier, min(int(x), dw * multiplier))
    y = max(-sh * multiplier, min(int(y), dh * multiplier))
    left, top = x // multiplier, y // multiplier
    dy0, dx0 = max(top, 0), max(left, 0)
    dy1, dx1 = min(dh, top + sh), min(dw, left + sw)
    if dy1 <= dy0 or dx1 <= dx0:
        return dest.contiguous()  # wholly out of the frame
    sy0, sx0 = dy0 - top, dx0 - left
    vh, vw = dy1 - dy0, dx1 - dx0
    src_crop = src[:, sy0:sy0 + vh, sx0:sx0 + vw, :]
    if m is None:
        m_crop = torch.ones((1, vh, vw, 1), device=dest.device)
    else:
        if tuple(m.shape[1:]) != (sh, sw):
            m = _resize_mask(m, sh, sw)
        m_crop = m[:, sy0:sy0 + vh, sx0:sx0 + vw, None]
    out = dest.clone()
    region = dest[:, dy0:dy1, dx0:dx1, :]
    out[:, dy0:dy1, dx0:dx1, :] = src_crop * m_crop + region * (1.0 - m_crop)
    return out


@register_node
class SolidMask:
    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "value": ("FLOAT", {"default": 1.0}),
                "width": ("INT", {"default": 512}),
                "height": ("INT", {"default": 512}),
            }
        }

    RETURN_TYPES = ("MASK",)
    FUNCTION = "solid"

    def solid(self, value=1.0, width=512, height=512, context=None):
        device = getattr(context, "device", None) or "cuda"
        return (torch.full((1, int(height), int(width)), float(value), dtype=torch.float32,
                           device=device),)


@register_node
class InvertMask:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"mask": ("MASK",)}}

    RETURN_TYPES = ("MASK",)
    FUNCTION = "invert"

    def invert(self, mask, context=None):
        return (1.0 - as_mask(mask),)


@register_node
class CropMask:
    """A mask region, clamped as ImageCrop clamps."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "mask": ("MASK",),
                "x": ("INT", {"default": 0}),
                "y": ("INT", {"default": 0}),
                "width": ("INT", {"default": 512}),
                "height": ("INT", {"default": 512}),
            }
        }

    RETURN_TYPES = ("MASK",)
    FUNCTION = "crop"

    def crop(self, mask, x=0, y=0, width=512, height=512, context=None):
        from .nodes_core import _crop_window

        m = as_mask(mask)
        y0, y1, x0, x1 = _crop_window(m.shape[1], m.shape[2], x, y, width, height)
        return (m[:, y0:y1, x0:x1],)


@register_node
class MaskToImage:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"mask": ("MASK",)}}

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "mask_to_image"

    def mask_to_image(self, mask, context=None):
        return (as_mask(mask)[..., None].repeat(1, 1, 1, 3),)


@register_node
class ImageToMask:
    """One channel of an image as a mask."""

    CHANNELS = ("red", "green", "blue", "alpha")

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"image": ("IMAGE",), "channel": ("STRING", {"default": "red"})}}

    RETURN_TYPES = ("MASK",)
    FUNCTION = "image_to_mask"

    def image_to_mask(self, image, channel="red", context=None):
        if channel not in self.CHANNELS:
            raise ValueError(f"channel must be one of {self.CHANNELS}, got {channel!r}")
        img = torch.as_tensor(image).float()
        c = self.CHANNELS.index(channel)
        if c >= img.shape[-1]:
            raise ValueError(f"image has {img.shape[-1]} channel(s); no {channel!r} plane")
        return (img[..., c],)


@register_node
class MaskComposite:
    """Two masks combined at an offset by an arithmetic or boolean
    operation; the source is clipped to the destination, which keeps its
    values outside the overlap."""

    OPERATIONS = ("multiply", "add", "subtract", "and", "or", "xor")

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "destination": ("MASK",),
                "source": ("MASK",),
                "x": ("INT", {"default": 0}),
                "y": ("INT", {"default": 0}),
                "operation": ("STRING", {"default": "multiply"}),
            }
        }

    RETURN_TYPES = ("MASK",)
    FUNCTION = "combine"

    def combine(self, destination, source, x=0, y=0, operation="multiply", context=None):
        if operation not in self.OPERATIONS:
            raise ValueError(f"operation must be one of {self.OPERATIONS}, got {operation!r}")
        dest = as_mask(destination)
        dest, src = _broadcast_batch(dest, as_mask(source).to(dest.device))
        dh, dw = dest.shape[1], dest.shape[2]
        left = min(max(int(x), 0), dw)
        top = min(max(int(y), 0), dh)
        right = min(left + src.shape[2], dw)
        bottom = min(top + src.shape[1], dh)
        if bottom <= top or right <= left:
            return (dest.contiguous(),)
        s = src[:, :bottom - top, :right - left]
        d = dest[:, top:bottom, left:right]
        if operation == "multiply":
            res = d * s
        elif operation == "add":
            res = torch.clamp(d + s, 0.0, 1.0)
        elif operation == "subtract":
            res = torch.clamp(d - s, 0.0, 1.0)
        else:
            db, sb = torch.round(d).bool(), torch.round(s).bool()
            res = {"and": db & sb, "or": db | sb, "xor": db ^ sb}[operation].float()
        out = dest.clone()
        out[:, top:bottom, left:right] = res
        return (out,)


@register_node
class FeatherMask:
    """Linear ramps multiplied in along the requested edges: row or column
    i < n of an edge scales by (i + 1) / n; widths clamp to the mask."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "mask": ("MASK",),
                "left": ("INT", {"default": 0}),
                "top": ("INT", {"default": 0}),
                "right": ("INT", {"default": 0}),
                "bottom": ("INT", {"default": 0}),
            }
        }

    RETURN_TYPES = ("MASK",)
    FUNCTION = "feather"

    def feather(self, mask, left=0, top=0, right=0, bottom=0, context=None):
        m = as_mask(mask)
        h, w = m.shape[1], m.shape[2]
        left, right = min(int(left), w), min(int(right), w)
        top, bottom = min(int(top), h), min(int(bottom), h)

        def ramp(n: int, lo: int, hi: int) -> torch.Tensor:
            idx = torch.arange(n, dtype=torch.float32, device=m.device)
            r = torch.ones(n, device=m.device)
            if lo > 0:
                r = r * torch.clamp((idx + 1.0) / lo, 0.0, 1.0)
            if hi > 0:
                r = r * torch.clamp((n - idx) / hi, 0.0, 1.0)
            return r

        m = m * ramp(h, top, bottom)[None, :, None]
        return (m * ramp(w, left, right)[None, None, :],)


def _morph_step(m: torch.Tensor, grow: bool, tapered: bool) -> torch.Tensor:
    """One 3x3 dilation (grow) or erosion step, the border edge-replicated;
    `tapered` takes the cross-shaped element (corners off)."""
    pad = F.pad(m[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    if not tapered:
        if grow:
            return F.max_pool2d(pad[:, None], 3, stride=1)[:, 0]
        return -F.max_pool2d(-pad[:, None], 3, stride=1)[:, 0]
    neighbourhood = torch.stack([m, pad[:, :-2, 1:-1], pad[:, 2:, 1:-1], pad[:, 1:-1, :-2],
                                 pad[:, 1:-1, 2:]])
    return neighbourhood.amax(dim=0) if grow else neighbourhood.amin(dim=0)


@register_node
class GrowMask:
    """|expand| steps of 3x3 dilation (expand > 0) or erosion (< 0);
    `tapered_corners` takes the cross element, so growth spreads as a
    diamond, else the full square."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "mask": ("MASK",),
                "expand": ("INT", {"default": 0}),
                "tapered_corners": ("BOOLEAN", {"default": True}),
            }
        }

    RETURN_TYPES = ("MASK",)
    FUNCTION = "expand_mask"

    def expand_mask(self, mask, expand=0, tapered_corners=True, context=None):
        m = as_mask(mask)
        n = int(expand)
        for _ in range(abs(n)):
            m = _morph_step(m, grow=n > 0, tapered=bool(tapered_corners))
        return (m,)


@register_node
class ImageCompositeMasked:
    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "destination": ("IMAGE",),
                "source": ("IMAGE",),
                "x": ("INT", {"default": 0}),
                "y": ("INT", {"default": 0}),
                "resize_source": ("BOOLEAN", {"default": False}),
            },
            "optional": {"mask": ("MASK",)},
        }

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "composite"

    def composite(self, destination, source, x=0, y=0, resize_source=False, mask=None,
                  context=None):
        return (composite(destination, source, int(x), int(y), mask, multiplier=1,
                          resize_source=bool(resize_source)),)


@register_node
class LatentCompositeMasked:
    """A masked latent paste; offsets in pixels, 8 a latent cell."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "destination": ("LATENT",),
                "source": ("LATENT",),
                "x": ("INT", {"default": 0}),
                "y": ("INT", {"default": 0}),
                "resize_source": ("BOOLEAN", {"default": False}),
            },
            "optional": {"mask": ("MASK",)},
        }

    RETURN_TYPES = ("LATENT",)
    FUNCTION = "composite"

    def composite(self, destination, source, x=0, y=0, resize_source=False, mask=None,
                  context=None):
        out = dict(destination)
        out["samples"] = composite(destination["samples"], source["samples"], int(x), int(y),
                                   mask, multiplier=8, resize_source=bool(resize_source))
        return (out,)


@register_node
class ThresholdMask:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"mask": ("MASK",), "value": ("FLOAT", {"default": 0.5})}}

    RETURN_TYPES = ("MASK",)
    FUNCTION = "image_to_mask"

    def image_to_mask(self, mask, value=0.5, context=None):
        return ((as_mask(mask) > float(value)).float(),)


@register_node
class JoinImageWithAlpha:
    """The mask as the image's alpha channel, alpha = 1 - mask."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"image": ("IMAGE",), "alpha": ("MASK",)}}

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "join_image_with_alpha"

    def join_image_with_alpha(self, image, alpha, context=None):
        m = as_mask(alpha).to(image.device)
        if tuple(m.shape[1:]) != tuple(image.shape[1:3]):
            m = _resize_mask(m, image.shape[1], image.shape[2])
        m, rgb = _broadcast_batch(m, image[..., :3])
        return (torch.cat([rgb, (1.0 - m)[..., None]], dim=-1),)


@register_node
class SplitImageWithAlpha:
    """An RGBA image as RGB and a MASK (1 - alpha); no alpha gives a zero
    mask."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"image": ("IMAGE",)}}

    RETURN_TYPES = ("IMAGE", "MASK")
    FUNCTION = "split_image_with_alpha"

    def split_image_with_alpha(self, image, context=None):
        if image.shape[-1] > 3:
            mask = 1.0 - image[..., 3]
        else:
            mask = torch.zeros(tuple(image.shape[:3]), dtype=torch.float32, device=image.device)
        return (image[..., :3], mask)
