"""Geometry and blend nodes for images and latents: flips, quarter turns,
crops, blends, latent arithmetic, quantisation, a solid image, a mask
from one channel of a file, and the batch seed behaviour.

Counterpart of comfyui_distributed_tpu/graph/nodes_transform.py, with
its node names and inputs. IMAGE is [B, H, W, C] float in [0, 1]; LATENT
is {"samples": [B, h, w, C]} with pixel offsets at 8 pixels a latent
cell; MASK is [B, H, W]. LoadImageMask reads a PNG by path through the
port's own codec, as LoadImage does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.resize import center_crop_to_aspect, resize_image
from ..utils import image as img_utils
from .io_dirs import resolve_input_path
from .registry import register_node

_FLIP_METHODS = ("x-axis: vertically", "y-axis: horizontally")
_ROTATIONS = ("none", "90 degrees", "180 degrees", "270 degrees")


def _flip(arr: torch.Tensor, method: str) -> torch.Tensor:
    """"x-axis: vertically" reverses rows, "y-axis: horizontally" columns."""
    if str(method).startswith("x"):
        return torch.flip(arr, dims=(1,))
    if str(method).startswith("y"):
        return torch.flip(arr, dims=(2,))
    raise ValueError(f"unknown flip_method {method!r}; use {_FLIP_METHODS}")


def _rotate(arr: torch.Tensor, rotation: str) -> torch.Tensor:
    """Clockwise quarter turns over (H, W): "90 degrees" turns the top
    edge to the right."""
    rot = str(rotation)
    if rot not in _ROTATIONS:
        raise ValueError(f"unknown rotation {rotation!r}; use {_ROTATIONS}")
    quarters = _ROTATIONS.index(rot)
    if quarters == 0:
        return arr
    return torch.rot90(arr, k=-quarters, dims=(1, 2))


def _with_mask(samples: dict, fn) -> dict:
    """`fn` applied to the latents and to a noise mask they carry."""
    out = dict(samples)
    out["samples"] = fn(samples["samples"])
    if samples.get("noise_mask") is not None:
        out["noise_mask"] = fn(samples["noise_mask"])
    return out


@register_node
class LatentFlip:
    """A latent mirrored (its noise mask with it)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "samples": ("LATENT",),
                "flip_method": ("STRING", {"default": _FLIP_METHODS[0]}),
            }
        }

    RETURN_TYPES = ("LATENT",)
    FUNCTION = "flip"

    def flip(self, samples: dict, flip_method=_FLIP_METHODS[0], context=None):
        return (_with_mask(samples, lambda a: _flip(a, flip_method)),)


@register_node
class LatentRotate:
    """A latent turned clockwise in quarter turns; 90 and 270 swap a
    non-square latent's sides."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"samples": ("LATENT",), "rotation": ("STRING", {"default": "none"})}}

    RETURN_TYPES = ("LATENT",)
    FUNCTION = "rotate"

    def rotate(self, samples: dict, rotation="none", context=None):
        return (_with_mask(samples, lambda a: _rotate(a, rotation)),)


@register_node
class LatentCrop:
    """A latent region addressed in pixels (8 a cell), clamped as
    ImageCrop clamps."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "samples": ("LATENT",),
                "width": ("INT", {"default": 512}),
                "height": ("INT", {"default": 512}),
                "x": ("INT", {"default": 0}),
                "y": ("INT", {"default": 0}),
            }
        }

    RETURN_TYPES = ("LATENT",)
    FUNCTION = "crop"

    def crop(self, samples: dict, width=512, height=512, x=0, y=0, context=None):
        from .nodes_core import _crop_window

        z = samples["samples"]
        y0, y1, x0, x1 = _crop_window(z.shape[1], z.shape[2], x, y, width, height, unit=8)
        return (_with_mask(samples, lambda a: a[:, y0:y1, x0:x1, :]),)


@register_node
class LatentBlend:
    """samples1 * blend_factor + samples2 * (1 - blend_factor); the shapes
    must match."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "samples1": ("LATENT",),
                "samples2": ("LATENT",),
                "blend_factor": ("FLOAT", {"default": 0.5}),
            }
        }

    RETURN_TYPES = ("LATENT",)
    FUNCTION = "blend"

    def blend(self, samples1: dict, samples2: dict, blend_factor=0.5, context=None):
        a, b = _latent_pair(samples1, samples2, "LatentBlend needs")
        f = float(blend_factor)
        return ({**samples1, "samples": a * f + b * (1.0 - f)},)


@register_node
class ImageFlip:
    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "image": ("IMAGE",),
                "flip_method": ("STRING", {"default": _FLIP_METHODS[0]}),
            }
        }

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "flip"

    def flip(self, image, flip_method=_FLIP_METHODS[0], context=None):
        return (_flip(image, flip_method),)


@register_node
class ImageRotate:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"image": ("IMAGE",), "rotation": ("STRING", {"default": "none"})}}

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "rotate"

    def rotate(self, image, rotation="none", context=None):
        return (_rotate(image, rotation),)


_BLEND_MODES = ("normal", "multiply", "screen", "overlay", "soft_light", "difference")


@register_node
class ImageBlend:
    """image1 lerped by blend_factor toward the blend mode's composite of
    (image1, image2); image2 centre-cropped and resized (bilinear) to
    image1's size where they differ."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "image1": ("IMAGE",),
                "image2": ("IMAGE",),
                "blend_factor": ("FLOAT", {"default": 0.5}),
                "blend_mode": ("STRING", {"default": "normal"}),
            }
        }

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "blend"

    def blend(self, image1, image2, blend_factor=0.5, blend_mode="normal", context=None):
        mode = str(blend_mode)
        if mode not in _BLEND_MODES:
            raise ValueError(f"unknown blend_mode {mode!r}; use {_BLEND_MODES}")
        if tuple(image1.shape[1:3]) != tuple(image2.shape[1:3]):
            h, w = image1.shape[1], image1.shape[2]
            (image2,) = center_crop_to_aspect([image2], h, w)
            image2 = resize_image(image2, h, w, "bilinear")
        a, b = image1, image2.to(image1.device)
        if mode == "normal":
            mixed = b
        elif mode == "multiply":
            mixed = a * b
        elif mode == "screen":
            mixed = 1.0 - (1.0 - a) * (1.0 - b)
        elif mode == "overlay":
            mixed = torch.where(a <= 0.5, 2.0 * a * b, 1.0 - 2.0 * (1.0 - a) * (1.0 - b))
        elif mode == "soft_light":
            # the W3C piecewise form
            d = torch.where(a <= 0.25, ((16.0 * a - 12.0) * a + 4.0) * a,
                            torch.sqrt(torch.clamp(a, min=0.0)))
            mixed = torch.where(b <= 0.5, a - (1.0 - 2.0 * b) * a * (1.0 - a),
                                a + (2.0 * b - 1.0) * (d - a))
        else:  # difference
            mixed = torch.abs(a - b)
        f = float(blend_factor)
        return (torch.clamp(a * (1.0 - f) + mixed * f, 0.0, 1.0),)


@register_node
class EmptyImage:
    """A solid-colour batch: `color` is 0xRRGGBB."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "width": ("INT", {"default": 512}),
                "height": ("INT", {"default": 512}),
                "batch_size": ("INT", {"default": 1}),
                "color": ("INT", {"default": 0}),
            }
        }

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "generate"

    def generate(self, width=512, height=512, batch_size=1, color=0, context=None):
        c = int(color)
        device = getattr(context, "device", None) or "cuda"
        rgb = torch.tensor([(c >> 16) & 0xFF, (c >> 8) & 0xFF, c & 0xFF], dtype=torch.float32,
                           device=device) / 255.0
        return (rgb.expand(int(batch_size), int(height), int(width), 3).contiguous(),)


@register_node
class LoadImageMask:
    """One channel of a PNG as a MASK: "alpha" gives 1 - alpha (the
    transparent hole is the region to regenerate; no alpha gives zeros),
    a colour channel its plane (a missing one raises)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "image": ("STRING", {"default": ""}),
                "channel": ("STRING", {"default": "alpha"}),
            }
        }

    RETURN_TYPES = ("MASK",)
    FUNCTION = "load"
    NEVER_CACHE = True  # the file can change between runs

    def load(self, image: str, channel="alpha", context=None):
        chans = {"red": 0, "green": 1, "blue": 2, "alpha": 3}
        ch = str(channel)
        if ch not in chans:
            raise ValueError(f"unknown channel {ch!r}; use {tuple(chans)}")
        with open(resolve_input_path(str(image), context), "rb") as fh:
            arr = img_utils.decode_png(fh.read())  # [H, W, 1|3|4] in [0, 1]
        if ch == "alpha":
            mask = 1.0 - arr[..., 3] if arr.shape[-1] == 4 else np.zeros(arr.shape[:2],
                                                                           np.float32)
        elif chans[ch] >= arr.shape[-1]:
            raise ValueError(f"image has {arr.shape[-1]} channel(s); no {ch!r} plane")
        else:
            mask = arr[..., chans[ch]]
        device = getattr(context, "device", None) or "cuda"
        return (torch.from_numpy(np.ascontiguousarray(mask, dtype=np.float32))[None].to(device),)


def _latent_pair(samples1: dict, samples2: dict, what: str = "latent math needs"):
    a, b = samples1["samples"], samples2["samples"]
    if tuple(a.shape) != tuple(b.shape):
        raise ValueError(f"{what} matching shapes, got {tuple(a.shape)} vs {tuple(b.shape)}")
    return a, b.to(a.device)


@register_node
class LatentAdd:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"samples1": ("LATENT",), "samples2": ("LATENT",)}}

    RETURN_TYPES = ("LATENT",)
    FUNCTION = "op"

    def op(self, samples1: dict, samples2: dict, context=None):
        a, b = _latent_pair(samples1, samples2)
        return ({**samples1, "samples": a + b},)


@register_node
class LatentSubtract:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"samples1": ("LATENT",), "samples2": ("LATENT",)}}

    RETURN_TYPES = ("LATENT",)
    FUNCTION = "op"

    def op(self, samples1: dict, samples2: dict, context=None):
        a, b = _latent_pair(samples1, samples2)
        return ({**samples1, "samples": a - b},)


@register_node
class LatentMultiply:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"samples": ("LATENT",), "multiplier": ("FLOAT", {"default": 1.0})}}

    RETURN_TYPES = ("LATENT",)
    FUNCTION = "op"

    def op(self, samples: dict, multiplier=1.0, context=None):
        return ({**samples, "samples": samples["samples"] * float(multiplier)},)


@register_node
class LatentInterpolate:
    """Norm-preserving interpolation: the unit directions lerped by
    `ratio`, then scaled to the lerped norms."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "samples1": ("LATENT",),
                "samples2": ("LATENT",),
                "ratio": ("FLOAT", {"default": 1.0}),
            }
        }

    RETURN_TYPES = ("LATENT",)
    FUNCTION = "op"

    def op(self, samples1: dict, samples2: dict, ratio=1.0, context=None):
        a, b = _latent_pair(samples1, samples2)
        r = float(ratio)
        dims = tuple(range(1, a.ndim))

        def norm(t):
            return torch.sqrt(torch.sum(t * t, dim=dims, keepdim=True))

        na, nb = norm(a), norm(b)
        mixed = a / torch.clamp(na, min=1e-8) * r + b / torch.clamp(nb, min=1e-8) * (1.0 - r)
        out = mixed / torch.clamp(norm(mixed), min=1e-8) * (na * r + nb * (1.0 - r))
        return ({**samples1, "samples": out},)


@register_node
class ImageQuantize:
    """N levels a channel; only dither "none" (error diffusion is
    sequential per pixel, and is refused rather than approximated)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "image": ("IMAGE",),
                "colors": ("INT", {"default": 256}),
                "dither": ("STRING", {"default": "none"}),
            }
        }

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "quantize"

    def quantize(self, image, colors=256, dither="none", context=None):
        if str(dither) != "none":
            raise ValueError("only dither='none' is implemented (error-diffusion dithering is "
                             "sequential per pixel)")
        n = int(colors)
        if not 2 <= n <= 256:
            raise ValueError("colors must be in [2, 256]")
        levels = n - 1
        return (torch.round(torch.clamp(image, 0.0, 1.0) * levels) / levels,)


@register_node
class LatentBatchSeedBehavior:
    """"fixed": every row of the batch gets row 0's initial noise (the
    `batch_index_fixed` flag every sampler node reads); "random": fresh
    noise a row."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "samples": ("LATENT",),
                "seed_behavior": ("STRING", {"default": "fixed"}),
            }
        }

    RETURN_TYPES = ("LATENT",)
    FUNCTION = "op"

    def op(self, samples: dict, seed_behavior="fixed", context=None):
        mode = str(seed_behavior)
        if mode not in ("fixed", "random"):
            raise ValueError(f"seed_behavior must be 'fixed' or 'random', got {mode!r}")
        out = dict(samples)
        if mode == "fixed":
            out["batch_index_fixed"] = True
        else:
            out.pop("batch_index_fixed", None)
        return (out,)
