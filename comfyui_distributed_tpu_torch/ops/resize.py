"""Image resizing with jax.image.resize's sampling.

Counterpart of the resize of comfyui_distributed_tpu/ops/upscale.py:
`jax.image.resize` (scale and translate: half-pixel centres, the kernel
widened by the factor when it shrinks, renormalised at the edges) for
each user-facing method name, and an exact box average for "area"; and
the size rules of the resize nodes (`resolve_resize_dims`, `scale_dims`,
`center_crop_to_aspect`). The upscale path, the conditioning planes
(hints, masks), the upscale model's base image and the image and latent
resize nodes all resize through it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.layers import resize_nearest

# user-facing upscale_method names → the jax.image.resize kernel the JAX
# package routes them to; "area" is an exact box average
RESIZE_METHODS = {
    "bicubic": "cubic",
    "bilinear": "linear",
    "nearest": "nearest",
    "nearest-exact": "nearest",
    "lanczos": "lanczos3",
}


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _lanczos3(x: np.ndarray) -> np.ndarray:
    radius = 3.0
    y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(x > 1e-3, y / np.where(x != 0, np.pi**2 * x**2, 1), 1.0)
    return np.where(x > radius, 0.0, out)


_KERNELS = {"cubic": _keys_cubic, "linear": _triangle, "lanczos3": _lanczos3}


def _scale_weights(n_in: int, n_out: int, kernel: str) -> np.ndarray:
    """[n_in, n_out] resampling weights of jax.image.resize (scale and
    translate with antialiasing): half-pixel centres, the kernel widened
    by the downscale factor, columns normalised, samples outside the
    input zeroed."""
    scale = n_out / n_in
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    weights = _KERNELS[kernel](x)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, 1),
        0.0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], weights, 0.0).astype(np.float32)


def _area_weights(n_out: int, n_in: int) -> np.ndarray:
    """[n_out, n_in] row-stochastic box weights (adaptive average pool)."""
    scale = n_in / n_out
    w = np.zeros((n_out, n_in), dtype=np.float32)
    for i in range(n_out):
        lo, hi = i * scale, (i + 1) * scale
        for j in range(int(np.floor(lo)), min(int(np.ceil(hi)), n_in)):
            cover = min(hi, j + 1) - max(lo, j)
            if cover > 0:
                w[i, j] = cover
        w[i] /= max(w[i].sum(), 1e-12)
    return w


def resize_image(image: torch.Tensor, out_h: int, out_w: int, method_name: str) -> torch.Tensor:
    """[B, H, W, C] → [B, out_h, out_w, C] with the JAX package's
    sampling for each method name. Unknown names raise; identical sizes
    return the input untouched. F.interpolate is not used: its bicubic
    is the a=-0.75 kernel with other edge handling."""
    if method_name != "area" and method_name not in RESIZE_METHODS:
        raise ValueError(
            f"unknown upscale_method {method_name!r}; use {sorted(RESIZE_METHODS) + ['area']}"
        )
    b, h, w, c = image.shape
    if (h, w) == (out_h, out_w):
        return image
    if method_name == "area":
        wh = torch.from_numpy(_area_weights(out_h, h)).to(image.device)
        ww = torch.from_numpy(_area_weights(out_w, w)).to(image.device)
        return torch.einsum("oh,bhwc,pw->bopc", wh, image.float(), ww)
    kernel = RESIZE_METHODS[method_name]
    if kernel == "nearest":
        return resize_nearest(image.permute(0, 3, 1, 2), (out_h, out_w)).permute(0, 2, 3, 1)
    out = image.float()
    if h != out_h:
        wh = torch.from_numpy(_scale_weights(h, out_h, kernel)).to(image.device)
        out = torch.einsum("bhwc,ho->bowc", out, wh)
    if w != out_w:
        ww = torch.from_numpy(_scale_weights(w, out_w, kernel)).to(image.device)
        out = torch.einsum("bhwc,wp->bhpc", out, ww)
    return out


def resolve_resize_dims(h: int, w: int, target_w: int, target_h: int) -> tuple[int, int]:
    """(out_h, out_w) by ComfyUI's common_upscale rule: a 0 target side
    keeps the source aspect (0 and 0 keep the size)."""
    if target_w == 0 and target_h == 0:
        return h, w
    if target_w == 0:
        return target_h, max(1, round(w * target_h / h))
    if target_h == 0:
        return max(1, round(h * target_w / w)), target_w
    return target_h, target_w


def scale_dims(h: int, w: int, factor: float) -> tuple[int, int]:
    """(out_h, out_w) of a resize by a factor (the *UpscaleBy nodes):
    rounded to the nearest, at least 1."""
    return max(1, int(round(h * float(factor)))), max(1, int(round(w * float(factor))))


def center_crop_to_aspect(planes: list, out_h: int, out_w: int) -> list:
    """[B, H, W, ...] planes of one geometry centre-cropped to the
    (out_h, out_w) aspect (common_upscale's crop "center"), all alike."""
    h, w = planes[0].shape[1], planes[0].shape[2]
    aspect = out_w / out_h
    if w / h > aspect:
        cw = max(1, round(h * aspect))
        x0 = (w - cw) // 2
        return [p[:, :, x0:x0 + cw] for p in planes]
    if w / h < aspect:
        ch = max(1, round(w / aspect))
        y0 = (h - ch) // 2
        return [p[:, y0:y0 + ch] for p in planes]
    return list(planes)
