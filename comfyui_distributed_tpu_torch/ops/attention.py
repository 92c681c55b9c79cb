"""Attention for [B, N, H, D] tensors: the router, the Hopper kernel's
wrapper and the kernel's plain version.

`dot_product_attention` is what the models call. A CPU tensor goes to
`flash_attention_reference`, plain PyTorch in f32 math; a CUDA tensor
goes to `flash_attention`, which launches the hand-written kernel in
`csrc/flash_attention.cu` or raises. There is no fallback from one to
the other: the device of the input decides.

The kernel is the port of comfyui_distributed_tpu/ops/attention.py::
flash_attention. Unlike the TPU kernel it takes ragged N and M, so it
carries every attention call of the SDXL upscale path (UNet self- and
cross-attention at D=64, VAE mid-block at D=512).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

# head dims the kernel is instantiated for (template parameters in
# csrc/flash_attention.cu); the other model families' head dims are
# later instantiations
KERNEL_HEAD_DIMS = (64, 512)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_library = None  # (ctypes function, BuildResult) once built and loaded


def load_library():
    """Build (first use only) and load the kernel library; returns
    (`cdt_flash_attention_fwd` as a ctypes function, BuildResult)."""
    global _library
    if _library is None:
        result = _build.build("flash_attention.cu")
        fn = ctypes.CDLL(result.path).cdt_flash_attention_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _library = (fn, result)
    return _library


def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """[B, N, H, D] queries against [B, M, H, D] keys/values →
    [B, N, H, D] in q's dtype, softmax scale 1/sqrt(D)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    return flash_attention(q, k, v)


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> torch.Tensor:
    """The kernel's plain version: softmax((q*scale) k^T) v with both
    products in f32, output in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float().permute(0, 2, 1, 3) * scale
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    probs = torch.softmax(qf @ kf.transpose(-1, -2), dim=-1)
    return (probs @ vf).permute(0, 2, 1, 3).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes [B, N, H, D] tensors")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(
            f"flash_attention shapes disagree: q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("flash_attention needs N >= 1 and M >= 1")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"flash_attention is built for head dims {KERNEL_HEAD_DIMS}, got {d}"
        )
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            "flash_attention takes float32 or bfloat16 q, k, v of one dtype, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention needs a contiguous last (head) dim")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(
            "flash_attention launches a CUDA kernel and takes CUDA tensors "
            f"on one device, got {q.device}, {k.device}, {v.device}"
        )


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> torch.Tensor:
    """Launch the Hopper kernel on the current stream; raises on input
    it does not take. Each launch adds one to `flash_attention.launches`."""
    _check(q, k, v)
    b, n, h, d = q.shape
    m = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    fn, _ = load_library()
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in (t.stride(0), t.stride(1), t.stride(2)))
    )
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[q.dtype], d, q.device.index, b, n, m, h,
        ctypes.addressof(strides), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
