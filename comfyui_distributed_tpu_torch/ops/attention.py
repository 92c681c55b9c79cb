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
cross-attention at D=64, VAE mid-block at D=512). The source compiles
three kernels; `plan` picks one, with its key tile and query rows per
block, for each call:

- "wgmma": bf16, D=64, rows 16-byte aligned. Warp-specialised for
  Hopper: TMA loads, wgmma products, 64 query rows per block (one
  consumer warpgroup), a key tile of 80, 112 or 144.
- "mma": bf16, D=512, aligned. mma.sync, 32 query rows and 32 keys.
- "fma": f32 (either D) and unaligned bf16 views. f32 FMAs.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from .. import _build

# head dims the kernels are instantiated for (template parameters in
# csrc/flash_attention.cu); the other model families' head dims are
# later instantiations
KERNEL_HEAD_DIMS = (64, 512)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# instance codes of csrc/flash_attention.cu
INSTANCES = {"fma": 0, "mma": 1, "wgmma": 2}
# compiled key tiles of the wgmma instance: wgmma's N is a multiple of 8
# up to 256 and P V steps keys by 16
WGMMA_KEY_TILES = (80, 112, 144)
# compiled tiles of the other instances, by head dim: (keys, query rows)
_FMA_TILES = {64: (64, 64), 512: (32, 32)}
_MMA_TILES = {512: (32, 32)}
# query rows per block of the wgmma instance (one consumer warpgroup)
WGMMA_ROWS = 64

_library = None  # (ctypes functions, BuildResult) once built and loaded


@dataclasses.dataclass(frozen=True)
class Plan:
    """Which compiled kernel takes a call, and its tile: `keys_per_tile`
    keys per K/V tile, `rows_per_cta` query rows per thread block."""

    instance: str
    keys_per_tile: int
    rows_per_cta: int

    def key_tiles(self, m: int) -> int:
        return -(-m // self.keys_per_tile)

    def masked_share(self, m: int) -> float:
        """Share of the key slots the tiles give that lie past M."""
        slots = self.key_tiles(m) * self.keys_per_tile
        return (slots - m) / slots

    def ctas(self, b: int, n: int, h: int) -> int:
        return -(-n // self.rows_per_cta) * b * h


@functools.lru_cache(maxsize=256)
def _wgmma_key_tile(m: int) -> int:
    """The compiled key tile that gives M the fewest key slots; of two
    with as many, the larger (fewer tiles)."""
    return min(WGMMA_KEY_TILES, key=lambda t: (-(-m // t) * t, -t))


def _tensor_core_aligned(*tensors: torch.Tensor) -> bool:
    """TMA and the 16-byte copies need every row of q, k and v to start on
    a 16-byte boundary: the base address and the batch, token and head
    strides (bf16: multiples of 8 elements)."""
    for t in tensors:
        sb, sn, sh, _ = t.stride()
        if t.data_ptr() % 16 or sb % 8 or sn % 8 or sh % 8:
            return False
    return True


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Plan:
    """The router: the instance and tile for one call of `flash_attention`.

    A pure function of the inputs' dtype, shapes, strides and alignment.
    Aligned bf16 at D=64 goes to the wgmma instance, aligned bf16 at
    D=512 to mma.sync, everything else to the FMA kernel."""
    d = q.shape[-1]
    m = k.shape[1]
    if q.dtype == torch.bfloat16 and _tensor_core_aligned(q, k, v):
        if d == 64:
            return Plan("wgmma", _wgmma_key_tile(m), WGMMA_ROWS)
        if d in _MMA_TILES:
            return Plan("mma", *_MMA_TILES[d])
    return Plan("fma", *_FMA_TILES[d])


def load_library():
    """Build (first use only) and load the kernel library; returns
    ((`cdt_flash_attention_fwd`, `cdt_flash_attention_blocks_per_sm`) as
    ctypes functions, BuildResult)."""
    global _library
    if _library is None:
        result = _build.build("flash_attention.cu")
        lib = ctypes.CDLL(result.path)
        fwd = lib.cdt_flash_attention_fwd
        fwd.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        fwd.restype = ctypes.c_int
        occupancy = lib.cdt_flash_attention_blocks_per_sm
        occupancy.argtypes = [ctypes.c_int] * 6
        occupancy.restype = ctypes.c_int
        _library = ((fwd, occupancy), result)
    return _library


def blocks_per_sm(p: Plan, dtype: torch.dtype, head_dim: int, device: int = 0) -> int:
    """Thread blocks of the planned kernel that fit on one SM at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    (_, occupancy), _ = load_library()
    rc = occupancy(INSTANCES[p.instance], _DTYPE_CODES[dtype], head_dim,
                   p.keys_per_tile, p.rows_per_cta, device)
    if rc <= 0:
        raise RuntimeError(f"no occupancy for {p} at {dtype}, D={head_dim}: code {rc}")
    return rc


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


_LAUNCH_ERRORS = {
    -1: "the plan names no compiled kernel",
    -2: "a TMA tensor map could not be encoded",
    -3: "the view is not aligned for the planned tensor-core kernel",
}


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None,
    with_plan: Plan | None = None,
) -> torch.Tensor:
    """Launch the Hopper kernel `plan(q, k, v)` picks (or `with_plan`) on the
    current stream; raises on input it does not take. Each launch adds
    one to `flash_attention.launches` and to its instance's entry of
    `flash_attention.launches_by_instance`."""
    _check(q, k, v)
    b, n, h, d = q.shape
    m = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    p = plan(q, k, v) if with_plan is None else with_plan
    (fwd, _), _ = load_library()
    device = q.get_device()
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    rc = fwd(
        INSTANCES[p.instance], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[q.dtype], d, device, b, n, m, h,
        ctypes.addressof(strides), float(scale), p.keys_per_tile, p.rows_per_cta,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        reason = _LAUNCH_ERRORS.get(rc, f"CUDA error {rc}")
        raise RuntimeError(f"flash_attention launch failed ({p}): {reason}")
    flash_attention.launches += 1
    flash_attention.launches_by_instance[p.instance] += 1
    return out


def reset_launch_counts() -> None:
    flash_attention.launches = 0
    flash_attention.launches_by_instance = dict.fromkeys(INSTANCES, 0)


reset_launch_counts()
