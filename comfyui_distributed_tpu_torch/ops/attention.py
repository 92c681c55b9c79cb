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
cross-attention at D=64, VAE mid-block at D=512), of SD1.5's txt2img
(D=40, 80 and 160, which the TPU wrapper pads to 128; the softmax scale
stays 1/sqrt(D) of the real head dim) and of Flux's joint attention
(D=128, the TPU kernel's own width: 4608 or, with a Kontext reference,
8704 tokens). The source compiles three instances; `plan` picks one,
with its key tile, query rows per block and key splits, for each call:

- "wgmma": bf16, D=40, 64, 80, 128 or 160, rows 16-byte aligned.
  Warp-specialised for Hopper: TMA loads, wgmma products, the head dim
  in column chunks of their own swizzle, 64 query rows per consumer
  warpgroup, the key tile by D that leaves the fewest slots masked
  (WGMMA_KEY_TILES); at D=40 and 128, where the keys pass
  WGMMA_PINGPONG_ABOVE, two consumers taking turns at the tensor cores
  (WGMMA_PINGPONG_KEYS). P enters P·V as two bf16 (16 bits of P), but
  in D=128's two-consumer plan as one bf16 (WGMMA_BF16_P): there the
  port departs from the TPU kernel, which multiplies an f32 P by V.
- "wgmma512": bf16, D=512, aligned. Warp-specialised, two consumer
  warpgroups sharing 64 query rows (256 output dims each), 32-key tiles,
  each row block's keys split over as many blocks as fill the card best;
  a second kernel merges the splits.
- "fma": f32 (either D) and unaligned bf16 views. f32 FMAs.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import threading

import torch

from .. import _build

# head dims the kernels are instantiated for (template parameters in
# csrc/flash_attention.cu); the other model families' head dims are
# later instantiations
KERNEL_HEAD_DIMS = (40, 64, 80, 128, 160, 512)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# instance codes of csrc/flash_attention.cu
INSTANCES = {"fma": 0, "wgmma": 2, "wgmma512": 3}
# compiled key tiles of the wgmma instance with one consumer warpgroup, by
# head dim: wgmma's N is a multiple of 8 up to 256 and P V steps keys by
# 16. Each D's tiles give its path's key counts few masked slots: M = 77
# one tile of 80, M = 1024 tiles of 128 (D = 80), M = 256 and 64 tiles of
# 64 (D = 160, whose registers a 128-key tile would crowd), M = 324 and
# 1296 (D = 64) tiles of 112 and 144; at D = 128 tiles of 64 with P split
# in two bf16 (64 accumulator registers a thread, two blocks an SM), for
# the key counts up to WGMMA_PINGPONG_ABOVE[128].
WGMMA_KEY_TILES = {40: (80,), 64: (80, 112, 144), 80: (80, 128), 128: (64,),
                   160: (64, 80)}
# the wgmma instance with two consumer warpgroups of 64 query rows in one
# block (one block an SM) taking turns at the tensor cores, so that one's
# softmax runs under the other's products (FA3's ping-pong), and sharing
# each K and V tile, by head dim: its key tile. At D=40, where the
# softmax's exp2 binds, it beat one consumer a block (two blocks an SM)
# at self@4096 (PERF.md, PR 6). At D=128 (Flux's joint attention) it
# rounds P once to bf16 (WGMMA_BF16_P): with P split, two consumers of
# 64-key tiles had measured no faster than one (PERF.md, PR 12); with one
# bf16 P a thread holds up to 176-key tiles (88 score, 44 P and 64
# accumulator registers).
WGMMA_PINGPONG_KEYS = {40: (128,), 128: (144, 176)}
# what one key tile of a two-consumer plan costs beyond its key slots
# (turn-taking, barriers, the rescale), in key slots: fitted to D=128's
# 128-, 144- and 176-key tiles at 8704 keys, where it orders them as
# measured at 4608, 8704 and 4481 keys too (PERF.md, PR 13)
PINGPONG_TILE_COST_KEYS = 18
# the router takes the two-consumer plan for keys past this many: at D=40
# past its one 80-key tile; at D=128 past 1024. Over Flux's 4608 query
# rows and 24 heads one bf16 P misses the f32 plain version where few keys
# share the weight: its emulation (`bf16_p_attention_reference`) by 2.4-4.3
# times the kernel's tolerance at 2-16 keys and holds at 0.66 of it at
# 1025 (tests/test_torch_attention_d128.py); the kernel by 1.56 times at 63
# keys, 0.87 at 257, 0.66 at 1025 (chip_smoke.py's [threshold] line,
# PERF.md, PR 13)
WGMMA_PINGPONG_ABOVE = {40: 80, 128: 1024}
# head dims whose two-consumer plan rounds P once to bf16 for P·V, with the
# row sum taken from the f32 P; every other wgmma plan splits P in two bf16
WGMMA_BF16_P = frozenset({128})
# compiled tiles of the FMA kernel, by head dim: (keys, query rows)
_FMA_TILES = {40: (64, 128), 64: (64, 64), 80: (64, 64), 128: (64, 64), 160: (64, 64),
              512: (32, 32)}
# query rows per block of the wgmma instances (one consumer warpgroup's)
WGMMA_ROWS = 64
# the D=512 instance's key tile: two stages of 32-key K and V tiles and
# the resident Q tile fill the block's shared memory
WGMMA512_KEYS = 32
# SMs of an H100 SXM: the router's default card
H100_SMS = 132
# the most key splits one row block gets, and what one split's partial
# output costs (256 KB of f32 written and read again per row block) in
# units of one block's key tile
MAX_KEY_SPLITS = 16
_SPLIT_COST = 0.08

_library = None  # (ctypes functions, BuildResult) once built and loaded
# one build and load per process, however many threads launch first
_library_lock = threading.Lock()
# the launch counts are read-modify-writes shared by every thread that
# runs a model (a master and a worker in one process)
_counts_lock = threading.Lock()


@dataclasses.dataclass(frozen=True)
class Plan:
    """Which compiled kernel takes a call, and its tile: `keys_per_tile`
    keys per K/V tile, `rows_per_cta` query rows per thread block,
    `splits` blocks sharing each block of query rows, each over its own
    run of key tiles (more than one only for "wgmma512")."""

    instance: str
    keys_per_tile: int
    rows_per_cta: int
    splits: int = 1

    def key_tiles(self, m: int) -> int:
        return -(-m // self.keys_per_tile)

    def masked_share(self, m: int) -> float:
        """Share of the key slots the tiles give that lie past M."""
        slots = self.key_tiles(m) * self.keys_per_tile
        return (slots - m) / slots

    def ctas(self, b: int, n: int, h: int) -> int:
        return -(-n // self.rows_per_cta) * b * h * self.splits


@functools.lru_cache(maxsize=256)
def pingpong_key_tile(d: int, m: int) -> int:
    """The two-consumer key tile compiled at head dim D that takes M in
    the least time by its slots and per-tile cost; of two as good, the
    larger."""
    return min(WGMMA_PINGPONG_KEYS[d],
               key=lambda t: (-(-m // t) * (t + PINGPONG_TILE_COST_KEYS), -t))


@functools.lru_cache(maxsize=256)
def _wgmma_key_tile(d: int, m: int) -> int:
    """The key tile compiled at head dim D that gives M the fewest key
    slots; of two with as many, the larger (fewer tiles)."""
    return min(WGMMA_KEY_TILES[d], key=lambda t: (-(-m // t) * t, -t))


def wgmma_plans(d: int) -> list[Plan]:
    """Every compiled plan of the wgmma instance at head dim D: each key
    tile with one consumer warpgroup, then each with two."""
    return ([Plan("wgmma", keys, WGMMA_ROWS) for keys in WGMMA_KEY_TILES[d]]
            + [Plan("wgmma", keys, 2 * WGMMA_ROWS) for keys in WGMMA_PINGPONG_KEYS.get(d, ())])


def _wgmma_plan(d: int, m: int) -> Plan:
    """Two consumers a block where D has them and M passes
    WGMMA_PINGPONG_ABOVE, with the key tile of `pingpong_key_tile`; else
    one consumer with the key tile of the fewest slots."""
    if d in WGMMA_PINGPONG_KEYS and m > WGMMA_PINGPONG_ABOVE[d]:
        return Plan("wgmma", pingpong_key_tile(d, m), 2 * WGMMA_ROWS)
    return Plan("wgmma", _wgmma_key_tile(d, m), WGMMA_ROWS)


@functools.lru_cache(maxsize=256)
def key_splits(row_blocks: int, tiles: int, sms: int = H100_SMS) -> int:
    """Blocks to split each row block's `tiles` key tiles over, with one
    block per SM: the count that gives the least time in key tiles (waves
    times the tiles of the longest split), plus the merge's cost for more
    than one; of two as good, the fewer. Never more splits than tiles, so
    no split is left without a key (its row max would be -inf)."""

    def cost(s: int) -> tuple[float, int]:
        waves = -(-row_blocks * s // sms)
        merge = _SPLIT_COST * row_blocks * s if s > 1 else 0.0
        return waves * -(-tiles // s) + merge, s

    return min(range(1, min(tiles, MAX_KEY_SPLITS) + 1), key=cost)


def _tensor_core_aligned(*tensors: torch.Tensor) -> bool:
    """TMA needs every row of q, k and v to start on a 16-byte boundary:
    the base address and the batch, token and head strides (bf16:
    multiples of 8 elements; a D=40 row is 80 bytes, five 16-byte
    chunks, so contiguous D=40 views pass)."""
    for t in tensors:
        sb, sn, sh, _ = t.stride()
        if t.data_ptr() % 16 or sb % 8 or sn % 8 or sh % 8:
            return False
    return True


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sms: int = H100_SMS) -> Plan:
    """The router: the instance, tile and key splits for one call of
    `flash_attention` on a card of `sms` SMs.

    A pure function of the inputs' dtype, shapes, strides and alignment.
    Aligned bf16 at D=40, 64, 80, 128 or 160 goes to the wgmma instance, at
    D=512 to wgmma512, everything else to the FMA kernel."""
    b, n, h, d = q.shape
    m = k.shape[1]
    if q.dtype == torch.bfloat16 and _tensor_core_aligned(q, k, v):
        if d in WGMMA_KEY_TILES:
            return _wgmma_plan(d, m)
        if d == 512:
            row_blocks = -(-n // WGMMA_ROWS) * b * h
            tiles = -(-m // WGMMA512_KEYS)
            return Plan("wgmma512", WGMMA512_KEYS, WGMMA_ROWS, key_splits(row_blocks, tiles, sms))
    return Plan("fma", *_FMA_TILES[d])


@functools.lru_cache(maxsize=16)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def load_library():
    """Build (first use only) and load the kernel library; returns
    ((`cdt_flash_attention_fwd`, `cdt_flash_attention_blocks_per_sm`) as
    ctypes functions, BuildResult)."""
    global _library
    with _library_lock:
        if _library is None:
            _library = _load()
    return _library


def _load():
    result = _build.build("flash_attention.cu")
    lib = ctypes.CDLL(result.path)
    fwd = lib.cdt_flash_attention_fwd
    fwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
        + [ctypes.c_void_p, ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    fwd.restype = ctypes.c_int
    occupancy = lib.cdt_flash_attention_blocks_per_sm
    occupancy.argtypes = [ctypes.c_int] * 6
    occupancy.restype = ctypes.c_int
    return (fwd, occupancy), result


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


# the most f32 scores [B, H, rows, M] the plain version forms at once; past
# it the query rows go in chunks (rows are independent, so the result is
# the same): WAN's 14B self-attention, [2, 28350, 40, 128], would be
# 257 GB of scores whole
REFERENCE_CHUNK_ELEMENTS = 2**28


def _query_row_chunks(q: torch.Tensor, m: int) -> list[slice]:
    """Slices of q's rows (dim 1) whose [B, H, rows, M] scores stay within
    REFERENCE_CHUNK_ELEMENTS; one slice when the whole fits."""
    b, n, h, _ = q.shape
    rows = max(1, REFERENCE_CHUNK_ELEMENTS // max(1, b * h * m))
    return [slice(start, min(start + rows, n)) for start in range(0, n, rows)]


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> torch.Tensor:
    """The kernel's plain version: softmax((q*scale) k^T) v with both
    products in f32, output in q's dtype; past REFERENCE_CHUNK_ELEMENTS
    scores in chunks of query rows."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    parts = []
    for rows in _query_row_chunks(q, k.shape[1]):
        qf = q[:, rows].float().permute(0, 2, 1, 3) * scale
        probs = torch.softmax(qf @ kf.transpose(-1, -2), dim=-1)
        parts.append((probs @ vf).permute(0, 2, 1, 3).to(q.dtype))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def bf16_p_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, keys_per_tile: int,
    scale: float | None = None,
) -> torch.Tensor:
    """The arithmetic of the plans that round P once to bf16
    (WGMMA_BF16_P), in plain PyTorch: the online softmax over key tiles of
    `keys_per_tile`, in log2 units; each tile's P = 2^(s scale log2(e) -
    running max) rounded once to bf16 for P·V (products exact, summed in
    f32), the row sum taken from the f32 P. Output in q's dtype; query
    rows in chunks whose one tile's scores stay within
    REFERENCE_CHUNK_ELEMENTS (rows are independent). Tests hold
    it against the TPU kernel and the f32 plain version, and chip_smoke.py
    holds the kernel to it; the port never calls it."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    chunks = _query_row_chunks(q, keys_per_tile)
    if len(chunks) > 1:
        return torch.cat([bf16_p_attention_reference(q[:, rows], k, v, keys_per_tile, scale)
                          for rows in chunks], dim=1)
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    scale_log2 = scale * math.log2(math.e)
    row_max = torch.full((*qf.shape[:3], 1), -math.inf, device=qf.device)
    row_sum = torch.zeros_like(row_max)
    acc = torch.zeros_like(qf)
    for start in range(0, kf.shape[2], keys_per_tile):
        scores = qf @ kf[:, :, start:start + keys_per_tile].transpose(-1, -2) * scale_log2
        new_max = torch.maximum(row_max, scores.amax(dim=-1, keepdim=True))
        correction = torch.exp2(row_max - new_max)
        probs = torch.exp2(scores - new_max)
        row_sum = row_sum * correction + probs.sum(dim=-1, keepdim=True)
        acc = acc * correction + probs.bfloat16().float() @ vf[:, :, start:start + keys_per_tile]
        row_max = new_max
    return (acc / row_sum).permute(0, 2, 1, 3).to(q.dtype)


def key_split_ranges(m: int, keys_per_tile: int, splits: int) -> list[tuple[int, int]]:
    """Keys [start, stop) of each split, as the wgmma512 kernel cuts them:
    of the T key tiles, split s takes tiles floor(s T / S) up to
    floor((s + 1) T / S); the last split ends at M. With S <= T no split
    is empty."""
    tiles = -(-m // keys_per_tile)
    if not 1 <= splits <= tiles:
        raise ValueError(f"{splits} key splits of {tiles} key tiles would leave a split empty")
    return [
        (s * tiles // splits * keys_per_tile, min((s + 1) * tiles // splits * keys_per_tile, m))
        for s in range(splits)
    ]


def split_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, splits: int,
    keys_per_tile: int = WGMMA512_KEYS, scale: float | None = None,
) -> torch.Tensor:
    """The plain version of the wgmma512 kernel's key splits and their
    merge, in f32 math: each split's attention kept as its unnormalised
    output o_s, row max m_s (scores in log2 units, as the kernel keeps
    them) and row sum l_s; then o = sum_s 2^(m_s - m) o_s / sum_s
    2^(m_s - m) l_s with m = max_s m_s, added in split order. Output in
    q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float().permute(0, 2, 1, 3) * (scale * math.log2(math.e))
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    parts = []
    for start, stop in key_split_ranges(k.shape[1], keys_per_tile, splits):
        scores = qf @ kf[:, :, start:stop].transpose(-1, -2)
        row_max = scores.amax(dim=-1, keepdim=True)
        probs = torch.exp2(scores - row_max)
        parts.append((probs @ vf[:, :, start:stop], row_max, probs.sum(dim=-1, keepdim=True)))
    top = torch.stack([row_max for _, row_max, _ in parts]).amax(dim=0)
    num = sum(torch.exp2(row_max - top) * o for o, row_max, _ in parts)
    den = sum(torch.exp2(row_max - top) * row_sum for _, row_max, row_sum in parts)
    return (num / den).permute(0, 2, 1, 3).to(q.dtype)


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
    -1: "the plan names no compiled kernel, or more key splits than key tiles",
    -2: "a TMA tensor map could not be encoded",
    -3: "the view is not aligned for the planned tensor-core kernel",
}


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None,
    with_plan: Plan | None = None,
) -> torch.Tensor:
    """Launch the Hopper kernel `plan(q, k, v)` picks (or `with_plan`) on the
    current stream; raises on input it does not take. Each call adds one
    to `flash_attention.launches` and to its instance's entry of
    `flash_attention.launches_by_instance` (a split call's merge kernel
    is part of its one launch)."""
    _check(q, k, v)
    b, n, h, d = q.shape
    m = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    device = q.get_device()
    p = plan(q, k, v, _sm_count(device)) if with_plan is None else with_plan
    (fwd, _), _ = load_library()
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    # the splits' partial outputs and row statistics, for the merge
    scratch = (
        torch.empty(p.splits * b * h * n * (d + 2), dtype=torch.float32, device=q.device)
        if p.splits > 1 else None
    )
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    rc = fwd(
        INSTANCES[p.instance], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        _DTYPE_CODES[q.dtype], d, device, b, n, m, h,
        ctypes.addressof(strides), float(scale), p.keys_per_tile, p.rows_per_cta, p.splits,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        reason = _LAUNCH_ERRORS.get(rc, f"CUDA error {rc}")
        raise RuntimeError(f"flash_attention launch failed ({p}): {reason}")
    count_launch(p.instance)
    return out


def count_launch(instance: str) -> None:
    """Add one launch of `instance` to `flash_attention.launches` and
    `flash_attention.launches_by_instance`, under a lock."""
    with _counts_lock:
        flash_attention.launches += 1
        flash_attention.launches_by_instance[instance] += 1


def reset_launch_counts() -> None:
    with _counts_lock:
        flash_attention.launches = 0
        flash_attention.launches_by_instance = dict.fromkeys(INSTANCES, 0)


reset_launch_counts()
