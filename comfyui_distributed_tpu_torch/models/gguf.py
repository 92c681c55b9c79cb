"""GGUF checkpoints (quantized single files): reader and writer.

The port's own copy of comfyui_distributed_tpu/models/gguf.py: parse the
GGUF v2/v3 container and dequantize the common block formats to float32
numpy on the host, giving the state dict models/sd_checkpoint.py maps
into modules. Diffusion GGUF files keep the original state-dict names,
so the key schedules apply unchanged.

Tensor types: F32, F16, Q8_0, Q4_0, Q4_1, Q5_0, Q5_1. K-quants (Q*_K)
raise rather than misread.

The writer (`write_gguf`) covers the same types, so tests need no binary
fixtures. It quantizes every block at once in numpy; for F32, F16,
Q8_0, Q4_0 and Q5_0 its bytes are the JAX package's writer's, which
goes block by block.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

GGUF_MAGIC = b"GGUF"

# metadata value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32 = 0, 1, 2, 3, 4, 5
_T_F32, _T_BOOL, _T_STRING, _T_ARRAY, _T_U64, _T_I64, _T_F64 = 6, 7, 8, 9, 10, 11, 12

# tensor (ggml) types
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q4_1 = 2, 3
GGML_Q5_0, GGML_Q5_1 = 6, 7
GGML_Q8_0 = 8

_BLOCK = 32  # elements per quant block

_TYPE_NAMES = {
    GGML_F32: "F32", GGML_F16: "F16", GGML_Q4_0: "Q4_0", GGML_Q4_1: "Q4_1",
    GGML_Q5_0: "Q5_0", GGML_Q5_1: "Q5_1", GGML_Q8_0: "Q8_0",
}

_BLOCK_BYTES = {
    GGML_Q4_0: 2 + 16,
    GGML_Q4_1: 2 + 2 + 16,
    GGML_Q5_0: 2 + 4 + 16,
    GGML_Q5_1: 2 + 2 + 4 + 16,
    GGML_Q8_0: 2 + 32,
}

_SCALAR_FORMATS = {
    _T_U8: "<B", _T_I8: "<b", _T_U16: "<H", _T_I16: "<h", _T_U32: "<I", _T_I32: "<i",
    _T_F32: "<f", _T_U64: "<Q", _T_I64: "<q", _T_F64: "<d",
}


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated GGUF file")
        self.pos += n
        return out

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def string(self) -> str:
        return self.take(self.u64()).decode("utf-8")

    def value(self, vtype: int) -> Any:
        fmt = _SCALAR_FORMATS.get(vtype)
        if fmt is not None:
            return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]
        if vtype == _T_BOOL:
            return bool(self.take(1)[0])
        if vtype == _T_STRING:
            return self.string()
        if vtype == _T_ARRAY:
            etype = self.u32()
            count = self.u64()
            return [self.value(etype) for _ in range(count)]
        raise ValueError(f"unknown GGUF metadata type {vtype}")


def _f16(blocks: np.ndarray, start: int) -> np.ndarray:
    """Column [B, 1] of the f16 at byte `start` of each block, as f32."""
    return blocks[:, start:start + 2].copy().view(np.float16).astype(np.float32)


def _dequant(raw: np.ndarray, gtype: int, n_elements: int) -> np.ndarray:
    """Raw uint8 block data → float32 [n_elements]."""
    blocks = raw.reshape(-1, _BLOCK_BYTES[gtype])
    d = _f16(blocks, 0)
    has_m = gtype in (GGML_Q4_1, GGML_Q5_1)
    off = 4 if has_m else 2
    if gtype == GGML_Q8_0:
        q = blocks[:, 2:].copy().view(np.int8).astype(np.float32)
        return (d * q).reshape(-1)[:n_elements]
    if gtype in (GGML_Q4_0, GGML_Q4_1):
        qs = blocks[:, off:]
        q = np.concatenate([(qs & 0x0F).astype(np.float32), (qs >> 4).astype(np.float32)],
                           axis=1)  # [B, 32]
        out = d * q + _f16(blocks, 2) if has_m else d * (q - 8.0)
        return out.reshape(-1)[:n_elements]
    # Q5_0 / Q5_1: four bytes of high bits, then the low nibbles
    qh = blocks[:, off:off + 4].copy().view(np.uint32)[:, 0]
    qs = blocks[:, off + 4:]
    bit = np.arange(16, dtype=np.uint32)
    lo_h = ((qh[:, None] >> bit) & 1).astype(np.uint8) << 4
    hi_h = ((qh[:, None] >> (bit + 16)) & 1).astype(np.uint8) << 4
    q = np.concatenate([(qs & 0x0F).astype(np.uint8) | lo_h, (qs >> 4).astype(np.uint8) | hi_h],
                       axis=1).astype(np.float32)
    out = d * q + _f16(blocks, 2) if has_m else d * (q - 16.0)
    return out.reshape(-1)[:n_elements]


def read_gguf(path: str) -> dict[str, np.ndarray]:
    """A GGUF file → {tensor name: float32 ndarray} (F16 widened)."""
    with open(path, "rb") as fh:
        data = fh.read()
    r = _Reader(data)
    if r.take(4) != GGUF_MAGIC:
        raise ValueError(f"{path}: not a GGUF file")
    version = r.u32()
    if version not in (2, 3):
        raise ValueError(f"{path}: unsupported GGUF version {version}")
    tensor_count = r.u64()
    kv_count = r.u64()
    metadata: dict[str, Any] = {}
    for _ in range(kv_count):
        key = r.string()
        metadata[key] = r.value(r.u32())
    alignment = int(metadata.get("general.alignment", 32))
    infos = []
    for _ in range(tensor_count):
        name = r.string()
        n_dims = r.u32()
        # ggml dims: ne[0] is the innermost (contiguous): numpy's shape reversed
        dims = [r.u64() for _ in range(n_dims)]
        gtype = r.u32()
        offset = r.u64()
        infos.append((name, dims, gtype, offset))
    base = (r.pos + alignment - 1) // alignment * alignment
    out: dict[str, np.ndarray] = {}
    for name, dims, gtype, offset in infos:
        n = int(np.prod(dims)) if dims else 1
        start = base + offset
        if gtype == GGML_F32:
            arr = np.frombuffer(data, np.float32, count=n, offset=start).copy()
        elif gtype == GGML_F16:
            arr = np.frombuffer(data, np.float16, count=n, offset=start).astype(np.float32)
        elif gtype in _BLOCK_BYTES:
            nbytes = -(-n // _BLOCK) * _BLOCK_BYTES[gtype]
            arr = _dequant(np.frombuffer(data, np.uint8, count=nbytes, offset=start), gtype, n)
        else:
            raise ValueError(
                f"{path}: tensor {name!r} uses unsupported ggml type {gtype} "
                f"(supported: {sorted(_TYPE_NAMES.values())})")
        out[name] = arr.reshape(tuple(reversed(dims)))
    return out


# --- writer -------------------------------------------------------------------

def _scale(value: np.ndarray) -> np.ndarray:
    """A per-block scale in double, 0 replaced by 1e-12 (the JAX writer's
    `x or 1e-12`)."""
    return np.where(value == 0.0, 1e-12, value)


def _quantize(arr: np.ndarray, gtype: int) -> bytes:
    """Every block of `arr` at once. The arithmetic is the JAX writer's:
    scales in double, the division in f32, scales stored as f16."""
    flat = arr.astype(np.float32).reshape(-1)
    flat = np.concatenate([flat, np.zeros((-len(flat)) % _BLOCK, np.float32)])
    blocks = flat.reshape(-1, _BLOCK)
    rows = np.arange(len(blocks))
    if gtype in (GGML_Q4_1, GGML_Q5_1):
        lo = blocks.min(axis=1)
        levels = 15.0 if gtype == GGML_Q4_1 else 31.0
        d = _scale((blocks.max(axis=1).astype(np.float64) - lo) / levels)
        q = np.clip(np.round((blocks - lo[:, None]) / d.astype(np.float32)[:, None]), 0,
                    levels).astype(np.uint8)
        head = [d.astype(np.float16).view(np.uint8).reshape(-1, 2),
                lo.astype(np.float16).view(np.uint8).reshape(-1, 2)]
    elif gtype == GGML_Q8_0:
        d = _scale(np.abs(blocks).max(axis=1).astype(np.float64) / 127.0)
        q = np.clip(np.round(blocks / d.astype(np.float32)[:, None]), -127, 127).astype(np.int8)
        return np.concatenate([d.astype(np.float16).view(np.uint8).reshape(-1, 2),
                               q.view(np.uint8)], axis=1).tobytes()
    elif gtype in (GGML_Q4_0, GGML_Q5_0):
        half = 8 if gtype == GGML_Q4_0 else 16
        amax = blocks[rows, np.abs(blocks).argmax(axis=1)]
        d = _scale(amax.astype(np.float64) / -float(half))
        q = np.clip(np.round(blocks / d.astype(np.float32)[:, None]) + half, 0,
                    2 * half - 1).astype(np.uint8)
        head = [d.astype(np.float16).view(np.uint8).reshape(-1, 2)]
    else:
        raise ValueError(f"writer does not support ggml type {gtype}")
    if gtype in (GGML_Q5_0, GGML_Q5_1):
        bits = (q >> 4).astype(np.uint32)
        qh = (bits[:, :16] << np.arange(16, dtype=np.uint32)).sum(axis=1, dtype=np.uint32)
        qh |= (bits[:, 16:] << np.arange(16, 32, dtype=np.uint32)).sum(axis=1, dtype=np.uint32)
        head.append(qh.astype("<u4").view(np.uint8).reshape(-1, 4))
    packed = ((q[:, :16] & 0xF) | ((q[:, 16:] & 0xF) << 4)).astype(np.uint8)
    return np.concatenate(head + [packed], axis=1).tobytes()


def write_gguf(path: str, tensors: dict[str, tuple[np.ndarray, int]],
               metadata: dict[str, Any] | None = None, alignment: int = 32) -> int:
    """Write {name: (array, ggml type)} as a GGUF v3 file; returns its bytes."""
    def enc_string(s: str) -> bytes:
        raw = s.encode("utf-8")
        return struct.pack("<Q", len(raw)) + raw

    meta = {"general.alignment": alignment, **(metadata or {})}
    head = bytearray(GGUF_MAGIC)
    head += struct.pack("<I", 3) + struct.pack("<Q", len(tensors)) + struct.pack("<Q", len(meta))
    for key, value in meta.items():
        head += enc_string(key)
        if isinstance(value, bool):
            head += struct.pack("<I", _T_BOOL) + struct.pack("<B", value)
        elif isinstance(value, int):
            head += struct.pack("<I", _T_U32) + struct.pack("<I", value)
        elif isinstance(value, float):
            head += struct.pack("<I", _T_F32) + struct.pack("<f", value)
        else:
            head += struct.pack("<I", _T_STRING) + enc_string(str(value))
    blobs = []
    offset = 0
    for name, (arr, gtype) in tensors.items():
        if gtype == GGML_F32:
            blob = np.asarray(arr).astype(np.float32).tobytes()
        elif gtype == GGML_F16:
            blob = np.asarray(arr).astype(np.float16).tobytes()
        else:
            blob = _quantize(np.asarray(arr), gtype)
        head += enc_string(name)
        dims = list(reversed(np.shape(arr)))  # numpy → ggml dim order
        head += struct.pack("<I", len(dims))
        for dim in dims:
            head += struct.pack("<Q", dim)
        head += struct.pack("<I", gtype) + struct.pack("<Q", offset)
        padded = (len(blob) + alignment - 1) // alignment * alignment
        blobs.append(blob + b"\x00" * (padded - len(blob)))
        offset += padded
    base_pad = (-len(head)) % alignment
    with open(path, "wb") as fh:
        fh.write(bytes(head) + b"\x00" * base_pad)
        for blob in blobs:
            fh.write(blob)
    return len(head) + base_pad + offset
