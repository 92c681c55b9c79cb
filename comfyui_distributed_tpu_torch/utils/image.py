"""Image codecs for the HTTP tier, on the standard library.

The port's own copy of comfyui_distributed_tpu/utils/image.py, written
on `zlib` and `struct` instead of PIL (the card's machine has no PIL).
Arrays are channel-last float [H, W, C] (or [1, H, W, C]) in [0, 1];
PNG files are 8-bit greyscale (C = 1), RGB or RGBA, not interlaced.
The encoder writes every row unfiltered; the decoder undoes all five
PNG row filters, so it reads what PIL and other encoders write.
`encode_apng_u8` writes an animated PNG (acTL, fcTL and fdAT chunks,
every frame whole and unfiltered) where the JAX package calls PIL's
save_all.

The float → uint8 rule is the JAX package's `f32_to_u8`
(comfyui_distributed_tpu/native/__init__.py), reproduced exactly:
clip to [0, 1], times 255, plus 0.5, truncate, all in float32.
"""

from __future__ import annotations

import base64
import struct
import zlib

import numpy as np

DATA_URL_PREFIX = "data:image/png;base64,"
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type ↔ channels, 8-bit samples only
_COLOR_TYPES = {0: 1, 2: 3, 6: 4}
_CHANNEL_COLOR_TYPE = {c: t for t, c in _COLOR_TYPES.items()}


def ensure_numpy(tensor) -> np.ndarray:
    """Accept torch tensors and numpy-convertible arrays; return a
    contiguous float32 numpy array (a CUDA tensor is copied to the host)."""
    if hasattr(tensor, "detach"):
        tensor = tensor.detach().float().cpu().numpy()
    return np.ascontiguousarray(np.asarray(tensor, dtype=np.float32))


def f32_to_u8(src: np.ndarray) -> np.ndarray:
    src = np.ascontiguousarray(src, dtype=np.float32)
    return (np.clip(src, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def u8_to_f32(src: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(src, dtype=np.uint8).astype(np.float32) / 255.0


def _single_image(image) -> np.ndarray:
    arr = ensure_numpy(image)
    if arr.ndim == 4:
        if arr.shape[0] != 1:
            raise ValueError(f"expected a single image, got batch {arr.shape}")
        arr = arr[0]
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[-1] not in _CHANNEL_COLOR_TYPE:
        raise ValueError(f"expected [H, W, 1|3|4], got {arr.shape}")
    return arr


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png_u8(u8: np.ndarray, compress_level: int = 0) -> bytes:
    """[H, W, C] uint8 → PNG bytes, every row with filter type 0."""
    h, w, c = u8.shape
    header = struct.pack(">IIBBBBB", w, h, 8, _CHANNEL_COLOR_TYPE[c], 0, 0, 0)
    return b"".join((
        PNG_SIGNATURE,
        _chunk(b"IHDR", header),
        _chunk(b"IDAT", zlib.compress(_rows(u8), compress_level)),
        _chunk(b"IEND", b""),
    ))


def _rows(u8: np.ndarray) -> bytes:
    """[H, W, C] uint8 → the scanlines, each with filter type 0."""
    h, w, c = u8.shape
    rows = np.empty((h, 1 + w * c), dtype=np.uint8)
    rows[:, 0] = 0
    rows[:, 1:] = u8.reshape(h, w * c)
    return rows.tobytes()


def encode_apng_u8(frames: np.ndarray, duration_ms: int, compress_level: int = 4,
                   loop: int = 0) -> bytes:
    """[N, H, W, C] uint8 → an animated PNG: every frame the whole canvas
    (dispose none, blend source), shown `duration_ms` ms (delay
    duration_ms/1000), played `loop` times (0: forever). Frame 0 is the
    IDAT image, so a plain PNG reader sees it."""
    n, h, w, c = frames.shape
    header = struct.pack(">IIBBBBB", w, h, 8, _CHANNEL_COLOR_TYPE[c], 0, 0, 0)
    chunks = [PNG_SIGNATURE, _chunk(b"IHDR", header), _chunk(b"acTL", struct.pack(">II", n, loop))]
    seq = 0
    for i in range(n):
        chunks.append(_chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, w, h, 0, 0,
                                                 int(duration_ms), 1000, 0, 0)))
        seq += 1
        data = zlib.compress(_rows(frames[i]), compress_level)
        if i == 0:
            chunks.append(_chunk(b"IDAT", data))
        else:
            chunks.append(_chunk(b"fdAT", struct.pack(">I", seq) + data))
            seq += 1
    chunks.append(_chunk(b"IEND", b""))
    return b"".join(chunks)


def encode_png(image, compress_level: int = 0) -> bytes:
    """One float image → PNG bytes. compress_level 0 trades size for
    speed on the tile path, as the JAX package does."""
    return encode_png_u8(f32_to_u8(_single_image(image)), compress_level)


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_serial(kind: int, line: bytearray, prior: bytes, bpp: int) -> None:
    """Average (3) and Paeth (4) depend on the reconstructed byte to the
    left, so they run byte by byte, in place."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        if kind == 3:
            line[i] = (line[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = prior[i - bpp] if i >= bpp else 0
            line[i] = (line[i] + _paeth(a, b, c)) & 0xFF


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = np.frombuffer(raw, dtype=np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG image data holds {rows.size} bytes, expected {h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    kinds = rows[:, 0]
    out = rows[:, 1:].copy()
    if not kinds.any():
        return out
    if int(kinds.max()) > 4:
        raise ValueError(f"unknown PNG row filter {int(kinds.max())}")
    prior = np.zeros(stride, dtype=np.uint8)
    for y in range(h):
        kind = int(kinds[y])
        if kind == 1:  # Sub: a running sum along the row, per byte of a pixel
            out[y] = np.cumsum(out[y].reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            out[y] += prior
        elif kind in (3, 4):
            line = bytearray(out[y].tobytes())
            _unfilter_serial(kind, line, prior.tobytes(), bpp)
            out[y] = np.frombuffer(bytes(line), dtype=np.uint8)
        prior = out[y]
    return out


def decode_png_u8(data: bytes) -> np.ndarray:
    """PNG bytes → [H, W, C] uint8 (C = 1, 3 or 4)."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    pos = len(PNG_SIGNATURE)
    header = None
    idat = []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color_type, _, _, interlace = header
    if depth != 8 or color_type not in _COLOR_TYPES or interlace != 0:
        raise ValueError(
            f"unsupported PNG: bit depth {depth}, colour type {color_type}, "
            f"interlace {interlace} (8-bit L, RGB or RGBA, not interlaced)"
        )
    channels = _COLOR_TYPES[color_type]
    out = _unfilter(zlib.decompress(b"".join(idat)), h, w * channels, channels)
    return out.reshape(h, w, channels)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → [H, W, C] float32 in [0, 1]."""
    return u8_to_f32(decode_png_u8(data))


def encode_image_data_url(image, compress_level: int = 0) -> str:
    return DATA_URL_PREFIX + base64.b64encode(encode_png(image, compress_level)).decode("ascii")


def decode_image_data_url(data_url: str) -> np.ndarray:
    payload = data_url
    if payload.startswith("data:"):
        _, _, payload = payload.partition(",")
    return decode_png(base64.b64decode(payload))
