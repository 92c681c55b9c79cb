"""Animated WEBP on the standard library and numpy (no PIL).

SaveAnimatedWEBP writes through here: the card's machine has no PIL, and
the JAX node calls PIL's `save_all`. The file is a RIFF container,

    RIFF <size> WEBP
      VP8X  flags (animation, alpha when a frame has one), canvas size
      ANIM  background 0 (transparent black), loop count 0 (forever)
      ANMF  one a frame: offset 0, the frame's size, its duration, no
            blending, no disposal; holding
        VP8L  the frame as a lossless bitstream

every chunk padded to an even size. Each frame is one VP8L image
(the WebP lossless format, RFC 9649) with the subtract-green transform,
no color cache, no meta prefix codes and literals only (no backward
references): five prefix codes a frame, Huffman codes of the frame's own
histograms limited to 15 bits, each written as a normal code through the
19-symbol code-length code or, for one or two symbols, as a simple code
(a constant alpha costs no bit a pixel). Pixels are exact: the encoder
is lossless whatever the caller asked for (SaveAnimatedWEBP's
`lossless=False` writes VP8L too, where libwebp would write a smaller
lossy VP8 image).

VP8L writes bits LSB-first, while its canonical prefix codes are read
from their first bit on, so every code is written bit-reversed (as in
DEFLATE). The bit packing is vectorised (`_pack`): a frame of 480x480 is
~0.9 M fields; numpy releases the interpreter lock, so the frames encode
on a thread each, up to the cores.

`read_container` parses the container back (chunk sizes, canvas, loop,
each frame's offsets, size, duration and VP8L header) for checks that
have no decoder.
"""

from __future__ import annotations

import heapq
import itertools
import os
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np

MAX_CODE_LENGTH = 15
# the order in which the code-length code's lengths are written
CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
CODE_LENGTH_CODES = 19
MAX_CODE_LENGTH_LENGTH = 7
# green + the 24 length prefix codes (no color cache), red, blue, alpha,
# distance
ALPHABETS = (256 + 24, 256, 256, 256, 40)
VP8L_SIGNATURE = 0x2F
SUBTRACT_GREEN = 2
MAX_SIDE = 1 << 14  # VP8L's 14-bit sizes
ANMF_NO_BLEND = 0x02


# --- prefix codes ----------------------------------------------------------

def _huffman_lengths(counts: np.ndarray, limit: int) -> np.ndarray:
    """Code lengths of a complete Huffman code over the used symbols
    (count > 0), at most `limit` bits: counts are halved (kept above 0)
    until the tree fits. Needs two used symbols or more."""
    counts = counts.astype(np.int64)
    used = [int(s) for s in np.flatnonzero(counts)]
    while True:
        lengths = np.zeros(len(counts), np.int32)
        tie = itertools.count()
        heap = [(int(counts[s]), next(tie), [s]) for s in used]
        heapq.heapify(heap)
        while len(heap) > 1:
            c1, _, s1 = heapq.heappop(heap)
            c2, _, s2 = heapq.heappop(heap)
            for s in s1 + s2:
                lengths[s] += 1
            heapq.heappush(heap, (c1 + c2, next(tie), s1 + s2))
        if lengths.max() <= limit:
            return lengths
        counts = np.where(counts > 0, (counts + 1) // 2, 0)


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """The canonical code of each symbol (DEFLATE's assignment: shorter
    codes first, then by symbol), bit-reversed for LSB-first writing."""
    max_len = int(lengths.max())
    bl_count = np.bincount(lengths, minlength=max_len + 1)
    bl_count[0] = 0
    next_code = np.zeros(max_len + 1, np.int64)
    code = 0
    for bits in range(1, max_len + 1):
        code = (code + int(bl_count[bits - 1])) << 1
        next_code[bits] = code
    codes = np.zeros(len(lengths), np.int64)
    for symbol in np.flatnonzero(lengths):
        bits = int(lengths[symbol])
        value = int(next_code[bits])
        next_code[bits] += 1
        codes[symbol] = int(format(value, f"0{bits}b")[::-1], 2)
    return codes


class _Fields:
    """Bit fields in writing order: (value, bit count) pairs, LSB first."""

    def __init__(self) -> None:
        self.values: list[np.ndarray] = []
        self.nbits: list[np.ndarray] = []

    def put(self, value: int, nbits: int) -> None:
        self.values.append(np.array([value], np.uint16))
        self.nbits.append(np.array([nbits], np.uint8))

    def put_array(self, values: np.ndarray, nbits: np.ndarray) -> None:
        self.values.append(np.asarray(values, np.uint16).ravel())
        self.nbits.append(np.asarray(nbits, np.uint8).ravel())


def _pack(fields: _Fields) -> bytes:
    """Every field's bits, LSB first, one stream; zero-padded to a byte."""
    values = np.concatenate(fields.values)
    nbits = np.concatenate(fields.nbits)
    keep = nbits > 0
    values, nbits = values[keep], nbits[keep]
    columns = np.arange(int(nbits.max()), dtype=np.uint16)
    bits = ((values[:, None] >> columns) & 1).astype(np.uint8)
    return np.packbits(bits[columns[None, :] < nbits[:, None]], bitorder="little").tobytes()


def _write_code(fields: _Fields, counts: np.ndarray, alphabet: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """Write the prefix code of a histogram; returns (code, bit count)
    of each symbol. One or two used symbols below 256: a simple code
    (one symbol takes no bit, two take one each); otherwise a normal
    code, its lengths through the code-length code."""
    used = np.flatnonzero(counts)
    codes = np.zeros(alphabet, np.int64)
    lengths = np.zeros(alphabet, np.int32)
    if len(used) == 0:
        used = np.array([0])
    if len(used) <= 2 and used.max() < 256:
        fields.put(1, 1)  # simple code
        fields.put(len(used) - 1, 1)
        first_8bits = int(used[0] > 1)
        fields.put(first_8bits, 1)
        fields.put(int(used[0]), 8 if first_8bits else 1)
        if len(used) == 2:
            fields.put(int(used[1]), 8)
            codes[used[1]], lengths[used] = 1, 1
        return codes, lengths
    lengths = _huffman_lengths(counts, MAX_CODE_LENGTH)
    codes = _canonical_codes(lengths)
    # the code-length code over the lengths 0..15, written literally
    # (no repeat codes 16-18); two used lengths at least, so no length
    # is coded in zero bits
    cl_counts = np.bincount(lengths, minlength=CODE_LENGTH_CODES).astype(np.int64)
    if np.count_nonzero(cl_counts) < 2:
        cl_counts[0 if lengths[0] else 1] += 1
    cl_lengths = _huffman_lengths(cl_counts, MAX_CODE_LENGTH_LENGTH)
    cl_codes = _canonical_codes(cl_lengths)
    fields.put(0, 1)  # normal code
    fields.put(CODE_LENGTH_CODES - 4, 4)
    for symbol in CODE_LENGTH_ORDER:
        fields.put(int(cl_lengths[symbol]), 3)
    fields.put(0, 1)  # max_symbol = the alphabet
    fields.put_array(cl_codes[lengths], cl_lengths[lengths])
    return codes, lengths


# --- one frame -------------------------------------------------------------

def encode_vp8l(frame: np.ndarray) -> bytes:
    """One [H, W, 3 or 4] uint8 frame → a VP8L bitstream (the VP8L
    chunk's payload), lossless."""
    height, width, channels = frame.shape
    if not (0 < width <= MAX_SIDE and 0 < height <= MAX_SIDE) or channels not in (3, 4):
        raise ValueError(f"VP8L takes [H, W, 3|4] frames up to {MAX_SIDE} a side, got "
                         f"{frame.shape}")
    pixels = np.ascontiguousarray(frame, np.uint8).reshape(-1, channels)
    red, green, blue = pixels[:, 0], pixels[:, 1], pixels[:, 2]
    alpha = pixels[:, 3] if channels == 4 else np.full(len(pixels), 255, np.uint8)
    # the subtract-green transform: red and blue minus green, mod 256
    red = (red.astype(np.int16) - green).astype(np.uint8)
    blue = (blue.astype(np.int16) - green).astype(np.uint8)
    fields = _Fields()
    fields.put(VP8L_SIGNATURE, 8)
    fields.put(width - 1, 14)
    fields.put(height - 1, 14)
    fields.put(int(bool((alpha != 255).any())), 1)
    fields.put(0, 3)  # version
    fields.put(1, 1)  # a transform
    fields.put(SUBTRACT_GREEN, 2)
    fields.put(0, 1)  # no more transforms
    fields.put(0, 1)  # no color cache
    fields.put(0, 1)  # no meta prefix codes
    streams = (green, red, blue, alpha)
    tables = []
    for stream, alphabet in zip(streams, ALPHABETS):
        tables.append(_write_code(fields, np.bincount(stream, minlength=alphabet), alphabet))
    _write_code(fields, np.zeros(ALPHABETS[4], np.int64), ALPHABETS[4])  # distance: unused
    # every pixel a literal: green, red, blue, alpha
    fields.put_array(np.stack([codes[s] for s, (codes, _) in zip(streams, tables)], axis=1),
                     np.stack([lengths[s] for s, (_, lengths) in zip(streams, tables)], axis=1))
    return _pack(fields)


# --- the container ---------------------------------------------------------

def _chunk(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("<I", len(payload)) + payload + (b"\0" if len(payload) % 2 else b"")


def _u24(value: int) -> bytes:
    return int(value).to_bytes(3, "little")


def encode_animated_webp(frames: np.ndarray, duration_ms: int, loop: int = 0) -> bytes:
    """[N, H, W, 3 or 4] uint8 frames → an animated WEBP file, each frame
    shown `duration_ms` ms, looping `loop` times (0: forever)."""
    frames = np.asarray(frames)
    if frames.ndim != 4 or frames.dtype != np.uint8 or len(frames) == 0:
        raise ValueError(f"expected [N, H, W, C] uint8 frames, got {frames.dtype} "
                         f"{frames.shape}")
    _, height, width, channels = frames.shape
    has_alpha = channels == 4 and bool((frames[..., 3] != 255).any())
    vp8x = bytes([0x02 | (0x10 if has_alpha else 0)]) + b"\0\0\0" + _u24(width - 1) \
        + _u24(height - 1)
    body = [_chunk(b"VP8X", vp8x),
            _chunk(b"ANIM", struct.pack("<IH", 0, int(loop)))]
    header = (_u24(0) + _u24(0) + _u24(width - 1) + _u24(height - 1)
              + _u24(int(duration_ms)) + bytes([ANMF_NO_BLEND]))
    with ThreadPoolExecutor(max(1, min(len(frames), os.cpu_count() or 1))) as pool:
        for bitstream in pool.map(encode_vp8l, frames):
            body.append(_chunk(b"ANMF", header + _chunk(b"VP8L", bitstream)))
    payload = b"WEBP" + b"".join(body)
    return b"RIFF" + struct.pack("<I", len(payload)) + payload


def read_container(data: bytes) -> dict[str, Any]:
    """The container of an animated WEBP: {"riff_size", "file_size",
    "flags", "canvas": (w, h), "background", "loop", "frames": [{"x",
    "y", "size": (w, h), "duration", "flags", "vp8l_size",
    "vp8l_header": (w, h, alpha, version)}]}. Raises ValueError on a
    malformed container."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a RIFF WEBP file")
    riff_size = struct.unpack("<I", data[4:8])[0]
    out: dict[str, Any] = {"riff_size": riff_size, "file_size": len(data), "frames": []}
    pos = 12
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError(f"truncated chunk header at {pos}")
        tag, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        payload = data[pos + 8:pos + 8 + size]
        if len(payload) != size:
            raise ValueError(f"chunk {tag!r} at {pos} runs past the file")
        if tag == b"VP8X":
            out["flags"] = payload[0]
            out["canvas"] = (int.from_bytes(payload[4:7], "little") + 1,
                             int.from_bytes(payload[7:10], "little") + 1)
        elif tag == b"ANIM":
            out["background"], out["loop"] = struct.unpack("<IH", payload[:6])
        elif tag == b"ANMF":
            frame = {"x": 2 * int.from_bytes(payload[0:3], "little"),
                     "y": 2 * int.from_bytes(payload[3:6], "little"),
                     "size": (int.from_bytes(payload[6:9], "little") + 1,
                              int.from_bytes(payload[9:12], "little") + 1),
                     "duration": int.from_bytes(payload[12:15], "little"),
                     "flags": payload[15]}
            inner = payload[16:]
            if inner[:4] != b"VP8L":
                raise ValueError(f"frame {len(out['frames'])} holds {inner[:4]!r}, not VP8L")
            vp8l_size = struct.unpack("<I", inner[4:8])[0]
            bits = int.from_bytes(inner[9:13], "little")
            if inner[8] != VP8L_SIGNATURE:
                raise ValueError(f"frame {len(out['frames'])}: no VP8L signature")
            frame["vp8l_size"] = vp8l_size
            frame["vp8l_header"] = ((bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1,
                                    (bits >> 28) & 1, bits >> 29)
            out["frames"].append(frame)
        pos += 8 + size + (size % 2)
    return out
