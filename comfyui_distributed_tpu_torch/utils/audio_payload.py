"""Audio envelopes of the HTTP tier.

The port's own copy of comfyui_distributed_tpu/utils/audio_payload.py:
a waveform travels as the base64 of its raw float32 bytes beside its
shape, dtype and sample rate, under a size cap
(CDT_MAX_AUDIO_PAYLOAD_BYTES). The layout is [B, C, S] float32, samples
last: the collector concatenates participants' audio along the samples
axis (`combine_audio`).
"""

from __future__ import annotations

import base64
from typing import Any

import numpy as np

from .constants import MAX_AUDIO_PAYLOAD_BYTES
from .exceptions import DistributedError


def encode_audio_payload(waveform, sample_rate: int) -> dict[str, Any]:
    """A waveform (numpy, or a tensor on any device) → its envelope."""
    if hasattr(waveform, "detach"):
        waveform = waveform.detach().float().cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(waveform, dtype=np.float32))
    raw = arr.tobytes()
    if len(raw) > MAX_AUDIO_PAYLOAD_BYTES:
        raise DistributedError(
            f"audio payload {len(raw)} bytes exceeds cap {MAX_AUDIO_PAYLOAD_BYTES}")
    return {
        "data": base64.b64encode(raw).decode("ascii"),
        "shape": list(arr.shape),
        "dtype": "float32",
        "sample_rate": int(sample_rate),
    }


def decode_audio_payload(payload: dict[str, Any]) -> tuple[np.ndarray, int]:
    """An envelope from the network → (float32 waveform, sample rate);
    raises DistributedError on anything malformed."""
    if not isinstance(payload, dict):
        raise DistributedError("audio payload must be a dict")
    for key in ("data", "shape", "dtype", "sample_rate"):
        if key not in payload:
            raise DistributedError(f"audio payload missing '{key}'")
    if payload["dtype"] != "float32":
        raise DistributedError(f"unsupported audio dtype {payload['dtype']!r}")
    raw = base64.b64decode(payload["data"])
    if len(raw) > MAX_AUDIO_PAYLOAD_BYTES:
        raise DistributedError("audio payload exceeds size cap")
    shape = tuple(int(d) for d in payload["shape"])
    expected = int(np.prod(shape)) * 4 if shape else 0
    if expected != len(raw):
        raise DistributedError(
            f"audio payload size mismatch: shape {shape} wants {expected} bytes, got {len(raw)}")
    arr = np.frombuffer(raw, dtype=np.float32).reshape(shape).copy()
    return arr, int(payload["sample_rate"])


def combine_audio(payloads: list[tuple[np.ndarray, int]]) -> tuple[np.ndarray, int]:
    """Concatenate waveforms along the samples axis (the last); every
    part must share one sample rate."""
    if not payloads:
        raise DistributedError("no audio to combine")
    rates = {rate for _, rate in payloads}
    if len(rates) != 1:
        raise DistributedError(f"mismatched sample rates: {sorted(rates)}")
    return np.concatenate([arr for arr, _ in payloads], axis=-1), rates.pop()
