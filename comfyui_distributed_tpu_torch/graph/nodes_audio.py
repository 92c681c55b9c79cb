"""Audio workflow nodes: LoadAudio and SaveAudio.

The port's own copy of comfyui_distributed_tpu/graph/nodes_audio.py. The
AUDIO value is {"waveform": [B, C, S] float32, "sample_rate": int}, the
layout the collector's audio path (graph/nodes_distributed.py,
utils/audio_payload.py) and AudioBatchDivider speak; the waveform is a
tensor on the context's device, as LoadImage's image is.

LoadAudio reads a `.npz` holding `waveform` and `sample_rate`, or a PCM
WAV through the standard library's `wave` (16- and 32-bit samples
scaled by their type's largest value, as the JAX node does; 8-bit ones
unsigned around 128 and 24-bit ones over 2^23, which the JAX node reads
as signed 8-bit and refuses); SaveAudio
writes `<filename_prefix>.npz` into the output directory.
"""

from __future__ import annotations

import os
import wave

import numpy as np
import torch

from ..utils import image as img_utils
from .io_dirs import get_output_dir, resolve_input_path
from .nodes_core import _device
from .registry import register_node


def _pcm_to_float(raw: bytes, width: int) -> np.ndarray:
    """PCM WAV sample bytes as float32: 8-bit samples are unsigned
    around 128, (u - 128) / 128; 24-bit ones little-endian three-byte
    signed ints over 2^23; 16- and 32-bit ones over their type's largest
    value, as the JAX node scales them."""
    if width == 1:
        return (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    if width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
        pcm = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        pcm = np.where(pcm >= 1 << 23, pcm - (1 << 24), pcm)
        return pcm.astype(np.float32) / float(1 << 23)
    dtype = {2: np.int16, 4: np.int32}.get(width)
    if dtype is None:
        raise ValueError(f"unsupported WAV sample width: {width} bytes")
    return np.frombuffer(raw, dtype=dtype).astype(np.float32) / float(np.iinfo(dtype).max)


@register_node
class LoadAudio:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"audio": ("STRING", {"default": ""})}}

    RETURN_TYPES = ("AUDIO",)
    FUNCTION = "load"
    NEVER_CACHE = True  # the file can change between runs

    def load(self, audio: str, context=None):
        path = resolve_input_path(str(audio), context)
        if path.endswith(".npz"):
            with np.load(path) as data:
                samples = np.asarray(data["waveform"], np.float32)
                rate = int(data["sample_rate"])
        else:
            with wave.open(path, "rb") as wf:
                rate = wf.getframerate()
                raw = wf.readframes(wf.getnframes())
                width = wf.getsampwidth()
                channels = wf.getnchannels()
            pcm = _pcm_to_float(raw, width)
            samples = pcm.reshape(-1, channels).T[None]  # [1, C, S]
        waveform = torch.from_numpy(np.ascontiguousarray(samples)).to(_device(context))
        return ({"waveform": waveform, "sample_rate": rate},)


@register_node
class SaveAudio:
    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "audio": ("AUDIO",),
                "filename_prefix": ("STRING", {"default": "audio"}),
            }
        }

    RETURN_TYPES = ()
    FUNCTION = "save"
    OUTPUT_NODE = True

    def save(self, audio: dict, filename_prefix="audio", context=None):
        out_dir = get_output_dir(context)
        os.makedirs(out_dir, exist_ok=True)
        name = f"{filename_prefix}.npz"
        np.savez(os.path.join(out_dir, name),
                 waveform=img_utils.ensure_numpy(audio["waveform"]),
                 sample_rate=audio["sample_rate"])
        return ({"ui": {"audio": [name]}, "audio": audio},)
