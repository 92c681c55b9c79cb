"""Audio workflow nodes: LoadAudio and SaveAudio.

The port's own copy of comfyui_distributed_tpu/graph/nodes_audio.py. The
AUDIO value is {"waveform": [B, C, S] float32, "sample_rate": int}, the
layout the collector's audio path (graph/nodes_distributed.py,
utils/audio_payload.py) and AudioBatchDivider speak; the waveform is a
tensor on the context's device, as LoadImage's image is.

LoadAudio reads a `.npz` holding `waveform` and `sample_rate`, or a PCM
WAV through the standard library's `wave` (8-, 16- or 32-bit samples
scaled by their type's largest value, as the JAX node does); SaveAudio
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
            dtype = {1: np.int8, 2: np.int16, 4: np.int32}[width]
            pcm = np.frombuffer(raw, dtype=dtype).astype(np.float32)
            pcm /= float(np.iinfo(dtype).max)
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
