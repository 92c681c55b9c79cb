"""LoRA files and their merge into the port's modules.

The port's own copy of comfyui_distributed_tpu/models/lora.py. The
kohya safetensors layout

    lora_unet_<sd key with underscores>.lora_down.weight  [r, I]
    lora_unet_<...>.lora_up.weight                        [O, r]
    lora_unet_<...>.alpha                                 scalar
    lora_te_* (SD1.x) / lora_te1_* + lora_te2_* (SDXL)    (text towers)

maps onto the parameters the checkpoint schedules fill
(models/sd_checkpoint.py), so there is one naming source: a backbone
module's kohya name is its schedule's sd key with dots made underscores,
and the text towers' names come from the HF-layout text_encoder_schedule
(kohya names BOTH of SDXL's towers in the HF layout, though the file
stores the second in OpenCLIP's; open_clip_schedule fuses q, k and v, so
it cannot name them).

The merge: W' = W + strength * up @ ((alpha / rank) * down), in f32, cast
back to W's dtype, by the adapter plane's patch
(adapters/segmented.py::apply_segment_delta), so LoraLoader and a
request's adapters share one merge. A torch Linear weight is [O, I], so the delta is
up @ down as it stands (the flax kernel is [I, O]: down.T @ up.T there).
A 1x1-conv LoRA ([r, I, 1, 1], [O, r, 1, 1]) is squeezed to 2-D; every
target of the port's schedules is a 2-D weight (the SD1.x transformers'
proj_in/proj_out are Dense layers here, loaded from 1x1 convs).
Merging never touches the modules it is given: each patched module is a
copy sharing every untouched parameter (models/io.py::with_parameters).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from .sd_checkpoint import (
    _LINEAR,
    _LINEAR_NOBIAS,
    _PROJ,
    SafetensorsFile,
    flux_schedule,
    text_encoder_schedule,
    unet_schedule,
)

_TARGET_KINDS = (_LINEAR, _LINEAR_NOBIAS, _PROJ)


def _te_targets(cfg, kohya_prefix: str, part: str) -> dict[str, tuple[str, str]]:
    """Kohya names of one CLIP text tower (HF layout, whatever the file's)."""
    targets = {}
    for sd, pt, kind in text_encoder_schedule(cfg, prefix="text_model"):
        if kind in _TARGET_KINDS:
            targets[f"{kohya_prefix}_" + sd.replace(".", "_")] = (part, f"{pt}.weight")
    return targets


def lora_target_map(unet_cfg, te_cfg=None, te2_cfg=None) -> dict[str, tuple[str, str]]:
    """{kohya module name: (part, parameter name)} for every weight a
    LoRA can target. ValueError for a backbone other than the UNet and
    Flux's MMDiT (SD3, video)."""
    from .mmdit import MMDiTConfig
    from .unet import UNetConfig

    targets: dict[str, tuple[str, str]] = {}
    if isinstance(unet_cfg, MMDiTConfig):
        # Flux: bare transformer keys; the kohya Flux trainers leave the
        # T5 (te) alone and name the CLIP tower (te2) lora_te1
        for sd, pt, kind in flux_schedule(unet_cfg):
            if kind in _TARGET_KINDS:
                targets["lora_unet_" + sd.replace(".", "_")] = ("unet", f"{pt}.weight")
        if te2_cfg is not None:
            targets.update(_te_targets(te2_cfg, "lora_te1", "te2"))
        return targets
    if not isinstance(unet_cfg, UNetConfig):
        raise ValueError("LoRA merging is only supported for UNet- and MMDiT-family models "
                         f"(got config {type(unet_cfg).__name__})")
    prefix = "model.diffusion_model."
    for sd, pt, kind in unet_schedule(unet_cfg):
        if kind in _TARGET_KINDS and sd.startswith(prefix):
            targets["lora_unet_" + sd[len(prefix):].replace(".", "_")] = ("unet", f"{pt}.weight")
    if te_cfg is not None:
        # SD1.x tools write lora_te_*, SDXL tools lora_te1_* for CLIP-L
        targets.update(_te_targets(te_cfg, "lora_te", "te"))
        targets.update(_te_targets(te_cfg, "lora_te1", "te"))
    if te2_cfg is not None:
        targets.update(_te_targets(te2_cfg, "lora_te2", "te2"))
    return targets


def read_lora(path: str) -> dict[str, np.ndarray]:
    """A .safetensors LoRA → {key: numpy array} (bf16 tensors as f32:
    numpy has no bf16), read with the port's own reader."""
    reader = SafetensorsFile(path)
    try:
        out = {}
        for key in reader:
            t = reader[key]
            if t.dtype == torch.bfloat16:
                t = t.float()
            out[key] = t.numpy().copy()
        return out
    finally:
        reader.close()


def parse_lora(state_dict: dict[str, Any]) -> dict[str, dict]:
    """Flat LoRA keys → {module: {down, up, alpha}}."""
    modules: dict[str, dict] = {}
    for key, value in state_dict.items():
        if key.endswith(".lora_down.weight"):
            modules.setdefault(key[: -len(".lora_down.weight")], {})["down"] = value
        elif key.endswith(".lora_up.weight"):
            modules.setdefault(key[: -len(".lora_up.weight")], {})["up"] = value
        elif key.endswith(".alpha"):
            modules.setdefault(key[: -len(".alpha")], {})["alpha"] = float(np.asarray(value))
    return modules


def lora_pair(payload: dict) -> tuple[np.ndarray, np.ndarray, float]:
    """(down [r, I], up [O, r], alpha / rank) of one parsed module, f32,
    a 1x1-conv pair squeezed to 2-D."""
    down = np.asarray(payload["down"], np.float32)
    up = np.asarray(payload["up"], np.float32)
    if down.ndim == 4:
        down = down[:, :, 0, 0]
        up = up[:, :, 0, 0]
    rank = down.shape[0]
    return down, up, float(payload.get("alpha", rank)) / rank


@torch.no_grad()
def apply_lora(
    modules_by_part: dict[str, nn.Module],
    lora_sd: dict[str, Any],
    unet_cfg,
    te_cfg=None,
    te2_cfg=None,
    strength: float = 1.0,
    te_strength: float | None = None,
) -> tuple[dict[str, nn.Module], list[str]]:
    """Merge a LoRA into {'unet': module, 'te': module[, 'te2': module]}.

    Returns (modules, unmatched module names). Unmatched modules are
    reported, not fatal (unet-only and te-only LoRAs are normal). A part
    no module of the file touches comes back as the same object; a
    patched part is a copy whose targeted weights are new tensors on the
    same device, every other parameter shared."""
    from ..adapters.segmented import apply_segment_delta

    te_strength = strength if te_strength is None else te_strength
    targets = lora_target_map(unet_cfg, te_cfg, te2_cfg)
    shapes = {part: {name: tuple(p.shape) for name, p in module.named_parameters()}
              for part, module in modules_by_part.items()}
    operands: dict[str, tuple[list, list, list]] = {part: ([], [], []) for part in modules_by_part}
    unmatched: list[str] = []
    for name, payload in parse_lora(lora_sd).items():
        target = targets.get(name)
        if target is None or "down" not in payload or "up" not in payload:
            unmatched.append(name)
            continue
        part, pname = target
        shape = shapes.get(part, {}).get(pname)
        if shape is None:
            unmatched.append(name)
            continue
        down, up, scale = lora_pair(payload)
        if (up.shape[0], down.shape[1]) != shape or up.shape[1] != down.shape[0]:
            unmatched.append(name)
            continue
        paths, downs, ups = operands[part]
        paths.append(f"{part}/{pname}")
        downs.append(scale * down)
        ups.append(up)
    merged: dict[str, nn.Module] = {}
    for part, module in modules_by_part.items():
        paths, downs, ups = operands[part]
        merged.update(apply_segment_delta({part: module}, paths, downs, ups,
                                          strength if part == "unet" else te_strength))
    return merged, unmatched
