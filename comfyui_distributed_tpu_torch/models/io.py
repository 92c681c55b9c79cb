"""Weights for the port's modules: the carry from a JAX parameter tree,
and a seeded random init where no checkpoint exists.

Submodules carry the flax module names, so a flattened flax path maps
onto a PyTorch parameter name by rule:

- "/" becomes "."; a leading "params/" collection is dropped;
- a Dense `kernel` [in, out] becomes `weight` [out, in];
- a Conv `kernel` HWIO becomes `weight` OIHW (a 3-D one THWIO becomes
  OITHW);
- a norm's `scale` and an Embed's `embedding` become `weight`;
- anything else (biases, position embeddings, the text projection)
  keeps its name and layout.

One rule carries every tree: the UNet, the VAE, the text encoders
(CLIP and T5, with its shared `rel_bias` table), the ControlNet, the
upscale model, the Flux MMDiT (its RMS `scale`s, and the Dense
kernels of the fused linear1/linear2), the SD3 MMDiT (its `pos_embed`
table), the WAN video DiT (its bare `modulation` tables), the causal
video VAE (its Conv3d kernels) and the CLIP-vision tower.

Real single-file SD checkpoints (.safetensors, .ckpt) load through
models/sd_checkpoint.py, whose key schedules name parameters by the same
rule.

`with_parameters` is the copy on write that LoRA merges, weight merges
and per-job adapter patches go through: a new module tree sharing every
untouched parameter with the one it came from, which stays as it is.
"""

from __future__ import annotations

import copy
import math
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from .layers import RMSNorm
from .video_vae import _RMSNormChannels


def _torch_name_and_value(path: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    parts = path.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    leaf = parts[-1]
    if leaf == "kernel":
        if value.ndim == 2:
            value = value.T
        elif value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        elif value.ndim == 5:
            value = value.transpose(4, 3, 0, 1, 2)
        else:
            raise ValueError(f"{path}: kernel of rank {value.ndim}")
        leaf = "weight"
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return ".".join(parts[:-1] + [leaf]), value


def from_jax_params(flat: dict[str, np.ndarray], module: nn.Module) -> dict[str, torch.Tensor]:
    """`module`'s state dict from the output of the JAX package's
    models/io.py::flatten_params (as numpy). Strict both ways: a JAX key
    that names no parameter, a parameter that no key fills, or a shape
    that disagrees raises ValueError."""
    expected = {name: tuple(p.shape) for name, p in module.state_dict().items()}
    state: dict[str, torch.Tensor] = {}
    seen: set[str] = set()
    problems: list[str] = []
    for path, value in flat.items():
        name, arr = _torch_name_and_value(path, np.asarray(value))
        if name not in expected:
            problems.append(f"unused JAX key {path} (as {name})")
            continue
        seen.add(name)
        if tuple(arr.shape) != expected[name]:
            problems.append(f"shape of {path}: {arr.shape} vs {expected[name]}")
        else:
            state[name] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    problems += [f"no JAX key fills {name}" for name in sorted(set(expected) - seen)]
    if problems:
        raise ValueError("JAX parameter carry mismatch: " + "; ".join(problems[:10]))
    return state


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter in place from `generator`, in registration
    order: Dense/Conv weights N(0, 1/fan_in), biases 0, norm and RMS-norm
    scales 1, embeddings N(0, 1/width), the position table N(0, 0.01^2),
    the SD3 MMDiT's learned position table N(0, 1/width), the text
    projection N(0, 1/width), the video DiT's modulation tables N(0,
    1/width) and the CLIP-vision class and position embeddings N(0,
    0.02^2), with the scales of the flax initialisers."""
    device = generator.device
    for name, param in module.named_parameters():
        owner = module.get_submodule(name.rpartition(".")[0])
        leaf = name.rpartition(".")[2]
        if leaf == "bias":
            param.zero_()
        elif isinstance(owner, (nn.GroupNorm, nn.LayerNorm, RMSNorm, _RMSNormChannels)):
            param.fill_(1.0)
        else:
            if isinstance(owner, (nn.Linear, nn.Conv2d, nn.Conv3d)):
                std = 1.0 / math.sqrt(param[0].numel())
            elif leaf in ("modulation", "head_modulation"):
                std = 1.0 / math.sqrt(param.shape[-1])
            elif leaf == "class_embedding" or (leaf == "position_embedding"
                                               and hasattr(owner, "class_embedding")):
                std = 0.02
            elif leaf == "position_embedding":
                std = 0.01
            elif leaf == "pos_embed":
                std = 1.0 / math.sqrt(param.shape[-1])
            else:  # token embedding table, text projection
                std = 1.0 / math.sqrt(param.shape[0] if leaf == "text_projection" else param.shape[1])
            draw = torch.randn(param.shape, generator=generator, device=device) * std
            param.copy_(draw)
    return module


def with_parameters(module: nn.Module, replaced: Mapping[str, torch.Tensor]) -> nn.Module:
    """A copy of `module` in which each parameter named in `replaced` is
    that tensor (a Parameter without grad); every other parameter and
    every module off the replaced parameters' paths is shared with
    `module` by reference. Only the modules on those paths are copied,
    shallowly (their parameter and submodule tables), so `module` and
    whoever holds it see no change."""
    copies: dict[str, nn.Module] = {}

    def copied(prefix: str) -> nn.Module:
        if prefix in copies:
            return copies[prefix]
        parent_prefix, _, name = prefix.rpartition(".")
        parent = copied(parent_prefix) if prefix else None
        source = parent._modules[name] if parent is not None else module
        new = copy.copy(source)
        new._parameters = dict(source._parameters)
        new._modules = dict(source._modules)
        if parent is not None:
            parent._modules[name] = new
        copies[prefix] = new
        return new

    root = copied("")
    for name, value in replaced.items():
        owner_path, _, leaf = name.rpartition(".")
        owner = copied(owner_path)
        old = owner._parameters.get(leaf)
        if old is None:
            raise KeyError(f"{type(module).__name__} has no parameter {name}")
        if tuple(value.shape) != tuple(old.shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)} replaces {tuple(old.shape)}")
        owner._parameters[leaf] = nn.Parameter(value.detach(), requires_grad=False)
    return root
