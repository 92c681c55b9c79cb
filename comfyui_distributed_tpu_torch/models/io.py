"""Weights for the port's modules: the carry from a JAX parameter tree,
and a seeded random init where no checkpoint exists.

Submodules carry the flax module names, so a flattened flax path maps
onto a PyTorch parameter name by rule:

- "/" becomes "."; a leading "params/" collection is dropped;
- a Dense `kernel` [in, out] becomes `weight` [out, in];
- a Conv `kernel` HWIO becomes `weight` OIHW;
- a norm's `scale` and an Embed's `embedding` become `weight`;
- anything else (biases, position embeddings, the text projection)
  keeps its name and layout.

Reading real SD safetensors comes with a later slice.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


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
    order: Dense/Conv weights N(0, 1/fan_in), biases 0, norm scales 1,
    embeddings N(0, 1/width), the position table N(0, 0.01^2) and the
    text projection N(0, 1/width), with the scales of the flax
    initialisers."""
    device = generator.device
    for name, param in module.named_parameters():
        owner = module.get_submodule(name.rpartition(".")[0])
        leaf = name.rpartition(".")[2]
        if leaf == "bias":
            param.zero_()
        elif isinstance(owner, (nn.GroupNorm, nn.LayerNorm)):
            param.fill_(1.0)
        else:
            if isinstance(owner, (nn.Linear, nn.Conv2d)):
                std = 1.0 / math.sqrt(param[0].numel())
            elif leaf == "position_embedding":
                std = 0.01
            else:  # token embedding table, text projection
                std = 1.0 / math.sqrt(param.shape[0] if leaf == "text_projection" else param.shape[1])
            draw = torch.randn(param.shape, generator=generator, device=device) * std
            param.copy_(draw)
    return module
