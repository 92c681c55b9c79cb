"""Canonical cache keys for tile results.

The port's own copy of comfyui_distributed_tpu/cache/keys.py, in its own
key namespace (KEY_VERSION). A tile result is a pure function of (model
weights and patches, conditioning, tile pixels, tile noise, sampler
settings, adapter, geometry). The key changes whenever any input that
can change one output bit changes, and does NOT change on inputs that
cannot (job id, tenant, worker placement); tests/test_torch_tile_cache.py
holds both directions, field by field (docs/caching.md's golden rules).

Canonicalization, as in the JAX package:

- every field is serialized as `name=value\\n` into one blake2b-256
  stream, so adjacent values never collide by concatenation;
- arrays (numpy or torch, any device) contribute dtype + shape + C-order
  bytes: a dtype or shape change with identical bytes changes the key;
- floats serialize via `float.hex()`, exact;
- `KEY_VERSION` is the first field: a change to sampler numerics or to
  the serialization bumps it and cold-starts the cache.

Where the port differs, and why:

- the RNG field is the port's noise identity, not JAX key bits: a tile's
  noise is drawn from generators seeded by (seed, global tile index,
  stream) (ops/upscale.py::TileNoise), so the field names the scheme and
  the seed, and the tile index is a field of its own. Two jobs with the
  same seed and inputs share results;
- the weights field covers what the tile processor reads: the backbone's
  and the VAE's parameters (by name) and the bundle's sampling patches
  (FreeU, PAG, SAG, RescaleCFG, the parameterization and flow-shift
  overrides, ...), which the JAX package's params tree does not carry;
- the weights fingerprint is a digest over each parameter's own digest,
  and those are remembered per parameter object, so a module that shares
  parameters with one already seen (FreeU's view, the untouched weights
  of a LoRA or merge output) hashes only its new tensors. A remembered
  digest is recomputed when its parameter lives at another address or,
  where torch counts it, has been written in place since
  (`Tensor._version`; tensors made under inference mode do not count and
  rely on modules never being written in place, which the port's
  patches keep: they copy on write). `params_fingerprint(...,
  memo=False)` is the unremembered definition; they are byte-equal.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

KEY_VERSION = "torch-1"

_DIGEST_BYTES = 32


def _hasher():
    return hashlib.blake2b(digest_size=_DIGEST_BYTES)


def _feed(h, name: str, value: Any) -> None:
    """Append one named field to the hash stream."""
    h.update(name.encode("utf-8"))
    h.update(b"=")
    if isinstance(value, bool):
        h.update(b"true" if value else b"false")
    elif isinstance(value, int):
        h.update(str(value).encode("ascii"))
    elif isinstance(value, float):
        h.update(value.hex().encode("ascii"))
    elif isinstance(value, str):
        h.update(value.encode("utf-8"))
    elif isinstance(value, (bytes, memoryview)):
        h.update(value)
    elif value is None:
        h.update(b"none")
    else:
        raise TypeError(f"unsupported key field type for {name}: {type(value)}")
    h.update(b"\n")


def _feed_array(h, name: str, arr: Any) -> None:
    """dtype + shape + C-order bytes, read on the host. A torch tensor's
    bytes are read as they are (bf16 included, which numpy lacks), its
    dtype named as numpy names it, so a tensor and an array of the same
    dtype and bytes key alike."""
    if isinstance(arr, torch.Tensor):
        host = arr.detach().to("cpu").contiguous()
        _feed(h, name + ".dtype", str(host.dtype).removeprefix("torch."))
        _feed(h, name + ".shape", ",".join(str(d) for d in host.shape))
        _feed(h, name + ".data", memoryview(host.reshape(-1).view(torch.uint8).numpy()))
        return
    host = np.ascontiguousarray(np.asarray(arr))
    _feed(h, name + ".dtype", str(host.dtype))
    _feed(h, name + ".shape", ",".join(str(d) for d in host.shape))
    _feed(h, name + ".data", memoryview(host.reshape(-1).view(np.uint8)))


def _param_digest(param: torch.Tensor) -> str:
    h = _hasher()
    _feed_array(h, "leaf", param)
    return h.hexdigest()


# parameter → (address, write count, digest), held weakly by identity: a
# module copy that shares parameters (FreeU's view, a LoRA or merge
# output's untouched weights) finds their digests
_MEMO = WeakIdKeyDictionary()
_MEMO_LOCK = threading.Lock()


def _remembered_digest(param: torch.Tensor) -> str:
    """A parameter's digest, recomputed when it lives at another address
    or, where torch counts it, has been written in place since."""
    try:
        version = param._version
    except RuntimeError:  # an inference tensor: no write counter
        version = None
    stamp = (param.data_ptr(), version)
    with _MEMO_LOCK:
        cached = _MEMO.get(param)
    if cached is not None and cached[0] == stamp:
        return cached[1]
    digest = _param_digest(param)
    with _MEMO_LOCK:
        _MEMO[param] = (stamp, digest)
    return digest


def params_fingerprint(module: torch.nn.Module, memo: bool = True) -> str:
    """Hex digest over one module's parameters, by name (a rename with the
    same bytes changes it): each parameter's digest (dtype, shape, bytes)
    in order. Each digest is remembered per parameter object (see the
    module docstring) unless `memo` is False."""
    digest = _remembered_digest if memo else _param_digest
    h = _hasher()
    params = list(module.named_parameters())
    _feed(h, "type", type(module).__name__)
    _feed(h, "leaves", len(params))
    for name, param in params:
        _feed(h, "leaf:" + name, digest(param))
    return h.hexdigest()


# the bundle fields that patch how its backbone samples (models/pipeline.py)
_PATCH_FIELDS = ("pag", "sag", "cfg_rescale", "dual_cfg", "perp_neg",
                 "parameterization_override", "flow_shift_override", "slg")


def bundle_fingerprint(bundle: Any, memo: bool = True) -> str:
    """The weights field: the model name, its backbone's config (FreeU
    rides it), the sampling patches, and the backbone's and the VAE's
    parameters."""
    h = _hasher()
    _feed(h, "model", str(bundle.model_name))
    _feed(h, "config", repr(getattr(bundle.unet, "config", None)))
    for field in _PATCH_FIELDS:
        _feed(h, "patch:" + field, repr(getattr(bundle, field, None)))
    for part in ("unet", "vae"):
        module = getattr(bundle, part, None)
        _feed(h, part, params_fingerprint(module, memo) if module is not None else None)
    return h.hexdigest()


def _walk(h, label: str, obj: Any) -> None:
    """Feed a conditioning value: tensors, arrays, scalars, strings, and
    dataclasses, lists, tuples and dicts of them; a module by its
    parameters (a ControlNet on a hint)."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        _feed_array(h, label, obj)
    elif isinstance(obj, torch.nn.Module):
        _feed(h, label + ":module", type(obj).__name__ + ":" + params_fingerprint(obj))
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        _feed(h, label + ":type", type(obj).__name__)
        for field in dataclasses.fields(obj):
            _walk(h, f"{label}.{field.name}", getattr(obj, field.name))
    elif isinstance(obj, (list, tuple)):
        _feed(h, label + ":len", len(obj))
        for i, item in enumerate(obj):
            _walk(h, f"{label}[{i}]", item)
    elif isinstance(obj, dict):
        _feed(h, label + ":len", len(obj))
        for key in sorted(obj, key=str):
            _walk(h, f"{label}[{key!r}]", obj[key])
    elif isinstance(obj, (bool, int, float, str, bytes)) or obj is None:
        _feed(h, label, obj)
    elif isinstance(obj, (np.generic,)):
        _feed(h, label, obj.item())
    else:
        _feed(h, label, repr(obj))


def cond_fingerprint(pos: Any, neg: Any) -> str:
    """Fingerprint of the (prepped) positive and negative conditioning."""
    h = _hasher()
    for name, cond in (("pos", pos), ("neg", neg)):
        inner = _hasher()
        _walk(inner, name, cond)
        _feed(h, name, inner.hexdigest())
    return h.hexdigest()


def adapter_fingerprint(adapter: Any = None) -> str:
    """The adapter field: "" for the base model, else a digest of the
    resolved plan key (adapters/registry.py::adapter_plan_key)."""
    if not adapter:
        return ""
    h = _hasher()
    _walk(h, "plan", adapter)
    return h.hexdigest()


def noise_identity(noise: Any) -> str | None:
    """The RNG field for the port's tile noise: the scheme and its seed.
    None for noise of another kind (a caller's own function), which the
    key cannot name: no tile of such a job is cached."""
    from ..ops.upscale import FrameTileNoise, TileNoise

    if type(noise) is TileNoise:
        return f"TileNoise(seed={noise.seed})"
    if type(noise) is FrameTileNoise:
        return f"FrameTileNoise(seed={noise.seed}, frame={noise.frame_index})"
    return None


@dataclass(frozen=True)
class JobKeyContext:
    """The per-job part of the key, computed once at job start; tile_key
    adds the per-tile fields (index, position, pixels)."""

    weights_fp: str
    cond_fp: str
    base_key: str  # the noise identity (noise_identity)
    steps: int
    sampler: str
    scheduler: str
    cfg: float
    denoise: float
    adapter_fp: str = ""
    upscale_by: float = 1.0
    upscale_method: str = ""
    mask_blur: int = 0
    uniform: bool = False
    tiled_decode: bool = False
    tile_w: int = 0
    tile_h: int = 0
    padding: int = 0
    grid_w: int = 0
    grid_h: int = 0
    num_tiles: int = 0


def tile_key(ctx: JobKeyContext, tile_idx: int, tile: Any, y: int, x: int) -> str:
    """The content key of one tile's result. `tile` is the extracted
    (pre-sampling) tile exactly as fed to the processor; y, x its canvas
    position (they reach the sampler through the per-tile conditioning
    windows)."""
    h = _hasher()
    _feed(h, "v", KEY_VERSION)
    _feed(h, "weights", ctx.weights_fp)
    _feed(h, "cond", ctx.cond_fp)
    _feed(h, "base_key", ctx.base_key)
    _feed(h, "steps", ctx.steps)
    _feed(h, "sampler", ctx.sampler)
    _feed(h, "scheduler", ctx.scheduler)
    _feed(h, "cfg", float(ctx.cfg))
    _feed(h, "denoise", float(ctx.denoise))
    _feed(h, "adapter", ctx.adapter_fp)
    _feed(h, "upscale_by", float(ctx.upscale_by))
    _feed(h, "upscale_method", ctx.upscale_method)
    _feed(h, "mask_blur", int(ctx.mask_blur))
    _feed(h, "uniform", bool(ctx.uniform))
    _feed(h, "tiled_decode", bool(ctx.tiled_decode))
    _feed(h, "tile_w", int(ctx.tile_w))
    _feed(h, "tile_h", int(ctx.tile_h))
    _feed(h, "padding", int(ctx.padding))
    _feed(h, "grid_w", int(ctx.grid_w))
    _feed(h, "grid_h", int(ctx.grid_h))
    _feed(h, "num_tiles", int(ctx.num_tiles))
    _feed(h, "tile_idx", int(tile_idx))
    _feed(h, "y", int(y))
    _feed(h, "x", int(x))
    _feed_array(h, "pixels", tile)
    return h.hexdigest()
