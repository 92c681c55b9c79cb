"""Adapter operands and the whole-grant weight patch.

The port's own copy of the whole-grant half of comfyui_distributed_tpu/
adapters/segmented.py. A resolved adapter becomes per-target operands:
for every backbone weight W the adapter covers, a pair `down` [r_b, I]
(with the kohya alpha/rank folded in) and `up` [O, r_b], zero-padded to
a rank bucket (CDT_ADAPTER_RANK_BUCKETS). Zero padding is exact: a
padded rank row adds 0. Where the JAX package lays operands over the
WHOLE target map (zeros for the weights the adapter leaves alone, the
fixed layout its per-slot step batches over), the port keeps the covered
weights only: W + 0 is W, so the patch is the same, and an adapter that
covers a few weights costs their operands and their copies, not the
whole backbone's. The per-slot application of the cross-job tier
(`make_adapter_step`, `adapter_signature`) is not ported yet
(ROADMAP.md, Queue 1 item 4b); it brings the fixed layout with it.

`patch_params` applies them to every tile of a job at once (the elastic
tier, where a job wears one plan): W ← (W_f32 + scale · up @ down) cast
to W's dtype (`apply_segment_delta`, which LoraLoader's merge uses too:
models/lora.py), into a copy of the backbone that shares every other
parameter; the bundle it came from is left as it is.

The backbone (`unet` part) only: text-encoder conditioning is computed
before the tile loop, so `lora_te*` modules are skipped here and stay
the merging loader's (LoraLoader).

Operand paths are "unet/<parameter name>"; shapes are (I, O), the JAX
package's kernel order, so down and up have the JAX package's shapes.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple

import numpy as np
import torch

from .registry import AdapterError

_DEFAULT_RANK_BUCKETS = "4,8,16,32,64"


def rank_buckets() -> tuple[int, ...]:
    """The bounded rank-bucket set (CDT_ADAPTER_RANK_BUCKETS)."""
    raw = os.environ.get("CDT_ADAPTER_RANK_BUCKETS", _DEFAULT_RANK_BUCKETS)
    try:
        vals = sorted({int(v) for v in raw.split(",") if v.strip()})
    except ValueError as exc:
        raise AdapterError(
            f"CDT_ADAPTER_RANK_BUCKETS must be comma-separated ints: {raw!r}") from exc
    if not vals or vals[0] <= 0:
        raise AdapterError(f"CDT_ADAPTER_RANK_BUCKETS must be positive ints: {raw!r}")
    return tuple(vals)


def rank_bucket_for(rank: int, buckets: tuple[int, ...] | None = None) -> int:
    """The smallest bucket >= rank; AdapterError past the largest."""
    buckets = rank_buckets() if buckets is None else buckets
    for b in buckets:
        if rank <= b:
            return b
    raise AdapterError(f"adapter rank {rank} exceeds the largest rank bucket {buckets[-1]} "
                       "(CDT_ADAPTER_RANK_BUCKETS)")


class SegmentOperands(NamedTuple):
    """One resolved plan's operands: `paths`, `downs` and `ups` aligned,
    paths sorted, the covered weights only; `scale` is the strength the
    patch multiplies by (1.0 where compose_operands folded strengths
    in)."""

    paths: tuple[str, ...]
    downs: tuple[np.ndarray, ...]  # each [rank_bucket, I], float32
    ups: tuple[np.ndarray, ...]  # each [O, rank_bucket], float32
    scale: float
    rank_bucket: int
    nbytes: int
    fingerprint: str


def bundle_target_map(bundle: Any) -> dict[str, tuple[str, tuple[int, int]]]:
    """{kohya module name: ("unet/<parameter>", (I, O))} for every 2-D
    backbone weight of `bundle` a LoRA can target (models/lora.py's map,
    the backbone part)."""
    from ..models.lora import lora_target_map
    from ..models.registry import get_config

    try:
        targets = lora_target_map(get_config(bundle.model_name))
    except ValueError as exc:
        raise AdapterError(str(exc)) from exc
    params = dict(bundle.unet.named_parameters()) if bundle.unet is not None else {}
    out: dict[str, tuple[str, tuple[int, int]]] = {}
    for name in sorted(targets):
        part, pname = targets[name]
        weight = params.get(pname)
        if part != "unet" or weight is None or weight.ndim != 2:
            continue
        out[name] = (f"unet/{pname}", (int(weight.shape[1]), int(weight.shape[0])))
    return out


def _operands(paths, downs, ups, bucket: int, fingerprint: str) -> SegmentOperands:
    nbytes = sum(a.nbytes for a in downs) + sum(a.nbytes for a in ups)
    return SegmentOperands(paths=tuple(paths), downs=tuple(downs), ups=tuple(ups), scale=1.0,
                           rank_bucket=int(bucket), nbytes=int(nbytes),
                           fingerprint=str(fingerprint))


def build_operands(state_dict: dict[str, Any], target_map: dict, bucket: int | None = None,
                   *, fingerprint: str = "") -> SegmentOperands:
    """One kohya state dict → rank-bucketed operands for the weights of
    `target_map` it covers. Modules outside it (lora_te*, unknown names,
    shape mismatches) are skipped and counted in a debug line."""
    from ..models.lora import lora_pair, parse_lora
    from ..utils.logging import debug_log

    modules = parse_lora(state_dict)
    per_path: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    skipped: list[str] = []
    max_rank = 0
    for name in sorted(modules):
        payload = modules[name]
        target = target_map.get(name)
        if target is None or "down" not in payload or "up" not in payload:
            skipped.append(name)
            continue
        path, (dim_in, dim_out) = target
        down, up, scale = lora_pair(payload)
        rank = int(down.shape[0])
        if down.ndim != 2 or up.ndim != 2 or down.shape[1] != dim_in \
                or up.shape != (dim_out, rank):
            skipped.append(name)
            continue
        per_path[path] = (scale * down, up)
        max_rank = max(max_rank, rank)
    if skipped:
        debug_log(f"adapter operands: skipped {len(skipped)} non-backbone/mismatched "
                  f"module(s) (first: {skipped[0]})")
    if bucket is None:
        bucket = rank_bucket_for(max(1, max_rank))
    elif max_rank > bucket:
        raise AdapterError(f"adapter rank {max_rank} exceeds requested bucket {bucket}")
    paths = sorted(per_path)
    downs, ups = [], []
    for path in paths:
        down, up = per_path[path]
        padded_down = np.zeros((bucket, down.shape[1]), np.float32)
        padded_up = np.zeros((up.shape[0], bucket), np.float32)
        padded_down[:down.shape[0]] = down
        padded_up[:, :up.shape[1]] = up
        downs.append(padded_down)
        ups.append(padded_up)
    return _operands(paths, downs, ups, bucket, fingerprint)


def compose_operands(parts: list[SegmentOperands], strengths: list[float]) -> SegmentOperands:
    """Stack adapters into ONE pair per path: concatenate along the rank
    with each adapter's strength folded into its down slice,
    up_cat @ down_cat == Σ s_i up_i @ down_i; the concat re-buckets to
    cover the summed rank. A path one adapter leaves alone takes zeros
    in its slice."""
    if not parts:
        raise AdapterError("compose_operands needs at least one adapter")
    if len(parts) != len(strengths):
        raise AdapterError("compose_operands: strengths/parts length mismatch")
    shapes: dict[str, tuple[int, int]] = {}
    pairs = [dict(zip(ops.paths, zip(ops.downs, ops.ups))) for ops in parts]
    for by_path in pairs:
        for path, (down, up) in by_path.items():
            if shapes.setdefault(path, (down.shape[1], up.shape[0])) != \
                    (down.shape[1], up.shape[0]):
                raise AdapterError(
                    "compose_operands: adapters were built against different target maps")
    bucket = rank_bucket_for(sum(ops.rank_bucket for ops in parts))
    paths = sorted(shapes)
    downs, ups = [], []
    for path in paths:
        dim_in, dim_out = shapes[path]
        down_parts, up_parts = [], []
        for ops, by_path, s in zip(parts, pairs, strengths):
            pair = by_path.get(path)
            if pair is None:
                down_parts.append(np.zeros((ops.rank_bucket, dim_in), np.float32))
                up_parts.append(np.zeros((dim_out, ops.rank_bucket), np.float32))
            else:
                down_parts.append(float(s) * pair[0])
                up_parts.append(pair[1])
        down = np.concatenate(down_parts, axis=0)
        up = np.concatenate(up_parts, axis=1)
        pad = bucket - down.shape[0]
        if pad:
            down = np.concatenate([down, np.zeros((pad, dim_in), np.float32)], axis=0)
            up = np.concatenate([up, np.zeros((dim_out, pad), np.float32)], axis=1)
        downs.append(np.ascontiguousarray(down, np.float32))
        ups.append(np.ascontiguousarray(up, np.float32))
    return _operands(paths, downs, ups, bucket, "+".join(ops.fingerprint for ops in parts))


@torch.no_grad()
def apply_segment_delta(modules: dict[str, torch.nn.Module], paths, downs, ups,
                        scale: float) -> dict[str, torch.nn.Module]:
    """{part: module} → {part: module} with W ← (W_f32 + scale · up @
    down) cast to W's dtype on each path's weight ("<part>/<parameter>");
    the product runs in f32 on the weight's device. A path named twice
    adds to the first patch's result. Copy on write: a module no path
    names comes back as it is."""
    from ..models.io import with_parameters

    params = {part: dict(module.named_parameters()) for part, module in modules.items()}
    replaced: dict[str, dict[str, torch.Tensor]] = {part: {} for part in modules}
    for path, down, up in zip(paths, downs, ups):
        part, _, name = path.partition("/")
        weight = replaced[part].get(name, params[part][name])
        delta = torch.matmul(torch.as_tensor(up).to(weight.device),
                             torch.as_tensor(down).to(weight.device))  # [O, I]
        replaced[part][name] = (weight.float() + float(scale) * delta).to(weight.dtype)
    return {part: with_parameters(module, replaced[part]) if replaced[part] else module
            for part, module in modules.items()}


def patch_params(bundle: Any, operands: SegmentOperands, scale: float | None = None):
    """The whole-grant patch: `bundle` with its backbone patched by the
    operands (a new bundle; `bundle` is left as it is). Every tile of the
    job samples with it through the unchanged tile processor."""
    import dataclasses

    s = float(operands.scale if scale is None else scale)
    patched = apply_segment_delta({"unet": bundle.unet}, operands.paths, operands.downs,
                                  operands.ups, s)
    return dataclasses.replace(bundle, unet=patched["unet"])
