"""Master-side cache wiring for the elastic tier.

The port's own copy of comfyui_distributed_tpu/cache/integration.py: build
the job's JobKeyContext once, derive one key per tile, probe, settle the
hits into the job store (so workers never pull them) and blend the
cached pixels locally. Key derivation runs once per job, and only while
the cache is on: a disabled cache costs one None check.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from .keys import (
    JobKeyContext,
    adapter_fingerprint,
    bundle_fingerprint,
    cond_fingerprint,
    tile_key,
)
from .store import TileResultCache, get_tile_cache


def job_key_context(bundle: Any, pos: Any, neg: Any, base_key: str, grid: Any, *, steps: int,
                    sampler: str, scheduler: str, cfg: float, denoise: float,
                    upscale_by: float = 1.0, upscale_method: str = "", mask_blur: int = 0,
                    uniform: bool = False, tiled_decode: bool = False,
                    adapter: Any = None, weights_fp: str | None = None) -> JobKeyContext:
    """The per-job key context of a prepared tile run. `pos`/`neg` are
    the PREPPED conditionings (prep_cond_for_tiles), `bundle` the base
    bundle (an adapter enters through `adapter`, its resolved plan key),
    `base_key` the noise identity (keys.noise_identity); `weights_fp`,
    where given, is bundle_fingerprint(bundle) computed already."""
    return JobKeyContext(
        weights_fp=weights_fp if weights_fp is not None else bundle_fingerprint(bundle),
        cond_fp=cond_fingerprint(pos, neg),
        base_key=str(base_key),
        steps=int(steps), sampler=str(sampler), scheduler=str(scheduler), cfg=float(cfg),
        denoise=float(denoise), adapter_fp=adapter_fingerprint(adapter),
        upscale_by=float(upscale_by), upscale_method=str(upscale_method),
        mask_blur=int(mask_blur), uniform=bool(uniform), tiled_decode=bool(tiled_decode),
        tile_w=int(grid.tile_w), tile_h=int(grid.tile_h), padding=int(grid.padding),
        grid_w=int(grid.cols), grid_h=int(grid.rows), num_tiles=int(grid.num_tiles),
    )


def tile_keys_for(ctx: JobKeyContext, extracted: Any, grid: Any) -> list[str]:
    """One key per tile index; `extracted` is the prepared tile stack
    [T, B, th, tw, C], read to the host once here."""
    host = extracted.detach().to("cpu") if isinstance(extracted, torch.Tensor) \
        else np.asarray(extracted)
    return [tile_key(ctx, idx, host[idx], *grid.positions[idx])
            for idx in range(grid.num_tiles)]


class JobCacheBinding:
    """One master run's view of the cache: `probe()` collects the hits
    (tile index → frozen host array), which the caller settles in the
    store and blends; `populate(tile_idx, arr)` writes a computed tile
    back, unless the cache served it."""

    def __init__(self, cache: TileResultCache, keys: list[str]) -> None:
        self.cache = cache
        self.keys = keys
        self.hits: dict[int, np.ndarray] = {}

    def probe(self) -> dict[int, np.ndarray]:
        for idx, key in enumerate(self.keys):
            arr = self.cache.get(key)
            if arr is not None:
                self.hits[idx] = arr
        return self.hits

    def populate(self, tile_idx: int, arr: Any) -> None:
        if tile_idx in self.hits:
            return
        if 0 <= tile_idx < len(self.keys):
            self.cache.put(self.keys[tile_idx], arr)


def bind_job_cache(build_keys: Callable[[], list[str]]) -> JobCacheBinding | None:
    """A JobCacheBinding when a cache is on (CDT_CACHE=1, or one
    installed with set_tile_cache), else None; `build_keys` runs only
    then."""
    cache = get_tile_cache()
    if cache is None:
        return None
    return JobCacheBinding(cache, build_keys())


