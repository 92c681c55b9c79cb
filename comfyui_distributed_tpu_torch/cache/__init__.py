"""Content-addressed tile result cache (the port's own copy of
comfyui_distributed_tpu/cache/).

A tile's result is a pure function of its sampler inputs (the elastic
tier's canvases are bit-identical whoever computes a tile), so it can be
served again: `keys.py` canonicalizes the inputs into a content hash,
`store.py` holds the two-tier store (RAM LRU, CRC-checked disk), and
`integration.py` is the elastic master's probe, settle and populate.
"""

from .integration import JobCacheBinding, bind_job_cache, job_key_context, tile_keys_for
from .keys import (
    KEY_VERSION,
    JobKeyContext,
    adapter_fingerprint,
    bundle_fingerprint,
    cond_fingerprint,
    noise_identity,
    params_fingerprint,
    tile_key,
)
from .store import TileResultCache, get_tile_cache, set_tile_cache

__all__ = [
    "KEY_VERSION", "JobKeyContext", "adapter_fingerprint", "bundle_fingerprint",
    "cond_fingerprint", "noise_identity", "params_fingerprint", "tile_key",
    "JobCacheBinding", "bind_job_cache", "job_key_context", "tile_keys_for",
    "TileResultCache", "get_tile_cache", "set_tile_cache",
]
