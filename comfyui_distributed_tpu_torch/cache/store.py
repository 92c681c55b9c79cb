"""Two-tier content-addressed store for tile results.

The port's own copy of comfyui_distributed_tpu/cache/store.py. Tier 1 is
a bounded host-RAM LRU of the float arrays the master blends; tier 2 an
optional disk tier (CDT_CACHE_DIR) written with utils/fsio.py's atomic
write, a CRC32 over the pixel bytes checked on every read: a corrupt,
truncated or alien file is deleted and reads as a miss, so the cache can
fall back to recomputing but never places a wrong pixel.

Master-side only and thread-safe. Entries are immutable: `put` copies,
`get` returns a read-only array.
"""

from __future__ import annotations

import binascii
import contextlib
import json
import os
import struct
import threading
from collections import OrderedDict

import numpy as np

from ..utils import constants
from ..utils.fsio import atomic_write_bytes

_MAGIC = b"CDTC"
_HEADER_STRUCT = struct.Struct("<4sI")  # magic, header-json length


class TileResultCache:
    """Bounded RAM LRU + CRC-checked disk tier, keyed by content hash."""

    def __init__(
        self,
        ram_mb: float | None = None,
        disk_dir: str | None = None,
        disk_mb: float | None = None,
    ) -> None:
        if ram_mb is None:
            ram_mb = constants.CACHE_RAM_MB
        if disk_mb is None:
            disk_mb = constants.CACHE_DISK_MB
        self._lock = threading.Lock()
        self._ram: OrderedDict[str, np.ndarray] = OrderedDict()
        self._ram_bytes = 0
        self._ram_budget = max(0, int(ram_mb * 1024 * 1024))
        self._disk_dir = disk_dir
        self._disk_budget = max(0, int(disk_mb * 1024 * 1024))
        self._disk_bytes = 0
        self._hits_ram = 0
        self._hits_disk = 0
        self._misses = 0
        self._puts = 0
        self._evictions = 0
        self._corrupt = 0
        self._settled = 0
        # scrape-time delta marks of the mirrored counters
        # (telemetry/instruments.bind_server_collectors)
        self.scrape_mirrored: dict[str, int] = {}
        if self._disk_dir:
            os.makedirs(self._disk_dir, exist_ok=True)
            self._disk_bytes = self._scan_disk_bytes()

    # -- lookup / populate -------------------------------------------------

    def get(self, key: str) -> np.ndarray | None:
        """The cached result array, or None. RAM first, then disk (a
        disk hit is promoted into RAM)."""
        with self._lock:
            arr = self._ram.get(key)
            if arr is not None:
                self._ram.move_to_end(key)
                self._hits_ram += 1
                return arr
        arr = self._disk_read(key)
        with self._lock:
            if arr is not None:
                self._hits_disk += 1
                self._ram_insert(key, arr)
            else:
                self._misses += 1
        return arr

    def put(self, key: str, arr) -> None:
        """Populate both tiers. The stored copy is frozen so a hit can
        be blended without defensive copying."""
        host = np.ascontiguousarray(np.asarray(arr)).copy()
        host.setflags(write=False)
        with self._lock:
            self._puts += 1
            self._ram_insert(key, host)
        self._disk_write(key, host)

    def note_settled(self, n: int = 1) -> None:
        """Count tiles settled into a job straight from the cache."""
        with self._lock:
            self._settled += int(n)

    # -- RAM tier (call under self._lock) ----------------------------------

    def _ram_insert(self, key: str, arr: np.ndarray) -> None:
        if key in self._ram:
            self._ram.move_to_end(key)
            return
        size = arr.nbytes
        if size > self._ram_budget:
            return  # larger than the whole budget: disk-only
        self._ram[key] = arr
        self._ram_bytes += size
        while self._ram_bytes > self._ram_budget and self._ram:
            _, evicted = self._ram.popitem(last=False)
            self._ram_bytes -= evicted.nbytes
            self._evictions += 1

    # -- disk tier ---------------------------------------------------------

    def _disk_path(self, key: str) -> str:
        return os.path.join(self._disk_dir, key[:2], key + ".tile")

    def _disk_write(self, key: str, arr: np.ndarray) -> None:
        if not self._disk_dir:
            return
        body = arr.tobytes()
        header = json.dumps(
            {
                "dtype": str(arr.dtype),
                "shape": list(arr.shape),
                "crc": binascii.crc32(body) & 0xFFFFFFFF,
            }
        ).encode("utf-8")
        blob = _HEADER_STRUCT.pack(_MAGIC, len(header)) + header + body
        path = self._disk_path(key)
        try:
            existed = os.path.exists(path)
            atomic_write_bytes(path, blob)
        except OSError:
            return  # disk tier is best-effort; RAM tier already has it
        with self._lock:
            if not existed:
                self._disk_bytes += len(blob)
        self._disk_prune()

    def _disk_read(self, key: str) -> np.ndarray | None:
        if not self._disk_dir:
            return None
        path = self._disk_path(key)
        try:
            with open(path, "rb") as fh:
                blob = fh.read()
        except OSError:
            return None
        try:
            magic, header_len = _HEADER_STRUCT.unpack_from(blob, 0)
            if magic != _MAGIC:
                raise ValueError("bad magic")
            header_end = _HEADER_STRUCT.size + header_len
            header = json.loads(blob[_HEADER_STRUCT.size:header_end])
            body = blob[header_end:]
            if (binascii.crc32(body) & 0xFFFFFFFF) != int(header["crc"]):
                raise ValueError("crc mismatch")
            arr = np.frombuffer(body, dtype=np.dtype(header["dtype"]))
            arr = arr.reshape([int(d) for d in header["shape"]])
        except (ValueError, KeyError, TypeError, struct.error, json.JSONDecodeError):
            # Corrupt entry: delete it (a retry must not re-read the
            # same bad bytes) and report a miss — never a wrong canvas.
            with self._lock:
                self._corrupt += 1
                self._disk_bytes = max(0, self._disk_bytes - len(blob))
            with contextlib.suppress(OSError):
                os.unlink(path)
            return None
        arr.setflags(write=False)
        return arr

    def _disk_prune(self) -> None:
        """Prune oldest disk entries past the byte budget (0 = unbounded)."""
        if not self._disk_dir or not self._disk_budget:
            return
        with self._lock:
            over = self._disk_bytes > self._disk_budget
        if not over:
            return
        entries = []
        for sub in os.scandir(self._disk_dir):
            if not sub.is_dir():
                continue
            for ent in os.scandir(sub.path):
                if ent.is_file() and ent.name.endswith(".tile"):
                    st = ent.stat()
                    entries.append((st.st_mtime, st.st_size, ent.path))
        entries.sort()
        total = sum(size for _, size, _ in entries)
        for _, size, path in entries:
            if total <= self._disk_budget:
                break
            with contextlib.suppress(OSError):
                os.unlink(path)
            total -= size
            with self._lock:
                self._evictions += 1
        with self._lock:
            self._disk_bytes = total

    def _scan_disk_bytes(self) -> int:
        total = 0
        try:
            for sub in os.scandir(self._disk_dir):
                if not sub.is_dir():
                    continue
                for ent in os.scandir(sub.path):
                    if ent.is_file() and ent.name.endswith(".tile"):
                        total += ent.stat().st_size
        except OSError:
            return 0
        return total

    # -- management --------------------------------------------------------

    def clear(self) -> dict:
        """Drop both tiers; returns what was dropped (the answer of
        POST /distributed/cache/clear)."""
        with self._lock:
            dropped_entries = len(self._ram)
            dropped_bytes = self._ram_bytes
            self._ram.clear()
            self._ram_bytes = 0
        disk_entries = 0
        if self._disk_dir:
            for sub in list(os.scandir(self._disk_dir)):
                if not sub.is_dir():
                    continue
                for ent in list(os.scandir(sub.path)):
                    if ent.is_file() and ent.name.endswith(".tile"):
                        with contextlib.suppress(OSError):
                            dropped_bytes += ent.stat().st_size
                            os.unlink(ent.path)
                            disk_entries += 1
            with self._lock:
                self._disk_bytes = 0
        return {
            "dropped_entries": dropped_entries + disk_entries,
            "dropped_bytes": dropped_bytes,
        }

    def stats(self) -> dict:
        with self._lock:
            hits = self._hits_ram + self._hits_disk
            lookups = hits + self._misses
            return {
                "hits": hits,
                "hits_ram": self._hits_ram,
                "hits_disk": self._hits_disk,
                "misses": self._misses,
                "hit_rate": (hits / lookups) if lookups else 0.0,
                "puts": self._puts,
                "evictions": self._evictions,
                "corrupt": self._corrupt,
                "settled": self._settled,
                "ram_entries": len(self._ram),
                "ram_bytes": self._ram_bytes,
                "disk_bytes": self._disk_bytes if self._disk_dir else 0,
                "disk_tier": bool(self._disk_dir),
            }


# -- the process-global cache ------------------------------------------------

_tile_cache: TileResultCache | None = None
_cache_lock = threading.Lock()


def get_tile_cache() -> TileResultCache | None:
    """The process-global cache, or None when CDT_CACHE is off.

    Constructed lazily from the CDT_CACHE_* knobs on first enabled
    call; while disabled nothing is memoized, so tests can flip the
    env and reset freely.
    """
    global _tile_cache
    with _cache_lock:
        if _tile_cache is not None:
            return _tile_cache
        if not constants.cache_enabled():
            return None
        _tile_cache = TileResultCache(disk_dir=constants.cache_dir())
        return _tile_cache


def set_tile_cache(cache: TileResultCache | None) -> TileResultCache | None:
    """Install a cache instance (tests, the smoke run); returns the
    previous one so the caller can put it back."""
    global _tile_cache
    with _cache_lock:
        prev = _tile_cache
        _tile_cache = cache
        return prev


