"""The host-side adapter operand cache.

The port's own copy of comfyui_distributed_tpu/adapters/cache.py.
Decoding a kohya file and laying out rank-bucketed operands is host work
worth redoing once per adapter, not once per job: this LRU holds
`SegmentOperands` per (content hash, target map, rank-bucket set) under a
byte budget (CDT_ADAPTER_CACHE_MB), counting hits, misses and
evictions, in its stats and in the ``cdt_adapter_cache_*`` metrics.
`adapter_admission_cost` is the scheduler's seam into it: a request
whose adapters are not all resident pays CDT_ADAPTER_COLD_COST at DRR
admission.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable

from .registry import AdapterError, AdapterSpec, get_adapter_catalog
from .segmented import SegmentOperands, build_operands, compose_operands, rank_buckets


def _metrics():
    from ..telemetry.instruments import (
        adapter_cache_bytes,
        adapter_cache_evictions_total,
        adapter_cache_lookups_total,
    )

    return adapter_cache_lookups_total(), adapter_cache_evictions_total(), adapter_cache_bytes()


class AdapterOperandCache:
    """Byte-budgeted LRU: key → SegmentOperands. Keys carry the content
    hash, the target paths and the bucket set, so a changed file or knob
    never serves stale operands."""

    def __init__(self, budget_bytes: int | None = None) -> None:
        if budget_bytes is None:
            from ..utils.constants import adapter_cache_mb

            budget_bytes = int(adapter_cache_mb() * 1024 * 1024)
        self.budget_bytes = max(0, int(budget_bytes))
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple, SegmentOperands] = OrderedDict()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _evict_until_fits(self) -> None:
        while self.bytes > self.budget_bytes and len(self._entries) > 1:
            _, ops = self._entries.popitem(last=False)
            self.bytes -= ops.nbytes
            self.evictions += 1
            _metrics()[1].inc()

    def get_or_build(self, key: tuple,
                     build: Callable[[], SegmentOperands]) -> tuple[SegmentOperands, bool]:
        """(operands, was_hit). `build` runs outside the lock; a
        racing build of the same key keeps the entry inserted first. An
        entry larger than the whole budget is returned and not kept."""
        with self._lock:
            cached = self._entries.get(key)
            if cached is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                _metrics()[0].inc(outcome="hit")
                return cached, True
        ops = build()
        lookups, _, bytes_gauge = _metrics()
        with self._lock:
            raced = self._entries.get(key)
            if raced is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                lookups.inc(outcome="hit")
                return raced, True
            self.misses += 1
            lookups.inc(outcome="miss")
            if ops.nbytes <= self.budget_bytes:
                self._entries[key] = ops
                self.bytes += ops.nbytes
                self._evict_until_fits()
            bytes_gauge.set(float(self.bytes))
        return ops, False

    def contains_hash(self, content_hash: str) -> bool:
        """Whether operands of the adapter with this content hash are
        resident (under any target map or bucket set)."""
        with self._lock:
            return any(key[1] == content_hash for key in self._entries)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {"entries": len(self._entries), "bytes": int(self.bytes),
                    "budget_bytes": int(self.budget_bytes), "hits": int(self.hits),
                    "misses": int(self.misses), "evictions": int(self.evictions)}


_CACHE: AdapterOperandCache | None = None
_CACHE_LOCK = threading.Lock()


def get_adapter_cache() -> AdapterOperandCache:
    global _CACHE
    with _CACHE_LOCK:
        if _CACHE is None:
            _CACHE = AdapterOperandCache()
        return _CACHE


def operands_for_plan(specs: list[AdapterSpec], target_map: dict, *, catalog: Any = None,
                      cache: AdapterOperandCache | None = None) -> SegmentOperands:
    """A resolved plan → its operands, through the cache. Each adapter's
    operands are cached by (hash, target paths, bucket set), whatever its
    strength; one adapter rides its strength as the scale, a stack folds
    the strengths in (compose_operands)."""
    if not specs:
        raise AdapterError("operands_for_plan: empty plan")
    catalog = catalog or get_adapter_catalog()
    cache = cache or get_adapter_cache()
    buckets = rank_buckets()
    paths = tuple(sorted(path for path, _ in target_map.values()))
    parts: list[SegmentOperands] = []
    for spec in specs:
        if not spec.content_hash:
            raise AdapterError(f"adapter {spec.name!r} has no content hash (unresolved plan)")
        ops, _ = cache.get_or_build(
            ("one", spec.content_hash, paths, buckets),
            lambda spec=spec: build_operands(catalog.load_state_dict(spec.name), target_map,
                                             fingerprint=spec.content_hash))
        parts.append(ops)
    if len(parts) == 1:
        return parts[0]._replace(scale=float(specs[0].strength))
    return compose_operands(parts, [float(s.strength) for s in specs])


def adapter_admission_cost(hashes: Any) -> float:
    """DRR admission multiplier for a plan's content hashes: 1.0 when the
    knob is off, the plan is empty or every adapter's operands are
    resident; CDT_ADAPTER_COLD_COST otherwise. Advisory: an error here
    never blocks admission."""
    try:
        hashes = tuple(hashes or ())
        if not hashes:
            return 1.0
        from ..utils.constants import adapter_cold_cost

        cost = float(adapter_cold_cost())
        if cost == 1.0:
            return 1.0
        cache = get_adapter_cache()
        if all(cache.contains_hash(h) for h in hashes):
            return 1.0
        return cost
    except Exception:  # noqa: BLE001 - advisory seam
        return 1.0
