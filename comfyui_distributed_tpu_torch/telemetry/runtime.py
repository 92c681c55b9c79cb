"""Runtime health on the scrape: the card's memory and host RSS.

The port's own copy of comfyui_distributed_tpu/telemetry/runtime.py. A
latency regression means little without knowing whether the process ran
the card's memory to the edge, so a scrape-time collector puts the
runtime next to the protocol on `/distributed/metrics`:

- ``cdt_device_memory_bytes{device, stat}`` — per CUDA device, the
  caching allocator's counters under the JAX labels: ``bytes_in_use``
  (``torch.cuda.memory_allocated``), ``peak_bytes_in_use``
  (``max_memory_allocated``), ``bytes_reserved`` (``memory_reserved``)
  and ``bytes_limit`` (the card's total memory). The device label is
  ``gpu:<index>``, as a JAX device reads ``<platform>:<id>``. Only
  consulted once CUDA is initialised in this process: a scrape must
  never be what creates a context on the card, and a CPU process (the
  tests) reports no device.
- ``cdt_host_rss_bytes`` — the process's resident set, read from
  /proc/self/statm (psutil is not on the card's machine); the peak RSS
  of getrusage where /proc is absent.

The JAX package's compile and compilation-cache gauges (``cdt_jax_*``)
have no counterpart: nothing here is compiled by XLA.
`ensure_runtime_collectors()` binds the collector to the CURRENT global
registry (re-binding after a test reset).
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Any

from . import instruments
from .metrics import MetricsRegistry, get_metrics_registry

_bound_registry: MetricsRegistry | None = None
_bind_lock = threading.Lock()


def _host_rss_bytes() -> int | None:
    try:
        with open("/proc/self/statm", encoding="ascii") as fh:
            resident_pages = int(fh.read().split()[1])
        return resident_pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        try:
            import resource

            # ru_maxrss is KiB on Linux (peak, not current: close enough
            # for a fallback gauge)
            return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
        except Exception:  # noqa: BLE001 - no RSS source at all
            return None


def _device_memory() -> list[dict[str, Any]]:
    """Per-device memory stats, ONLY if CUDA is already initialised in
    this process (never create a context from a scrape)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return []
    out = []
    for index in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(index)
        out.append({
            "id": f"gpu:{index}",
            "kind": props.name,
            "platform": "gpu",
            "memory": {
                "bytes_in_use": torch.cuda.memory_allocated(index),
                "peak_bytes_in_use": torch.cuda.max_memory_allocated(index),
                "bytes_reserved": torch.cuda.memory_reserved(index),
                "bytes_limit": props.total_memory,
            },
        })
    return out


def collect_runtime_gauges() -> None:
    """Scrape-time collector body: refresh the host and device gauges."""
    rss = _host_rss_bytes()
    if rss is not None:
        instruments.host_rss_bytes().set(rss)
    gauge = instruments.device_memory_bytes()
    gauge.clear()  # a device that went away must not freeze a stale series
    for device in _device_memory():
        for stat, value in device["memory"].items():
            gauge.set(value, device=device["id"], stat=stat)


def runtime_snapshot() -> dict[str, Any]:
    """The same readings as a plain dict in the JAX package's shape
    (the fleet snapshot's memory block reads it): the compile tallies
    are zeros, nothing here is compiled by XLA."""
    out: dict[str, Any] = {"compiles": 0, "compile_time_s": 0.0, "cache_hits": 0,
                           "cache_misses": 0}
    rss = _host_rss_bytes()
    if rss is not None:
        out["host_rss_bytes"] = rss
    devices = _device_memory()
    if devices:
        out["devices"] = devices
    return out


def ensure_runtime_collectors() -> None:
    """Bind `collect_runtime_gauges` to the current global registry
    (idempotent per registry: a test reset re-binds on the next call)."""
    global _bound_registry
    registry = get_metrics_registry()
    with _bind_lock:
        if _bound_registry is registry:
            return
        registry.register_collector(collect_runtime_gauges)
        _bound_registry = registry
