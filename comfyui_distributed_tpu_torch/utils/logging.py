"""Logging with a hot-reloadable debug flag.

The port's own copy of comfyui_distributed_tpu/utils/logging.py: `log`
always prints, `debug_log` only while the debug flag is on; both keep
their last LOG_RING_LINES lines in memory (`recent_lines`, which
/distributed/master_log serves). The flag
comes from a reader (the config module installs one that reads the
config file's settings.debug) and is re-read at most every
DEBUG_FLAG_TTL_SECONDS, so toggling it reaches running processes.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
from typing import Callable

from .constants import DEBUG_FLAG_TTL_SECONDS

PREFIX = "[Distributed-Torch]"
LOG_RING_LINES = 1000

_ring: collections.deque[str] = collections.deque(maxlen=LOG_RING_LINES)

_lock = threading.Lock()
_debug = {"value": False, "checked_at": float("-inf")}
_debug_flag_reader: Callable[[], bool] | None = None


def set_debug_flag_reader(reader: Callable[[], bool] | None) -> None:
    """Install the function that reads the persistent debug flag."""
    global _debug_flag_reader
    with _lock:
        _debug_flag_reader = reader
        _debug["checked_at"] = float("-inf")


def is_debug_enabled() -> bool:
    now = time.monotonic()
    with _lock:
        reader = _debug_flag_reader
        if reader is None or now - _debug["checked_at"] < DEBUG_FLAG_TTL_SECONDS:
            return bool(_debug["value"])
        _debug["checked_at"] = now
    try:
        value = bool(reader())
    except (OSError, ValueError, KeyError, TypeError) as exc:
        log(f"debug-flag reader failed ({type(exc).__name__}: {exc}); keeping last value")
        return bool(_debug["value"])
    _debug["value"] = value
    return value


def _emit(line: str) -> None:
    _ring.append(line)
    print(line, file=sys.stdout, flush=True)


def recent_lines(tail: int) -> list[str]:
    """The last `tail` lines logged by this process."""
    lines = list(_ring)
    return lines[-tail:] if tail > 0 else []


def log(message: str) -> None:
    _emit(f"{PREFIX} {message}")


def debug_log(message: str) -> None:
    if is_debug_enabled():
        _emit(f"{PREFIX}[DEBUG] {message}")
