"""Logging with a hot-reloadable debug flag.

The port's own copy of comfyui_distributed_tpu/utils/logging.py: `log`
always prints, `debug_log` only while the debug flag is on. The flag
comes from a reader (the config module installs one that reads the
config file's settings.debug) and is re-read at most every
DEBUG_FLAG_TTL_SECONDS, so toggling it reaches running processes.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable

from .constants import DEBUG_FLAG_TTL_SECONDS

PREFIX = "[Distributed-Torch]"

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


def log(message: str) -> None:
    print(f"{PREFIX} {message}", file=sys.stdout, flush=True)


def debug_log(message: str) -> None:
    if is_debug_enabled():
        print(f"{PREFIX}[DEBUG] {message}", file=sys.stdout, flush=True)
