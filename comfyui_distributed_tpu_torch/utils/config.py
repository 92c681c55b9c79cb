"""Persistent JSON config.

The port's own copy of the parts of comfyui_distributed_tpu/utils/
config.py that the server and the elastic tier read: defaults merged
recursively under the file's values (unknown keys kept), a read cache
keyed by the file's mtime, atomic writes, and one mutex for every
read-modify-write: `config_transaction` (the config routes, on the
loop) and `locked_config` (the process manager's PID records, on
threads) exclude each other, so neither loses the other's write. The
path is the `path` argument, else CDT_CONFIG_PATH, else
`cdt_torch_config.json` in the working directory.

Workers are entries of config["workers"] (WORKER_TEMPLATE): "type" is
"local" for a process the master launches on this host, "remote" for
one on another; "cuda_device" is the card a local worker is pinned to
(the upstream reference's own key, in place of the JAX package's
`tpu_chips`); "extra_args" are appended to its command line.
settings.input_dir and settings.output_dir point the media nodes at
their directories; `managed_processes` holds the PIDs of launched
workers.
"""

from __future__ import annotations

import asyncio
import contextlib
import copy
import json
import os
import threading
from typing import Any, AsyncIterator, Iterator

from . import logging as dlog
from .constants import HEARTBEAT_TIMEOUT_SECONDS
from .fsio import atomic_write_json

CONFIG_FILENAME = "cdt_torch_config.json"
CDT_CONFIG_PATH = "CDT_CONFIG_PATH"

DEFAULT_CONFIG: dict[str, Any] = {
    "master": {"host": "", "cuda_device": 0},
    "workers": [],
    "settings": {
        "debug": False,
        "auto_launch_workers": False,
        "stop_workers_on_master_exit": True,
        "master_delegate_only": False,
        "websocket_orchestration": True,
        "worker_timeout_seconds": HEARTBEAT_TIMEOUT_SECONDS,
        "probe_concurrency": 8,
        "prep_concurrency": 4,
        "media_sync_concurrency": 2,
    },
    "managed_processes": {},
}

WORKER_TEMPLATE: dict[str, Any] = {
    "id": "",
    "name": "",
    "type": "local",
    "host": "",
    "port": 0,
    "cuda_device": None,
    "enabled": False,
    "extra_args": "",
}


def get_config_path() -> str:
    return os.environ.get(CDT_CONFIG_PATH) or os.path.join(os.getcwd(), CONFIG_FILENAME)


def _merge_defaults(defaults: Any, loaded: Any) -> Any:
    """Recursively overlay `loaded` on `defaults`, keeping unknown keys."""
    if isinstance(defaults, dict) and isinstance(loaded, dict):
        merged = {k: copy.deepcopy(v) for k, v in defaults.items()}
        for key, value in loaded.items():
            if key in merged:
                merged[key] = _merge_defaults(merged[key], value)
            else:
                merged[key] = copy.deepcopy(value)
        return merged
    return copy.deepcopy(loaded)


class _Cache:
    def __init__(self) -> None:
        self.path: str | None = None
        self.mtime: float | None = None
        self.data: dict[str, Any] | None = None
        self.lock = threading.Lock()


_cache = _Cache()
# The read-modify-write mutex: a threading.Lock (taken off the loop by
# the async transaction) because transactions run on the server loop and
# on plain threads alike.
_txn_lock = threading.Lock()


def load_config(path: str | None = None) -> dict[str, Any]:
    """The config with defaults merged in; cached by the file's mtime. A
    missing or corrupt file gives the defaults (a corrupt one is logged)."""
    path = path or get_config_path()
    with _cache.lock:
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            mtime = None
        if _cache.data is not None and _cache.path == path and mtime is not None \
                and _cache.mtime == mtime:
            return copy.deepcopy(_cache.data)
        loaded: dict[str, Any] = {}
        if mtime is not None:
            try:
                with open(path, encoding="utf-8") as fh:
                    loaded = json.load(fh)
            except (OSError, json.JSONDecodeError) as exc:
                dlog.log(f"Config load failed ({exc}); using defaults")
                loaded = {}
        merged = _merge_defaults(DEFAULT_CONFIG, loaded)
        _cache.path, _cache.mtime, _cache.data = path, mtime, merged
        return copy.deepcopy(merged)


def save_config(config: dict[str, Any], path: str | None = None) -> None:
    """Atomic write (utils/fsio.py); the cache keeps the merged view."""
    path = path or get_config_path()
    atomic_write_json(path, config, indent=2)
    with _cache.lock:
        _cache.path = path
        try:
            _cache.mtime = os.path.getmtime(path)
        except OSError:
            _cache.mtime = None
        _cache.data = _merge_defaults(DEFAULT_CONFIG, config)


@contextlib.contextmanager
def locked_config(path: str | None = None) -> Iterator[dict[str, Any]]:
    """Locked read-modify-write for threads; saves only if changed."""
    with _txn_lock:
        config = load_config(path)
        snapshot = copy.deepcopy(config)
        yield config
        if config != snapshot:
            save_config(config, path)


@contextlib.asynccontextmanager
async def config_transaction(path: str | None = None) -> AsyncIterator[dict[str, Any]]:
    """`locked_config` for coroutines: the lock is taken on a thread, so
    the loop never blocks on it."""
    await asyncio.to_thread(_txn_lock.acquire)
    try:
        config = load_config(path)
        snapshot = copy.deepcopy(config)
        yield config
        if config != snapshot:
            save_config(config, path)
    finally:
        _txn_lock.release()


def get_setting(name: str, default: Any = None, path: str | None = None) -> Any:
    return load_config(path).get("settings", {}).get(name, default)


def get_worker_timeout_seconds(path: str | None = None) -> float:
    return worker_timeout_seconds(load_config(path))


def worker_timeout_seconds(config: dict[str, Any]) -> float:
    """settings.worker_timeout_seconds of a loaded config: how long a
    worker may go without a heartbeat before its tiles are requeued."""
    value = config.get("settings", {}).get("worker_timeout_seconds", HEARTBEAT_TIMEOUT_SECONDS)
    try:
        value = float(value)
    except (TypeError, ValueError):
        return HEARTBEAT_TIMEOUT_SECONDS
    return value if value > 0 else HEARTBEAT_TIMEOUT_SECONDS


def _read_debug_flag() -> bool:
    return bool(get_setting("debug", False))


dlog.set_debug_flag_reader(_read_debug_flag)
