"""The master's start-up and shutdown, and a worker's drain.

The port's own copy of comfyui_distributed_tpu/workers/startup.py:

- `auto_populate_workers`: once per config, one disabled local worker
  entry per card the master does not use (`torch.cuda.device_count()`
  cards, the master's `cuda_device` left out), ports from 8189;
- `delayed_auto_launch`: shortly after start, drop stale PID records
  and launch the enabled local workers when settings.auto_launch_workers
  is on;
- `sync_cleanup` / `register_signals`: on SIGINT, SIGTERM or SIGHUP (and
  at exit) the master stops its managed workers when
  settings.stop_workers_on_master_exit is on;
- `drain_worker` / `register_worker_drain`: SIGTERM or SIGINT on a
  worker interrupts its prompt, waits for the executor to settle, then
  stops the server.

The JAX package's `configure_compile_cache` has no counterpart: it
points JAX's persistent compile cache at a shared directory. The port's
only compiled artefact is the kernel library in
`comfyui_distributed_tpu_torch/build/`, named by the hash of `csrc/`
(`_build.py`), which every process on the host shares: a worker started
while the master builds may build its own copy, renamed into place
atomically.
"""

from __future__ import annotations

import asyncio
import atexit
import os
import signal
import threading
from typing import Any, Callable, Optional

from ..utils import config as config_mod
from ..utils.constants import AUTO_LAUNCH_DELAY_SECONDS, WORKER_ENV_FLAG
from ..utils.logging import log
from .process_manager import get_worker_manager

_cleanup_done = threading.Event()
FIRST_WORKER_PORT = 8189


def is_worker_process() -> bool:
    return os.environ.get(WORKER_ENV_FLAG) == "1"


def _device_count() -> int:
    import torch

    try:
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    except RuntimeError:
        return 0


def auto_populate_workers(config_path: str | None = None) -> list[dict[str, Any]]:
    """One disabled local worker per spare card, once (the flag
    settings.has_auto_populated_workers persists)."""
    if is_worker_process():
        return []
    config = config_mod.load_config(config_path)
    if config.get("settings", {}).get("has_auto_populated_workers"):
        return []
    master_device = config.get("master", {}).get("cuda_device", 0)
    master_devices = set(master_device if isinstance(master_device, list) else [master_device])
    spare = [d for d in range(_device_count()) if d not in master_devices]
    created = [{"id": f"cuda{d}", "name": f"cuda{d}", "type": "local", "host": "127.0.0.1",
                "port": FIRST_WORKER_PORT + i, "cuda_device": d, "enabled": False,
                "extra_args": "", "auto_populated": True}
               for i, d in enumerate(spare)]
    with config_mod.locked_config(config_path) as locked:
        locked.setdefault("workers", []).extend(created)
        locked.setdefault("settings", {})["has_auto_populated_workers"] = True
    if created:
        log(f"auto-populated {len(created)} worker(s) for spare cards {spare}")
    return created


def delayed_auto_launch(config_path: str | None = None,
                        delay: float = AUTO_LAUNCH_DELAY_SECONDS) -> Optional[threading.Timer]:
    """After `delay` (the server listens first): clear stale PID records,
    then launch the enabled local workers if auto_launch_workers is on."""
    if is_worker_process():
        return None

    def launch() -> None:
        manager = get_worker_manager()
        stale = manager.clear_stale(config_path)
        if stale:
            log(f"cleared stale managed workers: {stale}")
        config = config_mod.load_config(config_path)
        if not config.get("settings", {}).get("auto_launch_workers"):
            return
        for worker in config.get("workers", []):
            if not worker.get("enabled") or worker.get("type") != "local":
                continue
            try:
                manager.launch_worker(worker, config_path)
            except Exception as exc:  # noqa: BLE001 - the others still launch
                log(f"auto-launch of {worker.get('id')} failed: {exc}")

    timer = threading.Timer(delay, launch)
    timer.daemon = True
    timer.start()
    return timer


def sync_cleanup(config_path: str | None = None) -> None:
    """Stop the managed workers if configured to (once; masters only)."""
    if _cleanup_done.is_set() or is_worker_process():
        return
    _cleanup_done.set()
    config = config_mod.load_config(config_path)
    if config.get("settings", {}).get("stop_workers_on_master_exit", True):
        stopped = get_worker_manager().stop_all(config_path)
        if stopped:
            log(f"stopped {stopped} managed worker(s) on exit")


def register_signals(loop: asyncio.AbstractEventLoop, config_path: str | None = None,
                     on_stop: Optional[Callable[[], None]] = None) -> None:
    """SIGINT/SIGTERM/SIGHUP on a master: the cleanup (off the loop), then
    `on_stop` (default: stop the loop); atexit as the fallback."""
    if is_worker_process():
        return
    stop = on_stop or loop.stop

    def handler() -> None:
        async def cleanup_then_stop() -> None:
            try:
                await asyncio.to_thread(sync_cleanup, config_path)
            finally:
                stop()

        loop.create_task(cleanup_then_stop())

    for sig in (signal.SIGINT, signal.SIGTERM, signal.SIGHUP):
        try:
            loop.add_signal_handler(sig, handler)
        except (NotImplementedError, RuntimeError):
            pass  # atexit still covers it
    atexit.register(sync_cleanup, config_path)


async def drain_worker(server, grace_seconds: float = 30.0) -> bool:
    """Interrupt the prompt in flight (an elastic worker flushes what it
    encoded and hands the rest back), wait up to `grace_seconds` for the
    executor, then stop the server. True when it settled in time."""
    server.interrupt()
    loop = asyncio.get_running_loop()
    deadline = loop.time() + max(0.0, grace_seconds)
    drained = True
    while server._executing.is_set():
        if loop.time() > deadline:
            drained = False
            log(f"worker drain: executor still busy after {grace_seconds}s; stopping anyway")
            break
        await asyncio.sleep(0.1)
    await server.stop()
    return drained


def register_worker_drain(loop: asyncio.AbstractEventLoop, server, grace_seconds: float = 30.0,
                          on_stopped: Optional[Callable[[], None]] = None) -> None:
    """SIGTERM/SIGINT on a worker: drain, then `on_stopped` (default: stop
    the loop); a second signal stops at once."""
    if not (is_worker_process() or getattr(server, "is_worker", False)):
        return
    draining = threading.Event()

    def handler() -> None:
        stop = on_stopped or loop.stop
        if draining.is_set():
            stop()
            return
        draining.set()
        log("worker received SIGTERM/SIGINT: draining the prompt in flight")

        async def drain_and_stop() -> None:
            try:
                await drain_worker(server, grace_seconds)
            finally:
                stop()

        loop.create_task(drain_and_stop())

    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, handler)
        except (NotImplementedError, RuntimeError):
            pass
