"""Sync ↔ async bridging.

The port's own copy of comfyui_distributed_tpu/utils/async_helpers.py.
The graph executor runs nodes on a plain thread (compute must not block
the control-plane loop), while all distributed state (the job store,
HTTP) lives on one asyncio loop. `run_async_in_server_loop` bridges the
two: a compute thread hands a coroutine to the registered loop and
waits for its result.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import threading
from typing import Any, Awaitable, Optional

from .exceptions import DistributedError

_server_loop: Optional[asyncio.AbstractEventLoop] = None
_loop_lock = threading.Lock()


def set_server_loop(loop: Optional[asyncio.AbstractEventLoop]) -> None:
    """Register the control-plane event loop (the server does at start)."""
    global _server_loop
    with _loop_lock:
        _server_loop = loop


def get_server_loop() -> Optional[asyncio.AbstractEventLoop]:
    with _loop_lock:
        return _server_loop


def run_async_in_server_loop(coroutine: Awaitable[Any], timeout: float | None = None) -> Any:
    """Run `coroutine` on the registered server loop from a sync thread.

    With no running loop registered (hermetic tests, standalone use) it
    runs under `asyncio.run`. Raises TimeoutError on expiry after
    cancelling the task, and refuses to run on the loop's own thread,
    where waiting for the loop would deadlock it."""
    loop = get_server_loop()
    if loop is None or not loop.is_running():
        return asyncio.run(_with_timeout(coroutine, timeout))
    if _running_on(loop):
        close = getattr(coroutine, "close", None)
        if close is not None:
            close()
        raise DistributedError(
            "run_async_in_server_loop called from the server loop itself; "
            "this would deadlock: await the coroutine directly instead"
        )
    future = asyncio.run_coroutine_threadsafe(coroutine, loop)
    try:
        return future.result(timeout=timeout)
    except concurrent.futures.TimeoutError:
        future.cancel()
        raise TimeoutError(f"async operation timed out after {timeout}s") from None


async def _with_timeout(coroutine: Awaitable[Any], timeout: float | None) -> Any:
    if timeout is None:
        return await coroutine
    try:
        return await asyncio.wait_for(coroutine, timeout)
    except asyncio.TimeoutError:
        raise TimeoutError(f"async operation timed out after {timeout}s") from None


def _running_on(loop: asyncio.AbstractEventLoop) -> bool:
    try:
        return asyncio.get_running_loop() is loop
    except RuntimeError:
        return False


class ServerLoopThread:
    """Own an asyncio loop on a daemon thread (the control-plane loop).

    `start()` registers the loop globally so run_async_in_server_loop
    works from any compute thread; `stop()` drains pending tasks and
    closes it."""

    def __init__(self, name: str = "cdt-server-loop"):
        self._name = name
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()

    @property
    def loop(self) -> asyncio.AbstractEventLoop:
        if self._loop is None:
            raise DistributedError("server loop not started")
        return self._loop

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, name=self._name, daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise DistributedError("server loop thread did not start within 10 s")
        set_server_loop(self._loop)

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        self._loop = loop
        asyncio.set_event_loop(loop)
        self._started.set()
        loop.run_forever()
        pending = asyncio.all_tasks(loop)
        for task in pending:
            task.cancel()
        if pending:
            loop.run_until_complete(asyncio.gather(*pending, return_exceptions=True))
        loop.close()

    def stop(self) -> None:
        loop, thread = self._loop, self._thread
        if loop is not None and loop.is_running():
            loop.call_soon_threadsafe(loop.stop)
        if thread is not None:
            thread.join(timeout=10)
            if thread.is_alive():
                # still draining: keep the state so a later stop() retries
                return
        if get_server_loop() is loop:
            set_server_loop(None)
        self._thread = None
        self._loop = None
