"""Retry/backoff policy for every cross-host RPC.

The port's own copy of comfyui_distributed_tpu/resilience/policy.py:
one `RetryPolicy` (exponential backoff, multiplicative jitter, an
overall deadline) and one `retry_async`, with the same canonical
policies and parameters. `retry_async` re-raises the last failure, so
callers keep their own exception types; every retry counts in
cdt_retries_total by operation. The transport errors are
urllib's and the socket's (utils/network.py), not aiohttp's.
"""

from __future__ import annotations

import asyncio
import dataclasses
import random
import time
from typing import Any, Awaitable, Callable, Optional, Tuple, Type

from ..utils import constants
from ..utils.logging import debug_log
from ..utils.network import TRANSPORT_ERRORS

_jitter_rng = random.Random()


def transport_errors() -> Tuple[Type[BaseException], ...]:
    """Failures where the request may never have arrived: the only class
    worth retrying for a send that is not idempotent."""
    return TRANSPORT_ERRORS + (asyncio.TimeoutError,)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff schedule with jitter and an overall deadline."""

    max_attempts: int = 5
    base_delay: float = 0.5
    multiplier: float = 2.0
    max_delay: float = 30.0
    jitter: float = 0.1  # +- fraction of the computed delay
    deadline: Optional[float] = None  # wall-clock budget for all attempts

    def delay_for(self, attempt: int) -> float:
        """Backoff to sleep after failed attempt `attempt` (0-based)."""
        raw = min(self.base_delay * (self.multiplier ** attempt), self.max_delay)
        if self.jitter > 0:
            raw *= 1.0 + _jitter_rng.uniform(-self.jitter, self.jitter)
        return max(0.0, raw)


async def retry_async(
    fn: Callable[[], Awaitable[Any]],
    policy: RetryPolicy,
    *,
    retryable: Tuple[Type[BaseException], ...] = (Exception,),
    label: str = "",
) -> Any:
    """Await `fn()` under `policy`; re-raise the last failure when the
    attempts or the deadline run out. Exceptions outside `retryable`
    propagate at once."""
    start = time.monotonic()
    attempts = max(1, policy.max_attempts)
    for attempt in range(attempts):
        try:
            return await fn()
        except retryable as exc:
            if attempt + 1 >= attempts:
                raise
            delay = policy.delay_for(attempt)
            if policy.deadline is not None and time.monotonic() - start + delay > policy.deadline:
                debug_log(f"retry[{label}]: deadline {policy.deadline}s exhausted "
                          f"after {attempt + 1} attempt(s)")
                raise
            # one counter labelled by the operation part of the label
            # ("dispatch:w1" → op="dispatch"): retry pressure without
            # per-target series
            from ..telemetry import instruments

            instruments.retries_total().inc(op=label.split(":", 1)[0] if label else "unlabeled")
            debug_log(f"retry[{label}]: attempt {attempt + 1}/{attempts} failed "
                      f"({type(exc).__name__}: {exc}); backing off {delay:.2f}s")
        await asyncio.sleep(delay)
    raise AssertionError("unreachable: the last attempt returns or raises")


# --- canonical policies ---------------------------------------------------
# Factories, so a test that patches utils.constants gets fresh values.

def http_policy(deadline: float | None = None) -> RetryPolicy:
    """General request retry: short exponential backoff, 30 s cap."""
    return RetryPolicy(
        max_attempts=constants.REQUEST_RETRY_COUNT,
        base_delay=constants.REQUEST_RETRY_BACKOFF,
        multiplier=2.0, max_delay=30.0, jitter=0.1, deadline=deadline,
    )


def work_pull_policy() -> RetryPolicy:
    """Worker → master tile pull: patient, capped."""
    return RetryPolicy(
        max_attempts=constants.WORK_PULL_RETRY_COUNT,
        base_delay=constants.REQUEST_RETRY_BACKOFF,
        multiplier=2.0, max_delay=constants.WORK_PULL_RETRY_CAP_SECONDS, jitter=0.1,
    )


def poll_ready_policy() -> RetryPolicy:
    """Job-ready poll: a fixed interval, no jitter."""
    return RetryPolicy(
        max_attempts=constants.JOB_READY_POLL_ATTEMPTS,
        base_delay=constants.JOB_READY_POLL_INTERVAL,
        multiplier=1.0, max_delay=constants.JOB_READY_POLL_INTERVAL, jitter=0.0,
    )
