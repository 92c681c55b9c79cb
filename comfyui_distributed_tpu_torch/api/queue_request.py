"""Queue-request payload parsing and validation.

The port's own copy of comfyui_distributed_tpu/api/queue_request.py,
without the scheduler's tenant/lane fields and adapters: {"prompt" |
"workflow": {...}, "workers" | "worker_ids": [...], "client_id": str,
"deadline_s"?: seconds}; errors name the offending field. Every other
key of the body lands in `extra` (e.g. "load_balance": true, which the
orchestration reads), the JAX package's keys excluded as there, so the
same body gives the same `extra` in both packages.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

from ..utils.exceptions import DistributedError


class QueueRequestError(DistributedError):
    pass


@dataclasses.dataclass
class QueueRequestPayload:
    prompt: dict[str, Any]
    client_id: str
    worker_ids: list[str]
    # end-to-end deadline in seconds from arrival (None = none): rides
    # the job record, which expires overdue work
    deadline_s: float | None = None
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)


# the keys the JAX package parses (tenant, lane and adapters included):
# none of them lands in `extra`
_PARSED_KEYS = ("prompt", "workflow", "client_id", "workers", "worker_ids", "tenant", "lane",
                "deadline_s", "adapters")


def parse_deadline_seconds(value: Any) -> float | None:
    """Positive finite seconds; None or "" = no deadline; else raises."""
    if value is None or value == "":
        return None
    try:
        deadline = float(value)
    except (TypeError, ValueError) as exc:
        raise QueueRequestError("'deadline_s' must be a positive number of seconds") from exc
    if not (deadline > 0 and math.isfinite(deadline)):
        raise QueueRequestError("'deadline_s' must be a positive number of seconds")
    return deadline


def parse_queue_request_payload(body: Any) -> QueueRequestPayload:
    if not isinstance(body, dict):
        raise QueueRequestError("request body must be a JSON object")
    prompt = body.get("prompt")
    if prompt is None and isinstance(body.get("workflow"), dict):
        prompt = body["workflow"].get("prompt", body["workflow"])
    if not isinstance(prompt, dict) or not prompt:
        raise QueueRequestError("missing or empty 'prompt'")
    client_id = body.get("client_id")
    if not isinstance(client_id, str) or not client_id:
        raise QueueRequestError("'client_id' is required")
    workers = body.get("workers", body.get("worker_ids", []))
    if workers is None:
        workers = []
    if not isinstance(workers, list) or not all(isinstance(w, (str, int)) for w in workers):
        raise QueueRequestError("'workers' must be a list of ids")
    return QueueRequestPayload(
        prompt=prompt,
        client_id=client_id,
        worker_ids=[str(w) for w in workers],
        deadline_s=parse_deadline_seconds(body.get("deadline_s")),
        extra={k: v for k, v in body.items() if k not in _PARSED_KEYS},
    )
