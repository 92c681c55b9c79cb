"""Error types of the port (own copies of the ones it raises from
comfyui_distributed_tpu/utils/exceptions.py)."""


class DistributedError(Exception):
    """Base class for all framework errors."""


class WorkerError(DistributedError):
    """A worker failed or returned an invalid response."""

    def __init__(self, message: str, worker_id: str | int | None = None):
        super().__init__(message)
        self.worker_id = worker_id


class TransientServerError(WorkerError):
    """The peer answered 5xx: it is alive but momentarily failing, so
    the request is worth retrying, unlike a 4xx rejection."""


class WorkerNotAvailableError(WorkerError):
    """A worker could not be used at dispatch or probe time (unreachable,
    or it answered with a rejection)."""


class WorkerUnreachableError(WorkerNotAvailableError):
    """Transport-level failure: the request may never have arrived."""


class JobQueueError(DistributedError):
    """Job queue state is missing or inconsistent."""


class JobCancelled(DistributedError):
    """The job reached a terminal cancelled state (client cancel or
    deadline expiry): pending and in-flight tiles were refunded, and the
    master loop unwinds instead of blending a partial canvas."""

    def __init__(self, job_id: str, reason: str = "cancel"):
        super().__init__(f"job {job_id} cancelled ({reason})")
        self.job_id = job_id
        self.reason = reason


class JobPoisoned(DistributedError):
    """The poison policy is "fail" and at least one tile exhausted its
    attempt budget: the job terminates instead of completing with a
    degraded (base-image) region."""

    def __init__(self, job_id: str, tiles: list[int]):
        super().__init__(
            f"job {job_id} poisoned: tile(s) {sorted(tiles)} exhausted "
            "their attempt budget"
        )
        self.job_id = job_id
        self.tiles = sorted(int(t) for t in tiles)


class PromptValidationError(DistributedError):
    """A workflow graph failed validation before execution."""

    def __init__(self, message: str, node_errors: dict | None = None):
        super().__init__(message)
        self.node_errors = node_errors or {}
