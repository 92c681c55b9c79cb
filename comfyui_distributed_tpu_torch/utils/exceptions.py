"""Error types of the port (own copies of the ones it raises from
comfyui_distributed_tpu/utils/exceptions.py)."""


class DistributedError(Exception):
    """Base class for all framework errors."""


class PromptValidationError(DistributedError):
    """A workflow graph failed validation before execution."""

    def __init__(self, message: str, node_errors: dict | None = None):
        super().__init__(message)
        self.node_errors = node_errors or {}
