"""Graph executor and the workflow nodes of the PyTorch port.

Importing the package registers the ported nodes.
"""

from . import nodes_core, nodes_distributed, nodes_upscale  # noqa: F401  (register nodes)
from .executor import ExecutionContext, GraphExecutor, validate_prompt
from .registry import NODE_REGISTRY, register_node

__all__ = [
    "ExecutionContext", "GraphExecutor", "NODE_REGISTRY", "register_node",
    "validate_prompt",
]
