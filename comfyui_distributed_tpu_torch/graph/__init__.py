"""Graph executor and the workflow nodes of the PyTorch port.

Importing the package registers the ported nodes.
"""

from . import (  # noqa: F401
    nodes_controlnet,
    nodes_core,
    nodes_custom_sampling,
    nodes_distributed,
    nodes_loaders,
    nodes_mask,
    nodes_transform,
    nodes_upscale,
    nodes_video,
)
from .executor import ExecutionContext, GraphExecutor, validate_prompt
from .registry import NODE_REGISTRY, register_node

__all__ = [
    "ExecutionContext", "GraphExecutor", "NODE_REGISTRY", "register_node",
    "validate_prompt",
]
