"""Node registry: class name → node implementation.

The port's own copy of comfyui_distributed_tpu/graph/registry.py (that
package's graph/__init__.py imports every JAX node module). Nodes follow
the ComfyUI contract, so the bundled workflows load unchanged:

    class MyNode:
        @classmethod
        def INPUT_TYPES(cls) -> {"required": {name: (type, opts)},
                                 "optional": {...}, "hidden": {...}}
        RETURN_TYPES: tuple[str, ...]
        FUNCTION: str            # method name to call
        OUTPUT_NODE: bool        # terminal sink (its run marks outputs)
"""

from __future__ import annotations

from typing import Any, Type

NODE_REGISTRY: dict[str, Type[Any]] = {}


def register_node(cls: Type[Any] | None = None, *, name: str | None = None):
    """Class decorator: @register_node or @register_node(name=...)."""

    def wrap(klass: Type[Any]) -> Type[Any]:
        NODE_REGISTRY[name or klass.__name__] = klass
        return klass

    if cls is not None:
        return wrap(cls)
    return wrap


def get_node_class(class_type: str) -> Type[Any]:
    if class_type not in NODE_REGISTRY:
        raise KeyError(
            f"unknown node class {class_type!r}; registered: {sorted(NODE_REGISTRY)}"
        )
    return NODE_REGISTRY[class_type]
