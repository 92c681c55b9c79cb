"""Prompt-graph basics the executor needs (the port's own copy of the
link convention in comfyui_distributed_tpu/graph/prompt.py; the
distributed rewrite passes come with the elastic tier)."""

from __future__ import annotations

from typing import Any

Prompt = dict[str, dict[str, Any]]


def is_link(value: Any) -> bool:
    """A link is [node_id, output_index]."""
    return (
        isinstance(value, (list, tuple))
        and len(value) == 2
        and isinstance(value[0], str)
        and isinstance(value[1], int)
    )
