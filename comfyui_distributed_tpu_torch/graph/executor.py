"""Graph validation and execution.

The port's own copy of comfyui_distributed_tpu/graph/executor.py:
`validate_prompt` summarises per-node errors, `GraphExecutor.execute`
runs the graph in topological order with per-context result caching.
The context names the device the nodes run on: the card unless the
caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import threading
import time
from typing import Any, Optional

from ..utils.exceptions import PromptValidationError
from .prompt import Prompt, is_link
from .registry import NODE_REGISTRY, get_node_class


@dataclasses.dataclass
class ExecutionContext:
    """Everything a node can reach at run time."""

    device: str = "cuda"
    mesh: Any = None
    config: dict[str, Any] | None = None
    server: Any = None  # api server state (elastic tier)
    interrupt_event: threading.Event = dataclasses.field(default_factory=threading.Event)
    # caches shared across nodes in one process
    pipelines: dict[str, Any] = dataclasses.field(default_factory=dict)
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)

    def check_interrupted(self) -> None:
        if self.interrupt_event.is_set():
            raise InterruptedError("execution interrupted")


def validate_prompt(prompt: Prompt) -> None:
    """Raise PromptValidationError carrying per-node error summaries."""
    node_errors: dict[str, list[str]] = {}
    if not isinstance(prompt, dict) or not prompt:
        raise PromptValidationError("prompt must be a non-empty dict", {})

    for node_id, node in prompt.items():
        errors: list[str] = []
        if not isinstance(node, dict) or "class_type" not in node:
            node_errors[str(node_id)] = ["node must be a dict with class_type"]
            continue
        class_type = node["class_type"]
        if class_type not in NODE_REGISTRY:
            node_errors[str(node_id)] = [f"unknown class_type {class_type!r}"]
            continue
        schema = get_node_class(class_type).INPUT_TYPES()
        inputs = node.get("inputs", {})
        for name, spec in schema.get("required", {}).items():
            if name not in inputs and _spec_default(spec) is None:
                errors.append(f"missing required input {name!r}")
        for name, value in inputs.items():
            if not is_link(value):
                continue
            if value[0] not in prompt:
                errors.append(f"input {name!r} links to missing node {value[0]!r}")
                continue
            src = prompt[value[0]]
            src_cls = NODE_REGISTRY.get(src.get("class_type", "")) if isinstance(src, dict) else None
            if src_cls is not None:
                n_outputs = len(getattr(src_cls, "RETURN_TYPES", ()))
                if value[1] >= n_outputs:
                    errors.append(
                        f"input {name!r} links to output {value[1]} of "
                        f"node {value[0]!r} which has {n_outputs} output(s)"
                    )
        if errors:
            node_errors[str(node_id)] = errors

    if node_errors:
        summary = "; ".join(
            f"node {nid}: {', '.join(errs)}" for nid, errs in sorted(node_errors.items())
        )
        raise PromptValidationError(f"invalid prompt: {summary}", node_errors)

    _toposort(prompt)  # raises on cycles


def _spec_default(spec: Any) -> Any:
    if isinstance(spec, (tuple, list)) and len(spec) > 1 and isinstance(spec[1], dict):
        return spec[1].get("default")
    return None


def _toposort(prompt: Prompt) -> list[str]:
    order: list[str] = []
    state: dict[str, int] = {}  # 0=unvisited 1=visiting 2=done

    def visit(node_id: str, chain: list[str]) -> None:
        s = state.get(node_id, 0)
        if s == 2:
            return
        if s == 1:
            cycle = " -> ".join(chain + [node_id])
            raise PromptValidationError(f"cycle in prompt graph: {cycle}", {})
        state[node_id] = 1
        for value in prompt[node_id].get("inputs", {}).values():
            if is_link(value) and value[0] in prompt:
                visit(value[0], chain + [node_id])
        state[node_id] = 2
        order.append(node_id)

    for node_id in sorted(prompt):
        visit(node_id, [])
    return order


class GraphExecutor:
    """Execute a validated prompt graph."""

    def __init__(self, context: Optional[ExecutionContext] = None):
        self.context = context or ExecutionContext()
        # per-node wall times and outputs of the last execution; the
        # outputs let a caller read a node that feeds no sink
        self.last_timings: dict[str, float] = {}
        self.last_results: dict[str, tuple] = {}

    def execute(self, prompt: Prompt) -> dict[str, Any]:
        """Run the graph; returns {node_id: output} for OUTPUT_NODE nodes.

        A node re-executes only when its literal inputs or an upstream
        node changed since the previous run on this context; nodes
        marked NEVER_CACHE and output sinks always re-run.
        """
        validate_prompt(prompt)
        order = _toposort(prompt)
        results: dict[str, tuple] = {}
        outputs: dict[str, Any] = {}
        self.last_timings = {}
        self.last_results = results
        cache: dict[str, tuple[str, tuple]] = self.context.extras.setdefault("node_cache", {})
        content_keys: dict[str, str] = {}

        for node_id in order:
            self.context.check_interrupted()
            node_def = prompt[node_id]
            cls = get_node_class(node_def["class_type"])
            schema = cls.INPUT_TYPES()

            # content key: class + literal inputs + upstream keys
            literals = {k: v for k, v in node_def.get("inputs", {}).items() if not is_link(v)}
            upstream_keys = sorted(
                content_keys.get(v[0], "?")
                for v in node_def.get("inputs", {}).values()
                if is_link(v)
            )
            content_keys[node_id] = json.dumps(
                [node_def["class_type"], literals, upstream_keys], sort_keys=True, default=str,
            )
            cacheable = not getattr(cls, "OUTPUT_NODE", False) and not getattr(
                cls, "NEVER_CACHE", False
            )
            cached = cache.get(node_id) if cacheable else None
            if cached is not None and cached[0] == content_keys[node_id]:
                results[node_id] = cached[1]
                self.last_timings[node_id] = 0.0
                continue

            # defaults first, then literal/link inputs
            kwargs: dict[str, Any] = {}
            for section in ("required", "optional"):
                for name, spec in schema.get(section, {}).items():
                    default = _spec_default(spec)
                    if default is not None:
                        kwargs[name] = default
            for name, value in node_def.get("inputs", {}).items():
                kwargs[name] = results[value[0]][value[1]] if is_link(value) else value

            fn = getattr(cls(), cls.FUNCTION)
            if "context" in inspect.signature(fn).parameters:
                kwargs["context"] = self.context
            started = time.perf_counter()
            result = fn(**kwargs)
            self.last_timings[node_id] = round(time.perf_counter() - started, 4)
            if result is None:
                result = ()
            if not isinstance(result, tuple):
                result = (result,)
            results[node_id] = result
            if cacheable:
                cache[node_id] = (content_keys[node_id], result)
            if getattr(cls, "OUTPUT_NODE", False):
                outputs[node_id] = result
        # drop cache entries of node ids absent from this prompt, so a
        # long-lived context does not keep stale tensors alive
        for stale_id in set(cache) - set(prompt):
            del cache[stale_id]
        return outputs
