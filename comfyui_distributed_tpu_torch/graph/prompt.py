"""Prompt-graph indexing and the distributed rewrite passes.

The port's own copy of comfyui_distributed_tpu/graph/prompt.py, pure
JSON algorithms:

- PromptIndex: class/node lookup tables + upstream reachability.
- prune_prompt_for_worker: a worker keeps only the distributed nodes
  and everything upstream of them; downstream-only nodes (saves,
  previews) are dropped and a terminal PreviewImage is appended so the
  worker's executor has a sink.
- generate_job_id_map / apply_participant_overrides: one job id per
  distributed node, and per participant the role, worker id, master URL,
  job id, seed index and per-worker value overrides.

The delegate-only master rewrite (prepare_delegate_master_prompt) is
not ported yet.
"""

from __future__ import annotations

import copy
import time
import uuid
from typing import Any, Callable

Prompt = dict[str, dict[str, Any]]

# node classes that make a graph distributed (the reference's names, so
# its workflows load unchanged)
COLLECTOR_CLASSES = ("DistributedCollector",)
UPSCALER_CLASSES = ("UltimateSDUpscaleDistributed",)
SEED_CLASSES = ("DistributedSeed",)
VALUE_CLASSES = ("DistributedValue",)
DISTRIBUTED_CLASSES = COLLECTOR_CLASSES + UPSCALER_CLASSES + SEED_CLASSES + VALUE_CLASSES
TERMINAL_OUTPUT_CLASS = "PreviewImage"


def is_link(value: Any) -> bool:
    """A link is [node_id, output_index]."""
    return (
        isinstance(value, (list, tuple))
        and len(value) == 2
        and isinstance(value[0], str)
        and isinstance(value[1], int)
    )


class PromptIndex:
    """Lookup tables over a prompt graph + cached upstream reachability."""

    def __init__(self, prompt: Prompt):
        self.prompt = prompt
        self.by_class: dict[str, list[str]] = {}
        for node_id, node in prompt.items():
            self.by_class.setdefault(node.get("class_type", ""), []).append(node_id)
        self._upstream_cache: dict[str, frozenset[str]] = {}

    def nodes_of_class(self, *class_names: str) -> list[str]:
        out: list[str] = []
        for name in class_names:
            out.extend(self.by_class.get(name, []))
        return sorted(out)

    def inputs_of(self, node_id: str) -> dict[str, Any]:
        return self.prompt.get(node_id, {}).get("inputs", {})

    def direct_upstream(self, node_id: str) -> list[str]:
        return [v[0] for v in self.inputs_of(node_id).values()
                if is_link(v) and v[0] in self.prompt]

    def upstream_closure(self, node_id: str) -> frozenset[str]:
        """All nodes reachable following input links (incl. the node)."""
        cached = self._upstream_cache.get(node_id)
        if cached is not None:
            return cached
        seen: set[str] = set()
        stack = [node_id]
        while stack:
            current = stack.pop()
            if current in seen or current not in self.prompt:
                continue
            seen.add(current)
            stack.extend(self.direct_upstream(current))
        result = frozenset(seen)
        self._upstream_cache[node_id] = result
        return result


def fresh_node_id(*prompts: Prompt) -> str:
    """An id unused in all given prompts."""
    numeric = [int(k) for p in prompts for k in p if k.isdigit()]
    return str(max(numeric, default=0) + 1)


def prune_prompt_for_worker(prompt: Prompt, index: PromptIndex | None = None) -> Prompt:
    """Keep only the collector/upscaler nodes and their upstream closure,
    plus a terminal PreviewImage on the first of them."""
    index = index or PromptIndex(prompt)
    anchors = index.nodes_of_class(*(COLLECTOR_CLASSES + UPSCALER_CLASSES))
    if not anchors:
        return copy.deepcopy(prompt)
    keep: set[str] = set()
    for anchor in anchors:
        keep |= index.upstream_closure(anchor)
    pruned = {nid: copy.deepcopy(prompt[nid]) for nid in keep}
    sink_id = fresh_node_id(pruned, prompt)
    pruned[sink_id] = {"class_type": TERMINAL_OUTPUT_CLASS, "inputs": {"images": [anchors[0], 0]}}
    return pruned


def generate_job_id_map(prompt: Prompt, index: PromptIndex | None = None) -> dict[str, str]:
    """One job id per collector/upscaler node: exec_<ms>_<uuid6>_<node>."""
    index = index or PromptIndex(prompt)
    base = f"exec_{int(time.time() * 1000)}_{uuid.uuid4().hex[:6]}"
    return {node_id: f"{base}_{node_id}"
            for node_id in index.nodes_of_class(*(COLLECTOR_CLASSES + UPSCALER_CLASSES))}


# --- participant overrides ------------------------------------------------

def _coerce(value: Any, type_name: str) -> Any:
    try:
        if type_name == "INT":
            return int(value)
        if type_name == "FLOAT":
            return float(value)
        if type_name == "BOOLEAN":
            if isinstance(value, str):
                return value.strip().lower() in ("1", "true", "yes", "on")
            return bool(value)
        return str(value)
    except (TypeError, ValueError):
        return None


def _override_distributed_seed(node: dict[str, Any], participant: "ParticipantInfo") -> None:
    node["inputs"]["is_worker"] = participant.is_worker
    node["inputs"]["worker_index"] = participant.worker_index


def _override_distributed_value(node: dict[str, Any], participant: "ParticipantInfo") -> None:
    """A per-worker typed value: `overrides` is {"_type": "INT", "1":
    "100", ...} keyed by 1-based worker position; the master keeps the
    node's base value."""
    node["inputs"]["is_worker"] = participant.is_worker
    node["inputs"]["worker_index"] = participant.worker_index
    if not participant.is_worker:
        return
    overrides = node["inputs"].get("overrides")
    if not isinstance(overrides, dict):
        return
    raw = overrides.get(str(participant.worker_index + 1))
    if raw is None:
        return
    coerced = _coerce(raw, overrides.get("_type", "STRING"))
    if coerced is not None:
        node["inputs"]["value"] = coerced


def _override_collector(node: dict[str, Any], participant: "ParticipantInfo") -> None:
    node["inputs"]["is_worker"] = participant.is_worker
    node["inputs"]["worker_id"] = participant.worker_id
    node["inputs"]["master_url"] = participant.master_url
    node["inputs"]["job_id"] = participant.job_ids.get(participant.current_node_id, "")


_OVERRIDE_FNS: dict[str, Callable[[dict[str, Any], "ParticipantInfo"], None]] = {}
for _cls in SEED_CLASSES:
    _OVERRIDE_FNS[_cls] = _override_distributed_seed
for _cls in VALUE_CLASSES:
    _OVERRIDE_FNS[_cls] = _override_distributed_value
for _cls in COLLECTOR_CLASSES + UPSCALER_CLASSES:
    _OVERRIDE_FNS[_cls] = _override_collector


class ParticipantInfo:
    """Identity of one participant for a given execution."""

    def __init__(self, is_worker: bool, worker_index: int = -1, worker_id: str = "",
                 master_url: str = "", job_ids: dict[str, str] | None = None,
                 enabled_worker_ids: list[str] | None = None):
        self.is_worker = is_worker
        self.worker_index = worker_index
        self.worker_id = worker_id
        self.master_url = master_url
        self.job_ids = job_ids or {}
        self.enabled_worker_ids = enabled_worker_ids or []
        self.current_node_id = ""


def apply_participant_overrides(prompt: Prompt, participant: ParticipantInfo) -> Prompt:
    """A deep copy of the prompt with one participant's role, seed,
    value and job-id overrides applied."""
    out = copy.deepcopy(prompt)
    for node_id, node in out.items():
        fn = _OVERRIDE_FNS.get(node.get("class_type", ""))
        if fn is not None:
            participant.current_node_id = node_id
            node.setdefault("inputs", {})
            fn(node, participant)
            # every distributed node also learns the participant roster
            node["inputs"]["enabled_worker_ids"] = list(participant.enabled_worker_ids)
    return out
