"""Adapter catalog and identity: request names → content-hashed sources.

The port's own copy of comfyui_distributed_tpu/adapters/registry.py.
Requests name adapters (`adapters: [{name, strength}]` in the queue
payload); everything past admission speaks the blake2b content hash
instead: the tile cache key and the worker's verification. Two files
with the same name but different bytes never alias.

Resolution follows the LoraLoader convention (graph/nodes_core.py): an
absolute path, or `CDT_LORA_DIR/<name>[.safetensors]`. Tests and the
smoke run may register in-memory state dicts instead
(`register_memory`). A request's names (`resolve_request`, the queue
route) reach registrations and CDT_LORA_DIR only, never a path.

Workers re-resolve names against their OWN catalog and verify that the
master-stamped hash matches before sampling: a fleet with divergent
adapter files fails loudly (AdapterError) instead of sampling wrong.

State dicts are numpy ({key: ndarray}), framework-neutral: the hashes
equal the JAX package's for the same bytes.
"""

from __future__ import annotations

import hashlib
import math
import os
import threading
from dataclasses import dataclass, replace
from typing import Any

import numpy as np

# Bound per-request adapter stacks: operand concat grows the effective
# rank additively (segmented.compose_operands re-buckets the concat).
MAX_ADAPTERS_PER_REQUEST = 4

_HASH_BYTES = 16  # 32 hex chars


class AdapterError(ValueError):
    """Invalid adapter request (unknown name, bad spec, hash mismatch,
    unsupported rank). The queue route answers it 400 at admission; a
    worker fails the job on it: an unresolved adapter never samples the
    base model silently."""


@dataclass(frozen=True)
class AdapterSpec:
    """One requested adapter. `content_hash` is empty until the catalog
    stamps it (`resolve`)."""

    name: str
    strength: float = 1.0
    content_hash: str = ""


def parse_adapter_specs(raw: Any) -> list[AdapterSpec]:
    """Validate the payload's `adapters` field → specs: None or [] (no
    adapters), a list of {"name", "strength"?, "content_hash"?} objects
    or bare name strings (strength 1.0). AdapterError names the field."""
    if raw is None:
        return []
    if not isinstance(raw, (list, tuple)):
        raise AdapterError("adapters must be a list of {name, strength}")
    if len(raw) > MAX_ADAPTERS_PER_REQUEST:
        raise AdapterError(
            f"adapters lists at most {MAX_ADAPTERS_PER_REQUEST} entries (got {len(raw)})")
    specs: list[AdapterSpec] = []
    seen: set[str] = set()
    for i, entry in enumerate(raw):
        if isinstance(entry, str):
            entry = {"name": entry}
        if not isinstance(entry, dict):
            raise AdapterError(f"adapters[{i}] must be an object or string")
        name = entry.get("name")
        if not isinstance(name, str) or not name.strip():
            raise AdapterError(f"adapters[{i}].name must be a non-empty string")
        name = name.strip()
        if name in seen:
            raise AdapterError(f"adapters[{i}].name {name!r} repeats")
        seen.add(name)
        strength = entry.get("strength", 1.0)
        if isinstance(strength, bool) or not isinstance(strength, (int, float)):
            raise AdapterError(f"adapters[{i}].strength must be a number")
        strength = float(strength)
        if not math.isfinite(strength):
            raise AdapterError(f"adapters[{i}].strength must be finite")
        content_hash = entry.get("content_hash", "")
        if not isinstance(content_hash, str):
            raise AdapterError(f"adapters[{i}].content_hash must be a string")
        specs.append(AdapterSpec(name, strength, content_hash))
    return specs


def specs_to_wire(specs: list[AdapterSpec]) -> list[dict[str, Any]]:
    """Specs → the JSON wire form (the job_status answer)."""
    return [{"name": s.name, "strength": float(s.strength), "content_hash": s.content_hash}
            for s in specs]


def specs_from_wire(raw: Any) -> list[AdapterSpec]:
    """Wire form → specs, validated as a request is: a corrupt record
    raises instead of sampling wrong."""
    return parse_adapter_specs(raw)


def adapter_plan_key(specs: list[AdapterSpec]) -> tuple:
    """The content identity of a RESOLVED plan: ((content_hash,
    strength), ...) in request order (strength and order both change
    the output). What joins the tile cache key. () = no adapters."""
    for s in specs:
        if not s.content_hash:
            raise AdapterError(f"adapter {s.name!r} has no content hash (unresolved plan)")
    return tuple((s.content_hash, float(s.strength)) for s in specs)


def _hash_state_dict(state: dict[str, Any]) -> str:
    """Content hash of an in-memory kohya state dict: sorted keys, dtype
    + shape + C-order bytes per tensor (the JAX package's definition)."""
    h = hashlib.blake2b(digest_size=_HASH_BYTES)
    for key in sorted(state):
        arr = np.asarray(state[key])
        h.update(key.encode("utf-8"))
        h.update(b"\x00")
        h.update(str(arr.dtype).encode("ascii"))
        h.update(b"\x00")
        h.update(",".join(str(d) for d in arr.shape).encode("ascii"))
        h.update(b"\x00")
        h.update(np.ascontiguousarray(arr).tobytes())
        h.update(b"\x01")
    return h.hexdigest()


def _hash_file(path: str) -> str:
    h = hashlib.blake2b(digest_size=_HASH_BYTES)
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(1 << 20)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def resolve_lora_path(name: str) -> str | None:
    """The LoraLoader file convention: an absolute path, or
    CDT_LORA_DIR/<name>, with `.safetensors` appended when the bare name
    is no file. None when nothing exists there."""
    path = str(name)
    if not os.path.isabs(path):
        root = os.environ.get("CDT_LORA_DIR", "")
        candidate = os.path.join(root, path) if root else path
        if not os.path.exists(candidate) and not candidate.endswith(".safetensors"):
            candidate += ".safetensors"
        path = candidate
    return path if os.path.exists(path) else None


class AdapterCatalog:
    """name → source, with cached content hashes. Registrations (file or
    memory) win over the CDT_LORA_DIR scan, which is sorted."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # name → ("file", path) | ("memory", state dict)
        self._entries: dict[str, tuple[str, Any]] = {}
        self._hashes: dict[str, str] = {}

    def register_file(self, name: str, path: str) -> None:
        if not os.path.exists(path):
            raise AdapterError(f"adapter file not found: {path}")
        with self._lock:
            self._entries[str(name)] = ("file", str(path))
            self._hashes.pop(str(name), None)

    def register_memory(self, name: str, state: dict[str, Any]) -> None:
        with self._lock:
            self._entries[str(name)] = ("memory", {k: np.asarray(v) for k, v in state.items()})
            self._hashes.pop(str(name), None)

    def names(self) -> list[str]:
        """Registrations plus the stems of CDT_LORA_DIR/*.safetensors."""
        found = set()
        root = os.environ.get("CDT_LORA_DIR", "")
        if root and os.path.isdir(root):
            found.update(entry[: -len(".safetensors")] for entry in sorted(os.listdir(root))
                         if entry.endswith(".safetensors"))
        with self._lock:
            found.update(self._entries)
        return sorted(found)

    def _source(self, name: str) -> tuple[str, Any]:
        with self._lock:
            entry = self._entries.get(name)
        if entry is not None:
            return entry
        path = resolve_lora_path(name)
        if path is None:
            raise AdapterError(f"unknown adapter {name!r}")
        return ("file", path)

    def content_hash(self, name: str) -> str:
        with self._lock:
            cached = self._hashes.get(name)
        if cached is not None:
            return cached
        kind, source = self._source(name)
        digest = _hash_file(source) if kind == "file" else _hash_state_dict(source)
        with self._lock:
            self._hashes[name] = digest
        return digest

    def load_state_dict(self, name: str) -> dict[str, np.ndarray]:
        kind, source = self._source(name)
        if kind == "memory":
            return dict(source)
        from ..models.lora import read_lora

        return read_lora(source)

    def resolve_request(self, specs: list[AdapterSpec]) -> list[AdapterSpec]:
        """`resolve` for the names a request sends: each must be a
        registration or a file of CDT_LORA_DIR by its name. A path (an
        absolute one, one with a separator, "." or "..") is refused
        before any file is opened; LoraLoader, inside a workflow, keeps
        the path convention."""
        for spec in specs:
            with self._lock:
                registered = spec.name in self._entries
            if registered:
                continue
            name = spec.name
            if os.path.isabs(name) or "/" in name or "\\" in name or os.sep in name \
                    or name in (".", "..") or "\x00" in name:
                raise AdapterError(f"adapter {name!r}: a request names a registered adapter "
                                   "or a file of CDT_LORA_DIR, not a path")
            root = os.environ.get("CDT_LORA_DIR", "")
            if not root or not any(os.path.isfile(os.path.join(root, candidate))
                                   for candidate in (name, name + ".safetensors")):
                raise AdapterError(f"unknown adapter {name!r}")
        return self.resolve(specs)

    def resolve(self, specs: list[AdapterSpec]) -> list[AdapterSpec]:
        """Stamp content hashes onto specs. A spec arriving WITH a hash
        (worker side: the master stamped it) is verified against this
        host's resolution; a mismatch raises."""
        resolved: list[AdapterSpec] = []
        for spec in specs:
            digest = self.content_hash(spec.name)
            if spec.content_hash and spec.content_hash != digest:
                raise AdapterError(
                    f"adapter {spec.name!r} content mismatch: master has {spec.content_hash}, "
                    f"this host resolved {digest}")
            resolved.append(replace(spec, content_hash=digest))
        return resolved


_CATALOG = AdapterCatalog()


def get_adapter_catalog() -> AdapterCatalog:
    return _CATALOG


def set_adapter_catalog(catalog: AdapterCatalog) -> AdapterCatalog:
    """Install a catalog; returns the previous one so a caller can put
    it back."""
    global _CATALOG
    previous, _CATALOG = _CATALOG, catalog
    return previous
