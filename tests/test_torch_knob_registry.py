"""The port's knob registry held to the port's code and to the JAX registry.

- A static scan of comfyui_distributed_tpu_torch/ (every whole-string
  ``CDT_*`` constant, as the JAX package's lint finds knob reads) gives
  exactly the registry's names: no stale entry, none missing.
- Where a reading site states its default as a literal
  (``_env_int``/``_env_float``/``os.environ.get(name, default)``), the
  registry's default is that literal, rendered.
- Every knob the two packages share has the JAX registry's default, or
  stands in DIVERGENT_DEFAULTS with its reason.
- `resolved_knobs()` has the JAX shape: one {"value", "set"} entry a
  knob, the environment's value when set, the default otherwise.
"""

import ast
import os
import re

import pytest

from comfyui_distributed_tpu.telemetry import incidents as jincidents
from comfyui_distributed_tpu.utils import knob_registry as jregistry
from comfyui_distributed_tpu_torch.telemetry import incidents as tincidents
from comfyui_distributed_tpu_torch.utils import knob_registry as tregistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "comfyui_distributed_tpu_torch")
REGISTRY = os.path.join(PORT, "utils", "knob_registry.py")
_KNOB_RE = re.compile(r"CDT_[A-Z][A-Z0-9_]*$")

# knobs whose port default differs from the JAX registry's, and why
DIVERGENT_DEFAULTS = {
    "CDT_CONFIG_PATH": "the port's config file is cdt_torch_config.json in the working "
                       "directory (utils/config.py), not the JAX package's tpu_config.json",
}


def _port_sources():
    for root, _dirs, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                if path != REGISTRY:
                    yield path


def _reads() -> dict[str, list[str]]:
    sites: dict[str, list[str]] = {}
    for path in _port_sources():
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and _KNOB_RE.fullmatch(node.value):
                sites.setdefault(node.value, []).append(
                    f"{os.path.relpath(path, REPO)}:{node.lineno}")
    return sites


def test_the_registry_lists_exactly_the_knobs_the_port_reads():
    read = set(_reads())
    declared = [knob.name for knob in tregistry.KNOBS]
    assert len(declared) == len(set(declared)), "a knob is declared twice"
    assert read - set(declared) == set(), "read but not declared"
    assert set(declared) - read == set(), "declared but never read (stale)"
    # this slice's knobs are among them
    assert {"CDT_FLIGHT", "CDT_FLIGHT_EVENTS", "CDT_FLIGHT_SPANS", "CDT_INCIDENT_DIR",
            "CDT_INCIDENT_DEBOUNCE", "CDT_INCIDENT_MIN_INTERVAL", "CDT_INCIDENT_MAX",
            "CDT_INCIDENT_MAX_MB", "CDT_INCIDENT_WINDOW", "CDT_PROFILE_DIR",
            "CDT_PROFILE_MAX_SECONDS", "CDT_PROFILE_MAX", "CDT_PROFILE_MAX_MB",
            "CDT_PROFILE_AUTO", "CDT_PROFILE_AUTO_SECONDS"} <= set(declared)
    # the fault plan (resilience/faults.py), read by the transport and the
    # job store's seams
    assert "CDT_FAULT_PLAN" in declared
    # the durable control plane (durability/, the journal knobs of the
    # brownout and the SLO engine)
    assert {"CDT_JOURNAL_DIR", "CDT_JOURNAL_FSYNC", "CDT_JOURNAL_SEGMENT_BYTES",
            "CDT_SNAPSHOT_EVERY", "CDT_LEASE_TTL", "CDT_LEASE_PEERS", "CDT_STANDBY_BUFFER",
            "CDT_SHED_JOURNAL_P95", "CDT_SLO_JOURNAL_P95"} <= set(declared)
    assert len(declared) == 115


def _literal(node):
    """The value of a literal default expression (numbers, strings and
    arithmetic on them), else None."""
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Mult, ast.Add)):
        left, right = _literal(node.left), _literal(node.right)
        if isinstance(left, (int, float)) and isinstance(right, (int, float)):
            return left * right if isinstance(node.op, ast.Mult) else left + right
    return None


def _stated_defaults() -> dict[str, set]:
    """Knob -> the renderings the registry may give the default its
    reading site states as a literal (an empty string reads as "empty"
    or "unset")."""
    stated: dict[str, set] = {}
    for path in _port_sources():
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or len(node.args) != 2:
                continue
            name, default = node.args[0], _literal(node.args[1])
            if not (isinstance(name, ast.Constant) and isinstance(name.value, str)
                    and _KNOB_RE.fullmatch(name.value)) or default is None:
                continue
            func = node.func
            called = func.attr if isinstance(func, ast.Attribute) else getattr(func, "id", "")
            if called == "_env_float":
                stated[name.value] = {str(float(default))}
            elif called == "_env_int":
                stated[name.value] = {str(int(default))}
            elif called == "get" and isinstance(default, str):
                stated[name.value] = {default} if default else {"empty", "unset"}
    return stated


def test_the_registry_defaults_are_the_reading_sites_literals():
    stated = _stated_defaults()
    by_name = {knob.name: knob for knob in tregistry.KNOBS}
    assert len(stated) >= 70
    for name, renderings in stated.items():
        assert by_name[name].default in renderings, name


def test_shared_knobs_have_the_jax_default_or_a_stated_divergence():
    jax_knobs = {knob.name: knob for knob in jregistry.KNOBS}
    assert set(DIVERGENT_DEFAULTS) <= tregistry.knob_names()
    for knob in tregistry.KNOBS:
        assert knob.name in jax_knobs, f"{knob.name} has no JAX counterpart"
        jax_knob = jax_knobs[knob.name]
        if knob.name in DIVERGENT_DEFAULTS:
            assert knob.default != jax_knob.default, knob.name
        else:
            assert knob.default == jax_knob.default, knob.name
        assert knob.subsystem == jax_knob.subsystem, knob.name
        assert knob.effect, knob.name


def test_the_port_reads_fewer_knobs_than_the_jax_registry_lists():
    assert tregistry.knob_names() < jregistry.knob_names()
    grouped = tregistry.by_subsystem()
    assert sum(len(v) for v in grouped.values()) == len(tregistry.KNOBS)
    assert set(grouped) <= set(jregistry.by_subsystem())


@pytest.mark.parametrize("env", [{}, {"CDT_INCIDENT_MAX": "7", "CDT_CACHE": "1"}])
def test_resolved_knobs_have_the_jax_shape(monkeypatch, env):
    for knob in tregistry.KNOBS:
        monkeypatch.delenv(knob.name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    port, jax_ = tincidents.resolved_knobs(), jincidents.resolved_knobs()
    assert list(port) == [knob.name for knob in tregistry.KNOBS]
    for name, entry in port.items():
        assert set(entry) == set(jax_[name]) == {"value", "set"}
        if name in env:
            assert entry == jax_[name] == {"value": env[name], "set": True}
        else:
            assert entry == {"value": tregistry.KNOBS[list(port).index(name)].default,
                             "set": False}
