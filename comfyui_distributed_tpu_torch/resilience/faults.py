"""Deterministic, seeded fault injection for chaos testing.

The port's own copy of comfyui_distributed_tpu/resilience/faults.py. A
`FaultInjector` is parsed from a *fault plan* string (env var
`CDT_FAULT_PLAN`) and consulted at instrumented call sites: the HTTP
transport (utils/network.py: every GET and POST of `request_json` and
`request_bytes`) and the `JobStore` (jobs/store.py checks pull, submit
and heartbeat ops). The in-process chaos harness (resilience/chaos.py)
adds worker-loop sites (`chaos:<worker>:pull` / `pulled` / `submit`).

Plan grammar (rules joined with ';')::

    plan   := rule (';' rule)*
    rule   := 'seed=' INT
            | FAULT ['(' NUMBER ')'] '@' PATTERN [SCHEDULE]
    SCHEDULE := '#' OCC (',' OCC)*        occurrence schedule (1-based)
              | '%' FLOAT                 per-match probability (seeded)
    OCC    := INT | INT '-' INT | '*'

    FAULT  := 'connect_error'   transport-level connection failure
            | 'http500'         server error response (transport sites)
            | 'latency'         sleep NUMBER seconds, then proceed
            | 'drop'            swallow the operation (fire-and-forget
                                sites: heartbeats). At request/response
                                sites the caller sees an empty OK, so a
                                dropped pull reads as queue-drained:
                                model a lost REQUEST with connect_error
            | 'crash'           kill the participant at this site

`PATTERN` matches operation names (glob if it contains ``*?[``,
substring otherwise). Operation names are hierarchical strings such as
``http:POST:/distributed/request_image``, ``store:pull:w1``,
``store:heartbeat:w1``, ``chaos:w1:pulled``. Without a schedule a rule
fires on its FIRST match only (``#1``); ``#*`` fires on every match.

Examples::

    CDT_FAULT_PLAN='seed=7;crash@chaos:w1:pulled#2'
        worker w1 crashes right after pulling its 2nd tile

    CDT_FAULT_PLAN='connect_error@http:POST:/distributed/submit_tiles#1-3'
        the first three tile submissions fail at the transport

    CDT_FAULT_PLAN='seed=3;latency(0.2)@request_image%0.5'
        every pull has a seeded 50% chance of a 200 ms latency spike

Determinism: occurrence counting is per rule, and probabilistic rules
draw from a per-rule `random.Random` seeded with seed * 1000003 + the
rule's index, as in the JAX package: two injectors built from the same
plan, in either package, observe identical fault sequences for
identical op sequences.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import os
import random
import re
import threading
import time
from typing import Optional

from ..utils.exceptions import DistributedError
from ..utils.logging import debug_log

FAULT_KINDS = ("connect_error", "http500", "latency", "drop", "crash")

ENV_FAULT_PLAN = "CDT_FAULT_PLAN"

_RULE_RE = re.compile(
    r"^(?P<kind>[a-z_0-9]+)"
    r"(?:\((?P<arg>[^)]*)\))?"
    r"@(?P<pattern>[^#%]+)"
    r"(?:#(?P<occ>[0-9,\-*]+)|%(?P<prob>[0-9.]+))?$"
)


class FaultInjected(DistributedError):
    """Raised at a call site the active fault plan targets."""

    def __init__(self, kind: str, op: str):
        super().__init__(f"injected fault {kind!r} at {op!r}")
        self.kind = kind
        self.op = op


class FaultPlanError(DistributedError):
    """The CDT_FAULT_PLAN string does not parse."""


@dataclasses.dataclass(frozen=True)
class FaultRule:
    kind: str
    pattern: str
    arg: Optional[float] = None
    occurrences: Optional[frozenset[int]] = None  # None + no probability = {1}
    all_matches: bool = False
    probability: Optional[float] = None

    def matches(self, op: str) -> bool:
        if any(c in self.pattern for c in "*?["):
            return fnmatch.fnmatchcase(op, self.pattern)
        return self.pattern in op

    def fires(self, nth_match: int, rng: random.Random) -> bool:
        if self.probability is not None:
            return rng.random() < self.probability
        if self.all_matches:
            return True
        occ = self.occurrences if self.occurrences is not None else frozenset({1})
        return nth_match in occ


@dataclasses.dataclass(frozen=True)
class FaultAction:
    kind: str
    op: str
    arg: Optional[float] = None


def _occurrences(text: str, part: str) -> frozenset[int]:
    """The occurrence numbers of a '#' schedule other than '*'."""
    occ: set[int] = set()
    for piece in text.split(","):
        piece = piece.strip()
        if not piece:
            continue
        try:
            if "-" in piece:
                lo, _, hi = piece.partition("-")
                occ.update(range(int(lo), int(hi) + 1))
            else:
                occ.add(int(piece))
        except ValueError as exc:
            raise FaultPlanError(f"bad occurrence {piece!r} in {part!r}") from exc
    return frozenset(occ)


def parse_fault_plan(text: str) -> tuple[int, list[FaultRule]]:
    """Parse a plan string into (seed, rules); raises FaultPlanError."""
    seed = 0
    rules: list[FaultRule] = []
    for raw in text.split(";"):
        part = raw.strip()
        if not part:
            continue
        if part.startswith("seed="):
            try:
                seed = int(part[len("seed="):])
            except ValueError as exc:
                raise FaultPlanError(f"bad seed in fault plan: {part!r}") from exc
            continue
        m = _RULE_RE.match(part)
        if m is None:
            raise FaultPlanError(f"unparseable fault rule: {part!r}")
        kind = m.group("kind")
        if kind not in FAULT_KINDS:
            raise FaultPlanError(
                f"unknown fault kind {kind!r} (known: {', '.join(FAULT_KINDS)})")
        arg = None
        if m.group("arg"):
            try:
                arg = float(m.group("arg"))
            except ValueError as exc:
                raise FaultPlanError(f"bad fault arg in {part!r}") from exc
        occurrences: Optional[frozenset[int]] = None
        all_matches = False
        probability = None
        if m.group("occ") is not None:
            if m.group("occ") == "*":
                all_matches = True
            else:
                occurrences = _occurrences(m.group("occ"), part)
        elif m.group("prob") is not None:
            try:
                probability = float(m.group("prob"))
            except ValueError as exc:
                raise FaultPlanError(f"bad probability in {part!r}") from exc
        rules.append(FaultRule(kind=kind, pattern=m.group("pattern").strip(), arg=arg,
                               occurrences=occurrences, all_matches=all_matches,
                               probability=probability))
    return seed, rules


class FaultInjector:
    """Consults a parsed plan at named call sites; thread-safe."""

    def __init__(self, plan: str):
        self.plan = plan
        self.seed, self.rules = parse_fault_plan(plan)
        self._lock = threading.Lock()
        self._counters = [0] * len(self.rules)
        # stable per-rule streams (not hash(): randomised per process)
        self._rngs = [random.Random(self.seed * 1000003 + idx) for idx in range(len(self.rules))]
        self.fired: list[FaultAction] = []

    def hit(self, op: str) -> Optional[FaultAction]:
        """Pure decision: does any rule fire for this op occurrence? Every
        matching rule's counter advances; the first firing rule wins (rule
        order = plan order)."""
        with self._lock:
            fired: Optional[FaultAction] = None
            for idx, rule in enumerate(self.rules):
                if not rule.matches(op):
                    continue
                self._counters[idx] += 1
                if fired is None and rule.fires(self._counters[idx], self._rngs[idx]):
                    fired = FaultAction(kind=rule.kind, op=op, arg=rule.arg)
            if fired is not None:
                self.fired.append(fired)
        if fired is not None:
            debug_log(f"fault injected: {fired.kind} at {op}")
        return fired

    def matches(self) -> list[int]:
        """How many ops each rule has matched so far, in plan order (what
        its schedule was held against)."""
        with self._lock:
            return list(self._counters)

    async def check(self, op: str) -> Optional[FaultAction]:
        """Async call-site helper: applies latency, raises for the error
        and crash kinds, returns the action for 'drop' (the site decides
        what swallowing means)."""
        action = self.hit(op)
        if action is None:
            return None
        if action.kind == "latency":
            import asyncio

            await asyncio.sleep(action.arg or 0.0)
            return action
        if action.kind == "drop":
            return action
        raise FaultInjected(action.kind, op)

    def check_blocking(self, op: str) -> Optional[FaultAction]:
        """Sync twin of `check` for worker threads."""
        action = self.hit(op)
        if action is None:
            return None
        if action.kind == "latency":
            time.sleep(action.arg or 0.0)
            return action
        if action.kind == "drop":
            return action
        raise FaultInjected(action.kind, op)


# --- the process-wide (env-driven) injector ---------------------------------

_env_injector: FaultInjector | None = None
_env_plan: str | None = None
_override: FaultInjector | None = None
_has_override = False
_global_lock = threading.Lock()


def get_fault_injector() -> Optional[FaultInjector]:
    """The process-wide injector: an explicit override if set, else one
    built (and cached) from CDT_FAULT_PLAN; None when no plan is active,
    so an uninstrumented run pays one lookup."""
    global _env_injector, _env_plan
    with _global_lock:
        if _has_override:
            return _override
        plan = os.environ.get(ENV_FAULT_PLAN, "").strip()
        if not plan:
            _env_injector, _env_plan = None, None
            return None
        if _env_injector is None or _env_plan != plan:
            _env_injector = FaultInjector(plan)
            _env_plan = plan
        return _env_injector


def set_fault_injector(injector: Optional[FaultInjector]) -> None:
    """Install an explicit injector (the chaos harness, tests, chip_smoke.py);
    it overrides the env plan until `reset_fault_injector`."""
    global _override, _has_override
    with _global_lock:
        _override = injector
        _has_override = True


def reset_fault_injector() -> None:
    """Drop any override and the env-plan cache."""
    global _override, _has_override, _env_injector, _env_plan
    with _global_lock:
        _override = None
        _has_override = False
        _env_injector = None
        _env_plan = None
