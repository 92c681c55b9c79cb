"""The port's scheduler control plane held to the JAX package's, decision
for decision, on the CPU.

The same scripted inputs, on injected clocks and without sleeps, go
through each JAX module and its port (scenarios after the JAX package's
tests/scheduler/*.py); the decisions must be equal:

- AdmissionQueue: the DRR grant order across lanes and weighted
  tenants, cost-weighted fairness, the 429 of a full lane and of a
  draining queue with their Retry-After, `estimate_wait` and
  `estimate_retry_after`, cancel, reprioritize and the snapshot;
- the exported state of either package restores in the other to the
  same status;
- PlacementPolicy: `batch_size` and `may_pull` after the same latency
  stream, capacities and breaker states; the store's grants through it;
- BrownoutController: the shed ladder, hysteresis and starvation decay;
- SchedulerControl: the deadline gate, the admission-cost seams
  (cold adapters, cache hits, measured cost) and the admission gap;
- PreemptionCoordinator over each package's store: flags, settle-time
  lifts with overlapping premiums, brownout eviction and what a flagged
  job's pulls answer.
"""

import asyncio
import collections

import pytest

from comfyui_distributed_tpu import scheduler as jsched
from comfyui_distributed_tpu.jobs.store import JobStore as JaxJobStore
from comfyui_distributed_tpu.resilience.health import HealthRegistry as JaxHealth
from comfyui_distributed_tpu.scheduler import preempt as jpreempt
from comfyui_distributed_tpu.telemetry import metrics as jmetrics
from comfyui_distributed_tpu.utils import constants as jconstants
from comfyui_distributed_tpu_torch import scheduler as tsched
from comfyui_distributed_tpu_torch.jobs.store import JobStore as PortJobStore
from comfyui_distributed_tpu_torch.resilience.health import HealthRegistry as PortHealth
from comfyui_distributed_tpu_torch.scheduler import preempt as tpreempt
from comfyui_distributed_tpu_torch.telemetry import metrics as tmetrics
from comfyui_distributed_tpu_torch.utils import constants as tconstants

SIDES = {
    "jax": {"sched": jsched, "store": JaxJobStore, "health": JaxHealth, "preempt": jpreempt,
            "constants": jconstants},
    "port": {"sched": tsched, "store": PortJobStore, "health": PortHealth, "preempt": tpreempt,
             "constants": tconstants},
}
LANES = [("interactive", 8), ("batch", 8), ("background", 8)]


@pytest.fixture(autouse=True)
def fresh_registries(monkeypatch):
    for metrics in (jmetrics, tmetrics):
        monkeypatch.setattr(metrics, "_registry", None)


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def both(scenario, *args):
    """(JAX decisions, port decisions) of one scripted scenario."""
    return tuple(scenario(SIDES[side], *args) for side in ("jax", "port"))


def _grant_order(queue, tickets, count):
    order = []
    for _ in range(count):
        (granted,) = [t for t in tickets if t.state == "granted"]
        order.append((granted.tenant, granted.lane, granted.ticket_id))
        queue.release(granted)
    return order


# --------------------------------------------------------------------------
# the admission queue
# --------------------------------------------------------------------------


def _drr(side, weights, costs):
    """Two lanes, three tenants: strict lane priority, DRR within a lane,
    on one grant slot; the full grant order."""

    async def run():
        clock = FakeClock()
        queue = side["sched"].AdmissionQueue(
            lanes=[("interactive", 10_000), ("batch", 10_000)], max_active=1,
            tenant_weights=weights, clock=clock)
        tickets = []
        for i in range(60):
            tickets.append(queue.submit("a", "interactive", cost=costs["a"]))
            tickets.append(queue.submit("b", "interactive", cost=costs["b"]))
            if i % 3 == 0:
                tickets.append(queue.submit("c", "batch", cost=1.0))
            clock.now += 0.001
        order = _grant_order(queue, tickets, len(tickets))
        return order, queue.snapshot()["totals"], queue.estimate_wait("batch")

    return asyncio.run(run())


@pytest.mark.parametrize("weights,costs", [
    ({"a": 3.0, "b": 1.0}, {"a": 1.0, "b": 1.0}),
    ({"a": 1.0, "b": 1.0}, {"a": 4.0, "b": 1.0}),
    ({"a": 2.5, "b": 0.5}, {"a": 3.0, "b": 0.25}),
], ids=["weights-3-to-1", "cost-weighted", "fractional"])
def test_the_drr_grant_order_is_the_jax_order(weights, costs):
    jax_out, port_out = both(_drr, weights, costs)
    assert port_out == jax_out
    order = [tenant for tenant, _, _ in port_out[0]]
    if weights == {"a": 3.0, "b": 1.0}:
        counts = collections.Counter(order[:80])
        assert abs(counts["a"] - 3 * counts["b"]) <= 8  # 3:1 within the interactive lane
    # strict priority: the batch lane is served only after interactive drains
    assert set(order[-20:]) == {"c"}


def _backpressure(side):
    """Pause, fill a lane, its 429; drain, its 503; cancel, reprioritize,
    the estimates on a fake timeline."""

    async def run():
        clock = FakeClock()
        sched = side["sched"]
        queue = sched.AdmissionQueue(lanes=[("interactive", 3), ("batch", 2)], max_active=1,
                                     clock=clock)
        out = []
        first = queue.submit("t", "interactive")
        clock.now += 2.0
        queue.release(first)  # one service sample: 2 s
        queue.pause()
        tickets = [queue.submit(t, "interactive") for t in ("x", "y", "z")]
        try:
            queue.submit("w", "interactive")
        except sched.SchedulerSaturated as exc:
            out.append(("full", exc.lane, exc.retry_after, type(exc).__name__))
        out.append(("typo", queue.submit("t", "typo").lane))
        out.append(("wait", queue.estimate_wait("interactive"),
                    queue.estimate_retry_after("interactive"), queue.estimate_wait("batch")))
        out.append(("cancel", queue.cancel(tickets[1]), queue.cancel(tickets[1]),
                    queue.cancel_ticket("t999"), tickets[1].state))
        out.append(("move", queue.reprioritize(tickets[2].ticket_id, "batch"),
                    queue.reprioritize("t999", "batch")))
        with pytest.raises(ValueError):
            queue.reprioritize(tickets[0].ticket_id, "nope")
        queue.set_weight("x", 2.0)
        queue.drain()
        try:
            queue.submit("t", "interactive")
        except sched.AdmissionClosed as exc:
            out.append(("closed", exc.retry_after, type(exc).__name__))
        clock.now += 1.0
        for _ in range(3):  # draining still grants what was admitted
            (granted,) = [t for t in [*tickets] if t.state == "granted"] or [None]
            if granted is None:
                break
            out.append(("granted", granted.ticket_id, granted.queue_wait_seconds))
            clock.now += 0.5
            queue.release(granted)
        snapshot = queue.snapshot()
        out.append(("snapshot", snapshot))
        return out

    return asyncio.run(run())


def test_full_lanes_drain_cancel_and_estimates_answer_as_the_jax_queue():
    jax_out, port_out = both(_backpressure)
    assert port_out == jax_out
    answers = dict((row[0], row[1:]) for row in port_out)
    # 2 s of service x (3 queued + 1) over one slot
    assert answers["full"] == ("interactive", 8.0, "SchedulerSaturated")
    assert answers["typo"] == ("batch",)
    assert answers["closed"][1] == "AdmissionClosed"


@pytest.mark.parametrize("source,target", [("jax", "port"), ("port", "jax")])
def test_exported_state_restores_in_the_other_package(source, target):
    async def exported(side):
        control = side["sched"].SchedulerControl(
            queue=side["sched"].AdmissionQueue(lanes=LANES, max_active=1,
                                               tenant_weights={"a": 3.0}, clock=FakeClock()))
        queue = control.queue
        queue.pause()
        for tenant, lane, cost in (("a", "interactive", 2.0), ("b", "interactive", 1.0),
                                   ("c", "batch", 5.0)):
            queue.submit(tenant, lane, cost=cost)
        queue.resume()
        for wid, sec in (("w1", 0.5), ("w1", 0.7), ("w2", 2.0), ("w2", 1.5)):
            control.placement.record_latency(wid, sec)
        control.placement.set_capacity("w2", 4)
        return control.export_state()

    state = asyncio.run(exported(SIDES[source]))

    def restored(side):
        control = side["sched"].SchedulerControl(
            queue=side["sched"].AdmissionQueue(lanes=LANES, max_active=1, clock=FakeClock()))
        control.restore_state(state)
        status = control.status()
        return (status["admission"]["tenant_weights"], status["admission"]["totals"],
                {lane["name"]: lane["tenants"] for lane in status["admission"]["lanes"]},
                status["placement"], status["worker_weights"],
                control.queue.lanes["interactive"].deficit)

    assert restored(SIDES[target]) == restored(SIDES[source])
    assert restored(SIDES[target])[3]["workers"]["w2"]["devices"] == 4


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------


def _placement(side):
    """The same latency stream, capacities and breaker states: every
    batch_size and may_pull decision along the way."""
    health = side["health"](failure_threshold=5, suspect_threshold=1, cooldown_seconds=30.0)
    policy = side["sched"].PlacementPolicy(health=health, min_samples=2, base_batch=2,
                                           max_batch=8, tail_tiles=3, trim_ratio=0.5)
    out = [("cold", policy.batch_size("w1", 10), policy.may_pull("w1", 2), policy.weights())]
    stream = [("w1", 0.4), ("w2", 1.6), ("w1", 0.5), ("w3", 0.9), ("w2", 2.4), ("w3", 0.8),
              ("w1", 0.3), ("w4", 4.0), ("w4", 5.0), ("master", 0.6), ("master", 0.7)]
    for i, (wid, sec) in enumerate(stream):
        policy.record_latency(wid, sec)
        if i == 5:
            policy.set_capacity("w3", 4)
        if i == 8:
            health.record_failure("w1")  # suspect
        out.append((i, {(w, r): (policy.batch_size(w, r), policy.may_pull(w, r))
                        for w in ("w1", "w2", "w3", "w4", "master", "new")
                        for r in (1, 3, 4, 9)},
                    policy.weights(), round(policy.per_chip_ratio("w3"), 9)))
    policy.forget("w2")
    out.append(("forgot", policy.weights(), policy.snapshot()))
    return out


def test_batch_size_and_may_pull_decide_as_the_jax_policy():
    jax_out, port_out = both(_placement)
    assert port_out == jax_out
    last = port_out[-2][1]
    assert last[("w3", 9)][0] > 1  # a 4-chip worker's grant
    assert last[("w1", 3)] == (1, False)  # suspect: trimmed from the tail
    assert last[("master", 3)][1] is True  # the master is never trimmed


def _grants(side):
    """A store wired to the placement policy: the grants each worker's
    pulls take, the trimmed and preempted answers, and the latency
    stream the store hands the sink."""

    async def run():
        store = side["store"]()
        health = side["health"](failure_threshold=5, suspect_threshold=1, cooldown_seconds=30.0)
        store.placement = side["sched"].PlacementPolicy(health=health, min_samples=1,
                                                        base_batch=2, max_batch=6, tail_tiles=2)
        seen = []
        store.latency_sink = lambda wid, sec: seen.append((wid, sec > 0))
        for wid, sec in (("fast", 0.05), ("fast", 0.05), ("slow", 0.5), ("slow", 0.5)):
            store.placement.record_latency(wid, sec)
        store.note_worker_capacity("quad", 4)
        store.note_worker_capacity("quad", "garbage")
        store.note_worker_capacity("huge", 10_000)
        await store.init_tile_job("job", list(range(12)))
        out = []
        for wid in ("fast", "slow", "quad", "fast", "master", "slow", "fast"):
            grant = await store.pull_tasks("job", wid, timeout=0.01)
            out.append((wid, grant))
        health.record_failure("slow")
        out.append(("trimmed", await store.pull_task("job", "slow", timeout=0.01)))
        out.append(("limit", await store.pull_tasks("job", "master", timeout=0.01, limit=1)))
        job = await store.get_tile_job("job")
        for wid, tids in sorted(job.assigned.items()):
            await store.submit_flush("job", wid, {t: None for t in sorted(tids)})
        out.append(("capacity", dict(store.worker_capacity), store.placement.capacity("huge")))
        out.append(("sink", sorted(seen)))
        out.append(("pulls", _pull_outcomes(side)))
        return out

    return asyncio.run(run())


def _pull_outcomes(side):
    """The cdt_store_pulls_total lines of the side's exposition."""
    metrics = jmetrics if side is SIDES["jax"] else tmetrics
    return [line for line in metrics.get_metrics_registry().render().splitlines()
            if line.startswith(("cdt_store_pulls_total", "cdt_worker_tile_seconds_count"))]


def test_the_store_grants_as_the_jax_store_with_placement():
    jax_out, port_out = both(_grants)
    assert port_out == jax_out
    grants = dict(port_out[:7])
    assert len(port_out[0][1]) == 4 and len(port_out[1][1]) == 1  # fast 4, slow 1
    assert port_out[7] == ("trimmed", None)
    assert any(len(g) > 1 for _, g in port_out[:7]) and grants


# --------------------------------------------------------------------------
# brownout and the control's admission gates
# --------------------------------------------------------------------------


class Payload:
    def __init__(self, lane=None, tenant="t", deadline_s=None, extra=None, adapters=()):
        self.lane = lane
        self.tenant = tenant
        self.trace_id = None
        self.deadline_s = deadline_s
        self.extra = extra or {}
        self.adapters = list(adapters)


def _brownout(side):
    """Overload, shed, starvation decay, hysteresis and the deadline gate
    through SchedulerControl.submit_payload on a fake clock."""

    async def run():
        sched = side["sched"]
        clock = FakeClock()
        queue = sched.AdmissionQueue(lanes=LANES, max_active=1, clock=clock)
        brownout = sched.BrownoutController(queue.lane_order, wait_p95_threshold=1.0,
                                            journal_p95_threshold=0.5, cooldown=1.0,
                                            clock=clock)
        control = sched.SchedulerControl(queue=queue, brownout=brownout, clock=clock)
        fired = []
        brownout.preempt_hook = lambda level, lanes: fired.append((level, list(lanes)))
        out = []

        def submit(lane, **kw):
            try:
                ticket = control.submit_payload(Payload(lane=lane, **kw))
                return ("admitted", ticket.lane, ticket.cost)
            except sched.DeadlineUnmeetable as exc:
                return ("deadline", exc.lane, exc.retry_after, round(exc.estimated_wait, 6))
            except sched.SchedulerOverloaded as exc:
                return ("shed", exc.lane, exc.retry_after)
            except sched.SchedulerSaturated as exc:
                return ("full", exc.lane)

        out.append(submit("background", deadline_s=0.5))  # idle: no wait, passes
        for step in range(12):
            clock.now += 1.1
            for _ in range(6):
                brownout.note_queue_wait(3.0 if step < 5 else 0.1)
            if step == 3:
                brownout.note_journal_append(2.0)
            out.append((step, brownout.evaluate(), brownout.shed_lanes(),
                        submit("background"), submit("batch"), submit("interactive"),
                        brownout.snapshot()))
        clock.now += 50.0  # no signal for 2x the cooldown while shedding
        out.append(("starved", brownout.evaluate(), brownout.snapshot()))
        out.append(("deadline", submit("interactive", deadline_s=0.01),
                    submit("interactive", deadline_s=1e6)))
        out.append(("fired", fired, dict(brownout.shed_counts)))
        return out

    return asyncio.run(run())


def test_brownout_levels_and_the_deadline_gate_decide_as_the_jax_control():
    jax_out, port_out = both(_brownout)
    assert port_out == jax_out
    levels = [row[1] for row in port_out[1:13]]
    # two lanes shed at most (never the premium one); the journal sample
    # holds the level until its signal starves, then it steps down
    assert max(levels) == 2 and port_out[13][1] == 1
    assert port_out[-2][1][0] == "deadline"


def _admission_costs(side, monkeypatch):
    """The cost seams of submit_payload: estimated tiles, the measured
    cost ratio (CDT_USAGE_COST), cold adapters (CDT_ADAPTER_COLD_COST),
    the cache-hit discount (CDT_CACHE_COST) and the admission gap."""

    async def run():
        sched = side["sched"]
        constants = side["constants"]
        monkeypatch.setattr(constants, "USAGE_COST_ENABLED", True)
        control = sched.SchedulerControl(
            queue=sched.AdmissionQueue(lanes=LANES, max_active=64, clock=FakeClock()))
        control.usage_cost = lambda tenant: {"heavy": 2.5, "broken": float("nan")}.get(tenant,
                                                                                        1.0)
        cold = type("Spec", (), {"content_hash": "f" * 64})()
        out = []
        for tenant, extra, adapters in (("light", {"estimated_tiles": 4}, ()),
                                        ("heavy", {"estimated_tiles": 4}, ()),
                                        ("broken", {"estimated_tiles": "x"}, ()),
                                        ("light", {}, (cold,)),
                                        ("cached", {"estimated_tiles": 8}, ())):
            out.append((tenant, control.submit_payload(
                Payload(tenant=tenant, extra=extra, adapters=adapters)).cost))
        out.append(("gap", control.note_cache_settled("cached", 6),
                    control.note_cache_settled("unknown", 2), control.note_cache_settled("x", 0)))
        out.append(("discounted", control.submit_payload(
            Payload(tenant="cached", extra={"estimated_tiles": 8})).cost))
        out.append(("status", control.status()["unsettled_admission_cost"]))
        return out

    monkeypatch.setenv("CDT_ADAPTER_COLD_COST", "3.0")
    monkeypatch.setenv("CDT_CACHE_COST", "1")
    return asyncio.run(run())


def test_admission_cost_seams_charge_as_the_jax_control(monkeypatch):
    jax_out, port_out = both(_admission_costs, monkeypatch)
    assert port_out == jax_out
    costs = dict(port_out[:5])
    assert costs["heavy"] == 10.0 and costs["broken"] == 1.0
    assert dict(port_out[3:4])["light"] == 3.0  # a cold adapter pays CDT_ADAPTER_COLD_COST


# --------------------------------------------------------------------------
# preemption over each package's store
# --------------------------------------------------------------------------


def _preemption(side, monkeypatch):
    async def run():
        store = side["store"]()
        coord = side["preempt"].PreemptionCoordinator(["premium", "interactive", "batch"],
                                                      store, enabled=True)
        store.preempt_policy = coord
        out = [("rank", coord.lane_rank("premium"), coord.lane_rank("batch"),
                coord.lane_rank(""), coord.lane_rank("typo"))]
        await store.init_tile_job("jb", [0, 1, 2], lane="batch")
        await store.init_tile_job("ji", [0], lane="interactive")
        await store.init_tile_job("jp1", [0], lane="premium")
        await store.init_tile_job("jp2", [0], lane="premium")

        async def flags():
            return {j: (job.preempt_requested, job.preempt_reason)
                    for j, job in sorted(store.tile_jobs.items())}

        out.append(("flagged", await flags(), coord.snapshot()))
        out.append(("pull", await store.pull_task("jb", "w1", timeout=0.01),
                    await store.pull_tasks("jb", "w1", timeout=0.01)))
        await store.cleanup_tile_job("jp1")  # jp2 still claims the victims
        out.append(("one settled", await flags()))
        await store.cancel_job("jp2")  # the last premium: the flags lift
        out.append(("lifted", await flags(), coord.snapshot()))
        out.append(("pull after", await store.pull_tasks("jb", "w1", timeout=0.01)))
        monkeypatch.setattr(side["constants"], "PREEMPT_BROWNOUT_LEVEL", 1)
        out.append(("brownout", await coord.on_brownout(1, ["batch"]), await flags()))
        out.append(("recovered", await coord.on_brownout(0, []), await flags()))
        out.append(("manual", await store.request_preemption(["ji", "nope"], reason="manual"),
                    await store.clear_preemption(["ji"]), await store.preempt_victims(0)))
        return out

    return asyncio.run(run())


def test_preemption_flags_and_lifts_as_the_jax_coordinator(monkeypatch):
    jax_out, port_out = both(_preemption, monkeypatch)
    assert port_out == jax_out
    flagged = port_out[1][1]
    assert flagged["jb"] == (True, "premium_arrival") and flagged["jp1"] == (False, "")
    assert port_out[2][1:] == (None, [])  # a flagged job's pulls read as drained
    assert port_out[4][1]["jb"] == (False, "")
