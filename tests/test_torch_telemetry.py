"""The port's telemetry plane held to the JAX package's, on the CPU.

- The same operations on both metrics registries give byte-equal
  Prometheus exposition text (counters, gauges, histograms, label
  escaping, the series cap, scrape-time collectors).
- The same nested spans on both tracers give equal span trees, apart
  from ids and times.
- The same dispatch stream through both usage meters and both transfer
  ledgers gives equal rollups, and the conservation identity is exact.
- The port's metric families are a subset of the JAX package's, with the
  same kind, help and label names (one help text reworded, listed in
  REWORDED_HELP); the JAX-only families are listed by the step that
  brings them (STILL_TO_PORT).
- The routes: /distributed/metrics of a port master and a JAX master
  after the same store operations; trace, traces, cache, fleet, alerts
  and usage (with their `since` checks); a plain GET of the event stream
  is refused with the JAX route's status; /distributed/durability
  answers a master without a journal as the JAX route does.
- The same tiny-unet elastic upscale, master + w1 on loopback through
  each package's own servers, twice with a tile cache installed (the
  second run settles every tile from the cache), gives the same families
  and label names, equal deterministic counters, and one connected span
  tree per execution in each package.
"""

import asyncio
import inspect
import itertools
import json
import math
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.telemetry import instruments as jinstruments
from comfyui_distributed_tpu.telemetry import metrics as jmetrics
from comfyui_distributed_tpu.telemetry import profiling as jprofiling
from comfyui_distributed_tpu.telemetry import tracing as jtracing
from comfyui_distributed_tpu.telemetry import usage as jusage
from comfyui_distributed_tpu_torch.telemetry import instruments as tinstruments
from comfyui_distributed_tpu_torch.telemetry import metrics as tmetrics
from comfyui_distributed_tpu_torch.telemetry import profiling as tprofiling
from comfyui_distributed_tpu_torch.telemetry import tracing as ttracing
from comfyui_distributed_tpu_torch.telemetry import usage as tusage

from test_torch_parity import one_torch_thread, port_loop  # noqa: F401  (fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The JAX package's metric families the port does not register yet, by
# the ROADMAP step that brings each.
STILL_TO_PORT = {
    "step 7g: standby masters (their replication lag)": {
        "cdt_replication_lag_records", "cdt_replication_lag_seconds",
    },
    "item 6: the multi-GPU tier (mesh)": {
        "cdt_mesh_devices", "cdt_mesh_batch_share", "cdt_mesh_gather_seconds",
    },
    "item 4b: the cross-job tier and K > 1 tile batches": {
        "cdt_batch_fill_ratio", "cdt_preempt_resume_total", "cdt_pipeline_padded_tiles_total",
        "cdt_adapter_slots_total",
    },
    "no counterpart: XLA compiles and its compilation cache": {
        "cdt_jax_compiles", "cdt_jax_compile_time_seconds", "cdt_jax_cache_hits",
        "cdt_jax_cache_misses",
    },
}


# The port's families whose help text is worded apart from the JAX
# package's (the JAX text cites the package's change history and a
# runbook the port does not carry; the port's captures are torch.profiler
# ones); name, kind and labels are the JAX family's.
REWORDED_HELP = {
    "cdt_cache_unsettled_admission_cost":
        "Cumulative DRR admission cost charged for tiles that later settled free from the "
        "tile cache at grant time — the full-cost-until-settle gap, surfaced so operators "
        "can see how much fair-share weight cached tenants are over-paying",
    "cdt_profile_captures_total":
        "On-demand torch.profiler captures by outcome (started|stopped|busy|errors|"
        "auto_stopped), mirrored by delta from the capture manager's counters at scrape time",
}


# --------------------------------------------------------------------------
# exposition
# --------------------------------------------------------------------------


def _script_fixed(reg):
    """Every instrument kind, label escaping, non-integer and infinite
    values, removal and clearing, histogram edges and overflow."""
    pulls = reg.counter("cdt_demo_pulls_total", "Pulls by outcome", ("worker_id", "outcome"))
    pulls.inc(worker_id="w1", outcome="task")
    pulls.inc(2.5, worker_id='w"2\\x\n', outcome="empty")
    pulls.inc(0, worker_id="w1", outcome="task")
    depth = reg.gauge("cdt_demo_depth", "Depth per server", ("server",))
    depth.set(3, server="master:1")
    depth.inc(0.25, server="master:1")
    depth.dec(1, server="worker:2")
    depth.set(7, server="gone")
    depth.remove(server="gone")
    ratio = reg.gauge("cdt_demo_ratio", "A ratio")
    ratio.set(float("inf"))
    cleared = reg.gauge("cdt_demo_cleared", "Cleared", ("k",))
    cleared.set(1, k="a")
    cleared.clear()
    hist = reg.histogram("cdt_demo_seconds", "Default buckets", ("stage", "role"))
    for value in (0.0, 0.001, 0.0011, 0.05, 1.0, 59.9, 60.0, 61.0, 1e9):
        hist.observe(value, stage="sample", role="master")
    hist.observe(0.3, stage="encode", role="worker")
    custom = reg.histogram("cdt_demo_bytes", "Custom buckets", (), buckets=(10, 1, 100.5))
    for value in (0.5, 1, 10, 10.5, 100.5, 1000):
        custom.observe(value)


def _script_random(reg, seed: int):
    """A seeded stream of operations over a small vocabulary."""
    rng = np.random.default_rng(seed)
    counter = reg.counter("cdt_rand_total", "Random counter", ("worker_id", "outcome"))
    gauge = reg.gauge("cdt_rand_gauge", "Random gauge", ("server",))
    hist = reg.histogram("cdt_rand_seconds", "Random histogram", ("role",))
    for _ in range(300):
        op = int(rng.integers(0, 5))
        worker = f"w{int(rng.integers(0, 4))}"
        if op == 0:
            counter.inc(float(rng.integers(0, 4)), worker_id=worker,
                        outcome=("task", "empty")[int(rng.integers(0, 2))])
        elif op == 1:
            gauge.set(float(rng.normal()), server=worker)
        elif op == 2:
            gauge.inc(float(rng.random()), server=worker)
        elif op == 3:
            hist.observe(float(rng.exponential(0.5)), role=("master", "worker")[int(
                rng.integers(0, 2))])
        else:
            counter.inc(worker_id=worker, outcome="cancelled")


def _script_overflow(reg):
    """More label sets than the cap: the rest collapse into _overflow and
    the registry's overflow counter counts them."""
    counter = reg.counter("cdt_capped_total", "Capped", ("worker_id",))
    hist = reg.histogram("cdt_capped_seconds", "Capped histogram", ("worker_id",))
    for i in range(7):
        counter.inc(worker_id=f"w{i}")
        hist.observe(0.01 * i, worker_id=f"w{i}")


def _script_collectors(reg):
    """Scrape-time collectors fill gauges; a broken one does not take the
    scrape down."""
    gauge = reg.gauge("cdt_live_depth", "Live depth", ("server",))
    state = {"n": 0}

    def collect():
        state["n"] += 1
        gauge.set(state["n"], server="master:1")

    def broken():
        raise RuntimeError("a data source went away")

    reg.register_collector(collect)
    unregister = reg.register_collector(broken)
    reg.render()
    unregister()


SCRIPTS = {
    "fixed": _script_fixed,
    "random-0": lambda reg: _script_random(reg, 0),
    "random-1": lambda reg: _script_random(reg, 1),
    "overflow": _script_overflow,
    "collectors": _script_collectors,
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_the_same_operations_render_byte_equal_exposition(script, monkeypatch):
    monkeypatch.setenv("CDT_METRIC_MAX_SERIES", "4")
    rendered = []
    for metrics in (jmetrics, tmetrics):
        reg = metrics.MetricsRegistry()
        SCRIPTS[script](reg)
        rendered.append(reg.render())
    assert rendered[0] == rendered[1]
    assert rendered[1].endswith("\n") and "# TYPE" in rendered[1]
    if script == "overflow":
        assert 'cdt_capped_total{worker_id="_overflow"} 3' in rendered[1]
        assert 'cdt_metric_series_overflow_total{metric="cdt_capped_total"} 3' in rendered[1]


def test_histogram_snapshots_and_quantiles_agree():
    rng = np.random.default_rng(3)
    hists = []
    for metrics in (jmetrics, tmetrics):
        hist = metrics.MetricsRegistry().histogram("cdt_q_seconds", "q", ("role",))
        for value in rng.exponential(0.2, size=200):
            hist.observe(float(value), role="master")
        hists.append(hist)
        rng = np.random.default_rng(3)
    assert hists[0].series_snapshot() == hists[1].series_snapshot()
    series = hists[1].series_snapshot()[("master",)]
    for q in (0.0, 0.5, 0.95, 1.0, 1.5):
        assert (tmetrics.histogram_quantile(hists[1].bounds, series["buckets"], series["count"], q)
                == jmetrics.histogram_quantile(hists[0].bounds, series["buckets"],
                                               series["count"], q))
    assert tmetrics.histogram_quantile((1.0,), [0], 0, 0.5) is None


def test_registry_refuses_what_the_jax_registry_refuses():
    for metrics in (jmetrics, tmetrics):
        reg = metrics.MetricsRegistry()
        reg.counter("cdt_x_total", "x", ("a",))
        with pytest.raises(ValueError):
            reg.gauge("cdt_x_total", "x", ("a",))
        with pytest.raises(ValueError):
            reg.counter("cdt_x_total", "x", ("b",))
        with pytest.raises(ValueError):
            reg.counter("bad name", "x")
        with pytest.raises(ValueError):
            reg.counter("cdt_y_total", "y").inc(-1)
        with pytest.raises(ValueError):
            reg.counter("cdt_x_total", "x", ("a",)).inc(b="1")


# --------------------------------------------------------------------------
# span trees
# --------------------------------------------------------------------------


def _drive_tracer(tracing):
    """The same spans on a tracer of `tracing` with a counting clock; returns
    the tracer."""
    ticks = itertools.count()
    tracer = tracing.Tracer(clock=lambda: float(next(ticks)), max_traces=3,
                            max_spans_per_trace=12)
    with tracer.span("queue_orchestration", trace_id="exec_a", client_id="c1"):
        tracer.event("log", message="orchestrating", level="info")
        with tracer.span("dispatch", worker_id="w1", prompt_id="exec_a_w0") as span:
            span.attrs["note"] = 1
        with pytest.raises(ValueError):
            with tracer.span("tile.sample", stage="sample", role="master", tile_idx=0):
                raise ValueError("boom")
        manual = tracer.start_span("manual", attrs={"a": 1})
        manual.status = "error"
        tracer.end_span(manual)
        tracer.end_span(manual, status="ok")  # ending twice changes nothing

    def worker_thread():
        # a new thread joins no trace until it activates one
        assert tracer.current_trace_id() is None
        token = tracer.activate("exec_a")
        try:
            with tracer.span("execute_prompt", role="worker"):
                with tracer.span("tile.pull", stage="pull", role="worker"):
                    tracer.event("noted", k="v")
        finally:
            tracer.deactivate(token)

    thread = threading.Thread(target=worker_thread)
    thread.start()
    thread.join()
    with tracer.span("rpc.request_image", trace_id="exec_a", worker_id="w1"):
        pass
    with tracer.span("orphan", trace_id="exec_b", parent_id="missing-parent"):
        pass
    for i in range(20):  # past max_spans_per_trace
        with tracer.span(f"tile.encode.{i}", trace_id="exec_c"):
            pass
    for name in ("exec_d", "exec_e"):  # past max_traces: the least recently active go
        with tracer.span("execute_prompt", trace_id=name):
            pass
    return tracer


def _shape(nodes):
    """A span forest without ids and times."""
    return [{
        "name": node["name"], "attrs": node["attrs"], "status": node["status"],
        "events": [(event["name"], event["attrs"]) for event in node["events"]],
        "children": _shape(node["children"]),
    } for node in nodes]


def test_the_same_spans_give_equal_trees_apart_from_ids_and_times(tmp_path):
    jax_tracer, port_tracer = _drive_tracer(jtracing), _drive_tracer(ttracing)
    assert jax_tracer.trace_ids() == port_tracer.trace_ids() == ["exec_c", "exec_d", "exec_e"]
    for trace_id in port_tracer.trace_ids():
        assert _shape(jax_tracer.tree(trace_id)) == _shape(port_tracer.tree(trace_id))
    assert len(port_tracer.spans("exec_c")) == 12


def test_the_same_spans_give_equal_trees_for_a_kept_trace(tmp_path):
    """The execution's trace itself, before eviction: one root, the
    worker thread's spans under it, the error status and its message."""
    trees = []
    for tracing in (jtracing, ttracing):
        ticks = itertools.count()
        tracer = tracing.Tracer(clock=lambda: float(next(ticks)))
        with tracer.span("queue_orchestration", trace_id="exec_a"):
            with tracer.span("dispatch", worker_id="w1"):
                pass
        token = tracer.activate("exec_a")
        with pytest.raises(KeyError):
            with tracer.span("execute_prompt", role="worker"):
                raise KeyError("k")
        tracer.deactivate(token)
        tracer.event("outside a trace: dropped")
        written = tracer.write_jsonl("exec_a", str(tmp_path / f"{tracing.__name__}.jsonl"))
        assert written == 3
        trees.append(tracer.tree("exec_a"))
    assert len(trees[1]) == 1 and trees[1][0]["name"] == "queue_orchestration"
    assert _shape(trees[0]) == _shape(trees[1])
    assert trees[1][0]["children"][1]["attrs"]["error"] == "KeyError: 'k'"


# --------------------------------------------------------------------------
# usage meter and transfer ledger
# --------------------------------------------------------------------------


def _drive_accounting(usage, profiling, seed: int):
    """A seeded dispatch stream through a meter and a ledger of the given
    modules; returns (meter, ledger, the per-dispatch records)."""
    rng = np.random.default_rng(seed)
    ticks = itertools.count()
    meter = usage.UsageMeter(clock=lambda: float(next(ticks)), max_keys=6)
    ledger = profiling.TransferLedger(clock=lambda: float(next(ticks)))
    records = []
    for step in range(120):
        role = ("master", "worker")[int(rng.integers(0, 2))]
        job = f"job{int(rng.integers(0, 9))}"
        if rng.random() < 0.1:
            meter.note_job_attrs(job, ("", "acme", "beta")[int(rng.integers(0, 3))],
                                 ("", "interactive")[int(rng.integers(0, 2))])
        if rng.random() < 0.05:
            meter.note_job_adapter(job, f"hash{int(rng.integers(0, 2))}:0.8")
        slots = [{"job_id": job if rng.random() < 0.8 else f"job{int(rng.integers(0, 9))}",
                  "kind": ("real", "real", "padding", "recompute")[int(rng.integers(0, 4))]}
                 for _ in range(int(rng.integers(1, 6)))]
        elapsed = float(rng.random() * 0.37)
        record = meter.note_dispatch(tier="scan", role=role, elapsed_s=elapsed,
                                     chips=int(rng.integers(1, 3)), slots=slots)
        records.append(record)
        meter.note_tiles(role, job, int(rng.integers(0, 3)))
        if rng.random() < 0.1:
            meter.note_cached("master", job, int(rng.integers(0, 3)), float(rng.random() * 1e-3))
        if rng.random() < 0.1:
            meter.note_waste("master", "poison_retry", float(rng.random()), job_id=job)
        ledger.note_dispatch(elapsed, tier="scan", role=role, device=bool(rng.random() < 0.7))
        ledger.note_host(("gather", "encode", "ship", "unknown")[int(rng.integers(0, 4))],
                         float(rng.random() * 0.05))
        ledger.note_transfer(("h2d", "d2h", "sideways")[int(rng.integers(0, 3))],
                             int(rng.integers(0, 1 << 20)), float(rng.random() * 0.01))
        ledger.note_tiles(int(rng.integers(0, 2)))
        if step == 60:
            meter.sweep(ttl_s=40.0)
    return meter, ledger, records


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_same_dispatch_stream_gives_equal_rollups_with_exact_conservation(seed):
    jax_meter, jax_ledger, jax_records = _drive_accounting(jusage, jprofiling, seed)
    port_meter, port_ledger, port_records = _drive_accounting(tusage, tprofiling, seed)
    assert port_records == jax_records
    for record in port_records:
        assert (record["attributed_ns"] + record["waste_ns"] + record["overhead_ns"]
                == record["chip_ns"])
    for roles in (None, ("master",), ("worker",)):
        assert port_meter.rollup(roles) == jax_meter.rollup(roles)
        assert port_meter.totals(roles) == jax_meter.totals(roles)
        assert port_meter.pair_totals(roles) == jax_meter.pair_totals(roles)
    for role in ("master", "worker"):
        assert port_meter.snapshot(role) == jax_meter.snapshot(role)
    totals = port_meter.totals()
    assert totals["conserved"] is True
    assert (totals["attributed_ns"] + totals["dispatch_waste_ns"] + totals["overhead_ns"]
            == totals["dispatch_chip_ns"] == sum(r["chip_ns"] for r in port_records))
    assert port_meter.sweep(5.0) == jax_meter.sweep(5.0)
    assert port_meter.rollup() == jax_meter.rollup()
    for role in ("master", "worker"):
        assert port_ledger.snapshot(role) == jax_ledger.snapshot(role)
        assert port_ledger.totals(role) == jax_ledger.totals(role)
    assert port_ledger.host_tax() == jax_ledger.host_tax()
    blocks = [port_ledger.snapshot("master"), {"device_ns": "x"}, None, jax_ledger.snapshot()]
    assert tprofiling.merge_profiling_blocks(blocks) == jprofiling.merge_profiling_blocks(blocks)


def test_a_ledger_that_saw_no_card_reads_host_tax_one_and_timed_sync_charges_its_bucket():
    for profiling in (jprofiling, tprofiling):
        ticks = iter((0.0, 0.25))
        ledger = profiling.TransferLedger(clock=lambda: next(ticks))
        ledger.note_dispatch(0.5, role="master", device=False)
        with ledger.timed_sync(bucket="gather"):
            pass
        assert ledger.host_tax() == 1.0
        assert ledger.snapshot()["host_ns"]["gather"] == 250_000_000
        assert ledger.snapshot()["eager_ns"] == 500_000_000


def test_transfer_nbytes_reads_tensors_and_arrays():
    assert tprofiling.transfer_nbytes(torch.zeros((3, 4), dtype=torch.bfloat16)) == 24
    array = np.zeros((2, 5), np.float32)
    assert tprofiling.transfer_nbytes(array) == jprofiling.transfer_nbytes(array) == 40
    assert tprofiling.transfer_nbytes(object()) == 0


# --------------------------------------------------------------------------
# the instrument registry
# --------------------------------------------------------------------------


def _families(instruments, metrics, monkeypatch) -> dict:
    """{name: (kind, help, labelnames)} of every instrument getter of
    `instruments`, called against a fresh registry."""
    monkeypatch.setattr(metrics, "_registry", metrics.MetricsRegistry())
    for name, fn in vars(instruments).items():
        if (inspect.isfunction(fn) and fn.__module__ == instruments.__name__
                and not name.startswith("_") and not inspect.signature(fn).parameters):
            fn()
    registry = metrics.get_metrics_registry()
    return {name: (m.kind, m.help, m.labelnames)
            for name in registry.names() for m in (registry.get(name),)}


def test_the_port_families_are_the_jax_families_less_the_steps_still_to_port(monkeypatch):
    jax_families = _families(jinstruments, jmetrics, monkeypatch)
    port_families = _families(tinstruments, tmetrics, monkeypatch)
    assert set(port_families) <= set(jax_families)
    for name, family in port_families.items():
        if name in REWORDED_HELP:
            assert family[1] == REWORDED_HELP[name] != jax_families[name][1], name
            family = (family[0], jax_families[name][1], family[2])
        assert family == jax_families[name], name
    missing = set(jax_families) - set(port_families)
    assert missing == set().union(*STILL_TO_PORT.values())
    for listed in STILL_TO_PORT.values():  # each family under one step only
        assert sum(len(listed & other) for other in STILL_TO_PORT.values()) == len(listed)
    for name, (kind, _help, _labels) in port_families.items():
        assert name.startswith("cdt_") and name == name.lower()
        if kind == "counter":
            assert name.endswith("_total"), name
    assert {"cdt_tile_stage_seconds", "cdt_tiles_processed_total", "cdt_device_execute_seconds",
            "cdt_host_tax_ratio", "cdt_transfer_bytes_total", "cdt_device_memory_bytes",
            "cdt_store_pulls_total", "cdt_sched_admissions_total", "cdt_worker_tile_seconds",
            "cdt_fleet_snapshots_total", "cdt_usage_chip_seconds_total"} <= set(port_families)


# --------------------------------------------------------------------------
# the routes, beside the JAX routes
# --------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _get(url: str, timeout: float = 30.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read().decode()
    except urllib.error.HTTPError as err:
        body = err.read().decode()
        err.close()
        return err.code, err.headers.get("Content-Type"), body


def _post(url: str, payload: dict, headers: dict | None = None, timeout: float = 120.0):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST",
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as err:
        body = err.read()
        err.close()
        return err.code, json.loads(body or b"null")


def _samples(body: str) -> dict[str, float]:
    """{`name{labels}`: value} of an exposition body; every sample line
    must parse."""
    out = {}
    for line in body.strip().splitlines():
        if line.startswith("#"):
            continue
        name_part, _, value = line.rpartition(" ")
        assert name_part, line
        out[name_part] = float(value)
    return out


def _types(body: str) -> dict[str, str]:
    return {line.split()[2]: line.split()[3] for line in body.splitlines()
            if line.startswith("# TYPE ")}


@pytest.fixture
def single_masters(tmp_path, monkeypatch, port_loop):
    """One JAX master and one port master, each on its own loop, with
    fresh registries, tracers and breaker registries on both sides."""
    from comfyui_distributed_tpu.api.server import DistributedServer as JaxServer
    from comfyui_distributed_tpu.resilience import health as jhealth
    from comfyui_distributed_tpu.utils import config as jconfig
    from comfyui_distributed_tpu.utils.async_helpers import ServerLoopThread as JaxLoop
    from comfyui_distributed_tpu_torch.api.server import DistributedServer as PortServer
    from comfyui_distributed_tpu_torch.resilience import health as thealth
    from comfyui_distributed_tpu_torch.utils import config as tconfig

    monkeypatch.setenv("CDT_CONFIG_PATH", str(tmp_path / "jax_config.json"))
    with jconfig._cache.lock:
        jconfig._cache.path = jconfig._cache.mtime = jconfig._cache.data = None
    for metrics, tracing, health in ((jmetrics, jtracing, jhealth), (tmetrics, ttracing, thealth)):
        monkeypatch.setattr(metrics, "_registry", None)
        monkeypatch.setattr(tracing, "_tracer", None)
        monkeypatch.setattr(health, "_registry", None)
    port_config = str(tmp_path / "port_config.json")
    tconfig.save_config({"master": {"host": "127.0.0.1"}, "workers": [], "settings": {}},
                        port_config)
    jax_loop = JaxLoop()
    jax_loop.start()
    jax_master = JaxServer(port=_free_port(), is_worker=False)
    port_master = PortServer(port=_free_port(), is_worker=False, config_path=port_config,
                             device="cpu")
    asyncio.run_coroutine_threadsafe(jax_master.start(), jax_loop.loop).result(timeout=60)
    asyncio.run_coroutine_threadsafe(port_master.start(), port_loop.loop).result(timeout=60)
    yield {"jax": (jax_master, jax_loop, jhealth, jinstruments, jtracing),
           "port": (port_master, port_loop, thealth, tinstruments, ttracing)}
    asyncio.run_coroutine_threadsafe(port_master.stop(), port_loop.loop).result(timeout=60)
    asyncio.run_coroutine_threadsafe(jax_master.stop(), jax_loop.loop).result(timeout=60)
    jax_loop.stop()


def test_metrics_route_matches_the_jax_route_after_the_same_store_operations(single_masters):
    scraped = {}
    for side, (server, loop, health, instruments, _tracing) in single_masters.items():
        async def touch(store=server.job_store):
            await store.init_tile_job("job-m", [0, 1, 2])
            await store.pull_task("job-m", "w1", timeout=0.05)
            await store.submit_result("job-m", "w1", 0, None)
            await store.submit_result("job-m", "w1", 0, None)  # a duplicate
            await store.heartbeat("job-m", "w1")
            await store.pull_task("job-m", "w2", timeout=0.05)
            await store.release_tasks("job-m", "w2", [1, 2])
            await store.cancel_job("job-m", reason="client")
            await store.pull_task("job-m", "w1", timeout=0.05)

        asyncio.run_coroutine_threadsafe(touch(), loop.loop).result(timeout=30)
        instruments.tile_stage_seconds().observe(0.05, stage="sample", role="master")
        for _ in range(5):
            health.get_health_registry().record_failure("w1")  # → quarantined
        status, content_type, body = _get(f"http://127.0.0.1:{server.port}/distributed/metrics")
        assert status == 200
        scraped[side] = (content_type, _samples(body), _types(body), server.port)
    (jax_type, jax_samples, jax_types, jax_port), (port_type, port_samples, port_types,
                                                   port_port) = scraped["jax"], scraped["port"]
    assert port_type == jax_type == "text/plain; version=0.0.4; charset=utf-8"
    for name, kind in port_types.items():
        assert jax_types.get(name) == kind, name
    compared = [key for key in port_samples if key.split("{")[0].rstrip("_sumcountbucket") and (
        key.startswith(("cdt_store_", "cdt_jobs_cancelled", "cdt_cancel_refunded",
                        "cdt_worker_breaker", "cdt_tile_stage_seconds",
                        "cdt_tile_jobs_active", "cdt_tiles_in_flight", "cdt_tile_queue_depth",
                        "cdt_collector_jobs_active", "cdt_prompt_queue_depth")))]
    assert len(compared) > 30
    for key in compared:
        jax_key = key.replace(f"master:{port_port}", f"master:{jax_port}")
        assert jax_samples.get(jax_key) == port_samples[key], key
    assert port_samples['cdt_store_pulls_total{worker_id="w1",outcome="task"}'] == 1
    assert port_samples['cdt_store_pulls_total{worker_id="w1",outcome="cancelled"}'] == 1
    assert port_samples['cdt_store_submits_total{worker_id="w1",outcome="duplicate"}'] == 1
    assert port_samples['cdt_store_requeued_tasks_total{worker_id="w2",reason="released"}'] == 1
    assert port_samples['cdt_worker_breaker_state{worker_id="w1"}'] == 2
    assert port_samples["cdt_host_rss_bytes"] > 0
    assert not any(key.startswith("cdt_device_memory_bytes") for key in port_samples)


def test_trace_routes_answer_as_the_jax_routes(single_masters):
    answers = {}
    for side, (server, _loop, _health, _instruments, tracing) in single_masters.items():
        tracer = tracing.get_tracer()
        with tracer.span("queue_orchestration", trace_id="exec_rt_1"):
            with tracer.span("dispatch", worker_id="w1"):
                pass
        for i in range(3):
            with tracer.span("execute_prompt", trace_id=f"exec_rt_{i + 2}"):
                pass
        base = f"http://127.0.0.1:{server.port}/distributed"
        status, _, body = _get(f"{base}/trace/exec_rt_1")
        tree = json.loads(body)
        page = json.loads(_get(f"{base}/traces?limit=2&offset=1")[2])
        answers[side] = (status, tree["span_count"], _shape(tree["tree"]), page,
                         _get(f"{base}/trace/nope")[0],
                         [_get(f"{base}/traces?{query}")[0]
                          for query in ("limit=x", "limit=0", "offset=-1", "limit=100000")])
    assert answers["port"] == answers["jax"]
    assert answers["port"][0] == 200 and answers["port"][1] == 2
    assert answers["port"][3] == {"traces": ["exec_rt_3", "exec_rt_2"], "total": 4, "limit": 2,
                                  "offset": 1}
    assert answers["port"][4] == 404 and answers["port"][5] == [400, 400, 400, 200]


def test_cache_routes_and_the_unported_routes(single_masters, monkeypatch):
    from comfyui_distributed_tpu.cache import store as jstore
    from comfyui_distributed_tpu_torch.cache import store as tstore

    port_master = single_masters["port"][0]
    jax_master = single_masters["jax"][0]
    off = {}
    for side, server in (("jax", jax_master), ("port", port_master)):
        off[side] = (_get(f"http://127.0.0.1:{server.port}/distributed/cache")[2],
                     _post(f"http://127.0.0.1:{server.port}/distributed/cache/clear", {}))
    monkeypatch.setattr(jstore, "_tile_cache", None)
    monkeypatch.setattr(tstore, "_tile_cache", None)
    assert off["port"][1] == off["jax"][1] and off["port"][1][1]["enabled"] is False
    assert json.loads(off["port"][0]) == json.loads(off["jax"][0])
    on = {}
    for side, store, server in (("jax", jstore, jax_master), ("port", tstore, port_master)):
        cache = store.TileResultCache()
        monkeypatch.setattr(store, "_tile_cache", cache)
        cache.put("k" * 64, np.ones((2, 2, 3), np.float32))
        cache.get("k" * 64)
        cache.get("m" * 64)
        base = f"http://127.0.0.1:{server.port}/distributed"
        stats = json.loads(_get(f"{base}/cache")[2])
        cleared = _post(f"{base}/cache/clear", {})
        on[side] = (stats, cleared, json.loads(_get(f"{base}/cache")[2])["ram_entries"])
    assert on["port"] == on["jax"]
    assert on["port"][0]["enabled"] is True and on["port"][0]["hits_ram"] == 1
    assert on["port"][1] == (200, {"dropped_entries": 1, "dropped_bytes": 48, "enabled": True})
    # the fleet plane's routes: the same statuses, keys and verdicts
    plane = {}
    for side, server in (("jax", jax_master), ("port", port_master)):
        base = f"http://127.0.0.1:{server.port}/distributed"
        answers = {}
        for path in ("fleet", "fleet?since=60", "fleet?since=x", "fleet?since=-1",
                     "fleet?since=nan", "alerts", "usage", "usage?since=60", "usage?since=inf"):
            status, _, body = _get(f"{base}/{path}")
            answers[path] = (status, json.loads(body))
        plane[side] = answers
    for path, (status, body) in plane["port"].items():
        jax_status, jax_body = plane["jax"][path]
        assert status == jax_status, path
        assert set(body) == set(jax_body), path
    port_fleet = plane["port"]["fleet?since=60"][1]
    assert port_fleet["enabled"] is True and port_fleet["workers"] == {}
    assert set(port_fleet["history"]) == set(plane["jax"]["fleet?since=60"][1]["history"])
    assert set(port_fleet["rollup"]) == set(plane["jax"]["fleet"][1]["rollup"])
    alerts = {side: plane[side]["alerts"][1] for side in plane}
    assert ([a["slo"] for a in alerts["port"]["alerts"]]
            == [a["slo"] for a in alerts["jax"]["alerts"]])
    assert alerts["port"]["active"] == alerts["jax"]["active"] == []
    assert plane["port"]["fleet?since=x"][0] == plane["port"]["usage?since=inf"][0] == 400
    assert set(plane["port"]["usage"][1]["rollup"]) == set(plane["jax"]["usage"][1]["rollup"])
    base = f"http://127.0.0.1:{port_master.port}/distributed"
    # the durability route is ported (step 7f): without CDT_JOURNAL_DIR it
    # answers the JAX route's disabled body
    durability = {side: _get(f"http://127.0.0.1:{server.port}/distributed/durability")
                  for side, server in (("jax", jax_master), ("port", port_master))}
    assert durability["port"][0] == durability["jax"][0] == 200
    assert json.loads(durability["port"][2]) == json.loads(durability["jax"][2]) == {
        "enabled": False, "hint": "set CDT_JOURNAL_DIR to enable"}
    # the profiler-capture routes are ported: without CDT_PROFILE_DIR they
    # answer the JAX routes' disabled statuses and keys
    profile = {}
    for side, server in (("jax", jax_master), ("port", port_master)):
        side_base = f"http://127.0.0.1:{server.port}/distributed"
        status, _, body = _get(f"{side_base}/profile")
        profile[side] = ((status, set(json.loads(body))),
                         _post(f"{side_base}/profile/start", {}))
    assert profile["port"] == profile["jax"]
    assert profile["port"][0][0] == 200 and profile["port"][1][0] == 400
    # the event stream is a WebSocket: a plain GET is refused as the JAX
    # route refuses it
    events = {side: _get(f"http://127.0.0.1:{server.port}/distributed/events")[0]
              for side, server in (("jax", jax_master), ("port", port_master))}
    assert events["port"] == events["jax"] == 400


# --------------------------------------------------------------------------
# one elastic job through each package's own servers
# --------------------------------------------------------------------------


def _usdu_prompt():
    with open(os.path.join(REPO, "workflows", "distributed-upscale.json"), encoding="utf-8") as fh:
        prompt = json.load(fh)
    prompt["1"]["inputs"]["ckpt_name"] = "tiny-unet"
    prompt["4"]["inputs"]["image"] = "usdu_src.png"
    prompt["5"]["inputs"].update(steps=1, tile_width=64, tile_height=64, tile_padding=16)
    return prompt


def _wait_done(url: str, timeout: float = 300.0) -> dict:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status, _, body = _get(url)
        if status == 200 and json.loads(body).get("done"):
            return json.loads(body)
        time.sleep(0.1)
    raise AssertionError(f"{url} not done within {timeout} s")


def _run_side(side: str, tmp, pixels):
    """Boot a master and w1 of `side` ("jax" or "port") on loopback, run
    the upscale twice with a tile cache installed, POST one collector
    envelope with the trace header, and scrape: {"samples", "types",
    "trees", "spans", "queued", ...}."""
    if side == "jax":
        from comfyui_distributed_tpu.api.server import DistributedServer
        from comfyui_distributed_tpu.cache import store as cache_store
        from comfyui_distributed_tpu.utils import config as config_mod
        from comfyui_distributed_tpu.utils import image as img_utils
        from comfyui_distributed_tpu.utils.async_helpers import ServerLoopThread
        tracing = jtracing
    else:
        from comfyui_distributed_tpu_torch.api.server import DistributedServer
        from comfyui_distributed_tpu_torch.cache import store as cache_store
        from comfyui_distributed_tpu_torch.utils import config as config_mod
        from comfyui_distributed_tpu_torch.utils import image as img_utils
        from comfyui_distributed_tpu_torch.utils.async_helpers import ServerLoopThread
        tracing = ttracing
    in_dir = os.path.join(tmp, side, "input")
    os.makedirs(in_dir)
    with open(os.path.join(in_dir, "usdu_src.png"), "wb") as fh:
        fh.write(img_utils.encode_png(pixels))
    master_port, worker_port = _free_port(), _free_port()
    config = {"master": {"host": "127.0.0.1"},
              "workers": [{"id": "w1", "name": "w1", "type": "remote", "host": "127.0.0.1",
                           "port": worker_port, "enabled": True}],
              "settings": {"input_dir": in_dir,
                           "output_dir": os.path.join(tmp, side, "output")}}
    previous_cache = cache_store.set_tile_cache(cache_store.TileResultCache())
    loop = ServerLoopThread()
    loop.start()
    if side == "jax":
        from comfyui_distributed_tpu.models import pipeline as jpl

        config_mod.save_config(config)
        master = DistributedServer(port=master_port, is_worker=False)
        worker = DistributedServer(port=worker_port, is_worker=True)
        bundle = jpl.load_pipeline("tiny-unet")  # one load for both servers
        for server in (master, worker):
            server.execution_context.pipelines["tiny-unet"] = bundle
    else:
        config_path = os.path.join(tmp, side, "config.json")
        config_mod.save_config(config, config_path)
        master = DistributedServer(port=master_port, is_worker=False, config_path=config_path,
                                   device="cpu")
        worker = DistributedServer(port=worker_port, is_worker=True, config_path=config_path,
                                   device="cpu")
        from comfyui_distributed_tpu_torch.models import pipeline as tpl

        bundle = tpl.load_pipeline("tiny-unet", seed=0, device="cpu")
        for server in (master, worker):
            server.execution_context.pipelines["tiny-unet"] = bundle
    out = {"queued": []}
    try:
        for server in (master, worker):
            asyncio.run_coroutine_threadsafe(server.start(), loop.loop).result(timeout=60)
        base = f"http://127.0.0.1:{master_port}"
        for _ in range(2):
            status, queued = _post(f"{base}/distributed/queue", {
                "prompt": _usdu_prompt(), "client_id": "telemetry", "workers": ["w1"]})
            assert status == 200 and queued["workers"] == ["w1"], queued
            history = _wait_done(f"{base}/history/{queued['prompt_id']}")
            worker_history = _wait_done(
                f"http://127.0.0.1:{worker_port}/history/{queued['trace_id']}_w0")
            assert history["error"] is None
            # a JAX worker that reaches a job its master already finished
            # (the all-cached run, or a master that took every tile) gets
            # 404s after the creation grace; the port answers it drained
            assert worker_history["error"] is None or (
                side == "jax" and "HTTP 404" in worker_history["error"]), worker_history
            out["queued"].append(queued)
        first_trace = out["queued"][0]["trace_id"]
        asyncio.run_coroutine_threadsafe(master.job_store.ensure_collector("collect-1"),
                                         loop.loop).result(timeout=30)
        status, _ = _post(f"{base}/distributed/job_complete", {
            "job_id": "collect-1", "worker_id": "w1", "batch_idx": 0, "is_last": True,
            "image": img_utils.encode_image_data_url(np.zeros((4, 4, 3), np.float32))},
            headers={"X-CDT-Trace-Id": first_trace})
        assert status == 200
        status, content_type, body = _get(f"{base}/distributed/metrics")
        assert status == 200
        out.update(samples=_samples(body), types=_types(body), content_type=content_type)
        out["trees"] = [json.loads(_get(f"{base}/distributed/trace/{q['trace_id']}")[2])
                        for q in out["queued"]]
        out["spans"] = [tracing.get_tracer().spans(q["trace_id"]) for q in out["queued"]]
        out["completions"] = [master.job_store.finished[q["job_ids"]["5"]]["completions"]
                              for q in out["queued"]] if side == "port" else None
    finally:
        for server in (master, worker):
            asyncio.run_coroutine_threadsafe(server.stop(), loop.loop).result(timeout=60)
        loop.stop()
        cache_store.set_tile_cache(previous_cache)
    return out


@pytest.fixture(scope="module")
def loopback_runs(tmp_path_factory):
    """Both packages' runs, each on fresh process-global telemetry state
    (registries, tracers, ledgers, meters, breakers), restored after."""
    from comfyui_distributed_tpu.resilience import health as jhealth
    from comfyui_distributed_tpu.utils import config as jconfig
    from comfyui_distributed_tpu.utils import constants as jconstants
    from comfyui_distributed_tpu_torch.resilience import health as thealth

    tmp = str(tmp_path_factory.mktemp("telemetry_loopback"))
    patch = pytest.MonkeyPatch()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        patch.setenv("CDT_CONFIG_PATH", os.path.join(tmp, "jax_config.json"))
        patch.setenv("CDT_DETERMINISTIC_BLEND", "1")
        # one pull attempt: a JAX worker reaching a finished job otherwise
        # retries its 404s for minutes
        patch.setattr(jconstants, "WORK_PULL_RETRY_COUNT", 1)
        with jconfig._cache.lock:
            jconfig._cache.path = jconfig._cache.mtime = jconfig._cache.data = None
        for module, name in ((jmetrics, "_registry"), (jtracing, "_tracer"),
                             (jprofiling, "_ledger"), (jusage, "_METER"), (jhealth, "_registry"),
                             (tmetrics, "_registry"), (ttracing, "_tracer"),
                             (tprofiling, "_ledger"), (tusage, "_METER"), (thealth, "_registry")):
            patch.setattr(module, name, None)
        pixels = np.random.default_rng(0).random((64, 64, 3), dtype=np.float32)
        runs = {side: _run_side(side, tmp, pixels) for side in ("port", "jax")}
        runs["port_meter"] = tusage.get_usage_meter()
        runs["port_ledger"] = tprofiling.peek_transfer_ledger()
        yield runs
    finally:
        patch.undo()
        torch.set_num_threads(threads)


def _sum(samples: dict, name: str, **labels) -> float:
    """The sum of `name`'s samples whose labels include `labels`."""
    total = 0.0
    for key, value in samples.items():
        family, _, rest = key.partition("{")
        if family != name:
            continue
        got = dict(item.split("=", 1) for item in rest.rstrip("}").split(",") if item)
        if all(got.get(k) == f'"{v}"' for k, v in labels.items()):
            total += value
    return total


def _label_names(samples: dict, family: str) -> set:
    names = set()
    for key in samples:
        base, _, rest = key.partition("{")
        if base in (family, f"{family}_bucket", f"{family}_sum", f"{family}_count"):
            names.add(tuple(item.split("=", 1)[0] for item in rest.rstrip("}").split(",")
                            if item and not item.startswith("le=")))
    return names


def test_loopback_runs_share_families_kinds_and_label_names(loopback_runs):
    port, jax = loopback_runs["port"], loopback_runs["jax"]
    assert port["content_type"] == jax["content_type"]
    assert set(port["types"]) <= set(jax["types"])
    for family, kind in port["types"].items():
        assert jax["types"][family] == kind, family
        port_labels, jax_labels = _label_names(port["samples"], family), _label_names(
            jax["samples"], family)
        if port_labels and jax_labels:
            assert port_labels == jax_labels, family


COUNTERS = {
    "tiles processed": ("cdt_tiles_processed_total", {}),
    "pulls that handed out a task": ("cdt_store_pulls_total", {"outcome": "task"}),
    "accepted submissions": ("cdt_store_submits_total", {"outcome": "accepted"}),
    "collector results": ("cdt_collector_results_total", {"worker_id": "w1"}),
    "cache settled": ("cdt_cache_settled_total", {}),
    "cache misses": ("cdt_cache_lookups_total", {"outcome": "miss"}),
    "cache hits": ("cdt_cache_lookups_total", {"outcome": "hit_ram"}),
    "fan-out orchestrations": ("cdt_orchestrations_total", {"mode": "fan_out"}),
    "dispatches to w1": ("cdt_dispatch_seconds_count", {"worker_id": "w1", "outcome": "ok"}),
}


@pytest.mark.parametrize("counter", sorted(COUNTERS))
def test_loopback_runs_count_the_same(loopback_runs, counter):
    name, labels = COUNTERS[counter]
    port = _sum(loopback_runs["port"]["samples"], name, **labels)
    jax = _sum(loopback_runs["jax"]["samples"], name, **labels)
    assert port == jax, (counter, port, jax)
    expected = {"tiles processed": 4, "pulls that handed out a task": 4, "collector results": 1,
                "cache settled": 4, "cache misses": 4, "cache hits": 4,
                "fan-out orchestrations": 2, "dispatches to w1": 2,
                "accepted submissions": 4}[counter]
    assert port == expected, counter


def test_loopback_runs_observe_the_same_stages_per_role(loopback_runs):
    """The stage histogram's (stage, role) series: the master pulls,
    samples, dispatches, reads back, decodes w1's tiles, blends and
    probes/hits the cache; w1 pulls, samples, dispatches, reads back,
    encodes and submits."""
    stages = {}
    for side in ("port", "jax"):
        stages[side] = {key.split("{")[1].split(",le=")[0]
                        for key in loopback_runs[side]["samples"]
                        if key.startswith("cdt_tile_stage_seconds_count")}
    assert stages["port"] == stages["jax"]
    samples = loopback_runs["port"]["samples"]
    for role in ("master", "worker"):
        tiles = _sum(samples, "cdt_tiles_processed_total", role=role)
        for stage in ("sample", "dispatch", "readback"):
            assert _sum(samples, "cdt_tile_stage_seconds_count", stage=stage, role=role) == tiles
    assert _sum(samples, "cdt_tile_stage_seconds_count", stage="encode", role="worker") == _sum(
        samples, "cdt_tiles_processed_total", role="worker")


def _connected(spans: list[dict]) -> bool:
    index = {s["span_id"]: s for s in spans}
    roots = [s for s in spans if not s["parent_id"] or s["parent_id"] not in index]
    return len(roots) == 1


@pytest.mark.parametrize("side", ["port", "jax"])
def test_loopback_runs_make_one_connected_span_tree_per_execution(loopback_runs, side):
    run = loopback_runs[side]
    for tree, spans in zip(run["trees"], run["spans"]):
        assert len(tree["tree"]) == 1 and tree["span_count"] == len(spans)
        assert _connected(spans)
        names = {s["name"] for s in spans}
        assert {"queue_orchestration", "dispatch", "execute_prompt", "rpc.request_image",
                "rpc.submit_tiles", "tile.pull"} <= names
        assert {s["attrs"].get("role") for s in spans if s["name"] == "execute_prompt"} == {
            "master", "worker"}
    first = {s["name"] for s in run["spans"][0]}
    assert {"tile.sample", "tile.dispatch", "tile.readback", "tile.blend",
            "rpc.job_complete"} <= first
    second = {s["name"] for s in run["spans"][1]}
    assert "tile.cache.hit" in second and "tile.dispatch" not in second


def test_loopback_port_span_names_are_the_jax_span_names(loopback_runs):
    port = {s["name"] for spans in loopback_runs["port"]["spans"] for s in spans}
    jax = {s["name"] for spans in loopback_runs["jax"]["spans"] for s in spans}
    assert port <= jax, port - jax


def test_loopback_port_usage_conserves_and_matches_its_dispatch_spans(loopback_runs):
    """On the CPU: the meter's identity is exact, each job's chip seconds
    are its tile.dispatch spans' seconds, the ledger saw no card (host-tax
    1.0, every dispatch on the host side) and read back every tile's
    float32 pixels."""
    meter, ledger = loopback_runs["port_meter"], loopback_runs["port_ledger"]
    run = loopback_runs["port"]
    totals = meter.totals()
    assert totals["conserved"] is True and totals["dispatches"] == 4
    assert (totals["attributed_ns"] + totals["dispatch_waste_ns"] + totals["overhead_ns"]
            == totals["dispatch_chip_ns"])
    rollup = meter.rollup()
    job_id = run["queued"][0]["job_ids"]["5"]
    spans = [s for s in run["spans"][0] if s["name"] == "tile.dispatch"]
    assert len(spans) == 4
    assert math.isclose(rollup["jobs"][job_id]["chip_s"], sum(s["duration"] for s in spans),
                        rel_tol=0.05)
    second = run["queued"][1]["job_ids"]["5"]
    assert rollup["jobs"][second]["cached_tiles"] == 4
    snap = ledger.snapshot()
    assert snap["device_ns"] == 0 and snap["eager_dispatches"] == 4 and snap["host_tax"] == 1.0
    # the meter and the ledger are fed apart for each dispatch
    assert totals["dispatch_chip_ns"] == snap["eager_ns"]
    assert snap["transfer"]["d2h"]["bytes"] == 4 * 96 * 96 * 3 * 4
    assert snap["host_ns"]["gather"] > 0 and snap["host_ns"]["encode"] > 0
    assert snap["host_ns"]["ship"] > 0
    assert run["samples"]['cdt_transfer_bytes_total{direction="d2h"}'] == 4 * 96 * 96 * 3 * 4


# --------------------------------------------------------------------------
# the worker's first fleet snapshot (a recorded divergence)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("uptime", [500.0, 5000.0])
def test_the_first_rpc_carries_a_snapshot_however_recently_the_clock_started(monkeypatch,
                                                                            uptime):
    """The JAX client starts its last-snapshot time at 0, so while the
    host's monotonic clock reads under the interval its first RPC carries
    no snapshot; the port's first RPC always carries one. Past the
    interval both do; the second RPC inside the interval carries none in
    either package."""
    import types

    from comfyui_distributed_tpu.graph import usdu_elastic as jelastic
    from comfyui_distributed_tpu_torch.graph import usdu_elastic as telastic

    clock = types.SimpleNamespace(monotonic=lambda: uptime)
    first = {}
    for side, module in (("jax", jelastic), ("port", telastic)):
        monkeypatch.setattr(module, "time", clock)
        client = module.HTTPWorkClient("http://127.0.0.1:1", "job", "w1")
        client._telemetry_interval = 1000.0
        first[side] = client._maybe_telemetry()
        assert client._maybe_telemetry() is None  # within the interval
    assert isinstance(first["port"], dict) and first["port"]["v"] == 3
    if uptime < 1000.0:
        assert first["jax"] is None
    else:
        assert isinstance(first["jax"], dict) and set(first["jax"]) == set(first["port"])
