"""The port's chaos harness (comfyui_distributed_tpu_torch/resilience/chaos.py)
replaying the scenarios of tests/test_chaos_usdu.py and
tests/test_chaos_cache.py whose arguments the port serves, with the JAX
tests' own plans and assertions.

Within the port every faulted canvas is held to its fault-free baseline
with assert_array_equal: the stub processor's tiles are exact multiples
of 1/255 (the PNG envelope is lossless) and CDT_DETERMINISTIC_BLEND
composites in sorted order. Across the packages the fault-free canvas of
seed 11 is held within a stated tolerance (the port handed the JAX
package's per-tile noise), and the crash-after-pull plan fires the same
faults on the same sites.

The JAX scenarios that need tile_batch > 1 (step 7b), mesh_devices > 1
(step 8) or device_canvas (7j) are not replayed: each such argument
raises NotImplementedError naming its step, tested below. journal_dir
(step 7f) is served: its scenarios are in
tests/test_torch_chaos_durability.py. Runs on the CPU at the JAX tests'
tiny sizes.
"""

import asyncio
import collections
import json
import os

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu_torch.cache.store import TileResultCache, get_tile_cache
from comfyui_distributed_tpu_torch.resilience import faults
from comfyui_distributed_tpu_torch.resilience.chaos import run_chaos_usdu
from comfyui_distributed_tpu_torch.telemetry import get_tracer
from comfyui_distributed_tpu_torch.telemetry.usage import get_usage_meter

from test_torch_parity import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# tests/test_chaos_usdu.py: the master's pulls are slowed, so worker
# threads win tiles before the in-process master drains the queue
SLOW_MASTER = "latency(0.15)@store:pull:master#1-3"
CRASH_AFTER_PULL = f"seed=11;{SLOW_MASTER};crash@chaos:w1:pulled#1"
STRAGGLER = (f"seed=11;{SLOW_MASTER};latency(0.4)@chaos:w1:pulled#*;"
             "crash@chaos:w2:pulled#1")


def run(**kwargs):
    """run_chaos_usdu on the CPU (the tests' device)."""
    return run_chaos_usdu(device="cpu", **kwargs)


@pytest.fixture(scope="module")
def baseline():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result = run(seed=11)
    finally:
        torch.set_num_threads(threads)
    assert result.output.shape == (1, 128, 128, 3)
    assert np.isfinite(result.output).all()
    return result.output


@pytest.fixture(autouse=True)
def _nothing_leaks():
    """Every run restores the process's tracer, usage meter and tile
    cache, and installs no injector."""
    tracer, meter, cache = get_tracer(), get_usage_meter(), get_tile_cache()
    yield
    assert get_tracer() is tracer and get_usage_meter() is meter
    assert get_tile_cache() is cache
    assert faults.get_fault_injector() is None
    assert os.environ.get("CDT_DETERMINISTIC_BLEND") is None


# --- tests/test_chaos_usdu.py -----------------------------------------------


def test_fault_free_run_is_reproducible(baseline):
    again = run(seed=11)
    np.testing.assert_array_equal(baseline, again.output)
    assert again.fired == [] and again.crashed_workers == []
    assert sum(again.tiles_by_worker.values()) == 4


def test_worker_crash_after_pull_recovers_bit_identical(baseline):
    result = run(seed=11, fault_plan=CRASH_AFTER_PULL)
    assert "w1" in result.crashed_workers
    assert "crash" in result.fired_kinds()
    np.testing.assert_array_equal(baseline, result.output)


def test_both_workers_crash_master_covers_everything(baseline):
    result = run(seed=11, fault_plan=(f"seed=11;{SLOW_MASTER};"
                                      "crash@chaos:w1:pulled#1;crash@chaos:w2:pulled#1"))
    assert set(result.crashed_workers) == {"w1", "w2"}
    np.testing.assert_array_equal(baseline, result.output)


def test_dropped_heartbeats_cause_requeue_and_duplicate_drop(baseline):
    result = run(seed=11, fault_plan=(f"seed=11;{SLOW_MASTER};"
                                      "drop@store:heartbeat:w1#*;latency(0.8)@chaos:w1:submit#1"),
                 worker_timeout=0.4)
    assert "drop" in result.fired_kinds()
    assert result.crashed_workers == []  # alive, just invisible
    np.testing.assert_array_equal(baseline, result.output)


def test_latency_spikes_do_not_change_output(baseline):
    result = run(seed=11, fault_plan=("seed=11;latency(0.2)@chaos:w2:pull#1-2;"
                                      "latency(0.1)@store:pull:master#1"))
    assert "latency" in result.fired_kinds()
    np.testing.assert_array_equal(baseline, result.output)


def test_straggler_worker_detected_suspected_and_speculated(baseline):
    result = run(seed=11, fault_plan=STRAGGLER, worker_timeout=10.0, watchdog={})
    assert "latency" in result.fired_kinds()
    assert result.crashed_workers == ["w2"]
    assert "w1" in result.stragglers, result.stragglers
    assert result.health.get("w1", {}).get("state") == "suspect", result.health
    assert result.stalls, "stall never detected"
    assert any(result.speculated.values()), result.speculated
    np.testing.assert_array_equal(baseline, result.output)


def test_straggler_fires_and_resolves_latency_slo_alert(baseline):
    result = run(seed=11, fault_plan=STRAGGLER, worker_timeout=10.0, watchdog={}, slo={})
    assert "w1" in result.stragglers
    assert result.health.get("w1", {}).get("state") == "suspect"
    kinds = [a["type"] for a in result.alerts]
    assert kinds == ["alert_fired", "alert_resolved"], result.alerts
    fired, resolved = result.alerts
    assert fired["slo"] == resolved["slo"] == "tile_latency"
    assert resolved["ts"] > fired["ts"]
    assert resolved["active_seconds"] > 0
    assert not result.slo_active
    np.testing.assert_array_equal(baseline, result.output)


def test_slo_engine_stays_quiet_on_a_healthy_run(baseline):
    result = run(seed=11, slo={})
    assert result.alerts == []
    assert not result.slo_active
    np.testing.assert_array_equal(baseline, result.output)


def test_stall_speculation_recovers_a_crashed_worker_before_timeout(baseline):
    result = run(seed=11, fault_plan=CRASH_AFTER_PULL, worker_timeout=10.0, watchdog={})
    assert "w1" in result.crashed_workers
    assert result.stalls, "stall never detected"
    speculated = [t for tids in result.speculated.values() for t in tids]
    assert speculated, "no speculative re-dispatch happened"
    np.testing.assert_array_equal(baseline, result.output)


def test_watchdog_stays_quiet_on_a_healthy_run(baseline):
    result = run(seed=11, watchdog={})
    assert result.stragglers == []
    assert result.stalls == []
    assert result.speculated == {}
    np.testing.assert_array_equal(baseline, result.output)


def test_weighted_placement_starves_straggler_but_not_output(baseline):
    """The JAX test's two halves: a scripted 10x gap drained by
    interleaved pulls against the port's store (every claim count a pure
    function of the policy), then the canvas invariant under the same
    pressure in the harness."""
    from comfyui_distributed_tpu_torch.jobs import JobStore
    from comfyui_distributed_tpu_torch.scheduler.placement import PlacementPolicy

    policy = PlacementPolicy(min_samples=1, base_batch=2, max_batch=4, tail_tiles=2,
                             trim_ratio=0.5)
    for _ in range(4):
        policy.record_latency("w1", 0.35)  # the straggler
        policy.record_latency("w2", 0.035)  # the healthy worker

    async def drain_interleaved():
        store = JobStore()
        store.placement = policy
        await store.init_tile_job("job", list(range(16)))
        counts = {"w1": 0, "w2": 0}
        while True:
            claimed = False
            for wid in ("w1", "w2"):
                grant = await store.pull_tasks("job", wid, timeout=0.01)
                for task_id in grant:
                    await store.submit_result("job", wid, task_id, None)
                counts[wid] += len(grant)
                claimed = claimed or bool(grant)
            if not claimed:
                return counts

    counts = asyncio.run(drain_interleaved())
    total = sum(counts.values())
    assert total == 16
    assert counts["w1"] < counts["w2"], counts
    assert counts["w1"] <= total // 3, counts
    snap = policy.snapshot()["workers"]["w1"]
    assert snap["speed_ratio"] < 0.5, snap
    assert snap["tail_trims"] >= 1, snap

    plan = ("seed=11;latency(0.2)@store:pull:master#1-8;"
            "latency(0.35)@chaos:w1:pulled#*;latency(0.035)@chaos:w2:pulled#*")
    big_baseline = run(seed=11, image_hw=(128, 128))
    weighted = run(seed=11, image_hw=(128, 128), fault_plan=plan, worker_timeout=10.0,
                   pipeline=False, placement=dict(base_batch=1, max_batch=4, tail_tiles=8,
                                                  min_samples=1, trim_ratio=0.5))
    np.testing.assert_array_equal(big_baseline.output, weighted.output)


def test_weighted_placement_is_invisible_on_a_healthy_fleet(baseline):
    result = run(seed=11, placement={})
    np.testing.assert_array_equal(baseline, result.output)
    for stats in result.placement["workers"].values():
        assert stats["tail_trims"] == 0


def test_pipelined_and_serial_workers_give_one_canvas(baseline):
    """The parity half of the JAX package's batched-pipelined scenarios at
    the port's K = 1: the threaded pipeline with pull prefetch and the
    serial staging give the baseline's canvas, square and ragged grids
    (15 tiles) alike."""
    result = run(seed=11, pipeline=True, prefetch=True)
    np.testing.assert_array_equal(baseline, result.output)
    serial = run(seed=7, image_hw=(96, 160), pipeline=False)
    threaded = run(seed=7, image_hw=(96, 160), pipeline=True, prefetch=True)
    assert sum(serial.tiles_by_worker.values()) == 15
    np.testing.assert_array_equal(serial.output, threaded.output)


def test_prefetch_crash_requeues_prefetched_grant(baseline):
    """tests/test_chaos_usdu.py's prefetch crash at the port's one tile a
    grant: a worker crashing on its second pulled tile strands it and its
    prefetched grant; the requeue recovers every tile bit-identically."""
    result = run(seed=11, fault_plan=f"seed=11;{SLOW_MASTER};crash@chaos:w1:pulled#2",
                 pipeline=True, prefetch=True)
    np.testing.assert_array_equal(baseline, result.output)


def test_store_level_connection_errors_kill_worker_but_not_job(baseline):
    result = run(seed=11, fault_plan=f"seed=11;{SLOW_MASTER};connect_error@chaos:w2:pull#2")
    np.testing.assert_array_equal(baseline, result.output)


def test_straggler_alert_auto_captures_an_incident_bundle(baseline, tmp_path):
    from comfyui_distributed_tpu_torch.telemetry.incidents import validate_bundle

    result = run(seed=11, fault_plan=STRAGGLER, worker_timeout=10.0, watchdog={}, slo={},
                 incidents={"dir": str(tmp_path)})
    assert [a["type"] for a in result.alerts][:1] == ["alert_fired"]
    assert len(result.incidents) == 1, result.incidents
    assert result.incidents[0]["trigger"] == "alert_fired"
    assert result.incident_retrigger == "debounced"
    with open(os.path.join(str(tmp_path), result.incidents[0]["id"] + ".json"),
              encoding="utf-8") as fh:
        bundle = json.load(fh)
    assert validate_bundle(bundle) == []
    assert bundle["trigger"]["key"] == "tile_latency"
    rules = bundle["trigger"]["context"].get("rules")
    assert rules and any(r["firing"] for r in rules), rules
    workers = bundle["fleet"]["history"]["workers"]
    assert "w1" in workers, sorted(workers)
    assert workers["w1"]["fleet_worker_tiles_per_s"], workers["w1"]
    assert bundle["flight"]["enabled"] is True
    assert bundle["flight"]["events"]
    np.testing.assert_array_equal(baseline, result.output)


def test_healthy_run_captures_no_incidents(baseline, tmp_path):
    result = run(seed=11, slo={}, incidents={"dir": str(tmp_path)})
    assert result.incidents == []
    assert result.incident_retrigger == ""
    np.testing.assert_array_equal(baseline, result.output)


def test_the_trace_and_the_usage_of_a_run(baseline, tmp_path):
    """One fake-clock span tree a run, exported as JSONL, and the run's
    own usage meter: its identity holds and every tile was metered."""
    path = str(tmp_path / "chaos.jsonl")
    result = run(seed=11, fault_plan=CRASH_AFTER_PULL, trace_jsonl=path)
    np.testing.assert_array_equal(baseline, result.output)
    with open(path, encoding="utf-8") as fh:
        spans = [json.loads(line) for line in fh if line.strip()]
    assert {s["trace_id"] for s in spans} == {result.trace_id} == {"exec_chaos_11"}
    assert "chaos_usdu" in {s["name"] for s in spans}
    assert result.usage["totals"]["conserved"]
    assert result.usage["totals"]["dispatch_chip_ns"] > 0


# --- tests/test_chaos_cache.py ----------------------------------------------


def _assert_warm_dispatch_free(warm, n_tiles: int) -> None:
    workers = {k: v for k, v in warm.tiles_by_worker.items() if k != "master"}
    assert all(v == 0 for v in workers.values()), warm.tiles_by_worker
    assert warm.tiles_by_worker["master"] == n_tiles


def test_cold_then_warm_bit_identical_and_dispatch_free(baseline):
    cache = TileResultCache(ram_mb=64)
    cold = run(seed=11, cache=cache)
    np.testing.assert_array_equal(baseline, cold.output)
    n = cold.cache["puts"]
    assert n > 0 and cold.cache["hits"] == 0
    assert cold.cache["misses"] == n

    warm = run(seed=11, cache=cache)
    np.testing.assert_array_equal(baseline, warm.output)
    assert warm.cache["hits"] - cold.cache["hits"] == n
    assert warm.cache["settled"] - cold.cache["settled"] == n
    assert warm.cache["puts"] == n
    _assert_warm_dispatch_free(warm, n)


def test_populate_under_crash_after_pull_then_warm_bit_identical(baseline):
    cache = TileResultCache(ram_mb=64)
    cold = run(seed=11, fault_plan=CRASH_AFTER_PULL, cache=cache)
    assert "w1" in cold.crashed_workers
    np.testing.assert_array_equal(baseline, cold.output)
    n = cold.cache["puts"]

    warm = run(seed=11, cache=cache)
    np.testing.assert_array_equal(baseline, warm.output)
    assert warm.cache["settled"] - cold.cache["settled"] == n
    _assert_warm_dispatch_free(warm, n)


def test_populate_under_speculative_race_then_warm_bit_identical(baseline):
    cache = TileResultCache(ram_mb=64)
    cold = run(seed=11, fault_plan=STRAGGLER, worker_timeout=10.0, watchdog={}, cache=cache)
    assert any(cold.speculated.values()), cold.speculated
    np.testing.assert_array_equal(baseline, cold.output)
    n = cold.cache["puts"]
    assert n == cold.cache["misses"]

    warm = run(seed=11, cache=cache)
    np.testing.assert_array_equal(baseline, warm.output)
    assert warm.cache["settled"] - cold.cache["settled"] == n
    _assert_warm_dispatch_free(warm, n)


def test_disk_tier_warm_restart_and_corrupt_entry_degrade(tmp_path, baseline):
    disk = str(tmp_path / "tile-cache")
    cold = run(seed=11, cache=TileResultCache(ram_mb=64, disk_dir=disk, disk_mb=64))
    np.testing.assert_array_equal(baseline, cold.output)
    n = cold.cache["puts"]

    warm = run(seed=11, cache=TileResultCache(ram_mb=64, disk_dir=disk, disk_mb=64))
    np.testing.assert_array_equal(baseline, warm.output)
    assert warm.cache["hits_disk"] == n and warm.cache["hits_ram"] == 0
    assert warm.cache["settled"] == n
    _assert_warm_dispatch_free(warm, n)

    victim = sorted((tmp_path / "tile-cache").rglob("*.tile"))[0]
    blob = bytearray(victim.read_bytes())
    blob[-1] ^= 0xFF
    victim.write_bytes(bytes(blob))
    hurt = run(seed=11, cache=TileResultCache(ram_mb=64, disk_dir=disk, disk_mb=64))
    np.testing.assert_array_equal(baseline, hurt.output)
    assert hurt.cache["corrupt"] == 1
    assert hurt.cache["settled"] == n - 1
    assert hurt.cache["puts"] == 1


# --- across the packages ------------------------------------------------------

# Bicubic resize and the feathered blend are f32 in both packages; a
# value that lands within an ulp of a k + 0.5 level rounds to a
# neighbouring 8-bit level in one of them, so one pixel may move by 1/255.
CROSS_PACKAGE_TOLERANCE = 1.0 / 255 + 1e-6


def jax_noise(seed: int):
    """The JAX harness's per-tile noise: normal(fold_in(key(seed), g))."""
    import jax

    key = jax.random.key(seed)

    def noise(tile_index, shape):
        draw = jax.random.normal(jax.random.fold_in(key, int(tile_index)), tuple(shape))
        return torch.from_numpy(np.array(draw, dtype=np.float32))

    return noise


def test_the_fault_free_canvas_matches_the_jax_harness():
    from comfyui_distributed_tpu.resilience.chaos import run_chaos_usdu as jax_run

    jax_out = jax_run(seed=11).output
    port_out = run(seed=11, noise=jax_noise(11)).output
    assert port_out.shape == jax_out.shape == (1, 128, 128, 3)
    diff = np.abs(port_out - np.asarray(jax_out, np.float32))
    assert float(diff.max()) <= CROSS_PACKAGE_TOLERANCE, float(diff.max())
    # a flip is rare: nearly every value is equal
    assert float((diff > 0).mean()) < 0.01


def test_the_crash_after_pull_plan_fires_alike_in_both_packages():
    from comfyui_distributed_tpu.resilience.chaos import run_chaos_usdu as jax_run

    jax_result = jax_run(seed=11, fault_plan=CRASH_AFTER_PULL)
    port_result = run(seed=11, fault_plan=CRASH_AFTER_PULL)

    def counts(result):
        return collections.Counter((a.kind, a.op) for a in result.fired)

    assert counts(port_result) == counts(jax_result)
    assert counts(port_result) == {("latency", "store:pull:master"): 3,
                                   ("crash", "chaos:w1:pulled"): 1}
    assert port_result.crashed_workers == jax_result.crashed_workers == ["w1"]


# --- the arguments that wait for later steps ---------------------------------


@pytest.mark.parametrize("argument, value, step", [
    ("tile_batch", 4, "7b"),
    ("mesh_devices", 4, "step 8"),
    ("journal_dir", "wal", "7f"),
    ("device_canvas", True, "7j"),
])
def test_each_waiting_argument_names_its_step(argument, value, step, tmp_path, baseline):
    if argument == "journal_dir":
        # step 7f brought the journal: the run journals into the directory
        # and its canvas is the fault-free one
        from comfyui_distributed_tpu_torch.durability.recovery import verify_idempotent_replay

        value = str(tmp_path / value)
        np.testing.assert_array_equal(baseline, run(seed=11, **{argument: value}).output)
        assert verify_idempotent_replay(value)
        return
    with pytest.raises(NotImplementedError, match=step):
        run(seed=11, **{argument: value})
    assert not (tmp_path / "wal").exists()


@pytest.mark.parametrize("argument, value", [("tile_batch", 1), ("mesh_devices", 1),
                                             ("mesh_devices", 0), ("journal_dir", None),
                                             ("device_canvas", False)])
def test_the_served_values_of_the_waiting_arguments_run(argument, value, baseline):
    np.testing.assert_array_equal(baseline, run(seed=11, **{argument: value}).output)
