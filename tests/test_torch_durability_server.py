"""A journaling port master on loopback, on the CPU: DistributedServer with
CDT_JOURNAL_DIR (and w1, which never journals) runs the tiny-unet elastic
upscale through /distributed/queue, and

- every acknowledged transition of the job is in the journal (one
  job_init, each tile pulled and submitted once, w1's worker_done when
  its final flush reached the live job, one cleanup), w1's submits
  durable and the master's volatile, replay idempotent;
- /distributed/durability answers `enabled`, `role` active, the lease's
  epoch and the appends; the scrape has the seven durability families,
  appends by record equal to the journal's, one fsync an append
  (CDT_JOURNAL_FSYNC=1); the brownout's and the SLO engine's journal
  windows took every append; an incident bundle has its `durability`
  section;
- a restart on the same directory recovers (nothing left to resume: the
  job was cleaned up) under the epoch one above;
- a master whose lease another claimant takes is deposed: the route says
  so, the bus publishes `master_deposed`, and its next store mutation is
  fenced before anything is journaled.
"""

import asyncio
import collections
import json
import os
import socket
import time
import urllib.request

import numpy as np
import pytest

import chip_smoke
from comfyui_distributed_tpu_torch.api.server import DistributedServer
from comfyui_distributed_tpu_torch.durability import (
    FencedOut,
    Lease,
    read_lease,
    replay_journal,
)
from comfyui_distributed_tpu_torch.durability import lease as lease_mod
from comfyui_distributed_tpu_torch.durability.recovery import verify_idempotent_replay
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.resilience import health
from comfyui_distributed_tpu_torch.telemetry import events, metrics
from comfyui_distributed_tpu_torch.utils import config as config_mod
from comfyui_distributed_tpu_torch.utils import image as timg
from comfyui_distributed_tpu_torch.utils.network import request_json

from test_torch_parity import one_torch_thread, port_loop  # noqa: F401  (fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.usefixtures("one_torch_thread")

FAMILIES = ("cdt_journal_appends_total", "cdt_journal_fsync_seconds", "cdt_snapshots_total",
            "cdt_snapshot_age_seconds", "cdt_recovery_replayed_records",
            "cdt_recovery_requeued_tasks", "cdt_failover_total")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _wait_done(url, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status, history = request_json("GET", url, timeout=10)
        if status == 200 and history.get("done"):
            return history
        time.sleep(0.1)
    raise AssertionError(f"{url} not done within {timeout} s")


@pytest.fixture
def journaled(tmp_path, monkeypatch, port_loop):
    """`boot()` starts a master (CDT_JOURNAL_DIR = tmp_path/wal,
    CDT_INCIDENT_DIR set) and w1 on one loop, `halt(servers)` stops them;
    every pair still running is stopped at teardown."""
    monkeypatch.setattr(metrics, "_registry", None)
    monkeypatch.setattr(events, "_bus", None)
    monkeypatch.setattr(health, "_registry", None)
    monkeypatch.setenv("CDT_JOURNAL_DIR", str(tmp_path / "wal"))
    monkeypatch.setenv("CDT_INCIDENT_DIR", str(tmp_path / "incidents"))
    (tmp_path / "in").mkdir()
    pixels = np.random.default_rng(0).random((64, 64, 3), dtype=np.float32)
    (tmp_path / "in" / "input.png").write_bytes(timg.encode_png(pixels))
    bundle = tpl.load_pipeline("tiny-unet", seed=0, device="cpu")
    running = []

    def boot():
        master_port, worker_port = _free_port(), _free_port()
        config_path = str(tmp_path / "config.json")
        config_mod.save_config({
            "master": {"host": "127.0.0.1"},
            "workers": [{"id": "w1", "name": "w1", "type": "remote", "host": "127.0.0.1",
                         "port": worker_port, "enabled": True}],
            "settings": {"input_dir": str(tmp_path / "in"), "output_dir": str(tmp_path / "out")},
        }, config_path)
        master = DistributedServer(port=master_port, is_worker=False, config_path=config_path,
                                   device="cpu")
        worker = DistributedServer(port=worker_port, is_worker=True, config_path=config_path,
                                   device="cpu")
        for server in (master, worker):
            server.execution_context.pipelines["tiny-unet"] = bundle

        async def start():
            await master.start()
            await worker.start()

        asyncio.run_coroutine_threadsafe(start(), port_loop.loop).result(timeout=60)
        running.append((master, worker))
        return master, worker

    def halt(pair):
        async def stop():
            for server in pair:
                await server.stop()

        running.remove(pair)
        asyncio.run_coroutine_threadsafe(stop(), port_loop.loop).result(timeout=60)

    yield boot, halt, tmp_path / "wal"
    for pair in list(running):
        halt(pair)


def _upscale_prompt():
    with open(os.path.join(REPO, "workflows", "distributed-upscale.json"), encoding="utf-8") as fh:
        prompt = json.load(fh)
    prompt["1"]["inputs"]["ckpt_name"] = "tiny-unet"
    prompt["5"]["inputs"].update(steps=1, tile_width=64, tile_height=64, tile_padding=16)
    return prompt


def _durability(server) -> dict:
    status, body = request_json("GET", f"http://127.0.0.1:{server.port}/distributed/durability",
                                timeout=10)
    assert status == 200
    return body


def test_a_journaling_master_journals_the_upscale_and_recovers_on_restart(journaled):
    boot, halt, wal = journaled
    master, worker = boot()
    assert master.durability is not None and worker.durability is None
    assert _durability(worker) == {"enabled": False, "hint": "set CDT_JOURNAL_DIR to enable"}
    first = _durability(master)
    assert first["enabled"] is True and first["role"] == "active" and first["epoch"] == 1
    assert first["appends"] == 0 and first["recovery"]["performed"] is False
    base = f"http://127.0.0.1:{master.port}"
    status, queued = request_json("POST", f"{base}/distributed/queue", {
        "prompt": _upscale_prompt(), "client_id": "test", "workers": ["w1"]}, timeout=30)
    assert status == 200 and queued["workers"] == ["w1"], queued
    history = _wait_done(f"{base}/history/{queued['prompt_id']}")
    worker_history = _wait_done(f"http://127.0.0.1:{worker.port}/history/{queued['trace_id']}_w0")
    assert history["error"] is None and worker_history["error"] is None
    job_id = queued["job_ids"]["5"]
    finished = master.job_store.finished[job_id]
    n_tiles = finished["total"]

    records = replay_journal(str(wal)).records
    by_type = collections.Counter(r["type"] for r in records)
    assert set(by_type) <= {"job_init", "pull", "submit", "worker_done", "cleanup"}, by_type
    assert by_type["job_init"] == by_type["cleanup"] == 1
    assert all(r["job"] == job_id for r in records)
    pulled = sorted(t for r in records if r["type"] == "pull" for t in r["tasks"])
    submits = [r for r in records if r["type"] == "submit"]
    assert pulled == sorted(r["task"] for r in submits) == list(range(n_tiles))
    # who submitted each tile is who the store records completing it
    assert sorted((r["task"], r["worker"]) for r in submits) == sorted(finished["completions"])
    # w1's final flush is journaled when it reaches the live job; one that
    # lands after the cleanup is dropped late (the store's drop_late, which
    # journals nothing, as the JAX store journals nothing for a gone job)
    assert [r["worker"] for r in records if r["type"] == "worker_done"] in ([], ["w1"])
    assert "w1" in finished["finished_workers"]
    assert any(r["worker"] == "w1" for r in submits)
    for record in submits:
        if record["worker"] == "master":
            assert record["payload"] is None  # volatile: the master's own blend
        else:
            assert record["payload"][0]["image"].startswith("data:image/png;base64,")
    assert verify_idempotent_replay(str(wal))

    status = _durability(master)
    assert status["appends"] == len(records) and status["jobs_tracked"] == 0
    _, samples = chip_smoke._scrape(base)
    with urllib.request.urlopen(f"{base}/distributed/metrics", timeout=30) as resp:
        exposition = resp.read().decode()
    for family in FAMILIES:  # each family from this scrape on, sampled or not
        assert f"# TYPE {family} " in exposition, family
    for kind, count in by_type.items():
        assert chip_smoke._total(samples, "cdt_journal_appends_total", record=kind) == count
    assert chip_smoke._total(samples, "cdt_journal_fsync_seconds_count") == len(records)
    assert chip_smoke._total(samples, "cdt_snapshots_total") >= 1
    brownout = master.scheduler.brownout.snapshot()
    assert brownout["journal_p95_seconds"] > 0 and brownout["level"] == 0
    assert brownout["journal_p95_threshold"] == 0.25
    assert master.slo._counts["journal_latency"][1] == len(records)
    bundle = master.incidents.read_bundle(master.incidents.capture_now(key="drill")["id"])
    assert bundle["durability"]["appends"] == len(records)
    assert bundle["durability"]["epoch"] == 1

    halt((master, worker))
    assert read_lease(str(wal)).expires_at <= time.time()  # released at stop
    master, worker = boot()
    report = master.durability.report.as_json()
    assert report["performed"] is True and report["jobs_recovered"] == 0
    assert report["replayed_records"] == len(records) and report["last_lsn"] == len(records)
    restarted = _durability(master)
    assert restarted["epoch"] == 2 and restarted["recovery"] == report
    assert restarted["admission_held"] is False


def test_a_master_whose_lease_is_taken_is_deposed_and_fenced(journaled, monkeypatch):
    boot, _halt, wal = journaled
    monkeypatch.setattr(lease_mod, "LEASE_TTL_SECONDS", 0.4)
    seen = []
    events.get_event_bus().add_tap(lambda event: seen.append(event))
    master, _worker = boot()
    assert master.durability.lease.ttl == 0.4
    # a second claimant on the same directory takes the lease (forced)
    assert Lease(str(wal), owner="usurper").acquire(force=True) == 2
    deadline = time.monotonic() + 10
    while not master.deposed and time.monotonic() < deadline:
        time.sleep(0.05)
    assert master.deposed
    assert _durability(master)["role"] == "deposed"
    assert any(e.get("type") == "master_deposed" for e in seen)
    head = master.durability.head_lsn()
    from comfyui_distributed_tpu_torch.utils.async_helpers import run_async_in_server_loop

    with pytest.raises(FencedOut):
        run_async_in_server_loop(master.job_store.init_tile_job("after", [0]), timeout=10)
    assert "after" not in master.job_store.tile_jobs
    assert master.durability.head_lsn() == head
