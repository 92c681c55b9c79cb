"""The port's chaos harness with the write-ahead journal (comfyui_distributed_tpu_torch/
resilience/chaos.py): the three kill-the-master scenarios of
tests/test_chaos_usdu.py (`run_chaos_master_crash`), and the three cancel
scenarios and the journaled poison scenario of tests/test_chaos_lifecycle.py
(`run_chaos_cancel`, `run_chaos_poison(journal_dir=...)`), with the JAX
tests' plans and assertions. Every recovered canvas is held to the
fault-free canvas of its seed with assert_array_equal (seed 11's master
killed after a pull included). Runs on the CPU.
"""

import json

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu_torch.durability import replay_journal
from comfyui_distributed_tpu_torch.durability.recovery import verify_idempotent_replay
from comfyui_distributed_tpu_torch.resilience import faults
from comfyui_distributed_tpu_torch.resilience.chaos import (
    run_chaos_cancel,
    run_chaos_master_crash,
    run_chaos_poison,
    run_chaos_usdu,
)

from test_torch_parity import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def baseline():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_chaos_usdu(seed=11, device="cpu").output
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_injector_left():
    yield
    assert faults.get_fault_injector() is None


# --- kill-the-master (tests/test_chaos_usdu.py) -------------------------------

# the workers' first pulls are held back, so the master claims tile 0
# at once and is killed at its first submit: the claim is in flight at
# death and recovery must requeue it
KILLED_AFTER_PULL = ("latency(1.5)@store:pull:w1#1;latency(1.5)@store:pull:w2#1;"
                     "crash@store:submit:master#1")
# ... or at its second: submit #1 lands in the journal, #2 is the kill
KILLED_AFTER_PARTIAL_SUBMIT = ("latency(1.5)@store:pull:w1#1;latency(1.5)@store:pull:w2#1;"
                               "crash@store:submit:master#2")


def test_master_killed_after_pull_recovers_bit_identical(baseline, tmp_path):
    journal_dir = str(tmp_path / "wal")
    result = run_chaos_master_crash(seed=11, crash_plan=KILLED_AFTER_PULL,
                                    journal_dir=journal_dir, device="cpu")
    assert "crash" in result.fired_kinds()  # the master actually died
    assert result.report["performed"]
    assert result.report["jobs_recovered"] == 1
    assert result.report["tasks_requeued"] >= 1  # the in-flight claim
    np.testing.assert_array_equal(baseline, result.output)
    # the restarted master journaled the job to its cleanup
    assert replay_journal(journal_dir).records[-1]["type"] == "cleanup"


def test_master_killed_after_partial_submit_recovers_bit_identical(baseline, tmp_path):
    result = run_chaos_master_crash(seed=11, crash_plan=KILLED_AFTER_PARTIAL_SUBMIT,
                                    journal_dir=str(tmp_path / "wal"), device="cpu")
    assert "crash" in result.fired_kinds()
    assert result.report["performed"]
    # something real was at stake: recovery requeued in-flight tiles or
    # restored durable worker results (typically both)
    assert result.report["tasks_requeued"] + result.report["tasks_restored"] > 0, result.report
    np.testing.assert_array_equal(baseline, result.output)


def test_master_crash_recovery_is_idempotent(tmp_path):
    journal_dir = str(tmp_path / "wal")
    # the master's slowed first pull lets workers win tiles (their durable
    # payloads land in the journal), then its second pull is the kill
    result = run_chaos_master_crash(
        seed=11, crash_plan="latency(0.3)@store:pull:master#1;crash@store:pull:master#2",
        journal_dir=journal_dir, device="cpu")
    assert "crash" in result.fired_kinds()
    assert verify_idempotent_replay(journal_dir)


def test_a_plan_that_never_kills_the_master_fails_the_run(tmp_path):
    with pytest.raises(RuntimeError, match="never fired"):
        run_chaos_master_crash(seed=11, crash_plan="crash@store:submit:master#99",
                               journal_dir=str(tmp_path / "wal"), workers=(), device="cpu")


# --- cooperative cancellation (tests/test_chaos_lifecycle.py) -----------------


@pytest.fixture(scope="module")
def cancelled(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_chaos_cancel(seed=11, journal_dir=str(tmp_path_factory.mktemp("wal")),
                                device="cpu")
    finally:
        torch.set_num_threads(threads)


def test_cancel_mid_job_refunds_everything_and_settles_terminal(cancelled):
    result = cancelled
    # the master unwound with the terminal status, carrying the reason
    assert result.raised == "JobCancelled"
    assert result.reason == "chaos"
    # the cancel hit a live job: work had completed and was outstanding
    assert result.completed_before_cancel >= 2
    acct = result.accounting
    assert acct["pending_refunded"] + acct["in_flight_refunded"] > 0
    # no leaked assignment the instant the cancel returned
    assert result.stats_after["in_flight"] == 0
    assert result.stats_after["queue_depth"] == 0


def test_cancel_round_trips_journal_and_replica(cancelled):
    result = cancelled
    # the shadow state at cancel time is terminally drained: what a
    # crash-after-cancel recovery replays to
    assert result.state_after_cancel.get("cancelled") is True
    assert result.state_after_cancel.get("pending") == []
    assert result.state_after_cancel.get("assigned") == {}
    # the standby replica applied the same cancel record
    assert result.replica_saw_cancel
    # after the master's cleanup both views agree the job is gone
    assert result.journal_jobs_after == {}
    assert result.replica_jobs_after == {}
    assert result.idempotent_replay
    assert result.cancel_latency_ms > 0


def test_cancelled_job_does_not_perturb_other_runs(tmp_path):
    """A cancel in one run leaves the determinism of the others alone: an
    undisturbed run before and after gives the bit-identical canvas."""
    before = run_chaos_usdu(seed=13, job_id="cancel-bystander-1", device="cpu")
    run_chaos_cancel(seed=11, journal_dir=str(tmp_path / "wal"), job_id="cancel-victim",
                     device="cpu")
    after = run_chaos_usdu(seed=13, job_id="cancel-bystander-2", device="cpu")
    np.testing.assert_array_equal(before.output, after.output)


# --- the journaled poison run (tests/test_chaos_lifecycle.py) -----------------


def test_poison_policy_fail_raises_terminal_error_with_the_journal(tmp_path):
    from comfyui_distributed_tpu_torch.utils.exceptions import JobPoisoned

    journal_dir = str(tmp_path / "wal")
    with pytest.raises(JobPoisoned) as err:
        run_chaos_poison(seed=11, journal_dir=journal_dir, poison_policy="fail",
                         job_id="poison-fail-job", device="cpu")
    assert err.value.tiles == [0]
    records = replay_journal(journal_dir).records
    assert [r["tasks"] for r in records if r["type"] == "tile_quarantine"] == [[0]]
    assert verify_idempotent_replay(journal_dir)


def test_a_journaled_usdu_run_equals_the_fault_free_canvas(baseline, tmp_path):
    journal_dir = str(tmp_path / "wal")
    result = run_chaos_usdu(seed=11, journal_dir=journal_dir, device="cpu")
    np.testing.assert_array_equal(baseline, result.output)
    records = replay_journal(journal_dir).records
    assert records[0]["type"] == "job_init" and records[-1]["type"] == "cleanup"
    submits = [r for r in records if r["type"] == "submit"]
    assert sorted(r["task"] for r in submits) == [0, 1, 2, 3]
    # the master's tiles are volatile, the workers' PNG envelopes durable
    for record in submits:
        assert (record["payload"] is None) == (record["worker"] == "master")
    assert json.loads(json.dumps(records)) == records
