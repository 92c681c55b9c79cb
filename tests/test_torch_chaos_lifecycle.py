"""The poison-tile scenarios of tests/test_chaos_lifecycle.py on the port's
harness (comfyui_distributed_tpu_torch/resilience/chaos.py::run_chaos_poison):
a tile that crashes three consecutive workers is quarantined, the crashes
are pardoned on the workers' breakers, and the job completes degraded
with every other tile bit-identical to a clean run, or, under
poison_policy "fail", ends in the port's JobPoisoned.

As in the JAX scenarios, the poison harness runs with a write-ahead
journal; the port's `journal_quarantined` lists the tiles the journal's
tile_quarantine records name (the JAX harness reads them from the state
after the job's cleanup record, where its list is always empty). The
cancel scenarios are in tests/test_torch_chaos_durability.py. Runs on the
CPU.
"""

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu_torch.resilience import faults
from comfyui_distributed_tpu_torch.resilience.chaos import run_chaos_poison, run_chaos_usdu

from test_torch_parity import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def poison_result(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_chaos_poison(seed=11, journal_dir=str(tmp_path_factory.mktemp("poison-wal")),
                                device="cpu")
    finally:
        torch.set_num_threads(threads)


def test_poison_tile_quarantined_after_three_crashes(poison_result):
    r = poison_result
    assert r.crashed_workers == ["w1", "w2", "w3"]
    assert r.attempts.get(r.poison_tile) == 3
    assert r.poison_tile in r.quarantined
    # the journal's tile_quarantine record names the same tile
    assert r.journal_quarantined == r.quarantined == [r.poison_tile]


def test_poison_crash_not_charged_to_the_workers(poison_result):
    r = poison_result
    # every crash opened a circuit at failure_threshold=1 ...
    assert "quarantined" in r.charged_states
    # ... and the quarantine's pardon closed every one of them
    assert sorted(r.pardons) == ["w1", "w2", "w3"]
    for wid, snap in r.health_after.items():
        assert snap["state"] == "healthy", (wid, snap)


def test_poison_job_completes_degraded_with_unaffected_tiles_identical(poison_result):
    r = poison_result
    baseline = run_chaos_usdu(seed=11, image_hw=(96, 96), tile=48, padding=16,
                              job_id="poison-baseline", device="cpu")
    y, x, th, tw = r.poison_rect
    mask = np.ones(r.output.shape, bool)
    mask[:, y:y + th, x:x + tw, :] = False
    np.testing.assert_array_equal(r.output[mask], baseline.output[mask])
    # the quarantined region is the base image, not the sampled tile
    assert not np.array_equal(r.output[:, y:y + th, x:x + tw, :],
                              baseline.output[:, y:y + th, x:x + tw, :])


def test_poison_policy_fail_raises_terminal_error():
    from comfyui_distributed_tpu_torch.utils.exceptions import JobPoisoned

    with pytest.raises(JobPoisoned) as err:
        run_chaos_poison(seed=11, poison_policy="fail", job_id="poison-fail-job", device="cpu")
    assert err.value.tiles == [0]
    assert faults.get_fault_injector() is None


def test_the_poison_journal_waits_for_step_7f(tmp_path):
    """Step 7f brought the journal: without `journal_dir` the poison run
    journals nothing and its `journal_quarantined` is empty; with it the
    directory holds the run's records, replayable twice alike."""
    from comfyui_distributed_tpu_torch.durability.recovery import verify_idempotent_replay

    result = run_chaos_poison(seed=11, job_id="poison-no-journal", device="cpu")
    assert result.journal_quarantined == []
    assert result.quarantined == [0]
    journal_dir = str(tmp_path / "wal")
    journaled = run_chaos_poison(seed=11, journal_dir=journal_dir, job_id="poison-journal",
                                 device="cpu")
    assert journaled.journal_quarantined == journaled.quarantined == [0]
    assert verify_idempotent_replay(journal_dir)
