"""The port's quorum lease (comfyui_distributed_tpu_torch/durability/
quorum.py) on the scenarios of tests/test_quorum_lease.py, with the JAX
tests' assertions: majority agreement on (holder, epoch, ttl) with the
file lease's interface; epoch fencing, indeterminate reads and monotonic
epochs survive peer crashes and partial writes. Plus
`quorum_lease_from_env`, which the journaling master calls at start-up,
read as the JAX constants read CDT_LEASE_PEERS. Runs on the CPU.
"""

import pytest

from comfyui_distributed_tpu_torch.durability.lease import (
    LeaseHeld,
    LeaseLost,
    LeaseState,
)
from comfyui_distributed_tpu_torch.durability.quorum import (
    FileLeasePeer,
    MemoryLeasePeer,
    QuorumLease,
    quorum_lease_from_env,
)


class Clock:
    def __init__(self, now: float = 1000.0):
        self.now = now

    def __call__(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += seconds


def trio():
    return [MemoryLeasePeer(f"p{i}") for i in range(3)]


def test_acquire_on_empty_cluster_takes_epoch_one():
    clock = Clock()
    lease = QuorumLease(trio(), owner="a", ttl=10.0, clock=clock)
    assert lease.acquire() == 1
    assert lease.epoch == 1
    assert lease.held()
    assert lease.quorum == 2


def test_live_foreign_lease_blocks_unforced_acquire():
    clock = Clock()
    peers = trio()
    a = QuorumLease(peers, owner="a", ttl=10.0, clock=clock)
    b = QuorumLease(peers, owner="b", ttl=10.0, clock=clock)
    a.acquire()
    with pytest.raises(LeaseHeld):
        b.acquire()
    # expiry opens the unforced path (the standby promotion gate)
    clock.advance(11.0)
    assert b.acquire() == 2


def test_forced_takeover_fences_the_zombie():
    clock = Clock()
    peers = trio()
    a = QuorumLease(peers, owner="a", ttl=10.0, clock=clock)
    b = QuorumLease(peers, owner="b", ttl=10.0, clock=clock)
    a.acquire()
    assert b.acquire(force=True) == 2
    # inside a's trust window the zombie still answers from cache...
    assert a.held()
    # ...but a verified read sees the epoch bump: fenced
    assert not a.held(verify=True)
    assert a.epoch == 0
    with pytest.raises(LeaseLost):
        a.renew()


def test_same_epoch_race_cannot_elect_two_masters():
    """Two claimants proposing the same epoch: each peer accepts the
    first and rejects the second (same epoch, different owner), so
    only one can assemble a majority — the loser sees LeaseHeld."""
    clock = Clock()
    peers = trio()
    winner = QuorumLease(peers, owner="w", ttl=10.0, clock=clock)
    assert winner.acquire() == 1
    loser = QuorumLease(peers, owner="l", ttl=10.0, clock=clock)
    # the loser raced: it read the cluster as empty and proposes the
    # same epoch the winner just took
    accepts, best_reject = loser._propose_all(
        LeaseState(1, "l", clock() + 10.0, clock())
    )
    assert accepts == 0
    assert best_reject is not None and best_reject.owner == "w"


def test_indeterminate_read_majority_blocks_acquire():
    clock = Clock()
    peers = trio()
    peers[0].fail_reads = 1
    peers[1].fail_reads = 1
    lease = QuorumLease(peers, owner="a", ttl=10.0, clock=clock)
    with pytest.raises(OSError):
        lease.acquire()
    # blips cleared: the next attempt goes through
    assert lease.acquire() == 1


def test_held_keeps_cached_verdict_on_indeterminate_cluster():
    """An unreachable peer majority neither confirms nor denies a
    takeover: held() keeps the cached verdict and does NOT advance the
    trust window — the next majority read still runs the real check."""
    clock = Clock()
    peers = trio()
    lease = QuorumLease(peers, owner="a", ttl=8.0, clock=clock)
    lease.acquire()
    verified_at = lease._last_verified
    clock.advance(3.0)  # beyond ttl/4: a re-read is due
    peers[0].fail_reads = 1
    peers[1].fail_reads = 1
    assert lease.held()
    assert lease._last_verified == verified_at  # window NOT advanced
    # the cluster heals and a takeover happened meanwhile: caught now
    usurper = QuorumLease(peers, owner="b", ttl=8.0, clock=clock)
    usurper.acquire(force=True)
    assert not lease.held()


def test_mid_acquire_peer_crash_still_elects_and_stays_monotonic():
    """One peer crashing mid-propose (either before or after applying)
    leaves a majority standing: the acquire succeeds, and later
    claimants read the surviving registers so epochs never regress."""
    for mode in ("before", "after"):
        clock = Clock()
        peers = trio()
        peers[2].crash_next_propose = mode
        a = QuorumLease(peers, owner="a", ttl=10.0, clock=clock)
        assert a.acquire() == 1
        assert a.held(verify=True)
        b = QuorumLease(peers, owner="b", ttl=10.0, clock=clock)
        assert b.acquire(force=True) == 2


def test_partial_write_burns_epoch_but_never_regresses():
    """Proposer reaching only a minority: the acquire is indeterminate
    (OSError), but the next claimant reads the burned epoch from the
    partially-written register and goes higher."""
    clock = Clock()
    peers = trio()
    peers[1].fail_writes = 1
    peers[2].crashed = True
    a = QuorumLease(peers, owner="a", ttl=10.0, clock=clock)
    with pytest.raises(OSError):
        a.acquire()  # only p0 applied epoch 1
    assert not a.held()
    peers[2].crashed = False
    b = QuorumLease(peers, owner="b", ttl=10.0, clock=clock)
    # the partial write might have been a successful acquire from the
    # cluster's point of view, so an unforced claimant waits the TTL out
    with pytest.raises(LeaseHeld):
        b.acquire()
    clock.advance(11.0)
    assert b.acquire() == 2  # burned epoch 1 is never reused


def test_renew_catches_up_lagging_peer_and_detects_takeover():
    clock = Clock()
    peers = trio()
    peers[2].crashed = True
    a = QuorumLease(peers, owner="a", ttl=10.0, clock=clock)
    a.acquire()  # p2 missed it
    peers[2].crashed = False
    a.renew()  # p2 catches up here
    assert peers[2].read().epoch == 1
    b = QuorumLease(peers, owner="b", ttl=10.0, clock=clock)
    b.acquire(force=True)
    with pytest.raises(LeaseLost):
        a.renew()


def test_renew_indeterminate_is_oserror_not_lost():
    """A write blip majority must surface as a retryable OSError —
    never as LeaseLost; one blip cannot depose a healthy active."""
    clock = Clock()
    peers = trio()
    a = QuorumLease(peers, owner="a", ttl=10.0, clock=clock)
    a.acquire()
    peers[0].fail_writes = 1
    peers[1].fail_writes = 1
    with pytest.raises(OSError):
        a.renew()
    a.renew()  # blip cleared: renewal heals
    assert a.held(verify=True)


def test_release_opens_immediate_unforced_takeover():
    clock = Clock()
    peers = trio()
    a = QuorumLease(peers, owner="a", ttl=10.0, clock=clock)
    a.acquire()
    a.release()
    b = QuorumLease(peers, owner="b", ttl=10.0, clock=clock)
    assert b.acquire() == 2  # no TTL wait


def test_status_surfaces_per_peer_registers():
    clock = Clock()
    peers = trio()
    peers[2].crashed = True
    a = QuorumLease(peers, owner="a", ttl=10.0, clock=clock)
    a.acquire()
    status = a.status()
    assert status["backend"] == "quorum"
    assert status["quorum"] == 2
    assert status["peers"][0]["state"]["epoch"] == 1
    assert "error" in status["peers"][2]


def test_file_peers_round_trip_without_a_shared_directory(tmp_path):
    """Three independent register directories (one per node): the
    quorum agrees with no directory shared between peers, and a
    corrupt register reads as empty without breaking monotonicity."""
    clock = Clock()
    dirs = [tmp_path / f"peer{i}" for i in range(3)]
    peers = [FileLeasePeer(str(d), name=f"p{i}") for i, d in enumerate(dirs)]
    a = QuorumLease(peers, owner="a", ttl=10.0, clock=clock)
    assert a.acquire() == 1
    assert a.held(verify=True)
    # corrupt one register: the other two carry the epoch
    (dirs[0] / "peer_register.json").write_text("{not json")
    b = QuorumLease(
        [FileLeasePeer(str(d), name=f"p{i}") for i, d in enumerate(dirs)],
        owner="b", ttl=10.0, clock=clock,
    )
    assert b.acquire(force=True) == 2
    assert not a.held(verify=True)


@pytest.mark.parametrize("raw", ["", " , ", "a", "a, b ,c"])
def test_lease_peers_are_read_as_the_jax_constants_read_them(raw, tmp_path, monkeypatch):
    import importlib

    from comfyui_distributed_tpu.utils import constants as jconstants
    from comfyui_distributed_tpu_torch.utils import constants as tconstants

    value = ",".join(str(tmp_path / p.strip()) if p.strip() else p for p in raw.split(","))
    monkeypatch.setenv("CDT_LEASE_PEERS", value)
    try:
        port_peers = importlib.reload(tconstants).LEASE_PEERS
        jax_peers = importlib.reload(jconstants).LEASE_PEERS
    finally:
        monkeypatch.delenv("CDT_LEASE_PEERS")
        importlib.reload(tconstants)
        importlib.reload(jconstants)
    assert port_peers == jax_peers
    monkeypatch.setattr(tconstants, "LEASE_PEERS", port_peers)
    lease = quorum_lease_from_env("master:test")
    if not port_peers:
        assert lease is None
        return
    assert [p.directory for p in lease.peers] == port_peers
    assert [p.name for p in lease.peers] == [f"peer{i}" for i in range(len(port_peers))]
    assert lease.quorum == len(port_peers) // 2 + 1
    assert lease.acquire(force=True) == 1
    assert lease.held(verify=True)
