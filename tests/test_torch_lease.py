"""The port's lease, fencing and replication (comfyui_distributed_tpu_torch/
durability/lease.py, quorum.py, replicate.py and DurabilityManager's
fencing, replica tee and adopt) on the scenarios of tests/test_failover.py
(its lease, fencing and replication sections; the store's epoch fencing
and the standby controller come with ROADMAP Queue 1 step 7g) and of
tests/test_lease_adversarial.py, with the JAX tests' assertions and
injectable clocks, so no test waits out a real TTL. Lease files live
under each test's tmp_path. Runs on the CPU.
"""

import errno
import json
import os
import threading
import time

import pytest

from comfyui_distributed_tpu_torch.durability import (
    DurabilityManager,
    FencedOut,
    Lease,
    LeaseHeld,
    LeaseLost,
    ReplicationSubscription,
    StandbyReplica,
    read_lease,
)
from comfyui_distributed_tpu_torch.durability import lease as lease_mod
from comfyui_distributed_tpu_torch.durability import state as state_mod
from comfyui_distributed_tpu_torch.durability.lease import LeaseState, lease_path
from comfyui_distributed_tpu_torch.durability.quorum import MemoryLeasePeer, QuorumLease


class Clock:
    def __init__(self, now=1000.0):
        self.now = now

    def __call__(self):
        return self.now


# --------------------------------------------------------------------------
# lease: arbitration
# --------------------------------------------------------------------------


def test_acquire_free_lease_starts_at_epoch_one(tmp_path):
    clock = Clock()
    lease = Lease(str(tmp_path), "a", ttl=10.0, clock=clock)
    assert lease.acquire() == 1
    assert lease.epoch == 1
    state = read_lease(str(tmp_path))
    assert (state.owner, state.epoch) == ("a", 1)
    assert state.expires_at == clock.now + 10.0


def test_acquire_respects_live_lease_and_takes_expired_one(tmp_path):
    clock = Clock()
    a = Lease(str(tmp_path), "a", ttl=10.0, clock=clock)
    b = Lease(str(tmp_path), "b", ttl=10.0, clock=clock)
    a.acquire()
    with pytest.raises(LeaseHeld):
        b.acquire()
    clock.now += 11.0  # the active missed renewals for a full TTL
    assert b.acquire() == 2  # epoch bump: the fencing token


def test_forced_acquire_wins_over_a_live_lease(tmp_path):
    clock = Clock()
    a = Lease(str(tmp_path), "a", ttl=10.0, clock=clock)
    b = Lease(str(tmp_path), "b", ttl=10.0, clock=clock)
    a.acquire()
    # restarting-master policy: the newest claimant on the journal dir
    # always wins; the deposed holder is fenced by the epoch bump
    assert b.acquire(force=True) == 2
    assert a.held(verify=True) is False


def test_renew_extends_and_lost_lease_raises(tmp_path):
    clock = Clock()
    a = Lease(str(tmp_path), "a", ttl=10.0, clock=clock)
    a.acquire()
    clock.now += 5.0
    a.renew()
    assert read_lease(str(tmp_path)).expires_at == clock.now + 10.0
    clock.now += 11.0
    b = Lease(str(tmp_path), "b", ttl=10.0, clock=clock)
    b.acquire()
    with pytest.raises(LeaseLost):
        a.renew()
    # a lost handle must not resurrect by renewing again
    with pytest.raises(LeaseLost):
        a.renew()


def test_release_expires_now_so_takeover_skips_the_ttl(tmp_path):
    clock = Clock()
    a = Lease(str(tmp_path), "a", ttl=10.0, clock=clock)
    a.acquire()
    a.release()
    b = Lease(str(tmp_path), "b", ttl=10.0, clock=clock)
    assert b.acquire() == 2  # no TTL wait: the lease file reads expired


def test_release_never_clobbers_a_successor(tmp_path):
    clock = Clock()
    a = Lease(str(tmp_path), "a", ttl=10.0, clock=clock)
    a.acquire()
    clock.now += 11.0
    b = Lease(str(tmp_path), "b", ttl=10.0, clock=clock)
    b.acquire()
    a.release()  # must be a no-op: b owns the file now
    state = read_lease(str(tmp_path))
    assert (state.owner, state.epoch) == ("b", 2)
    assert state.expires_at > clock.now


def test_corrupt_lease_file_reads_as_free(tmp_path):
    with open(lease_path(str(tmp_path)), "w", encoding="utf-8") as fh:
        fh.write("{not json")
    assert read_lease(str(tmp_path)) is None
    lease = Lease(str(tmp_path), "a", ttl=10.0, clock=Clock())
    assert lease.acquire() == 1


def test_racing_acquires_on_expired_lease_yield_exactly_one_winner(tmp_path):
    """Two standbys racing an expired lease must not both take epoch
    N+1 (the same-epoch split brain): the claim mutex serializes the
    read-modify-write cycle, so the loser re-reads the winner's fresh
    lease and raises LeaseHeld. The patched read() widens the
    read->write window far past thread-start skew — without the mutex
    both claimants read the expired lease and both 'win'."""
    clock = Clock()
    dead = Lease(str(tmp_path), "dead", ttl=10.0, clock=clock)
    dead.acquire()
    clock.now += 11.0  # expired: both contenders are entitled to try

    class SlowReadLease(Lease):
        def read(self, strict=False):
            state = super().read(strict=strict)
            time.sleep(0.2)
            return state

    results: dict[str, object] = {}

    def contend(name):
        lease = SlowReadLease(str(tmp_path), name, ttl=10.0, clock=clock)
        try:
            results[name] = lease.acquire()
        except LeaseHeld:
            results[name] = "held"

    threads = [
        threading.Thread(target=contend, args=(n,)) for n in ("s1", "s2")
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert sorted(results.values(), key=str) == [2, "held"]
    winner = next(n for n, r in results.items() if r == 2)
    assert read_lease(str(tmp_path)).owner == winner


def test_leftover_claim_lock_file_never_blocks(tmp_path):
    """The claim mutex is flock-based: a dead claimant's lock released
    with its fd, so a leftover lease.lock FILE (no live holder) must
    not block the next takeover — no stale-lock breaking exists to
    race on."""
    lock = os.path.join(str(tmp_path), "lease.lock")
    with open(lock, "w", encoding="utf-8") as fh:
        fh.write("corpse of a crashed claimant")
    os.utime(lock, (1.0, 1.0))  # ancient mtime must be irrelevant
    lease = Lease(str(tmp_path), "a", ttl=10.0, clock=Clock())
    assert lease.acquire() == 1


def test_transient_read_error_does_not_depose_the_holder(tmp_path):
    """One NFS blip (EIO/ESTALE) while re-reading the lease file must
    read as 'indeterminate', never as 'superseded': renew propagates
    the OSError (the renewal loop retries), held() keeps its cached
    verdict, and the next successful read carries on holding."""
    clock = Clock()
    a = Lease(str(tmp_path), "a", ttl=10.0, clock=clock)
    a.acquire()

    class FlakyLease(Lease):
        flake = False

        def read(self, strict=False):
            if self.flake and strict:
                raise OSError(5, "injected EIO")
            return super().read(strict=strict)

    flaky = FlakyLease(str(tmp_path), "a", ttl=10.0, clock=clock)
    flaky._epoch = a._epoch  # same holder identity
    flaky._last_verified = clock.now
    flaky.flake = True
    with pytest.raises(OSError):
        flaky.renew()
    assert flaky._lost is False  # NOT deposed
    # held() past the trust window keeps the cached verdict on a blip
    clock.now += 5.0  # > ttl/4 since last verification
    assert flaky.held() is True
    flaky.flake = False
    flaky.renew()  # the next good cycle proceeds normally
    assert read_lease(str(tmp_path)).expires_at == clock.now + 10.0
    assert flaky.held(verify=True) is True


def test_racing_renew_and_acquire_cannot_clobber_the_new_epoch(tmp_path):
    """The holder's renew() is also a read-modify-write: serialized
    against a claimant's acquire(), it must observe the taken epoch
    and raise LeaseLost instead of writing its stale epoch back."""
    clock = Clock()
    a = Lease(str(tmp_path), "a", ttl=10.0, clock=clock)
    a.acquire()
    clock.now += 11.0
    b = Lease(str(tmp_path), "b", ttl=10.0, clock=clock)
    assert b.acquire() == 2
    with pytest.raises(LeaseLost):
        a.renew()
    state = read_lease(str(tmp_path))
    assert (state.owner, state.epoch) == ("b", 2)


# --------------------------------------------------------------------------
# lease: the fencing check
# --------------------------------------------------------------------------


def test_held_trusts_clock_within_quarter_ttl_then_rereads(tmp_path):
    clock = Clock()
    a = Lease(str(tmp_path), "a", ttl=8.0, clock=clock)
    a.acquire()
    # b takes over immediately (forced): the file no longer carries a
    b2 = Lease(str(tmp_path), "b", ttl=8.0, clock=clock)
    b2.acquire(force=True)
    # within ttl/4 of a's last verification the stale cache answers...
    clock.now += 1.0
    assert a.held() is True  # the bounded zombie window
    # ...beyond it the re-read notices the takeover
    clock.now += 1.5  # 2.5 > 8/4
    assert a.held() is False
    assert a.epoch == 0


def test_held_verify_bypasses_the_trust_window(tmp_path):
    clock = Clock()
    a = Lease(str(tmp_path), "a", ttl=8.0, clock=clock)
    a.acquire()
    Lease(str(tmp_path), "b", ttl=8.0, clock=clock).acquire(force=True)
    assert a.held(verify=True) is False


def test_fenced_manager_refuses_to_journal(tmp_path):
    clock = Clock()
    journal_dir = str(tmp_path / "wal")
    os.makedirs(journal_dir)
    manager = DurabilityManager(journal_dir, fsync_every=1)
    lease = Lease(journal_dir, "active", ttl=8.0, clock=clock)
    lease.acquire()
    manager.lease = lease
    manager.record({"type": "job_init", "job": "j", "tasks": [0]})
    head = manager.head_lsn()
    # a standby takes the lease; the zombie's next append must raise
    # BEFORE any bytes land
    Lease(journal_dir, "standby", ttl=8.0, clock=clock).acquire(force=True)
    clock.now += 3.0  # past the ttl/4 trust window
    with pytest.raises(FencedOut):
        manager.record({"type": "cleanup", "job": "j"})
    assert manager.head_lsn() == head  # journaled NOTHING
    manager.close()


# --------------------------------------------------------------------------
# replication: subscription + replica
# --------------------------------------------------------------------------


def test_subscription_preserves_order_and_overflow_marks_lost():
    sub = ReplicationSubscription({}, head_lsn=0, maxlen=3)
    for lsn in (1, 2, 3):
        sub.offer({"lsn": lsn})
    assert [r["lsn"] for r in sub.pop()] == [1, 2, 3]
    for lsn in (4, 5, 6, 7):  # one past maxlen
        sub.offer({"lsn": lsn})
    assert sub.lost is True
    assert sub.pop() == []  # never a hole: the buffer clears entirely


def test_subscription_wait_wakes_on_offer():
    sub = ReplicationSubscription({}, head_lsn=0)
    woke = []

    def consumer():
        woke.append(sub.wait(5.0))

    thread = threading.Thread(target=consumer)
    thread.start()
    sub.offer({"lsn": 1})
    thread.join(timeout=10)
    assert woke == [True]


def test_replica_applies_dedups_and_tracks_lag():
    clock = Clock()
    replica = StandbyReplica(clock=clock)
    assert replica.synced is False
    snapshot = state_mod.new_state()
    snapshot["last_lsn"] = 5
    replica.reset(snapshot, head_lsn=5, epoch=3)
    assert replica.synced is True
    assert replica.source_epoch == 3
    # frames at or below the snapshot lsn are already covered
    assert replica.apply({"type": "job_init", "job": "j", "tasks": [0], "lsn": 5}) is False
    assert replica.apply({"type": "job_init", "job": "j", "tasks": [0, 1], "lsn": 6}) is True
    assert replica.last_lsn() == 6
    replica.note_head(9)
    assert replica.lag_records() == 3
    clock.now += 2.0
    assert replica.lag_seconds() == pytest.approx(2.0)
    status = replica.status()
    assert status["applied_records"] == 1
    assert status["jobs_tracked"] == 1


def test_replica_reset_counts_resyncs_and_clones_state():
    replica = StandbyReplica(clock=Clock())
    snapshot = state_mod.new_state()
    replica.reset(snapshot, head_lsn=0)
    snapshot["jobs"]["mutated-after"] = {}  # caller's buffer, not ours
    assert replica.status()["jobs_tracked"] == 0
    replica.reset(state_mod.new_state(), head_lsn=0)
    assert replica.resyncs == 1


def test_subscribe_replica_is_attach_consistent(tmp_path):
    """No record between the snapshot serialization and the first teed
    frame: applying the tee on top of the hello snapshot always equals
    the manager's shadow, whenever the attach happened."""
    journal_dir = str(tmp_path / "wal")
    manager = DurabilityManager(journal_dir, fsync_every=1)
    manager.record({"type": "job_init", "job": "j", "tasks": [0, 1, 2]})
    manager.record({"type": "pull", "job": "j", "worker": "w1", "tasks": [0]})
    sub = manager.subscribe_replica()
    replica = StandbyReplica(clock=Clock())
    replica.reset(sub.snapshot_state, sub.head_lsn, sub.epoch)
    manager.record({"type": "submit", "job": "j", "worker": "w1", "task": 0,
                    "payload": None})
    manager.record({"type": "pull", "job": "j", "worker": "w2", "tasks": [1]})
    for record in sub.pop():
        replica.apply(record)
    assert replica.lag_records() == 0
    # the replica's state IS the manager's shadow, byte for byte
    assert json.dumps(replica.status()["applied_lsn"]) == json.dumps(
        manager.head_lsn()
    )
    status = manager.status()
    assert status["replication"]["standbys"] == 1
    manager.unsubscribe_replica(sub)
    assert manager.status()["replication"]["standbys"] == 0
    manager.close()


def test_adopt_promotes_replica_into_live_store(tmp_path):
    """DurabilityManager.adopt = disk recovery with the replica
    standing in for snapshot + WAL tail: in-flight tiles requeue,
    durable worker payloads restore, the journal reopens at the
    replicated head, and the promotion counts a failover."""
    from comfyui_distributed_tpu_torch.jobs import JobStore

    journal_dir = str(tmp_path / "wal")
    active = DurabilityManager(journal_dir, fsync_every=1)
    active.record({"type": "job_init", "job": "j", "tasks": [0, 1, 2]})
    sub = active.subscribe_replica()
    replica = StandbyReplica(clock=Clock())
    replica.reset(sub.snapshot_state, sub.head_lsn, sub.epoch)
    active.record({"type": "pull", "job": "j", "worker": "w1", "tasks": [0, 1]})
    active.record({"type": "submit", "job": "j", "worker": "w1", "task": 0,
                   "payload": [{"batch_idx": 0, "image": "data:..."}]})
    for record in sub.pop():
        replica.apply(record)
    active.close()

    store = JobStore()
    standby = DurabilityManager(journal_dir, fsync_every=1)
    lease = Lease(journal_dir, "standby", ttl=8.0, clock=Clock())
    epoch = lease.acquire()
    report = standby.adopt(store, replica, lease=lease)
    assert report.jobs_recovered == 1
    assert report.tasks_requeued == 1   # tile 1: in flight, revoked
    assert report.tasks_restored == 1   # tile 0: durable payload kept
    job = store.tile_jobs["j"]
    assert job.pending.qsize() == 2     # tiles 1 + 2
    assert job.assigned == {}
    assert standby.epoch == epoch
    assert standby.failovers == 1
    assert standby.head_lsn() == replica.last_lsn()
    # the promoted journal accepts appends at the replicated head
    standby.record({"type": "cleanup", "job": "j"})
    assert standby.head_lsn() == replica.last_lsn() + 1
    standby.close()



# --------------------------------------------------------------------------
# adversarial cases (tests/test_lease_adversarial.py)
# --------------------------------------------------------------------------



def test_three_claimants_racing_an_expired_lease(tmp_path):
    """Three threads race acquire() on the same expired lease: the
    flock sidecar serializes the read-modify-write cycles, so exactly
    one claimant takes epoch+1 and the other two re-read its fresh
    lease and raise LeaseHeld — never a duplicated epoch."""
    directory = str(tmp_path)
    # an expired previous incarnation at epoch 5
    old = Lease(directory, owner="old", ttl=0.05)
    for _ in range(5):
        old.acquire(force=True)
    time.sleep(0.1)  # let epoch 5 expire

    barrier = threading.Barrier(3)
    outcomes: dict[str, object] = {}

    def claim(name: str) -> None:
        contender = Lease(directory, owner=name, ttl=10.0)
        barrier.wait()
        try:
            outcomes[name] = contender.acquire()
        except LeaseHeld as exc:
            outcomes[name] = exc

    threads = [
        threading.Thread(target=claim, args=(f"claimant-{i}",))
        for i in range(3)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    wins = [v for v in outcomes.values() if isinstance(v, int)]
    losses = [v for v in outcomes.values() if isinstance(v, LeaseHeld)]
    assert len(wins) == 1, outcomes
    assert len(losses) == 2, outcomes
    assert wins[0] == 6  # exactly one epoch bump past the expired 5
    final = lease_mod.read_lease(directory)
    assert final.epoch == 6


def test_indeterminate_reads_never_depose_file_holder(tmp_path, monkeypatch):
    """EIO/ESTALE on the strict lease read is *indeterminate*: held()
    keeps the cached verdict without advancing the trust window, and
    renew() surfaces OSError (retry) rather than LeaseLost."""
    holder = Lease(str(tmp_path), owner="active", ttl=8.0)
    holder.acquire(force=True)
    verified_at = holder._last_verified

    real_read = lease_mod.read_lease
    blips = {"n": 0}

    def flaky_read(directory, strict=False):
        if blips["n"] > 0:
            blips["n"] -= 1
            err = OSError(errno.ESTALE if blips["n"] % 2 else errno.EIO,
                          "injected NFS blip")
            if strict:
                raise err
            return None
        return real_read(directory, strict=strict)

    monkeypatch.setattr(lease_mod, "read_lease", flaky_read)
    # also patch the bound path used by Lease.read
    monkeypatch.setattr(Lease, "read",
                        lambda self, strict=False:
                        flaky_read(self.directory, strict=strict))

    blips["n"] = 1
    assert holder.held(verify=True)  # blip: cached verdict survives
    assert holder._last_verified == verified_at  # window NOT advanced
    blips["n"] = 1
    with pytest.raises(OSError):
        holder.renew()  # retryable, NOT LeaseLost
    holder.renew()  # blip cleared: renewal heals
    assert holder.held(verify=True)


def test_indeterminate_reads_during_quorum_fallback(tmp_path, monkeypatch):
    """The quorum-backend fallback path: a region master whose
    CDT_LEASE_PEERS quorum goes dark falls back to its cached verdict
    exactly like the file lease under EIO — and when a *file* lease
    is used as the co-located fallback arbitration medium, the same
    blip classification applies. Neither backend may turn a blip into
    a takeover verdict."""
    peers = [MemoryLeasePeer(f"p{i}") for i in range(3)]
    quorum = QuorumLease(peers, owner="active", ttl=8.0,
                         clock=lambda: time.time())
    quorum.acquire()
    file_lease = Lease(str(tmp_path), owner="active", ttl=8.0)
    file_lease.acquire(force=True)

    # quorum backend: majority dark -> cached verdict
    peers[0].fail_reads = 1
    peers[1].fail_reads = 1
    assert quorum.held(verify=True)
    # file fallback: strict read raises EIO -> cached verdict
    def eio_read(self, strict=False):
        raise OSError(errno.EIO, "injected")

    monkeypatch.setattr(Lease, "read", eio_read)
    assert file_lease.held(verify=True)
    monkeypatch.undo()
    # both backends still verify cleanly after the blips
    assert quorum.held(verify=True)
    assert file_lease.held(verify=True)


def test_clock_skewed_holder_is_still_fenced_by_epoch(tmp_path):
    """Fencing is epoch-based, not wall-clock-based: a holder whose
    clock is far BEHIND (it believes its TTL is still live) is fenced
    the moment a verified read sees the usurper's epoch bump."""
    slow_clock = {"now": 1000.0}
    holder = Lease(str(tmp_path), owner="active", ttl=10.0,
                   clock=lambda: slow_clock["now"])
    holder.acquire(force=True)
    # usurper with a real (far ahead) clock forces a takeover
    usurper = Lease(str(tmp_path), owner="usurper", ttl=10.0,
                    clock=lambda: 99999.0)
    usurper.acquire(force=True)
    # the holder's own clock says the lease is fresh — irrelevant:
    slow_clock["now"] += 1.0
    assert not holder.held(verify=True)


def test_fast_clock_claimant_cannot_create_split_brain(tmp_path):
    """A claimant whose clock runs FAST takes over 'early' (it sees
    the active's expires_at in its past). That is a liveness hazard,
    not a safety one: the epoch bump fences the deposed active, so at
    no point may both journal."""
    active = Lease(str(tmp_path), owner="active", ttl=10.0,
                   clock=lambda: 1000.0)
    active.acquire(force=True)
    # claimant clock is 20s ahead: the active's lease looks expired
    claimant = Lease(str(tmp_path), owner="claimant", ttl=10.0,
                     clock=lambda: 1020.0)
    epoch = claimant.acquire()  # unforced: succeeds due to skew
    assert epoch == 2
    # safety holds: the deposed active fails its verified check
    assert not active.held(verify=True)
    assert claimant.held(verify=True)
    # exactly one of the two may pass the journal seam's gate
    assert [active.held(verify=True),
            claimant.held(verify=True)].count(True) == 1


def test_holder_trust_window_bounds_the_zombie_interval(tmp_path):
    """Within ttl/4 of the last verification held() answers from
    cache — the documented zombie bound. The cached verdict must
    expire on schedule even when the file already carries a usurper."""
    clock = {"now": 1000.0}
    holder = Lease(str(tmp_path), owner="active", ttl=8.0,
                   clock=lambda: clock["now"])
    holder.acquire(force=True)
    usurper = Lease(str(tmp_path), owner="usurper", ttl=8.0,
                    clock=lambda: clock["now"])
    usurper.acquire(force=True)
    # inside the trust window: the zombie still answers True from cache
    clock["now"] += 1.0
    assert holder.held()
    # one tick past ttl/4: the re-read fires and the zombie is fenced
    clock["now"] += 1.1
    assert not holder.held()


def test_expired_own_lease_file_still_held_until_superseded(tmp_path):
    """An active whose renewals stalled past its own TTL but whose
    (epoch, owner) is still in the file has NOT been superseded:
    held() answers True (nobody took over — there is nothing to fence
    against), and the next renew() extends the same epoch."""
    clock = {"now": 1000.0}
    holder = Lease(str(tmp_path), owner="active", ttl=4.0,
                   clock=lambda: clock["now"])
    epoch = holder.acquire(force=True)
    clock["now"] += 60.0  # far past expiry, no takeover happened
    assert holder.held(verify=True)
    holder.renew()
    assert holder.epoch == epoch
    state = lease_mod.read_lease(str(tmp_path))
    assert state.expires_at == clock["now"] + 4.0


def test_corrupt_lease_file_arbitration_stays_monotonic(tmp_path):
    """A torn/corrupt lease.json reads as free; the epoch restarts
    from the corrupt read's value only via acquire's read — which sees
    None — so the NEXT incarnation starts at 1. The flock sidecar
    still serializes the claimants, so no two take the same epoch even
    across the corruption."""
    directory = str(tmp_path)
    a = Lease(directory, owner="a", ttl=10.0)
    a.acquire(force=True)
    (tmp_path / "lease.json").write_text("{torn")
    b = Lease(directory, owner="b", ttl=10.0)
    assert b.acquire() == 1  # corrupt == free: epoch restarts
    # the old holder is deposed regardless (owner mismatch on re-read)
    assert not a.held(verify=True)
