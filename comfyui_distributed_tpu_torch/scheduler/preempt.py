"""Preemption coordination: lanes get real teeth.

The port's own copy of comfyui_distributed_tpu/scheduler/preempt.py.
The admission lanes (scheduler/queue.py) order work at grant time and
brownout sheds cheap lanes' new admissions; the coordinator also acts
on jobs already running:

- **premium arrival** — when a job inits on a lane that outranks
  running work, every active lower-lane job with outstanding tiles is
  flagged for preemption (``JobStore.request_preemption``): its pulls
  read as drained and pull/heartbeat responses carry ``preempt: true``.
  On the port's K = 1 tile path a worker that reads the flag ends its
  pulls for that job, as a drained answer ends them; the tile it is
  sampling finishes and is submitted. (The JAX package's cross-job
  executor also checkpoints and releases in-flight tiles at a step
  boundary; that tier is ROADMAP.md Queue 1 step 7b.)
- **settle** — when the premium job completes or cancels, the flags it
  raised lift (unless another outstanding premium still claims the
  victim) and the flagged job's pending tiles are pullable again: its
  master's collection loop takes them.
- **brownout eviction** (CDT_PREEMPT_BROWNOUT_LEVEL) — at or above the
  configured shed level the brownout controller's hook also evicts
  RUNNING work from shed lanes instead of only rejecting their new
  admissions.

The coordinator owns lane ranking (the admission queue's strict
priority order); the store owns flags/state. Everything is advisory:
a coordinator failure degrades to today's no-preemption behavior,
never to a stuck queue. All methods run on the server loop.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

from ..telemetry import instruments  # noqa: F401 - counted in the store
from ..utils import constants
from ..utils.logging import debug_log, log

# Rank assigned to jobs with no / unknown lane: below every declared
# lane, so legacy jobs never outrank an explicit premium lane and are
# always eligible victims.
UNRANKED = 1 << 20


class PreemptionCoordinator:
    """Maps lane order onto preemption decisions over one JobStore.

    ``lane_order`` is the admission queue's priority order (highest
    first — ``AdmissionQueue.lane_order``). ``preempt_rank_limit``
    restricts which arrivals may preempt at all: only jobs whose lane
    rank is strictly below it (default 1: only the TOP lane preempts,
    so mid-tier lanes cannot churn the fleet with evictions).
    """

    def __init__(
        self,
        lane_order: Sequence[str],
        store: Any,
        enabled: Optional[bool] = None,
        preempt_rank_limit: int = 1,
    ) -> None:
        self.lane_order = [str(lane) for lane in lane_order]
        self._rank = {lane: i for i, lane in enumerate(self.lane_order)}
        self.store = store
        self.enabled = (
            bool(enabled)
            if enabled is not None
            else constants.PREEMPT_ENABLED == 1
        )
        self.preempt_rank_limit = max(1, int(preempt_rank_limit))
        # premium job id -> victims it flagged (for settle-time lifts)
        self._claims: dict[str, list[str]] = {}
        self.preemptions = 0

    # --- ranking ----------------------------------------------------------

    def lane_rank(self, lane: str) -> int:
        """Lower = more urgent; unknown/blank lanes rank UNRANKED (the
        JobStore delegates its ordering and victim selection here)."""
        return self._rank.get(str(lane or ""), UNRANKED)

    # --- store seams ------------------------------------------------------

    async def on_job_init(self, job_id: str) -> list[str]:
        """A job just initialized: if its lane outranks running work
        (and sits inside the preempting rank band), flag the victims.
        Returns the victim job ids (empty = no preemption)."""
        if not self.enabled:
            return []
        job = await self.store.get_tile_job(job_id)
        if job is None:
            return []
        rank = self.lane_rank(job.lane)
        if rank >= self.preempt_rank_limit:
            return []
        # claim EVERY lower-ranked job — including ones an earlier
        # premium already flagged — so that premium's settle cannot
        # lift flags this one still depends on; only the unflagged
        # subset is newly requested
        claims = [
            v
            for v in await self.store.preempt_victims(
                rank, include_flagged=True
            )
            if v != job_id
        ]
        if not claims:
            return []
        flagged = await self.store.request_preemption(
            claims, reason="premium_arrival"
        )
        self._claims[job_id] = claims
        if flagged:
            self.preemptions += len(flagged)
            log(
                f"premium job {job_id} (lane {job.lane!r}) preempts "
                f"{len(flagged)} running job(s): {', '.join(flagged)}"
            )
        return flagged

    async def on_job_settled(self, job_id: str) -> list[str]:
        """A job completed/cancelled: lift the flags it raised, except
        for victims another OUTSTANDING premium still claims."""
        claimed = self._claims.pop(job_id, None)
        if not claimed:
            return []
        still_claimed = {
            victim
            for premium, victims in sorted(self._claims.items())
            for victim in victims
        }
        release = [v for v in claimed if v not in still_claimed]
        if not release:
            return []
        # a flag brownout currently owns is not this premium's to
        # lift — brownout's own de-escalation hook clears those
        async with self.store.lock:
            release = [
                v
                for v in release
                if (job := self.store.tile_jobs.get(v)) is not None
                and job.preempt_reason != "brownout"
            ]
        if not release:
            return []
        cleared = await self.store.clear_preemption(release)
        if cleared:
            debug_log(
                f"preemption lifted after {job_id} settled: "
                f"{', '.join(cleared)}"
            )
        return cleared

    # --- brownout seam ----------------------------------------------------

    async def on_brownout(self, level: int, shed_lanes: Sequence[str]) -> list[str]:
        """Brownout level changed: at or above
        CDT_PREEMPT_BROWNOUT_LEVEL, evict RUNNING work from the shed
        lanes too (reason="brownout"); below it — including every
        de-escalation step — LIFT any brownout flags on jobs whose
        lane is no longer shed, so evicted work resumes the moment
        pressure recedes (a brownout flag must never outlive the
        brownout). With the knob at its 0 default brownout stays
        admission-only, exactly as before."""
        threshold = constants.PREEMPT_BROWNOUT_LEVEL
        if not self.enabled or threshold <= 0:
            return []
        shed = (
            {str(lane) for lane in shed_lanes} if level >= threshold else set()
        )
        async with self.store.lock:
            jobs = sorted(
                self.store.tile_jobs.values(),
                key=lambda j: (j.created_at, j.job_id),
            )
            victims = [
                job.job_id
                for job in jobs
                if not job.cancelled
                and not job.preempt_requested
                and job.lane in shed
            ]
            stale = [
                job.job_id
                for job in jobs
                if job.preempt_requested
                and job.preempt_reason == "brownout"
                and job.lane not in shed
            ]
        if stale:
            await self.store.clear_preemption(stale)
        if not victims:
            return []
        return await self.store.request_preemption(victims, reason="brownout")

    # --- observability ----------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "enabled": self.enabled,
            "lane_order": list(self.lane_order),
            "preempt_rank_limit": self.preempt_rank_limit,
            "preemptions": self.preemptions,
            "active_claims": {
                premium: list(victims)
                for premium, victims in sorted(self._claims.items())
            },
        }
