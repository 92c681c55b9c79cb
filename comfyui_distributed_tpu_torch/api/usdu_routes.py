"""USDU routes: the tile work-queue protocol.

The port's own copy of the static-mode endpoints of
comfyui_distributed_tpu/api/usdu_routes.py, with the same request and
response field names:

    POST /distributed/heartbeat      per-tile worker liveness
    POST /distributed/request_image  pull the next tile (or frame) index
    POST /distributed/submit_tiles   push processed tiles (a flush)
    POST /distributed/submit_image   push one processed frame (dynamic mode)
    POST /distributed/return_tiles   hand back an interrupted grant
    POST /distributed/job_status     ready/progress poll

Tiles travel as JSON entries carrying base64 PNG data URLs. A job that
completed and was cleaned up reads as drained, and its late tiles are
dropped as duplicates, so a worker that arrives after the end stops at
once (the JAX routes answer 404 after the creation grace, which the
worker's pull policy retries for minutes). Handlers
await the store directly on the loop; they never go through
run_async_in_server_loop, which would deadlock the loop they run on.
A pull, a submit and a hand-back carrying the X-CDT-Trace-Id header are
spans of that trace (`rpc.request_image` with the tile it handed out,
`rpc.submit_tiles` with the tiles and how many were accepted,
`rpc.submit_image`, `rpc.return_tiles`), so a worker's RPCs sit in the
master's tree of the execution.

The control plane, as in the JAX routes: a pull or heartbeat carrying
`devices` advertises the worker's chip count to the placement policy,
and one carrying `telemetry` (the worker's fleet snapshot,
telemetry/fleet.py::local_snapshot) is merged into the master's fleet
registry. A pull with `batch_max` > 1 takes a grant sized by the
placement policy and answers `tile_idxs` beside `tile_idx` (its first
element). A pull or heartbeat of a preempted job answers `preempt: true`
and `preempt_reason`. Left out: fencing epochs (409 stale_epoch), the
standby gate, cross-job grants (`any_job`) and preemption checkpoints
(ROADMAP.md, Queue 1 steps 7 and 7b).
"""

from __future__ import annotations

from ..jobs.models import ImageJob
from ..utils.constants import JOB_INIT_GRACE_SECONDS, QUEUE_POLL_INTERVAL_SECONDS
from ..utils.exceptions import JobQueueError
from ..utils.logging import debug_log
from .httpd import Request, Response, Router, json_response
from .telemetry_routes import rpc_span


def register(router: Router, server) -> None:
    routes = UsduRoutes(server)
    router.add_post("/distributed/heartbeat", routes.heartbeat)
    router.add_post("/distributed/request_image", routes.request_image)
    router.add_post("/distributed/submit_tiles", routes.submit_tiles)
    router.add_post("/distributed/submit_image", routes.submit_image)
    router.add_post("/distributed/return_tiles", routes.return_tiles)
    router.add_post("/distributed/job_status", routes.job_status)


def _job_and_worker(body) -> tuple[str, str] | None:
    if not isinstance(body, dict) or "job_id" not in body or "worker_id" not in body:
        return None
    return str(body["job_id"]), str(body["worker_id"])


_MISSING_IDS = {"error": "job_id and worker_id required"}


class UsduRoutes:
    def __init__(self, server):
        self.server = server

    def _note_worker(self, worker_id: str, body: dict) -> None:
        """A work RPC's advisory fields: the advertised capacity and the
        piggybacked fleet snapshot (merged only on a master running the
        fleet registry; a malformed one is counted and dropped, never an
        RPC error)."""
        if "devices" in body:
            self.server.job_store.note_worker_capacity(worker_id, body["devices"])
        registry = getattr(self.server, "fleet", None)
        snapshot = body.get("telemetry")
        if registry is not None and snapshot is not None:
            registry.note_snapshot(worker_id, snapshot)

    @staticmethod
    def _note_preempt(response: dict, job) -> None:
        if job is not None and job.preempt_requested:
            response["preempt"] = True
            response["preempt_reason"] = job.preempt_reason

    async def _live_job(self, job_id: str):
        """The job, parking up to the creation grace for one not created
        yet; None at once for a job that finished. A live job comes before
        a finished record of its id: the master removes the collector job
        announced for it (whose record lands in `finished` under the same
        id) an instant before the job itself."""
        store = self.server.job_store
        if job_id in store.finished and job_id not in store.tile_jobs:
            return None
        return await store.wait_for_tile_job(job_id, JOB_INIT_GRACE_SECONDS)

    async def heartbeat(self, request: Request) -> Response:
        body = request.json()
        ids = _job_and_worker(body)
        if ids is None:
            return json_response(_MISSING_IDS, 400)
        self._note_worker(ids[1], body)
        store = self.server.job_store
        ok = await store.heartbeat(*ids)
        response = {"status": "ok" if ok else "unknown_job"}
        # the eviction side channel for a worker mid-grant
        self._note_preempt(response, await store.get_tile_job(ids[0]))
        return json_response(response)

    async def request_image(self, request: Request) -> Response:
        """Pull work: {tile_idx | None, estimated_remaining,
        batched_static} (`image_idx` in place of `tile_idx` for a
        dynamic-mode job's frame), plus `tile_idxs` when the pull asked
        for a grant (`batch_max` > 1), `cancelled`/`cancel_reason` when
        the job was cancelled, `deadline_remaining` when it has a
        deadline and `preempt`/`preempt_reason` while it is preempted."""
        body = request.json()
        ids = _job_and_worker(body)
        if ids is None:
            return json_response(_MISSING_IDS, 400)
        job_id, worker_id = ids
        try:
            batch_max = max(1, int(body.get("batch_max", 1)))
        except (TypeError, ValueError):
            batch_max = 1
        self._note_worker(worker_id, body)
        store = self.server.job_store
        task_ids: list[int] = []
        with rpc_span(request, "rpc.request_image", worker_id=worker_id, job_id=job_id) as span:
            job = await self._live_job(job_id)
            if job is not None:
                try:
                    task_ids = await store.pull_tasks(job_id, worker_id,
                                                      timeout=QUEUE_POLL_INTERVAL_SECONDS,
                                                      limit=batch_max)
                except JobQueueError:  # cleaned up since
                    job = None
            if span is not None and task_ids:
                span.attrs["tile_idx"] = int(task_ids[0])
                if len(task_ids) > 1:
                    span.attrs["batch"] = [int(t) for t in task_ids]
        if job is None:
            if job_id in store.finished:
                answer = {"tile_idx": None, "estimated_remaining": 0, "batched_static": True}
                if batch_max > 1:
                    answer["tile_idxs"] = []
                return json_response(answer)
            return json_response({"error": "no such job"}, 404)
        key = "image_idx" if isinstance(job, ImageJob) else "tile_idx"
        response = {
            key: task_ids[0] if task_ids else None,
            "estimated_remaining": await store.remaining(job_id),
            "batched_static": job.batched,
        }
        if batch_max > 1:
            response["tile_idxs"] = task_ids
        if job.cancelled:
            response["cancelled"] = True
            response["cancel_reason"] = job.cancel_reason
        deadline_remaining = job.deadline_remaining()
        if deadline_remaining is not None:
            response["deadline_remaining"] = round(deadline_remaining, 3)
        self._note_preempt(response, job)
        return json_response(response)

    async def submit_tiles(self, request: Request) -> Response:
        """{job_id, worker_id, tiles: [entry...], is_final_flush}, entry =
        {tile_idx, batch_idx, global_idx, x, y, extracted_w/h, image:
        data URL}; entries are grouped per tile_idx into one result each."""
        body = request.json()
        ids = _job_and_worker(body)
        if ids is None:
            return json_response(_MISSING_IDS, 400)
        job_id, worker_id = ids
        tiles = body.get("tiles", [])
        if not isinstance(tiles, list):
            return json_response({"error": "tiles must be a list"}, 400)
        grouped: dict[int, list[dict]] = {}
        received = 0
        for entry in tiles:
            if not isinstance(entry, dict) or "tile_idx" not in entry \
                    or not isinstance(entry.get("image"), str):
                return json_response({"error": "bad tile entry"}, 400)
            grouped.setdefault(int(entry["tile_idx"]), []).append(entry)
            received += len(entry["image"])
        store = self.server.job_store
        with rpc_span(request, "rpc.submit_tiles", worker_id=worker_id, job_id=job_id) as span:
            job = await self._live_job(job_id)
            if job is not None:
                try:
                    accepted = await store.submit_flush(job_id, worker_id, grouped,
                                                        received_bytes=received)
                except JobQueueError:  # cleaned up since
                    job = None
            if span is not None and job is not None:
                span.attrs["tiles"] = sorted(grouped)
                span.attrs["accepted"] = accepted
        if job is None:
            final = worker_id if body.get("is_final_flush") else None
            if store.drop_late(job_id, len(grouped), finished_worker=final):
                return json_response({"status": "ok", "accepted": 0})
            return json_response({"error": "no such job"}, 404)
        if body.get("is_final_flush"):
            await store.mark_worker_done(job_id, worker_id)
        debug_log(f"submit_tiles job={job_id} worker={worker_id} tiles={len(grouped)} "
                  f"accepted={accepted}")
        return json_response({"status": "ok", "accepted": accepted})

    async def submit_image(self, request: Request) -> Response:
        """Dynamic mode: one whole processed frame, {job_id, worker_id,
        image_idx, image: data URL, is_last}. The frame is the task's
        result; a duplicate or a late frame is dropped, as tiles are."""
        body = request.json()
        ids = _job_and_worker(body)
        if ids is None:
            return json_response(_MISSING_IDS, 400)
        if "image_idx" not in body or not isinstance(body.get("image"), str):
            return json_response({"error": "image_idx and image required"}, 400)
        try:
            image_idx = int(body["image_idx"])
        except (TypeError, ValueError):
            return json_response({"error": "image_idx must be an int"}, 400)
        job_id, worker_id = ids
        store = self.server.job_store
        with rpc_span(request, "rpc.submit_image", worker_id=worker_id, job_id=job_id,
                      image_idx=image_idx):
            job = await self._live_job(job_id)
            if job is not None:
                try:
                    payload = [{"batch_idx": 0, "image": body["image"], "whole_image": True}]
                    accepted = await store.submit_flush(job_id, worker_id, {image_idx: payload},
                                                        received_bytes=len(body["image"]))
                except JobQueueError:  # cleaned up since
                    job = None
        if job is None:
            if store.drop_late(job_id, 1):
                return json_response({"status": "ok", "accepted": 0})
            return json_response({"error": "no such job"}, 404)
        if body.get("is_last"):
            await store.mark_worker_done(job_id, worker_id)
        debug_log(f"submit_image job={job_id} worker={worker_id} image={image_idx} "
                  f"accepted={accepted}")
        return json_response({"status": "ok", "accepted": accepted})

    async def return_tiles(self, request: Request) -> Response:
        """{job_id, worker_id, tile_idxs}: an interrupted worker hands back
        the unprocessed rest of its grant so those tiles requeue now."""
        body = request.json()
        ids = _job_and_worker(body)
        if ids is None:
            return json_response(_MISSING_IDS, 400)
        idxs = body.get("tile_idxs", [])
        try:
            idxs = [int(t) for t in idxs] if isinstance(idxs, list) else None
        except (TypeError, ValueError):
            idxs = None
        if idxs is None:
            return json_response({"error": "tile_idxs must be a list of ints"}, 400)
        with rpc_span(request, "rpc.return_tiles", worker_id=ids[1], job_id=ids[0]) as span:
            released = await self.server.job_store.release_tasks(*ids, idxs)
            if span is not None:
                span.attrs["released"] = released
        return json_response({"status": "ok", "released": released})

    async def job_status(self, request: Request) -> Response:
        body = request.json()
        if not isinstance(body, dict) or "job_id" not in body:
            return json_response({"error": "job_id required"}, 400)
        store = self.server.job_store
        job = await store.get_tile_job(str(body["job_id"]))
        if job is None:
            # a job the orchestration announced (it made its collector)
            # reads as ready before the master's loop creates the tile
            # queue: the worker's first pull parks until it exists. A job
            # already finished reads as ready too: its pull answers
            # drained at once. An adapter plan the orchestration noted
            # rides this answer too (the JAX route's answer carries none
            # before the job exists, so a worker that polls early there
            # samples the base model)
            job_id = str(body["job_id"])
            answer = {"ready": job_id in store.collectors or job_id in store.finished}
            adapters = await store.peek_job_adapters(job_id)
            if adapters:
                answer["adapters"] = adapters
            return json_response(answer)
        return json_response({
            "ready": True,
            "total": job.total_tasks,
            "completed": len(job.completed),
            "remaining": job.pending.qsize(),
            "cancelled": job.cancelled,
            "cancel_reason": job.cancel_reason,
            "quarantined_tiles": sorted(job.quarantined_tiles),
            "deadline_remaining": job.deadline_remaining(),
            # the resolved adapter plan: a pulling worker resolves it
            # against its own catalog and verifies the hashes
            "adapters": job.adapters,
        })
