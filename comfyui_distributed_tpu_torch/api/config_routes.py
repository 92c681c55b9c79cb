"""Config routes: the config file over HTTP, with typed patches.

The port's own copy of comfyui_distributed_tpu/api/config_routes.py:

    GET    /distributed/config                → the config, defaults merged
    POST   /distributed/config                {key: value, ...} → top-level keys replaced
    POST   /distributed/config/setting        {name, value}: checked against CONFIG_SCHEMA
    POST   /distributed/config/worker         {id, ...}: add a worker or update one
                                              (WORKER_FIELDS; 409 for a host:port in use)
    POST   /distributed/config/master         {host?, cuda_device?}
    DELETE /distributed/config/worker/{id}    404 for an unknown worker
    GET    /distributed/queue_status/{job_id} the job's collector and tile counts,
                                              the queue depth and the breakers

Every write goes through `config_transaction`, the mutex the process
manager's PID records share. A worker's card is `cuda_device` (an index
or a list), where the JAX package has `tpu_chips`; the queue status has
no scheduler view (the scheduler is not ported).
"""

from __future__ import annotations

from typing import Any, Callable

from ..resilience.health import get_health_registry
from ..utils import config as config_mod
from .httpd import Request, Response, Router, json_response

CONFIG_SCHEMA: dict[str, tuple[Any, Callable[[Any], bool]]] = {
    "debug": (bool, lambda v: True),
    "auto_launch_workers": (bool, lambda v: True),
    "stop_workers_on_master_exit": (bool, lambda v: True),
    "master_delegate_only": (bool, lambda v: True),
    "websocket_orchestration": (bool, lambda v: True),
    "worker_timeout_seconds": ((int, float), lambda v: v > 0),
    "probe_concurrency": (int, lambda v: 1 <= v <= 64),
    "prep_concurrency": (int, lambda v: 1 <= v <= 64),
    "media_sync_concurrency": (int, lambda v: 1 <= v <= 64),
    "output_dir": (str, lambda v: True),
    "input_dir": (str, lambda v: True),
}

WORKER_FIELDS: dict[str, Any] = {
    "id": str,
    "name": str,
    "type": str,
    "host": str,
    "port": int,
    "cuda_device": (int, list),
    "enabled": bool,
    "extra_args": str,
}


def register(router: Router, server) -> None:
    routes = ConfigRoutes(server)
    router.add_get("/distributed/config", routes.get_config)
    router.add_post("/distributed/config", routes.post_config)
    router.add_post("/distributed/config/setting", routes.patch_setting)
    router.add_post("/distributed/config/worker", routes.patch_worker)
    router.add_post("/distributed/config/master", routes.patch_master)
    router.add_delete("/distributed/config/worker/{worker_id}", routes.delete_worker)
    router.add_get("/distributed/queue_status/{job_id}", routes.queue_status)


def _type_name(expected: Any) -> str:
    if isinstance(expected, tuple):
        return " or ".join(t.__name__ for t in expected)
    return expected.__name__


class ConfigRoutes:
    def __init__(self, server):
        self.server = server

    async def get_config(self, request: Request) -> Response:
        return json_response(config_mod.load_config(self.server.config_path))

    async def post_config(self, request: Request) -> Response:
        body = request.json()
        if body is None:
            return json_response({"error": "invalid json"}, 400)
        if not isinstance(body, dict):
            return json_response({"error": "config must be an object"}, 400)
        async with config_mod.config_transaction(self.server.config_path) as cfg:
            cfg.update(body)
        return json_response({"status": "ok"})

    async def patch_setting(self, request: Request) -> Response:
        body = request.json()
        if not isinstance(body, dict):
            return json_response({"error": "invalid json"}, 400)
        name, value = body.get("name"), body.get("value")
        if name not in CONFIG_SCHEMA:
            return json_response({"error": f"unknown setting {name!r}"}, 400)
        expected, validator = CONFIG_SCHEMA[name]
        # a bool is an int to isinstance, but no int setting takes one
        if not isinstance(value, expected) or (expected is not bool and isinstance(value, bool)):
            return json_response({"error": f"setting {name!r} expects {expected}"}, 400)
        if not validator(value):
            return json_response({"error": f"invalid value for {name!r}"}, 400)
        async with config_mod.config_transaction(self.server.config_path) as cfg:
            cfg.setdefault("settings", {})[name] = value
        return json_response({"status": "ok"})

    async def patch_worker(self, request: Request) -> Response:
        body = request.json()
        if not isinstance(body, dict):
            return json_response({"error": "invalid json"}, 400)
        worker_id = str(body.get("id", ""))
        if not worker_id:
            return json_response({"error": "worker id required"}, 400)
        for key, value in body.items():
            if key not in WORKER_FIELDS:
                return json_response({"error": f"unknown field {key!r}"}, 400)
            if not isinstance(value, WORKER_FIELDS[key]):
                return json_response(
                    {"error": f"field {key!r} expects {_type_name(WORKER_FIELDS[key])}"}, 400)
        async with config_mod.config_transaction(self.server.config_path) as cfg:
            workers = cfg.setdefault("workers", [])
            existing = next((w for w in workers if str(w.get("id")) == worker_id), None)
            if existing is not None:
                existing.update(body)
                return json_response({"status": "ok"})
            entry = {**config_mod.WORKER_TEMPLATE, **body}
            if entry.get("port") and any(w.get("host") == entry.get("host")
                                         and w.get("port") == entry.get("port")
                                         for w in workers):
                return json_response({"error": "host:port already in use"}, 409)
            workers.append(entry)
        return json_response({"status": "ok"})

    async def delete_worker(self, request: Request) -> Response:
        worker_id = request.match_info["worker_id"]
        async with config_mod.config_transaction(self.server.config_path) as cfg:
            before = len(cfg.get("workers", []))
            cfg["workers"] = [w for w in cfg.get("workers", []) if str(w.get("id")) != worker_id]
            removed = before - len(cfg["workers"])
        if not removed:
            return json_response({"error": "no such worker"}, 404)
        return json_response({"status": "ok"})

    async def patch_master(self, request: Request) -> Response:
        body = request.json()
        if not isinstance(body, dict):
            return json_response({"error": "invalid json"}, 400)
        async with config_mod.config_transaction(self.server.config_path) as cfg:
            cfg.setdefault("master", {}).update(
                {k: v for k, v in body.items() if k in ("host", "cuda_device")})
        return json_response({"status": "ok"})

    async def queue_status(self, request: Request) -> Response:
        job_id = request.match_info["job_id"]
        store = self.server.job_store
        collector = store.collectors.get(job_id)
        tile_job = store.tile_jobs.get(job_id)
        tile_view = None
        if tile_job is not None:
            in_flight = sum(len([t for t in tasks if t not in tile_job.completed])
                            for tasks in list(tile_job.assigned.values()))
            tile_view = {"total": tile_job.total_tasks, "completed": len(tile_job.completed),
                         "pending": tile_job.pending.qsize(), "in_flight": in_flight}
        return json_response({
            "exists": collector is not None or tile_job is not None,
            "collector": None if collector is None else {
                "received": collector.received,
                "finished_workers": sorted(collector.finished_workers)},
            "tile_job": tile_view,
            "queue_remaining": self.server.queue_remaining,
            "breakers": get_health_registry().snapshot(),
            "scheduler": None,
        })
