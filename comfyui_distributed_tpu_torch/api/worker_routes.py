"""Worker routes: websocket dispatch, worker processes, logs, host info.

The port's own copy of comfyui_distributed_tpu/api/worker_routes.py, on
api/httpd.py instead of aiohttp:

    GET  /distributed/worker_ws        websocket: {type: dispatch_prompt,
                                       prompt, prompt_id, trace_id?} → {type:
                                       dispatch_ack, prompt_id, ok, error?};
                                       {type: ping} → {type: pong,
                                       queue_remaining}
    POST /distributed/launch_worker    {worker_id} → {status, worker_id, pid, log}
    POST /distributed/stop_worker      {worker_id} → {status, stopped}
    POST /distributed/worker/clear_launching {worker_id} → {status, cleared}
    GET  /distributed/managed          → {managed: the PID records}
    GET  /distributed/worker_log/{name}?tail= → {name, lines}
    GET  /distributed/master_log?tail= → {lines}: this process's recent log
    GET  /distributed/remote_log/{worker_id}?tail= → that worker's master_log
    GET  /distributed/network_info     → {candidates, recommended}
    GET  /distributed/system_info      → machine id, path separator,
                                       role, device and the CUDA devices,
                                       live queue counts and breakers

`status.ws_prompts` of system_info counts the prompts this server took
over its websocket, so a run can tell a websocket dispatch from the HTTP
fallback; `status.grant_signal` is what the push-grant signal of the
last elastic job this server worked on saw (None before one).
"""

from __future__ import annotations

import asyncio
import json
import os
import socket
from typing import Any

import torch

from ..resilience.health import get_health_registry
from ..utils.logging import recent_lines
from ..utils.network import build_worker_url, is_private_host, request_json_async
from ..workers import get_worker_manager
from ..workers.detection import get_machine_id, is_docker
from ..workers.process_manager import worker_log_path
from .httpd import Request, Response, Router, accept_websocket, json_response


def register(router: Router, server) -> None:
    routes = WorkerRoutes(server)
    router.add_get("/distributed/worker_ws", routes.worker_ws)
    router.add_post("/distributed/launch_worker", routes.launch_worker)
    router.add_post("/distributed/stop_worker", routes.stop_worker)
    router.add_post("/distributed/worker/clear_launching", routes.clear_launching)
    router.add_get("/distributed/managed", routes.managed)
    router.add_get("/distributed/worker_log/{name}", routes.worker_log)
    router.add_get("/distributed/master_log", routes.master_log)
    router.add_get("/distributed/remote_log/{worker_id}", routes.remote_log)
    router.add_get("/distributed/network_info", routes.network_info)
    router.add_get("/distributed/system_info", routes.system_info)


def _tail(request: Request) -> int:
    try:
        return int(request.query.get("tail", 200))
    except ValueError:
        return 200


class WorkerRoutes:
    def __init__(self, server):
        self.server = server

    def _worker(self, worker_id: str) -> dict[str, Any] | None:
        return next((w for w in self.server.config.get("workers", [])
                     if str(w.get("id")) == worker_id), None)

    # --- websocket dispatch ------------------------------------------------

    async def worker_ws(self, request: Request) -> Response:
        """The master connects and sends dispatch_prompt; the prompt is
        queued and acknowledged (ok false with the error when refused)."""
        ws = await accept_websocket(request)
        if ws is None:
            return json_response({"error": "websocket handshake expected"}, 400)
        try:
            async for text in ws:
                try:
                    data = json.loads(text)
                except json.JSONDecodeError:
                    await ws.send_json({"type": "error", "error": "invalid json"})
                    continue
                if data.get("type") == "dispatch_prompt":
                    prompt_id = str(data.get("prompt_id", ""))
                    try:
                        new = self.server.get_job(prompt_id) is None
                        self.server.queue_prompt(data.get("prompt", {}), prompt_id,
                                                 trace_id=data.get("trace_id") or None)
                        if new:
                            self.server.ws_prompts += 1
                        await ws.send_json({"type": "dispatch_ack", "prompt_id": prompt_id,
                                            "ok": True})
                    except Exception as exc:  # noqa: BLE001 - answered over the socket
                        await ws.send_json({"type": "dispatch_ack", "prompt_id": prompt_id,
                                            "ok": False, "error": str(exc)})
                elif data.get("type") == "ping":
                    await ws.send_json({"type": "pong",
                                        "queue_remaining": self.server.queue_remaining})
        except ConnectionError:
            pass
        finally:
            await ws.close()
        return Response.detached_response()

    # --- worker processes ----------------------------------------------------

    async def launch_worker(self, request: Request) -> Response:
        body = request.json() or {}
        worker_id = str(body.get("worker_id", "")) if isinstance(body, dict) else ""
        if not worker_id:
            return json_response({"error": "worker_id required"}, 400)
        worker = self._worker(worker_id)
        if worker is None:
            return json_response({"error": "no such worker"}, 404)
        try:
            info = await asyncio.to_thread(get_worker_manager().launch_worker, worker,
                                           self.server.config_path)
        except Exception as exc:  # noqa: BLE001 - reported to the client
            return json_response({"error": str(exc)}, 500)
        return json_response({"status": "ok", **info})

    async def stop_worker(self, request: Request) -> Response:
        body = request.json()
        worker_id = str(body.get("worker_id", "")) if isinstance(body, dict) else ""
        stopped = await asyncio.to_thread(get_worker_manager().stop_worker, worker_id,
                                          self.server.config_path)
        return json_response({"status": "ok", "stopped": stopped})

    async def clear_launching(self, request: Request) -> Response:
        """Drop a managed worker's 'launching' marker once it answers."""
        body = request.json()
        worker_id = str(body.get("worker_id", "")).strip() if isinstance(body, dict) else ""
        if not worker_id:
            return json_response({"error": "worker_id required"}, 400)
        if self._worker(worker_id) is None:
            return json_response({"error": "no such worker"}, 404)
        cleared = await asyncio.to_thread(get_worker_manager().clear_launching, worker_id,
                                          self.server.config_path)
        return json_response({"status": "success", "cleared": cleared})

    async def managed(self, request: Request) -> Response:
        return json_response(
            {"managed": get_worker_manager().managed_processes(self.server.config_path)})

    # --- logs ------------------------------------------------------------------

    async def worker_log(self, request: Request) -> Response:
        name = request.match_info["name"]
        path = worker_log_path(name)
        if not os.path.isfile(path):
            return json_response({"error": "no log"}, 404)
        lines = await asyncio.to_thread(_tail_file, path, _tail(request))
        return json_response({"name": name, "lines": lines})

    async def master_log(self, request: Request) -> Response:
        return json_response({"lines": recent_lines(_tail(request))})

    async def remote_log(self, request: Request) -> Response:
        """A worker's in-memory log, proxied (workers on other hosts)."""
        worker = self._worker(request.match_info["worker_id"])
        if worker is None:
            return json_response({"error": "no such worker"}, 404)
        url = build_worker_url(worker, f"/distributed/master_log?tail={_tail(request)}")
        try:
            status, data = await request_json_async("GET", url, timeout=10)
        except Exception as exc:  # noqa: BLE001 - proxied errors surface
            return json_response({"error": str(exc)}, 502)
        return json_response(data, status)

    # --- host info ---------------------------------------------------------------

    async def network_info(self, request: Request) -> Response:
        """Addresses this host may be reached on, private ones first. The
        outbound interface comes from connecting a UDP socket (which sends
        nothing); the JAX route also resolves the host name, which may ask
        a DNS server, and the port does not."""
        candidates: list[str] = []
        try:
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
                sock.connect(("10.255.255.255", 1))
                candidates.append(sock.getsockname()[0])
        except OSError:
            pass
        ranked = sorted((a for a in candidates if a != "127.0.0.1"),
                        key=lambda a: (not is_private_host(a), a))
        return json_response({"candidates": ranked or candidates,
                              "recommended": (ranked or ["127.0.0.1"])[0]})

    async def system_info(self, request: Request) -> Response:
        """Machine identity (what the media sync and same-host checks
        read), role, device (the CUDA devices in place of the JAX
        package's TPU topology) and live counts."""
        stats = await self.server.job_store.stats()
        devices = []
        if self.server.device.startswith("cuda") and torch.cuda.is_available():
            devices = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        return json_response({
            "machine_id": get_machine_id(),
            "path_separator": os.sep,
            "platform": os.name,
            "docker": is_docker(),
            "is_worker": self.server.is_worker,
            "pid": os.getpid(),
            "device": self.server.device,
            "cuda_devices": devices,
            "status": {
                "queue_remaining": self.server.queue_remaining,
                "tile_jobs": stats["tile_jobs"],
                "collector_jobs": stats["collectors"],
                "tile_queue_depth": stats["queue_depth"],
                "in_flight_tiles": stats["in_flight"],
                "breakers": get_health_registry().snapshot(),
                "ws_prompts": self.server.ws_prompts,
                "pipelines": sorted(self.server.execution_context.pipelines),
                # the last elastic job's push-grant signal, as the worker
                # loop left it (graph/usdu_elastic.py::GrantSignal.summary)
                "grant_signal": self.server.execution_context.extras.get("grant_signal"),
            },
        })


def _tail_file(path: str, n_lines: int) -> list[str]:
    """The last lines of a file, read from its end."""
    with open(path, "rb") as fh:
        fh.seek(0, os.SEEK_END)
        size = fh.tell()
        window = min(size, max(4096, n_lines * 200))
        fh.seek(size - window)
        data = fh.read().decode("utf-8", errors="replace")
    return data.splitlines()[-n_lines:]

