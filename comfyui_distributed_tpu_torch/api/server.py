"""DistributedServer: the hub of one master or worker process.

The port's own copy of comfyui_distributed_tpu/api/server.py, on
api/httpd.py instead of aiohttp. It owns:

- the HTTP server with GET/POST /prompt, POST /interrupt,
  GET /history/{prompt_id}, and the /distributed/* routes: the jobs
  (api/job_routes.py), the elastic tier (api/usdu_routes.py), the worker
  processes, websocket dispatch and host info (api/worker_routes.py) and
  the config (api/config_routes.py);
- the prompt queue, consumed by one executor thread running the graph
  executor, so compute never blocks the loop; every prompt shares the
  server's `execution_context.pipelines` (loaded models) and `extras`
  (the node cache, the elastic loops' stage times);
- the JobStore of the elastic tier.

The same server runs on master and workers; a prompt's hidden inputs
(written by the orchestration) decide each node's role. `device` is
where the nodes run: the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import asyncio
import os
import queue as thread_queue
import threading
import types
from typing import Any, Optional

import torch

from ..graph import ExecutionContext, GraphExecutor, validate_prompt
from ..graph.io_dirs import get_input_dir
from ..jobs import JobStore
from ..utils import config as config_mod
from ..utils.async_helpers import set_server_loop
from ..utils.constants import DEFAULT_MASTER_PORT, WORKER_ENV_FLAG
from ..utils.exceptions import PromptValidationError
from ..utils.logging import debug_log, log
from .httpd import HTTPServer, Request, Response, Router, json_response


class PromptJob:
    def __init__(self, prompt_id: str, prompt: dict):
        self.prompt_id = prompt_id
        self.prompt = prompt
        self.done = threading.Event()
        self.outputs: dict[str, Any] | None = None
        self.error: str | None = None
        self.timings: dict[str, float] = {}


class DistributedServer:
    def __init__(self, port: int = DEFAULT_MASTER_PORT, is_worker: Optional[bool] = None,
                 config_path: str | None = None, host: str | None = None,
                 device: str | None = None):
        self.port = port
        # loopback unless asked: the /distributed/* surface has no auth
        self.host = host or os.environ.get("CDT_HOST") or "127.0.0.1"
        self.is_worker = (is_worker if is_worker is not None
                          else os.environ.get(WORKER_ENV_FLAG) == "1")
        self.config_path = config_path
        self.device = device or "cuda"
        self.job_store = JobStore()
        self.router = Router()
        self.http: Optional[HTTPServer] = None
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self._prompt_queue: "thread_queue.Queue[Optional[PromptJob]]" = thread_queue.Queue()
        self._executing = threading.Event()
        self._executor_thread: Optional[threading.Thread] = None
        self._history: dict[str, PromptJob] = {}
        self._interrupt = threading.Event()
        self.execution_context = ExecutionContext(device=self.device)
        # prompts taken over /distributed/worker_ws (not the HTTP fallback)
        self.ws_prompts = 0
        self._register_routes()

    # --- config ----------------------------------------------------------

    @property
    def config(self) -> dict[str, Any]:
        return config_mod.load_config(self.config_path)

    def media_context(self) -> Any:
        """What graph/io_dirs.py reads the media directories from: this
        server's config, as its nodes see it."""
        return types.SimpleNamespace(config=self.config)

    def input_dir(self) -> str:
        """Where this server's LoadImage reads and /upload/image writes."""
        return get_input_dir(self.media_context())

    # --- routes ----------------------------------------------------------

    def _register_routes(self) -> None:
        from . import config_routes, job_routes, usdu_routes, worker_routes

        self.router.add_get("/prompt", self.handle_get_prompt)
        self.router.add_post("/prompt", self.handle_post_prompt)
        self.router.add_post("/interrupt", self.handle_interrupt)
        self.router.add_get("/history/{prompt_id}", self.handle_history)
        job_routes.register(self.router, self)
        usdu_routes.register(self.router, self)
        worker_routes.register(self.router, self)
        config_routes.register(self.router, self)

    # --- prompt queue ----------------------------------------------------

    @property
    def queue_remaining(self) -> int:
        return self._prompt_queue.qsize() + (1 if self._executing.is_set() else 0)

    async def handle_get_prompt(self, request: Request) -> Response:
        # the ComfyUI probe shape: exec_info.queue_remaining is the
        # busy-ness metric of worker selection and the busy-probe grace
        return json_response({"exec_info": {"queue_remaining": self.queue_remaining}})

    async def handle_post_prompt(self, request: Request) -> Response:
        body = request.json()
        if not isinstance(body, dict):
            return json_response({"error": "invalid json"}, 400)
        prompt = body.get("prompt")
        if not isinstance(prompt, dict):
            return json_response({"error": "missing prompt"}, 400)
        prompt_id = body.get("prompt_id") or f"prompt_{len(self._history)}_{os.getpid()}"
        try:
            job = self.queue_prompt(prompt, str(prompt_id))
        except PromptValidationError as exc:
            return json_response({"error": str(exc), "node_errors": exc.node_errors}, 400)
        return json_response({"prompt_id": job.prompt_id, "number": 0})

    async def handle_interrupt(self, request: Request) -> Response:
        self.interrupt()
        return json_response({"interrupted": True})

    async def handle_history(self, request: Request) -> Response:
        prompt_id = request.match_info["prompt_id"]
        job = self._history.get(prompt_id)
        if job is None:
            return json_response({}, 404)
        return json_response({
            "prompt_id": prompt_id,
            "done": job.done.is_set(),
            "error": job.error,
            "outputs": _jsonable_outputs(job.outputs),
            "timings": job.timings,
        })

    def get_job(self, prompt_id: str) -> Optional[PromptJob]:
        """A queued prompt with its outputs once done (None if unknown)."""
        return self._history.get(prompt_id)

    def queue_prompt(self, prompt: dict, prompt_id: str) -> PromptJob:
        """Validate, then enqueue; validation errors reach the caller.
        Idempotent per prompt_id: a retried dispatch whose first delivery
        landed does not run the prompt twice."""
        existing = self._history.get(prompt_id)
        if existing is not None:
            debug_log(f"prompt {prompt_id} already queued; duplicate dropped")
            return existing
        validate_prompt(prompt)
        job = PromptJob(prompt_id, prompt)
        self._history[prompt_id] = job
        self._prompt_queue.put(job)
        return job

    def interrupt(self) -> None:
        self._interrupt.set()

    # --- executor thread --------------------------------------------------

    def _executor_loop(self) -> None:
        # grad mode is thread-local: this thread runs the models
        with torch.inference_mode():
            while True:
                job = self._prompt_queue.get()
                if job is None:
                    return
                self._execute(job)

    def _execute(self, job: PromptJob) -> None:
        self._executing.set()
        self._interrupt.clear()
        ctx = ExecutionContext(
            device=self.device,
            config=self.config,
            server=self,
            interrupt_event=self._interrupt,
            pipelines=self.execution_context.pipelines,
            extras=self.execution_context.extras,  # the node cache persists
        )
        try:
            debug_log(f"executing prompt {job.prompt_id}")
            executor = GraphExecutor(ctx)
            job.outputs = executor.execute(job.prompt)
            job.timings = executor.last_timings
        except Exception as exc:  # noqa: BLE001 - reported to the client
            job.error = f"{type(exc).__name__}: {exc}"
            log(f"prompt {job.prompt_id} failed: {job.error}")
        finally:
            self._executing.clear()
            job.done.set()

    # --- lifecycle --------------------------------------------------------

    async def start(self) -> None:
        """Start the HTTP listener and the executor thread on the running
        loop."""
        self.loop = asyncio.get_running_loop()
        set_server_loop(self.loop)
        self._executor_thread = threading.Thread(target=self._executor_loop,
                                                 name="cdt-executor", daemon=True)
        self._executor_thread.start()
        self.http = HTTPServer(self.router)
        await self.http.start(self.host, self.port)
        log(f"{'worker' if self.is_worker else 'master'} server listening on "
            f"{self.host}:{self.port} (device {self.device})")

    async def stop(self) -> None:
        """Stop listening, then let the executor finish its prompt and exit
        (joined off the loop: a prompt in flight still needs the loop)."""
        if self.http is not None:
            await self.http.stop()
            self.http = None
        self._prompt_queue.put(None)
        if self._executor_thread is not None:
            self.interrupt()
            await asyncio.to_thread(self._executor_thread.join, 30)
            if self._executor_thread.is_alive():
                log("executor thread still running 30 s after stop")
            self._executor_thread = None


def _jsonable_outputs(outputs: dict | None) -> dict:
    if not outputs:
        return {}
    out: dict[str, Any] = {}
    for node_id, result in outputs.items():
        entry: dict[str, Any] = {}
        for item in result if isinstance(result, tuple) else (result,):
            if isinstance(item, dict) and "ui" in item:
                entry.update(item["ui"])
        out[node_id] = entry
    return out
