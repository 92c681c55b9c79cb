"""Tiles per second of the upscale workflow on one card, three ways.

    python -m comfyui_distributed_tpu_torch.profile_elastic [--runs N]
    python -m comfyui_distributed_tpu_torch.profile_elastic --profiling-ab [--runs N]
    python -m comfyui_distributed_tpu_torch.profile_elastic --grants-ab [--runs N]
    python -m comfyui_distributed_tpu_torch.profile_elastic --flight-ab [--runs N]

Queues workflows/distributed-upscale.json (SDXL, seeded random weights,
a seeded 512x512 input.png, four 576-px padded tiles) on a master
DistributedServer in this process through POST /distributed/queue, in
three modes:

- local:       no workers; the master runs every tile itself;
- in-process:  worker w1 is a second server in this process, on the
               master's loop, sharing its model (one interpreter lock
               for both);
- subprocess:  worker w2 is `python -m comfyui_distributed_tpu_torch
               --worker` in its own process, with its own copy of the
               same seeded weights, on the same card.

Warm-up runs per mode (up to WARMUPS, until its worker has taken a
tile), then the modes in turns (local, in-process, subprocess,
subprocess, in-process, local, ...) until each has --runs
timed runs: the host clock from the POST to the master's finished
history. Prints the card (name and power limit), each run's wall,
tiles/s and tiles per participant, each elastic run's grants by
participant (tiles a grant, from the master's trace of the run: its
tile.pull spans and the rpc.request_image spans it served the worker),
each elastic run's stage seconds by
role and its host-tax ratio by role (read from the participants'
/distributed/metrics: the cdt_tile_stage_seconds and
cdt_device_execute_seconds sums the run added; host = readback, encode,
decode and submit), and each mode's median. Both elastic modes
composite in sorted tile order (CDT_DETERMINISTIC_BLEND=1), so their
outputs must agree within 0.05; the local mode's weighted-average blend
differs at the seams and is not compared.

`--profiling-ab` measures what the transfer ledger costs instead, in
the subprocess mode, where the worker's sampler thread could otherwise
queue its next tile's launches while the card runs the current one: two
worker processes on the same card, w2 started with CDT_PROFILING=1 (the
default, which waits for the card at the end of every tile's dispatch)
and w3 with CDT_PROFILING=0, taken in turns, the master's ledger
switched to match (`utils.constants.PROFILING_ENABLED` is read at every
dispatch).

`--grants-ab` measures what grants of several tiles do instead, also in
the subprocess mode: one worker process, w2, and the master's placement
policy sizing grants from CDT_SCHED_BASE_PULL_BATCH's default (2) and
from 1, taken in turns (`PlacementPolicy.base_batch` is read at every
pull). Tile noise is seeded by the global tile index, so the two must
give the same output.

`--flight-ab` measures what the flight recorder's bus tap costs
instead (telemetry/flight.py; every server installs it unless
CDT_FLIGHT=0), in both elastic modes: in-process with the recorder's
tap on the shared bus and lifted, and subprocess with w2 (CDT_FLIGHT=1)
and w3 (CDT_FLIGHT=0), the master's tap lifted to match, all four in
turns.

`--platform cpu` with `--model tiny-unet --image-px 64 --tile 64
--padding 16 --steps 1` rehearses it without a card.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .api.server import DistributedServer
from .models import pipeline as pl
from .ops.upscale import plan_grid
from .utils import config as config_mod
from .utils import constants
from .utils import image as img_utils
from .utils.async_helpers import ServerLoopThread
from .utils.network import request_bytes, request_json

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261016
MODES = {"local": None, "in-process": "w1", "subprocess": "w2"}
# --profiling-ab: the subprocess mode with the transfer ledger on and off
PROFILING_MODES = {"ledger on": "w2", "ledger off (CDT_PROFILING=0)": "w3"}
# --grants-ab: the subprocess mode under two base grant sizes
GRANT_MODES = {f"base grant {constants.SCHED_BASE_PULL_BATCH} (default)": "w2",
               "base grant 1 (CDT_SCHED_BASE_PULL_BATCH=1)": "w2"}
# --flight-ab: both elastic modes with the recorder's tap on and lifted
FLIGHT_MODES = {"in-process, recorder on": "w1", "in-process, recorder off": "w1",
                "subprocess, recorder on": "w2", "subprocess, CDT_FLIGHT=0": "w3"}
FLIGHT_OFF = ("in-process, recorder off", "subprocess, CDT_FLIGHT=0")
# the worker processes, and the A/B's variable (CDT_PROFILING under
# --profiling-ab, CDT_FLIGHT under --flight-ab) each runs with
WORKER_PROCESSES = {"w2": "1", "w3": "0"}
HOST_STAGES = ("readback", "encode", "decode", "submit")
_SAMPLE_RE = re.compile(r'^(cdt_tile_stage_seconds_sum|cdt_device_execute_seconds_sum)'
                        r'\{(.*)\} (\S+)$')
_LABEL_RE = re.compile(r'(\w+)="([^"]*)"')
RUN_TIMEOUT_S = 600.0
WARMUPS = 3
TOLERANCE = 0.05


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _wait(predicate, what: str, timeout: float, proc=None):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"{what}: the worker process exited with {proc.returncode}")
        try:
            value = predicate()
        except OSError:
            value = None
        if value:
            return value
        time.sleep(0.05)
    raise RuntimeError(f"{what}: not within {timeout:.0f} s")


def _workflow(args) -> dict:
    with open(os.path.join(REPO, "workflows", "distributed-upscale.json"), encoding="utf-8") as fh:
        workflow = json.load(fh)
    workflow["1"]["inputs"]["ckpt_name"] = args.model
    usdu = workflow["5"]["inputs"]
    for key, value in (("steps", args.steps), ("tile_width", args.tile),
                       ("tile_height", args.tile), ("tile_padding", args.padding)):
        if value is not None:
            usdu[key] = value
    return workflow


def _card(device: str) -> str:
    if not device.startswith("cuda"):
        return "no card (cpu)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def _stage_sums(bases: list[str]) -> dict[tuple[str, str, str], float]:
    """{(family, role, stage or tier): seconds} of the stage and
    device-execute histograms, summed over the /distributed/metrics of
    `bases` (each process with a registry of its own)."""
    sums: dict[tuple[str, str, str], float] = {}
    for base in bases:
        status, body = request_bytes("GET", f"{base}/distributed/metrics", timeout=60)
        if status != 200:
            raise RuntimeError(f"{base}/distributed/metrics answered {status}")
        for line in body.decode("utf-8").splitlines():
            match = _SAMPLE_RE.match(line)
            if match:
                labels = dict(_LABEL_RE.findall(match.group(2)))
                key = (match.group(1), labels["role"], labels.get("stage", labels.get("tier")))
                sums[key] = sums.get(key, 0.0) + float(match.group(3))
    return sums


def _spans(tree: list) -> list:
    """The spans of a /distributed/trace answer's tree, flat."""
    out = []
    for node in tree:
        out.append(node)
        out.extend(_spans(node["children"]))
    return out


def _grants(base: str, trace_id: str, worker: str) -> dict[str, list[int]]:
    """Each participant's grants in one run (tiles a grant), from the
    master's trace: its tile.pull spans and the rpc.request_image spans
    it served `worker` (a grant's tiles in `batch`)."""
    status, answer = request_json("GET", f"{base}/distributed/trace/{trace_id}", timeout=60)
    if status != 200:
        raise RuntimeError(f"{base}/distributed/trace/{trace_id} answered {status}")
    spans = _spans(answer["tree"])
    return {
        "master": [len(s["attrs"].get("batch") or [0]) for s in spans
                   if s["name"] == "tile.pull" and s["attrs"].get("role") == "master"
                   and "tile_idx" in s["attrs"]],
        worker: [len(s["attrs"].get("batch") or [0]) for s in spans
                 if s["name"] == "rpc.request_image" and s["attrs"].get("worker_id") == worker
                 and "tile_idx" in s["attrs"]],
    }


def _stage_report(before: dict, after: dict) -> str:
    """Each role's stage seconds and host-tax ratio over one run."""
    moved = {key: after[key] - before.get(key, 0.0) for key in after}
    parts = []
    for role in ("master", "worker"):
        stages = {stage: round(v, 4) for (family, r, stage), v in sorted(moved.items())
                  if r == role and family == "cdt_tile_stage_seconds_sum" and v > 0}
        device = sum(v for (family, r, _), v in moved.items()
                     if r == role and family == "cdt_device_execute_seconds_sum")
        host = sum(stages.get(stage, 0.0) for stage in HOST_STAGES)
        tax = f"{host / (host + device):.4f}" if device > 0 else "no device time"
        parts.append(f"{role} {stages}, host-tax {tax}")
    return "; ".join(parts)


def _run_once(base: str, master, workflow: dict, workers: list[str], device: str,
              worker_base: str | None):
    """One queued workflow: (seconds, completions, output tensor, trace
    id). With a worker, its prompt must finish too, without an error."""
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    started = time.perf_counter()
    status, queued = request_json("POST", f"{base}/distributed/queue", {
        "prompt": workflow, "client_id": "profile_elastic", "workers": workers,
    }, timeout=120)
    if status != 200 or queued.get("workers") != workers:
        raise RuntimeError(f"queue answered {status}: {queued} (workers {workers} expected)")

    def done():
        code, history = request_json("GET", f"{base}/history/{queued['prompt_id']}", timeout=30)
        return history if code == 200 and history.get("done") else None

    history = _wait(done, f"prompt {queued['prompt_id']}", RUN_TIMEOUT_S)
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    seconds = time.perf_counter() - started
    if history.get("error"):
        raise RuntimeError(f"prompt failed: {history['error']}")
    if worker_base is not None:
        url = f"{worker_base}/history/{queued['trace_id']}_w0"

        def worker_done():
            code, worker_history = request_json("GET", url, timeout=30)
            return worker_history if code == 200 and worker_history.get("done") else None

        worker_history = _wait(worker_done, url, RUN_TIMEOUT_S)
        if worker_history.get("error"):
            raise RuntimeError(f"worker prompt failed: {worker_history['error']}")
    job_id = next(iter(queued["job_ids"].values()))
    record = master.job_store.finished.get(job_id)  # absent on the local path
    completions = record["completions"] if record else []
    if record and sorted(t for t, _ in completions) != list(range(record["total"])):
        raise RuntimeError(f"tiles not completed exactly once: {completions}")
    out = master.get_job(queued["prompt_id"]).outputs["6"][0]["images"]
    return seconds, completions, out, queued["trace_id"]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=3, help="timed runs per mode")
    parser.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--model", default="sdxl")
    parser.add_argument("--image-px", type=int, default=512)
    parser.add_argument("--tile", type=int, default=None)
    parser.add_argument("--padding", type=int, default=None)
    parser.add_argument("--steps", type=int, default=None)
    ab = parser.add_mutually_exclusive_group()
    ab.add_argument("--profiling-ab", action="store_true",
                    help="the subprocess mode with the transfer ledger on and off, in turns")
    ab.add_argument("--grants-ab", action="store_true",
                    help="the subprocess mode with base grants of 2 and 1 tiles, in turns")
    ab.add_argument("--flight-ab", action="store_true",
                    help="both elastic modes with the flight recorder on and off, in turns")
    args = parser.parse_args(argv)
    modes = (PROFILING_MODES if args.profiling_ab else GRANT_MODES if args.grants_ab
             else FLIGHT_MODES if args.flight_ab else MODES)
    profiling = constants.PROFILING_ENABLED
    try:
        return _profile(args, modes)
    finally:
        constants.PROFILING_ENABLED = profiling


def _profile(args, modes: dict) -> int:
    device = args.platform
    if device == "cuda" and not torch.cuda.is_available():
        print("profile_elastic: no CUDA device", file=sys.stderr)
        return 1
    print(f"[card] {_card(device)}")
    os.environ["CDT_DETERMINISTIC_BLEND"] = "1"
    workflow = _workflow(args)
    usdu = workflow["5"]["inputs"]
    n_tiles = plan_grid(args.image_px, args.image_px, float(usdu["upscale_by"]),
                        int(usdu["tile_width"]), int(usdu["tile_padding"]),
                        int(usdu["tile_height"]))[2].num_tiles
    bundle = pl.load_pipeline(args.model, seed=0, device=device)
    rng = np.random.default_rng(SEED)
    pixels = rng.random((args.image_px, args.image_px, 3), dtype=np.float32)
    with tempfile.TemporaryDirectory(prefix="cdt_profile_elastic_") as tmp:
        in_dir = os.path.join(tmp, "input")
        os.makedirs(in_dir)
        with open(os.path.join(in_dir, workflow["4"]["inputs"]["image"]), "wb") as fh:
            fh.write(img_utils.encode_png(pixels))
        ports = {name: _free_port() for name in ("master", "w1", *WORKER_PROCESSES)}
        config_path = os.path.join(tmp, "config.json")
        config_mod.save_config({
            "master": {"host": "127.0.0.1"},
            "workers": [{"id": wid, "name": wid, "type": "local", "host": "127.0.0.1",
                         "port": ports[wid], "enabled": True}
                        for wid in ("w1", *WORKER_PROCESSES)],
            "settings": {"input_dir": in_dir, "output_dir": os.path.join(tmp, "output")},
        }, config_path)
        procs: dict[str, tuple[subprocess.Popen, str]] = {}
        for wid, value in WORKER_PROCESSES.items():
            if wid not in modes.values():
                continue
            log_path = os.path.join(tmp, f"{wid}.log")
            env = {**os.environ, "PYTHONPATH": REPO}
            if args.profiling_ab or args.flight_ab:
                env["CDT_PROFILING" if args.profiling_ab else "CDT_FLIGHT"] = value
            with open(log_path, "wb") as log:
                procs[wid] = (subprocess.Popen(
                    [sys.executable, "-m", "comfyui_distributed_tpu_torch", "--port",
                     str(ports[wid]), "--worker", "--config", config_path, "--platform", device],
                    cwd=REPO, stdout=log, stderr=subprocess.STDOUT, env=env,
                ), log_path)
        loop = ServerLoopThread()
        loop.start()
        master = DistributedServer(port=ports["master"], is_worker=False,
                                   config_path=config_path, device=device)
        in_process = DistributedServer(port=ports["w1"], is_worker=True,
                                       config_path=config_path, device=device)
        for server in (master, in_process):
            server.execution_context.pipelines[args.model] = bundle
        try:
            async def boot():
                await master.start()
                await in_process.start()

            asyncio.run_coroutine_threadsafe(boot(), loop.loop).result(timeout=60)
            base = f"http://127.0.0.1:{ports['master']}"
            for wid, (proc, _) in procs.items():
                url = f"http://127.0.0.1:{ports[wid]}/prompt"
                _wait(lambda url=url: request_json("GET", url, timeout=5)[0] == 200,
                      f"worker {wid} start", 300, proc)
            names = list(modes)

            def run(name):
                worker = modes[name]
                if args.profiling_ab:
                    constants.PROFILING_ENABLED = name == names[0]
                if args.grants_ab:
                    master.scheduler.placement.base_batch = (
                        constants.SCHED_BASE_PULL_BATCH if name == names[0] else 1)
                if args.flight_ab:
                    # w1 shares the master's bus, so one tap serves both
                    if name in FLIGHT_OFF:
                        master.flight.uninstall()
                    else:
                        master.flight.install()
                worker_base = f"http://127.0.0.1:{ports[worker]}" if worker else None
                # a worker process keeps its stages in its own registry; w1
                # shares the master's
                bases = [base] + ([worker_base] if worker in procs else [])
                before = _stage_sums(bases)
                seconds, completions, out, trace_id = _run_once(
                    base, master, workflow, [worker] if worker else [], device, worker_base)
                if worker:
                    print(f"[stages] {name}: {_stage_report(before, _stage_sums(bases))}")
                    print(f"[grants] {name}: {_grants(base, trace_id, worker)}")
                return seconds, completions, out

            # warm-up: first launches, allocator, cuDNN plans, on every
            # participant (a worker that took no tile is warmed again)
            for name in names:
                for _ in range(WARMUPS):
                    seconds, completions, _ = run(name)
                    print(f"[warm-up] {name}: {seconds:.2f} s, tiles by "
                          f"{sorted(who for _, who in completions)}")
                    if not modes[name] or any(who == modes[name] for _, who in completions):
                        break
            order = []
            while len(order) < args.runs * len(names):
                order += names if len(order) // len(names) % 2 == 0 else names[::-1]
            walls: dict[str, list[float]] = {name: [] for name in names}
            worker_tiles = dict.fromkeys(names, 0)
            outputs: dict[str, torch.Tensor] = {}
            for name in order[:args.runs * len(names)]:
                seconds, completions, out = run(name)
                walls[name].append(seconds)
                outputs[name] = out
                by = {}
                for _, who in completions:
                    by[who] = by.get(who, 0) + 1
                worker_tiles[name] += by.get(modes[name], 0)
                print(f"[run] {name}: {seconds:.3f} s, {n_tiles / seconds:.4f} tiles/s, "
                      f"tiles by {by or {'master': f'{n_tiles} (local path)'}}")
            first, second = [name for name in names if modes[name]][:2]
            diff = float((outputs[first].float() - outputs[second].float()).abs().max())
            print(f"[check] {first} vs {second} output max |diff| {diff:.3g} "
                  f"(tolerance {TOLERANCE})")
            if diff > TOLERANCE:
                raise RuntimeError("the two elastic modes disagree")
            for name in names:
                median = statistics.median(walls[name])
                # the walls' quartiles, as tiles/s (the slow quartile first)
                quartiles = (statistics.quantiles(walls[name], n=4, method="inclusive")
                             if len(walls[name]) > 1 else [median] * 3)
                print(f"[summary] {name}: median {median:.3f} s over {len(walls[name])} runs, "
                      f"{n_tiles / median:.4f} tiles/s (quartiles "
                      f"{n_tiles / quartiles[2]:.4f}-{n_tiles / quartiles[0]:.4f}; walls "
                      f"{', '.join(f'{w:.3f}' for w in walls[name])})")
            # after the summaries, so that a refused A/B still shows its runs
            for name, worker in modes.items():
                if worker and not worker_tiles[name]:
                    raise RuntimeError(f"{worker} completed no tile in the {name} runs: they "
                                       "measured the master alone")
        finally:
            async def teardown():
                await master.stop()
                await in_process.stop()

            try:
                asyncio.run_coroutine_threadsafe(teardown(), loop.loop).result(timeout=60)
            finally:
                loop.stop()
                for proc, log_path in procs.values():
                    proc.terminate()
                    try:
                        proc.wait(timeout=30)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait(timeout=30)
                    if proc.returncode not in (0, -15):
                        with open(log_path, "rb") as fh:
                            print(fh.read()[-4000:].decode(errors="replace"), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
