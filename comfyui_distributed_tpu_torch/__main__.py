"""CLI entry point: run a master or a worker server.

    python -m comfyui_distributed_tpu_torch --port 8188                # master
    python -m comfyui_distributed_tpu_torch --port 8189 --worker       # worker
    python -m comfyui_distributed_tpu_torch --port 8188 --platform cpu # no card

The same server serves both roles (a prompt's hidden inputs decide);
--worker marks the process as a worker. --platform picks the device the
nodes run on: `cuda` (the default) or `cpu`. --config names the JSON
config (default: CDT_CONFIG_PATH, else ./cdt_torch_config.json). f32
layers compute in f32 (TF32 off for matmuls and convolutions).

A master auto-populates one disabled worker entry per spare card (once),
launches the enabled local workers when settings.auto_launch_workers is
on, and on SIGTERM, SIGINT or SIGHUP stops its managed workers (unless
settings.stop_workers_on_master_exit is off) before it stops. A worker
watches its master's PID (CDT_MASTER_PID, set by the master that
launched it) and exits when the master is gone; on SIGTERM or SIGINT it
drains its prompt, then stops.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="comfyui_distributed_tpu_torch")
    parser.add_argument("--port", type=int, default=8188)
    parser.add_argument("--host", type=str, default=None,
                        help="bind address (default 127.0.0.1, or CDT_HOST; the /distributed/* "
                             "surface has no auth, so binding wide is an explicit choice)")
    parser.add_argument("--worker", action="store_true")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--platform", choices=("cuda", "cpu"), default="cuda",
                        help="device the nodes run on (default: the card)")
    args = parser.parse_args(argv)
    if args.worker:
        os.environ.setdefault("CDT_IS_WORKER", "1")

    import torch

    # The f32 layers (the VAE's quant convs) compute in f32, not TF32: a
    # worker process then encodes exactly as its master does, where
    # cuDNN's default TF32 convolutions differ from process to process.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from .api.server import DistributedServer
    from .workers.monitor import start_master_watchdog
    from .workers.startup import (
        auto_populate_workers,
        delayed_auto_launch,
        register_signals,
        register_worker_drain,
    )

    server = DistributedServer(port=args.port, is_worker=args.worker, config_path=args.config,
                               host=args.host, device=args.platform)

    async def run() -> None:
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        await server.start()
        if server.is_worker:
            start_master_watchdog()
            register_worker_drain(loop, server, on_stopped=stop.set)
        else:
            register_signals(loop, args.config, on_stop=stop.set)
            auto_populate_workers(args.config)
            delayed_auto_launch(args.config)
        await stop.wait()
        await server.stop()

    asyncio.run(run())
    return 0


if __name__ == "__main__":
    sys.exit(main())
