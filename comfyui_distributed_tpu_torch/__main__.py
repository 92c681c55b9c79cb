"""CLI entry point: run a master or a worker server.

    python -m comfyui_distributed_tpu_torch --port 8188                # master
    python -m comfyui_distributed_tpu_torch --port 8189 --worker       # worker
    python -m comfyui_distributed_tpu_torch --port 8188 --platform cpu # no card

The same server serves both roles (a prompt's hidden inputs decide);
--worker marks the process as a worker. --platform picks the device the
nodes run on: `cuda` (the default) or `cpu`. --config names the JSON
config (default: CDT_CONFIG_PATH, else ./cdt_torch_config.json). SIGTERM
or SIGINT stops the server cleanly.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import signal
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

    from .api.server import DistributedServer

    server = DistributedServer(port=args.port, is_worker=args.worker, config_path=args.config,
                               host=args.host, device=args.platform)

    async def run() -> None:
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        await server.start()
        await stop.wait()
        await server.stop()

    asyncio.run(run())
    return 0


if __name__ == "__main__":
    sys.exit(main())
