"""The PyTorch port imports no JAX, no flax and nothing of the JAX package,
and no aiohttp, no PIL, no safetensors and no psutil (the card's machine
has none of them).

tests/conftest.py imports jax at collection, so the runtime check runs
in a fresh interpreter, where importing aiohttp, PIL, safetensors or
psutil raises. The static scan reads the port's sources (and
chip_smoke.py, which drives the port on the card) for imports of
`comfyui_distributed_tpu` that are not `comfyui_distributed_tpu_torch`,
and of aiohttp, PIL, safetensors and psutil.
"""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "comfyui_distributed_tpu_torch")

_CHECK = """
import importlib, importlib.abc, pkgutil, sys

class Blocked(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("aiohttp", "PIL", "safetensors", "psutil"):
            raise ImportError(name + " is blocked: the card's machine has none")
        return None

sys.meta_path.insert(0, Blocked())
import comfyui_distributed_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax",
             "comfyui_distributed_tpu", "aiohttp", "PIL", "safetensors", "psutil"))
print("modules=%d" % len(names))
print("outside=" + ",".join(bad))
"""


def test_importing_every_port_module_leaves_jax_out():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _CHECK], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120, check=False,
    )
    assert proc.returncode == 0, proc.stderr
    lines = dict(line.split("=", 1) for line in proc.stdout.splitlines() if "=" in line)
    assert int(lines["modules"]) >= 40  # executor, nodes, models, ops, server, elastic tier
    assert lines["outside"] == "", f"the port pulled in {lines['outside']}"


def test_the_server_and_the_elastic_tier_are_among_the_imported_modules():
    names = {os.path.relpath(p, REPO) for p in _port_sources()}
    for module in ("api/server.py", "api/httpd.py", "api/usdu_routes.py", "api/job_routes.py",
                   "api/orchestration/dispatch.py", "graph/usdu_elastic.py",
                   "graph/tile_pipeline.py", "jobs/store.py", "utils/image.py", "__main__.py",
                   "graph/nodes_distributed.py", "parallel/collective.py",
                   "models/sd_checkpoint.py", "models/controlnet.py", "models/upscaler.py",
                   "ops/tiled_vae.py", "ops/filters.py", "ops/resize.py",
                   "graph/nodes_controlnet.py", "models/sd3.py", "models/lora.py",
                   "models/gguf.py", "adapters/registry.py", "adapters/segmented.py",
                   "adapters/cache.py", "cache/keys.py", "cache/store.py",
                   "cache/integration.py", "models/dit.py", "models/video_vae.py",
                   "models/clip_vision.py", "models/video_pipeline.py",
                   "graph/nodes_video.py", "telemetry/__init__.py", "telemetry/metrics.py",
                   "telemetry/tracing.py", "telemetry/events.py", "telemetry/instruments.py",
                   "telemetry/runtime.py", "telemetry/profiling.py", "telemetry/usage.py",
                   "utils/trace_logger.py", "api/telemetry_routes.py",
                   "scheduler/__init__.py", "scheduler/queue.py", "scheduler/placement.py",
                   "scheduler/brownout.py", "scheduler/control.py", "scheduler/preempt.py",
                   "telemetry/watchdog.py", "telemetry/timeseries.py", "telemetry/slo.py",
                   "telemetry/fleet.py", "api/scheduler_routes.py",
                   "durability/__init__.py", "durability/journal.py", "durability/state.py",
                   "durability/snapshot.py", "durability/recovery.py", "durability/lease.py",
                   "durability/quorum.py", "durability/replicate.py", "durability/manager.py"):
        assert os.path.join("comfyui_distributed_tpu_torch", module) in names


def _imported_modules(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _port_sources():
    for root, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_sources_import_nothing_of_the_jax_package():
    offenders = []
    n_files = 0
    for path in _port_sources():
        n_files += 1
        for module in _imported_modules(path):
            top = module.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "comfyui_distributed_tpu", "aiohttp", "PIL",
                       "safetensors", "psutil"):
                offenders.append(f"{os.path.relpath(path, REPO)}: {module}")
    assert n_files >= 40
    assert offenders == []


def test_scan_tells_the_two_packages_apart(tmp_path):
    src = tmp_path / "probe.py"
    src.write_text(
        "import comfyui_distributed_tpu_torch.ops\n"
        "from comfyui_distributed_tpu_torch import graph\n"
        "from comfyui_distributed_tpu.models import io\n"
        "import comfyui_distributed_tpu\n"
    )
    tops = [m.split(".")[0] for m in _imported_modules(str(src))]
    assert tops.count("comfyui_distributed_tpu_torch") == 2
    assert tops.count("comfyui_distributed_tpu") == 2
