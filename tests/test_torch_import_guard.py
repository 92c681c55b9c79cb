"""The PyTorch port imports no JAX, no flax and nothing of the JAX package.

tests/conftest.py imports jax at collection, so the runtime check runs
in a fresh interpreter. The static scan reads the port's sources (and
chip_smoke.py, which drives the port on the card) for imports of
`comfyui_distributed_tpu` that are not `comfyui_distributed_tpu_torch`.
"""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "comfyui_distributed_tpu_torch")

_CHECK = """
import importlib, pkgutil, sys
import comfyui_distributed_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax",
             "comfyui_distributed_tpu"))
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
    assert int(lines["modules"]) >= 20  # executor, nodes, models, ops all imported
    assert lines["outside"] == "", f"the port pulled in {lines['outside']}"


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
            if top in ("jax", "jaxlib", "flax", "comfyui_distributed_tpu"):
                offenders.append(f"{os.path.relpath(path, REPO)}: {module}")
    assert n_files >= 20
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
