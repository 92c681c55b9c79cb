"""Build the port's CUDA sources into plain-C-ABI shared libraries.

Each source under `csrc/` compiles with nvcc for Hopper (`sm_90a`) into
`build/` (listed in .gitignore). The library is named by the source's
content hash and that of every other file under `csrc/` (the headers it
includes), so an edited source or header rebuilds and an unchanged tree
loads as is. Nothing here runs at import time: a kernel builds on its first
launch, which is why `python3 chip_smoke.py` from a fresh checkout
builds everything it needs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import subprocess
import time

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "build")

# -Xptxas -v reports registers, shared memory and spills per kernel; the
# log is kept on the result so a caller can print it.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: str
    seconds: float  # 0.0 when an up-to-date library was found
    log: str


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for cand in candidates:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "kernels build from csrc/ on a machine with the CUDA toolkit"
    )


def source_digest() -> str:
    """Hash of every file under csrc/, names and contents: a source
    rebuilds when it or any header it may include changes."""
    sha = hashlib.sha1()
    for root, dirs, files in os.walk(CSRC_DIR):
        dirs.sort()
        for name in sorted(files):
            path = os.path.join(root, name)
            sha.update(os.path.relpath(path, CSRC_DIR).encode() + b"\0")
            with open(path, "rb") as fh:
                sha.update(fh.read())
    return sha.hexdigest()[:12]


def build(source_name: str) -> BuildResult:
    """Compile `csrc/<source_name>` unless a library of the current
    content of `csrc/` is already in build/; returns where the library
    is."""
    src = os.path.join(CSRC_DIR, source_name)
    digest = source_digest()
    stem = os.path.splitext(source_name)[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    if os.path.exists(out):
        return BuildResult(out, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    started = time.perf_counter()
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
        capture_output=True, text=True, check=False,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode} for {src}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    # rename last, so a concurrent process never loads a partial file
    os.replace(tmp, out)
    return BuildResult(out, time.perf_counter() - started, proc.stdout + proc.stderr)
