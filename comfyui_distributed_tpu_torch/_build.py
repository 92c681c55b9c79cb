"""Build the port's CUDA sources into plain-C-ABI shared libraries.

Each source under `csrc/` compiles with nvcc for Hopper (`sm_90a`) into
`build/` (listed in .gitignore). The library is named by the source's
content hash and that of every other file under `csrc/` (the headers it
includes), so an edited source or header rebuilds and an unchanged tree
loads as is. A source of PARTS compiles as that many objects at once, one
nvcc each with `-DCDT_PARTS=n -DCDT_PART=k` (the source keeps group k of
its instances in object k), then links them into the one library: the
build takes its slowest group's time, not the sum. Nothing here runs at
import time: a kernel builds on its first launch, which is why `python3
chip_smoke.py` from a fresh checkout builds everything it needs.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
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
# sources compiled as this many objects at once (the groups of their
# instances, CDT_PARTS in the source)
PARTS = {"flash_attention.cu": 8}


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
    # unique per process and thread: two builders never write one file
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    started = time.perf_counter()
    parts = PARTS.get(source_name, 1)
    if parts == 1:
        log = _nvcc([*NVCC_FLAGS, "-o", tmp, src], src)
    else:
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        objects = [f"{tmp}.{k}.o" for k in range(1, parts + 1)]
        try:
            with concurrent.futures.ThreadPoolExecutor(parts) as pool:
                logs = list(pool.map(
                    lambda k: _nvcc([*compile_flags, "-c", f"-DCDT_PARTS={parts}",
                                     f"-DCDT_PART={k}", "-o", objects[k - 1], src], src),
                    range(1, parts + 1)))
            log = "".join(logs) + _nvcc(["-shared", "-o", tmp, *objects], src)
        finally:
            for obj in objects:
                if os.path.exists(obj):
                    os.remove(obj)
    # rename last, so a concurrent process never loads a partial file
    os.replace(tmp, out)
    return BuildResult(out, time.perf_counter() - started, log)


def _nvcc(args: list[str], src: str) -> str:
    """One nvcc run; its output, or RuntimeError with it."""
    proc = subprocess.run([nvcc_path(), *args], capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode} for {src}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    return proc.stdout + proc.stderr
