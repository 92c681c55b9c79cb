"""Crash-safe JSON writes (the port's own copy of
comfyui_distributed_tpu/utils/fsio.py).

A reader only ever sees the old complete file or the new complete file:
write a temporary file in the same directory, flush, fsync, rename over
the target, then fsync the directory so the rename itself survives a
power cut.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Any


def fsync_dir(path: str) -> None:
    """fsync a directory so a rename inside it is durable (best effort
    where a directory cannot be opened)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Atomically replace `path` with `data`; the temporary file is
    removed on any failure."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp_path = tempfile.mkstemp(
        dir=directory, prefix=f".{os.path.basename(path)}.", suffix=".tmp"
    )
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp_path, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp_path)
        raise
    fsync_dir(directory)


def atomic_write_json(path: str, data: Any, indent: int | None = 2,
                      sort_keys: bool = False) -> None:
    """Atomically replace `path` with `data` as JSON. Serialisation comes
    first, so an unserialisable value raises before the disk is touched."""
    payload = json.dumps(data, indent=indent, sort_keys=sort_keys) + "\n"
    atomic_write_bytes(path, payload.encode("utf-8"))
