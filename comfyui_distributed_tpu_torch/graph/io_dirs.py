"""Input/output directories of the media nodes (the port's own copy of
comfyui_distributed_tpu/graph/io_dirs.py): settings.input_dir /
settings.output_dir from the config, overridable by env, with defaults
under ./data.
"""

from __future__ import annotations

import os

from ..utils.exceptions import DistributedError


def _data_dir() -> str:
    return os.environ.get("CDT_DATA_DIR", os.path.join(os.getcwd(), "data"))


def get_input_dir(context=None) -> str:
    cfg = getattr(context, "config", None) or {}
    return (
        os.environ.get("CDT_INPUT_DIR")
        or cfg.get("settings", {}).get("input_dir")
        or os.path.join(_data_dir(), "input")
    )


def get_output_dir(context=None) -> str:
    cfg = getattr(context, "config", None) or {}
    return (
        os.environ.get("CDT_OUTPUT_DIR")
        or cfg.get("settings", {}).get("output_dir")
        or os.path.join(_data_dir(), "output")
    )


def resolve_input_path(name: str, context=None) -> str:
    """Absolute paths pass through; bare names resolve against the input
    dir, and a name that escapes it raises."""
    if os.path.isabs(name):
        return name
    base = os.path.normpath(get_input_dir(context))
    path = os.path.normpath(os.path.join(base, name))
    if not path.startswith(base + os.sep) and path != base:
        raise DistributedError(f"input path {name!r} escapes input dir")
    return path


def next_counter(out_dir: str, prefix: str, ext: str) -> int:
    """First free <prefix>_NNNNN.<ext> counter: max existing + 1."""
    suffix = f".{ext}"
    start = 0
    for f in os.listdir(out_dir):
        if f.startswith(f"{prefix}_") and f.endswith(suffix):
            stem = f[len(prefix) + 1 : -len(suffix)]
            if stem.isdigit():
                start = max(start, int(stem) + 1)
    return start
