"""Media sync: the files a prompt names, onto a worker before dispatch.

The port's own copy of comfyui_distributed_tpu/api/orchestration/
media_sync.py, on utils/network.py instead of aiohttp: find the inputs
that look like media (an image/video/audio/file/filename key or a media
extension), ask the worker for each file's md5 (POST
/distributed/check_file), upload the missing or different ones
(multipart POST /upload/image, the field "image" as the JAX uploader's
FormData writes it), and rewrite path separators to the worker's
(its /distributed/system_info `path_separator`). A file missing here is
skipped; a failed upload is logged and dispatch goes on. Each upload
counts in cdt_media_sync_uploads_total by outcome, and each sync's wall
time is a sample of cdt_media_sync_seconds.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import re
import time
from typing import Any

from ...resilience.policy import http_policy, retry_async, transport_errors
from ...telemetry.instruments import media_sync_seconds, media_sync_uploads_total
from ...utils.constants import MEDIA_SYNC_TIMEOUT_SECONDS
from ...utils.logging import debug_log, log
from ...utils.network import build_worker_url, request_bytes, request_json_async
from ..httpd import encode_multipart

MEDIA_INPUT_KEYS = ("image", "video", "audio", "file", "filename")
MEDIA_EXT_RE = re.compile(
    r"\.(png|jpg|jpeg|webp|gif|bmp|mp4|webm|mov|avi|wav|mp3|flac|ogg|safetensors)$",
    re.IGNORECASE,
)


def find_media_references(prompt: dict[str, Any]) -> list[tuple[str, str, str]]:
    """[(node_id, input_key, filename)] of the inputs that look like media."""
    refs = []
    for node_id, node in prompt.items():
        for key, value in node.get("inputs", {}).items():
            if not isinstance(value, str) or not value:
                continue
            if key in MEDIA_INPUT_KEYS or MEDIA_EXT_RE.search(value):
                refs.append((node_id, key, value))
    return refs


def file_md5(path: str) -> str:
    digest = hashlib.md5()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


async def _worker_path_separator(worker: dict[str, Any]) -> str:
    try:
        status, data = await request_json_async(
            "GET", build_worker_url(worker, "/distributed/system_info"), timeout=10)
        if status == 200 and isinstance(data, dict):
            return data.get("path_separator", os.sep)
    except Exception as exc:  # noqa: BLE001 - the local separator then
        debug_log(f"system_info of {worker.get('id')}: {exc}")
    return os.sep


async def _check_file(worker, filename: str, md5: str) -> bool:
    """Whether the worker holds `filename` with this md5."""
    url = build_worker_url(worker, "/distributed/check_file")

    async def attempt() -> bool:
        status, data = await request_json_async("POST", url, {"filename": filename, "md5": md5},
                                                timeout=15)
        if status != 200 or not isinstance(data, dict):
            return False
        return bool(data.get("exists") and data.get("matches", True))

    try:
        return await retry_async(attempt, http_policy(), retryable=transport_errors(),
                                 label=f"check_file:{filename}")
    except Exception:  # noqa: BLE001 - unknown is not present: upload
        return False


async def _upload_file(worker, path: str, filename: str) -> bool:
    url = build_worker_url(worker, "/upload/image")

    def read() -> bytes:
        with open(path, "rb") as fh:
            return fh.read()

    # read once, outside the retry: a missing local file is no transient fault
    payload = await asyncio.to_thread(read)
    body, content_type = encode_multipart([("image", os.path.basename(filename), payload)])

    async def attempt() -> bool:
        status, _ = await asyncio.to_thread(request_bytes, "POST", url, body,
                                            {"Content-Type": content_type},
                                            MEDIA_SYNC_TIMEOUT_SECONDS)
        return status == 200

    try:
        return await retry_async(attempt, http_policy(), retryable=transport_errors(),
                                 label=f"upload:{filename}")
    except Exception as exc:  # noqa: BLE001 - sync is best effort
        debug_log(f"upload of {filename} to {worker.get('id')} failed: {exc}")
        return False


async def sync_worker_media(worker: dict[str, Any], prompt: dict[str, Any], input_dir: str,
                            timeout: float = MEDIA_SYNC_TIMEOUT_SECONDS) -> dict[str, Any]:
    """Sync every media file `prompt` names to `worker`, rewriting its
    paths in place for the worker's separator. Returns the prompt."""
    refs = find_media_references(prompt)
    if not refs:
        return prompt
    worker_id = str(worker.get("id"))
    started = time.monotonic()
    sep = await _worker_path_separator(worker)

    async def sync_one(node_id: str, key: str, filename: str) -> None:
        local = filename if os.path.isabs(filename) else os.path.join(input_dir, filename)
        if not os.path.isfile(local):
            debug_log(f"media ref {filename} not found locally; skipping sync")
            return
        digest = await asyncio.to_thread(file_md5, local)
        if not await _check_file(worker, filename, digest):
            ok = await _upload_file(worker, local, filename)
            media_sync_uploads_total().inc(worker_id=worker_id, outcome="ok" if ok else "failed")
            if ok:
                log(f"synced {filename} to worker {worker.get('id')}")
            else:
                log(f"FAILED to sync {filename} to worker {worker.get('id')}")
        if sep != os.sep:
            prompt[node_id]["inputs"][key] = filename.replace(os.sep, sep)

    try:
        await asyncio.wait_for(asyncio.gather(*(sync_one(*ref) for ref in refs)), timeout)
    finally:
        media_sync_seconds().observe(time.monotonic() - started, worker_id=worker_id)
    return prompt
