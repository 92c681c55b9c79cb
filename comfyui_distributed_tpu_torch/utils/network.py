"""HTTP transport for the elastic tier, on `urllib.request`.

The port's own copy of the parts of comfyui_distributed_tpu/utils/
network.py that the port calls: host normalisation, the worker and
master URL builders (cloud hosts get https), and the `/prompt` probe
whose `queue_remaining` is the busy-ness metric. The JAX package pools
aiohttp sessions; here each request is one blocking `urllib` call,
which coroutines run on a worker thread (`asyncio.to_thread`), never on
the loop.

Every GET and POST of the port goes through `request_json` or
`request_bytes`, so these two are the fault-injection seam the JAX
package puts in its wrapper of the pooled aiohttp client
(`FaultingClientSession`): under an active fault plan (CDT_FAULT_PLAN,
or an injector installed with resilience.faults.set_fault_injector)
each consults the injector with op `http:<METHOD>:<path>` before it
touches the network. `latency` sleeps,
then sends; `connect_error` and `crash` raise a transport error;
`http500` answers 500 and `drop` an empty 200 without sending. The
websocket connections (utils/websocket.py) are not faulted.
"""

from __future__ import annotations

import asyncio
import http.client
import ipaddress
import json
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Optional

from .constants import DEFAULT_MASTER_PORT, PROBE_TIMEOUT_SECONDS
from .logging import debug_log

# Failures where the request may never have arrived: urllib's, the
# socket's (OSError covers refused, reset and timed-out connections)
# and a malformed or cut-off response. An HTTP error status is NOT one:
# `request_json` returns it as a status.
TRANSPORT_ERRORS: tuple[type[BaseException], ...] = (
    urllib.error.URLError, OSError, http.client.HTTPException,
)

# Participants address each other directly: no proxy from the
# environment is consulted.
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _injected(method: str, url: str) -> Optional[str]:
    """Consult the process's fault injector for this request: None to
    send it, else the kind of the answer to give without sending
    ("http500" or "drop"). Sleeps for `latency`; raises for
    `connect_error` and `crash`. Only GET and POST are faulted."""
    from ..resilience.faults import get_fault_injector

    injector = get_fault_injector()
    if injector is None or method not in ("GET", "POST"):
        return None
    path = urllib.parse.urlsplit(url).path or "/"
    action = injector.hit(f"http:{method}:{path}")
    if action is None:
        return None
    if action.kind == "latency":
        time.sleep(action.arg or 0.0)
        return None
    if action.kind in ("connect_error", "crash"):
        # a member of TRANSPORT_ERRORS, retried as a real one (the JAX
        # seam raises aiohttp's ClientConnectionError)
        raise urllib.error.URLError(f"injected {action.kind} at {path}")
    return action.kind


def request_json(method: str, url: str, payload: Any = None, timeout: float = 30.0,
                 headers: dict[str, str] | None = None) -> tuple[int, Any]:
    """One blocking HTTP request with a JSON body (or none) and the
    extra `headers` (a propagated trace id); returns (status, decoded
    JSON body or None). Raises only transport errors."""
    injected = _injected(method, url)
    if injected is not None:
        return (500, None) if injected == "http500" else (200, {})
    data = None if payload is None else json.dumps(payload).encode("utf-8")
    headers = dict(headers or {})
    if data is not None:
        headers["Content-Type"] = "application/json"
    req = urllib.request.Request(url, data=data, headers=headers, method=method)
    try:
        with _OPENER.open(req, timeout=timeout) as resp:
            status, body = resp.status, resp.read()
    except urllib.error.HTTPError as err:
        status, body = err.code, err.read()
        err.close()
    try:
        return status, json.loads(body) if body else None
    except ValueError:
        return status, None


def request_bytes(method: str, url: str, data: bytes | None = None,
                  headers: dict[str, str] | None = None, timeout: float = 30.0
                  ) -> tuple[int, bytes]:
    """One blocking HTTP request with a raw body; returns (status, the
    response's bytes). Raises only transport errors."""
    injected = _injected(method, url)
    if injected == "http500":
        return 500, f"injected fault response (500) for {url}".encode("utf-8")
    if injected == "drop":
        return 200, b""
    req = urllib.request.Request(url, data=data, headers=headers or {}, method=method)
    try:
        with _OPENER.open(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        body = err.read()
        err.close()
        return err.code, body


async def request_json_async(method: str, url: str, payload: Any = None,
                             timeout: float = 30.0, headers: dict[str, str] | None = None
                             ) -> tuple[int, Any]:
    """`request_json` on a worker thread, so the event loop never blocks."""
    return await asyncio.to_thread(request_json, method, url, payload, timeout, headers)


def parse_master_urls(raw) -> list[str]:
    """One URL or a comma-separated list; trailing slashes stripped."""
    if isinstance(raw, str):
        urls = [u.strip().rstrip("/") for u in raw.split(",")]
    else:
        urls = [str(u).strip().rstrip("/") for u in raw]
    return [u for u in urls if u]


# --- host / URL handling -------------------------------------------------

def normalize_host(host: str) -> str:
    """Strip scheme and trailing slash; keep bare host[:port]."""
    host = (host or "").strip()
    for scheme in ("https://", "http://"):
        if host.startswith(scheme):
            host = host[len(scheme):]
    return host.rstrip("/")


def split_host_port(host: str, default_port: int | None = None) -> tuple[str, int | None]:
    host = normalize_host(host)
    if host.startswith("["):  # [ipv6]:port
        end = host.find("]")
        if end != -1:
            addr, rest = host[1:end], host[end + 1:]
            if rest.startswith(":"):
                try:
                    return addr, int(rest[1:])
                except ValueError:
                    return addr, default_port
            return addr, default_port
    if host.count(":") == 1:
        name, _, port_s = host.partition(":")
        try:
            return name, int(port_s)
        except ValueError:
            return name, default_port
    return host, default_port


_LOOPBACK_HOSTS = {"", "localhost", "127.0.0.1", "::1", "0.0.0.0"}


def is_private_host(host: str) -> bool:
    """A private (RFC 1918, loopback, link-local) address or localhost:
    network_info ranks these first."""
    name, _ = split_host_port(host)
    if name in ("localhost", ""):
        return True
    try:
        return ipaddress.ip_address(name).is_private
    except ValueError:
        return False


def is_loopback_host(host: str) -> bool:
    """True only for this machine's addresses (a private LAN address is
    another machine)."""
    name, _ = split_host_port(host)
    return name in _LOOPBACK_HOSTS


def _fmt_host(name: str) -> str:
    return f"[{name}]" if ":" in name and not name.startswith("[") else name


def _wants_https(host: str, port: int | None, worker_type: str) -> bool:
    if worker_type in ("cloud", "remote_https") or port == 443:
        return True
    name, _ = split_host_port(host)
    return name.endswith(".trycloudflare.com") or ".proxy.runpod.net" in name


def build_worker_url(worker: dict[str, Any], path: str = "") -> str:
    """URL of a worker described by a config entry: https for cloud,
    tunnel and port-443 hosts, http otherwise."""
    host = normalize_host(str(worker.get("host") or "localhost"))
    worker_type = str(worker.get("type", "local"))
    name, embedded_port = split_host_port(host)
    port = embedded_port or worker.get("port") or 0
    https = _wants_https(host, port or None, worker_type)
    scheme = "https" if https else "http"
    if https and port in (443, 0):
        base = f"{scheme}://{_fmt_host(name)}"
    else:
        base = f"{scheme}://{_fmt_host(name)}:{port or DEFAULT_MASTER_PORT}"
    return f"{base}{path}" if path.startswith("/") or not path else f"{base}/{path}"


def build_master_url(master_host: str, master_port: int, path: str = "") -> str:
    host = normalize_host(master_host) or "127.0.0.1"
    name, embedded_port = split_host_port(host)
    port = embedded_port or master_port
    https = _wants_https(host, port, "remote")
    scheme = "https" if https else "http"
    if https and port in (443, 0):
        base = f"{scheme}://{_fmt_host(name)}"
    else:
        base = f"{scheme}://{_fmt_host(name)}:{port}"
    return f"{base}{path}"


def build_master_callback_url(worker: dict[str, Any], master_host: str, master_port: int,
                              path: str = "") -> str:
    """URL a worker calls the master back on: loopback for workers on
    this machine (type local, or a loopback host), whatever host the
    master advertises; the master's real address for the others."""
    if worker.get("type") == "local" or is_loopback_host(str(worker.get("host", ""))):
        return f"http://127.0.0.1:{master_port}{path}"
    return build_master_url(master_host, master_port, path)


# --- probing -------------------------------------------------------------

async def probe_worker(url_base: str, timeout: float = PROBE_TIMEOUT_SECONDS) -> dict[str, Any]:
    """GET {worker}/prompt → {"online", "queue_remaining"}."""
    try:
        status, data = await request_json_async("GET", f"{url_base}/prompt", timeout=timeout)
    except TRANSPORT_ERRORS as exc:
        debug_log(f"probe {url_base}: {type(exc).__name__}: {exc}")
        return {"online": False, "queue_remaining": None}
    remaining = data.get("exec_info", {}).get("queue_remaining") if isinstance(data, dict) else None
    if status != 200 or remaining is None:
        return {"online": False, "queue_remaining": None}
    return {"online": True, "queue_remaining": int(remaining)}
