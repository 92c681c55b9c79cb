"""A small HTTP/1.1 server on `asyncio.start_server`, in place of aiohttp.

It serves what the port's routes need: JSON request and response
bodies sized by Content-Length, raw response bodies (a served image),
path parameters (`/history/{prompt_id}`) and query strings, extra
response headers (Retry-After), a 413
answer for a body past MAX_PAYLOAD_SIZE, and a clean shutdown that
cancels the handlers still running. Each connection carries one request
(`Connection: close`): the elastic tier's clients open one connection
per RPC. Chunked request bodies are refused (411).

Two more framings, in place of aiohttp's:

- `parse_multipart` reads a `multipart/form-data` body (the media
  sync's uploads, aiohttp's `FormData` included) and `encode_multipart`
  writes one;
- `accept_websocket` upgrades a request to an RFC 6455 websocket
  (utils/websocket.py holds the frames and the client): the handler
  then owns the connection and answers `Response.detached_response()`.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import re
import urllib.parse
import uuid
from typing import Any, Awaitable, Callable, Optional

from ..utils.constants import MAX_PAYLOAD_SIZE
from ..utils.logging import debug_log, log
from ..utils.websocket import WebSocket, accept_key

_REASONS = {101: "Switching Protocols", 200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 409: "Conflict", 411: "Length Required",
            413: "Payload Too Large", 429: "Too Many Requests", 500: "Internal Server Error",
            502: "Bad Gateway",
            503: "Service Unavailable"}
# the request line and headers of one request
MAX_HEADER_BYTES = 64 * 1024


class Request:
    def __init__(self, method: str, path: str, headers: dict[str, str], body: bytes,
                 match_info: dict[str, str], query: dict[str, str] | None = None,
                 reader: asyncio.StreamReader | None = None,
                 writer: asyncio.StreamWriter | None = None):
        self.method = method
        self.path = path
        self.headers = headers  # names in lower case
        self.body = body
        self.match_info = match_info
        self.query = query or {}
        # the connection, for a handler that upgrades it (accept_websocket)
        self.reader = reader
        self.writer = writer

    @property
    def remote(self) -> Optional[str]:
        """The peer's host, as aiohttp's `request.remote`; None without a
        connection."""
        peer = self.writer.get_extra_info("peername") if self.writer is not None else None
        return str(peer[0]) if peer else None

    def json(self) -> Any:
        """The body decoded as JSON; None when it is empty or malformed."""
        if not self.body:
            return None
        try:
            return json.loads(self.body)
        except ValueError:
            return None


class Response:
    def __init__(self, body: Any = None, status: int = 200,
                 headers: dict[str, str] | None = None):
        self.status = status
        self.body = b"" if body is None else json.dumps(body).encode("utf-8")
        self.content_type = "application/json"
        # extra response headers (Retry-After on a 429 or 503)
        self.headers = dict(headers or {})
        # the handler wrote to the connection itself (a websocket)
        self.detached = False

    @classmethod
    def raw(cls, data: bytes, content_type: str, status: int = 200) -> "Response":
        response = cls(None, status)
        response.body, response.content_type = data, content_type
        return response

    @classmethod
    def detached_response(cls) -> "Response":
        response = cls(None, 101)
        response.detached = True
        return response


def json_response(body: Any, status: int = 200,
                  headers: dict[str, str] | None = None) -> Response:
    return Response(body, status, headers)


Handler = Callable[[Request], Awaitable[Response]]


class Router:
    """Method + path → handler; `{name}` in a path matches one segment."""

    def __init__(self) -> None:
        self._routes: list[tuple[str, re.Pattern, Handler]] = []

    def add(self, method: str, path: str, handler: Handler) -> None:
        pattern = "^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", re.escape(path).replace(
            r"\{", "{").replace(r"\}", "}")) + "$"
        self._routes.append((method.upper(), re.compile(pattern), handler))

    def add_get(self, path: str, handler: Handler) -> None:
        self.add("GET", path, handler)

    def add_post(self, path: str, handler: Handler) -> None:
        self.add("POST", path, handler)

    def add_delete(self, path: str, handler: Handler) -> None:
        self.add("DELETE", path, handler)

    def resolve(self, method: str, path: str) -> tuple[Optional[Handler], dict[str, str], bool]:
        """(handler, path parameters, whether the path exists at all)."""
        path_known = False
        for route_method, pattern, handler in self._routes:
            match = pattern.match(path)
            if match is None:
                continue
            path_known = True
            if route_method == method:
                params = {k: urllib.parse.unquote(v) for k, v in match.groupdict().items()}
                return handler, params, True
        return None, {}, path_known


class HTTPServer:
    def __init__(self, router: Router, max_body: int = MAX_PAYLOAD_SIZE):
        self.router = router
        self.max_body = max_body
        self._server: Optional[asyncio.AbstractServer] = None
        self._tasks: set[asyncio.Task] = set()

    async def start(self, host: str, port: int) -> None:
        self._server = await asyncio.start_server(self._serve, host, port, limit=MAX_HEADER_BYTES)

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        """Stop listening, cancel the handlers still running, wait for them."""
        if self._server is None:
            return
        self._server.close()
        tasks = list(self._tasks)
        for task in tasks:
            task.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        try:
            await asyncio.wait_for(self._server.wait_closed(), 5.0)
        except asyncio.TimeoutError:
            log("http server: connections still open 5 s after close")
        self._server = None

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._tasks.add(task)
        try:
            response = await self._handle(reader, writer)
            if not response.detached:
                await self._write(writer, response)
        except (ConnectionError, asyncio.IncompleteReadError) as exc:
            debug_log(f"http connection dropped: {type(exc).__name__}: {exc}")
        finally:
            self._tasks.discard(task)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, asyncio.CancelledError):
                pass

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> Response:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.LimitOverrunError:
            return json_response({"error": "request head too large"}, 400)
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, _version = lines[0].split(" ", 2)
        except ValueError:
            return json_response({"error": "malformed request line"}, 400)
        headers = {}
        for line in lines[1:]:
            if ":" in line:
                name, _, value = line.partition(":")
                headers[name.strip().lower()] = value.strip()
        if "chunked" in headers.get("transfer-encoding", "").lower():
            return json_response({"error": "chunked bodies are not accepted"}, 411)
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            return json_response({"error": "bad Content-Length"}, 400)
        if length > self.max_body:
            return json_response(
                {"error": f"body of {length} bytes exceeds the limit of {self.max_body}"}, 413
            )
        body = await reader.readexactly(length) if length > 0 else b""
        parsed = urllib.parse.urlsplit(target)
        handler, params, path_known = self.router.resolve(method.upper(), parsed.path)
        if handler is None:
            return json_response({"error": "method not allowed" if path_known else "not found"},
                                 405 if path_known else 404)
        query = dict(urllib.parse.parse_qsl(parsed.query))
        request = Request(method.upper(), parsed.path, headers, body, params, query, reader,
                          writer)
        try:
            return await handler(request)
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # noqa: BLE001 - the server keeps serving
            log(f"handler for {method} {parsed.path} failed: {type(exc).__name__}: {exc}")
            return json_response({"error": f"{type(exc).__name__}: {exc}"}, 500)

    @staticmethod
    async def _write(writer: asyncio.StreamWriter, response: Response) -> None:
        reason = _REASONS.get(response.status, "Status")
        head = [f"HTTP/1.1 {response.status} {reason}",
                f"Content-Type: {response.content_type}",
                f"Content-Length: {len(response.body)}",
                *(f"{name}: {value}" for name, value in response.headers.items()),
                "Connection: close"]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + response.body)
        await writer.drain()


# --- websocket upgrade -----------------------------------------------------

async def accept_websocket(request: Request) -> Optional[WebSocket]:
    """Answer a websocket handshake (RFC 6455 section 4.2) with 101 and
    the Sec-WebSocket-Accept of the client's key; None when the request
    is no valid handshake (the caller answers 400). No extension is
    accepted, so a client that offered compression sends plain frames."""
    headers = request.headers
    key = headers.get("sec-websocket-key", "")
    if (request.method != "GET" or headers.get("upgrade", "").lower() != "websocket"
            or "upgrade" not in headers.get("connection", "").lower()
            or headers.get("sec-websocket-version") != "13" or not key
            or request.writer is None):
        return None
    head = ["HTTP/1.1 101 Switching Protocols", "Upgrade: websocket", "Connection: Upgrade",
            f"Sec-WebSocket-Accept: {accept_key(key)}"]
    request.writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))
    await request.writer.drain()
    return WebSocket(request.reader, request.writer, mask=False)


# --- multipart/form-data ---------------------------------------------------

@dataclasses.dataclass
class Part:
    name: str
    filename: Optional[str]
    data: bytes


def _disposition_params(value: str) -> dict[str, str]:
    """The parameters of a Content-Disposition value (quoted strings with
    backslash escapes, as aiohttp writes them)."""
    params: dict[str, str] = {}
    for match in re.finditer(r';\s*([\w*-]+)\s*=\s*("(?:[^"\\]|\\.)*"|[^;]*)', value):
        name, raw = match.group(1).lower(), match.group(2).strip()
        if raw.startswith('"'):
            raw = re.sub(r"\\(.)", r"\1", raw[1:-1])
        if name.endswith("*"):  # RFC 5987: charset'lang'percent-encoded
            name = name[:-1]
            raw = urllib.parse.unquote(raw.split("'", 2)[-1])
        params.setdefault(name, raw)
    return params


def _multipart_boundary(content_type: str) -> Optional[str]:
    if not content_type.lower().startswith("multipart/form-data"):
        return None
    match = re.search(r'boundary=("([^"]+)"|[^;\s]+)', content_type)
    if match is None:
        return None
    return match.group(2) or match.group(1)


def parse_multipart(body: bytes, content_type: str) -> list[Part]:
    """The parts of a multipart/form-data body (RFC 7578). A part's data
    ends at CRLF "--" boundary, so a body holding CRLF "--" without the
    boundary after it (a PNG may) stays whole. Raises ValueError on a
    body that is not multipart or is cut off."""
    boundary = _multipart_boundary(content_type)
    if boundary is None:
        raise ValueError("not multipart/form-data with a boundary")
    delimiter = b"--" + boundary.encode("latin-1")
    start = body.find(delimiter)
    if start < 0:
        raise ValueError("no multipart boundary in the body")
    parts = []
    pos = start + len(delimiter)
    while True:
        if body[pos:pos + 2] == b"--":
            return parts  # the close delimiter
        if body[pos:pos + 2] != b"\r\n":
            raise ValueError("malformed multipart delimiter line")
        head_end = body.find(b"\r\n\r\n", pos + 2)
        if head_end < 0:
            raise ValueError("multipart part headers cut off")
        headers = {}
        for line in body[pos + 2:head_end].decode("utf-8", "replace").split("\r\n"):
            name, _, value = line.partition(":")
            headers[name.strip().lower()] = value.strip()
        data_end = body.find(b"\r\n" + delimiter, head_end + 4)
        if data_end < 0:
            raise ValueError("multipart body cut off")
        params = _disposition_params(headers.get("content-disposition", ""))
        parts.append(Part(name=params.get("name", ""), filename=params.get("filename"),
                          data=body[head_end + 4:data_end]))
        pos = data_end + 2 + len(delimiter)


def encode_multipart(fields: list[tuple[str, Optional[str], bytes]]) -> tuple[bytes, str]:
    """(body, Content-Type) of a multipart/form-data body of (name,
    filename or None, data) fields."""
    boundary = uuid.uuid4().hex
    chunks = []
    for name, filename, data in fields:
        disposition = f'form-data; name="{_quote(name)}"'
        if filename is not None:
            disposition += f'; filename="{_quote(filename)}"'
        chunks.append(f"--{boundary}\r\nContent-Disposition: {disposition}\r\n"
                      "Content-Type: application/octet-stream\r\n\r\n".encode("utf-8"))
        chunks.append(data)
        chunks.append(b"\r\n")
    chunks.append(f"--{boundary}--\r\n".encode("latin-1"))
    return b"".join(chunks), f"multipart/form-data; boundary={boundary}"


def _quote(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"')
