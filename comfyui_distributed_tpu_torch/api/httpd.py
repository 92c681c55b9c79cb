"""A small HTTP/1.1 server on `asyncio.start_server`, in place of aiohttp.

It serves what the port's routes need: JSON request and response
bodies sized by Content-Length, path parameters (`/history/{prompt_id}`),
a 413 answer for a body past MAX_PAYLOAD_SIZE, and a clean shutdown that
cancels the handlers still running. Each connection carries one request
(`Connection: close`): the elastic tier's clients open one connection
per RPC. Chunked request bodies are refused (411).
"""

from __future__ import annotations

import asyncio
import json
import re
import urllib.parse
from typing import Any, Awaitable, Callable, Optional

from ..utils.constants import MAX_PAYLOAD_SIZE
from ..utils.logging import debug_log, log

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
            411: "Length Required", 413: "Payload Too Large", 500: "Internal Server Error",
            503: "Service Unavailable"}
# the request line and headers of one request
MAX_HEADER_BYTES = 64 * 1024


class Request:
    def __init__(self, method: str, path: str, headers: dict[str, str], body: bytes,
                 match_info: dict[str, str]):
        self.method = method
        self.path = path
        self.headers = headers  # names in lower case
        self.body = body
        self.match_info = match_info

    def json(self) -> Any:
        """The body decoded as JSON; None when it is empty or malformed."""
        if not self.body:
            return None
        try:
            return json.loads(self.body)
        except ValueError:
            return None


class Response:
    def __init__(self, body: Any = None, status: int = 200):
        self.status = status
        self.body = b"" if body is None else json.dumps(body).encode("utf-8")


def json_response(body: Any, status: int = 200) -> Response:
    return Response(body, status)


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
            response = await self._handle(reader)
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

    async def _handle(self, reader: asyncio.StreamReader) -> Response:
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
        request = Request(method.upper(), parsed.path, headers, body, params)
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
                "Content-Type: application/json",
                f"Content-Length: {len(response.body)}",
                "Connection: close"]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + response.body)
        await writer.drain()
