"""RFC 6455 websockets on asyncio streams, in place of aiohttp's.

`WebSocket` reads and writes frames on a connection that has already
been upgraded: text and binary messages (fragmented ones reassembled),
payload lengths in the 7-, 16- and 64-bit forms, masking (a client
masks every frame it sends, a server none), ping answered by pong, and
the closing handshake. `connect_websocket` is the client: it opens the
connection, sends the handshake and checks the server's
Sec-WebSocket-Accept. The server side of the handshake is
api/httpd.py's `accept_websocket`. No extension (compression) is
offered or accepted.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import hashlib
import json
import os
import ssl
import struct
import urllib.parse
from typing import Any, AsyncIterator, Optional

from .constants import MAX_PAYLOAD_SIZE

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONTINUATION, OP_TEXT, OP_BINARY = 0x0, 0x1, 0x2
OP_CLOSE, OP_PING, OP_PONG = 0x8, 0x9, 0xA


class WebSocketError(ConnectionError):
    """A protocol violation or a failed handshake: a transport failure."""


def accept_key(key: str) -> str:
    """Sec-WebSocket-Accept for a client's Sec-WebSocket-Key."""
    return base64.b64encode(hashlib.sha1((key + GUID).encode("ascii")).digest()).decode("ascii")


def _masked(data: bytes, key: bytes) -> bytes:
    """XOR with the 4-byte key repeated (one big-integer XOR, not a
    Python loop per byte)."""
    n = len(data)
    if n == 0:
        return data
    stream = (key * (n // 4 + 1))[:n]
    return (int.from_bytes(data, "big") ^ int.from_bytes(stream, "big")).to_bytes(n, "big")


def encode_frame(opcode: int, payload: bytes, mask: bool, fin: bool = True) -> bytes:
    head = bytearray([(0x80 if fin else 0) | opcode])
    mask_bit = 0x80 if mask else 0
    n = len(payload)
    if n < 126:
        head.append(mask_bit | n)
    elif n < 1 << 16:
        head.append(mask_bit | 126)
        head += struct.pack("!H", n)
    else:
        head.append(mask_bit | 127)
        head += struct.pack("!Q", n)
    if mask:
        key = os.urandom(4)
        return bytes(head) + key + _masked(payload, key)
    return bytes(head) + payload


class WebSocket:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter, mask: bool,
                 max_message: int = MAX_PAYLOAD_SIZE):
        self.reader = reader
        self.writer = writer
        self.mask = mask  # True on the client side
        self.max_message = max_message
        self.closed = False
        self.close_code: Optional[int] = None
        self._send_lock = asyncio.Lock()

    # --- sending ---------------------------------------------------------

    async def _send(self, opcode: int, payload: bytes) -> None:
        async with self._send_lock:
            self.writer.write(encode_frame(opcode, payload, self.mask))
            await self.writer.drain()

    async def send_text(self, text: str) -> None:
        await self._send(OP_TEXT, text.encode("utf-8"))

    async def send_json(self, obj: Any) -> None:
        await self.send_text(json.dumps(obj))

    async def close(self, code: int = 1000, reason: str = "") -> None:
        """Send a close frame (once) and close the connection."""
        if not self.closed:
            self.closed = True
            try:
                await self._send(OP_CLOSE, struct.pack("!H", code) + reason.encode("utf-8"))
            except (ConnectionError, RuntimeError):
                pass
        self.writer.close()
        with contextlib.suppress(ConnectionError, asyncio.CancelledError):
            await self.writer.wait_closed()

    # --- receiving -------------------------------------------------------

    async def _read_frame(self) -> tuple[bool, int, bytes]:
        b0, b1 = await self.reader.readexactly(2)
        if b0 & 0x70:
            raise WebSocketError("reserved bits set: no extension was negotiated")
        fin, opcode, masked, n = bool(b0 & 0x80), b0 & 0x0F, bool(b1 & 0x80), b1 & 0x7F
        if n == 126:
            (n,) = struct.unpack("!H", await self.reader.readexactly(2))
        elif n == 127:
            (n,) = struct.unpack("!Q", await self.reader.readexactly(8))
        if n > self.max_message:
            raise WebSocketError(f"frame of {n} bytes exceeds the limit of {self.max_message}")
        if masked == self.mask:
            # RFC 6455 5.1: clients mask every frame, servers none
            raise WebSocketError("frame masking does not match the peer's role")
        key = await self.reader.readexactly(4) if masked else b""
        payload = await self.reader.readexactly(n)
        return fin, opcode, _masked(payload, key) if masked else payload

    async def receive(self) -> Optional[tuple[int, bytes]]:
        """The next text or binary message as (opcode, payload); None once
        the peer closed (the close is answered). Pings are answered with
        pongs on the way."""
        message: Optional[bytearray] = None
        message_op = OP_TEXT
        while True:
            try:
                fin, opcode, payload = await self._read_frame()
            except (asyncio.IncompleteReadError, ConnectionError):
                self.closed = True
                return None
            if opcode == OP_PING:
                await self._send(OP_PONG, payload)
                continue
            if opcode == OP_PONG:
                continue
            if opcode == OP_CLOSE:
                self.close_code = struct.unpack("!H", payload[:2])[0] if len(payload) >= 2 else 1005
                await self.close(self.close_code if self.close_code != 1005 else 1000)
                return None
            if opcode in (OP_TEXT, OP_BINARY):
                if message is not None:
                    raise WebSocketError("a new message began inside a fragmented one")
                message, message_op = bytearray(payload), opcode
            elif opcode == OP_CONTINUATION:
                if message is None:
                    raise WebSocketError("continuation frame with no message")
                message += payload
                if len(message) > self.max_message:
                    raise WebSocketError("fragmented message exceeds the limit")
            else:
                raise WebSocketError(f"unknown opcode {opcode:#x}")
            if fin:
                return message_op, bytes(message)

    async def receive_text(self) -> Optional[str]:
        """The next text message (binary ones are skipped); None at close."""
        while True:
            received = await self.receive()
            if received is None:
                return None
            opcode, payload = received
            if opcode == OP_TEXT:
                return payload.decode("utf-8")

    def __aiter__(self) -> AsyncIterator[str]:
        return self._texts()

    async def _texts(self) -> AsyncIterator[str]:
        while True:
            text = await self.receive_text()
            if text is None:
                return
            yield text


@contextlib.asynccontextmanager
async def connect_websocket(url: str, timeout: float = 30.0) -> AsyncIterator[WebSocket]:
    """Open a client websocket to a ws:// or wss:// URL (RFC 6455 4.1);
    closed on the way out. Raises WebSocketError (a ConnectionError) when
    the server does not complete the handshake."""
    parts = urllib.parse.urlsplit(url)
    secure = parts.scheme == "wss"
    if parts.scheme not in ("ws", "wss") or not parts.hostname:
        raise ValueError(f"not a websocket URL: {url!r}")
    port = parts.port or (443 if secure else 80)
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(parts.hostname, port,
                                ssl=ssl.create_default_context() if secure else None,
                                limit=64 * 1024), timeout)
    ws = WebSocket(reader, writer, mask=True)
    try:
        key = base64.b64encode(os.urandom(16)).decode("ascii")
        target = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
        host = parts.hostname if ":" not in parts.hostname else f"[{parts.hostname}]"
        head = [f"GET {target} HTTP/1.1", f"Host: {host}:{port}", "Upgrade: websocket",
                "Connection: Upgrade", f"Sec-WebSocket-Key: {key}", "Sec-WebSocket-Version: 13"]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))
        await writer.drain()
        try:
            answer = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), timeout)
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError) as exc:
            raise WebSocketError(f"websocket handshake with {url} cut off") from exc
        lines = answer.decode("latin-1").split("\r\n")
        headers = {}
        for line in lines[1:]:
            name, _, value = line.partition(":")
            headers[name.strip().lower()] = value.strip()
        status = lines[0].split(" ", 2)
        if len(status) < 2 or status[1] != "101":
            raise WebSocketError(f"websocket handshake with {url} answered {lines[0]!r}")
        if headers.get("sec-websocket-accept") != accept_key(key):
            raise WebSocketError(f"websocket handshake with {url}: wrong Sec-WebSocket-Accept")
        yield ws
    finally:
        await ws.close()
