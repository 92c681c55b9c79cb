"""The port's websocket (utils/websocket.py, api/httpd.py's
accept_websocket) against itself and against aiohttp, the independent
implementation here (the card's machine has no aiohttp):

- text frames at 0, 125, 126, 65535 and 65536 bytes (the 7-, 16- and
  64-bit length forms) through the port's client and server, the port's
  client against an aiohttp server, and aiohttp's client against the
  port's server;
- ping answered by pong on both sides, and the closing handshake;
- dispatch: the port's `_dispatch_ws` against the JAX package's
  `worker_ws` route served by aiohttp, and the JAX `_dispatch_ws`
  (aiohttp's client) against the port's `worker_ws` route: an ack, and
  a rejection raised as the worker's answer, never as unreachable.

Every network wait has its own timeout.
"""

import asyncio
import json

import aiohttp
import pytest
from aiohttp import web

from comfyui_distributed_tpu_torch.api.httpd import (
    HTTPServer,
    Response,
    Router,
    accept_websocket,
    json_response,
)
from comfyui_distributed_tpu_torch.api.orchestration import dispatch as tdispatch
from comfyui_distributed_tpu_torch.utils.exceptions import (
    WorkerNotAvailableError,
    WorkerUnreachableError,
)
from comfyui_distributed_tpu_torch.utils.websocket import connect_websocket, encode_frame

SIZES = [0, 125, 126, 65535, 65536]
TIMEOUT = 20


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT))


async def _port_echo_server():
    """A port HTTPServer whose /ws echoes each text message back."""
    async def echo(request):
        ws = await accept_websocket(request)
        if ws is None:
            return json_response({"error": "no handshake"}, 400)
        async for text in ws:
            await ws.send_text(text)
        echo.close_code = ws.close_code
        return Response.detached_response()

    echo.close_code = None
    router = Router()
    router.add_get("/ws", echo)
    server = HTTPServer(router)
    await server.start("127.0.0.1", 0)
    return server, echo


async def _aiohttp_server(handler):
    app = web.Application()
    app.router.add_get("/ws", handler)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = site._server.sockets[0].getsockname()[1]
    return runner, port


@pytest.mark.parametrize("size", SIZES)
def test_port_client_and_port_server_carry_each_length_form(size):
    async def body():
        server, echo = await _port_echo_server()
        try:
            async with connect_websocket(f"ws://127.0.0.1:{server.port}/ws") as ws:
                text = "x" * size
                await ws.send_text(text)
                assert await ws.receive_text() == text
            for _ in range(100):  # the server read the client's close
                if echo.close_code is not None:
                    break
                await asyncio.sleep(0.01)
            assert echo.close_code == 1000
        finally:
            await server.stop()

    _run(body())


@pytest.mark.parametrize("size", SIZES)
def test_port_client_against_an_aiohttp_server(size):
    closes = []

    async def echo(request):
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        async for msg in ws:
            if msg.type == aiohttp.WSMsgType.TEXT:
                await ws.send_str(msg.data)
        closes.append(ws.close_code)
        return ws

    async def body():
        runner, port = await _aiohttp_server(echo)
        try:
            async with connect_websocket(f"ws://127.0.0.1:{port}/ws") as ws:
                text = "y" * size
                await ws.send_text(text)
                assert await ws.receive_text() == text
            for _ in range(100):
                if closes:
                    break
                await asyncio.sleep(0.01)
            assert closes == [1000]
        finally:
            await runner.cleanup()

    _run(body())


@pytest.mark.parametrize("size", SIZES)
def test_aiohttp_client_against_the_port_server(size):
    async def body():
        server, echo = await _port_echo_server()
        try:
            async with aiohttp.ClientSession() as session:
                async with session.ws_connect(f"ws://127.0.0.1:{server.port}/ws") as ws:
                    text = "z" * size
                    await ws.send_str(text)
                    msg = await ws.receive()
                    assert msg.type == aiohttp.WSMsgType.TEXT and msg.data == text
                    await ws.close()
                    assert ws.close_code == 1000
            for _ in range(100):
                if echo.close_code is not None:
                    break
                await asyncio.sleep(0.01)
            assert echo.close_code == 1000
        finally:
            await server.stop()

    _run(body())


def test_the_port_server_answers_a_ping_with_its_payload():
    async def body():
        server, _ = await _port_echo_server()
        try:
            async with aiohttp.ClientSession() as session:
                async with session.ws_connect(f"ws://127.0.0.1:{server.port}/ws",
                                              autoping=False) as ws:
                    await ws.ping(b"are you there")
                    msg = await ws.receive()
                    assert msg.type == aiohttp.WSMsgType.PONG
                    assert msg.data == b"are you there"
        finally:
            await server.stop()

    _run(body())


def test_the_port_client_answers_an_aiohttp_servers_ping():
    pongs = []

    async def pinger(request):
        ws = web.WebSocketResponse(autoping=False)
        await ws.prepare(request)
        await ws.ping(b"ping-payload")
        msg = await ws.receive()
        pongs.append((msg.type, msg.data))
        await ws.send_str("done")
        await ws.receive()  # the client's close
        return ws

    async def body():
        runner, port = await _aiohttp_server(pinger)
        try:
            async with connect_websocket(f"ws://127.0.0.1:{port}/ws") as ws:
                assert await ws.receive_text() == "done"
        finally:
            await runner.cleanup()

    _run(body())
    assert pongs == [(aiohttp.WSMsgType.PONG, b"ping-payload")]


def test_frame_headers_use_the_rfc_length_forms():
    assert encode_frame(0x1, b"a" * 125, mask=False)[:2] == bytes([0x81, 125])
    assert encode_frame(0x1, b"a" * 126, mask=False)[:4] == bytes([0x81, 126, 0, 126])
    assert encode_frame(0x1, b"a" * 65536, mask=False)[:10] == bytes(
        [0x81, 127, 0, 0, 0, 0, 0, 1, 0, 0])
    masked = encode_frame(0x1, b"abcd", mask=True)
    assert masked[1] == 0x80 | 4 and len(masked) == 2 + 4 + 4


def test_a_plain_get_on_the_websocket_route_answers_400():
    from comfyui_distributed_tpu_torch.utils.network import request_json

    async def body():
        server, _ = await _port_echo_server()
        try:
            return await asyncio.to_thread(request_json, "GET",
                                           f"http://127.0.0.1:{server.port}/ws", None, 10)
        finally:
            await server.stop()

    status, answer = _run(body())
    assert status == 400 and "handshake" in answer["error"]


class _FakeServer:
    """What the JAX worker_ws route calls on its server."""

    def __init__(self, reject: bool = False):
        self.reject = reject
        self.queued = []
        self.queue_remaining = 0

    def queue_prompt(self, prompt, prompt_id, extra_data=None, trace_id=None):
        if self.reject:
            raise ValueError("bad graph")
        self.queued.append((prompt_id, prompt))


@pytest.mark.parametrize("reject", [False, True])
def test_port_dispatch_against_the_jax_worker_ws_route(reject):
    from comfyui_distributed_tpu.api.worker_routes import WorkerRoutes

    fake = _FakeServer(reject=reject)
    routes = WorkerRoutes(fake)

    async def body():
        runner, port = await _aiohttp_server(routes.worker_ws)
        worker = {"id": "w1", "host": "127.0.0.1", "port": port, "type": "remote"}
        try:
            # the JAX route is served at /ws here: point the URL builder there
            original = tdispatch.build_worker_url
            tdispatch.build_worker_url = lambda w, path="": original(w, "/ws")
            try:
                await tdispatch._dispatch_ws(worker, {"1": {"class_type": "X", "inputs": {}}},
                                             "p1", None)
            finally:
                tdispatch.build_worker_url = original
        finally:
            await runner.cleanup()

    if reject:
        with pytest.raises(WorkerNotAvailableError) as info:
            _run(body())
        assert not isinstance(info.value, WorkerUnreachableError)
        assert "bad graph" in str(info.value)
    else:
        _run(body())
        assert fake.queued == [("p1", {"1": {"class_type": "X", "inputs": {}}})]


@pytest.mark.parametrize("valid", [True, False])
def test_jax_dispatch_against_the_port_worker_ws_route(valid, tmp_path, port_loop):
    """aiohttp's client (the JAX `_dispatch_ws`) into the port's route on
    a DistributedServer: a valid prompt is queued and counted as taken
    over the socket; an invalid one is refused over the socket."""
    from comfyui_distributed_tpu.api.orchestration import dispatch as jdispatch
    from comfyui_distributed_tpu.utils import exceptions as jexc
    from comfyui_distributed_tpu.utils.network import close_client_session
    from comfyui_distributed_tpu_torch.api.server import DistributedServer

    server = DistributedServer(port=0, is_worker=True, config_path=str(tmp_path / "c.json"),
                               device="cpu")
    asyncio.run_coroutine_threadsafe(server.start(), port_loop.loop).result(timeout=TIMEOUT)
    port = server.http.port
    prompt = ({"1": {"class_type": "EmptyLatentImage",
                     "inputs": {"width": 8, "height": 8, "batch_size": 1}}}
              if valid else {"1": {"class_type": "NoSuchNode", "inputs": {}}})

    async def body():
        try:
            await jdispatch._dispatch_ws({"id": "w1", "host": "127.0.0.1", "port": port,
                                          "type": "remote"}, prompt, "p7", None)
        finally:
            await close_client_session()

    try:
        if valid:
            _run(body())
            assert server.ws_prompts == 1
            assert server.get_job("p7") is not None
            assert server.get_job("p7").done.wait(TIMEOUT)
        else:
            with pytest.raises(jexc.WorkerNotAvailableError) as info:
                _run(body())
            assert not isinstance(info.value, jexc.WorkerUnreachableError)
            assert server.ws_prompts == 0
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(), port_loop.loop).result(timeout=60)


def test_a_dead_port_is_unreachable_to_the_port_dispatch():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with pytest.raises((ConnectionError, OSError)):
        _run(tdispatch._dispatch_ws({"id": "w", "host": "127.0.0.1", "port": port}, {}, "p",
                                    None))


@pytest.fixture
def port_loop():
    from comfyui_distributed_tpu_torch.utils.async_helpers import ServerLoopThread

    loop = ServerLoopThread(name="ws-test-loop")
    loop.start()
    yield loop
    loop.stop()


def test_json_messages_survive_both_directions():
    async def body():
        server, _ = await _port_echo_server()
        try:
            async with connect_websocket(f"ws://127.0.0.1:{server.port}/ws") as ws:
                message = {"type": "dispatch_prompt", "prompt": {"1": {"inputs": {"t": "é"}}}}
                await ws.send_json(message)
                assert json.loads(await ws.receive_text()) == message
        finally:
            await server.stop()

    _run(body())
