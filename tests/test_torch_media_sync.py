"""The port's media sync (api/orchestration/media_sync.py) and its
routes (/distributed/check_file, /upload/image, /distributed/load_image)
against the JAX package's:

- find_media_references gives the same references on every bundled
  workflow;
- sync uploads the missing file, skips the matching one, leaves a file
  missing here alone and rewrites path separators, in both packages on
  the same stubs (tests/api/test_media_sync.py's cases);
- the same bytes land both ways: the JAX `_upload_file` (aiohttp
  FormData) into the port's /upload/image, and the port's uploader into
  the JAX route served by aiohttp; a PNG whose body holds CRLF "--" and
  a file larger than one read buffer among them;
- check_file answers as the JAX route does, and a name that escapes
  the input directory is refused;
- a sync into a real port worker: the file arrives with the master's
  md5, and a second sync uploads nothing.
"""

import asyncio
import glob
import hashlib
import json
import os

import numpy as np
import pytest
from aiohttp import web

from comfyui_distributed_tpu.api.orchestration import media_sync as jmedia
from comfyui_distributed_tpu_torch.api.httpd import encode_multipart, parse_multipart
from comfyui_distributed_tpu_torch.api.orchestration import media_sync as tmedia
from comfyui_distributed_tpu_torch.api.server import DistributedServer
from comfyui_distributed_tpu_torch.utils import config as config_mod
from comfyui_distributed_tpu_torch.utils import image as timg
from comfyui_distributed_tpu_torch.utils.network import request_bytes, request_json

from test_torch_parity import port_loop  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 30


def _workflows():
    return sorted(glob.glob(os.path.join(REPO, "workflows", "*.json")))


def test_every_bundled_workflow_is_counted():
    assert len(_workflows()) == 16


@pytest.mark.parametrize("path", _workflows(), ids=os.path.basename)
def test_find_media_references_equals_the_jax_packages(path):
    with open(path, encoding="utf-8") as fh:
        workflow = json.load(fh)
    assert tmedia.find_media_references(workflow) == jmedia.find_media_references(workflow)


@pytest.mark.parametrize("module", [jmedia, tmedia], ids=["jax", "torch"])
def test_sync_uploads_missing_and_skips_matching(tmp_path, monkeypatch, module):
    (tmp_path / "a.png").write_bytes(b"aaa")
    (tmp_path / "b.png").write_bytes(b"bbb")
    checked, uploaded = [], []

    async def fake_check(worker, filename, md5):
        checked.append((filename, md5))
        return filename == "a.png"

    async def fake_upload(worker, path, filename):
        uploaded.append((os.path.basename(path), filename))
        return True

    async def fake_sep(worker):
        return os.sep

    monkeypatch.setattr(module, "_check_file", fake_check)
    monkeypatch.setattr(module, "_upload_file", fake_upload)
    monkeypatch.setattr(module, "_worker_path_separator", fake_sep)
    prompt = {"1": {"class_type": "LoadImage", "inputs": {"image": "a.png"}},
              "2": {"class_type": "LoadImage", "inputs": {"image": "b.png"}},
              "3": {"class_type": "LoadImage", "inputs": {"image": "missing.png"}}}
    asyncio.run(module.sync_worker_media({"id": "w"}, prompt, str(tmp_path)))
    assert sorted(checked) == [("a.png", hashlib.md5(b"aaa").hexdigest()),
                               ("b.png", hashlib.md5(b"bbb").hexdigest())]
    assert uploaded == [("b.png", "b.png")]


@pytest.mark.parametrize("module", [jmedia, tmedia], ids=["jax", "torch"])
def test_path_separator_rewrite(tmp_path, monkeypatch, module):
    (tmp_path / "sub").mkdir()
    rel = os.path.join("sub", "img.png")
    (tmp_path / rel).write_bytes(b"x")

    async def fake_check(worker, filename, md5):
        return True

    async def fake_sep(worker):
        return "\\"

    monkeypatch.setattr(module, "_check_file", fake_check)
    monkeypatch.setattr(module, "_worker_path_separator", fake_sep)
    prompt = {"1": {"class_type": "LoadImage", "inputs": {"image": rel}}}
    asyncio.run(module.sync_worker_media({"id": "w"}, prompt, str(tmp_path)))
    assert prompt["1"]["inputs"]["image"] == "sub\\img.png"


def _payloads():
    """(name, bytes): a PNG whose body holds CRLF "--" (and the boundary's
    lead-in), and 3 MiB of seeded bytes, more than one read buffer."""
    rng = np.random.default_rng(7)
    pixels = rng.random((96, 96, 3), dtype=np.float32)
    png = timg.encode_png(pixels)
    # a PNG ancillary chunk is skipped by decoders: plant the sequences in one
    text = b"Comment\x00\r\n--\r\n--boundary\r\n\r\n"
    chunk = len(text).to_bytes(4, "big") + b"tEXt" + text + b"\x00\x00\x00\x00"
    png = png[:33] + chunk + png[33:]
    big = rng.integers(0, 256, 3 * 2**20, dtype=np.uint8).tobytes()
    big = big[:1000] + b"\r\n--" + big[1000:]
    return [("input.png", png), ("big.bin", big)]


@pytest.fixture
def port_worker(tmp_path, port_loop):
    """A port worker server whose config names its own input directory."""
    in_dir = tmp_path / "worker_in"
    config_path = str(tmp_path / "worker.json")
    config_mod.save_config({"settings": {"input_dir": str(in_dir)}}, config_path)
    server = DistributedServer(port=0, is_worker=True, config_path=config_path, device="cpu")
    asyncio.run_coroutine_threadsafe(server.start(), port_loop.loop).result(timeout=TIMEOUT)
    worker = {"id": "w1", "host": "127.0.0.1", "port": server.http.port, "type": "remote"}
    yield server, worker, in_dir
    asyncio.run_coroutine_threadsafe(server.stop(), port_loop.loop).result(timeout=60)


def test_the_jax_uploader_lands_the_same_bytes_on_the_port(tmp_path, port_worker):
    from comfyui_distributed_tpu.utils.network import close_client_session

    _, worker, in_dir = port_worker
    src = tmp_path / "src"
    src.mkdir()

    async def upload(path, name):
        try:
            return await jmedia._upload_file(worker, str(path), name)
        finally:
            await close_client_session()

    for name, data in _payloads():
        (src / name).write_bytes(data)
        assert asyncio.run(asyncio.wait_for(upload(src / name, name), TIMEOUT))
        assert (in_dir / name).read_bytes() == data
    decoded = timg.decode_png_u8((in_dir / "input.png").read_bytes())
    assert decoded.shape == (96, 96, 3)


def test_the_port_uploader_lands_the_same_bytes_on_the_jax_route(tmp_path, monkeypatch):
    from comfyui_distributed_tpu.api.job_routes import JobRoutes

    jax_in = tmp_path / "jax_in"
    monkeypatch.setenv("CDT_INPUT_DIR", str(jax_in))
    routes = JobRoutes(server=None)
    src = tmp_path / "src"
    src.mkdir()

    async def body():
        app = web.Application(client_max_size=64 * 2**20)
        app.router.add_post("/upload/image", routes.upload_image)
        app.router.add_post("/distributed/check_file", routes.check_file)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        worker = {"id": "jw", "host": "127.0.0.1", "port": port, "type": "remote"}
        try:
            for name, data in _payloads():
                (src / name).write_bytes(data)
                assert await tmedia._upload_file(worker, str(src / name), name)
                digest = hashlib.md5(data).hexdigest()
                assert await tmedia._check_file(worker, name, digest)
                assert not await tmedia._check_file(worker, name, "0" * 32)
        finally:
            await runner.cleanup()

    asyncio.run(asyncio.wait_for(body(), TIMEOUT))
    for name, data in _payloads():
        assert (jax_in / name).read_bytes() == data


def test_multipart_round_trip_and_aiohttp_framing():
    body, content_type = encode_multipart([("image", 'we"ird\\name.png', b"\r\n--x\r\n"),
                                           ("note", None, b"")])
    parts = parse_multipart(body, content_type)
    assert [(p.name, p.filename, p.data) for p in parts] == [
        ("image", 'we"ird\\name.png', b"\r\n--x\r\n"), ("note", None, b"")]
    with pytest.raises(ValueError):
        parse_multipart(body[:-20], content_type)
    with pytest.raises(ValueError):
        parse_multipart(body, "application/json")


def _jax_check_file_answers(tmp_path, monkeypatch, requests):
    from comfyui_distributed_tpu.api.job_routes import JobRoutes

    monkeypatch.setenv("CDT_INPUT_DIR", str(tmp_path / "in"))
    routes = JobRoutes(server=None)

    async def body():
        app = web.Application()
        app.router.add_post("/distributed/check_file", routes.check_file)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        try:
            return [await asyncio.to_thread(request_json, "POST",
                                            f"http://127.0.0.1:{port}/distributed/check_file",
                                            req, 10) for req in requests]
        finally:
            await runner.cleanup()

    return asyncio.run(asyncio.wait_for(body(), TIMEOUT))


def test_check_file_answers_as_the_jax_route(tmp_path, monkeypatch, port_worker):
    _, worker, in_dir = port_worker
    data = b"seeded bytes"
    for d in (in_dir, tmp_path / "in"):
        d.mkdir(exist_ok=True)
        (d / "here.png").write_bytes(data)
    (tmp_path / "secret.png").write_bytes(data)
    digest = hashlib.md5(data).hexdigest()
    requests = [{"filename": "here.png", "md5": digest}, {"filename": "here.png", "md5": "0"},
                {"filename": "here.png"}, {"filename": "gone.png", "md5": digest},
                {"filename": "../secret.png", "md5": digest}, {"md5": digest}]
    base = f"http://127.0.0.1:{worker['port']}"
    port_answers = [request_json("POST", f"{base}/distributed/check_file", req, 10)
                    for req in requests]
    monkeypatch.delenv("CDT_INPUT_DIR", raising=False)
    jax_answers = _jax_check_file_answers(tmp_path, monkeypatch, requests)
    assert port_answers == jax_answers
    assert port_answers[0] == (200, {"exists": True, "md5": digest, "matches": True})
    assert port_answers[4] == (200, {"exists": False})


def test_uploads_stay_inside_the_input_directory(tmp_path, port_worker):
    _, worker, in_dir = port_worker
    base = f"http://127.0.0.1:{worker['port']}"
    body, content_type = encode_multipart([("image", "../../escape.png", b"e"),
                                           ("file", "/abs/path/abs.png", b"a")])
    status, raw = request_bytes("POST", f"{base}/upload/image", body,
                                {"Content-Type": content_type}, 10)
    assert status == 200 and json.loads(raw)["saved"] == ["escape.png", "abs.png"]
    assert sorted(os.listdir(in_dir)) == ["abs.png", "escape.png"]
    assert not (tmp_path / "escape.png").exists()
    body, content_type = encode_multipart([("image", "..", b"x")])
    status, _ = request_bytes("POST", f"{base}/upload/image", body,
                              {"Content-Type": content_type}, 10)
    assert status == 400
    status, raw = request_bytes("GET", f"{base}/distributed/load_image?filename=abs.png", None,
                                None, 10)
    assert (status, raw) == (200, b"a")
    for name, want in (("../worker.json", 400), ("nothing.png", 404)):
        status, _ = request_bytes("GET", f"{base}/distributed/load_image?filename={name}", None,
                                  None, 10)
        assert status == want


def test_a_sync_into_a_port_worker_uploads_once(tmp_path, port_worker):
    server, worker, in_dir = port_worker
    master_in = tmp_path / "master_in"
    master_in.mkdir()
    (name, data), _ = _payloads()
    (master_in / name).write_bytes(data)
    prompt = {"1": {"class_type": "LoadImage", "inputs": {"image": name}}}
    uploads = []
    original = tmedia._upload_file

    async def counting(worker_, path, filename):
        uploads.append(filename)
        return await original(worker_, path, filename)

    tmedia._upload_file = counting
    try:
        for _ in range(2):
            asyncio.run(asyncio.wait_for(
                tmedia.sync_worker_media(worker, prompt, str(master_in)), TIMEOUT))
    finally:
        tmedia._upload_file = original
    assert uploads == [name]
    assert hashlib.md5((in_dir / name).read_bytes()).hexdigest() == hashlib.md5(data).hexdigest()
    assert server.input_dir() == str(in_dir)
