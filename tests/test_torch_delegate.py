"""The delegate-only master (graph/prompt.py::prepare_delegate_master_prompt
and the orchestration's delegate branch) against the JAX package:

- the rewrite gives the same JSON as the JAX function on every bundled
  workflow with a collector, as given and after the master's overrides,
  and downstream_closure agrees on every node;
- a tiny-unet master and w1 (two port servers in one process, on the
  CPU) with settings.master_delegate_only: the master runs no sampler and
  its collector returns w1's one image, which is the local run at w1's
  seed (tests/api/test_delegate_mode.py's case); with no worker online
  the master falls back and renders its own.
"""

import glob
import json
import os

import pytest
import torch

from comfyui_distributed_tpu.graph import prompt as jprompt
from comfyui_distributed_tpu_torch.api.server import DistributedServer
from comfyui_distributed_tpu_torch.graph import prompt as tprompt
from comfyui_distributed_tpu_torch.utils import config as config_mod
from comfyui_distributed_tpu_torch.utils.network import request_json

from test_torch_collector import (  # noqa: F401  (the bundle fixture)
    PNG_STEP,
    _config,
    _free_port,
    _local,
    _start,
    _stop,
    _txt2img_prompt,
    _wait_done,
    bundle,
)
from test_torch_parity import one_torch_thread, port_loop  # noqa: F401  (fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _collector_workflows():
    out = []
    for path in sorted(glob.glob(os.path.join(REPO, "workflows", "*.json"))):
        with open(path, encoding="utf-8") as fh:
            workflow = json.load(fh)
        if any(n.get("class_type") == "DistributedCollector" for n in workflow.values()):
            out.append(path)
    return out


def _load(path):
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def test_most_bundled_workflows_have_a_collector():
    assert len(_collector_workflows()) >= 12


@pytest.mark.parametrize("path", _collector_workflows(), ids=os.path.basename)
def test_the_delegate_rewrite_equals_the_jax_packages(path):
    workflow = _load(path)
    assert tprompt.prepare_delegate_master_prompt(workflow) == \
        jprompt.prepare_delegate_master_prompt(workflow)
    job_ids = {nid: f"job_{nid}" for nid in tprompt.PromptIndex(workflow).nodes_of_class(
        *tprompt.COLLECTOR_CLASSES)}
    master = tprompt.apply_participant_overrides(
        workflow, tprompt.ParticipantInfo(is_worker=False, job_ids=job_ids,
                                          enabled_worker_ids=["w1"]))
    rewritten = tprompt.prepare_delegate_master_prompt(master)
    assert rewritten == jprompt.prepare_delegate_master_prompt(master)
    assert not any(n["class_type"] in ("KSampler", "KSamplerAdvanced", "SamplerCustomAdvanced")
                   for n in rewritten.values())
    assert sum(n["class_type"] == "DistributedEmptyImage" for n in rewritten.values()) == 1


@pytest.mark.parametrize("path", _collector_workflows()[:4], ids=os.path.basename)
def test_downstream_closure_equals_the_jax_packages(path):
    workflow = _load(path)
    tindex, jindex = tprompt.PromptIndex(workflow), jprompt.PromptIndex(workflow)
    for node_id in workflow:
        assert tindex.downstream_closure(node_id) == jindex.downstream_closure(node_id)


def test_a_prompt_without_a_collector_is_kept_whole():
    prompt = {"1": {"class_type": "EmptyLatentImage", "inputs": {}}}
    assert tprompt.prepare_delegate_master_prompt(prompt) == prompt
    assert tprompt.prepare_delegate_master_prompt(prompt) is not prompt


@pytest.fixture
def delegate_cluster(tmp_path, port_loop, bundle):
    config_path, ports = _config(tmp_path)
    with config_mod.locked_config(config_path) as config:
        config["settings"]["master_delegate_only"] = True
    master = DistributedServer(port=_free_port(), is_worker=False, config_path=config_path,
                               device="cpu")
    worker = DistributedServer(port=ports["w1"], is_worker=True, config_path=config_path,
                               device="cpu")
    for server in (master, worker):
        server.execution_context.pipelines["tiny-unet"] = bundle
    _start(port_loop, (master, worker))
    yield master, worker
    _stop(port_loop, (master, worker))


def test_the_delegate_master_collects_only_the_workers_image(delegate_cluster, bundle):
    master, worker = delegate_cluster
    base = f"http://127.0.0.1:{master.port}"
    status, queued = request_json("POST", f"{base}/distributed/queue", {
        "prompt": _txt2img_prompt(), "client_id": "t", "workers": ["w1"]}, timeout=30)
    assert status == 200 and queued["workers"] == ["w1"]
    history = _wait_done(f"{base}/history/{queued['prompt_id']}")
    assert history["error"] is None, history["error"]
    # the master's prompt: the collector, its sink and the placeholder
    assert sorted(master.get_job(queued["prompt_id"]).prompt) == ["10", "8", "9"]
    assert "6" not in history["timings"]
    images = master.get_job(queued["prompt_id"]).outputs["9"][0]["images"]
    assert tuple(images.shape) == (1, 32, 32, 3)
    torch.testing.assert_close(images[0], _local(bundle, 12)[0], atol=PNG_STEP + 1e-7, rtol=0)
    assert worker.ws_prompts == 1  # dispatched over the websocket


def test_the_delegate_master_falls_back_with_no_worker(delegate_cluster, bundle):
    master, _ = delegate_cluster
    base = f"http://127.0.0.1:{master.port}"
    status, queued = request_json("POST", f"{base}/distributed/queue", {
        "prompt": _txt2img_prompt(), "client_id": "t", "workers": []}, timeout=30)
    assert status == 200 and queued["workers"] == []
    history = _wait_done(f"{base}/history/{queued['prompt_id']}")
    assert history["error"] is None, history["error"]
    assert history["timings"]["6"] > 0.0  # the master sampled
    images = master.get_job(queued["prompt_id"]).outputs["9"][0]["images"]
    torch.testing.assert_close(images, _local(bundle, 11), atol=0, rtol=0)
