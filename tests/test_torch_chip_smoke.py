"""chip_smoke.py's bookkeeping, checked on the CPU.

On the card the smoke run asserts that each run of the workflow launches
the attention kernel exactly as often as `_attention_shapes` says. Here
full-width SDXL runs on the `meta` device (shapes only, no memory) with
a router that records every attention call, so that count is held to
what the models really do. The elastic phase runs here whole, on
tiny-unet and the CPU: its servers, its HTTP round trips and its checks.
"""

import collections
import copy
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from comfyui_distributed_tpu_torch.models import layers, mmdit, sd3, vae
from comfyui_distributed_tpu_torch.models.registry import create_model, get_config
from comfyui_distributed_tpu_torch.ops import attention as attn
from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.ops import samplers as tsmp
from comfyui_distributed_tpu_torch.ops.samplers import get_sigmas
from comfyui_distributed_tpu_torch.utils import image as timg

from test_torch_parity import one_torch_thread  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def recorded_calls(monkeypatch):
    calls = collections.Counter()

    def record(q, k, v):
        calls[(tuple(q.shape), k.shape[1])] += 1
        return torch.empty_like(q)

    monkeypatch.setattr(layers, "dot_product_attention", record)
    monkeypatch.setattr(vae, "dot_product_attention", record)
    monkeypatch.setattr(mmdit, "dot_product_attention", record)
    monkeypatch.setattr(sd3, "dot_product_attention", record)
    return calls


def test_attention_shapes_match_one_sdxl_tile_on_meta(recorded_calls):
    evals = get_sigmas("karras", 20, 0.35).shape[0] - 1
    assert evals == 20
    with torch.device("meta"):
        unet, autoencoder = create_model("sdxl"), create_model("vae-sd")
        for _ in range(2):  # two evaluations of the CFG-batched UNet
            unet(torch.empty(2, 72, 72, 4), torch.empty(2), torch.empty(2, 77, 2048),
                 y=torch.empty(2, 2816))
        autoencoder.decode(autoencoder.encode(torch.empty(1, 576, 576, 3)))
    shapes = chip_smoke._attention_shapes(get_config("sdxl"), get_config("vae-sd"), 77, 72, evals)
    expected = collections.Counter()
    for _label, q, m, per_tile in shapes:
        expected[(q, m)] += per_tile * 2 // evals if q[0] == 2 else per_tile
    assert recorded_calls == expected
    assert sum(per_tile for *_, per_tile in shapes) == 2802


def test_attention_shapes_match_one_cut_sdxl_tile_on_meta(recorded_calls):
    """The adapters, samplers, usdu_full and dynamic phases' SDXL at the
    cut depth: the counts the phases assert are the UNet's calls."""
    evals = get_sigmas("karras", 20, 0.35).shape[0] - 1
    cuts = chip_smoke._depth_cuts()
    with chip_smoke._installed({name: cuts[name] for name in chip_smoke.UNET_CUTS}):
        cfg = get_config("sdxl")
        with torch.device("meta"):
            unet = create_model("sdxl")
            for _ in range(2):
                unet(torch.empty(2, 72, 72, 4), torch.empty(2), torch.empty(2, 77, 2048),
                     y=torch.empty(2, 2816))
        shapes = chip_smoke._attention_shapes(cfg, get_config("vae-sd"), 77, 72, evals)
    expected = collections.Counter()
    for _label, q, m, per_tile in shapes:
        if q[0] == 2:
            expected[(q, m)] += per_tile * 2 // evals
    assert recorded_calls == expected
    assert get_config("sdxl").num_res_blocks == 2  # the cut is gone outside the block
    unet_calls = sum(per_tile for _label, q, *_, per_tile in shapes if q[0] == 2)
    # 7 transformer blocks an evaluation (3 at level 1; 3 and the middle one's at
    # level 2), a self- and a cross-attention each
    assert unet_calls == 20 * 7 * 2


def test_expected_launches_by_instance_follow_the_shapes():
    """The main phase asserts these per tile: the UNet's 2800 D=64 calls
    on the wgmma instance, the VAE's 2 D=512 calls on wgmma512."""
    evals = get_sigmas("karras", 20, 0.35).shape[0] - 1
    shapes = chip_smoke._attention_shapes(get_config("sdxl"), get_config("vae-sd"), 77, 72, evals)
    assert chip_smoke._expected_by_instance(attn, shapes, torch) == {
        "wgmma": 2800, "wgmma512": 2, "fma": 0,
    }


def _txt2img_workflow():
    with open(os.path.join(REPO, "workflows", "distributed-txt2img.json"), encoding="utf-8") as fh:
        return json.load(fh)


def test_attention_shapes_match_one_sd15_image_on_meta(recorded_calls):
    """sd15 has num_heads, not head_dim: 8 heads of 40, 80 and 160. One
    CFG-batched UNet evaluation and one VAE decode at 512 px, on meta."""
    with torch.device("meta"):
        unet, autoencoder = create_model("sd15"), create_model("vae-sd")
        unet(torch.empty(2, 64, 64, 4), torch.empty(2), torch.empty(2, 77, 768))
        autoencoder.decode(torch.empty(1, 64, 64, 4))
    shapes = chip_smoke._txt2img_shapes(_txt2img_workflow())
    assert shapes == chip_smoke._attention_shapes(get_config("sd15"), get_config("vae-sd"), 77,
                                                  64, 20, vae_calls=1)
    expected = collections.Counter()
    for _label, q, m, per_image in shapes:
        expected[(q, m)] += per_image // 20 if q[0] == 2 else per_image
    assert recorded_calls == expected
    assert sum(per_image for *_, per_image in shapes) == 641
    assert {q[3] for _label, q, *_ in shapes} == {40, 80, 160, 512}


def test_expected_txt2img_launches_by_instance():
    """The txt2img phase asserts these per image: 640 UNet calls at D=40,
    80 and 160 on the wgmma instance, the VAE decode's one on wgmma512."""
    shapes = chip_smoke._txt2img_shapes(_txt2img_workflow())
    assert chip_smoke._expected_by_instance(attn, shapes, torch) == {
        "wgmma": 640, "wgmma512": 1, "fma": 0,
    }


@pytest.mark.parametrize("d, dtype, layout, instance", [
    (40, "bfloat16", "contiguous", "wgmma"), (160, "bfloat16", "fused", "wgmma"),
    (80, "bfloat16", "edge", "wgmma"), (80, "float32", "contiguous", "fma"),
    (40, "bfloat16", "unaligned", "fma"), (64, "bfloat16", "fused", "wgmma"),
    (512, "bfloat16", "offset", "wgmma512"), (512, "float32", "contiguous", "fma"),
])
def test_expected_instance_of_a_check(d, dtype, layout, instance):
    assert chip_smoke._expected_instance(attn, d, dtype, layout) == instance


def test_bounds_follow_the_published_peaks():
    terms = chip_smoke._bounds((2, 1296, 10, 64), 1296, "bfloat16", sms=132, clock_mhz=1980)
    assert terms["operations"] == pytest.approx(4 * 2 * 10 * 1296 * 1296 * 64 / 989e12 * 1e3)
    assert terms["bytes"] == pytest.approx(4 * 2 * 1296 * 10 * 64 * 2 / 3.35e12 * 1e3)
    assert terms["exponentials"] == pytest.approx(2 * 10 * 1296 * 1296 / (132 * 16 * 1980e6) * 1e3)
    # self-attention at 1296 tokens and D=64: operations bound
    assert chip_smoke._bound_by(terms) == "operations"
    # self@4096 at D=40: 268.4 M scores, one exp2 each at 16 a clock on
    # 132 SMs at 1980 MHz, 64.2 us, above the operations' 43.4 us
    terms = chip_smoke._bounds((2, 4096, 8, 40), 4096, "bfloat16", sms=132, clock_mhz=1980)
    assert terms["exponentials"] == pytest.approx(0.0642, abs=5e-5)
    assert terms["operations"] == pytest.approx(0.0434, abs=5e-5)
    assert chip_smoke._bound_by(terms) == "exponentials"
    # cross-attention against 77 text tokens: bytes bound
    terms = chip_smoke._bounds((2, 4096, 8, 40), 77, "bfloat16", sms=132, clock_mhz=1980)
    assert chip_smoke._bound_by(terms) == "bytes"


def test_smoke_run_refuses_without_cuda(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""



def _tiny_workflow():
    with open(os.path.join(REPO, "workflows", "distributed-upscale.json"), encoding="utf-8") as fh:
        workflow = json.load(fh)
    workflow["1"]["inputs"]["ckpt_name"] = "tiny-unet"
    workflow["5"]["inputs"].update(steps=1, tile_width=64, tile_height=64, tile_padding=16)
    return workflow


def test_usdu_options_are_the_nodes_inputs_with_its_defaults():
    opts = chip_smoke._usdu_options(_tiny_workflow())
    assert opts["tile_width"] == 64 and opts["seed"] == 7 and opts["steps"] == 1
    assert opts["mask_blur"] == 8 and opts["force_uniform_tiles"] is True
    assert opts["upscale_method"] == "bicubic" and "image" not in opts


def test_elastic_phase_runs_and_checks_on_the_cpu(capsys, one_torch_thread):
    """The phase as the card runs it, on tiny-unet: the local reference
    equals phase 4's output, every run completes each tile exactly once,
    and the output agrees with the reference. On the CPU no attention
    kernel launches, so the launch checks are off."""
    workflow = _tiny_workflow()
    bundle = tpl.load_pipeline("tiny-unet", seed=0, device="cpu")
    with torch.no_grad():
        weight = bundle.unet.out_conv.weight
        weight.copy_(torch.randn(weight.shape, generator=torch.Generator().manual_seed(0)) * 0.1)
    rng = np.random.default_rng(1)
    image = torch.from_numpy(timg.u8_to_f32(timg.f32_to_u8(
        rng.random((1, 64, 64, 3), dtype=np.float32))))
    prompt = copy.deepcopy(workflow)
    del prompt["4"], prompt["6"]
    prompt["5"]["inputs"]["image"] = image
    context = ExecutionContext(device="cpu")
    context.pipelines["tiny-unet"] = bundle
    executor = GraphExecutor(context)
    executor.execute(prompt)
    local = executor.last_results["5"][0]
    result = chip_smoke._elastic_phase(torch, bundle, "tiny-unet", workflow, image, local, "cpu")
    out = capsys.readouterr().out.splitlines()
    lines = [line for line in out if line.startswith("[elastic]")]
    assert result["launches"] == 0
    assert len(lines) == 1 + 3 * chip_smoke.ELASTIC_RUNS
    assert "max |diff| 0" in lines[0]  # the reference tiles are phase 4's
    assert all("tiles completed: master" in line for line in lines[1::3])
    assert all("stage seconds (cdt_tile_stage_seconds): master" in line
               for line in lines[2::3])
    # the [telemetry] checks of every run: counters, trace, ledger, usage
    # (no card: no memory line, and the ledger reads host-tax 1.0)
    telemetry = [line for line in out if line.startswith("[telemetry] elastic run")]
    assert len(telemetry) == 4 * chip_smoke.ELASTIC_RUNS
    assert all("= the store's completions" in line for line in telemetry[0::4])
    assert all("one tree of" in line and "rpc.submit_tiles" in line for line in telemetry[1::4])
    assert all("D2H bytes" in line for line in telemetry[2::4])
    assert all("(exact)" in line for line in telemetry[3::4])
    # the [sched] checks of every run: admission, grants, the watchdog
    sched = [line for line in out if line.startswith("[sched] elastic run")]
    assert len(sched) == chip_smoke.ELASTIC_RUNS
    assert all("admissions +1, grants +1, cdt_sched_active 0" in line
               and "stalls +0" in line and "breaker healthy" in line for line in sched)
    assert result["grants"]["master"] and sum(map(sum, result["grants"].values())) == 4


def test_the_control_plane_checks_drain_and_the_fleet_on_the_cpu(capsys, one_torch_thread):
    """The drain check before the last run and the procs phase's [fleet]
    checks, rehearsed with w1 in this process piggybacking a snapshot on
    every RPC: the 503 with its Retry-After, w1 in the master's fleet,
    its adopted chip seconds equal to its meter's, no alert."""
    workflow = _tiny_workflow()
    bundle = tpl.load_pipeline("tiny-unet", seed=0, device="cpu")
    result = chip_smoke._elastic_phase(torch, bundle, "tiny-unet", workflow,
                                       torch.zeros((1, 64, 64, 3)), None, "cpu", runs=2,
                                       drain=True, fleet_interval=1e-6)
    out = capsys.readouterr().out.splitlines()
    drained = [line for line in out if line.startswith("[sched] elastic drain:")]
    assert len(drained) == 1 and "answered 503" in drained[0] and "launches 0" in drained[0]
    assert result["drain"] == {"status": 503, "retry_after": "1"}
    fleet = [line for line in out if line.startswith("[fleet] elastic run")]
    assert len(fleet) == 2
    assert all("lists w1 (snapshot v3, devices 1" in line and "none firing" in line
               for line in fleet)
    # the drain sits between the runs: the last run follows it
    assert out.index(drained[0]) < out.index(fleet[1])


def _elastic_on_tiny():
    """chip_smoke's elastic phase on tiny-unet on the CPU, one run."""
    workflow = _tiny_workflow()
    bundle = tpl.load_pipeline("tiny-unet", seed=0, device="cpu")
    image = torch.zeros((1, 64, 64, 3))
    return chip_smoke._elastic_phase(torch, bundle, "tiny-unet", workflow, image, None, "cpu",
                                     runs=1)


def test_the_telemetry_checks_fail_when_tiles_are_not_counted(monkeypatch, one_torch_thread):
    """A tile pipeline that does not count its tiles fails the run."""
    from comfyui_distributed_tpu_torch.graph import usdu_elastic
    from comfyui_distributed_tpu_torch.telemetry.metrics import Counter

    monkeypatch.setattr(usdu_elastic, "tiles_processed_total",
                        lambda: Counter("cdt_unscraped_total", "not in the registry", ("role",)))
    with pytest.raises(RuntimeError, match="cdt_tiles_processed_total rose by"):
        _elastic_on_tiny()


def test_the_telemetry_checks_fail_when_the_trace_is_not_propagated(monkeypatch,
                                                                   one_torch_thread):
    """A worker whose RPCs carry no trace id leaves the master's tree
    without w1's pulls and submits, and fails the run."""
    from comfyui_distributed_tpu_torch.graph import usdu_elastic

    monkeypatch.setattr(usdu_elastic, "current_trace_id", lambda: None)
    with pytest.raises(RuntimeError, match="rpc.request_image"):
        _elastic_on_tiny()


def test_the_telemetry_checks_fail_when_the_ledger_misses_a_readback(monkeypatch,
                                                                    one_torch_thread):
    """A readback the ledger does not note fails the run on its D2H
    bytes."""
    from comfyui_distributed_tpu_torch.graph import tile_pipeline
    from comfyui_distributed_tpu_torch.utils import image as img_utils

    monkeypatch.setattr(tile_pipeline.GrantSampler, "collect",
                        lambda self, result: img_utils.ensure_numpy(result))
    with pytest.raises(RuntimeError, match="D2H bytes rose by"):
        _elastic_on_tiny()


@pytest.mark.parametrize("fault", ["drops", "doubles"])
def test_the_telemetry_checks_fail_when_the_meter_miscounts_a_dispatch(monkeypatch, fault,
                                                                      one_torch_thread):
    """A usage meter that drops or double-counts the dispatches fails the
    run against the transfer ledger's brackets, which are fed apart."""
    from comfyui_distributed_tpu_torch.graph import tile_pipeline

    note = tile_pipeline.GrantSampler._note_usage

    def miscount(self, elapsed_s, real):
        for _ in range({"drops": 0, "doubles": 2}[fault]):
            note(self, elapsed_s, real=real)

    monkeypatch.setattr(tile_pipeline.GrantSampler, "_note_usage", miscount)
    with pytest.raises(RuntimeError, match="the usage meter's dispatch chip ns"):
        _elastic_on_tiny()


def test_the_control_plane_checks_fail_when_the_watchdog_acts(monkeypatch, one_torch_thread):
    """A watchdog that flags a stall on the healthy run fails it."""
    from comfyui_distributed_tpu_torch.telemetry.watchdog import Watchdog

    record = Watchdog.record_latency

    def flagging(self, worker_id, seconds):
        record(self, worker_id, seconds)
        self.stalls_detected.append("job")

    monkeypatch.setattr(Watchdog, "record_latency", flagging)
    with pytest.raises(RuntimeError, match="the watchdog acted on a healthy fleet"):
        _elastic_on_tiny()


def test_the_control_plane_checks_fail_without_admission(monkeypatch, one_torch_thread):
    """A master whose queue route admits nothing (no scheduler in front of
    the orchestration: no admission, no grant, no scheduler block) fails
    the run."""
    from comfyui_distributed_tpu_torch.api.server import DistributedServer

    wire = DistributedServer._wire_control_plane

    def without_admission(self):
        wire(self)
        self.scheduler = None

    monkeypatch.setattr(DistributedServer, "_wire_control_plane", without_admission)
    # the trace lacks its sched.wait root: the first check to see it
    with pytest.raises(RuntimeError, match="not one tree under the admission wait sched.wait"):
        _elastic_on_tiny()


def test_the_fleet_check_fails_without_the_worker_snapshot(monkeypatch, one_torch_thread):
    """A worker that piggybacks no snapshot leaves the master's fleet
    without w1, and the [fleet] check fails."""
    workflow = _tiny_workflow()
    bundle = tpl.load_pipeline("tiny-unet", seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="does not list w1"):
        # the piggyback off (an interval <= 0): no snapshot is ever sent
        # (a long interval no longer does it: the first RPC always
        # carries one)
        chip_smoke._elastic_phase(torch, bundle, "tiny-unet", workflow,
                                  torch.zeros((1, 64, 64, 3)), None, "cpu", runs=1,
                                  fleet_interval=0.0)


def test_scraped_samples_parse_and_sum_by_label():
    body_samples = [("cdt_x_total", {"role": "master", "stage": "a"}, 2.0),
                    ("cdt_x_total", {"role": "worker", "stage": "a"}, 3.0),
                    ("cdt_y_total", {"role": "master"}, 7.0)]
    assert chip_smoke._total(body_samples, "cdt_x_total") == 5.0
    assert chip_smoke._total(body_samples, "cdt_x_total", role="worker") == 3.0
    assert chip_smoke._total(body_samples, "cdt_x_total", role="nobody") == 0.0
    assert chip_smoke._LABEL_RE.findall('a="x",b="q\\"uote"') == [("a", "x"), ("b", 'q\\"uote')]
    tree = [{"name": "root", "children": [{"name": "a", "children": []},
                                          {"name": "b", "children": [{"name": "c",
                                                                      "children": []}]}]}]
    assert [s["name"] for s in chip_smoke._spans_of(tree)] == ["root", "a", "b", "c"]
    workflow = _tiny_workflow()
    assert chip_smoke._tile_output_bytes(workflow, torch.zeros((1, 64, 64, 3))) == (
        96 * 96 * 3 * 4)


def test_adapters_phase_runs_and_checks_on_the_cpu(capsys, one_torch_thread):
    """The adapters phase as the card runs it, on tiny-unet served as the
    elastic phase serves it (no elastic runs), its base output the local
    tiles' weighted average: the LoRA file, LoraLoader and
    LoraLoaderModelOnly locally, the adapter over HTTP against L's tiles,
    the unknown adapter's 400, the tile cache cold, warm (every tile
    settled, no launch, the cold run's bytes), at 0.7 and on the base
    model, the weights fingerprint of a FreeU graph and of LoRA merges,
    and an attention-only adapter over HTTP twice. On the CPU no kernel
    launches, so the launch checks are off."""
    workflow = _tiny_workflow()
    bundle = tpl.load_pipeline("tiny-unet", seed=0, device="cpu")
    with torch.no_grad():
        weight = bundle.unet.out_conv.weight
        weight.copy_(torch.randn(weight.shape, generator=torch.Generator().manual_seed(0)) * 0.1)
    rng = np.random.default_rng(1)
    image = torch.from_numpy(timg.u8_to_f32(timg.f32_to_u8(
        rng.random((1, 64, 64, 3), dtype=np.float32))))
    prompt = copy.deepcopy(workflow)
    del prompt["4"], prompt["6"]
    prompt["5"]["inputs"]["image"] = image
    context = ExecutionContext(device="cpu")
    context.pipelines["tiny-unet"] = bundle
    executor = GraphExecutor(context)
    executor.execute(prompt)
    local = executor.last_results["5"][0]
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    bases = []

    def adapters_phase(servers):
        bases.append(servers["reference_avg"])
        return chip_smoke._adapters_phase(torch, bundle, "tiny-unet", workflow, image,
                                          servers["reference_avg"], servers, "cpu", gen)

    result = chip_smoke._elastic_phase(torch, bundle, "tiny-unet", workflow, image, None, "cpu",
                                       runs=0, tag="adapters", after=adapters_phase)
    adapters = result["after"]
    # the base output the phase holds LoraLoader's against is the local run's
    assert float((bases[0] - local).abs().max()) <= chip_smoke.RERUN_TOLERANCE
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("[adapters]")]
    assert len(lines) == 16, lines
    assert adapters["warm_launches"] == 0 and adapters["max_abs_diff"] <= 1.0 / 255 + 1e-6
    assert set(adapters["patch_s"]) <= {"master", "worker"} and adapters["operand_bytes"] > 0
    assert "HTTP 400" in lines[5] and "settled from the cache [0, 1, 2, 3]" in lines[7]
    assert "FreeU graph" in lines[11] and "weights fingerprint a job" in lines[12]
    assert set(adapters["fingerprint_by_graph_s"]) == {
        "FreeU", chip_smoke.ADAPTER_NAME, chip_smoke.ADAPTER_PARTIAL_NAME}
    assert 0 < adapters["partial_operand_bytes"] < adapters["operand_bytes"]
    assert os.environ.get("CDT_LORA_DIR") is None


def test_the_lora_is_worn_by_every_model_and_clip_link():
    workflow = _tiny_workflow()
    both = chip_smoke._wear_lora(workflow, {"class_type": "LoraLoader", "inputs": {}})
    model_only = chip_smoke._wear_lora(workflow, {"class_type": "LoraLoaderModelOnly",
                                                  "inputs": {}})
    links = [v for node in both.values() for v in node["inputs"].values()
             if isinstance(v, list) and v[0] in ("1", "lora")]
    assert sorted(links) == [["1", 2], ["lora", 0], ["lora", 1], ["lora", 1]]
    assert model_only["5"]["inputs"]["model"] == ["lora", 0]
    assert all(v[0] == "1" for node in model_only.values() for v in node["inputs"].values()
               if isinstance(v, list) and v[1] == 1)


def test_elastic_phase_fails_when_the_worker_is_not_dispatched(monkeypatch,
                                                               one_torch_thread):
    """A worker the probe finds offline makes the phase fail, not fall
    back to a master-only run."""
    from comfyui_distributed_tpu_torch.api.orchestration import queue_orchestration

    async def nobody(workers, concurrency=8):
        return []

    monkeypatch.setattr(queue_orchestration, "select_active_workers", nobody)
    workflow = _tiny_workflow()
    bundle = tpl.load_pipeline("tiny-unet", seed=0, device="cpu")
    image = torch.zeros((1, 64, 64, 3))
    reference, _ = chip_smoke._local_reference(torch, bundle, workflow, image)
    local = torch.zeros((1, 128, 128, 3))
    monkeypatch.setattr(chip_smoke, "_local_reference",
                        lambda *args: (reference, local))
    with pytest.raises(RuntimeError, match="w1 was not dispatched"):
        chip_smoke._elastic_phase(torch, bundle, "tiny-unet", workflow, image, local, "cpu")


def _tiny_txt2img_workflow():
    workflow = _txt2img_workflow()
    workflow["1"]["inputs"]["ckpt_name"] = "tiny-unet"
    workflow["4"]["inputs"].update(width=32, height=32)
    workflow["6"]["inputs"]["steps"] = 2
    return workflow


def test_txt2img_phase_runs_and_checks_on_the_cpu(capsys, one_torch_thread):
    """The phase as the card runs it, on tiny-unet at 32 px: the local
    runs at seeds 42 and 43, then two runs over HTTP whose batch holds the
    master's image and w1's. On the CPU no kernel launches, so the launch
    checks are off."""
    bundle = tpl.load_pipeline("tiny-unet", seed=0, device="cpu")
    chip_smoke._seed_out_conv(torch, bundle, torch.Generator().manual_seed(0))
    result = chip_smoke._txt2img_phase(torch, bundle, _tiny_txt2img_workflow(), "cpu")
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("[txt2img]")]
    assert result["launches"] == 0
    assert len(lines) == 2 + 2 * chip_smoke.TXT2IMG_RUNS
    assert "seed 42" in lines[0] and "seed 43" in lines[1]
    assert all("w1 envelopes {'w1': 1}" in line and "collector jobs left 0" in line
               for line in lines[2::2])
    assert all("image 0 vs the local seed 42 0 " in line for line in lines[3::2])


def test_txt2img_phase_fails_when_the_worker_is_not_dispatched(monkeypatch, one_torch_thread):
    from comfyui_distributed_tpu_torch.api.orchestration import queue_orchestration

    async def nobody(workers, concurrency=8):
        return []

    monkeypatch.setattr(queue_orchestration, "select_active_workers", nobody)
    bundle = tpl.load_pipeline("tiny-unet", seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="w1 was not dispatched"):
        chip_smoke._txt2img_phase(torch, bundle, _tiny_txt2img_workflow(), "cpu")


def test_txt2img_phase_fails_when_the_images_do_not_differ(monkeypatch, one_torch_thread):
    """A worker that sampled the master's seed (no offset) gives the
    master's image twice: the phase must fail, not pass on two copies."""
    from comfyui_distributed_tpu_torch.graph import nodes_core

    monkeypatch.setattr(nodes_core.SeedSpec, "effective_seed", lambda self: self.base_seed)
    bundle = tpl.load_pipeline("tiny-unet", seed=0, device="cpu")
    chip_smoke._seed_out_conv(torch, bundle, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="w1's image is not the local seed's"):
        chip_smoke._txt2img_phase(torch, bundle, _tiny_txt2img_workflow(), "cpu")


SD_WORKFLOW_FILES = ["distributed-txt2img.json", *chip_smoke.SD_WORKFLOWS.values()]


def _workflow(name):
    with open(os.path.join(REPO, "workflows", name), encoding="utf-8") as fh:
        return json.load(fh)


@pytest.mark.parametrize("name", SD_WORKFLOW_FILES)
def test_the_phase_finds_each_sd_workflows_nodes_by_class(name):
    """The workflows number their nodes differently (the seed is node 5
    or 6; inpaint has no EmptyLatentImage): the phase looks them up by
    class."""
    workflow = _workflow(name)
    found = {cls: chip_smoke._node_id(workflow, cls) for cls in (
        "CheckpointLoaderSimple", "DistributedSeed", "DistributedCollector", "SaveImage")}
    assert found["CheckpointLoaderSimple"] == "1"
    assert workflow[found["DistributedCollector"]]["inputs"]["images"][0] == \
        chip_smoke._node_id(workflow, "VAEDecode")
    assert workflow[found["SaveImage"]]["inputs"]["images"] == [found["DistributedCollector"], 0]
    samplers = [n for cls in chip_smoke.SAMPLERS for n in chip_smoke._node_ids(workflow, cls)]
    assert all(workflow[n]["inputs"].get("seed", workflow[n]["inputs"].get("noise_seed"))
               == [found["DistributedSeed"], 0] for n in samplers)
    assert len(samplers) == (2 if "2pass" in name else 1)
    side = 768 if "sd21" in name else 512
    assert chip_smoke._image_px(workflow) == (side, side)
    assert chip_smoke._sampler_evals(workflow) == 20
    with pytest.raises(RuntimeError, match="2 KSamplerAdvanced nodes"):
        chip_smoke._node_id(_workflow("distributed-txt2img-2pass.json"), "KSamplerAdvanced")


@pytest.mark.parametrize("tag, per_instance", [
    ("2pass", {"wgmma": 640, "wgmma512": 1, "fma": 0}),
    ("pag", {"wgmma": 1260, "wgmma512": 1, "fma": 0}),
    ("inpaint", {"wgmma": 640, "wgmma512": 2, "fma": 0}),
    ("sd21", {"wgmma": 640, "wgmma512": 1, "fma": 0}),
])
def test_sd_workflow_launches_match_their_models_on_meta(tag, per_instance, recorded_calls):
    """One CFG-batched UNet evaluation (and under PAG one perturbed
    evaluation at batch 1), the VAE's decode (and inpaint's encode), on
    meta: the calls `_txt2img_shapes` counts, 20 evaluations an image."""
    workflow = _workflow(chip_smoke.SD_WORKFLOWS[tag])
    ckpt = workflow["1"]["inputs"]["ckpt_name"]
    side = chip_smoke._image_px(workflow)[0] // 8
    ctx = get_config(ckpt).context_dim
    with torch.device("meta"):
        unet, autoencoder = create_model(ckpt), create_model("vae-sd")
        unet(torch.empty(2, side, side, 4), torch.empty(2), torch.empty(2, 77, ctx))
        if tag == "pag":
            unet(torch.empty(1, side, side, 4), torch.empty(1), torch.empty(1, 77, ctx),
                 pag=True)
        if tag == "inpaint":
            autoencoder.encode(torch.empty(1, 8 * side, 8 * side, 3))
        autoencoder.decode(torch.empty(1, side, side, 4))
    shapes = chip_smoke._txt2img_shapes(workflow)
    expected = collections.Counter()
    for _label, q, m, per_image in shapes:
        expected[(q, m)] += per_image // 20 if q[3] != 512 else per_image
    assert recorded_calls == expected
    assert chip_smoke._expected_by_instance(attn, shapes, torch) == per_instance
    if tag == "sd21":
        assert {(q[1], q[2], q[3]) for _label, q, *_ in shapes if q[3] == 64} == {
            (9216, 5, 64), (2304, 10, 64), (576, 20, 64), (144, 20, 64)}
        assert ("vae@9216", (1, 9216, 1, 512), 9216, 1) in shapes
    if tag == "pag":
        batch1 = {(q, m) for _label, q, m, _ in shapes if q[0] == 1 and q[3] != 512}
        assert ((1, 64, 8, 160), 64) not in batch1 and ((1, 64, 8, 160), 77) in batch1
        assert len(batch1) == 7


def _tiny_sd_workflow(tag):
    workflow = _workflow(chip_smoke.SD_WORKFLOWS[tag])
    workflow["1"]["inputs"]["ckpt_name"] = "tiny-unet-v" if tag == "sd21" else "tiny-unet"
    for node_id in chip_smoke._node_ids(workflow, "EmptyLatentImage"):
        workflow[node_id]["inputs"].update(width=32, height=32)
    return workflow


def _tiny_bundle(name):
    bundle = tpl.load_pipeline(name, seed=0, device="cpu")
    chip_smoke._seed_out_conv(torch, bundle, torch.Generator().manual_seed(0))
    return bundle


@pytest.fixture
def counted_calls(monkeypatch):
    """Every attention call counted as a launch (under "fma": the tiny
    models' head dims have no tensor-core instance), as the card's
    wrapper counts its kernel's."""

    def counting(attention):
        def call(q, k, v):
            attn.count_launch("fma")
            return attention(q, k, v)
        return call

    monkeypatch.setattr(layers, "dot_product_attention", counting(layers.dot_product_attention))
    monkeypatch.setattr(vae, "dot_product_attention", counting(vae.dot_product_attention))
    monkeypatch.setattr(mmdit, "dot_product_attention", counting(mmdit.dot_product_attention))
    monkeypatch.setattr(sd3, "dot_product_attention", counting(sd3.dot_product_attention))
    attn.reset_launch_counts()
    yield
    attn.reset_launch_counts()


@pytest.mark.parametrize("tag", list(chip_smoke.SD_WORKFLOWS))
def test_sd_workflow_phases_run_and_check_on_the_cpu(tag, capsys, one_torch_thread,
                                                     counted_calls):
    """Each later phase as the card runs it, on tiny models at 32 px:
    the local references and the workflow's own check (two-pass equals
    one KSampler, PAG differs from no PAG, inpaint keeps its latent
    outside the mask), then a run over HTTP, each run with the attention
    calls `_txt2img_shapes` counts."""
    workflow = _tiny_sd_workflow(tag)
    bundle = _tiny_bundle(workflow["1"]["inputs"]["ckpt_name"])
    per_image = sum(count for *_, count in chip_smoke._txt2img_shapes(workflow, image_px=32))
    result = chip_smoke._txt2img_phase(
        torch, bundle, workflow, "cpu", 2 * per_image,
        {"fma": 2 * per_image, "wgmma": 0, "wgmma512": 0}, runs=1, tag=tag, image_px=32)
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith(f"[{tag}]")]
    assert result["launches"] == 2 * per_image and result["images_per_s"] > 0
    extra = {"2pass": "one KSampler over the whole schedule max |diff| 0 ",
             "pag": "PAG vs without max |diff|", "inpaint": "outside the mask: True",
             "sd21": None}[tag]
    assert extra is None or any(extra in line for line in lines)
    assert "w1 envelopes {'w1': 1}" in lines[-2] and "collector jobs left 0" in lines[-2]
    assert "image 0 vs the local seed 42 0 " in lines[-1]
    if tag == "inpaint":
        assert "over the grown mask's" in lines[-1]


def test_the_inpaint_input_has_a_transparent_square_a_quarter_of_the_area():
    rgba = chip_smoke._inpaint_input(512, 1)
    hole = rgba[..., 3] == 0.0
    assert hole.sum() == 256 * 256 and hole[128:384, 128:384].all()
    assert np.array_equal(timg.u8_to_f32(timg.f32_to_u8(rgba)), rgba)  # survives a PNG


@pytest.mark.parametrize("broken, message", [
    (lambda mask: None, "sampling changed the latent outside the inpaint mask"),
    (torch.zeros_like, "the master's and w1's images do not differ"),
])
def test_the_inpaint_checks_fail_when_the_pin_is_broken(broken, message, monkeypatch,
                                                        one_torch_thread):
    """A pin that keeps nothing (no mask reaches the sampler) changes the
    latent outside the mask; one that keeps everything (a zero mask)
    gives both participants the encoded image: each check must fail."""
    sample = tpl._masked_sample

    def broken_sample(*args):
        *head, noise_mask = args
        return sample(*head, None if noise_mask is None else broken(noise_mask))

    monkeypatch.setattr(tpl, "_masked_sample", broken_sample)
    with pytest.raises(RuntimeError, match=message):
        chip_smoke._txt2img_phase(torch, _tiny_bundle("tiny-unet"), _tiny_sd_workflow("inpaint"),
                                  "cpu", runs=1, tag="inpaint", image_px=32)


# --- the checkpoint and samplers phases --------------------------------------------

@pytest.mark.parametrize("sampler, evals", [
    ("euler", 20), ("euler_ancestral", 20), ("dpmpp_2m_sde", 20), ("lcm", 20), ("heun", 39),
    ("dpm_2", 39), ("dpm_2_ancestral", 39), ("dpmpp_2s_ancestral", 39), ("dpmpp_sde", 39),
])
def test_sampler_evals_count_second_order_samplers_twice(sampler, evals):
    """A second-order sampler evaluates the UNet 2n - 1 times over n sigma
    pairs (its last step, to sigma 0, is Euler); a two-pass workflow sums
    its windows."""
    workflow = _txt2img_workflow()
    workflow["6"]["inputs"]["sampler_name"] = sampler
    assert chip_smoke._sampler_evals(workflow) == evals
    two_pass = _workflow("distributed-txt2img-2pass.json")
    for node_id in chip_smoke._node_ids(two_pass, "KSamplerAdvanced"):
        two_pass[node_id]["inputs"]["sampler_name"] = sampler
    windows = (14, 6)
    assert chip_smoke._sampler_evals(two_pass) == sum(
        2 * n - 1 if evals == 39 else n for n in windows)


def test_samplers_phase_runs_and_checks_on_the_cpu(capsys, one_torch_thread, counted_calls):
    """The phase's local runs as the card runs them, on tiny-unet at 32 px
    and 2 steps: every other sampler and scheduler once, each stochastic
    sampler three times; every run launches the attention calls
    `_txt2img_shapes` counts for its sampler."""
    workflow = _tiny_txt2img_workflow()
    result = chip_smoke._samplers_phase(torch, _tiny_bundle("tiny-unet"), workflow, "cpu")
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("[samplers]")]
    stochastic = list(tsmp.STOCHASTIC_SAMPLERS)
    variants = 11 + 7
    assert len(result["seconds"]) == variants + 2 * len(stochastic)
    assert len(lines) == variants + 2 * len(stochastic) + len(stochastic)

    def per_image(sampler, scheduler="karras"):
        prompt = copy.deepcopy(workflow)
        prompt["6"]["inputs"].update(sampler_name=sampler, scheduler=scheduler)
        return sum(count for *_, count in chip_smoke._txt2img_shapes(prompt, image_px=32))

    samplers = [s for s in tsmp.SAMPLER_NAMES if s != "euler"]
    want = sum(per_image(s) * (3 if s in stochastic else 1) for s in samplers)
    want += sum(per_image("euler", s) for s in tsmp.SCHEDULER_NAMES if s != "karras")
    # a second-order sampler: 2n - 1 UNet evaluations over n = 2 pairs
    unet_calls = per_image("euler") - 1  # less the decode's one call
    assert per_image("heun") == unet_calls // 2 * 3 + 1
    assert result["launches"] == want == result["launches_by_instance"]["fma"]
    # the kernels entry's run: SAMPLERS_ENTRY_SAMPLER's alone
    entry = per_image(chip_smoke.SAMPLERS_ENTRY_SAMPLER)
    assert result["entry_launches"] == entry == result["entry_by_instance"]["fma"]


def test_the_http_sampler_runs_the_collector_and_the_elastic_tier_on_the_cpu(
        capsys, one_torch_thread):
    """HTTP_SAMPLER (stochastic) through the txt2img phase (w1's image is
    the local run's at its own seed) and through the elastic phase with no
    local run to hold the reference against (the tiles' step noise follows
    their global index, wherever they run)."""
    workflow = _tiny_txt2img_workflow()
    workflow["6"]["inputs"]["sampler_name"] = chip_smoke.HTTP_SAMPLER
    bundle = _tiny_bundle("tiny-unet")
    chip_smoke._txt2img_phase(torch, bundle, workflow, "cpu", runs=1, tag="samplers")
    upscale = _tiny_workflow()
    upscale[chip_smoke.USDU_NODE]["inputs"]["sampler_name"] = chip_smoke.HTTP_SAMPLER
    image = torch.from_numpy(timg.u8_to_f32(timg.f32_to_u8(
        np.random.default_rng(0).random((1, 64, 64, 3), dtype=np.float32))))
    chip_smoke._elastic_phase(torch, bundle, "tiny-unet", upscale, image, None, "cpu", runs=1,
                              tag="samplers")
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("[samplers]")]
    assert any("image 1 vs the local seed 43" in line for line in lines)
    assert any("vs the local tiles composited alike" in line for line in lines)


def _tiny_ckpt_workflows():
    sd21 = _tiny_sd_workflow("sd21")
    sd21[chip_smoke._node_id(sd21, "KSampler")]["inputs"]["steps"] = 2
    return {"ckpt_sd15": _tiny_txt2img_workflow(), "ckpt_sd21": sd21}


def test_ckpt_phase_writes_loads_and_checks_on_the_cpu(capsys, monkeypatch, one_torch_thread,
                                                       counted_calls):
    """The phase as the card runs it, on tiny models at 32 px: tiny-unet in
    SD1.x's layout and tiny-unet-v with an OpenCLIP tower in SD2.x's, each
    written in f16 by the port's writer, read and loaded by a fresh master
    and w1 over HTTP: the weights equal, the image the direct run's and
    not the default init's, the launches `_txt2img_shapes`'; then
    tiny-unet's state dict as a GGUF file, loaded locally."""
    from comfyui_distributed_tpu_torch.models import registry as treg

    monkeypatch.setitem(treg.DEFAULT_TEXT_ENCODERS, "tiny-unet-v", "tiny-te-g")
    monkeypatch.setenv("CDT_CHECKPOINT_DIR", "/nonexistent-elsewhere")
    workflows = _tiny_ckpt_workflows()
    expected = {}
    for path, workflow in workflows.items():
        per_image = sum(count for *_, count in chip_smoke._txt2img_shapes(workflow, image_px=32))
        expected[path] = (2 * per_image, {"fma": 2 * per_image, "wgmma": 0, "wgmma512": 0})
    results = chip_smoke._ckpt_phase(torch, torch.Generator().manual_seed(0), workflows, "cpu",
                                     expected)
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("[ckpt]")]
    assert set(results) == set(workflows)
    assert sum("not torch.equal to the written weights: master 0, w1 0" in line
               for line in lines) == 2
    assert sum("wrote" in line and "(f16" in line for line in lines) == 2
    # GGUF: the SD1.5 path's state dict, Q8_0 and F16, loaded locally
    gguf = [line for line in lines if " GGUF: " in line]
    assert len(gguf) == 1 and "0 parameters not torch.equal" in gguf[0]
    assert results["ckpt_sd15"]["gguf"]["max_abs_diff"] <= chip_smoke.RERUN_TOLERANCE
    assert os.environ["CDT_CHECKPOINT_DIR"] == "/nonexistent-elsewhere"


def test_ckpt_phase_fails_when_the_file_is_not_read(monkeypatch, one_torch_thread):
    """A loader that ignores the file serves the default random init: the
    weights check must fail."""
    from comfyui_distributed_tpu_torch.models import sd_checkpoint as sdc

    monkeypatch.setattr(sdc, "find_checkpoint", lambda name: None)
    with pytest.raises(RuntimeError, match="loaded weights differ from the written ones"):
        chip_smoke._ckpt_phase(torch, torch.Generator().manual_seed(0),
                               {"ckpt_sd15": _tiny_txt2img_workflow()}, "cpu")


# --- usdu_full and guidance --------------------------------------------------------------------

def test_usdu_full_launches_match_one_sdxl_tile_on_meta(recorded_calls):
    """One evaluation's two batch-1 passes (a ControlNet keeps the CFG pair
    apart), the tile's VAE encode and its tiled decode, on meta: the calls
    `_usdu_full_shapes` counts, 20 evaluations a tile. The 72-latent tile
    decodes in 2 x 2 pieces of 80 latents: 5605 launches a tile, 5600
    wgmma and 5 wgmma512; 22420 a run of four tiles."""
    from comfyui_distributed_tpu_torch.ops.tiled_vae import decode_tiled

    with torch.device("meta"):
        unet, autoencoder = create_model("sdxl"), create_model("vae-sd")
        for _ in range(2):
            unet(torch.empty(1, 72, 72, 4), torch.empty(1), torch.empty(1, 77, 2048),
                 y=torch.empty(1, 2816), control=torch.empty(1, 72, 72, 320))
        decode_tiled(autoencoder, autoencoder.encode(torch.empty(1, 576, 576, 3)))
    workflow = chip_smoke._usdu_full_workflow(_workflow("distributed-upscale.json"))
    shapes = chip_smoke._usdu_full_shapes(workflow)
    expected = collections.Counter()
    for _label, q, m, per_tile in shapes:
        expected[(q, m)] += per_tile // 20 if q[3] == 64 else per_tile
    assert recorded_calls == expected
    assert ("vae@6400", (1, 6400, 1, 512), 6400, 4) in shapes
    assert sum(per_tile for *_, per_tile in shapes) == 5605
    assert chip_smoke._expected_by_instance(attn, shapes, torch) == {
        "wgmma": 5600, "wgmma512": 5, "fma": 0}


def test_the_usdu_full_workflow_wires_every_input_into_the_usdu_node():
    base = _workflow("distributed-upscale.json")
    full = chip_smoke._usdu_full_workflow(base)
    usdu = full[chip_smoke.USDU_NODE]["inputs"]
    assert full[usdu["upscale_model"][0]]["inputs"]["model_name"] == "4x-generic"
    assert usdu["tiled_decode"] is True
    apply = full[usdu["positive"][0]]
    assert apply["class_type"] == "ControlNetApplyAdvanced" and usdu["negative"] == [
        usdu["positive"][0], 1]
    assert apply["inputs"]["image"] == ["4", 0] and apply["inputs"]["strength"] == 1.0
    encode = full[apply["inputs"]["positive"][0]]
    assert encode["class_type"] == "CLIPTextEncodeSDXL"
    assert encode["inputs"]["text_g"] == base["2"]["inputs"]["text"]
    assert (encode["inputs"]["width"], encode["inputs"]["target_width"]) == (2048, 1024)
    assert base[chip_smoke.USDU_NODE]["inputs"].get("upscale_model") is None  # a copy


@pytest.mark.parametrize("variant, per_image, per_instance", [
    ("FreeU_V2", 641, {"wgmma": 640, "wgmma512": 1, "fma": 0}),
    ("FreeU", 641, {"wgmma": 640, "wgmma512": 1, "fma": 0}),
    ("SelfAttentionGuidance", 1901, {"wgmma": 1900, "wgmma512": 1, "fma": 0}),
    ("RescaleCFG", 641, {"wgmma": 640, "wgmma512": 1, "fma": 0}),
    ("area", 1921, {"wgmma": 1920, "wgmma512": 1, "fma": 0}),
])
def test_guidance_launches_match_sd15_on_meta(variant, per_image, per_instance, recorded_calls):
    """One evaluation of each guidance variant on SD1.5 at 512 px, on meta:
    plain CFG at batch 2; SAG adds the capture pass at batch 1 (its middle
    self-attention plain: 31 calls) and the degraded pass (32); the area
    image runs the whole latent twice at batch 1 and the 32 x 64 crop
    once. Then the decode: the calls `_guidance_shapes` counts."""
    workflow = chip_smoke._guidance_variants(_txt2img_workflow())[variant]
    with torch.device("meta"):
        unet, autoencoder = create_model("sd15"), create_model("vae-sd")

        def run(batch, hw=(64, 64), **kwargs):
            unet(torch.empty(batch, *hw, 4), torch.empty(batch), torch.empty(batch, 77, 768),
                 **kwargs)

        if variant == "area":
            run(1), run(1), run(1, (32, 64))
        else:
            run(2)
        if variant == "SelfAttentionGuidance":
            run(1, sag_capture=True)
            run(1)
        autoencoder.decode(torch.empty(1, 64, 64, 4))
    shapes = chip_smoke._guidance_shapes(variant, workflow)
    expected = collections.Counter()
    for _label, q, m, count in shapes:
        expected[(q, m)] += count // 20 if q[3] != 512 else count
    assert recorded_calls == expected
    assert sum(count for *_, count in shapes) == per_image
    assert chip_smoke._expected_by_instance(attn, shapes, torch) == per_instance
    if variant == "area":
        assert {(q, m) for _label, q, m, _ in shapes if q[1] in (2048, 512, 128, 32)} >= {
            ((1, 2048, 8, 40), 2048), ((1, 512, 8, 80), 512), ((1, 128, 8, 160), 128),
            ((1, 32, 8, 160), 32), ((1, 2048, 8, 40), 77)}


def test_usdu_full_phase_runs_and_checks_on_the_cpu(capsys, one_torch_thread, counted_calls):
    """The phase as the card runs it, on tiny-unet-adm (the SDXL layout):
    the local run with the upscale model, ControlNet tile (its conv_out
    seeded), CLIPTextEncodeSDXL and tiled decode, the zero-residual and
    strength-0 runs, and master + w1 over HTTP, each with the calls `_usdu_full_shapes` counts
    (a tiny tile fits one decode piece)."""
    workflow = _tiny_workflow()
    workflow["1"]["inputs"]["ckpt_name"] = "tiny-unet-adm"
    bundle = _tiny_bundle("tiny-unet-adm")
    image = torch.from_numpy(timg.u8_to_f32(timg.f32_to_u8(
        np.random.default_rng(2).random((1, 64, 64, 3), dtype=np.float32))))
    full = chip_smoke._usdu_full_workflow(workflow)
    per_tile = sum(count for *_, count in chip_smoke._usdu_full_shapes(full))
    result = chip_smoke._usdu_full_phase(
        torch, bundle, workflow, image, torch.Generator().manual_seed(1), "cpu",
        expected_launches=4 * per_tile,
        expected_by_instance={"fma": 4 * per_tile, "wgmma": 0, "wgmma512": 0},
        tiled_tolerance=chip_smoke.TILED_DECODE_TOLERANCE)
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("[usdu_full]")]
    assert result["launches"] == 4 * per_tile and result["tiles_per_s"] > 0
    assert len(lines) == 4
    assert "upscale model" in lines[0] and "tiled decode" in lines[0]
    assert "pre-upscaled images max |diff| 0;" in lines[3]


@pytest.mark.parametrize("fault", ["conv_out left zero", "residual never reaches the UNet"])
def test_usdu_full_phase_fails_when_the_controlnet_adds_nothing(fault, monkeypatch,
                                                                one_torch_thread):
    """A ControlNet whose output conv stays zero, or whose residual is
    dropped before the UNet, changes nothing: the phase's ControlNet check
    (against a zero-residual run on the same batch-1 passes) must fail."""
    if fault == "conv_out left zero":
        monkeypatch.setattr(chip_smoke, "_seed_weight", lambda torch, weight, gen: None)
    else:
        monkeypatch.setattr(tpl, "_control_residual", lambda *args, **kwargs: None)
    workflow = _tiny_workflow()
    workflow["1"]["inputs"]["ckpt_name"] = "tiny-unet-adm"
    bundle = tpl.load_pipeline("tiny-unet-adm", seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="the ControlNet does not change the output"):
        chip_smoke._usdu_full_phase(torch, bundle, workflow, torch.zeros((1, 64, 64, 3)),
                                    torch.Generator().manual_seed(1), "cpu")


def test_guidance_phase_runs_and_checks_on_the_cpu(capsys, one_torch_thread, counted_calls):
    """The phase as the card runs it, on tiny-unet at 32 px: each variant's
    local image apart from the unpatched one with the calls
    `_guidance_shapes` counts, the cached bundle unpatched, and SAG over
    the collector (w1's image its local seed 43's)."""
    workflow = _tiny_txt2img_workflow()
    bundle = _tiny_bundle("tiny-unet")
    expected = {}
    for name in chip_smoke._guidance_variants(workflow, 32):
        n = sum(count for *_, count in chip_smoke._guidance_shapes(name, workflow, 32))
        expected[name] = (n, {"fma": n, "wgmma": 0, "wgmma512": 0})
    result = chip_smoke._guidance_phase(torch, bundle, workflow, "cpu", expected, image_px=32)
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("[guidance]")]
    assert {name: r["launches"] for name, r in result.items() if name != "http"} == {
        name: n for name, (n, _) in expected.items()}
    assert sum("vs unpatched max |diff|" in line for line in lines) == 5
    assert "collector jobs left 0" in lines[-2] and "image 0 vs the local seed 42 0 " in lines[-1]


# --- the custom, dynamic, inpaint_model and nodes phases ------------------------------------

def test_the_merges_run_and_check_on_the_cpu(capsys, one_torch_thread):
    """The nodes phase's merges on two tiny-unet bundles at 32 px: at
    ratio 1.0 model1's weights exactly, at 0.5 an image apart from each
    parent's, for ModelMergeSimple and CLIPMergeSimple."""
    result = chip_smoke._merges_check(torch, _tiny_txt2img_workflow(), "cpu",
                                      torch.Generator().manual_seed(0))
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("[nodes] ") and "ratio 1.0 gives" in line]
    assert result["ratio_1_exact"] and len(lines) == 2
    for merge in ("ModelMergeSimple", "CLIPMergeSimple"):
        assert min(result[merge]["apart"].values()) >= chip_smoke.MERGE_MIN_DIFF


def _flux_custom():
    return _workflow(chip_smoke.CUSTOM_WORKFLOW)


@pytest.mark.parametrize("guider, batch", [("CFGGuider", 2), ("PerpNegGuider", 3),
                                           ("DualCFGGuider", 3)])
def test_custom_shapes_match_one_sd15_image_on_meta(guider, batch, recorded_calls):
    """The custom workflow on SD1.5: one evaluation is one UNet call at the
    guider's batch (PerpNeg's and DualCFG's three conditionings in one
    call), then the VAE decode; 20 evaluations an image."""
    workflow = chip_smoke._custom_workflow(_flux_custom(), guider)
    assert chip_smoke._node_ids(workflow, guider) and not chip_smoke._node_ids(workflow,
                                                                                "UNETLoader")
    with torch.device("meta"):
        unet, autoencoder = create_model("sd15"), create_model("vae-sd")
        unet(torch.empty(batch, 64, 64, 4), torch.empty(batch), torch.empty(batch, 77, 768))
        autoencoder.decode(torch.empty(1, 64, 64, 4))
    shapes = chip_smoke._custom_shapes(workflow)
    expected = collections.Counter()
    for _label, q, m, per_image in shapes:
        expected[(q, m)] += per_image // 20 if q[3] != 512 else per_image
    assert recorded_calls == expected
    assert {q[0] for _label, q, *_ in shapes if q[3] != 512} == {batch}
    assert chip_smoke._expected_by_instance(attn, shapes, torch) == {
        "wgmma": 640, "wgmma512": 1, "fma": 0}
    # split at 10: 10 + 10 evaluations and stage one's x0 prediction at
    # its last sigma (above 0), one more
    two = chip_smoke._custom_shapes(chip_smoke._custom_two_stage(workflow))
    assert two == [(label, q, m, count * 21 // 20 if q[3] != 512 else count)
                   for label, q, m, count in shapes]


def test_dynamic_shapes_match_one_frame_on_meta(recorded_calls):
    """A 192x384 frame at 2x is two 384-px tiles padded to 448: each an
    encode, 20 CFG-batched SDXL evaluations and a decode."""
    workflow = chip_smoke._dynamic_workflow(_workflow(chip_smoke.DYNAMIC_WORKFLOW))
    assert len(chip_smoke._node_ids(workflow, "ImageBatch")) == 7
    assert len(chip_smoke._node_ids(workflow, "LoadImage")) == 8
    with torch.device("meta"):
        unet, autoencoder = create_model("sdxl"), create_model("vae-sd")
        unet(torch.empty(2, 56, 56, 4), torch.empty(2), torch.empty(2, 77, 2048),
             y=torch.empty(2, 2816))
        autoencoder.encode(torch.empty(1, 448, 448, 3))
        autoencoder.decode(torch.empty(1, 56, 56, 4))
    shapes = chip_smoke._dynamic_shapes(workflow)
    expected = collections.Counter()
    for _label, q, m, per_frame in shapes:
        expected[(q, m)] += per_frame // 40 if q[3] != 512 else per_frame // 2
    assert recorded_calls == expected
    assert {(q[1], m) for _label, q, m, _ in shapes} >= {(784, 784), (784, 77), (196, 196),
                                                         (3136, 3136)}


def test_inpaint_model_shapes_match_one_outpainted_image_on_meta(recorded_calls):
    """576 px (512 + 64): 20 CFG-batched evaluations of the 9-channel UNet,
    two encodes (InpaintModelConditioning) and a decode."""
    workflow = chip_smoke._inpaint_model_workflow()
    assert chip_smoke._image_px(workflow) == (576, 576)
    with torch.device("meta"):
        unet, autoencoder = create_model("sd15-inpaint"), create_model("vae-sd")
        unet(torch.empty(2, 72, 72, 9), torch.empty(2), torch.empty(2, 77, 768))
        for _ in range(2):
            autoencoder.encode(torch.empty(1, 576, 576, 3))
        autoencoder.decode(torch.empty(1, 72, 72, 4))
    shapes = chip_smoke._txt2img_shapes(workflow)
    expected = collections.Counter()
    for _label, q, m, per_image in shapes:
        expected[(q, m)] += per_image // 20 if q[3] != 512 else per_image
    assert recorded_calls == expected


def test_custom_phase_runs_and_checks_on_the_cpu(capsys, one_torch_thread, counted_calls):
    """The custom phase on tiny-unet at 32 px and 4 steps (split at 2):
    each guider over HTTP against the local seeds, PerpNeg and DualCFG at
    batch 3, and the two stages against one."""
    flux = _flux_custom()
    flux[chip_smoke._node_id(flux, "BasicScheduler")]["inputs"]["steps"] = 4
    bundle = _tiny_bundle("tiny-unet")
    expected = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "CUSTOM_SPLIT", 2)
        for guider in [*chip_smoke.CUSTOM_GUIDERS, "two_stage"]:
            workflow = chip_smoke._custom_workflow(
                flux, "CFGGuider" if guider == "two_stage" else guider, "tiny-unet", 32)
            if guider == "two_stage":
                workflow = chip_smoke._custom_two_stage(workflow)
            per_image = sum(count for *_, count in chip_smoke._custom_shapes(workflow,
                                                                             image_px=32))
            expected[guider] = (per_image, {"fma": per_image, "wgmma": 0, "wgmma512": 0})
        result = chip_smoke._custom_phase(torch, bundle, flux, "cpu", expected, image_px=32)
    out = capsys.readouterr().out
    assert result["two_stage"]["max_abs_diff"] <= chip_smoke.RERUN_TOLERANCE
    assert "two stages vs one stage" in out
    for guider in chip_smoke.CUSTOM_GUIDERS:
        assert result[guider]["launches"] == 2 * expected[guider][0]
        assert f"[custom_{guider}] run 1" in out


def test_dynamic_phase_runs_and_checks_on_the_cpu(capsys, one_torch_thread, counted_calls):
    """The dynamic phase on tiny-unet: 8 frames of 24x32 upscaled 2x in
    64-px tiles, one step, master + w1 over HTTP."""
    video = _workflow(chip_smoke.DYNAMIC_WORKFLOW)
    video["1"]["inputs"]["ckpt_name"] = "tiny-unet"
    video["5"]["inputs"].update(steps=1, tile_width=64, tile_height=64, tile_padding=16)
    bundle = _tiny_bundle("tiny-unet")
    result = chip_smoke._dynamic_phase(torch, bundle, video, "cpu", frame_hw=(24, 32))
    out = capsys.readouterr().out
    assert result["w1_frames"] >= 1 and result["max_abs_diff"] <= chip_smoke.RERUN_TOLERANCE
    assert "frames by participant" in out and "collector jobs left 0, tile jobs left 0" in out


def test_inpaint_model_phase_runs_and_checks_on_the_cpu(capsys, one_torch_thread,
                                                        counted_calls):
    """The outpainting graph on tiny-unet-inpaint at 64 px (128 padded),
    3 steps: its concat channels, the original region changed less than
    the outpainted one, and the HTTP run against the local seeds."""
    workflow = chip_smoke._inpaint_model_workflow("tiny-unet-inpaint", steps=3)
    bundle = _tiny_bundle("tiny-unet-inpaint")
    per_image = sum(count for *_, count in chip_smoke._txt2img_shapes(workflow, image_px=64))
    result = chip_smoke._txt2img_phase(
        torch, bundle, workflow, "cpu", 2 * per_image,
        {"fma": 2 * per_image, "wgmma": 0, "wgmma512": 0}, runs=1, tag="inpaint_model",
        image_px=64)
    out = capsys.readouterr().out
    assert result["launches"] == 2 * per_image
    assert "concat channels (1, 64, 64, 5) on both sides" in out
    assert "outpainted ones (mask 1)" in out and "over the outpainted " in out


def test_nodes_phase_runs_and_checks_on_the_cpu(capsys):
    result = chip_smoke._nodes_phase(torch, "cpu")
    registry_new = {"ImageBatch", "ImageCrop", "ImagePadForOutpaint", "ImageScale",
                    "ImageScaleBy", "ImageInvert", "ImageBlur", "ImageSharpen", "LatentComposite",
                    "RepeatLatentBatch", "SetLatentNoiseMask", "LatentUpscale", "LatentUpscaleBy",
                    "LatentFromBatch", "LatentBatch", "SolidMask", "InvertMask", "CropMask",
                    "MaskToImage", "ImageToMask", "MaskComposite", "FeatherMask", "GrowMask",
                    "ThresholdMask", "ImageCompositeMasked", "LatentCompositeMasked",
                    "JoinImageWithAlpha", "SplitImageWithAlpha", "LatentFlip", "LatentRotate",
                    "LatentCrop", "LatentBlend", "ImageFlip", "ImageRotate", "ImageBlend",
                    "EmptyImage", "LoadImageMask", "LatentAdd", "LatentSubtract",
                    "LatentMultiply", "LatentInterpolate", "ImageQuantize",
                    "LatentBatchSeedBehavior"}
    assert registry_new <= set(result["classes"])
    assert result["max_abs_diff"] == 0.0 and result["tensors"] > 40
    assert "[nodes]" in capsys.readouterr().out


TINY_FLUX = {"flux-schnell": "tiny-flux", "flux-dev": "tiny-flux", "clip-l": "tiny-te",
             "t5-xxl": "tiny-t5-shared", "vae-flux": "tiny-vae-flux"}


def _tiny_flux_workflow(tag, px=32, steps=2):
    """A bundled Flux workflow on the tiny models at `px`, 2 steps."""
    workflow = _workflow(chip_smoke.FLUX_WORKFLOWS[tag])
    for node in workflow.values():
        inputs = node["inputs"]
        for key in ("ckpt_name", "unet_name", "clip_name1", "clip_name2", "vae_name"):
            if key in inputs:
                inputs[key] = TINY_FLUX[inputs[key]]
        for key in ("width", "height"):
            if key in inputs:
                inputs[key] = px
        if "steps" in inputs:
            inputs["steps"] = steps
    return workflow


@pytest.mark.parametrize("tag, tokens, calls", [
    ("flux_schnell", 4608, 57 * 4), ("flux_dev", 4608, 57 * 20), ("flux_dual", 4608, 57 * 20),
    ("kontext", 8704, 57 * 20),
])
def test_flux_shapes_of_the_bundled_workflows(tag, tokens, calls):
    """At 1024 px: 512 T5 tokens and 64^2 image tokens (Kontext: another
    64^2 of its reference), 19 + 38 joint calls an evaluation at batch 1,
    then the VAE's decode (and Kontext's encode) at 128^2 latents."""
    shapes = chip_smoke._flux_shapes(_workflow(chip_smoke.FLUX_WORKFLOWS[tag]))
    vae_calls = 2 if tag == "kontext" else 1
    assert shapes == [(f"joint@{tokens}", (1, tokens, 24, 128), tokens, calls),
                      ("vae@16384", (1, 16384, 1, 512), 16384, vae_calls)]
    assert chip_smoke._expected_by_instance(attn, shapes, torch) == {
        "wgmma": calls, "wgmma512": vae_calls, "fma": 0}


def test_flux_shapes_match_one_evaluation_on_meta(recorded_calls):
    """flux-dev's forward on meta at 1024 px, with and without Kontext's
    reference: every joint call `_flux_shapes` counts, nothing else."""
    with torch.device("meta"):
        model = create_model("flux-dev")
        x, t, ctx, y = (torch.empty(1, 128, 128, 16), torch.empty(1), torch.empty(1, 512, 4096),
                        torch.empty(1, 768))
        model(x, t, ctx, y=y)
        model(x, t, ctx, y=y, ref_latents=[torch.empty(1, 128, 128, 16)])
    assert recorded_calls == {((1, 4608, 24, 128), 4608): 57, ((1, 8704, 24, 128), 8704): 57}


def test_flux_pipelines_resolve_every_loader():
    bundle = object()
    dual = chip_smoke._flux_pipelines(_workflow("distributed-flux-dual-prompt.json"), bundle)
    assert dual == {"flux-dev": bundle, "unet:flux-dev": bundle,
                    "clip:flux:clip-l,t5-xxl": bundle}
    assert chip_smoke._flux_model(_workflow("distributed-txt2img-flux.json")) == "flux-schnell"


def test_flux_phase_runs_and_checks_on_the_cpu(capsys, one_torch_thread, counted_calls):
    """The phase as the card runs it, on the tiny Flux models at 32 px and
    2 steps: each workflow's local references and one HTTP run with the
    attention calls `_flux_shapes` counts, Kontext without its reference,
    and the dual-prompt image against the custom-sampling one."""
    workflows = {tag: _tiny_flux_workflow(tag) for tag in chip_smoke.FLUX_WORKFLOWS}
    expected = {}
    for tag, workflow in workflows.items():
        per_image = sum(count for *_, count in chip_smoke._flux_shapes(workflow, image_px=32))
        expected[tag] = (per_image, {"fma": per_image, "wgmma": 0, "wgmma512": 0})
    results = chip_smoke._flux_phase(torch, workflows, "cpu", expected=expected, image_px=32)
    out = capsys.readouterr().out.splitlines()
    for tag in workflows:
        assert results[tag]["launches"] == 2 * expected[tag][0]
        lines = [line for line in out if line.startswith(f"[{tag}] run 1")]
        assert "collector jobs left 0" in lines[0] and "image 0 vs the local seed" in lines[1]
    assert any("with vs without ReferenceLatent" in line for line in out)
    assert any(line.startswith("[flux] dual-prompt vs custom-sampling") for line in out)



def test_d128_checks_reach_both_plans_at_their_edges():
    """The kernel phase's D=128 checks beyond the Flux workflows' shapes:
    the split-P plan at the short key count and the threshold, the
    one-bf16-P plan one key past it, at the ragged 1008-px length and at
    the edges of its 128-row blocks and first key tile past the
    threshold."""
    threshold = attn.WGMMA_PINGPONG_ABOVE[128]
    assert chip_smoke._bf16_p_edge_keys(attn) == (
        threshold, threshold + 1, 1055, 1056, 1057, 1151, 1152, 1153)
    checks = chip_smoke._flux_extra_checks(attn)
    plans = {}
    for label, (b, n, h, d), m, dtype, units, layout in checks:
        assert (d, dtype, units) == (128, "bfloat16", None)
        q = torch.empty((b, n, h, d), dtype=torch.bfloat16, device="meta")
        kv = torch.empty((b, m, h, d), dtype=torch.bfloat16, device="meta")
        plans[label] = attn.plan(q, kv, kv)
    split_p, k144, k176 = attn.wgmma_plans(128)
    assert plans["joint@4608 x 63 keys"] == plans[f"joint@4608 x {threshold} keys"] == split_p
    assert plans[f"joint@4608 x {threshold + 1} keys"] == k176
    assert plans[f"joint@{chip_smoke.FLUX_RAGGED_TOKENS} (1008 px)"] == k176
    edges = {(n, m): plans[f"edge D128 {n}x{m} B*H=1"]
             for n in chip_smoke.EDGE_ROWS_BF16_P for m in chip_smoke._bf16_p_edge_keys(attn)}
    assert len(edges) == 64
    assert all(p == split_p for (_, m), p in edges.items() if m == threshold)
    # past the threshold both key tiles take some of the edges
    assert {p for (_, m), p in edges.items() if m > threshold} == {k144, k176}


# --- the sd3 phase ------------------------------------------------------------------

def test_sd3_shapes_of_the_bundled_workflows():
    """At 1024 px, 28 euler steps, CFG-batched: SD3.5-large's 38 joint
    calls over 154 text and 64^2 image tokens an evaluation (1064 an
    image); SD3.5-medium's 24 joint and 13 attn2 calls (37 x 28), and in
    the 5 steps of its SLG window the batch-1 skip pass without blocks 7,
    8 and 9 (21 joint and 10 attn2 calls); the VAE's decode. With
    DualCLIPLoader sd3 the text is CLIP's 77 tokens alone."""
    large = chip_smoke._sd3_shapes(_workflow(chip_smoke.SD3_WORKFLOWS["sd35"]))
    assert large == [("joint@4250", (2, 4250, 38, 64), 4250, 38 * 28),
                     ("vae@16384", (1, 16384, 1, 512), 16384, 1)]
    slg = _workflow(chip_smoke.SD3_WORKFLOWS["sd35m_slg"])
    assert chip_smoke._sd3_slg_window(slg) == ((7, 8, 9), [1, 2, 3, 4, 5])
    medium = chip_smoke._sd3_shapes(slg)
    assert medium == [("joint@4250", (2, 4250, 24, 64), 4250, 24 * 28),
                      ("x-only@4096", (2, 4096, 24, 64), 4096, 13 * 28),
                      ("skip joint@4250", (1, 4250, 24, 64), 4250, 21 * 5),
                      ("skip x-only@4096", (1, 4096, 24, 64), 4096, 10 * 5),
                      ("vae@16384", (1, 16384, 1, 512), 16384, 1)]
    assert sum(c for *_, c in medium[:-1]) == 37 * 28 + 31 * 5
    assert chip_smoke._expected_by_instance(attn, medium, torch) == {
        "wgmma": 37 * 28 + 31 * 5, "wgmma512": 1, "fma": 0}
    dual = chip_smoke._sd3_shapes(chip_smoke._sd3_dualclip_workflow(slg))
    assert [label for label, *_ in dual] == ["joint@4173", "x-only@4096", "skip joint@4173",
                                            "skip x-only@4096", "vae@16384"]
    muted = chip_smoke._sd3_muted(slg)
    assert chip_smoke._sd3_slg_window(muted) == ((), [])
    (extra,) = chip_smoke._sd3_extra_checks()
    assert extra[1:4] == ((1, 63 * 63 + 154, 24, 64), 63 * 63 + 154, "bfloat16")


def test_sd3_shapes_match_one_evaluation_on_meta(recorded_calls):
    """SD3.5-large's and SD3.5-medium's forwards on meta at 1024 px (batch
    2 over 154 text tokens), and SD3.5-medium's skip pass (batch 1, blocks
    7-9 skipped): every attention call `_sd3_shapes` counts a step,
    nothing else."""
    with torch.device("meta"):
        x, t, ctx, y = (torch.empty(2, 128, 128, 16), torch.empty(2), torch.empty(2, 154, 4096),
                        torch.empty(2, 2048))
        create_model("sd35-large")(x, t, ctx, y=y)
        medium = create_model("sd35-medium")
        medium(x, t, ctx, y=y)
        medium(x[:1], t[:1], ctx[:1], y=y[:1], skip_layers=(7, 8, 9))
    assert recorded_calls == {((2, 4250, 38, 64), 4250): 38, ((2, 4250, 24, 64), 4250): 24,
                              ((2, 4096, 24, 64), 4096): 13, ((1, 4250, 24, 64), 4250): 21,
                              ((1, 4096, 24, 64), 4096): 10}


TINY_SD3 = {"sd35-large": "tiny-sd3", "sd35-medium": "tiny-sd35m"}


def _tiny_sd3_workflow(tag, px=32):
    """A bundled SD3.5 workflow on its tiny model at `px`: 2 steps, or 8
    under SLG (one step of the tiny models' unshifted schedule in its
    window), SLG on block 0 of the tiny model's 2."""
    workflow = _workflow(chip_smoke.SD3_WORKFLOWS[tag])
    for node in workflow.values():
        inputs = node["inputs"]
        if "ckpt_name" in inputs:
            inputs["ckpt_name"] = TINY_SD3[inputs["ckpt_name"]]
        for key in ("width", "height"):
            if key in inputs:
                inputs[key] = px
        if node["class_type"] == "SkipLayerGuidanceSD3":
            inputs["layers"] = "0"
    slg = chip_smoke._node_ids(workflow, "SkipLayerGuidanceSD3")
    workflow[chip_smoke._node_id(workflow, "KSampler")]["inputs"]["steps"] = 8 if slg else 2
    return workflow


def test_sd3_phase_runs_and_checks_on_the_cpu(capsys, one_torch_thread, counted_calls):
    """The phase as the card runs it, on the tiny SD3 models at 32 px: each
    workflow's local references and one HTTP run with the attention calls
    `_sd3_shapes` counts; the SLG workflow's skip passes against its host
    window, against itself muted, and through DualCLIPLoader sd3."""
    workflows = {tag: _tiny_sd3_workflow(tag) for tag in chip_smoke.SD3_WORKFLOWS}
    expected = {}
    for tag, workflow in list(workflows.items()):
        variants = {tag: workflow}
        if chip_smoke._node_ids(workflow, "SkipLayerGuidanceSD3"):
            variants[f"{tag}_dualclip"] = chip_smoke._sd3_dualclip_workflow(workflow)
        for name, wf in variants.items():
            per_image = sum(count for *_, count in chip_smoke._sd3_shapes(wf, image_px=32))
            expected[name] = (per_image, {"fma": per_image, "wgmma": 0, "wgmma512": 0})
    assert chip_smoke._sd3_slg_window(workflows["sd35m_slg"]) == ((0,), [1])
    results = chip_smoke._sd3_phase(torch, workflows, "cpu", expected=expected, image_px=32)
    out = capsys.readouterr().out.splitlines()
    for tag in workflows:
        assert results[tag]["launches"] == 2 * expected[tag][0]
        lines = [line for line in out if line.startswith(f"[{tag}] run 1")]
        assert "collector jobs left 0" in lines[0] and "image 0 vs the local seed" in lines[1]
    assert results["sd35m_slg_dualclip"]["launches"] == expected["sd35m_slg_dualclip"][0]
    assert "[sd35m_slg] skip passes 4 over 4 images (expected 4 x 1)" in out
    assert any("with vs without skip-layer guidance" in line for line in out)
    assert any("CLIP tokens equal to the triple's: True" in line for line in out)



# --- the wan phase ------------------------------------------------------------------

def test_wan_shapes_of_the_bundled_workflows():
    """wan-1.3b at 480x480x33 (9 x 30 x 30 = 8100 tokens, 12 heads, 30
    blocks, 30 steps) and wan-14b at 720x480x81 (21 x 30 x 45 = 28350, 40
    heads, 40 blocks, 30 steps), CFG-batched at D=128 over CLIP-L's 77
    tokens; the i2v workflow's 20 steps add the image cross-attention over
    257 CLIP tokens and CLIP vision's 31 D=80 blocks. A run is two videos:
    3600, 4800 and 4862 launches, every one on the wgmma instance."""
    wan = chip_smoke._wan_shapes(_workflow(chip_smoke.WAN_WORKFLOWS["wan"]))
    assert wan == [("wan_self@8100", (2, 8100, 12, 128), 8100, 30 * 30),
                   ("wan_text@77", (2, 8100, 12, 128), 77, 30 * 30)]
    t2v = chip_smoke._wan_shapes(_workflow(chip_smoke.WAN_WORKFLOWS["wan_14b"]))
    assert t2v == [("wan_self@28350", (2, 28350, 40, 128), 28350, 40 * 30),
                   ("wan_text@77", (2, 28350, 40, 128), 77, 40 * 30)]
    i2v = chip_smoke._wan_shapes(_workflow(chip_smoke.WAN_WORKFLOWS["wan_i2v"]))
    assert i2v == [("wan_self@28350", (2, 28350, 40, 128), 28350, 40 * 20),
                   ("wan_text@77", (2, 28350, 40, 128), 77, 40 * 20),
                   ("wan_img@257", (2, 28350, 40, 128), 257, 40 * 20),
                   ("clipvis@257", (1, 257, 16, 80), 257, 31)]
    for shapes, per_run in ((wan, 3600), (t2v, 4800), (i2v, 4862)):
        per_video = sum(count for *_, count in shapes)
        assert 2 * per_video == per_run
        assert chip_smoke._expected_by_instance(attn, shapes, torch) == {
            "wgmma": per_video, "wgmma512": 0, "fma": 0}
    video = chip_smoke._wan_video(_workflow(chip_smoke.WAN_WORKFLOWS["wan_i2v"]))
    assert (video["frames"], video["steps"], video["seed"], video["i2v"]) == (81, 20, 42, True)


def test_wan_shapes_match_one_evaluation_on_meta(monkeypatch):
    """wan-14b-i2v's CFG-batched forward and CLIP vision on meta at the
    i2v workflow's size: every attention call `_wan_shapes` counts a
    step, nothing else."""
    from comfyui_distributed_tpu_torch.models import clip_vision, dit

    calls = collections.Counter()

    def record(q, k, v):
        calls[(tuple(q.shape), k.shape[1])] += 1
        return torch.empty_like(q)

    monkeypatch.setattr(dit, "dot_product_attention", record)
    monkeypatch.setattr(clip_vision, "dot_product_attention", record)
    with torch.device("meta"):
        create_model("wan-14b-i2v")(torch.empty(2, 21, 60, 90, 36), torch.empty(2),
                                    torch.empty(2, 77, 4096), torch.empty(2, 257, 1280))
        create_model("clip-vision-h")(torch.empty(1, 224, 224, 3))
    want = {(q, m): count // 20 for _, q, m, count in
            chip_smoke._wan_shapes(_workflow(chip_smoke.WAN_WORKFLOWS["wan_i2v"]))[:3]}
    want[((1, 257, 16, 80), 257)] = 31
    assert calls == want


def test_phase_selection_and_the_depth_cuts():
    assert chip_smoke._parse_phases([]) == set(chip_smoke.PHASES)
    assert chip_smoke._parse_phases(["--phases", "wan"]) == {"wan"}
    assert chip_smoke._parse_phases(["--phases", "elastic,wan"]) == {"main", "elastic", "wan"}
    with pytest.raises(SystemExit):
        chip_smoke._parse_phases(["--phases", "nope"])
    assert chip_smoke._parse_phases(["--phases", "adapters"]) == {"adapters"}
    # the main path keeps its published depths; only phases that repeat it are cut
    assert set(chip_smoke.CUT_PHASES) < set(chip_smoke.PHASES)
    assert not {"main", "elastic", "txt2img", "procs", "wan"} & set(chip_smoke.CUT_PHASES)
    cuts = chip_smoke._depth_cuts()
    assert set(chip_smoke.UNET_CUTS) <= set(cuts)
    for name, cfg in cuts.items():
        full = get_config(name)
        if name.startswith("flux"):
            assert (cfg.double_depth, cfg.single_depth) == chip_smoke.FLUX_DEPTH_CUT
            assert cfg.hidden_dim == full.hidden_dim and cfg.heads == full.heads
        elif name in chip_smoke.WAN_DEPTH_CUT:
            assert cfg.depth == chip_smoke.WAN_DEPTH_CUT[name] < full.depth
            assert (cfg.hidden_dim, cfg.heads, cfg.ffn_dim, cfg.i2v) == (
                full.hidden_dim, full.heads, full.ffn_dim, full.i2v)
        elif name in chip_smoke.UNET_CUTS:
            cut = (tuple(cfg.transformer_depth), cfg.num_res_blocks)
            assert cut == ((chip_smoke.SDXL_DEPTH_CUT if name == "sdxl"
                            else tuple(full.transformer_depth)), chip_smoke.UNET_RES_BLOCKS_CUT)
            assert (cfg.model_channels, cfg.channel_mult, cfg.head_dim, cfg.num_heads) == (
                full.model_channels, full.channel_mult, full.head_dim, full.num_heads)
        else:
            assert (cfg.depth, cfg.dual_attn_blocks) == chip_smoke.SD3_DEPTH_CUT[name]
            assert (cfg.width, cfg.n_heads, cfg.head_dim) == (full.width, full.n_heads,
                                                             full.head_dim)
    slg = _workflow(chip_smoke.SD3_WORKFLOWS["sd35m_slg"])
    with chip_smoke._installed(cuts):
        assert get_config("flux-dev").double_depth == chip_smoke.FLUX_DEPTH_CUT[0]
        layers_, _ = chip_smoke._sd3_slg_window(slg)
        assert max(layers_) < get_config("sd35-medium").depth  # SLG's blocks survive the cut
    assert get_config("flux-dev").double_depth == 19
    assert get_config("wan-14b").depth == 40 and "wan-1.3b" not in cuts


def _tiny_wan_workflow(tag, px=32, frames=5, steps=2):
    """A bundled WAN workflow on tiny-dit / tiny-dit-i2v at `px`."""
    workflow = _workflow(chip_smoke.WAN_WORKFLOWS[tag])
    for node in workflow.values():
        inputs = node["inputs"]
        if node["class_type"] == "VideoCheckpointLoader":
            inputs["ckpt_name"] = "tiny-dit-i2v" if tag == "wan_i2v" else "tiny-dit"
        if node["class_type"] == "EmptyVideoLatent":
            inputs.update(width=px, height=px)
        if "frames" in inputs:
            inputs["frames"] = frames
        if "steps" in inputs:
            inputs["steps"] = steps
    return workflow


def test_wan_phase_runs_and_checks_on_the_cpu(capsys, one_torch_thread, counted_calls,
                                              monkeypatch):
    """The phase as the card runs it, on the tiny video stacks at 32 px, 5
    frames and 2 steps: tiny-dit's file load, local runs and HTTP run
    and chunked decode (the distributed-wan checks), the same workflows'
    first-evaluation checks (the 14B ones) and the i2v one's image branch;
    the launches `_wan_shapes` counts. The tiny stacks take the causal
    tiny-video-vae-3d here, as the WAN ones take wan-vae."""
    from comfyui_distributed_tpu_torch.models import clip_vision, dit
    from comfyui_distributed_tpu_torch.models import video_pipeline as tvp

    # the tiny stacks on the causal tiny-video-vae-3d, as the WAN ones on wan-vae
    parts = tvp.default_parts
    monkeypatch.setattr(tvp, "default_parts", lambda name: (
        "tiny-video-vae-3d", *parts(name)[1:]) if name.startswith("tiny") else parts(name))
    for module in (dit, clip_vision):
        real = module.dot_product_attention

        def counting(q, k, v, real=real):
            attn.count_launch("fma")
            return real(q, k, v)

        monkeypatch.setattr(module, "dot_product_attention", counting)
    workflows = {tag: _tiny_wan_workflow(tag) for tag in chip_smoke.WAN_WORKFLOWS}
    expected = {}
    for tag, workflow in workflows.items():
        per_video = sum(count for *_, count in chip_smoke._wan_shapes(workflow, (32, 32)))
        expected[tag] = (per_video, {"fma": per_video, "wgmma": 0, "wgmma512": 0})
    assert expected["wan_i2v"][0] == 2 * 2 * 3 + 2
    results = chip_smoke._wan_phase(torch, workflows, "cpu", expected=expected,
                                    frame_hw=(32, 32), gen=torch.Generator().manual_seed(0),
                                    local_tags=("wan",))
    out = capsys.readouterr().out
    for tag in workflows:
        assert results[tag]["launches"] == 2 * expected[tag][0]
    assert "parameters equal to the written ones: " in out
    assert "the chunked VAE decode of a seeded (1, 3, 16, 16, 16) latent" in out
    assert "the master's frames vs the local seed 0" in out
    assert out.count("first evaluations: the noise equals the draw at seeds") == 2
    assert "CLIP-vision tokens zeroed moves the velocity" in out
    assert "collector jobs left 0" in out


# --- push grants, the quarantine run, audio and WEBP ---------------------------


def test_the_push_checks_of_the_elastic_phase_on_the_cpu(capsys, one_torch_thread):
    """Each elastic run's [push] line: cdt_push_grants_total rose by the
    4 tiles the job made pending, w1's grant signal connected and got the
    stream's hello, parked at most once until the timeout, and the bus
    let go of its stream."""
    result = _elastic_on_tiny()
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("[push] elastic run")]
    assert len(lines) == 1
    assert "cdt_push_grants_total +4 (the 4 tiles made pending + 0 requeued)" in lines[0]
    assert "connections 1" in lines[0] and "subscribers 0 after the run, 0 before" in lines[0]
    push = result["push"]
    assert push["pushed"] == 4 and push["parks"] and push["frames"]["hello"] == 1
    assert [how for _, how in push["parks"]].count("timeout") <= 1


def test_the_push_checks_fail_when_the_event_stream_is_down(monkeypatch, one_torch_thread):
    """A worker whose grant signal never connects runs the pure pull loop
    and the output is right: the [push] check must still fail the run."""
    from comfyui_distributed_tpu_torch.graph import usdu_elastic

    monkeypatch.setattr(usdu_elastic.GrantSignal, "start", lambda self: None)
    with pytest.raises(RuntimeError, match="grant signal never connected"):
        _elastic_on_tiny()


def test_the_push_checks_fail_when_grants_are_not_announced(monkeypatch, one_torch_thread):
    from comfyui_distributed_tpu_torch.scheduler import placement

    monkeypatch.setattr(placement.PlacementPolicy, "notify_grants",
                        lambda self, job_id, count: None)
    with pytest.raises(RuntimeError, match="cdt_push_grants_total rose by 0"):
        _elastic_on_tiny()


def _quarantine_on_tiny(monkeypatch=None):
    """The procs phase's quarantine run, with w1 in this process."""
    import time

    workflow = _tiny_workflow()
    bundle = tpl.load_pipeline("tiny-unet", seed=0, device="cpu")
    image = torch.zeros((1, 64, 64, 3))

    def after(servers):
        master, base, port = servers["master"], servers["base"], servers["worker_port"]
        w1_base = f"http://127.0.0.1:{port}"

        def run():
            started = time.perf_counter()
            queued, _, _ = chip_smoke._queue(base, port, workflow)
            out = master.get_job(queued["prompt_id"]).outputs["6"][0]["images"]
            return queued, out, time.perf_counter() - started

        return chip_smoke._quarantine_run(master, base, w1_base, run, servers["reference"],
                                          chip_smoke._Push("[push] elastic", base, w1_base))

    return chip_smoke._elastic_phase(torch, bundle, "tiny-unet", workflow, image, None, "cpu",
                                     runs=0, after=after)["after"]


def test_the_quarantine_run_on_the_cpu(capsys, one_torch_thread):
    """w1 quarantined as soon as it holds a grant: its tiles requeued at
    once with reason quarantine and announced, every tile completed once,
    w1's copies dropped as duplicates, the output right, w1 pardoned."""
    from comfyui_distributed_tpu_torch.resilience.health import get_health_registry

    result = _quarantine_on_tiny()
    out = capsys.readouterr().out.splitlines()
    line = [line for line in out if line.startswith("[quarantine]")]
    assert len(line) == 1 and "state quarantined" in line[0] and "now healthy" in line[0]
    assert result["requeued"] == len(result["in_flight"]) == result["duplicates"] >= 1
    assert result["push"]["pushed"] == 4 + result["requeued"]
    assert result["push"]["frames"].get("grant_available", 0) >= 1
    assert get_health_registry().state("w1").value == "healthy"


def test_the_quarantine_run_fails_without_the_requeue_binding(monkeypatch, one_torch_thread):
    """A breaker that is not bound to the store leaves w1's tiles to the
    heartbeat timeout: the run must fail, and w1 is still pardoned."""
    from comfyui_distributed_tpu_torch import resilience
    from comfyui_distributed_tpu_torch.resilience.health import get_health_registry

    monkeypatch.setattr(resilience, "bind_quarantine_requeue", lambda registry, store: (
        lambda: None))
    with pytest.raises(RuntimeError, match="tiles requeued for the quarantine"):
        _quarantine_on_tiny()
    assert get_health_registry().state("w1").value == "healthy"


def test_the_audio_graph_runs_and_checks_on_the_cpu(tmp_path, capsys, one_torch_thread):
    in_dir, out_dir = str(tmp_path / "in"), str(tmp_path / "out")
    os.makedirs(in_dir)
    with chip_smoke._serving(str(tmp_path), {"input_dir": in_dir, "output_dir": out_dir},
                             "cpu") as (master, _worker, base, worker_port):
        result = chip_smoke._audio_check(master, base, worker_port, in_dir, out_dir, "cpu")
    line = [line for line in capsys.readouterr().out.splitlines() if line.startswith("[audio]")]
    assert len(line) == 1 and "equal to the master's then w1's: True" in line[0]
    assert result["samples"] == 2 * chip_smoke.AUDIO_SECONDS * chip_smoke.AUDIO_RATE
    assert result["envelope_bytes"] == 4 * (chip_smoke.AUDIO_SECONDS * chip_smoke.AUDIO_RATE
                                            * chip_smoke.AUDIO_CHANNELS * 4) // 3
    assert sorted(os.listdir(out_dir)) == ["combined.npz"] + [
        f"part{i}.npz" for i in range(chip_smoke.AUDIO_PARTS)]


def test_the_audio_check_fails_when_the_workers_audio_is_lost(tmp_path, monkeypatch,
                                                              one_torch_thread):
    from comfyui_distributed_tpu_torch.graph.nodes_distributed import DistributedCollector

    envelopes = DistributedCollector.envelopes
    monkeypatch.setattr(DistributedCollector, "envelopes", staticmethod(
        lambda images, worker_id, job_id, audio=None: envelopes(images, worker_id, job_id)))
    in_dir, out_dir = str(tmp_path / "in"), str(tmp_path / "out")
    os.makedirs(in_dir)
    with chip_smoke._serving(str(tmp_path), {"input_dir": in_dir, "output_dir": out_dir},
                             "cpu") as (master, _worker, base, worker_port):
        with pytest.raises(RuntimeError, match="not the master's then w1's"):
            chip_smoke._audio_check(master, base, worker_port, in_dir, out_dir, "cpu")


def test_the_webp_check_on_a_small_batch(tmp_path, capsys):
    frames = torch.rand((5, 24, 40, 3), generator=torch.Generator().manual_seed(0))
    result = chip_smoke._webp_check(frames, 16, str(tmp_path))
    line = capsys.readouterr().out.splitlines()
    assert len(line) == 1 and line[0].startswith("[webp] SaveAnimatedWEBP of 5 frames of 40x24")
    assert "durations [62] ms" in line[0] and "canvas (40, 24), loop 0" in line[0]
    assert result["frames"] == 5 and result["bytes"] == os.path.getsize(
        tmp_path / "chip_smoke_00000.webp")


def test_the_webp_check_fails_on_a_wrong_container(tmp_path, monkeypatch):
    from comfyui_distributed_tpu_torch.utils import webp

    encode = webp.encode_animated_webp
    monkeypatch.setattr(webp, "encode_animated_webp",
                        lambda frames, duration_ms, loop=0: encode(frames[1:], duration_ms, loop))
    with pytest.raises(RuntimeError, match="4 ANMF frames, not 5"):
        chip_smoke._webp_check(torch.rand((5, 8, 8, 3)), 16, str(tmp_path))
