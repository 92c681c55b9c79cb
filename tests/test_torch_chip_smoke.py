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
from comfyui_distributed_tpu_torch.models import layers, vae
from comfyui_distributed_tpu_torch.models.registry import create_model, get_config
from comfyui_distributed_tpu_torch.ops import attention as attn
from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
from comfyui_distributed_tpu_torch.models import pipeline as tpl
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
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("[elastic]")]
    assert result["launches"] == 0
    assert len(lines) == 1 + 3 * chip_smoke.ELASTIC_RUNS
    assert "max |diff| 0" in lines[0]  # the reference tiles are phase 4's
    assert all("tiles completed: master" in line for line in lines[1::3])
    assert all("stage seconds: master" in line for line in lines[2::3])


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
