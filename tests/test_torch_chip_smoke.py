"""chip_smoke.py's bookkeeping, checked on the CPU.

On the card the smoke run asserts that each run of the workflow launches
the attention kernel exactly as often as `_attention_shapes` says. Here
full-width SDXL runs on the `meta` device (shapes only, no memory) with
a router that records every attention call, so that count is held to
what the models really do.
"""

import collections

import pytest
import torch

import chip_smoke
from comfyui_distributed_tpu_torch.models import layers, vae
from comfyui_distributed_tpu_torch.models.registry import create_model, get_config
from comfyui_distributed_tpu_torch.ops import attention as attn
from comfyui_distributed_tpu_torch.ops.samplers import get_sigmas


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


def test_bounds_follow_the_published_peaks():
    ops_ms, bytes_ms = chip_smoke._bounds((2, 1296, 10, 64), 1296, "bfloat16")
    assert ops_ms == pytest.approx(4 * 2 * 10 * 1296 * 1296 * 64 / 989e12 * 1e3)
    assert bytes_ms == pytest.approx(4 * 2 * 1296 * 10 * 64 * 2 / 3.35e12 * 1e3)
    assert ops_ms > bytes_ms  # self-attention at 1296 tokens: operations bound


def test_smoke_run_refuses_without_cuda(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""
