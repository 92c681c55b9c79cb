"""Clip-skip in the port against the JAX package, on the CPU in f32.

- The text encoder at skip None (the tower's default), 0, 1, 2 and
  deeper than the tower, for the three kinds of tower: the full stack
  with the final LayerNorm (SD1's CLIP-L), the penultimate block
  without it (SDXL's), and the penultimate block through it (SD2's
  OpenCLIP-H, `final_ln_on_hidden`). Same numpy-seeded weights in both
  packages (`from_jax_params`).
- CLIPSetLastLayer and the conditioning it leads to, against the JAX
  node on the same bundle weights; the node returns a new bundle and
  leaves the shared one alone; the executor's cache misses when
  `stop_at_clip_layer` changes.

Tolerances: f32 on both sides, three pre-LN blocks: the measured
difference on a CPU is 2.1e-6 for values up to 2.7; 2e-5 leaves a margin
of about ten.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.graph.nodes_core import CLIPSetLastLayer as JCLIPSetLastLayer
from comfyui_distributed_tpu.models import pipeline as jpl
from comfyui_distributed_tpu.models import text_encoder as jte
from comfyui_distributed_tpu.models.io import flatten_params
from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
from comfyui_distributed_tpu_torch.graph.nodes_core import CLIPSetLastLayer
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.models import text_encoder as tte
from comfyui_distributed_tpu_torch.models.io import from_jax_params
from test_torch_parity import (  # noqa: F401  (one_torch_thread: fixture)
    jax_and_port_bundles,
    one_torch_thread,
    seeded_flax_params,
)

# one intra-op thread: the tiny models gain nothing from more, and the
# xdist run's processes would oversubscribe the cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOWERS = {
    "full-stack": dict(),
    "penultimate": dict(penultimate_hidden=True),
    "penultimate-ln": dict(penultimate_hidden=True, final_ln_on_hidden=True, activation="gelu",
                           proj_dim=24, pad_token_id=0),
}
TOKENS = np.array([[49406, 320, 1125, 539, 49407, 0, 0, 0],
                   [49406, 7, 9, 49407, 49407, 49407, 49407, 49407]], np.int32)


@pytest.fixture(scope="module", params=sorted(TOWERS))
def tower(request):
    kw = dict(width=32, layers=3, heads=2, max_length=8, dtype="float32", **TOWERS[request.param])
    jm = jte.TextEncoder(jte.TextEncoderConfig(**kw))
    params = seeded_flax_params(jm, 4, jnp.asarray(TOKENS))
    tm = tte.TextEncoder(tte.TextEncoderConfig(**kw))
    tm.load_state_dict(from_jax_params(flatten_params(params), tm))
    return jm, params, tm.eval().requires_grad_(False)


@pytest.mark.parametrize("skip", [None, 0, 1, 2, 3, 5])
def test_text_encoder_skip_matches_jax(tower, skip):
    jm, params, tm = tower
    ref_h, ref_p = (np.asarray(a) for a in jm.apply(params, jnp.asarray(TOKENS), eos_id=49407,
                                                      skip_last=skip))
    with torch.no_grad():
        h, p = tm(torch.from_numpy(TOKENS).long(), eos_id=49407, skip_last=skip)
    np.testing.assert_allclose(h.numpy(), ref_h, atol=2e-5, rtol=0)
    np.testing.assert_allclose(p.numpy(), ref_p, atol=2e-5, rtol=0)


def test_skips_differ_where_the_semantics_say(tower):
    """The pooled vector keeps the full stack at every skip; a skip past
    the tower is the last layer after the final LayerNorm."""
    _, _, tm = tower
    tokens = torch.from_numpy(TOKENS).long()
    with torch.no_grad():
        out = {s: tm(tokens, eos_id=49407, skip_last=s) for s in (None, 0, 1, 2, 3)}
    assert all(torch.equal(out[s][1], out[0][1]) for s in out)
    assert not torch.equal(out[1][0], out[2][0])
    cfg = tm.config
    if cfg.penultimate_hidden and not cfg.final_ln_on_hidden:
        # SDXL's towers: skip 0 is the last block before the final LN,
        # too deep is after it
        assert not torch.equal(out[0][0], out[3][0])
    else:
        assert torch.equal(out[0][0], out[3][0])


@pytest.fixture(scope="module")
def pair():
    return jax_and_port_bundles("tiny-unet")


@pytest.mark.parametrize("stop", [-1, -2, -3])
def test_clip_set_last_layer_conditioning_matches_jax(pair, stop):
    jb, tb = pair
    (jskip,) = JCLIPSetLastLayer().set_last_layer(jb, stop)
    (tskip,) = CLIPSetLastLayer().set_last_layer(tb, stop)
    assert tskip.clip_skip == jskip.clip_skip == -stop - 1
    ref = jpl.encode_text_pooled(jskip, ["a harbor at sunset"])
    got = tpl.encode_text_pooled(tskip, ["a harbor at sunset"])
    np.testing.assert_allclose(got.context.numpy(), np.asarray(ref.context), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.pooled.numpy(), np.asarray(ref.pooled), atol=2e-5, rtol=0)


def test_the_node_returns_a_new_bundle_and_rejects_counts_from_the_start(pair):
    _, tb = pair
    base = tpl.encode_text(tb, ["a prompt"])
    (skipped,) = CLIPSetLastLayer().set_last_layer(tb, -2)
    assert skipped is not tb and tb.clip_skip is None
    assert skipped.unet is tb.unet and skipped.text_encoder is tb.text_encoder
    assert not torch.equal(tpl.encode_text(skipped, ["a prompt"]), base)
    assert torch.equal(tpl.encode_text(tb, ["a prompt"]), base)
    (full,) = CLIPSetLastLayer().set_last_layer(tb, -1)
    assert torch.equal(tpl.encode_text(full, ["a prompt"]), base)  # tiny-te is full-stack
    for stop in (0, 1):
        with pytest.raises(ValueError, match="must be negative"):
            CLIPSetLastLayer().set_last_layer(tb, stop)


def test_a_changed_stop_at_clip_layer_misses_the_node_cache(pair):
    _, tb = pair
    prompt = {
        "1": {"class_type": "CheckpointLoaderSimple", "inputs": {"ckpt_name": "tiny-unet"}},
        "2": {"class_type": "CLIPSetLastLayer",
              "inputs": {"clip": ["1", 1], "stop_at_clip_layer": -2}},
        "3": {"class_type": "CLIPTextEncode", "inputs": {"text": "a harbor", "clip": ["2", 0]}},
    }
    context = ExecutionContext(device="cpu", pipelines={"tiny-unet": tb})
    executor = GraphExecutor(context)
    executor.execute(prompt)
    skip2 = executor.last_results["3"][0].context
    executor.execute(prompt)
    assert executor.last_timings["3"] == 0.0  # unchanged: cached
    prompt["2"]["inputs"]["stop_at_clip_layer"] = -1
    executor.execute(prompt)
    assert executor.last_timings["3"] > 0.0  # re-encoded
    skip1 = executor.last_results["3"][0].context
    assert not torch.equal(skip1, skip2)
    assert torch.equal(skip1, tpl.encode_text(tb, ["a harbor"]))
    assert context.pipelines["tiny-unet"] is tb and tb.clip_skip is None


def test_clip_h_config_equals_the_jax_packages():
    from comfyui_distributed_tpu.models import registry as jreg
    from comfyui_distributed_tpu_torch.models import registry as treg

    assert dataclasses.asdict(treg.get_config("clip-h")) == dataclasses.asdict(
        jreg.get_config("clip-h"))
