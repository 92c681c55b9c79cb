"""Perturbed-attention guidance (PAG) in the port against the JAX
package, on the CPU in f32.

- The identity self-attention: out = to_out(to_v(x)), no attention call.
- The UNet's PAG pass on tiny-unet (the middle block's attn1 as
  identity) against flax's, with the same numpy-seeded weights
  (`from_jax_params`).
- `pag_cfg_model`'s arithmetic against the JAX package's; a PAG bundle's
  guided model at scale 0 is plain CFG.
- The PerturbedAttentionGuidance node: a new bundle, the family guard,
  no second guidance patch.
- `workflows/distributed-txt2img-pag.json`, unmodified but for the
  checkpoint (tiny-unet) and the size (32 px), through both packages'
  GraphExecutors.

Tolerances: f32 on both sides, differing in summation order and in the
last bit of exp/erf; each leaves a margin of about ten over the
difference measured on a CPU.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.graph.nodes_loaders import (
    PerturbedAttentionGuidance as JPerturbedAttentionGuidance,
)
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models.io import flatten_params
from comfyui_distributed_tpu.ops import samplers as jsmp
from comfyui_distributed_tpu_torch.graph.nodes_loaders import PerturbedAttentionGuidance
from comfyui_distributed_tpu_torch.models import layers as tlayers
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models.io import from_jax_params
from comfyui_distributed_tpu_torch.ops import samplers as tsmp
from comfyui_distributed_tpu_torch.ops.conditioning import Conditioning
from test_torch_parity import (  # noqa: F401  (one_torch_thread: fixture)
    f32,
    jax_and_port_bundles,
    one_torch_thread,
    run_workflow_in_both,
    seeded_flax_params,
)

# one intra-op thread: the tiny models gain nothing from more, and the
# xdist run's processes would oversubscribe the cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def attention_calls(monkeypatch):
    calls = []
    attention = tlayers.dot_product_attention

    def record(q, k, v):
        calls.append((tuple(q.shape), k.shape[1]))
        return attention(q, k, v)

    monkeypatch.setattr(tlayers, "dot_product_attention", record)
    return calls


def test_identity_attention_is_projected_v(attention_calls):
    block = tlayers.AttentionBlock(8, 8, 2, 4, torch.float32)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
        x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 6, 8),
                                                                      dtype=np.float32))
        out = block(x, identity_self=True)
        ref = x @ block.to_v.weight.T @ block.to_out.weight.T + block.to_out.bias
        assert attention_calls == []
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
        assert not torch.allclose(block(x), out, atol=1e-4)  # attention mixes tokens
        # cross-attention is never perturbed
        ctx = torch.ones((1, 3, 8))
        assert torch.equal(block(x, ctx, identity_self=True), block(x, ctx))


def test_unet_pag_pass_matches_flax(attention_calls):
    jcfg, tcfg = f32(jreg.get_config("tiny-unet")), f32(treg.get_config("tiny-unet"))
    jm = jreg.UNet(jcfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    t = np.asarray([17.0, 981.0], np.float32)
    ctx = rng.standard_normal((2, 16, 64), dtype=np.float32)
    params = seeded_flax_params(jm, 0, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    # jitted: flax's eager apply of a UNet takes seconds on one core
    ref = np.asarray(jax.jit(functools.partial(jm.apply, pag=True))(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    tm = treg.UNet(tcfg)
    tm.load_state_dict(from_jax_params(flatten_params(params), tm))
    tm.eval().requires_grad_(False)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), pag=True)
        calls_pag = len(attention_calls)
        plain = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert (out - plain).abs().max() > 1e-3  # the perturbation shows
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-5, rtol=0)
    # every attention of the plain pass but the middle block's self-attention
    assert calls_pag == len(attention_calls) - calls_pag - 1


def test_pag_cfg_model_arithmetic_matches_jax():
    x = np.zeros((1, 2, 2, 1), np.float32)
    pos, neg = np.full_like(x, 2.0), np.full_like(x, 1.0)

    def base(x, sigma, cond):
        return cond.context if isinstance(cond, Conditioning) else cond

    def pert(x, sigma, cond):
        return base(x, sigma, cond) * 0.5

    ref = jsmp.pag_cfg_model(base, pert, 3.0, 2.0)(jnp.asarray(x), jnp.ones((1,)),
                                                   (jnp.asarray(pos), jnp.asarray(neg)))
    got = tsmp.pag_cfg_model(base, pert, 3.0, 2.0)(
        torch.from_numpy(x), torch.ones((1,)),
        (Conditioning(torch.from_numpy(pos)), Conditioning(torch.from_numpy(neg))))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), 4.0 + 2.0 * (2.0 - 1.0))


@pytest.fixture(scope="module")
def pair():
    return jax_and_port_bundles("tiny-unet")


def test_guided_model_of_a_pag_bundle(pair):
    """At scale 0 the PAG bundle's guided model is plain CFG's; at 3 it
    is not. (Against the JAX package: the workflow test below.)"""
    _, tb = pair
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 4, 4, 4), dtype=np.float32))
    cond = tuple(Conditioning(torch.from_numpy(rng.standard_normal((1, 16, 64),
                                                                   dtype=np.float32)))
                 for _ in range(2))
    sigma = torch.full((1,), 5.0)
    plain = tpl.guided_model(tb, 4.0)(x, sigma, cond)
    outs = {}
    for scale in (0.0, 3.0):
        (patched,) = PerturbedAttentionGuidance().patch(tb, scale=scale)
        outs[scale] = tpl.guided_model(patched, 4.0)(x, sigma, cond)
    torch.testing.assert_close(outs[0.0], plain, atol=1e-6, rtol=0)
    assert (outs[3.0] - plain).abs().max() > 1e-3


def test_the_node_returns_a_new_bundle_and_guards(pair):
    _, tb = pair
    (patched,) = PerturbedAttentionGuidance().patch(tb, scale=2.5)
    assert patched is not tb and tb.pag is None and patched.pag == tpl.PAGSpec(2.5)
    assert patched.unet is tb.unet
    with pytest.raises(ValueError, match="cannot combine with PerturbedAttentionGuidance"):
        PerturbedAttentionGuidance().patch(patched)
    vae_only = tpl.PipelineBundle("vae-sd", None, None, None, None, torch.device("cpu"))
    with pytest.raises(ValueError, match="vae-family"):
        PerturbedAttentionGuidance().patch(vae_only)


def test_pag_workflow_matches_the_jax_executor(pair, monkeypatch):
    with open(os.path.join(REPO, "workflows", "distributed-txt2img-pag.json"),
              encoding="utf-8") as fh:
        workflow = json.load(fh)
    workflow["1"]["inputs"]["ckpt_name"] = "tiny-unet"
    workflow["5"]["inputs"].update(width=32, height=32)
    jb, tb = pair
    ref, got = run_workflow_in_both(workflow, jb, tb, monkeypatch)
    assert got.shape == ref.shape == (1, 32, 32, 3)
    assert got.std() > 0.01
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=0)  # measured 2.6e-6
