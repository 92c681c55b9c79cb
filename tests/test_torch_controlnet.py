"""ControlNet in the port against the JAX package, on the CPU in f32.

- `ControlNetEncoder` against flax's, with the same numpy-seeded weights
  (`from_jax_params`; the output conv non-zero, as every kernel of
  `seeded_flax_params`: a fresh ControlNet adds zero, and the comparison
  would hold for a model that ignores its hint).
- The UNet's `control` residual against flax's.
- ControlNetApplyAdvanced's window: the node's entries, and the model
  function's gate at each edge of the window.
- A hinted positive and a plain negative run as two batch-1 passes, the
  hint reaching the UNet on the positive's only: the UNet's inputs of
  both packages compared call by call.
- A tiny-unet USDU run with ControlNet tile on both sides, port against
  JAX `ops/upscale.py::run_upscale`.

Tolerances: f32 on both sides, differing in summation order; each leaves
a margin of about ten over the difference measured on a CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.graph import nodes_controlnet as jnodes
from comfyui_distributed_tpu.models import pipeline as jpl
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models.io import flatten_params
from comfyui_distributed_tpu.ops import conditioning as jcond
from comfyui_distributed_tpu.ops import samplers as jsmp
from comfyui_distributed_tpu.ops import upscale as jup
from comfyui_distributed_tpu_torch.graph import ExecutionContext
from comfyui_distributed_tpu_torch.graph import nodes_controlnet as tnodes
from comfyui_distributed_tpu_torch.models import controlnet as tcn
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models.io import from_jax_params
from comfyui_distributed_tpu_torch.ops import conditioning as tcond
from comfyui_distributed_tpu_torch.ops import upscale as tup
from test_torch_parity import (  # noqa: F401  (one_torch_thread: fixture)
    JaxTileNoise,
    controlnet_pair,
    f32,
    jax_and_port_bundles,
    one_torch_thread,
    seeded_flax_params,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def nets():
    return controlnet_pair()


@pytest.mark.parametrize("shape", [(1, 64, 64, 3), (2, 72, 40, 3)])
def test_encoder_matches_flax(nets, shape):
    jnet, tnet = nets
    hint = np.random.default_rng(1).random(shape, dtype=np.float32)
    ref = np.asarray(jax.jit(jnet.encode)(jnp.asarray(hint)))
    with torch.no_grad():
        got = tnet.encode(torch.from_numpy(hint)).numpy()
    assert got.shape == ref.shape == (shape[0], -(-shape[1] // 8), -(-shape[2] // 8), 32)
    assert np.abs(ref).max() > 0.1
    # measured 1.5e-7 on a CPU
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0)


def test_load_controlnet_is_seeded_by_name_and_adds_zero_fresh():
    a = tcn.load_controlnet("tile", 32, device="cpu")
    b = tcn.load_controlnet("tile", 32, device="cpu")
    c = tcn.load_controlnet("canny", 32, device="cpu")
    assert torch.equal(a.module.mid.weight, b.module.mid.weight)
    assert not torch.equal(a.module.mid.weight, c.module.mid.weight)
    assert float(a.module.conv_out.weight.abs().max()) == 0.0
    # the conv stack in bf16, the output conv in f32, as the JAX package's
    assert a.module.mid.weight.dtype == torch.bfloat16
    assert a.module.conv_out.weight.dtype == torch.float32
    with torch.no_grad():
        assert float(a.encode(torch.rand(1, 16, 16, 3)).abs().max()) == 0.0


def test_unet_control_residual_matches_flax():
    jcfg, tcfg = f32(jreg.get_config("tiny-unet")), f32(treg.get_config("tiny-unet"))
    jm = jreg.UNet(jcfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    t = np.asarray([17.0, 981.0], np.float32)
    ctx = rng.standard_normal((2, 16, 64), dtype=np.float32)
    control = rng.standard_normal((2, 8, 8, 32), dtype=np.float32)
    params = seeded_flax_params(jm, 0, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                                       control=jnp.asarray(control)))
    tm = treg.UNet(tcfg)
    tm.load_state_dict(from_jax_params(flatten_params(params), tm))
    tm.eval().requires_grad_(False)
    with torch.no_grad():
        args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
        got = tm(*args, control=torch.from_numpy(control)).numpy()
        plain = tm(*args).numpy()
    assert np.abs(got - plain).max() > 1e-3  # the residual counts
    # measured 4.8e-6 on a CPU
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=0)


# --- the apply nodes and the window ----------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    return jax_and_port_bundles("tiny-unet")


def _contexts(seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 16, 64), dtype=np.float32) for _ in range(2)]


def test_apply_advanced_puts_the_hint_and_window_on_both_sides(nets):
    jnet, tnet = nets
    pos, neg = _contexts()
    hint = np.random.default_rng(4).random((1, 32, 32, 3), dtype=np.float32)
    jpos, jneg = jnodes.ControlNetApplyAdvanced().apply(
        jcond.Conditioning(jnp.asarray(pos)), jcond.Conditioning(jnp.asarray(neg)), jnet,
        jnp.asarray(hint), strength=0.8, start_percent=0.1, end_percent=0.7)
    tpos, tneg = tnodes.ControlNetApplyAdvanced().apply(
        tcond.Conditioning(torch.from_numpy(pos)), tcond.Conditioning(torch.from_numpy(neg)),
        tnet, torch.from_numpy(hint), strength=0.8, start_percent=0.1, end_percent=0.7)
    for t, j in ((tpos, jpos), (tneg, jneg)):
        assert t.control_net is tnet and j.control_params is jnet.params
        assert (t.control_strength, t.control_range) == (j.control_strength, j.control_range)
        np.testing.assert_array_equal(t.control_hint.numpy(), np.asarray(j.control_hint))
    (single,) = tnodes.ControlNetApply().apply(tcond.Conditioning(torch.from_numpy(pos)), tnet,
                                               torch.from_numpy(hint), strength=0.5)
    assert single.control_range is None and single.control_strength == 0.5
    untouched = tcond.Conditioning(torch.from_numpy(pos))
    assert tnodes.ControlNetApplyAdvanced().apply(untouched, untouched, tnet,
                                                  torch.from_numpy(hint), strength=0.0) == \
        (untouched, untouched)


WINDOW = (0.2, 0.6)


@pytest.mark.parametrize("edge", range(4), ids=["top", "above top", "bottom", "above bottom"])
def test_the_model_function_gates_the_hint_at_each_edge_of_its_window(pair, nets, edge):
    """The ControlNet residual applies while sigma <= p2s(start) and
    sigma > p2s(end), as the JAX package's arithmetic gate in f32."""
    jb, tb = pair
    jnet, tnet = nets
    hi = np.float32(jsmp.percent_to_sigma(WINDOW[0], "eps"))
    lo = np.float32(jsmp.percent_to_sigma(WINDOW[1], "eps"))
    sigma = [hi, np.nextafter(hi, np.float32(np.inf)), lo,
             np.nextafter(lo, np.float32(np.inf))][edge]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 4, 4, 4), dtype=np.float32)
    ctx = _contexts()[0]
    hint = rng.random((1, 32, 32, 3), dtype=np.float32)
    jc = jcond.Conditioning(jnp.asarray(ctx), control_hint=jnp.asarray(hint),
                            control_params=jnet.params, control_module=jnet.module,
                            control_range=WINDOW)
    tc = tcond.Conditioning(torch.from_numpy(ctx), control_hint=torch.from_numpy(hint),
                            control_net=tnet, control_range=WINDOW)
    sig = np.full((1,), sigma, np.float32)
    ref = np.asarray(jpl._make_model_fn(jb, jb.params)(jnp.asarray(x), jnp.asarray(sig), jc))
    with torch.no_grad():
        fn = tpl._make_model_fn(tb)
        got = fn(torch.from_numpy(x), torch.from_numpy(sig), tc).numpy()
        plain = fn(torch.from_numpy(x), torch.from_numpy(sig),
                   tcond.Conditioning(torch.from_numpy(ctx))).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
    inside = edge in (0, 3)
    assert bool(np.abs(got - plain).max() > 1e-4) is inside


class _Recorder:
    """A flax module's stand-in that records what each apply gets."""

    def __init__(self, module):
        self.module = module
        self.calls = []

    def apply(self, params, x, t, context, **kwargs):
        self.calls.append({"x": np.asarray(x), "control": kwargs.get("control")})
        return self.module.apply(params, x, t, context, **kwargs)


def test_a_hinted_positive_and_a_plain_negative_run_as_two_passes(pair, nets):
    """Never one 2B batch: the hint reaches the UNet with the positive,
    at batch 1, and the negative's pass has none (a batched pair built
    from context and pooled alone would drop it). The UNet's inputs
    equal the JAX package's, call by call."""
    jb, tb = pair
    jnet, tnet = nets
    pos, neg = _contexts(6)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 4, 4, 4), dtype=np.float32)
    hint = rng.random((1, 32, 32, 3), dtype=np.float32)
    (jpos,) = jnodes.ControlNetApply().apply(jcond.Conditioning(jnp.asarray(pos)), jnet,
                                             jnp.asarray(hint))
    (tpos,) = tnodes.ControlNetApply().apply(tcond.Conditioning(torch.from_numpy(pos)), tnet,
                                             torch.from_numpy(hint))
    recorder = _Recorder(jb.unet)
    jguided = jpl.guided_model(dataclasses.replace(jb, unet=recorder), jb.params, 5.0)
    sig = np.full((1,), 4.0, np.float32)
    ref = np.asarray(jguided(jnp.asarray(x), jnp.asarray(sig),
                             (jpos, jcond.Conditioning(jnp.asarray(neg)))))
    calls = []
    handle = tb.unet.register_forward_pre_hook(
        lambda module, args, kwargs: calls.append({"x": args[0].numpy().copy(),
                                                   "control": kwargs.get("control")}),
        with_kwargs=True)
    try:
        with torch.no_grad():
            got = tpl.guided_model(tb, 5.0)(torch.from_numpy(x), torch.from_numpy(sig),
                                            (tpos, tcond.Conditioning(torch.from_numpy(neg))))
    finally:
        handle.remove()
    assert len(calls) == len(recorder.calls) == 2
    assert [c["x"].shape[0] for c in calls] == [1, 1]
    assert calls[0]["control"] is not None and calls[1]["control"] is None
    assert recorder.calls[1]["control"] is None
    for t, j in zip(calls, recorder.calls):
        np.testing.assert_allclose(t["x"], j["x"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(calls[0]["control"].numpy(), np.asarray(recorder.calls[0]["control"]),
                               atol=2e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-5, rtol=0)


# --- a USDU run with ControlNet tile ------------------------------------------------------

GEOMETRY = dict(upscale_by=2.0, tile=64, padding=16, steps=2, sampler="euler",
                scheduler="karras", cfg=7.0, denoise=0.35, seed=13, mask_blur=8)


def test_run_upscale_with_controlnet_tile_matches_jax(pair, nets):
    """64 → 128 px in four 64-px tiles with 16-px padding, 2 euler steps;
    ControlNetApplyAdvanced's hint (the input image) on both sides, the
    tiles' windows of it through the ControlNet at each evaluation. The
    port draws the JAX package's tile noise. Tolerance 5e-5 on [0, 1]
    pixels, as the upscale slice's (measured 4.5e-6 on a CPU)."""
    jb, tb = pair
    jnet, tnet = nets
    pos, neg = _contexts(8)
    image = np.random.default_rng(9).random((1, 64, 64, 3), dtype=np.float32)
    jpos, jneg = jnodes.ControlNetApplyAdvanced().apply(
        jcond.Conditioning(jnp.asarray(pos)), jcond.Conditioning(jnp.asarray(neg)), jnet,
        jnp.asarray(image))
    tpos, tneg = tnodes.ControlNetApplyAdvanced().apply(
        tcond.Conditioning(torch.from_numpy(pos)), tcond.Conditioning(torch.from_numpy(neg)),
        tnet, torch.from_numpy(image))
    ref = np.asarray(jup.run_upscale(jb, jnp.asarray(image), jpos, jneg, tile_batch=1,
                                     **GEOMETRY))
    got = tup.run_upscale(tb, image, tpos, tneg, noise=JaxTileNoise(GEOMETRY["seed"]),
                          **GEOMETRY).numpy()
    plain = tup.run_upscale(tb, image, torch.from_numpy(pos), torch.from_numpy(neg),
                            noise=JaxTileNoise(GEOMETRY["seed"]), **GEOMETRY).numpy()
    assert got.shape == ref.shape == (1, 128, 128, 3)
    assert np.abs(got - plain).max() > 1.0 / 255  # the hint moved the tiles
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=0)


def test_the_loader_takes_width_and_downscale_from_the_model(pair):
    _, tb = pair
    context = ExecutionContext(device="cpu")
    (net,) = tnodes.ControlNetLoader().load("tile", model=tb, context=context)
    # tiny-vae's spatial factor is 2
    assert net.module.config.model_channels == 32 and net.module.config.downscale == 2
    assert context.pipelines["controlnet:tile:32:2"] is net
    (again,) = tnodes.ControlNetLoader().load("tile", model=tb, context=context)
    assert again is net
