"""Each ported layer against its flax counterpart, on the CPU in f32.

The flax module is initialised from a fixed key, its parameters carry
over through `from_jax_params`, and one numpy input goes through both.
Tolerance: 1e-5 absolute and relative unless a case says otherwise;
both sides are f32 and differ in summation order and in the last bit of
exp/erf, which moves these small blocks' outputs by ~1e-6.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import layers as jl
from comfyui_distributed_tpu.models.io import flatten_params
from comfyui_distributed_tpu_torch.models import layers as tl
from comfyui_distributed_tpu_torch.models.io import from_jax_params

F32 = torch.float32
TOL = dict(atol=1e-5, rtol=1e-5)


def _np(seed, shape, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * scale


def _carry(flax_module, port_module, *args):
    """Init the flax module on `args`, load its params into the port
    module, return (flax output, variables)."""
    variables = flax_module.init(jax.random.key(0), *(jnp.asarray(a) for a in args))
    port_module.load_state_dict(from_jax_params(flatten_params(variables), port_module))
    port_module.eval()
    return np.asarray(flax_module.apply(variables, *(jnp.asarray(a) for a in args)))


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("dim", [32, 33, 256])
def test_timestep_embedding(dim):
    t = np.asarray([0.0, 1.0, 17.0, 999.0, 576.0], np.float32)
    ref = np.asarray(jl.timestep_embedding(jnp.asarray(t), dim))
    out = tl.timestep_embedding(torch.from_numpy(t), dim).numpy()
    # cos/sin of arguments up to ~1000 rad: one f32 ulp of the argument
    # (6e-5) bounds the difference
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("channels, eps", [(32, 1e-5), (48, 1e-5), (16, 1e-6), (96, 1e-6)])
def test_group_norm32_with_group_fallback(channels, eps):
    x = _np(1, (2, 5, 6, channels), 3.0) + 1.0
    ref = _carry(jl.GroupNorm32(epsilon=eps), pm := tl.GroupNorm32(channels, eps=eps), x)
    np.testing.assert_allclose(_nhwc(pm(_nchw(x))), ref, **TOL)


@pytest.mark.parametrize("cross", [False, True])
def test_attention_block(cross):
    x = _np(2, (2, 10, 32))
    ctx = _np(3, (2, 7, 24)) if cross else None
    fm = jl.AttentionBlock(num_heads=2, head_dim=16, dtype=jnp.float32)
    pm = tl.AttentionBlock(32, 24 if cross else 32, 2, 16, F32)
    args = (x, ctx) if cross else (x,)
    ref = _carry(fm, pm, *args)
    out = pm(*(torch.from_numpy(a) for a in args)).detach().numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_geglu_and_feed_forward():
    x = _np(4, (2, 9, 16))
    ref = _carry(jl.GEGLU(dim_out=40, dtype=jnp.float32), g := tl.GEGLU(16, 40, F32), x)
    np.testing.assert_allclose(g(torch.from_numpy(x)).detach().numpy(), ref, **TOL)
    ref = _carry(jl.FeedForward(dtype=jnp.float32), ff := tl.FeedForward(16, F32), x)
    np.testing.assert_allclose(ff(torch.from_numpy(x)).detach().numpy(), ref, **TOL)


def test_transformer_block():
    x, ctx = _np(5, (2, 12, 32)), _np(6, (2, 5, 20))
    fm = jl.TransformerBlock(num_heads=4, head_dim=8, dtype=jnp.float32)
    pm = tl.TransformerBlock(32, 20, 4, 8, F32)
    ref = _carry(fm, pm, x, ctx)
    out = pm(torch.from_numpy(x), torch.from_numpy(ctx)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


def test_spatial_transformer():
    x, ctx = _np(7, (2, 4, 5, 32)), _np(8, (2, 6, 20))
    fm = jl.SpatialTransformer(num_heads=2, head_dim=16, depth=2, dtype=jnp.float32)
    pm = tl.SpatialTransformer(32, 20, 2, 16, 2, F32)
    ref = _carry(fm, pm, x, ctx)
    out = _nhwc(pm(_nchw(x), torch.from_numpy(ctx)))
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("c_in, c_out", [(32, 32), (32, 64)])
def test_res_block(c_in, c_out):
    x, emb = _np(9, (2, 6, 7, c_in)), _np(10, (2, 48))
    fm = jl.ResBlock(c_out, dtype=jnp.float32)
    pm = tl.ResBlock(c_in, c_out, 48, F32)
    ref = _carry(fm, pm, x, emb)
    out = _nhwc(pm(_nchw(x), torch.from_numpy(emb)))
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_downsample_symmetric_pad(hw):
    x = _np(11, (1, *hw, 8))
    ref = _carry(jl.Downsample(dtype=jnp.float32), pm := tl.Downsample(8, F32), x)
    np.testing.assert_allclose(_nhwc(pm(_nchw(x))), ref, **TOL)


@pytest.mark.parametrize("hw, stride", [((8, 8), 2), ((7, 9), 2), ((6, 5), 1)])
def test_conv_same_padding(hw, stride):
    """flax SAME: a stride-2 conv on an even size pads (0, 1)."""
    x = _np(12, (1, *hw, 6))
    fm = fnn.Conv(5, (3, 3), strides=(stride, stride), dtype=jnp.float32)
    pm = tl.Conv(6, 5, 3, stride=stride, dtype=F32)
    ref = _carry(fm, pm, x)
    np.testing.assert_allclose(_nhwc(pm(_nchw(x))), ref, **TOL)


@pytest.mark.parametrize("hw, out_hw", [((4, 4), None), ((3, 5), (5, 9)), ((2, 2), (4, 3))])
def test_upsample_nearest_onto_skip_size(hw, out_hw):
    x = _np(13, (1, *hw, 8))
    fm = jl.Upsample(dtype=jnp.float32)
    pm = tl.Upsample(8, F32)
    variables = fm.init(jax.random.key(0), jnp.asarray(x), out_hw)
    pm.load_state_dict(from_jax_params(flatten_params(variables), pm))
    ref = np.asarray(fm.apply(variables, jnp.asarray(x), out_hw))
    np.testing.assert_allclose(_nhwc(pm(_nchw(x), out_hw)), ref, **TOL)
