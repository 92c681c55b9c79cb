"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py),
and tests of the helpers themselves."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models.io import flatten_params
from comfyui_distributed_tpu_torch.utils.async_helpers import ServerLoopThread


@pytest.fixture
def one_torch_thread():
    """One intra-op thread per torch call, for tests that run several
    Python threads calling torch at once (master, worker, pipeline
    stages): each call's default team of one thread per core would
    oversubscribe the cores of every test process beside them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def port_loop():
    """The port's own control-plane loop (tests/conftest.py's server_loop
    drives the JAX package's)."""
    loop = ServerLoopThread(name="port-test-loop")
    loop.start()
    yield loop
    loop.stop()


def f32(config):
    """A registry config computing in float32, for f32 parity."""
    return dataclasses.replace(config, dtype="float32")


def seeded_flax_params(module, seed, *args, **kwargs):
    """The parameter tree `module.init(key, *args)` would build, filled
    from numpy with a fixed seed instead of running init: the shapes come
    from a trace (a second), where flax's init of a tiny UNet takes a
    minute on one core. Kernels N(0, 1/fan_in), biases N(0, 0.1^2), norm
    scales 1 + N(0, 0.1^2), embedding tables N(0, 1/width), the position
    table N(0, 0.01^2). Non-zero biases and scales make a mis-mapped
    parameter show; the UNet's out_conv, zero after flax's init, comes
    out non-zero like every other kernel, so the UNet's output counts."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args, **kwargs)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        draw = rng.standard_normal(leaf.shape, dtype=np.float32)
        if name == "kernel":
            return jnp.asarray(draw / math.sqrt(math.prod(leaf.shape[:-1])))
        if name == "bias":
            return jnp.asarray(draw * 0.1)
        if name == "scale":
            return jnp.asarray(1.0 + draw * 0.1)
        if name == "embedding":
            return jnp.asarray(draw / math.sqrt(leaf.shape[-1]))
        if name == "position_embedding":
            return jnp.asarray(draw * 0.01)
        if name == "text_projection":
            return jnp.asarray(draw / math.sqrt(leaf.shape[0]))
        raise KeyError(f"no fill rule for parameter {name!r}")

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("name", ["tiny-unet-adm", "tiny-vae", "tiny-te-g"])
def test_seeded_params_fill_every_leaf_of_flax_init(name):
    """Same tree, same shapes as flax's init; seeded; out_conv non-zero."""
    module = jreg.create_model(name)
    if name.startswith("tiny-unet"):
        args = (jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 16, 160)))
    elif name == "tiny-vae":
        args = (jnp.zeros((1, 16, 16, 3)),)
    else:
        args = (jnp.zeros((1, 16), jnp.int32),)
    def shapes(tree):
        return jax.tree_util.tree_map(lambda leaf: tuple(leaf.shape), tree)

    filled = seeded_flax_params(module, 7, *args)
    assert shapes(filled) == shapes(jax.eval_shape(module.init, jax.random.key(0), *args))
    a = flatten_params(filled)
    b = flatten_params(seeded_flax_params(module, 7, *args))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    if "params/out_conv/kernel" in a:
        assert np.abs(a["params/out_conv/kernel"]).max() > 0
