"""The port's attention router and the kernel's plain version against the
JAX package's flash attention, on the CPU.

Inputs come from numpy with a fixed seed and go through both packages in
f32. Tolerances: both sides compute softmax(q k^T / sqrt(D)) v in f32
and differ only in summation order, which moves an output by ~1e-6 at
these sizes; 2e-5 absolute leaves a margin of ten.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.ops import attention as jax_attn
from comfyui_distributed_tpu_torch.ops import attention as attn

ATOL = 2e-5


def _qkv(seed, b, n, m, h, d):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, n, h, d), dtype=np.float32),
        rng.standard_normal((b, m, h, d), dtype=np.float32),
        rng.standard_normal((b, m, h, d), dtype=np.float32),
    )


@pytest.mark.parametrize("shape", [(2, 256, 2, 64, 256), (1, 128, 2, 128, 256)])
def test_plain_matches_pallas_kernel_interpret(shape):
    """Aligned shapes reach the JAX package's Pallas kernel itself
    (interpret mode on the CPU)."""
    b, n, h, d, m = shape
    q, k, v = _qkv(0, b, n, m, h, d)
    ref = jax_attn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    out = attn.flash_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "b, n, m, h, d",
    [
        (2, 81, 77, 2, 64),     # ragged self and cross lengths
        (2, 324, 324, 2, 64),   # the 18x18 UNet level of a 576-px tile
        (2, 324, 77, 2, 64),    # its cross-attention on 77 text tokens
        (1, 200, 200, 1, 512),  # the VAE mid-block head dim
    ],
)
def test_router_matches_jax_on_ragged_shapes(b, n, m, h, d):
    """Lengths off the TPU kernel's 128 grid: the JAX package computes
    them with jax.nn.dot_product_attention, the port with the plain
    version on the CPU."""
    q, k, v = _qkv(1, b, n, m, h, d)
    ref = jax.nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = attn.dot_product_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert out.dtype == torch.float32 and out.shape == (b, n, h, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_explicit_scale_matches_jax():
    q, k, v = _qkv(2, 1, 128, 128, 2, 64)
    ref = jax_attn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.3, interpret=True
    )
    out = attn.flash_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), scale=0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_cpu_router_launches_no_kernel():
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 64, 64, 2, 64))
    before = attn.flash_attention.launches
    attn.dot_product_attention(q, k, v)
    assert attn.flash_attention.launches == before == 0


def test_plain_version_keeps_bf16_dtype():
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(4, 1, 40, 30, 1, 64))
    out = attn.dot_product_attention(q, k, v)
    assert out.dtype == torch.bfloat16
    ref = attn.flash_attention_reference(q.float(), k.float(), v.float())
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=2e-2, rtol=2**-7)


@pytest.mark.parametrize(
    "q_shape, k_shape, dtype, match",
    [
        ((1, 8, 2, 80), (1, 8, 2, 80), torch.float32, "head dims"),
        ((1, 8, 2, 64), (1, 8, 2, 64), torch.float16, "float32 or bfloat16"),
        ((1, 8, 2, 64), (1, 8, 3, 64), torch.float32, "disagree"),
        ((1, 8, 64), (1, 8, 64), torch.float32, r"\[B, N, H, D\]"),
        ((1, 8, 2, 64), (1, 0, 2, 64), torch.float32, "M >= 1"),
        ((1, 8, 2, 64), (1, 8, 2, 64), torch.float32, "CUDA tensors"),
    ],
)
def test_kernel_wrapper_rejects_what_it_does_not_take(q_shape, k_shape, dtype, match):
    q = torch.zeros(q_shape, dtype=dtype)
    k = torch.zeros(k_shape, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        attn.flash_attention(q, k, k)
    assert attn.flash_attention.launches == 0


def test_kernel_wrapper_rejects_strided_head_dim():
    q = torch.zeros((1, 8, 2, 128))[..., ::2]
    with pytest.raises(ValueError, match="contiguous last"):
        attn.flash_attention(q, q, q)
