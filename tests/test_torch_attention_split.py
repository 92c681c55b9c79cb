"""The wgmma512 kernel's key splits and their merge, in their plain
version (`ops/attention.py::split_attention_reference`), against the JAX
package's flash attention, on the CPU.

Inputs come from numpy with a fixed seed and go through both packages in
f32. Aligned shapes reach the JAX package's Pallas kernel itself
(interpret mode); ragged ones `jax.nn.dot_product_attention`, which the
JAX package takes for them. Tolerance: both sides compute softmax(q k^T /
sqrt(D)) v in f32 and differ only in summation order and in where the
sum is cut (~1e-6 at these sizes); 2e-5 absolute leaves a margin of ten.
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


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_split_merge_matches_pallas_kernel_interpret(splits):
    """Aligned D=512: 8 key tiles of 32 over 256 keys, cut in 1 to 8."""
    q, k, v = _qkv(splits, 1, 128, 256, 1, 512)
    ref = jax_attn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    out = attn.split_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), splits)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "b, n, m, h, splits",
    [
        (1, 200, 190, 1, 2),   # ragged N and M, the last tile ragged
        (1, 200, 190, 1, 6),   # one tile a split
        (2, 65, 33, 2, 2),     # B*H > 1; a split of one key
        (2, 63, 31, 2, 1),     # one tile, so one split
        (1, 1, 1, 1, 1),       # M = 1
        (1, 81, 300, 1, 3),    # vae@5184's router split on a short row block
    ],
)
def test_split_merge_matches_jax_on_ragged_shapes(b, n, m, h, splits):
    q, k, v = _qkv(n + m, b, n, m, h, 512)
    ref = jax.nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = attn.split_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), splits)
    assert out.dtype == torch.float32 and out.shape == (b, n, h, 512)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("m, splits", [(1, 1), (33, 2), (190, 6), (5184, 3), (18496, 5), (300, 7)])
def test_key_split_ranges_cover_the_keys_without_an_empty_split(m, splits):
    ranges = attn.key_split_ranges(m, attn.WGMMA512_KEYS, splits)
    assert len(ranges) == splits
    assert ranges[0][0] == 0 and ranges[-1][1] == m
    assert all(stop == start for (_, stop), (start, _) in zip(ranges, ranges[1:]))
    assert all(stop > start and start % attn.WGMMA512_KEYS == 0 for start, stop in ranges)


def test_key_split_ranges_refuse_more_splits_than_tiles():
    with pytest.raises(ValueError, match="empty"):
        attn.key_split_ranges(64, attn.WGMMA512_KEYS, 3)
