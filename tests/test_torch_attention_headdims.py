"""Attention at SD1.5's head dims 40, 80 and 160, on the CPU.

The port's plain version (`flash_attention_reference`, what the CPU
router runs and what the card's wgmma instance is held to) against the
JAX package: its Pallas kernel in interpret mode through
`dot_product_attention(..., force_flash=True)`, which pads D to 128 and
pins the softmax scale to 1/sqrt(D), at aligned lengths; and
`jax.nn.dot_product_attention` at ragged ones. Inputs come from numpy
with a fixed seed, in f32; both sides differ only in summation order
(~1e-6 here), so 2e-5 absolute leaves a margin of ten.

Then the router (`plan`) on meta tensors: aligned bf16 at the new head
dims goes to the wgmma instance with the key tile that leaves the
fewest key slots masked, f32 and unaligned views to the FMA kernel,
D=64 and 512 where they went before; and the wrapper's head-dim check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.ops import attention as jax_attn
from comfyui_distributed_tpu_torch.ops import attention as attn

ATOL = 2e-5
NEW_HEAD_DIMS = (40, 80, 160)


def _qkv(seed, b, n, m, h, d):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, n, h, d), dtype=np.float32),
        rng.standard_normal((b, m, h, d), dtype=np.float32),
        rng.standard_normal((b, m, h, d), dtype=np.float32),
    )


@pytest.mark.parametrize("n, m", [(256, 256), (128, 384)])
@pytest.mark.parametrize("d", NEW_HEAD_DIMS)
def test_plain_matches_the_padded_pallas_kernel(d, n, m):
    q, k, v = _qkv(d + n, 1, n, m, 2, d)
    ref = jax_attn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         force_flash=True)
    out = attn.flash_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)))
    assert out.shape == ref.shape == (1, n, 2, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("d", NEW_HEAD_DIMS)
def test_router_matches_jax_at_ragged_lengths(d):
    """200 queries against the 77 text tokens: off the TPU kernel's 128
    grid, so the JAX package takes jax.nn; the port's CPU router takes
    the plain version."""
    q, k, v = _qkv(d, 2, 200, 77, 2, d)
    ref = jax.nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = attn.dot_product_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def _meta(b, n, m, h, d, dtype=torch.bfloat16, unaligned=False):
    if unaligned:
        # rows one element off a 16-byte boundary, a (d + 1)-element pitch
        wide = torch.empty((3, b, max(n, m), h, d + 1), dtype=dtype, device="meta")
        q, k, v = (t[..., 1:] for t in wide.unbind(0))
        return q[:, :n], k[:, :m], v[:, :m]
    return tuple(torch.empty((b, x, h, d), dtype=dtype, device="meta") for x in (n, m, m))


@pytest.mark.parametrize("case, expected", [
    # SD1.5's txt2img at 512 px: self@4096 on two consumers a block
    ((2, 4096, 4096, 8, 40), ("wgmma", 128, 128, 1)),
    ((2, 4096, 77, 8, 40), ("wgmma", 80, 64, 1)),
    ((2, 1024, 1024, 8, 80), ("wgmma", 128, 64, 1)),
    ((2, 256, 77, 8, 160), ("wgmma", 80, 64, 1)),
    ((2, 64, 64, 8, 160), ("wgmma", 64, 64, 1)),
    ((1, 1, 1, 1, 40), ("wgmma", 80, 64, 1)),
    # what went elsewhere before still does
    ((2, 1296, 1296, 10, 64), ("wgmma", 144, 64, 1)),
    ((1, 5184, 5184, 1, 512), ("wgmma512", 32, 64, 3)),
])
def test_plan_routes_aligned_bf16(case, expected):
    p = attn.plan(*_meta(*case))
    assert (p.instance, p.keys_per_tile, p.rows_per_cta, p.splits) == expected


@pytest.mark.parametrize("d, m, keys, tiles", [
    # the path's (D, M): cross-attention at each level, self-attention at
    # D = 80 and 160 (D = 40's self@4096 takes two consumers, below)
    (40, 77, 80, 1), (80, 1024, 128, 8), (80, 77, 80, 1),
    (160, 256, 64, 4), (160, 77, 80, 1), (160, 64, 64, 1),
    # the compiled tiles' edges: fewest slots, then the larger tile
    (40, 1, 80, 1), (40, 79, 80, 1), (40, 80, 80, 1), (80, 79, 80, 1),
    (80, 81, 128, 1), (80, 256, 128, 2), (160, 65, 80, 1), (160, 128, 64, 2),
    (160, 129, 80, 2), (160, 320, 80, 4), (64, 145, 80, 2),
])
def test_plan_picks_the_key_tile_with_the_fewest_slots(d, m, keys, tiles):
    p = attn.plan(*_meta(2, 300, m, 8, d))
    assert (p.instance, p.keys_per_tile, p.key_tiles(m), p.rows_per_cta) == (
        "wgmma", keys, tiles, attn.WGMMA_ROWS)
    slots = min(-(-m // t) * t for t in attn.WGMMA_KEY_TILES[d])
    assert p.key_tiles(m) * p.keys_per_tile == slots
    assert keys in attn.WGMMA_KEY_TILES[d] and p in attn.wgmma_plans(d)


@pytest.mark.parametrize("b, n, h, m, rows", [
    # self@4096: 512 blocks of 128 rows, 32 key tiles
    (2, 4096, 8, 4096, 128),
    # however few the blocks: one head, one query row
    (2, 4096, 1, 4096, 128), (1, 1, 1, 4096, 128), (1, 200, 1, 257, 128),
    # keys past one 80-key tile: two consumers, up to one 128-key tile and past it
    (2, 4096, 8, 81, 128), (2, 4096, 8, 128, 128), (2, 4096, 8, 129, 128),
    # keys within one 80-key tile: one consumer
    (2, 4096, 8, 77, 64), (2, 4096, 8, 80, 64),
])
def test_plan_takes_two_consumers_at_d40_past_one_key_tile(b, n, h, m, rows):
    p = attn.plan(*_meta(b, n, m, h, 40), sms=132)
    assert (p.instance, p.rows_per_cta) == ("wgmma", rows)
    expected_keys = attn.WGMMA_PINGPONG_KEYS[40] if rows == 2 * attn.WGMMA_ROWS else 80
    assert p.keys_per_tile == expected_keys
    assert p in attn.wgmma_plans(40)


def test_every_d40_plan_is_on_the_path():
    """D=40 compiles two plans, and the path's two D=40 shapes take one
    each: cross@4096 one consumer at 80 keys, self@4096 two at 128."""
    taken = {attn.plan(*_meta(2, 4096, m, 8, 40)) for m in (77, 4096)}
    assert taken == set(attn.wgmma_plans(40))


@pytest.mark.parametrize("d, tile", [(40, (64, 128)), (80, (64, 64)), (160, (64, 64))])
def test_plan_sends_f32_and_unaligned_views_to_the_fma_kernel(d, tile):
    p = attn.plan(*_meta(2, 300, 300, 2, d, dtype=torch.float32))
    assert (p.instance, p.keys_per_tile, p.rows_per_cta) == ("fma", *tile)
    q, k, v = _meta(2, 300, 300, 2, d, unaligned=True)
    p = attn.plan(q, k, v)
    assert (p.instance, p.keys_per_tile, p.rows_per_cta) == ("fma", *tile)


def test_a_d40_row_is_five_16_byte_chunks():
    """Contiguous and fused-qkv D=40 views start every row on a 16-byte
    boundary (80 bytes a head); a pitch of 41 elements does not."""
    q = torch.zeros((2, 10, 4, 40), dtype=torch.bfloat16)
    assert attn._tensor_core_aligned(q, q, q)
    fused = torch.zeros((2, 10, 3, 4, 40), dtype=torch.bfloat16)
    assert attn._tensor_core_aligned(*fused.unbind(2))
    assert not attn._tensor_core_aligned(torch.zeros((2, 10, 4, 41), dtype=torch.bfloat16))


@pytest.mark.parametrize("d", NEW_HEAD_DIMS + (64, 512))
def test_the_wrapper_takes_the_new_head_dims(d):
    """The head-dim check passes; a CPU tensor then fails the device
    check, and nothing launches."""
    q = torch.zeros((1, 8, 2, d), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        attn.flash_attention(q, q, q)
    assert attn.flash_attention.launches == 0


@pytest.mark.parametrize("d", [32, 48, 96, 128])
def test_the_wrapper_rejects_other_head_dims(d):
    q = torch.zeros((1, 8, 2, d), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        attn.flash_attention(q, q, q)
