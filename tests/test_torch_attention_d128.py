"""Flux's D=128 attention on the CPU: the router's two plans and the
arithmetic of the one that rounds P once to bf16.

Past WGMMA_PINGPONG_ABOVE[128] keys the router sends D=128 to the wgmma
instance's two-consumer plans (128 query rows a block, 144- or 176-key
tiles, whichever `pingpong_key_tile` weighs faster), which round P once
to bf16 for P·V and take the row sum from the f32 P; at or below it, to
the one-consumer plan of 64-key tiles, which splits P in two bf16. The TPU kernel multiplies an f32 P by V, so the
first plan departs from it: `bf16_p_attention_reference` repeats that
plan's arithmetic in plain PyTorch, and is held here

(a) against the JAX package's Pallas kernel in interpret mode (as its
    own tests run it on the CPU), at N = M = 512;
(b) against the f32 plain version at Flux's joint lengths 4608 and 4481;
(c) at the small key counts where it misses the plain version, which
    the router keeps on the split-P plan.

Inputs come from numpy with a fixed seed, rounded to bf16 (the kernel's
input type). Tolerance: the kernel's, |d| <= 1e-3 + 2^-7 |ref|, never
widened. The kernel itself is held to the plain version on the card
(tests/test_torch_attention_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.ops import attention as jax_attn
from comfyui_distributed_tpu_torch.ops import attention as attn

RTOL, ATOL = 2.0**-7, 1e-3
# PR 12's plan (one consumer, 64-key tiles, P split in two bf16) and the
# two-consumer plans that round P once to bf16
SPLIT_P = attn.Plan("wgmma", 64, attn.WGMMA_ROWS)
BF16_P_144 = attn.Plan("wgmma", 144, 2 * attn.WGMMA_ROWS)
BF16_P = attn.Plan("wgmma", 176, 2 * attn.WGMMA_ROWS)
THRESHOLD = attn.WGMMA_PINGPONG_ABOVE[128]


def _meta(b, n, m, h, d=128):
    q = torch.empty((b, n, h, d), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((b, m, h, d), dtype=torch.bfloat16, device="meta")
    return q, kv, kv


def _qkv(seed, n, m, h, d=128):
    """bf16 [1, N, H, D] q and [1, M, H, D] k, v from a seeded numpy draw."""
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16()
        for shape in ((1, n, h, d), (1, m, h, d), (1, m, h, d))
    )


def _tolerance_ratio(got, ref):
    """The largest |got - ref| over the kernel's tolerance: at most 1 passes."""
    got, ref = got.float(), ref.float()
    return float(((got - ref).abs() / (ATOL + RTOL * ref.abs())).max())


# --- the router -------------------------------------------------------------------


@pytest.mark.parametrize("n, m, expected", [
    # Flux's joint attention at 1024 px (32 tiles of 144 keys, none
    # masked, against 27 of 176), Kontext's and at 1008 px (50 and 26
    # tiles of 176 against 61 and 32 of 144)
    (4608, 4608, BF16_P_144), (8704, 8704, BF16_P), (4481, 4481, BF16_P),
    # a short key count at Flux's 24 heads
    (4608, 63, SPLIT_P),
    # both sides of the threshold, and the key tiles' edges past it
    (4608, THRESHOLD, SPLIT_P), (4608, THRESHOLD + 1, BF16_P),
    (200, 1055, BF16_P), (200, 1056, BF16_P), (200, 1057, BF16_P_144),
    (200, 1151, BF16_P_144), (200, 1152, BF16_P_144), (200, 1153, BF16_P),
    # one key tile, and a few, stay split however many query rows
    (4608, 1, SPLIT_P), (1, 128, SPLIT_P), (200, 257, SPLIT_P),
])
def test_plan_pins_d128(n, m, expected):
    p = attn.plan(*_meta(1, n, m, 24), sms=132)
    assert p == expected
    assert p in attn.wgmma_plans(128)
    # batch and heads do not move it
    assert attn.plan(*_meta(2, n, m, 1)) == p


def test_wgmma_plans_at_d128_list_both_plans():
    assert attn.wgmma_plans(128) == [SPLIT_P, BF16_P_144, BF16_P]
    assert 128 in attn.WGMMA_BF16_P and 40 not in attn.WGMMA_BF16_P
    # D=40's two-consumer plan still takes over past its one 80-key tile
    assert attn.plan(*_meta(2, 4096, 81, 8, 40)).rows_per_cta == 2 * attn.WGMMA_ROWS
    assert attn.plan(*_meta(2, 4096, 80, 8, 40)).rows_per_cta == attn.WGMMA_ROWS


def test_the_main_shapes_masked_key_slots():
    """The router's tiles leave none of 4608 slots empty at 4608 keys (144
    keys a tile), 96 of 8800 at 8704 and 95 of 4576 at 4481 (176)."""
    assert (BF16_P_144.key_tiles(4608), BF16_P.key_tiles(8704), BF16_P.key_tiles(4481)) == (
        32, 50, 26)
    assert BF16_P_144.masked_share(4608) == 0.0
    assert BF16_P.masked_share(8704) == pytest.approx(96 / 8800)
    assert BF16_P.masked_share(4481) == pytest.approx(95 / 4576)
    # 128-row blocks: 864 of them at joint@4608, 6.55 waves of one an SM
    assert BF16_P.ctas(1, 4608, 24) == 864


# --- the one-bf16-P arithmetic ------------------------------------------------------


def test_bf16_p_emulation_matches_the_pallas_kernel():
    """(a) N = M = 512, D = 128, two heads: the TPU kernel (f32 P) in
    interpret mode against the emulation (P rounded once to bf16) at each
    compiled key tile."""
    q, k, v = _qkv(512, 512, 512, 2)
    ref = torch.from_numpy(np.asarray(jax_attn.flash_attention(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)), interpret=True)).copy())
    for keys in attn.WGMMA_PINGPONG_KEYS[128]:
        got = attn.bf16_p_attention_reference(q, k, v, keys)
        assert got.dtype == torch.bfloat16 and got.shape == (1, 512, 2, 128)
        assert _tolerance_ratio(got, ref) <= 1.0


@pytest.mark.parametrize("m", [4608, 4481])
def test_bf16_p_emulation_holds_at_flux_joint_lengths(m):
    """(b) Flux's joint lengths at 1024 and 1008 px, two heads: within the
    kernel's tolerance of the f32 plain version (about half of it: the
    two outputs' own bf16 roundings)."""
    q, k, v = _qkv(m, m, m, 2)
    p = attn.plan(q, k, v)
    assert p.rows_per_cta == 2 * attn.WGMMA_ROWS
    got = attn.bf16_p_attention_reference(q, k, v, p.keys_per_tile)
    assert _tolerance_ratio(got, attn.flash_attention_reference(q, k, v)) <= 1.0


def test_bf16_p_emulation_equals_the_f32_softmax_where_p_is_exact():
    """One key: P = 2^0 = 1 is exact in bf16, and the output is v."""
    q, k, v = _qkv(1, 64, 1, 2)
    got = attn.bf16_p_attention_reference(q, k, v, BF16_P.keys_per_tile)
    torch.testing.assert_close(got, v.expand(1, 64, 2, 128), rtol=0, atol=0)


@pytest.mark.parametrize("m", [2, 4, 8, 16])
def test_bf16_p_misses_where_few_keys_share_the_weight(m):
    """(c) Flux's 4608 query rows at its 24 heads against a few keys: one
    bf16 P misses the f32 plain version by more than the tolerance (2.4 to
    4.3 times it on these seeds), so the router keeps these key counts on
    the split-P plan."""
    q, k, v = _qkv(m, 4608, m, 24)
    got = attn.bf16_p_attention_reference(q, k, v, BF16_P.keys_per_tile)
    assert _tolerance_ratio(got, attn.flash_attention_reference(q, k, v)) > 1.5
    assert attn.plan(q, k, v) == SPLIT_P


def test_bf16_p_holds_just_past_the_threshold():
    """(c) The first key count the router sends to the one-bf16-P plan, at
    Flux's 4608 query rows and 24 heads: within the tolerance (0.66 of it
    on this seed)."""
    q, k, v = _qkv(THRESHOLD + 1, 4608, THRESHOLD + 1, 24)
    p = attn.plan(q, k, v)
    assert p.rows_per_cta == 2 * attn.WGMMA_ROWS
    got = attn.bf16_p_attention_reference(q, k, v, p.keys_per_tile)
    assert _tolerance_ratio(got, attn.flash_attention_reference(q, k, v)) <= 0.8
