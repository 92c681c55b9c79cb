"""The attention router (`ops/attention.py::plan`) on the CPU.

`plan` decides which compiled kernel takes a call, from the inputs'
dtype, shapes, strides and alignment alone, so it is checked here
without a card: every attention shape of the SDXL upscale path, the
edges of the wgmma instance's key tiles, f32, an unaligned view, the
VAE's D=512 at its row-block and key-tile edges and the key-split rule
(on an H100's 132 SMs unless a case says otherwise). The kernels
themselves are held to their plain version on the card
(tests/test_torch_attention_cuda.py, chip_smoke.py).
"""

import pytest
import torch

from comfyui_distributed_tpu_torch.ops import attention as attn


def _views(b, n, m, h, d, dtype=torch.bfloat16, unaligned=False):
    if unaligned:
        # rows one element off a 16-byte boundary, with a (d + 1)-element
        # head stride
        wide = torch.zeros((3, b, max(n, m), h, d + 1), dtype=dtype)
        q, k, v = (t[..., 1:] for t in wide.unbind(0))
        return q[:, :n], k[:, :m], v[:, :m]
    return (torch.zeros((b, x, h, d), dtype=dtype) for x in (n, m, m))


# (B, N, M, H, D, dtype, unaligned) -> (instance, keys per tile, rows per
# block, key splits)
CASES = {
    # the main path of one 576-px SDXL tile
    "self@1296": ((2, 1296, 1296, 10, 64, torch.bfloat16, False), ("wgmma", 144, 64, 1)),
    "cross@1296": ((2, 1296, 77, 10, 64, torch.bfloat16, False), ("wgmma", 80, 64, 1)),
    "self@324": ((2, 324, 324, 20, 64, torch.bfloat16, False), ("wgmma", 112, 64, 1)),
    "cross@324": ((2, 324, 77, 20, 64, torch.bfloat16, False), ("wgmma", 80, 64, 1)),
    # 81 row blocks of 64 over 162 key tiles: 3 splits make 243 blocks, two
    # waves of 54 tiles, against one wave of 162 on 81 SMs
    "vae@5184": ((1, 5184, 5184, 1, 512, torch.bfloat16, False), ("wgmma512", 32, 64, 3)),
    # a 1024-px tile's VAE: 289 row blocks over 578 key tiles
    "vae@18496": ((1, 18496, 18496, 1, 512, torch.bfloat16, False), ("wgmma512", 32, 64, 5)),
    # the key-tile edges, one head of one batch, N a multiple of no block
    **{
        f"edge M={m}": ((1, 200, m, 1, 64, torch.bfloat16, False), ("wgmma", keys, 64, 1))
        for m, keys in (
            (1, 80), (77, 80), (79, 80), (80, 80), (81, 112), (143, 144),
            (144, 144), (145, 80), (324, 112), (1296, 144),
        )
    },
    # M = 300: four tiles of 80 give fewer slots than three of 112
    "M=300": ((4, 520, 300, 8, 64, torch.bfloat16, False), ("wgmma", 80, 64, 1)),
    # D=512 at the edges of the 64-row blocks and 32-key tiles, B*H = 2*2:
    # one key tile is never split; two are, where 4 row blocks leave the
    # card nearly empty
    **{
        f"D512 N={n} M={m}": ((2, n, m, 2, 512, torch.bfloat16, False), ("wgmma512", 32, 64, s))
        for n, m, s in (
            (1, 1, 1), (1, 31, 1), (1, 32, 1), (1, 33, 2),
            (63, 1, 1), (63, 31, 1), (63, 32, 1), (63, 33, 2),
            (65, 1, 1), (65, 31, 1), (65, 32, 1), (65, 33, 1),
            (200, 1, 1), (200, 31, 1), (200, 32, 1), (200, 33, 1),
        )
    },
    # what the tensor-core kernels do not take
    "f32 D=64": ((2, 324, 324, 20, 64, torch.float32, False), ("fma", 64, 64, 1)),
    "f32 D=512": ((1, 200, 190, 1, 512, torch.float32, False), ("fma", 32, 32, 1)),
    "unaligned D=64": ((2, 90, 90, 3, 64, torch.bfloat16, True), ("fma", 64, 64, 1)),
    "unaligned D=512": ((2, 90, 90, 3, 512, torch.bfloat16, True), ("fma", 32, 32, 1)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plan_routes_and_tiles(case):
    (b, n, m, h, d, dtype, unaligned), (instance, keys, rows, splits) = CASES[case]
    q, k, v = _views(b, n, m, h, d, dtype, unaligned)
    assert unaligned == (q.data_ptr() % 16 != 0)
    p = attn.plan(q, k, v)
    assert (p.instance, p.keys_per_tile, p.rows_per_cta, p.splits) == (instance, keys, rows, splits)
    # the key tiles cover M, and the last one holds at least one key
    assert p.key_tiles(m) * p.keys_per_tile >= m > (p.key_tiles(m) - 1) * p.keys_per_tile
    # the blocks cover N, once per split; no split is left without keys
    assert p.ctas(b, n, h) * p.rows_per_cta >= n * b * h * p.splits
    assert 1 <= p.splits <= p.key_tiles(m)
    if instance == "wgmma":
        assert keys in attn.WGMMA_KEY_TILES[d] and keys % 16 == 0


@pytest.mark.parametrize(
    "m, keys, tiles, masked",
    [
        (77, 80, 1, 3 / 80),        # cross-attention: 64-key tiles left 51 of 128 slots empty
        (324, 112, 3, 12 / 336),    # self@324: 64-key tiles left 60 of 384
        (1296, 144, 9, 0.0),        # self@1296
    ],
)
def test_masked_share_of_the_main_path(m, keys, tiles, masked):
    p = attn.plan(*_views(2, 324, m, 20, 64))
    assert (p.keys_per_tile, p.key_tiles(m)) == (keys, tiles)
    assert p.masked_share(m) == pytest.approx(masked)
    assert attn.Plan("wgmma", 64, 64).masked_share(m) > p.masked_share(m) or m == 1296


def test_plan_is_pure():
    q, k, v = _views(2, 1296, 77, 10, 64)
    assert attn.plan(q, k, v) == attn.plan(q, k, v)
    assert attn.flash_attention.launches == 0



@pytest.mark.parametrize("row_blocks", [1, 4, 81, 132, 289, 264])
@pytest.mark.parametrize("tiles", [1, 2, 3, 162, 578])
def test_key_splits_never_leave_a_split_empty(row_blocks, tiles):
    s = attn.key_splits(row_blocks, tiles)
    assert 1 <= s <= min(tiles, attn.MAX_KEY_SPLITS)
    if tiles == 1:  # M <= 32, down to M = 1
        assert s == 1
    if row_blocks % attn.H100_SMS == 0:  # whole waves already: splitting only adds merges
        assert s == 1


def test_plan_takes_the_cards_sm_count():
    q, k, v = _views(1, 5184, 5184, 1, 512)
    assert attn.plan(q, k, v).splits == attn.plan(q, k, v, sms=132).splits == 3
    # half the SMs: 81 row blocks already make most of two waves
    assert attn.plan(q, k, v, sms=66).splits == 4
    assert attn.Plan("wgmma512", 32, 64, 3).ctas(1, 5184, 1) == 243
