"""The attention router (`ops/attention.py::plan`) on the CPU.

`plan` decides which compiled kernel takes a call, from the inputs'
dtype, shapes, strides and alignment alone, so it is checked here
without a card: every attention shape of the SDXL upscale path, the
edges of the wgmma instance's key tiles, f32, an unaligned view and the
VAE's D=512. The kernels themselves are held to their plain version on
the card (tests/test_torch_attention_cuda.py, chip_smoke.py).
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


# (B, N, M, H, D, dtype, unaligned) -> (instance, keys per tile, rows per block)
CASES = {
    # the main path of one 576-px SDXL tile
    "self@1296": ((2, 1296, 1296, 10, 64, torch.bfloat16, False), ("wgmma", 144, 64)),
    "cross@1296": ((2, 1296, 77, 10, 64, torch.bfloat16, False), ("wgmma", 80, 64)),
    "self@324": ((2, 324, 324, 20, 64, torch.bfloat16, False), ("wgmma", 112, 64)),
    "cross@324": ((2, 324, 77, 20, 64, torch.bfloat16, False), ("wgmma", 80, 64)),
    "vae@5184": ((1, 5184, 5184, 1, 512, torch.bfloat16, False), ("mma", 32, 32)),
    # the key-tile edges, one head of one batch, N a multiple of no block
    **{
        f"edge M={m}": ((1, 200, m, 1, 64, torch.bfloat16, False), ("wgmma", keys, 64))
        for m, keys in (
            (1, 80), (77, 80), (79, 80), (80, 80), (81, 112), (143, 144),
            (144, 144), (145, 80), (324, 112), (1296, 144),
        )
    },
    # M = 300: four tiles of 80 give fewer slots than three of 112
    "M=300": ((4, 520, 300, 8, 64, torch.bfloat16, False), ("wgmma", 80, 64)),
    # what the tensor-core kernels do not take
    "f32 D=64": ((2, 324, 324, 20, 64, torch.float32, False), ("fma", 64, 64)),
    "f32 D=512": ((1, 200, 190, 1, 512, torch.float32, False), ("fma", 32, 32)),
    "unaligned D=64": ((2, 90, 90, 3, 64, torch.bfloat16, True), ("fma", 64, 64)),
    "unaligned D=512": ((2, 90, 90, 3, 512, torch.bfloat16, True), ("fma", 32, 32)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plan_routes_and_tiles(case):
    (b, n, m, h, d, dtype, unaligned), (instance, keys, rows) = CASES[case]
    q, k, v = _views(b, n, m, h, d, dtype, unaligned)
    assert unaligned == (q.data_ptr() % 16 != 0)
    p = attn.plan(q, k, v)
    assert (p.instance, p.keys_per_tile, p.rows_per_cta) == (instance, keys, rows)
    # the key tiles cover M, and the last one holds at least one key
    assert p.key_tiles(m) * p.keys_per_tile >= m > (p.key_tiles(m) - 1) * p.keys_per_tile
    # the blocks cover N
    assert p.ctas(b, n, h) * p.rows_per_cta >= n * b * h
    if instance == "wgmma":
        assert keys in attn.WGMMA_KEY_TILES and keys % 16 == 0


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

