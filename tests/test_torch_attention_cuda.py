"""The Hopper flash-attention kernel against its plain version, on the card.

These tests need an NVIDIA GPU with nvcc and skip elsewhere. The file
imports no JAX, so on a GPU machine without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_attention_cuda.py -q

Tolerances: both sides accumulate in f32 from the same inputs and differ
in summation order (~1e-6 relative); bf16 outputs may then round one
bf16 step apart, hence 2^-7 relative.
"""

import pytest
import torch

from comfyui_distributed_tpu_torch.ops import attention as attn

pytestmark = pytest.mark.cuda

SHAPES = [
    # (B, N, M, H, D): main-path shapes, then ragged edges of the tiling
    (2, 1296, 1296, 10, 64),
    (2, 1296, 77, 10, 64),
    (2, 324, 324, 20, 64),
    (2, 324, 77, 20, 64),
    (1, 5184, 5184, 1, 512),
    (1, 1, 1, 1, 64),
    (3, 65, 63, 2, 64),
    (1, 33, 31, 1, 512),
    (2, 70, 100, 2, 512),
    # SD1.5's txt2img at 512 px: D = 40, 80, 160 on the wgmma instance
    (2, 4096, 4096, 8, 40),
    (2, 4096, 77, 8, 40),
    (2, 1024, 1024, 8, 80),
    (2, 1024, 77, 8, 80),
    (2, 256, 256, 8, 160),
    (2, 256, 77, 8, 160),
    (2, 64, 64, 8, 160),
    (2, 64, 77, 8, 160),
]

# key counts at the edges of the wgmma instance's key tiles (80, 112, 144)
EDGE_KEYS = (1, 77, 79, 80, 81, 143, 144, 145, 324, 1296)
# query and key counts at the edges of the wgmma512 instance's 64-row
# blocks and 32-key tiles
EDGE_ROWS_512 = (1, 63, 65, 200)
EDGE_KEYS_512 = (1, 31, 32, 33)
# query and key counts at the edges of the wgmma instance's 64-row blocks
# and its key tiles at D = 40, 80 and 160 (64, 80, 128)
EDGE_ROWS_WG = (1, 63, 64, 65, 200)
EDGE_KEYS_WG = (1, 63, 64, 65, 77, 79, 80, 81, 127, 128, 129)
# query and key counts at the edges of D = 40's two-consumer blocks (128
# rows, consumer 1 on rows 64-127) and 128-key tiles
EDGE_ROWS_PINGPONG = (1, 63, 64, 65, 127, 128, 129, 200)
EDGE_KEYS_PINGPONG = (1, 77, 127, 128, 129, 257)
TXT2IMG_HEAD_DIMS = (40, 80, 160)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel is CUDA C++ with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's f32 products
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b, n, m, h, d", SHAPES)
def test_kernel_matches_plain(cuda, b, n, m, h, d, dtype):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n * 31 + m)
    q, k, v = (
        torch.randn(s, generator=gen, device=cuda).to(dtype)
        for s in ((b, n, h, d), (b, m, h, d), (b, m, h, d))
    )
    instance = attn.plan(q, k, v).instance
    assert instance == ("fma" if dtype == torch.float32 else "wgmma512" if d == 512
                        else "wgmma")
    before = attn.flash_attention.launches
    by_instance = attn.flash_attention.launches_by_instance[instance]
    out = attn.dot_product_attention(q, k, v)
    assert attn.flash_attention.launches == before + 1
    assert attn.flash_attention.launches_by_instance[instance] == by_instance + 1
    ref = attn.flash_attention_reference(q, k, v)
    rtol, atol = (2.0**-7, 1e-3) if dtype == torch.bfloat16 else (1e-5, 2e-5)
    assert out.dtype == dtype and out.shape == (b, n, h, d)
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)


def test_kernel_reads_strided_heads(cuda):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    fused = torch.randn((2, 100, 3, 4, 64), generator=gen, device=cuda).bfloat16()
    q, k, v = fused.unbind(2)
    assert attn.plan(q, k, v).instance == "wgmma"
    torch.testing.assert_close(
        attn.flash_attention(q, k, v).float(),
        attn.flash_attention_reference(q, k, v).float(),
        rtol=2.0**-7, atol=1e-3,
    )


@pytest.mark.parametrize("d", [40, 64, 80, 160, 512])
def test_kernel_reads_unaligned_rows(cuda, d):
    # rows 2 bytes off a 16-byte boundary, with a (d + 1)-element row
    # stride: the tensor-core kernel's 16-byte copies cannot read these,
    # the FMA kernel takes them
    gen = torch.Generator(device=cuda)
    gen.manual_seed(11)
    wide = torch.randn((3, 2, 90, 3, d + 1), generator=gen, device=cuda).bfloat16()
    q, k, v = (t[..., 1:] for t in wide.unbind(0))
    assert q.data_ptr() % 16 != 0 and q.stride(2) == d + 1
    assert attn.plan(q, k, v).instance == "fma"
    torch.testing.assert_close(
        attn.flash_attention(q, k, v).float(),
        attn.flash_attention_reference(q, k, v).float(),
        rtol=2.0**-7, atol=1e-3,
    )


def _wgmma_matches_plain(cuda, b, n, m, h, p, seed):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    q, k, v = (
        torch.randn(s, generator=gen, device=cuda).bfloat16()
        for s in ((b, n, h, 64), (b, m, h, 64), (b, m, h, 64))
    )
    assert attn.plan(q, k, v).instance == "wgmma"
    before = attn.flash_attention.launches_by_instance["wgmma"]
    out = attn.flash_attention(q, k, v, with_plan=p)
    assert attn.flash_attention.launches_by_instance["wgmma"] == before + 1
    torch.testing.assert_close(
        out.float(), attn.flash_attention_reference(q, k, v).float(), rtol=2.0**-7, atol=1e-3
    )


@pytest.mark.parametrize("m", EDGE_KEYS)
def test_wgmma_key_tile_edges(cuda, m):
    # the router's key tile for M, one head of one batch (B * H = 1), and
    # N = 200, not a multiple of the block's 64 query rows
    _wgmma_matches_plain(cuda, 1, 200, m, 1, None, seed=m)


@pytest.mark.parametrize("keys", attn.WGMMA_KEY_TILES[64])
def test_wgmma_every_compiled_tile(cuda, keys):
    # every compiled key tile, over several tiles with a ragged last
    p = attn.Plan("wgmma", keys, attn.WGMMA_ROWS)
    _wgmma_matches_plain(cuda, 2, 300, 333, 3, p, seed=keys)


def test_wgmma_reads_rows_on_16_not_128_byte_boundaries(cuda):
    # rows start 16 bytes into a 144-byte pitch: TMA's 16-byte rule holds,
    # the 128-byte swizzle atom is not aligned to them in device memory
    gen = torch.Generator(device=cuda)
    gen.manual_seed(13)
    wide = torch.randn((3, 2, 150, 3, 72), generator=gen, device=cuda).bfloat16()
    q, k, v = (t[..., 8:] for t in wide.unbind(0))
    assert q.data_ptr() % 128 == 16 and q.stride(2) == 72
    assert attn.plan(q, k, v).instance == "wgmma"
    torch.testing.assert_close(
        attn.flash_attention(q, k, v).float(),
        attn.flash_attention_reference(q, k, v).float(),
        rtol=2.0**-7, atol=1e-3,
    )


def _wgmma512_matches_plain(cuda, b, n, m, h, p, seed, qkv=None):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    if qkv is None:
        qkv = (
            torch.randn(s, generator=gen, device=cuda).bfloat16()
            for s in ((b, n, h, 512), (b, m, h, 512), (b, m, h, 512))
        )
    q, k, v = qkv
    assert attn.plan(q, k, v).instance == "wgmma512"
    before = attn.flash_attention.launches_by_instance["wgmma512"]
    out = attn.flash_attention(q, k, v, with_plan=p)
    assert attn.flash_attention.launches_by_instance["wgmma512"] == before + 1
    torch.testing.assert_close(
        out.float(), attn.flash_attention_reference(q, k, v).float(), rtol=2.0**-7, atol=1e-3
    )
    return q, k, v, out


@pytest.mark.parametrize("m", EDGE_KEYS_512)
@pytest.mark.parametrize("n", EDGE_ROWS_512)
def test_wgmma512_tile_edges(cuda, n, m):
    # the router's plan, B * H = 2 * 2, at the edges of the row blocks and
    # key tiles: few keys share the weight, where one bf16 P would miss
    _wgmma512_matches_plain(cuda, 2, n, m, 2, None, seed=n * 7 + m)


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 10])
def test_wgmma512_every_split(cuda, splits):
    # the compiled key tile over 10 tiles with a ragged last, split over
    # 1 to 10 blocks (every split keeps at least one tile)
    p = attn.Plan("wgmma512", attn.WGMMA512_KEYS, attn.WGMMA_ROWS, splits)
    q, k, v, out = _wgmma512_matches_plain(cuda, 2, 130, 300, 2, p, seed=splits)
    # and against the plain version of the same splits and merge
    torch.testing.assert_close(
        out.float(), attn.split_attention_reference(q, k, v, splits).float(),
        rtol=2.0**-7, atol=1e-3,
    )


def test_wgmma512_refuses_more_splits_than_key_tiles(cuda):
    q = torch.zeros((1, 64, 1, 512), device=cuda, dtype=torch.bfloat16)
    p = attn.Plan("wgmma512", attn.WGMMA512_KEYS, attn.WGMMA_ROWS, 3)
    with pytest.raises(RuntimeError, match="more key splits than key tiles"):
        attn.flash_attention(q, q, q, with_plan=p)  # M = 64: two key tiles


def test_wgmma512_reads_strided_heads(cuda):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(17)
    fused = torch.randn((2, 150, 3, 2, 512), generator=gen, device=cuda).bfloat16()
    q, k, v = fused.unbind(2)
    p = attn.Plan("wgmma512", attn.WGMMA512_KEYS, attn.WGMMA_ROWS, 2)
    _wgmma512_matches_plain(cuda, 2, 150, 150, 2, None, seed=0, qkv=(q, k, v))
    _wgmma512_matches_plain(cuda, 2, 150, 150, 2, p, seed=0, qkv=(q, k, v))


def test_wgmma512_reads_rows_on_16_not_128_byte_boundaries(cuda):
    # rows start 16 bytes into a 1040-byte pitch
    gen = torch.Generator(device=cuda)
    gen.manual_seed(19)
    wide = torch.randn((3, 2, 100, 2, 520), generator=gen, device=cuda).bfloat16()
    q, k, v = (t[..., 8:] for t in wide.unbind(0))
    assert q.data_ptr() % 128 == 16 and q.stride(2) == 520
    _wgmma512_matches_plain(cuda, 2, 100, 100, 2, None, seed=0, qkv=(q, k, v))


def _headdim_matches_plain(cuda, q, k, v, p=None):
    assert attn.plan(q, k, v).instance == "wgmma"
    before = attn.flash_attention.launches_by_instance["wgmma"]
    out = attn.flash_attention(q, k, v, with_plan=p)
    assert attn.flash_attention.launches_by_instance["wgmma"] == before + 1
    torch.testing.assert_close(
        out.float(), attn.flash_attention_reference(q, k, v).float(), rtol=2.0**-7, atol=1e-3
    )


@pytest.mark.parametrize("d", TXT2IMG_HEAD_DIMS)
@pytest.mark.parametrize("m", EDGE_KEYS_WG)
@pytest.mark.parametrize("n", EDGE_ROWS_WG)
def test_wgmma_head_dim_tile_edges(cuda, n, m, d):
    # one head of one batch, at the edges of the row blocks and of the key
    # tiles the router picks at this head dim
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n * 1009 + m * 7 + d)
    q, k, v = (
        torch.randn(s, generator=gen, device=cuda).bfloat16()
        for s in ((1, n, 1, d), (1, m, 1, d), (1, m, 1, d))
    )
    _headdim_matches_plain(cuda, q, k, v)


@pytest.mark.parametrize("d, p", [(d, p) for d in TXT2IMG_HEAD_DIMS for p in attn.wgmma_plans(d)],
                         ids=lambda x: str(x) if isinstance(x, int) else f"k{x.keys_per_tile}"
                                                                      f"r{x.rows_per_cta}")
def test_wgmma_head_dim_every_compiled_plan(cuda, d, p):
    # every compiled key tile and consumer count, over several key tiles
    # with a ragged last and N a multiple of no block
    gen = torch.Generator(device=cuda)
    gen.manual_seed(d * 31 + p.keys_per_tile + p.rows_per_cta)
    q, k, v = (
        torch.randn(s, generator=gen, device=cuda).bfloat16()
        for s in ((2, 300, 3, d), (2, 333, 3, d), (2, 333, 3, d))
    )
    _headdim_matches_plain(cuda, q, k, v, p)


@pytest.mark.parametrize("m", EDGE_KEYS_PINGPONG)
@pytest.mark.parametrize("n", EDGE_ROWS_PINGPONG)
def test_wgmma_two_consumer_tile_edges(cuda, n, m):
    # D = 40's two-consumer plan at the edges of its blocks and key tiles,
    # one head of one batch: consumer 1 with no, some or all rows valid,
    # one key tile (the first is also the last) or several
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n * 1013 + m)
    q, k, v = (
        torch.randn(s, generator=gen, device=cuda).bfloat16()
        for s in ((1, n, 1, 40), (1, m, 1, 40), (1, m, 1, 40))
    )
    p = attn.Plan("wgmma", attn.WGMMA_PINGPONG_KEYS[40], 2 * attn.WGMMA_ROWS)
    _headdim_matches_plain(cuda, q, k, v, p)


@pytest.mark.parametrize("d", TXT2IMG_HEAD_DIMS)
def test_wgmma_head_dim_reads_strided_heads(cuda, d):
    # q, k and v as views into one fused [B, N, 3, H, D] buffer: a D = 40
    # head starts 80 bytes after the last
    gen = torch.Generator(device=cuda)
    gen.manual_seed(23 + d)
    fused = torch.randn((2, 150, 3, 4, d), generator=gen, device=cuda).bfloat16()
    _headdim_matches_plain(cuda, *fused.unbind(2))


@pytest.mark.parametrize("d", TXT2IMG_HEAD_DIMS)
def test_wgmma_head_dim_reads_rows_on_16_not_128_byte_boundaries(cuda, d):
    # rows start 16 bytes into a (D + 8)-element pitch: TMA's 16-byte rule
    # holds, the swizzle atoms are not aligned to them in device memory
    gen = torch.Generator(device=cuda)
    gen.manual_seed(29 + d)
    wide = torch.randn((3, 2, 100, 2, d + 8), generator=gen, device=cuda).bfloat16()
    q, k, v = (t[..., 8:] for t in wide.unbind(0))
    assert q.data_ptr() % 128 == 16 and q.stride(2) == d + 8
    _headdim_matches_plain(cuda, q, k, v)
