"""The port's PNG codec (comfyui_distributed_tpu_torch/utils/image.py)
against the JAX package's PIL-based one, and the LoadImage/SaveImage
nodes that now use it. Bytes ↔ pixels must be exact.
"""

import base64
import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from comfyui_distributed_tpu.native import f32_to_u8 as jax_f32_to_u8
from comfyui_distributed_tpu.utils import image as jimg
from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
from comfyui_distributed_tpu_torch.utils import image as timg

SHAPES = [(17, 23, 1), (16, 20, 3), (9, 31, 4)]


def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _pil_image(u8):
    mode = {1: "L", 3: "RGB", 4: "RGBA"}[u8.shape[-1]]
    return Image.fromarray(u8[..., 0] if u8.shape[-1] == 1 else u8, mode=mode)


@pytest.mark.parametrize("shape", SHAPES)
def test_port_decodes_the_jax_encoder_exactly(shape):
    u8 = _u8(0, shape)
    data = jimg.encode_png(u8.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(timg.decode_png_u8(data), u8)
    np.testing.assert_array_equal(timg.decode_png(data), jimg.decode_png(data))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("level", [0, 6])
def test_jax_decodes_the_port_encoder_exactly(shape, level):
    u8 = _u8(1, shape)
    data = timg.encode_png(u8.astype(np.float32) / 255.0, compress_level=level)
    np.testing.assert_array_equal(timg.u8_to_f32(u8), jimg.decode_png(data))
    with Image.open(io.BytesIO(data)) as img:
        got = np.asarray(img)
    np.testing.assert_array_equal(got.reshape(shape), u8)


def test_float_to_u8_rounding_is_the_jax_packages():
    """Edges of every level, out-of-range values and the exact halves."""
    rng = np.random.default_rng(2)
    x = np.concatenate([
        rng.random(4096, dtype=np.float32) * 1.2 - 0.1,
        (np.arange(256, dtype=np.float32) + 0.5) / 255.0,
        np.arange(256, dtype=np.float32) / 255.0,
        np.array([-1.0, 0.0, 1.0, 2.0, np.nextafter(np.float32(1), np.float32(0))],
                 dtype=np.float32),
    ])
    np.testing.assert_array_equal(timg.f32_to_u8(x), jax_f32_to_u8(x))
    img = x[:4096].reshape(32, 128, 1)
    assert timg.decode_png_u8(timg.encode_png(img)).tobytes() == jax_f32_to_u8(img).tobytes()


def _png_with_filter(u8, kind):
    """u8 [H, W, C] written with row filter `kind` on every row (the
    PNG spec's filters, computed here independently of the decoder)."""
    h, w, c = u8.shape
    raw = u8.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        line, prior = raw[y], raw[y - 1] if y else np.zeros(w * c, np.int32)
        left = np.concatenate([np.zeros(c, np.int32), line[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int32), prior[:-c]])
        if kind == 0:
            pred = np.zeros_like(line)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - up_left
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, up_left))
        rows.append(bytes([kind]) + ((line - pred) % 256).astype(np.uint8).tobytes())

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(
            ">I", zlib.crc32(tag + body) & 0xFFFFFFFF)

    color = {1: 0, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_decoder_undoes_every_row_filter(kind, shape):
    u8 = _u8(3, shape)
    data = _png_with_filter(u8, kind)
    with Image.open(io.BytesIO(data)) as img:  # the oracle reads the same file
        np.testing.assert_array_equal(np.asarray(img).reshape(shape), u8)
    np.testing.assert_array_equal(timg.decode_png_u8(data), u8)


@pytest.mark.parametrize("shape", SHAPES)
def test_decoder_reads_what_pil_writes_at_every_level(shape):
    """PIL picks its own filters per row (adaptive above level 0)."""
    ramp = np.linspace(0, 255, shape[0] * shape[1] * shape[2]).reshape(shape)
    u8 = (ramp + _u8(4, shape) % 7).clip(0, 255).astype(np.uint8)
    for level in (0, 1, 6, 9):
        buf = io.BytesIO()
        _pil_image(u8).save(buf, format="PNG", compress_level=level)
        np.testing.assert_array_equal(timg.decode_png_u8(buf.getvalue()), u8)


def test_data_url_round_trip_and_envelope():
    img = _u8(5, (12, 10, 3)).astype(np.float32) / 255.0
    url = timg.encode_image_data_url(img)
    assert url.startswith("data:image/png;base64,")
    np.testing.assert_array_equal(timg.decode_image_data_url(url), img)
    np.testing.assert_array_equal(jimg.decode_image_data_url(url), img)
    bare = base64.b64encode(jimg.encode_png(img)).decode()
    np.testing.assert_array_equal(timg.decode_image_data_url(bare), img)


def test_tensors_and_batches_of_one_encode_like_arrays():
    img = _u8(6, (1, 8, 8, 3)).astype(np.float32) / 255.0
    data = timg.encode_png(torch.from_numpy(img))
    assert data == timg.encode_png(img[0])
    with pytest.raises(ValueError, match="single image"):
        timg.encode_png(np.zeros((2, 8, 8, 3), np.float32))


def test_decoder_refuses_what_it_does_not_read():
    with pytest.raises(ValueError, match="not a PNG"):
        timg.decode_png(b"GIF89a")
    eight_bit = _png_with_filter(_u8(8, (4, 4, 1)), 0)
    # the same file with its IHDR saying 16-bit samples (CRC fixed up)
    header = bytearray(eight_bit[16:29])
    header[8] = 16
    sixteen_bit = (eight_bit[:16] + bytes(header)
                   + struct.pack(">I", zlib.crc32(b"IHDR" + bytes(header)) & 0xFFFFFFFF)
                   + eight_bit[33:])
    with pytest.raises(ValueError, match="bit depth 16"):
        timg.decode_png(sixteen_bit)


def test_load_image_reads_pil_and_port_files_alike_and_save_image_writes_png(tmp_path):
    """LoadImage of a PNG that PIL wrote and of one the port wrote gives
    the same array; SaveImage's file reads back through PIL."""
    u8 = _u8(7, (20, 24, 4))
    (tmp_path / "in").mkdir()
    _pil_image(u8).save(tmp_path / "in" / "pil.png", format="PNG", compress_level=6)
    (tmp_path / "in" / "port.png").write_bytes(timg.encode_png_u8(u8))
    config = {"settings": {"input_dir": str(tmp_path / "in"), "output_dir": str(tmp_path / "out")}}
    context = ExecutionContext(device="cpu", config=config)
    prompt = {
        "1": {"class_type": "LoadImage", "inputs": {"image": "pil.png"}},
        "2": {"class_type": "LoadImage", "inputs": {"image": "port.png"}},
        "3": {"class_type": "SaveImage", "inputs": {"images": ["1", 0], "filename_prefix": "t"}},
    }
    executor = GraphExecutor(context)
    outputs = executor.execute(prompt)
    (a, mask_a), (b, mask_b) = executor.last_results["1"], executor.last_results["2"]
    assert a.shape == (1, 20, 24, 3) and a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(mask_a, mask_b, rtol=0, atol=0)
    np.testing.assert_array_equal(a[0].numpy(), u8[..., :3].astype(np.float32) / 255.0)
    np.testing.assert_array_equal(mask_a[0].numpy(), 1.0 - u8[..., 3].astype(np.float32) / 255.0)
    assert outputs["3"][0]["ui"]["images"] == ["t_00000.png"]
    with Image.open(tmp_path / "out" / "t_00000.png") as saved:
        np.testing.assert_array_equal(np.asarray(saved), u8[..., :3])
