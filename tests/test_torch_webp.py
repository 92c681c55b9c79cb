"""The port's animated-WEBP writer (utils/webp.py) and SaveAnimatedWEBP,
against PIL, which the CPU tests have and the port does not use: PIL
decodes the port's file to exactly the input frames, with the
frame count, durations and loop of the JAX node's PIL-written lossless
file, and to the same pixels as that file. `lossless=False` keeps the
port's exact pixels where the JAX node writes libwebp's lossy frames (a
deliberate divergence, ROADMAP Queue 3). The container parser reads back
what the writer wrote, and refuses a malformed file.
"""

import io
import os
import types

import numpy as np
import pytest
import torch
from PIL import Image

from comfyui_distributed_tpu.graph import nodes_video as jnodes_video
from comfyui_distributed_tpu_torch.graph import nodes_video
from comfyui_distributed_tpu_torch.utils import image as timg
from comfyui_distributed_tpu_torch.utils import webp


def _decode(data: bytes) -> tuple[np.ndarray, list[int], int | None]:
    """PIL's reading of an animated WEBP: the frames as RGB(A) uint8, each
    frame's duration and the loop count."""
    im = Image.open(io.BytesIO(data))
    frames, durations = [], []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGBA" if "A" in im.mode else "RGB")))
        durations.append(im.info.get("duration"))
    return np.stack(frames), durations, im.info.get("loop")


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("shape", [
    (3, 17, 23, 3),     # odd sizes: padded chunks
    (1, 1, 1, 3),       # one pixel
    (2, 64, 48, 3),     # every byte value: normal codes
    (2, 9, 11, 4),      # alpha
])
def test_pil_decodes_the_frames_exactly(shape):
    frames = _frames(1, shape)
    data = webp.encode_animated_webp(frames, 62)
    decoded, durations, loop = _decode(data)
    np.testing.assert_array_equal(decoded[..., :shape[-1]], frames)
    assert durations == [62] * shape[0] and loop == 0


@pytest.mark.parametrize("name, frames", [
    ("constant", np.full((2, 8, 9, 3), 77, np.uint8)),
    ("two levels", (_frames(2, (2, 5, 6, 3)) % 2 * 200).astype(np.uint8)),
    ("smooth", np.clip(np.cumsum(np.random.default_rng(3).integers(-3, 4, (2, 40, 50, 3)),
                                 axis=2) + 128, 0, 255).astype(np.uint8)),
    ("one channel differs", np.concatenate([np.zeros((1, 6, 7, 2), np.uint8),
                                            _frames(4, (1, 6, 7, 1))], axis=-1)),
])
def test_simple_and_skewed_histograms_decode_exactly(name, frames):
    """One- and two-symbol codes (simple codes), a code-length code of
    one used length, and skewed histograms that need the 15-bit limit."""
    decoded, _, _ = _decode(webp.encode_animated_webp(frames, 100))
    np.testing.assert_array_equal(decoded, frames)


def test_a_long_tailed_histogram_keeps_codes_within_15_bits():
    """Fibonacci counts make a Huffman tree 19 deep: the code is limited
    to 15 bits, stays complete (as the decoder requires) and decodes."""
    fib = [1, 1]
    while len(fib) < 20:
        fib.append(fib[-1] + fib[-2])
    counts = np.zeros(256, np.int64)
    counts[:20] = fib
    lengths = webp._huffman_lengths(counts, webp.MAX_CODE_LENGTH)
    assert lengths.max() <= 15 and np.all(lengths[:20] > 0) and np.all(lengths[20:] == 0)
    assert sum(2.0 ** -lengths[:20]) == 1.0
    assert webp._huffman_lengths(counts, 32).max() == 19  # unlimited, the tree's depth
    pixels = np.repeat(np.arange(20, dtype=np.uint8), fib)  # 17710 pixels
    frame = np.zeros(133 * 134, np.uint8)
    frame[:len(pixels)] = np.random.default_rng(10).permutation(pixels)
    frame = np.repeat(frame.reshape(1, 133, 134, 1), 3, axis=-1)
    np.testing.assert_array_equal(_decode(webp.encode_animated_webp(frame, 50))[0], frame)


def _save(module, context, images, **kwargs):
    return module.SaveAnimatedWEBP().save(images, "clip", context=context, **kwargs)[0]


def test_the_node_matches_the_jax_nodes_lossless_file(tmp_path):
    """Frames, durations and loop as PIL reads the JAX node's file, the
    same pixels, and the same counter-scanned name and UI."""
    images = timg.u8_to_f32(_frames(5, (4, 20, 30, 3)))
    out = {}
    for name, module, value in (("port", nodes_video, torch.from_numpy(images)),
                                ("jax", jnodes_video, images)):
        context = types.SimpleNamespace(config={"settings": {"output_dir": str(tmp_path / name)}})
        first = _save(module, context, value, fps=16)
        second = _save(module, context, value, fps=16)
        with open(os.path.join(str(tmp_path / name), second["ui"]["images"][0]), "rb") as fh:
            out[name] = (first["ui"], second["ui"], _decode(fh.read()))
    assert out["port"][:2] == out["jax"][:2]
    assert out["port"][1] == {"images": ["clip_00001.webp"], "fps": 16}
    (frames, durations, loop), (jframes, jdurations, jloop) = out["port"][2], out["jax"][2]
    np.testing.assert_array_equal(frames, jframes)
    np.testing.assert_array_equal(frames, timg.f32_to_u8(images))
    assert durations == jdurations == [62] * 4 and loop == jloop == 0


def test_lossless_false_keeps_the_exact_pixels_where_the_jax_node_goes_lossy(tmp_path):
    """The divergence ROADMAP Queue 3 records: the JAX node's
    lossless=False file (libwebp's lossy VP8) does not give the input
    back; the port's does, in a larger file."""
    images = timg.u8_to_f32(_frames(6, (2, 32, 32, 3)))
    files = {}
    for name, module, value in (("port", nodes_video, torch.from_numpy(images)),
                                ("jax", jnodes_video, images)):
        context = types.SimpleNamespace(config={"settings": {"output_dir": str(tmp_path / name)}})
        ui = _save(module, context, value, fps=8, lossless=False, quality=80)["ui"]
        with open(os.path.join(str(tmp_path / name), ui["images"][0]), "rb") as fh:
            files[name] = fh.read()
    u8 = timg.f32_to_u8(images)
    port_frames, port_durations, _ = _decode(files["port"])
    jax_frames, jax_durations, _ = _decode(files["jax"])
    np.testing.assert_array_equal(port_frames, u8)
    assert not np.array_equal(jax_frames, u8)
    assert port_durations == jax_durations == [125, 125]
    assert len(files["port"]) > len(files["jax"])
    assert [f["vp8l_header"] for f in webp.read_container(files["port"])["frames"]] == [
        (32, 32, 0, 0)] * 2


def test_a_gray_batch_is_written_as_rgb(tmp_path):
    gray = timg.u8_to_f32(_frames(7, (2, 6, 5, 1)))
    context = types.SimpleNamespace(config={"settings": {"output_dir": str(tmp_path)}})
    ui = _save(nodes_video, context, torch.from_numpy(gray), fps=10)["ui"]
    with open(os.path.join(str(tmp_path), ui["images"][0]), "rb") as fh:
        frames, _, _ = _decode(fh.read())
    np.testing.assert_array_equal(frames, np.repeat(timg.f32_to_u8(gray), 3, axis=-1))


def test_the_container_reads_back_what_was_written():
    frames = _frames(8, (3, 7, 10, 3))
    data = webp.encode_animated_webp(frames, 40, loop=2)
    info = webp.read_container(data)
    assert info["riff_size"] == len(data) - 8 == info["file_size"] - 8
    assert info["flags"] == 0x02 and info["canvas"] == (10, 7) and info["loop"] == 2
    assert [(f["x"], f["y"], f["size"], f["duration"], f["flags"], f["vp8l_header"])
            for f in info["frames"]] == [(0, 0, (10, 7), 40, 0x02, (10, 7, 0, 0))] * 3
    assert webp.read_container(webp.encode_animated_webp(_frames(9, (1, 4, 4, 4)), 40)
                               )["flags"] == 0x12


@pytest.mark.parametrize("bad", [b"RIFX" + b"\0" * 20, b"RIFF\0\0\0\0WEBPVP8X\x0a\0\0\0\0"])
def test_the_container_parser_refuses_a_malformed_file(bad):
    with pytest.raises(ValueError):
        webp.read_container(bad)


@pytest.mark.parametrize("frames", [np.zeros((1, 4, 4, 3), np.float32),
                                    np.zeros((0, 4, 4, 3), np.uint8),
                                    np.zeros((1, 4, 4, 2), np.uint8),
                                    np.zeros((1, 1, (1 << 14) + 1, 3), np.uint8)])
def test_the_writer_refuses_what_vp8l_cannot_hold(frames):
    with pytest.raises(ValueError):
        webp.encode_animated_webp(frames, 10)
