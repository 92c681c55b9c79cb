"""chip_smoke.py's tiled-decode tolerance, held on the CPU from both sides.

The card's `usdu_full` phase bounds the mean |diff| on [0, 1] pixels
between a tile's latents decoded in pieces (`ops/tiled_vae.py::
decode_tiled`, GroupNorm statistics per piece) and decoded whole, by
`chip_smoke.TILED_DECODE_TOLERANCE`. Here the SD VAE at full width
(`vae-sd`, seeded random init, bf16 as on the card) decodes 18-latent
planes cut as USDU's 72-latent tile is cut (a tile of 8/9 of the side and
1/9 of overlap: a 2 x 2 grid) both ways. The right decode must land under
the tolerance, and a decode with its pieces placed wrong over it:

- "transposed": the pieces blended in column-major order (the top-right
  and bottom-left pieces swapped);
- "shifted": each piece off its place by the overlap.

Measured on a CPU (mean |diff|): right 0.0546 (an encoded image) and
0.0398 (N(0, 1) latents); transposed 0.1244 and 0.1383; shifted 0.1281
and 0.1400. The card read 0.0164 on a 72-latent tile.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import chip_smoke
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.ops import tiled_vae as ttvae
from test_torch_parity import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIDE = 18  # latents; 144 px


@functools.lru_cache(maxsize=1)
def _vae():
    return tpl.load_vae("vae-sd", seed=0, device="cpu").vae


@functools.lru_cache(maxsize=None)
def _latents_and_whole(kind: str):
    rng = np.random.default_rng(0)
    with torch.no_grad():
        if kind == "encoded image":
            image = torch.from_numpy(rng.random((1, SIDE * 8, SIDE * 8, 3), dtype=np.float32))
            latents = _vae().encode(image).float()
        else:
            latents = torch.from_numpy(rng.standard_normal((1, SIDE, SIDE, 4),
                                                           dtype=np.float32))
        return latents, _vae().decode(latents).float()


def _plant(monkeypatch, fault: str) -> None:
    if fault == "transposed":
        extract = ttvae.tile_ops.extract_tiles

        def column_major(images, grid):
            assert (grid.rows, grid.cols) == (2, 2)
            return extract(images, grid)[torch.tensor([0, 2, 1, 3])]

        monkeypatch.setattr(ttvae.tile_ops, "extract_tiles", column_major)
    elif fault == "shifted":
        scaled = ttvae._scaled_grid

        def shifted(grid, h, w, scale):
            out = scaled(grid, h, w, scale)
            return dataclasses.replace(out, positions=tuple(
                (max(0, y - out.padding), x) for y, x in out.positions))

        monkeypatch.setattr(ttvae, "_scaled_grid", shifted)


@pytest.mark.parametrize("kind", ["encoded image", "N(0, 1)"])
@pytest.mark.parametrize("fault", [None, "transposed", "shifted"])
def test_the_tolerance_sits_between_the_right_and_a_broken_tiled_decode(kind, fault,
                                                                         monkeypatch):
    latents, whole = _latents_and_whole(kind)
    _plant(monkeypatch, fault)
    tiled = ttvae.decode_tiled(_vae(), latents, tile=SIDE * 8 // 9, overlap=SIDE // 9).float()
    mean = float((tiled - whole).abs().mean())
    if fault is None:
        assert 0 < mean < chip_smoke.TILED_DECODE_TOLERANCE
    else:
        assert mean > chip_smoke.TILED_DECODE_TOLERANCE
