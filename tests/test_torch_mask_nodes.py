"""The mask nodes (graph/nodes_mask.py) in the port against the JAX
package's, on the CPU: the same numpy-seeded inputs through both, every
output compared. Tolerance: 1e-5 relative to the largest |x| of the JAX
output (pure node math in f32; GrowMask's morphology and the boolean
composites compare exactly in practice).
"""

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.graph import nodes_mask as jmask
from comfyui_distributed_tpu_torch.graph import ExecutionContext
from comfyui_distributed_tpu_torch.graph import nodes_mask as tmask
from test_torch_image_nodes import run_both
from test_torch_parity import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RNG = np.random.default_rng(31)
MASK = RNG.random((2, 9, 11), dtype=np.float32)
SRC = RNG.random((1, 5, 4), dtype=np.float32)
BINARY = (RNG.random((1, 12, 10)) > 0.7).astype(np.float32)
IMAGE = RNG.random((2, 9, 11, 3), dtype=np.float32)
RGBA = RNG.random((1, 9, 11, 4), dtype=np.float32)
SOURCE = RNG.random((1, 6, 7, 3), dtype=np.float32)
LATENT = RNG.standard_normal((1, 6, 8, 4), dtype=np.float32)
SMALL_LATENT = RNG.standard_normal((1, 3, 3, 4), dtype=np.float32)
PAIR = (jmask, tmask)

CASES = {
    "InvertMask": ("InvertMask", "invert", dict(mask=MASK)),
    "CropMask": ("CropMask", "crop", dict(mask=MASK, x=3, y=2, width=5, height=40)),
    "MaskToImage": ("MaskToImage", "mask_to_image", dict(mask=MASK)),
    "ImageToMask-green": ("ImageToMask", "image_to_mask", dict(image=IMAGE, channel="green")),
    "ImageToMask-alpha": ("ImageToMask", "image_to_mask", dict(image=RGBA, channel="alpha")),
    "ThresholdMask": ("ThresholdMask", "image_to_mask", dict(mask=MASK, value=0.35)),
    "FeatherMask": ("FeatherMask", "feather", dict(mask=MASK, left=3, top=0, right=20,
                                                   bottom=2)),
    "JoinImageWithAlpha": ("JoinImageWithAlpha", "join_image_with_alpha",
                           dict(image=IMAGE, alpha=SRC)),
    "SplitImageWithAlpha-rgba": ("SplitImageWithAlpha", "split_image_with_alpha",
                                 dict(image=RGBA)),
    "SplitImageWithAlpha-rgb": ("SplitImageWithAlpha", "split_image_with_alpha",
                                dict(image=IMAGE)),
    "ImageCompositeMasked": ("ImageCompositeMasked", "composite",
                             dict(destination=IMAGE, source=SOURCE, x=-2, y=5, mask=SRC)),
    "ImageCompositeMasked-resize": ("ImageCompositeMasked", "composite",
                                    dict(destination=IMAGE, source=SOURCE, x=0, y=0,
                                         resize_source=True)),
    "ImageCompositeMasked-outside": ("ImageCompositeMasked", "composite",
                                     dict(destination=IMAGE, source=SOURCE, x=40, y=0)),
    "LatentCompositeMasked": ("LatentCompositeMasked", "composite",
                              dict(destination={"samples": LATENT},
                                   source={"samples": SMALL_LATENT}, x=20, y=-8,
                                   mask=RNG.random((3, 3), dtype=np.float32))),
}
for op in tmask.MaskComposite.OPERATIONS:
    CASES[f"MaskComposite-{op}"] = ("MaskComposite", "combine",
                                    dict(destination=MASK, source=SRC, x=6, y=-1, operation=op))
for expand in (-2, 0, 3):
    for tapered in (True, False):
        CASES[f"GrowMask-{expand}-{tapered}"] = ("GrowMask", "expand_mask",
                                                 dict(mask=BINARY, expand=expand,
                                                      tapered_corners=tapered))


@pytest.mark.parametrize("case", list(CASES))
def test_mask_node_matches_jax(case):
    name, method, kwargs = CASES[case]
    run_both(name, method, module_pair=PAIR, **kwargs)


def test_solid_mask_on_the_contexts_device():
    (ref,) = jmask.SolidMask().solid(0.25, 7, 5)
    (got,) = tmask.SolidMask().solid(0.25, 7, 5, context=ExecutionContext(device="cpu"))
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_growing_a_point_spreads_as_a_diamond_or_a_square():
    point = torch.zeros((1, 7, 7))
    point[0, 3, 3] = 1.0
    (diamond,) = tmask.GrowMask().expand_mask(point, 2, True)
    (square,) = tmask.GrowMask().expand_mask(point, 2, False)
    assert int(diamond.sum()) == 13 and int(square.sum()) == 25
    (back,) = tmask.GrowMask().expand_mask(square, -2, False)
    torch.testing.assert_close(back, point, rtol=0, atol=0)


def test_bad_channels_and_operations_raise_like_jax():
    for mod, conv in ((jmask, np.asarray), (tmask, torch.from_numpy)):
        with pytest.raises(ValueError, match="no 'alpha' plane"):
            mod.ImageToMask().image_to_mask(conv(IMAGE), "alpha")
        with pytest.raises(ValueError, match="operation must be one of"):
            mod.MaskComposite().combine(conv(MASK), conv(SRC), 0, 0, "max")
