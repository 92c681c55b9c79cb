"""The transform nodes (graph/nodes_transform.py) in the port against the
JAX package's, on the CPU: flips, quarter turns, crops, blends, latent
arithmetic, quantisation, EmptyImage, LoadImageMask (one PNG file read
by both: the port's codec, the JAX package's PIL) and
LatentBatchSeedBehavior, whose "fixed" batch is sampled by KSampler in
both packages with the JAX package's noise handed to the port.
Tolerance: 1e-5 relative to the largest |x| for node math; the sampled
latents 5e-5 per unit of their largest |x| (f32 summation order).
"""

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.graph import nodes_core as jnc
from comfyui_distributed_tpu.graph import nodes_transform as jtr
from comfyui_distributed_tpu_torch.graph import ExecutionContext
from comfyui_distributed_tpu_torch.graph import nodes_core as tnc
from comfyui_distributed_tpu_torch.graph import nodes_transform as ttr
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.utils import image as img_utils
from test_torch_image_nodes import run_both
from test_torch_parity import jax_and_port_bundles, jax_noise, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RNG = np.random.default_rng(41)
IMAGE = RNG.random((2, 7, 10, 3), dtype=np.float32)
OTHER = RNG.random((1, 14, 9, 3), dtype=np.float32)
LATENT = RNG.standard_normal((1, 5, 6, 4), dtype=np.float32)
LATENT_B = RNG.standard_normal((1, 5, 6, 4), dtype=np.float32)
NOISE_MASK = RNG.random((1, 5, 6, 1), dtype=np.float32)
PAIR = (jtr, ttr)

CASES = {
    "LatentCrop": ("LatentCrop", "crop", dict(samples={"samples": LATENT,
                                                       "noise_mask": NOISE_MASK},
                                              width=24, height=100, x=8, y=9)),
    "LatentBlend": ("LatentBlend", "blend", dict(samples1={"samples": LATENT},
                                                 samples2={"samples": LATENT_B},
                                                 blend_factor=0.3)),
    "LatentAdd": ("LatentAdd", "op", dict(samples1={"samples": LATENT},
                                          samples2={"samples": LATENT_B})),
    "LatentSubtract": ("LatentSubtract", "op", dict(samples1={"samples": LATENT},
                                                    samples2={"samples": LATENT_B})),
    "LatentMultiply": ("LatentMultiply", "op", dict(samples={"samples": LATENT},
                                                    multiplier=-1.7)),
    "LatentInterpolate": ("LatentInterpolate", "op", dict(samples1={"samples": LATENT},
                                                          samples2={"samples": LATENT_B},
                                                          ratio=0.35)),
    "ImageQuantize": ("ImageQuantize", "quantize", dict(image=IMAGE, colors=5)),
}
for method in ("x-axis: vertically", "y-axis: horizontally"):
    CASES[f"LatentFlip-{method[0]}"] = ("LatentFlip", "flip",
                                        dict(samples={"samples": LATENT,
                                                      "noise_mask": NOISE_MASK},
                                             flip_method=method))
    CASES[f"ImageFlip-{method[0]}"] = ("ImageFlip", "flip", dict(image=IMAGE,
                                                                 flip_method=method))
for rotation in ("none", "90 degrees", "180 degrees", "270 degrees"):
    CASES[f"LatentRotate-{rotation}"] = ("LatentRotate", "rotate",
                                         dict(samples={"samples": LATENT,
                                                       "noise_mask": NOISE_MASK},
                                              rotation=rotation))
    CASES[f"ImageRotate-{rotation}"] = ("ImageRotate", "rotate", dict(image=IMAGE,
                                                                      rotation=rotation))
for mode in ("normal", "multiply", "screen", "overlay", "soft_light", "difference"):
    CASES[f"ImageBlend-{mode}"] = ("ImageBlend", "blend", dict(image1=IMAGE, image2=OTHER,
                                                               blend_factor=0.6,
                                                               blend_mode=mode))
for mode in ("fixed", "random"):
    CASES[f"LatentBatchSeedBehavior-{mode}"] = (
        "LatentBatchSeedBehavior", "op",
        dict(samples={"samples": LATENT, "batch_index_fixed": True}, seed_behavior=mode))


@pytest.mark.parametrize("case", list(CASES))
def test_transform_node_matches_jax(case):
    name, method, kwargs = CASES[case]
    run_both(name, method, module_pair=PAIR, **kwargs)


def test_empty_image_matches_jax_on_the_contexts_device():
    (ref,) = jtr.EmptyImage().generate(9, 4, 2, 0x3366CC)
    (got,) = ttr.EmptyImage().generate(9, 4, 2, 0x3366CC, context=ExecutionContext(device="cpu"))
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("channel", ["alpha", "red", "blue"])
@pytest.mark.parametrize("alpha", [True, False])
def test_load_image_mask_reads_one_png_as_jax_does(tmp_path, channel, alpha):
    pixels = RNG.random((6, 5, 4 if alpha else 3), dtype=np.float32)
    path = tmp_path / "mask.png"
    path.write_bytes(img_utils.encode_png(pixels))
    (ref,) = jtr.LoadImageMask().load(str(path), channel)
    (got,) = ttr.LoadImageMask().load(str(path), channel, context=ExecutionContext(device="cpu"))
    assert got.shape == (1, 6, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_mismatched_latents_and_bad_options_raise_like_jax():
    for mod, conv in ((jtr, np.asarray), (ttr, torch.from_numpy)):
        with pytest.raises(ValueError, match="matching shapes"):
            mod.LatentAdd().op({"samples": conv(LATENT)}, {"samples": conv(LATENT[:, :3])})
        with pytest.raises(ValueError, match="unknown rotation"):
            mod.ImageRotate().rotate(conv(IMAGE), "45 degrees")
        with pytest.raises(ValueError, match="dither"):
            mod.ImageQuantize().quantize(conv(IMAGE), 8, "floyd-steinberg")
        with pytest.raises(ValueError, match="seed_behavior"):
            mod.LatentBatchSeedBehavior().op({"samples": conv(LATENT)}, "sometimes")


@pytest.fixture(scope="module")
def pair():
    return jax_and_port_bundles("tiny-unet")


@pytest.mark.parametrize("mode", ["fixed", "random"])
def test_a_fixed_batch_samples_row_zeros_noise_on_every_row_as_jax(pair, mode, monkeypatch):
    """A batch of 3 through LatentBatchSeedBehavior and KSampler in both
    packages: "fixed" draws one row of noise for all three (the rows come
    out equal), "random" a row each."""
    jb, tb = pair
    monkeypatch.setattr(tpl, "default_noise",
                        lambda seed, shape, device: torch.from_numpy(jax_noise(seed, shape)))
    ctx = [RNG.standard_normal((1, 16, 64), dtype=np.float32) for _ in range(2)]
    outs = []
    for nc, tr, bundle, conv, kw in ((jnc, jtr, jb, np.asarray, {}),
                                     (tnc, ttr, tb, torch.from_numpy,
                                      {"context": ExecutionContext(device="cpu")})):
        (latent,) = nc.EmptyLatentImage().generate(32, 32, 3, **kw)
        (latent,) = tr.LatentBatchSeedBehavior().op(latent, mode)
        (out,) = nc.KSampler().sample(bundle, 21, 2, 5.0, "euler", "karras", conv(ctx[0]),
                                      conv(ctx[1]), latent, denoise=1.0)
        outs.append(np.asarray(out["samples"]))
    ref, got = outs
    assert got.shape == (3, 16, 16, 4)
    rows_equal = np.array_equal(got[0], got[2])
    assert rows_equal == (mode == "fixed")
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-5 * float(np.abs(ref).max()))
