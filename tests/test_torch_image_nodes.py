"""The image and latent nodes of graph/nodes_core.py in the port against the
JAX package's, on the CPU: the same numpy-seeded inputs through both,
every output compared (images, latents, masks and the dict extras).
Tolerance: 1e-5 relative to the largest |x| of the JAX output (pure node
math in f32; resizes are the same separable weights summed in another
order). Also: the two packages' node registries, with what the port
still lacks named by its ROADMAP item.
"""

import numpy as np
import pytest
import torch

import comfyui_distributed_tpu.graph as jgraph
import comfyui_distributed_tpu_torch.graph as tgraph
from comfyui_distributed_tpu.graph import nodes_core as jnc
from comfyui_distributed_tpu_torch.graph import ExecutionContext
from comfyui_distributed_tpu_torch.graph import nodes_core as tnc
from test_torch_parity import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RNG = np.random.default_rng(20261017)
IMAGE = RNG.random((2, 20, 28, 3), dtype=np.float32)
OTHER = RNG.random((1, 12, 30, 3), dtype=np.float32)
LATENT = RNG.standard_normal((2, 6, 8, 4), dtype=np.float32)
SMALL = RNG.standard_normal((1, 3, 4, 4), dtype=np.float32)
MASK = RNG.random((2, 6, 8), dtype=np.float32)
PIXEL_MASK = (RNG.random((20, 28)) > 0.5).astype(np.float32)


def _to(value, side):
    """numpy (and containers of it) → jnp arrays or torch tensors."""
    import jax.numpy as jnp

    if isinstance(value, np.ndarray):
        return jnp.asarray(value) if side == "jax" else torch.from_numpy(value.copy())
    if isinstance(value, dict):
        return {k: _to(v, side) for k, v in value.items()}
    return value


def _np(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def assert_same(got, ref, path="out"):
    """Outputs equal in structure; arrays within 1e-5 of the largest |x|."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), (path, set(got) ^ set(ref))
        for key in ref:
            assert_same(got[key], ref[key], f"{path}[{key!r}]")
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same(g, r, f"{path}[{i}]")
    elif hasattr(ref, "shape"):
        g, r = _np(got), np.asarray(ref)
        assert g.shape == r.shape, (path, g.shape, r.shape)
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * max(1.0, float(np.abs(r).max())),
                                   err_msg=path)
    else:
        assert got == ref, path


def run_both(name, method, module_pair=(jnc, tnc), **kwargs):
    """One node through both packages; kwargs are numpy or plain values."""
    jmod, tmod = module_pair
    ref = getattr(getattr(jmod, name)(), method)(**_to(kwargs, "jax"))
    got = getattr(getattr(tmod, name)(), method)(**_to(kwargs, "torch"))
    assert_same(got, ref)
    return got, ref


CASES = {
    "ImageBatch-same": ("ImageBatch", "batch", dict(image1=IMAGE, image2=IMAGE[:1] * 0.5)),
    "ImageBatch-aspect": ("ImageBatch", "batch", dict(image1=IMAGE, image2=OTHER)),
    "ImageCrop": ("ImageCrop", "crop", dict(image=IMAGE, width=9, height=50, x=5, y=3)),
    "ImageCrop-clamped": ("ImageCrop", "crop", dict(image=IMAGE, width=0, height=4, x=40,
                                                     y=-7)),
    "LatentComposite": ("LatentComposite", "composite",
                        dict(samples_to={"samples": LATENT}, samples_from={"samples": SMALL},
                             x=16, y=8, feather=0)),
    "LatentComposite-feather": ("LatentComposite", "composite",
                                dict(samples_to={"samples": LATENT, "width": 64},
                                     samples_from={"samples": SMALL}, x=24, y=16, feather=16)),
    "RepeatLatentBatch": ("RepeatLatentBatch", "repeat",
                          dict(samples={"samples": LATENT, "noise_mask": MASK[..., None]},
                               amount=3)),
    "ImagePadForOutpaint": ("ImagePadForOutpaint", "expand",
                            dict(image=IMAGE, left=4, top=0, right=12, bottom=6,
                                 feathering=5)),
    "ImagePadForOutpaint-flat": ("ImagePadForOutpaint", "expand",
                                 dict(image=IMAGE, left=0, top=3, right=0, bottom=0,
                                      feathering=0)),
    "SetLatentNoiseMask": ("SetLatentNoiseMask", "set_mask",
                           dict(samples={"samples": LATENT}, mask=PIXEL_MASK)),
    "ImageScale-bilinear": ("ImageScale", "scale", dict(image=IMAGE, upscale_method="bilinear",
                                                        width=41, height=33)),
    "ImageScale-bicubic-aspect": ("ImageScale", "scale",
                                  dict(image=IMAGE, upscale_method="bicubic", width=0,
                                       height=50)),
    "ImageScale-area-center": ("ImageScale", "scale",
                               dict(image=IMAGE, upscale_method="area", width=9, height=9,
                                    crop="center")),
    "ImageScale-lanczos": ("ImageScale", "scale", dict(image=IMAGE, upscale_method="lanczos",
                                                       width=14, height=10)),
    "ImageScale-nearest-exact": ("ImageScale", "scale",
                                 dict(image=IMAGE, upscale_method="nearest-exact", width=37,
                                      height=23)),
    "ImageScaleBy": ("ImageScaleBy", "scale", dict(image=IMAGE, upscale_method="bicubic",
                                                   scale_by=1.7)),
    "ImageInvert": ("ImageInvert", "invert", dict(image=IMAGE)),
    "LatentUpscale": ("LatentUpscale", "upscale",
                      dict(samples={"samples": LATENT, "noise_mask": MASK}, width=96, height=72,
                           upscale_method="bilinear")),
    "LatentUpscale-center": ("LatentUpscale", "upscale",
                             dict(samples={"samples": LATENT, "noise_mask": MASK}, width=64,
                                  height=0, crop="center", upscale_method="nearest-exact")),
    "LatentUpscaleBy": ("LatentUpscaleBy", "upscale",
                        dict(samples={"samples": LATENT}, upscale_method="bicubic",
                             scale_by=1.5)),
    "LatentFromBatch": ("LatentFromBatch", "frombatch",
                        dict(samples={"samples": LATENT, "noise_mask": MASK[..., None]},
                             batch_index=1, length=5)),
    "LatentBatch": ("LatentBatch", "batch",
                    dict(samples1={"samples": LATENT, "noise_mask": MASK},
                         samples2={"samples": SMALL})),
    "ImageBlur": ("ImageBlur", "blur", dict(image=IMAGE, blur_radius=3, sigma=1.4)),
    "ImageBlur-off": ("ImageBlur", "blur", dict(image=IMAGE, blur_radius=0, sigma=1.4)),
    "ImageSharpen": ("ImageSharpen", "sharpen", dict(image=IMAGE, sharpen_radius=2, sigma=1.0,
                                                     alpha=0.8)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_node_matches_jax(case):
    name, method, kwargs = CASES[case]
    got, ref = run_both(name, method, **kwargs)
    assert got is not None and ref is not None


def test_unknown_modes_raise_like_jax():
    for node, method, kwargs, match in (
        ("ImageScale", "scale", dict(upscale_method="bilinear", width=8, height=8, crop="edge"),
         "unknown crop"),
        ("ImageScale", "scale", dict(upscale_method="bicubicc", width=8, height=8),
         "unknown upscale_method"),
    ):
        for mod, image in ((jnc, _to(IMAGE, "jax")), (tnc, torch.from_numpy(IMAGE))):
            with pytest.raises(ValueError, match=match):
                getattr(getattr(mod, node)(), method)(image=image, **kwargs)


def test_nodes_keep_the_tensors_device_and_dtype():
    """CPU in, CPU f32 out: no node moves a tensor to the card by itself."""
    (out,) = tnc.ImageSharpen().sharpen(torch.from_numpy(IMAGE), 2, 1.0, 0.8)
    padded, mask = tnc.ImagePadForOutpaint().expand(torch.from_numpy(IMAGE), 2, 2, 2, 2, 4)
    for t in (out, padded, mask):
        assert t.device.type == "cpu" and t.dtype == torch.float32


# the JAX package's nodes the port does not register yet, by the ROADMAP
# item that brings them (Queue 1)
STILL_TO_PORT = {
    "step 6b (WEBP)": {"SaveAnimatedWEBP"},
    "step 6b (audio)": {"LoadAudio", "SaveAudio", "AudioBatchDivider"},
}


def test_the_registries_differ_only_by_the_families_still_to_port():
    """Every SD-family node of the JAX package is registered in the port
    under its name, and so is every Flux and SD3 node, LoRA loader and
    weight merge, every video, CLIP-vision and unCLIP node; what is
    missing is SaveAnimatedWEBP and the audio nodes (129 of 133)."""
    # each package's own nodes: other test modules register nodes of their
    # own in the same process
    jax_nodes, port_nodes = ({name for name, cls in graph.NODE_REGISTRY.items()
                              if cls.__module__.startswith(graph.__name__ + ".")}
                             for graph in (jgraph, tgraph))
    assert jax_nodes - port_nodes == set().union(*STILL_TO_PORT.values())
    assert port_nodes <= jax_nodes
    for name in ("KSamplerSelect", "SamplerCustomAdvanced", "PerpNegGuider", "GrowMask",
                 "LatentBatchSeedBehavior", "InpaintModelConditioning", "ImageBatch",
                 "ModelSamplingDiscrete", "CLIPTextEncodeFlux", "FluxGuidance",
                 "ModelSamplingFlux", "ReferenceLatent", "UNETLoader", "CLIPLoader",
                 "DualCLIPLoader", "EmptySD3LatentImage", "TripleCLIPLoader",
                 "ModelSamplingSD3", "SkipLayerGuidanceSD3", "LoraLoader",
                 "LoraLoaderModelOnly", "ModelMergeSimple", "CLIPMergeSimple",
                 "VideoCheckpointLoader", "VideoCLIPTextEncode", "EmptyVideoLatent",
                 "VideoFlowSampler", "WanImageToVideo", "SaveVideoFrames", "SaveAnimatedPNG",
                 "CLIPVisionLoader", "CLIPVisionEncode", "unCLIPConditioning"):
        assert name in tgraph.NODE_REGISTRY
    assert len(jax_nodes) == 133 and len(port_nodes) == 129


def test_a_graph_of_image_nodes_runs_through_the_executor():
    """ImageBatch → ImageScaleBy → ImageSharpen → ImageCrop in one prompt
    on the CPU, against the nodes called by hand."""
    import numpy as np

    from comfyui_distributed_tpu_torch.graph import GraphExecutor

    class Source:
        @classmethod
        def INPUT_TYPES(cls):
            return {"required": {}}

        RETURN_TYPES = ("IMAGE",)
        FUNCTION = "make"

        def make(self, context=None):
            return (torch.from_numpy(IMAGE),)

    tgraph.register_node(Source, name="TestImageSource")
    try:
        prompt = {
            "1": {"class_type": "TestImageSource", "inputs": {}},
            "2": {"class_type": "ImageBatch", "inputs": {"image1": ["1", 0], "image2": ["1", 0]}},
            "3": {"class_type": "ImageScaleBy", "inputs": {"image": ["2", 0],
                                                           "upscale_method": "bilinear",
                                                           "scale_by": 1.5}},
            "4": {"class_type": "ImageSharpen", "inputs": {"image": ["3", 0],
                                                           "sharpen_radius": 1, "sigma": 1.0,
                                                           "alpha": 1.0}},
            "5": {"class_type": "ImageCrop", "inputs": {"image": ["4", 0], "width": 16,
                                                        "height": 16, "x": 4, "y": 4}},
            "6": {"class_type": "PreviewImage", "inputs": {"images": ["5", 0]}},
        }
        out = GraphExecutor(ExecutionContext(device="cpu")).execute(prompt)["6"][0]["images"]
    finally:
        tgraph.NODE_REGISTRY.pop("TestImageSource")
    image = torch.from_numpy(IMAGE)
    (x,) = tnc.ImageBatch().batch(image, image)
    (x,) = tnc.ImageScaleBy().scale(x, "bilinear", 1.5)
    (x,) = tnc.ImageSharpen().sharpen(x, 1, 1.0, 1.0)
    (x,) = tnc.ImageCrop().crop(x, 16, 16, 4, 4)
    assert tuple(out.shape) == (4, 16, 16, 3) and np.isfinite(out.numpy()).all()
    torch.testing.assert_close(out, x, rtol=0, atol=0)
