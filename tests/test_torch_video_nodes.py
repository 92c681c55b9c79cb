"""The port's video, CLIP-vision and unCLIP nodes against the JAX
package's on the CPU, at f32.

- The three bundled WAN workflows (distributed-wan, -wan-2.2-14b-t2v,
  -wan-i2v), unmodified but for sizes (`shrunk`: tiny-dit or
  tiny-dit-i2v with the causal tiny-video-vae-3d, 32 px, 5 frames, 2
  steps), through both packages' GraphExecutors on the same
  numpy-seeded weights, the port drawing the JAX package's noise: the
  frames within 1e-4 absolute (f32 summation order; measured ~1e-6), and
  SaveVideoFrames' PNGs and manifest, decoded with PIL, the frames' u8
  values in both.
- SaveAnimatedPNG: one APNG whose frames PIL decodes to the u8 frames,
  delay round(1000 / fps) ms, loop 0, as the JAX node's (PIL's writer).
- unCLIPConditioning: a sampler given its conditioning raises the JAX
  package's ValueError, word for word, in both packages; WanImageToVideo
  refuses a frame count off 4n+1 for an i2v model in both."""

import copy
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from comfyui_distributed_tpu.graph import executor as jexec
from comfyui_distributed_tpu.graph import nodes_loaders as jnl
from comfyui_distributed_tpu.graph import nodes_video as jnv
from comfyui_distributed_tpu.ops import samplers as jsmp
from comfyui_distributed_tpu.ops.conditioning import Conditioning as JCond
from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
from comfyui_distributed_tpu_torch.graph import nodes_loaders as tnl
from comfyui_distributed_tpu_torch.graph import nodes_video as tnv
from comfyui_distributed_tpu_torch.models import video_pipeline as tvp
from comfyui_distributed_tpu_torch.ops import samplers as tsmp
from comfyui_distributed_tpu_torch.ops.conditioning import Conditioning as TCond
from comfyui_distributed_tpu_torch.utils import image as img_utils

from test_torch_video_pipeline import jax_key_noise, video_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKFLOWS = ("distributed-wan.json", "distributed-wan-2.2-14b-t2v.json",
             "distributed-wan-i2v.json")
PX, FRAMES, STEPS = 32, 5, 2


@pytest.fixture(scope="module")
def pairs():
    with pytest.MonkeyPatch.context() as mp:
        return {name: video_pair(name, "tiny-video-vae-3d", mp)
                for name in ("tiny-dit", "tiny-dit-i2v")}


def shrunk(name: str) -> dict:
    """A bundled WAN workflow on the tiny models at PX, FRAMES, STEPS."""
    with open(os.path.join(REPO, "workflows", name), encoding="utf-8") as fh:
        wf = json.load(fh)
    for node in wf.values():
        inputs = node["inputs"]
        if node["class_type"] == "VideoCheckpointLoader":
            i2v = inputs["ckpt_name"].endswith("i2v")
            inputs["ckpt_name"] = "tiny-dit-i2v" if i2v else "tiny-dit"
        elif node["class_type"] == "EmptyVideoLatent":
            inputs.update(width=PX, height=PX, frames=FRAMES)
        elif node["class_type"] == "VideoFlowSampler":
            inputs["steps"] = STEPS
        elif node["class_type"] == "WanImageToVideo":
            inputs.update(frames=FRAMES, steps=STEPS)
    return wf


def _sink(wf):
    (sink,) = [k for k, v in wf.items() if v["class_type"] == "SaveVideoFrames"]
    return sink


@pytest.mark.parametrize("name", WORKFLOWS)
def test_bundled_workflows_match_jax(pairs, name, tmp_path, monkeypatch):
    wf = shrunk(name)
    ckpt = next(v["inputs"]["ckpt_name"] for v in wf.values()
                if v["class_type"] == "VideoCheckpointLoader")
    jb, tb = pairs[ckpt]
    in_dir = tmp_path / "input"
    in_dir.mkdir()
    for node in wf.values():
        if node["class_type"] == "LoadImage":
            rgb = np.random.default_rng(5).random((1, PX, PX, 3), dtype=np.float32)
            (in_dir / node["inputs"]["image"]).write_bytes(img_utils.encode_png(rgb))
    monkeypatch.setattr(tvp, "video_noise",
                        lambda bundle, seed, shape: torch.from_numpy(jax_key_noise(seed, shape)))
    sink = _sink(wf)
    outs = {}
    for pkg in ("jax", "port"):
        settings = {"input_dir": str(in_dir), "output_dir": str(tmp_path / pkg)}
        if pkg == "jax":
            ex = jexec.GraphExecutor(jexec.ExecutionContext(
                config={"settings": settings}, pipelines={f"video:{ckpt}": jb}))
        else:
            ex = GraphExecutor(ExecutionContext(device="cpu", config={"settings": settings},
                                                pipelines={f"video:{ckpt}": tb}))
        result = ex.execute(copy.deepcopy(wf))[sink][0]
        frames = np.asarray(result["images"], np.float32)
        outs[pkg] = frames
        prefix = wf[sink]["inputs"]["filename_prefix"]
        manifest = json.loads((tmp_path / pkg / f"{prefix}_manifest.json").read_text())
        assert manifest["fps"] == 16 and len(manifest["frames"]) == frames.shape[0]
        for i, fname in enumerate(manifest["frames"]):
            png = np.asarray(Image.open(tmp_path / pkg / fname).convert("RGB"))
            np.testing.assert_array_equal(png, img_utils.f32_to_u8(frames[i]))
    assert outs["port"].shape == outs["jax"].shape == (FRAMES, PX, PX, 3)
    assert outs["jax"].std() > 0.01
    np.testing.assert_allclose(outs["port"], outs["jax"], atol=1e-4, rtol=0)


def test_save_animated_png_matches_the_jax_nodes_file(tmp_path):
    frames = np.random.default_rng(3).random((4, 12, 10, 3), dtype=np.float32)
    files = {}
    for pkg, node, arg in (("jax", jnv.SaveAnimatedPNG, jnp.asarray(frames)),
                           ("port", tnv.SaveAnimatedPNG, torch.from_numpy(frames))):
        out_dir = tmp_path / pkg
        ctx = type("Ctx", (), {"config": {"settings": {"output_dir": str(out_dir)}}})()
        (result,) = node().save(arg, filename_prefix="clip", fps=16, context=ctx)
        (name,) = result["ui"]["images"]
        assert name == "clip_00000.png"
        files[pkg] = Image.open(out_dir / name)
    for im in files.values():
        assert im.n_frames == 4
        assert im.info["loop"] == 0 and im.info["duration"] == round(1000 / 16)
    want = img_utils.f32_to_u8(frames)
    for i in range(4):
        for im in files.values():
            im.seek(i)
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")), want[i])


def test_unclip_conditioning_raises_the_jax_error(pairs):
    """The node attaches the tokens; CFG over that entry raises the JAX
    package's ValueError in both packages, the same words."""
    tokens = np.random.default_rng(4).random((1, 17, 48), dtype=np.float32)
    ctx = np.zeros((1, 3, 8), np.float32)
    (jcond,) = jnl.UnCLIPConditioning().apply_adm(
        JCond(context=jnp.asarray(ctx)), jnl.ClipVisionOutput(tokens=jnp.asarray(tokens)), 0.7)
    (tcond,) = tnl.UnCLIPConditioning().apply_adm(
        TCond(context=torch.from_numpy(ctx)), tnl.ClipVisionOutput(tokens=torch.from_numpy(tokens)),
        0.7)
    assert tcond.unclip_strength == jcond.unclip_strength == 0.7
    assert torch.equal(tcond.unclip_embeds, torch.from_numpy(tokens))
    errors = []
    for smp, cond, neg, x, lib in (
            (jsmp, jcond, JCond(context=jnp.asarray(ctx)), jnp.zeros((1, 4, 4, 4)), jnp),
            (tsmp, tcond, TCond(context=torch.from_numpy(ctx)), torch.zeros(1, 4, 4, 4), torch)):
        with pytest.raises(ValueError) as exc:
            smp.cfg_model(lambda x, s, c: x, 2.0)(x, lib.ones((1,)), (cond, neg))
        errors.append(str(exc.value))
    assert errors[0] == errors[1] and "unCLIP" in errors[1]


def test_i2v_frame_stride_is_refused_in_both(pairs):
    jb, tb = pairs["tiny-dit-i2v"]
    image = np.zeros((1, PX, PX, 3), np.float32)
    for node, bundle, arg in ((jnv.WanImageToVideo, jb, jnp.asarray(image)),
                              (tnv.WanImageToVideo, tb, torch.from_numpy(image))):
        with pytest.raises(ValueError, match="4n\\+1"):
            node().generate(bundle, arg, frames=6, steps=1)


def test_the_loader_takes_the_bundled_workflows_names():
    """"wan-1.3b" (distributed-wan.json) is a registry name, not a file
    with the extension ".3b": the port's loader keeps it, where the JAX
    node's splitext makes it "wan-1" (ROADMAP.md, Queue 3); a file name
    loses its extension in both."""
    bundle = object()
    context = ExecutionContext(device="cpu", pipelines={"video:wan-1.3b": bundle,
                                                        "video:wan-14b": bundle})
    for name in ("wan-1.3b", "wan-14b.safetensors"):
        assert tnv.VideoCheckpointLoader().load(name, context=context) == (bundle,) * 3
    assert tnv.video_model_name("wan-14b-i2v") == "wan-14b-i2v"
    with pytest.raises(KeyError, match="wan-1'"):
        jnv.VideoCheckpointLoader().load("wan-1.3b", context=jexec.ExecutionContext())
