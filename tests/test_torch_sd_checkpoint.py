"""The port's single-file SD checkpoints
(comfyui_distributed_tpu_torch/models/sd_checkpoint.py) against the JAX
package's (comfyui_distributed_tpu/models/sd_checkpoint.py) on the CPU:
the key schedules at full width, coverage of every full-width module on
`meta`, the reader and writer against the `safetensors` package, files
written from seeded weights loaded by both packages' load_pipeline (the
SD1.x and SDXL layouts at tiny width, the SD2.x layout through
load_sd_weights), `.ckpt` files, the VAELoader node, and the file edge
cases. No checkpoint is downloaded: the tests invert the schedules."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import pipeline as jpl
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import sd_checkpoint as jsdc
from comfyui_distributed_tpu.models.io import flatten_params
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import sd_checkpoint as tsdc
from comfyui_distributed_tpu_torch.models.io import _torch_name_and_value, from_jax_params

from test_torch_parity import f32, seeded_flax_params

SEED = 7


def _read(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a checkpoint, copied out of the file."""
    with tsdc.open_checkpoint(path) as state_dict:
        return {k: state_dict[k].clone() for k in state_dict}


# --- the schedules --------------------------------------------------------------

def _port_name(flax_path: str) -> str:
    return _torch_name_and_value(f"params/{flax_path}", np.zeros((1, 1)))[0]


SCHEDULES = [
    ("sd15", "unet_schedule", {}),
    ("sd21", "unet_schedule", {}),
    ("sdxl", "unet_schedule", {}),
    ("vae-sd", "vae_schedule", {}),
    ("vae-sd", "vae_schedule", {"prefix": ""}),
    ("clip-l", "text_encoder_schedule", {}),
    ("clip-l-sdxl", "text_encoder_schedule",
     {"prefix": "conditioner.embedders.0.transformer.text_model"}),
    ("clip-g", "text_encoder_schedule", {"prefix": "text_model", "projection_layout": "linear"}),
    ("clip-g", "open_clip_schedule", {}),
    ("clip-h", "open_clip_schedule", {"prefix": "cond_stage_model.model"}),
]


@pytest.mark.parametrize("name, schedule, kwargs", SCHEDULES)
def test_schedules_list_the_jax_keys_in_order(name, schedule, kwargs):
    """Pure functions of the config at full width: the same SD keys in the
    same order, each onto the parameter the JAX flax path names under
    models/io.py's rule."""
    jax_entries = getattr(jsdc, schedule)(jreg.get_config(name), **kwargs)
    port_entries = getattr(tsdc, schedule)(treg.get_config(name), **kwargs)
    assert [sd for sd, _, _ in port_entries] == [sd for sd, _, _ in jax_entries]
    assert ([(sd, name) for sd, name, _ in tsdc._expand(port_entries)]
            == [(sd, _port_name(fx)) for sd, fx, _ in jsdc._expand(jax_entries)])


MODULES = ["sd15", "sd21", "sdxl", "vae-sd", "clip-l", "clip-l-sdxl", "clip-g", "clip-h"]


def _full_width_schedule(name):
    cfg = treg.get_config(name)
    family = treg.model_family(name)
    if family == "unet":
        return tsdc.unet_schedule(cfg)
    if family == "vae":
        return tsdc.vae_schedule(cfg)
    if name in ("clip-g", "clip-h"):
        return tsdc.open_clip_schedule(cfg)
    return tsdc.text_encoder_schedule(cfg)


@pytest.mark.parametrize("name", MODULES)
def test_full_width_modules_are_covered_on_meta(name):
    """Each full-width module, built on `meta`: every parameter is filled
    by exactly one schedule entry, and a state dict synthesized from its
    shapes loads back with no problem."""
    with torch.device("meta"):
        module = treg.create_model(name)
    entries = _full_width_schedule(name)
    names = [n for _, n, _ in tsdc._expand(entries)]
    assert sorted(names) == sorted(module.state_dict())
    state = tsdc.synthesize_state_dict(module.state_dict(), entries)
    flat, missing = tsdc.convert_state_dict(state, entries)
    assert not missing
    assert {n: tuple(t.shape) for n, t in flat.items()} == {
        n: tuple(t.shape) for n, t in module.state_dict().items()}
    assert tsdc._merge_into_module(state, entries, module, name) == []


def test_sdxl_and_sd2_keys_carry_the_published_shapes():
    """A few keys of the published SD1.5, SD2.1 and SDXL files with their
    shapes, from the schedules run over the full-width modules on meta."""
    with torch.device("meta"):
        shapes = {}
        for name, kind in (("sdxl", "unet"), ("clip-g", "te2"), ("clip-h", "te")):
            module = treg.create_model(name)
            if kind == "unet":
                entries = tsdc.unet_schedule(module.config)
            elif kind == "te2":
                entries = tsdc.open_clip_schedule(module.config)
            else:
                entries = tsdc.open_clip_schedule(module.config, prefix="cond_stage_model.model")
            shapes.update({k: tuple(v.shape) for k, v in
                           tsdc.synthesize_state_dict(module.state_dict(), entries).items()})
    assert shapes["model.diffusion_model.label_emb.0.0.weight"] == (1280, 2816)
    assert shapes["model.diffusion_model.input_blocks.4.1.transformer_blocks.1.attn2.to_k.weight"] \
        == (640, 2048)
    assert shapes["conditioner.embedders.1.model.transformer.resblocks.31.attn.in_proj_weight"] \
        == (3840, 1280)
    assert shapes["conditioner.embedders.1.model.text_projection"] == (1280, 1280)
    assert shapes["conditioner.embedders.1.model.positional_embedding"] == (77, 1280)
    assert shapes["cond_stage_model.model.transformer.resblocks.23.attn.in_proj_bias"] == (3072,)


# --- files ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16, torch.int64])
def test_reader_and_writer_agree_with_the_safetensors_package(tmp_path, dtype):
    from safetensors.torch import load_file, save_file

    gen = torch.Generator()
    gen.manual_seed(1)
    tensors = {"a.weight": torch.randn((3, 5), generator=gen), "b": torch.randn((7,), generator=gen),
               "c.scalar": torch.randn((), generator=gen), "d.empty": torch.zeros((0, 4))}
    tensors = {k: (v * 100).to(dtype) for k, v in tensors.items()}
    ours = str(tmp_path / "ours.safetensors")
    size = tsdc.save_safetensors(tensors, ours)
    assert size == os.path.getsize(ours)
    for k, v in load_file(ours).items():
        assert v.dtype == dtype and torch.equal(v, tensors[k]), k
    theirs = str(tmp_path / "theirs.safetensors")
    save_file(tensors, theirs, metadata={"format": "pt"})  # a header with __metadata__
    got = _read(theirs)
    assert set(got) == set(tensors)
    for k, v in got.items():
        assert v.dtype == dtype and torch.equal(v, tensors[k]), k


def test_the_writer_casts_floating_tensors_only(tmp_path):
    path = str(tmp_path / "f16.safetensors")
    tsdc.save_safetensors({"w": torch.full((2,), 1.0 / 3.0), "ids": torch.arange(3)}, path,
                          dtype=torch.float16)
    got = _read(path)
    assert got["w"].dtype == torch.float16 and got["ids"].dtype == torch.int64
    assert torch.equal(got["w"], torch.full((2,), 1.0 / 3.0).half())


def test_a_corrupt_header_raises(tmp_path):
    path = str(tmp_path / "bad.safetensors")
    tsdc.save_safetensors({"w": torch.zeros((4, 4))}, path)
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) - 8)
    with pytest.raises(ValueError, match="data_offsets"):
        _read(path)


def test_find_checkpoint_rules(tmp_path, monkeypatch):
    monkeypatch.delenv("CDT_CHECKPOINT_DIR", raising=False)
    assert tsdc.find_checkpoint("sd15") is None
    (tmp_path / "sd15.ckpt").write_bytes(b"")
    monkeypatch.setenv("CDT_CHECKPOINT_DIR", str(tmp_path))
    assert tsdc.find_checkpoint("sd15") == str(tmp_path / "sd15.ckpt")
    (tmp_path / "sd15.safetensors").write_bytes(b"")
    assert tsdc.find_checkpoint("sd15") == str(tmp_path / "sd15.safetensors")
    assert tsdc.find_checkpoint("sdxl") is None
    # the variable naming a file applies to that stem only
    monkeypatch.setenv("CDT_CHECKPOINT_DIR", str(tmp_path / "sd15.safetensors"))
    assert tsdc.find_checkpoint("sd15") == str(tmp_path / "sd15.safetensors")
    assert tsdc.find_checkpoint("tiny-unet") is None
    for name in ("sd15", "tiny-unet", "sdxl"):
        assert tsdc.find_checkpoint(name) == jsdc.find_checkpoint(name)


def test_gguf_files_raise_with_their_roadmap_item(tmp_path):
    """A .gguf checkpoint goes through models/gguf.py (ROADMAP Queue 1
    item 4a, done): a file cut after its magic raises as the JAX
    reader's does."""
    from comfyui_distributed_tpu.models.gguf import read_gguf as jax_read_gguf

    path = tmp_path / "tiny-unet.gguf"
    path.write_bytes(b"GGUF")
    for read in (_read, jax_read_gguf):
        with pytest.raises(ValueError, match="truncated GGUF file"):
            read(str(path))


# --- tiny bundles through both packages -------------------------------------------

LAYOUTS = {
    "sd1": ("tiny-unet", "tiny-vae", "tiny-te", None),
    "sdxl": ("tiny-unet-adm", "tiny-vae", "tiny-te-l", "tiny-te-g"),
}


@pytest.fixture
def f32_registries(monkeypatch):
    """Both registries' tiny configs computing in float32, for exact
    weights and f32 parity."""
    for registry in (jreg.MODEL_REGISTRY, treg.MODEL_REGISTRY):
        for name in ("tiny-unet", "tiny-unet-adm", "tiny-vae", "tiny-te", "tiny-te-l",
                     "tiny-te-g"):
            monkeypatch.setitem(registry, name, {**registry[name],
                                                 "config": f32(registry[name]["config"])})


def _seeded_port_bundle(layout, seed):
    """A port bundle on the CPU whose every parameter comes from numpy-
    seeded JAX trees (seeded_flax_params) through from_jax_params, and
    those trees."""
    unet_name, vae_name, te_name, te2_name = LAYOUTS[layout]
    tb = tpl.load_pipeline(unet_name, device="cpu")
    ctx = jreg.get_config(unet_name).context_dim
    te_len = jreg.get_config(te_name).max_length
    trees = {
        "unet": seeded_flax_params(jreg.create_model(unet_name), seed, jnp.zeros((1, 16, 16, 4)),
                                   jnp.zeros((1,)), jnp.zeros((1, te_len, ctx))),
        "vae": seeded_flax_params(jreg.create_model(vae_name), seed + 1,
                                  jnp.zeros((1, 32, 32, 3))),
        "te": seeded_flax_params(jreg.create_model(te_name), seed + 2,
                                 jnp.zeros((1, te_len), jnp.int32)),
    }
    if te2_name:
        trees["te2"] = seeded_flax_params(jreg.create_model(te2_name), seed + 3,
                                          jnp.zeros((1, te_len), jnp.int32))
    for part, module in tb.parts().items():
        module.load_state_dict(from_jax_params(flatten_params(trees[part]), module))
    return tb, trees


def _jax_schedules(layout):
    unet_name, vae_name, te_name, te2_name = LAYOUTS[layout]
    te_prefix = ("conditioner.embedders.0.transformer.text_model" if layout == "sdxl"
                 else "cond_stage_model.transformer.text_model")
    out = {"unet": jsdc.unet_schedule(jreg.get_config(unet_name)),
           "vae": jsdc.vae_schedule(jreg.get_config(vae_name)),
           "te": jsdc.text_encoder_schedule(jreg.get_config(te_name), prefix=te_prefix)}
    if te2_name:
        out["te2"] = jsdc.open_clip_schedule(jreg.get_config(te2_name))
    return out


def _assert_same_weights(bundle, jax_params):
    """Every parameter of the port bundle equals the JAX bundle's, carried
    by from_jax_params."""
    for part, module in bundle.parts().items():
        want = from_jax_params(flatten_params(jax.device_get(jax_params[part])), module)
        got = module.state_dict()
        assert set(got) == set(want)
        for name, value in want.items():
            assert torch.equal(got[name], value), (part, name)


@pytest.mark.parametrize("layout", ["sd1", "sdxl"])
def test_a_written_file_loads_alike_in_both_packages(layout, tmp_path, monkeypatch,
                                                     f32_registries):
    """Seeded weights → the port's synthesize_checkpoint and writer → one
    file, which the JAX package's read_checkpoint (the safetensors
    package) reads back exactly and its load_pipeline loads; the port's
    load_pipeline finds it through CDT_CHECKPOINT_DIR. Both hold the
    written weights exactly, and txt2img from the JAX package's noise
    agrees within tests/test_torch_txt2img.py's image tolerance (5e-5)."""
    source, trees = _seeded_port_bundle(layout, SEED)
    state = tsdc.synthesize_checkpoint(source)
    # the same state dict the JAX package's inverse schedule writes
    jax_state = {}
    for part, entries in _jax_schedules(layout).items():
        jax_state.update(jsdc.synthesize_state_dict(flatten_params(trees[part]), entries))
    assert list(state) == list(jax_state)
    for key, value in jax_state.items():
        np.testing.assert_array_equal(state[key].numpy(), value, err_msg=key)

    model = LAYOUTS[layout][0]
    path = str(tmp_path / f"{model}.safetensors")
    tsdc.save_safetensors(state, path)
    read = jsdc.read_checkpoint(path)
    assert set(read) == set(state)
    for key, value in read.items():
        np.testing.assert_array_equal(value, state[key].numpy(), err_msg=key)

    jb = jpl.load_pipeline(model, seed=0, checkpoint=path)
    monkeypatch.setenv("CDT_CHECKPOINT_DIR", str(tmp_path))
    tb = tpl.load_pipeline(model, seed=0, device="cpu")
    _assert_same_weights(tb, jb.params)
    for part, module in tb.parts().items():
        for name, value in source.parts()[part].state_dict().items():
            assert torch.equal(module.state_dict()[name], value), (part, name)

    kw = dict(height=32, width=32, steps=2, sampler="euler", scheduler="karras", cfg_scale=3.0,
              seed=SEED)
    ref = np.asarray(jpl.txt2img(jb, "a lighthouse at dusk", "blurry", **kw))
    # _txt2img_jit's initial noise: normal(split(key(seed), 3)[1])
    noise_key = jax.random.split(jax.random.key(SEED), 3)[1]
    side = 32 // tb.latent_scale
    noise = torch.from_numpy(np.array(jax.random.normal(noise_key, (1, side, side, 4))))
    out = tpl.txt2img(tb, "a lighthouse at dusk", "blurry", noise=noise, **kw).numpy()
    assert out.shape == ref.shape == (1, 32, 32, 3) and out.std() > 0.01
    np.testing.assert_allclose(out, ref, atol=5e-5, rtol=0)


def test_the_sd2_layout_maps_alike_in_both_packages(f32_registries):
    """cond_stage_model.model.* keys (the OpenCLIP tower: fused in_proj,
    bare positional embedding and projection) with tiny-unet, tiny-vae
    and the OpenCLIP-shaped tiny-te-g, at load_sd_weights, as the JAX
    package's test_sd2_openclip_te_prefix_detected: the same weights,
    exactly, in both."""
    unet_cfg, vae_cfg, te_cfg = (treg.get_config(n) for n in ("tiny-unet", "tiny-vae",
                                                                "tiny-te-g"))
    modules = {part: treg.create_model(name) for part, name in
               (("unet", "tiny-unet"), ("vae", "tiny-vae"), ("te", "tiny-te-g"))}
    trees = {
        "unet": seeded_flax_params(jreg.create_model("tiny-unet"), 3, jnp.zeros((1, 16, 16, 4)),
                                   jnp.zeros((1,)), jnp.zeros((1, 16, 64))),
        "vae": seeded_flax_params(jreg.create_model("tiny-vae"), 4, jnp.zeros((1, 32, 32, 3))),
        "te": seeded_flax_params(jreg.create_model("tiny-te-g"), 5, jnp.zeros((1, 16), jnp.int32)),
    }
    for part, module in modules.items():
        module.load_state_dict(from_jax_params(flatten_params(trees[part]), module))
    schedules = tsdc.sd_schedules("sd2", unet_cfg, vae_cfg, te_cfg)
    state = {}
    for part, entries in schedules.items():
        state.update(tsdc.synthesize_state_dict(modules[part].state_dict(), entries))
    assert "cond_stage_model.model.transformer.resblocks.0.attn.in_proj_weight" in state
    assert tsdc.checkpoint_layout(state) == "sd2"

    numpy_state = {k: v.numpy() for k, v in state.items()}
    jax_out, problems = jsdc.load_sd_weights(
        numpy_state, jreg.get_config("tiny-unet"), jreg.get_config("tiny-vae"),
        jreg.get_config("tiny-te-g"), trees)
    assert problems == []
    fresh = {part: treg.create_model(name) for part, name in
             (("unet", "tiny-unet"), ("vae", "tiny-vae"), ("te", "tiny-te-g"))}
    tsdc.load_sd_weights(state, unet_cfg, vae_cfg, te_cfg, fresh)  # raises on a problem
    for part, module in fresh.items():
        want = from_jax_params(flatten_params(jax_out[part]), module)
        for name, value in module.state_dict().items():
            assert torch.equal(value, want[name]), (part, name)
            assert torch.equal(value, modules[part].state_dict()[name]), (part, name)


# --- the port's own loader cases -----------------------------------------------

@pytest.fixture
def sd1_file(tmp_path, f32_registries):
    """(a seeded tiny-unet bundle, its state dict, the directory holding it
    as tiny-unet.safetensors)."""
    source, _ = _seeded_port_bundle("sd1", SEED + 10)
    state = tsdc.synthesize_checkpoint(source)
    tsdc.save_safetensors(state, str(tmp_path / "tiny-unet.safetensors"))
    return source, state, tmp_path


def _load(directory, monkeypatch, model="tiny-unet"):
    monkeypatch.setenv("CDT_CHECKPOINT_DIR", str(directory))
    return tpl.load_pipeline(model, device="cpu")


def _equal_bundles(a, b):
    for part, module in a.parts().items():
        other = b.parts()[part].state_dict()
        if any(not torch.equal(v, other[k]) for k, v in module.state_dict().items()):
            return False
    return True


def test_extra_keys_and_int64_or_float_position_ids_are_ignored(sd1_file, monkeypatch):
    source, state, directory = sd1_file
    prefix = "cond_stage_model.transformer.text_model.embeddings.position_ids"
    for ids in (torch.arange(16)[None], torch.arange(16, dtype=torch.float32)[None]):
        extra = {**state, prefix: ids, "model_ema.decay": torch.tensor(0.9999),
                 "alphas_cumprod": torch.linspace(1.0, 0.0, 1000)}
        tsdc.save_safetensors(extra, str(directory / "tiny-unet.safetensors"))
        assert _equal_bundles(_load(directory, monkeypatch), source)


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_a_missing_key_or_a_wrong_shape_raises(sd1_file, monkeypatch, fault):
    _, state, directory = sd1_file
    key = "model.diffusion_model.input_blocks.1.1.proj_in.weight"
    state = dict(state)
    if fault == "missing":
        del state[key]
        match = "checkpoint lacks " + key
    else:
        state[key] = torch.zeros((3, 3))
        match = "shape mismatch"
    tsdc.save_safetensors(state, str(directory / "tiny-unet.safetensors"))
    with pytest.raises(ValueError, match=match):
        _load(directory, monkeypatch)


def test_ckpt_files_round_trip(sd1_file, monkeypatch):
    source, state, directory = sd1_file
    os.remove(directory / "tiny-unet.safetensors")
    torch.save({"state_dict": dict(state), "global_step": 3}, directory / "tiny-unet.ckpt")
    assert _equal_bundles(_load(directory, monkeypatch), source)
    assert _read(str(directory / "tiny-unet.ckpt")).keys() == state.keys()


def test_proj_weights_load_as_1x1_convs_too(sd1_file, monkeypatch):
    """SD1.x files store the transformers' proj_in/proj_out and the VAE's
    mid-attention projections as 1x1 convs."""
    source, state, directory = sd1_file
    convs = {k: (v[:, :, None, None] if k.endswith(("proj_in.weight", "proj_out.weight",
                                                       "attn_1.q.weight")) else v)
             for k, v in state.items()}
    assert sum(v.ndim == 4 and v.shape[-1] == 1 for v in convs.values()) >= 5
    tsdc.save_safetensors(convs, str(directory / "tiny-unet.safetensors"))
    assert _equal_bundles(_load(directory, monkeypatch), source)


def test_without_a_file_the_init_is_the_seeded_random_one(tmp_path, monkeypatch):
    monkeypatch.setenv("CDT_CHECKPOINT_DIR", str(tmp_path))
    (tmp_path / "sd15.safetensors").write_bytes(b"")  # another model's file
    a = tpl.load_pipeline("tiny-unet", seed=3, device="cpu")
    monkeypatch.delenv("CDT_CHECKPOINT_DIR")
    b = tpl.load_pipeline("tiny-unet", seed=3, device="cpu")
    assert _equal_bundles(a, b)
    assert float(a.unet.out_conv.weight.abs().max()) == 0.0


def test_a_standalone_text_encoder_file_fills_its_tower(sd1_file, monkeypatch):
    """Without a checkpoint, CDT_CHECKPOINT_DIR/tiny-te.safetensors (HF
    layout, bare text_model.* keys) fills the text tower, as the JAX
    package's _load_te_checkpoint does."""
    source, _, directory = sd1_file
    os.remove(directory / "tiny-unet.safetensors")
    te_cfg = treg.get_config("tiny-te")
    entries = tsdc.text_encoder_schedule(te_cfg, prefix="text_model")
    tsdc.save_safetensors(tsdc.synthesize_state_dict(source.text_encoder.state_dict(), entries),
                          str(directory / "tiny-te.safetensors"))
    tb = _load(directory, monkeypatch)
    for name, value in source.text_encoder.state_dict().items():
        assert torch.equal(tb.text_encoder.state_dict()[name], value), name
    assert not torch.equal(tb.vae.decoder.conv_in.weight, source.vae.decoder.conv_in.weight)


def test_vae_loader_reads_a_standalone_vae_file(sd1_file, monkeypatch):
    """VAELoader resolves `tiny-vae.safetensors` by stem (bare encoder./
    decoder. keys), as the JAX package's load_vae maps it; the USDU node
    swaps it into a copy of the bundle and the cached bundle keeps its
    own VAE."""
    from comfyui_distributed_tpu_torch.graph import ExecutionContext
    from comfyui_distributed_tpu_torch.graph.nodes_core import VAEDecode, VAELoader

    source, _, directory = sd1_file
    os.remove(directory / "tiny-unet.safetensors")
    vae_cfg = treg.get_config("tiny-vae")
    tsdc.save_safetensors(tsdc.synthesize_state_dict(source.vae.state_dict(),
                                                     tsdc.vae_schedule(vae_cfg, prefix="")),
                          str(directory / "tiny-vae.safetensors"))
    monkeypatch.setenv("CDT_CHECKPOINT_DIR", str(directory))
    context = ExecutionContext(device="cpu")
    (vae,) = VAELoader().load_vae("tiny-vae.safetensors", context=context)
    for name, value in source.vae.state_dict().items():
        assert torch.equal(vae.vae.state_dict()[name], value), name
    jvae = jpl.load_vae("tiny-vae")
    want = from_jax_params(flatten_params(jax.device_get(jvae.params["vae"])), vae.vae)
    assert all(torch.equal(vae.vae.state_dict()[k], v) for k, v in want.items())

    bundle = tpl.load_pipeline("tiny-unet", device="cpu")
    before = {k: v.clone() for k, v in bundle.vae.state_dict().items()}
    swapped = dataclasses.replace(bundle, vae=vae.vae, latent_channels=vae.latent_channels,
                                  latent_scale=vae.latent_scale)
    assert swapped.vae is vae.vae and bundle.vae is not vae.vae
    assert all(torch.equal(bundle.vae.state_dict()[k], v) for k, v in before.items())
    z = torch.zeros((1, 4, 4, 4))
    (img,) = VAEDecode().decode({"samples": z}, vae, context=context)
    assert torch.equal(img, source.vae.decode(z))
