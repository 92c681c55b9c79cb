"""The WAN stack's checkpoint schedules and loaders in the port
(models/sd_checkpoint.py) against the JAX package's.

- `wan_schedule` (wan-1.3b, wan-14b-i2v; bare and ComfyUI-repacked),
  `wan_vae_schedule` (wan-vae) and `clip_vision_schedule`
  (clip-vision-h) at full width: the same state-dict keys in the same
  order, each to the parameter the JAX flax path names under
  models/io.py's rule, and every parameter of the port's module (built
  on meta) filled exactly once;
- files in the original layouts (a tiny-dit-i2v DiT, bare and repacked,
  a tiny-video-vae-3d VAE and a tiny-clip-vision tower), synthesized by
  the JAX package from seeded weights and written by the port's writer,
  loaded by both packages' loaders: the port's parameters equal the JAX
  package's, exactly (f32 throughout)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import sd_checkpoint as jsdc
from comfyui_distributed_tpu.models.io import flatten_params
from comfyui_distributed_tpu_torch.models import clip_vision as tcv
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import sd_checkpoint as tsdc
from comfyui_distributed_tpu_torch.models import video_pipeline as tvp
from comfyui_distributed_tpu_torch.models.io import from_jax_params

from test_torch_parity import f32, seeded_flax_params


def _torch_name(flax_path: str) -> str:
    """A JAX schedule's flax path as the port's parameter name (models/
    io.py's rule)."""
    parts = flax_path.split("/")
    if parts[-1] in ("kernel", "scale", "embedding"):
        parts[-1] = "weight"
    return ".".join(parts)


SCHEDULES = {
    "wan-1.3b": ("wan_schedule", {}),
    "wan-14b-i2v": ("wan_schedule", {}),
    "wan-14b-i2v repacked": ("wan_schedule", {"prefix": "model.diffusion_model."}),
    "wan-vae": ("wan_vae_schedule", {}),
    "clip-vision-h": ("clip_vision_schedule", {}),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_schedules_equal_the_jax_ones_at_full_width(case):
    name = case.split()[0]
    fn, kwargs = SCHEDULES[case]
    jexp = jsdc._expand(getattr(jsdc, fn)(jreg.get_config(name), **kwargs))
    texp = tsdc._expand(getattr(tsdc, fn)(treg.get_config(name), **kwargs))
    assert [k for k, _, _ in texp] == [k for k, _, _ in jexp]
    assert [n for _, n, _ in texp] == [_torch_name(p) for _, p, _ in jexp]
    with torch.device("meta"):
        module = treg.create_model(name)
    names = [n for _, n, _ in texp]
    assert len(names) == len(set(names))
    assert set(names) == set(module.state_dict())
    shapes = {n: tuple(p.shape) for n, p in module.state_dict().items()}
    if name == "wan-14b-i2v":
        assert shapes["patch_embed.weight"] == (5120, 36 * 4)
        assert shapes["block_39.cross_attn_k_img.weight"] == (5120, 5120)
        assert shapes["block_0.modulation"] == (1, 6, 5120)
    if name == "clip-vision-h":
        assert shapes["position_embedding"] == (257, 1280) and "block_30.fc1.weight" in shapes
        assert "block_31.fc1.weight" not in shapes  # penultimate: 31 blocks


def _write(tmp_path, stem: str, state: dict) -> str:
    path = str(tmp_path / f"{stem}.safetensors")
    tsdc.save_safetensors({k: torch.from_numpy(np.array(v))
                           for k, v in state.items()}, path)
    return path


def _assert_carried(module, jax_params):
    want = from_jax_params(flatten_params(jax_params), module)
    got = module.state_dict()
    for key, value in want.items():
        torch.testing.assert_close(got[key], value, rtol=0, atol=0, msg=key)


@pytest.mark.parametrize("repacked", [False, True])
def test_wan_files_load_equal_weights_in_both_packages(tmp_path, monkeypatch, repacked):
    """A tiny-dit-i2v DiT file (bare `blocks.N.*` or under
    `model.diffusion_model.`), a tiny-video-vae-3d VAE file and a
    tiny-clip-vision file under CDT_CHECKPOINT_DIR: the JAX loaders and
    the port's load_video_pipeline fill the same weights."""
    names = ("tiny-dit-i2v", "tiny-video-vae-3d", "tiny-clip-vision")
    for registry in (jreg.MODEL_REGISTRY, treg.MODEL_REGISTRY):
        for name in names:
            monkeypatch.setitem(registry, name, {**registry[name],
                                                 "config": f32(registry[name]["config"])})
    dit_cfg, vae_cfg, cv_cfg = (jreg.get_config(n) for n in names)
    dit, vae, cv = (jreg.create_model(n) for n in names)
    params = {
        "dit": seeded_flax_params(dit, 21, jnp.zeros((1, 2, 4, 4, 36)), jnp.zeros((1,)),
                                  jnp.zeros((1, 16, 64)), jnp.zeros((1, 17, 48))),
        "vae": seeded_flax_params(vae, 22, jnp.zeros((1, 3, 32, 32, 3))),
        "cv": seeded_flax_params(cv, 23, jnp.zeros((1, 32, 32, 3))),
    }
    dit_sd = jsdc.synthesize_state_dict(flatten_params(params["dit"]), jsdc.wan_schedule(dit_cfg))
    if repacked:
        dit_sd = {f"model.diffusion_model.{k}": v for k, v in dit_sd.items()}
    files = {
        "tiny-dit-i2v": _write(tmp_path, "tiny-dit-i2v", dit_sd),
        "tiny-video-vae-3d": _write(tmp_path, "tiny-video-vae-3d", jsdc.synthesize_state_dict(
            flatten_params(params["vae"]), jsdc.wan_vae_schedule(vae_cfg))),
        "tiny-clip-vision": _write(tmp_path, "tiny-clip-vision", jsdc.synthesize_state_dict(
            flatten_params(params["cv"]), jsdc.clip_vision_schedule(cv_cfg))),
    }
    with tsdc.open_checkpoint(files["tiny-dit-i2v"]) as state_dict:
        assert tsdc.checkpoint_layout(state_dict) == "wan"
    loaded = {
        "dit": jsdc.load_wan_weights(jsdc.read_checkpoint(files["tiny-dit-i2v"]), dit_cfg,
                                     params["dit"])[0],
        "vae": jsdc.load_wan_vae_weights(jsdc.read_checkpoint(files["tiny-video-vae-3d"]),
                                         vae_cfg, params["vae"])[0],
        "cv": jsdc.load_clip_vision_weights(jsdc.read_checkpoint(files["tiny-clip-vision"]),
                                            cv_cfg, params["cv"])[0],
    }
    monkeypatch.setenv("CDT_CHECKPOINT_DIR", str(tmp_path))
    tb = tvp.load_video_pipeline("tiny-dit-i2v", vae_name="tiny-video-vae-3d", device="cpu")
    _assert_carried(tb.dit, loaded["dit"])
    _assert_carried(tb.vae, loaded["vae"])
    _assert_carried(tb.clip_vision, loaded["cv"])
    _assert_carried(tcv.load_clip_vision("tiny-clip-vision", device="cpu").module, loaded["cv"])
    # strict on the port's side too
    with pytest.raises(ValueError, match="WAN checkpoint mapping failed"):
        tsdc.load_wan_weights({}, treg.get_config("tiny-dit-i2v"), tb.dit)


def test_a_wan_file_is_refused_as_an_sd_checkpoint():
    state = {"blocks.0.self_attn.q.weight": torch.zeros(1)}
    with pytest.raises(ValueError, match="WAN video DiT file"):
        tsdc.load_sd_weights(state, None, None, None, {})
