"""LoRA and weight merges in the PyTorch port against the JAX package.

The same seeded numpy LoRA goes through both packages' `apply_lora`: the
port's merged weights ([O, I]) equal the JAX kernels ([I, O]) transposed
at rtol 1e-5, atol 1e-6 (f32; the two sum the rank product in their own
order). The target maps equal the JAX maps name for name, their
parameters named by models/io.py's rule. The four nodes run through the
port's GraphExecutor and leave their input bundles as they were.
"""

import dataclasses

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.graph.nodes_loaders import _merge_trees as jax_merge_trees
from comfyui_distributed_tpu.models import get_config as jax_config
from comfyui_distributed_tpu.models.io import flatten_params, unflatten_params
from comfyui_distributed_tpu.models.lora import apply_lora as jax_apply_lora
from comfyui_distributed_tpu.models.lora import lora_target_map as jax_target_map
from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.models.io import _torch_name_and_value
from comfyui_distributed_tpu_torch.models.lora import apply_lora, lora_target_map
from comfyui_distributed_tpu_torch.models.registry import get_config
from comfyui_distributed_tpu_torch.models.sd_checkpoint import save_safetensors

RTOL, ATOL = 1e-5, 1e-6

# (backbone, first text tower, second text tower): tiny-unet is the SD1.x
# layout, tiny-unet-adm SDXL's, tiny-flux Flux's (CLIP as its te2)
MODELS = {
    "tiny-unet": ("tiny-te", None),
    "tiny-unet-adm": ("tiny-te-l", "tiny-te-g"),
    "tiny-flux": (None, "tiny-te"),
}


def port_name(jax_path: str) -> str:
    """A JAX target path as the port's parameter name (models/io.py)."""
    return _torch_name_and_value(jax_path, np.zeros((1, 1), np.float32))[0]


def jax_tree(module: torch.nn.Module) -> dict:
    """A module's parameters as the flax-layout tree the JAX package's
    apply_lora reads: Dense weights as [I, O] kernels, the rest under
    their own names."""
    flat = {}
    for name, param in module.named_parameters():
        *path, leaf = name.split(".")
        owner = module.get_submodule(".".join(path))
        value = param.detach().float().numpy().copy()
        if leaf == "weight" and isinstance(owner, torch.nn.Linear):
            leaf, value = "kernel", value.T.copy()
        flat["/".join(["params", *path, leaf])] = value
    return unflatten_params(flat)


def f32_bundle(model_name: str, seed: int = 0) -> tpl.PipelineBundle:
    bundle = tpl.load_pipeline(model_name, seed=seed, device="cpu")
    for module in bundle.parts().values():
        module.float()
    return bundle


def seeded_lora(targets: dict, shapes: dict, seed: int, rank: int = 4, alpha: float = 2.0,
                conv: tuple = ()) -> dict:
    """A kohya state dict covering every target, `conv` names in the
    1x1-conv layout, alpha as a 0-d array."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name in sorted(targets):
        dim_out, dim_in = shapes[name]
        down = rng.standard_normal((rank, dim_in), dtype=np.float32) * 0.1
        up = rng.standard_normal((dim_out, rank), dtype=np.float32) * 0.1
        if name in conv:
            down, up = down[:, :, None, None], up[:, :, None, None]
        sd[f"{name}.lora_down.weight"] = down
        sd[f"{name}.lora_up.weight"] = up
        sd[f"{name}.alpha"] = np.array(alpha, np.float32)
    return sd


def parts_of(bundle) -> dict:
    parts = {"unet": bundle.unet}
    if bundle.text_encoder is not None and not bundle.model_name.endswith("flux"):
        parts["te"] = bundle.text_encoder
    if bundle.text_encoder_2 is not None:
        parts["te2"] = bundle.text_encoder_2
    return parts


def configs(model: str):
    te, te2 = MODELS[model]
    return model, te, te2


@pytest.mark.parametrize("model", sorted(MODELS))
def test_target_maps_equal_the_jax_maps_name_for_name(model):
    model, te, te2 = configs(model)
    ours = lora_target_map(get_config(model), te and get_config(te), te2 and get_config(te2))
    theirs = jax_target_map(jax_config(model), te and jax_config(te), te2 and jax_config(te2))
    assert sorted(ours) == sorted(theirs)
    assert {name: (part, port_name(path)) for name, (part, path) in theirs.items()} == ours


def test_sd3_and_video_backbones_raise_as_in_the_jax_package():
    for name in ("tiny-sd3", "sd35-large"):
        with pytest.raises(ValueError, match="only supported for UNet- and MMDiT-family"):
            lora_target_map(get_config(name))
        with pytest.raises(ValueError, match="only supported for UNet- and MMDiT-family"):
            jax_target_map(jax_config(name))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_merged_weights_equal_the_jax_merge_transposed(model):
    """Every target of the map, a 1x1-conv pair on proj_in where the model
    has one, plus modules that do not match (unknown, no up, a shape
    that differs): merged weights and unmatched lists agree."""
    model, te, te2 = configs(model)
    bundle = f32_bundle(model)
    parts = parts_of(bundle)
    targets = lora_target_map(get_config(model), te and get_config(te), te2 and get_config(te2))
    targets = {n: t for n, t in targets.items() if t[0] in parts}
    params = {part: dict(m.named_parameters()) for part, m in parts.items()}
    shapes = {n: tuple(params[part][p].shape) for n, (part, p) in targets.items()}
    conv = tuple(n for n in targets if n.endswith("proj_in"))[:1]
    sd = seeded_lora(targets, shapes, seed=3, conv=conv)
    sd["lora_unet_not_a_module.lora_down.weight"] = np.ones((2, 3), np.float32)
    sd["lora_unet_not_a_module.lora_up.weight"] = np.ones((3, 2), np.float32)
    first = sorted(targets)[0]
    sd["lora_unet_only_down.lora_down.weight"] = np.ones((2, 3), np.float32)
    wrong = sorted(n for n in targets if targets[n][0] == "unet")[-1]
    sd[f"{wrong}.lora_up.weight"] = np.ones((shapes[wrong][0] + 1, 4), np.float32)
    trees = {part: jax_tree(m) for part, m in parts.items()}
    jmerged, junmatched = jax_apply_lora(
        trees, sd, jax_config(model), te and jax_config(te),
        te2_cfg=te2 and jax_config(te2), strength=0.8, te_strength=0.6)
    merged, unmatched = apply_lora(parts, sd, get_config(model), te and get_config(te),
                                   te2_cfg=te2 and get_config(te2), strength=0.8,
                                   te_strength=0.6)
    assert sorted(unmatched) == sorted(junmatched)
    assert {"lora_unet_not_a_module", "lora_unet_only_down", wrong} <= set(unmatched)
    assert first not in unmatched
    jflat = {part: flatten_params(tree) for part, tree in jmerged.items()}
    jaxt = jax_target_map(jax_config(model), te and jax_config(te), te2 and jax_config(te2))
    checked = 0
    for name, (part, pname) in targets.items():
        got = dict(merged[part].named_parameters())[pname].detach().numpy()
        ref = np.asarray(jflat[part][jaxt[name][1]]).T
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL, err_msg=name)
        checked += name not in unmatched
    assert checked == len(targets) - 1
    # untouched parameters are the input's own tensors
    for part, module in merged.items():
        for pname, param in module.named_parameters():
            if pname not in {p for n, (pt, p) in targets.items() if pt == part}:
                assert param is params[part][pname]


def _lora_file(tmp_path, bundle, seed: int) -> str:
    """A LoRA over the backbone and the text tower, written with the
    port's safetensors writer into tmp_path (CDT_LORA_DIR)."""
    model, te, _ = configs(bundle.model_name)
    targets = lora_target_map(get_config(model), get_config(te))
    params = {part: dict(m.named_parameters()) for part, m in parts_of(bundle).items()}
    shapes = {n: tuple(params[part][p].shape) for n, (part, p) in targets.items()}
    sd = seeded_lora(targets, shapes, seed=seed)
    save_safetensors({k: torch.from_numpy(v) for k, v in sd.items()},
                     str(tmp_path / "style.safetensors"))
    return sd


def _snapshot(bundle) -> dict:
    return {part: {n: (p, p.detach().clone()) for n, p in m.named_parameters()}
            for part, m in bundle.parts().items()}


def _unchanged(bundle, snapshot) -> bool:
    for part, module in bundle.parts().items():
        now = dict(module.named_parameters())
        for name, (obj, value) in snapshot[part].items():
            if now[name] is not obj or not torch.equal(now[name], value):
                return False
    return True


def test_the_four_nodes_through_the_executor_leave_their_inputs_unchanged(tmp_path,
                                                                          monkeypatch):
    monkeypatch.setenv("CDT_LORA_DIR", str(tmp_path))
    base, other = f32_bundle("tiny-unet", seed=0), f32_bundle("tiny-unet", seed=5)
    sd = _lora_file(tmp_path, base, seed=11)
    before = {"base": _snapshot(base), "other": _snapshot(other)}
    context = ExecutionContext(device="cpu")
    context.pipelines.update({"tiny-unet": base, "tiny-unet-b": other})
    prompt = {
        "1": {"class_type": "CheckpointLoaderSimple", "inputs": {"ckpt_name": "tiny-unet"}},
        "2": {"class_type": "CheckpointLoaderSimple", "inputs": {"ckpt_name": "tiny-unet-b"}},
        "3": {"class_type": "LoraLoader", "inputs": {
            "model": ["1", 0], "clip": ["1", 1], "lora_name": "style",
            "strength_model": 0.8, "strength_clip": 0.5}},
        "4": {"class_type": "LoraLoaderModelOnly", "inputs": {
            "model": ["1", 0], "lora_name": str(tmp_path / "style.safetensors"),
            "strength_model": 0.8}},
        "5": {"class_type": "ModelMergeSimple", "inputs": {
            "model1": ["1", 0], "model2": ["2", 0], "ratio": 0.3}},
        "6": {"class_type": "CLIPMergeSimple", "inputs": {
            "clip1": ["1", 1], "clip2": ["2", 1], "ratio": 0.3}},
        "7": {"class_type": "ModelMergeSimple", "inputs": {
            "model1": ["1", 0], "model2": ["2", 0], "ratio": 1.0}},
    }
    GraphExecutor(context).execute(prompt)
    results = GraphExecutor(context)
    results.execute(prompt)
    out = results.last_results
    assert _unchanged(base, before["base"]) and _unchanged(other, before["other"])
    assert context.pipelines["tiny-unet"] is base

    lora_model, lora_clip = out["3"]
    merged, _ = apply_lora({"unet": base.unet, "te": base.text_encoder}, sd,
                           get_config("tiny-unet"), get_config("tiny-te"), strength=0.8,
                           te_strength=0.5)
    for got, ref in ((lora_model.unet, merged["unet"]), (lora_clip.text_encoder, merged["te"])):
        for (n, a), (_, b) in zip(got.named_parameters(), ref.named_parameters()):
            assert torch.equal(a, b), n
    # each output patches its own input: the MODEL's towers and the CLIP's
    # backbone are the base bundle's
    assert lora_model.text_encoder is base.text_encoder and lora_clip.unet is base.unet
    (model_only,) = out["4"]
    for (n, a), (_, b) in zip(model_only.unet.named_parameters(), lora_model.unet.named_parameters()):
        assert torch.equal(a, b), n
    assert model_only.text_encoder is base.text_encoder

    (mixed,) = out["5"]
    jmixed = flatten_params(jax_merge_trees(jax_tree(base.unet), jax_tree(other.unet), 0.3, "t"))
    for name, param in mixed.unet.named_parameters():
        *path, leaf = name.split(".")
        owner = base.unet.get_submodule(".".join(path))
        key = "/".join(["params", *path, "kernel" if leaf == "weight" and isinstance(
            owner, torch.nn.Linear) else leaf])
        ref = np.asarray(jmixed[key])
        ref = ref.T if key.endswith("kernel") else ref
        np.testing.assert_array_equal(param.detach().numpy(), ref, err_msg=name)
    assert mixed.text_encoder is base.text_encoder
    (clip_mixed,) = out["6"]
    jclip = flatten_params(jax_merge_trees(jax_tree(base.text_encoder),
                                           jax_tree(other.text_encoder), 0.3, "t"))
    for name, param in clip_mixed.text_encoder.named_parameters():
        *path, leaf = name.split(".")
        owner = base.text_encoder.get_submodule(".".join(path))
        key = "/".join(["params", *path, "kernel" if leaf == "weight" and isinstance(
            owner, torch.nn.Linear) else leaf])
        ref = np.asarray(jclip[key])
        np.testing.assert_array_equal(param.detach().numpy(), ref.T if key.endswith("kernel")
                                      else ref, err_msg=name)
    assert clip_mixed.unet is base.unet
    (whole,) = out["7"]
    for (n, a), (_, b) in zip(whole.unet.named_parameters(), base.unet.named_parameters()):
        assert torch.equal(a, b), n


def test_merges_refuse_two_architectures_and_a_missing_tower():
    from comfyui_distributed_tpu_torch.graph.nodes_loaders import CLIPMergeSimple, ModelMergeSimple

    sd15, sdxl = f32_bundle("tiny-unet"), f32_bundle("tiny-unet-adm")
    with pytest.raises(ValueError, match="parameter trees differ"):
        ModelMergeSimple().merge(sd15, sdxl, 0.5)
    with pytest.raises(ValueError, match="clip2 has no 'te2' part"):
        CLIPMergeSimple().merge(sdxl, dataclasses.replace(sdxl, text_encoder_2=None), 0.5)


def test_a_lora_the_model_cannot_wear_is_reported_not_fatal(tmp_path, monkeypatch):
    """LoraLoaderModelOnly on a file of text-tower modules only: every
    module unmatched, the backbone returned as it is; a missing file
    raises FileNotFoundError."""
    from comfyui_distributed_tpu_torch.graph.nodes_core import LoraLoaderModelOnly

    monkeypatch.setenv("CDT_LORA_DIR", str(tmp_path))
    base = f32_bundle("tiny-unet")
    targets = {n: t for n, t in lora_target_map(get_config("tiny-unet"),
                                                get_config("tiny-te")).items() if t[0] == "te"}
    params = dict(base.text_encoder.named_parameters())
    sd = seeded_lora(targets, {n: tuple(params[p].shape) for n, (_, p) in targets.items()}, 2)
    save_safetensors({k: torch.from_numpy(v) for k, v in sd.items()},
                     str(tmp_path / "te_only.safetensors"))
    (out,) = LoraLoaderModelOnly().load_lora_model_only(base, "te_only", 1.0)
    assert out.unet is base.unet
    with pytest.raises(FileNotFoundError, match="LoRA not found"):
        LoraLoaderModelOnly().load_lora_model_only(base, "missing", 1.0)
