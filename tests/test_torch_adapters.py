"""The adapter plane of the PyTorch port against the JAX package.

- specs: the same payloads give the same errors, the same wire forms and
  the same plan keys; content hashes of a file and of an in-memory state
  dict equal the JAX package's (blake2b over the same bytes);
- operands: `bundle_target_map`, `build_operands` and `compose_operands`
  give the JAX package's arrays bit for bit on the same numpy LoRA for
  the weights it covers (the JAX package's are zeros elsewhere), and
  `patch_params` the JAX kernels transposed at rtol 1e-5, atol 1e-6
  (f32; the rank product sums in its own order);
- two catalogs whose files differ under one name refuse each other's
  hash;
- the repair: an unknown adapter, or more than MAX_ADAPTERS_PER_REQUEST,
  is answered 400 by both packages' queue routes with the same text, and
  no job is created;
- a tiny-unet elastic job over HTTP wearing an adapter: master and w1
  each patch their backbone, and the output is within one 8-bit level of
  the LoraLoaderModelOnly bundle's tiles composited the elastic way.
"""

import types

import numpy as np
import pytest
import torch

import chip_smoke
from comfyui_distributed_tpu.adapters import registry as jreg
from comfyui_distributed_tpu.adapters import segmented as jseg
from comfyui_distributed_tpu.models.io import flatten_params
from comfyui_distributed_tpu_torch.adapters import cache as tcache
from comfyui_distributed_tpu_torch.adapters import registry as treg
from comfyui_distributed_tpu_torch.adapters import segmented as tseg
from comfyui_distributed_tpu_torch.graph.nodes_core import LoraLoaderModelOnly
from comfyui_distributed_tpu_torch.models.lora import lora_target_map
from comfyui_distributed_tpu_torch.models.registry import get_config
from comfyui_distributed_tpu_torch.models.sd_checkpoint import save_safetensors
from comfyui_distributed_tpu_torch.utils.network import request_json

from test_torch_control_routes import apps  # noqa: F401  (fixture)
from test_torch_lora import f32_bundle, jax_tree, port_name, seeded_lora
from test_torch_parity import one_torch_thread, port_loop  # noqa: F401  (fixtures)
from test_torch_server import _upscale_prompt, _wait_done, cluster  # noqa: F401  (fixture)

RTOL, ATOL = 1e-5, 1e-6
pytestmark = pytest.mark.usefixtures("one_torch_thread")

BAD_SPECS = [
    "style",
    {"name": "style"},
    [1],
    [{"name": ""}],
    [{"name": "  "}],
    [{"strength": 1.0}],
    [{"name": "a"}, {"name": "a"}],
    [{"name": "a", "strength": True}],
    [{"name": "a", "strength": "1"}],
    [{"name": "a", "strength": float("inf")}],
    [{"name": "a", "strength": float("nan")}],
    [{"name": "a", "content_hash": 7}],
    [{"name": f"a{i}"} for i in range(5)],
]


@pytest.mark.parametrize("raw", BAD_SPECS, ids=range(len(BAD_SPECS)))
def test_bad_specs_raise_the_jax_packages_errors(raw):
    with pytest.raises(treg.AdapterError) as ours:
        treg.parse_adapter_specs(raw)
    with pytest.raises(jreg.AdapterError) as theirs:
        jreg.parse_adapter_specs(raw)
    assert str(ours.value) == str(theirs.value)


def test_wire_forms_and_plan_keys_equal_the_jax_packages():
    raw = [" a ", {"name": "b", "strength": 0.7}, {"name": "c", "strength": 2,
                                                 "content_hash": "ff"}]
    ours, theirs = treg.parse_adapter_specs(raw), jreg.parse_adapter_specs(raw)
    assert treg.specs_to_wire(ours) == jreg.specs_to_wire(theirs)
    assert treg.specs_from_wire(treg.specs_to_wire(ours)) == ours
    assert treg.parse_adapter_specs(None) == [] == jreg.parse_adapter_specs([])
    stamped = [treg.AdapterSpec(s.name, s.strength, "h" + s.name) for s in ours]
    jstamped = [jreg.AdapterSpec(s.name, s.strength, "h" + s.name) for s in theirs]
    assert treg.adapter_plan_key(stamped) == jreg.adapter_plan_key(jstamped)
    for module in (treg, jreg):
        with pytest.raises(module.AdapterError, match="no content hash"):
            module.adapter_plan_key(module.parse_adapter_specs(["x"]))


def _lora_sd(seed=0, names=("lora_unet_foo", "lora_te_bar")):
    rng = np.random.default_rng(seed)
    sd = {}
    for name in names:
        sd[f"{name}.lora_down.weight"] = rng.standard_normal((2, 4), dtype=np.float32)
        sd[f"{name}.lora_up.weight"] = rng.standard_normal((4, 2), dtype=np.float32)
        sd[f"{name}.alpha"] = np.array(2.0, np.float32)
    return sd


def test_content_hashes_equal_the_jax_packages(tmp_path, monkeypatch):
    """A file through the port's writer, found in CDT_LORA_DIR, and the
    same state dict in memory: both catalogs stamp the same hashes."""
    monkeypatch.setenv("CDT_LORA_DIR", str(tmp_path))
    sd = _lora_sd(1)
    save_safetensors({k: torch.from_numpy(v) for k, v in sd.items()},
                     str(tmp_path / "style.safetensors"))
    ours, theirs = treg.AdapterCatalog(), jreg.AdapterCatalog()
    for catalog in (ours, theirs):
        catalog.register_memory("mem", sd)
    assert ours.names() == theirs.names() == ["mem", "style"]
    for name in ("style", "mem"):
        assert ours.content_hash(name) == theirs.content_hash(name)
    assert ours.content_hash("style") != ours.content_hash("mem")
    loaded = ours.load_state_dict("style")
    assert sorted(loaded) == sorted(sd)
    for key in sd:
        np.testing.assert_array_equal(loaded[key], sd[key])
    resolved = ours.resolve(treg.parse_adapter_specs([{"name": "style", "strength": 0.5}]))
    jresolved = theirs.resolve(jreg.parse_adapter_specs([{"name": "style", "strength": 0.5}]))
    assert treg.specs_to_wire(resolved) == jreg.specs_to_wire(jresolved)
    for catalog, error in ((ours, treg.AdapterError), (theirs, jreg.AdapterError)):
        with pytest.raises(error, match="unknown adapter 'nope'"):
            catalog.resolve([type(resolved[0])("nope")])


def test_two_catalogs_with_different_files_refuse_each_others_hash(tmp_path):
    master, worker = treg.AdapterCatalog(), treg.AdapterCatalog()
    master.register_memory("style", _lora_sd(1))
    worker.register_memory("style", _lora_sd(2))
    stamped = master.resolve([treg.AdapterSpec("style", 0.8)])
    with pytest.raises(treg.AdapterError, match="content mismatch"):
        worker.resolve(stamped)
    same = treg.AdapterCatalog()
    same.register_memory("style", _lora_sd(1))
    assert same.resolve(stamped) == stamped


@pytest.fixture(scope="module")
def tiny():
    """A tiny-unet bundle at f32, its JAX-layout params and both
    packages' backbone target maps."""
    bundle = f32_bundle("tiny-unet", seed=2)
    jbundle = types.SimpleNamespace(model_name="tiny-unet",
                                    params={"unet": jax_tree(bundle.unet)})
    return bundle, jbundle, tseg.bundle_target_map(bundle), jseg.bundle_target_map(jbundle)


def _adapter(targets, seed, rank=4):
    params = {n: (shape[1], shape[0]) for n, (_, shape) in targets.items()}
    names = sorted(targets)[seed % 3::2]
    sd = seeded_lora({n: None for n in names}, params, seed=seed, rank=rank,
                     conv=tuple(n for n in names if n.endswith("proj_in"))[:1])
    sd.update(_lora_sd(seed, names=("lora_te_text_model_encoder_layers_0_mlp_fc1",)))
    return sd


def test_target_maps_and_operands_equal_the_jax_packages(tiny):
    bundle, jbundle, targets, jtargets = tiny
    assert sorted(targets) == sorted(jtargets)
    for name, (path, shape) in jtargets.items():
        assert targets[name] == ("unet/" + port_name(path[len("unet/"):]), shape)
    sd_a, sd_b = _adapter(targets, 1, rank=3), _adapter(targets, 2, rank=8)
    ops_a, jops_a = tseg.build_operands(sd_a, targets), jseg.build_operands(sd_a, jtargets)
    ops_b, jops_b = tseg.build_operands(sd_b, targets), jseg.build_operands(sd_b, jtargets)
    composed = tseg.compose_operands([ops_a, ops_b], [0.7, -0.4])
    jcomposed = jseg.compose_operands([jops_a, jops_b], [0.7, -0.4])
    # the port keeps the covered weights only; the JAX package's operands
    # of every other weight are zeros
    port_path = {jtargets[name][0]: targets[name][0] for name in jtargets}
    for ours, theirs, sd in ((ops_a, jops_a, (sd_a,)), (ops_b, jops_b, (sd_b,)),
                             (composed, jcomposed, (sd_a, sd_b))):
        assert (ours.rank_bucket, ours.scale) == (theirs.rank_bucket, theirs.scale)
        mine = {targets[n][0] for n in targets
                if any(k.startswith(n + ".") for part in sd for k in part)}
        assert 0 < len(mine) < len(targets) and ours.paths == tuple(sorted(mine))
        arrays = dict(zip(ours.paths, zip(ours.downs, ours.ups)))
        for path, jdown, jup in zip(theirs.paths, theirs.downs, theirs.ups):
            if port_path[path] in arrays:
                down, up = arrays[port_path[path]]
                np.testing.assert_array_equal(down, jdown)
                np.testing.assert_array_equal(up, jup)
            else:
                assert not jdown.any() and not jup.any()
        assert ours.nbytes == sum(a.nbytes for pair in arrays.values() for a in pair)
    assert (ops_a.rank_bucket, ops_b.rank_bucket, composed.rank_bucket) == (4, 8, 16)


@pytest.mark.parametrize("scale", [0.7, -1.3])
def test_patch_params_holds_against_the_jax_patch(tiny, scale):
    bundle, jbundle, targets, jtargets = tiny
    sd = _adapter(targets, 3)
    ops, jops = tseg.build_operands(sd, targets), jseg.build_operands(sd, jtargets)
    before = {n: (p, p.detach().clone()) for n, p in bundle.unet.named_parameters()}
    patched = tseg.patch_params(bundle, ops, scale=scale)
    jflat = flatten_params(jseg.patch_params(jbundle.params, jops, scale=scale)["unet"])
    ours = dict(patched.unet.named_parameters())
    for name, (path, _) in jtargets.items():
        got = ours[targets[name][0][len("unet/"):]].detach().numpy()
        np.testing.assert_allclose(got, np.asarray(jflat[path[len("unet/"):]]).T, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    # the bundle it came from is untouched, its other parameters shared
    assert patched is not bundle and patched.vae is bundle.vae
    # a weight the adapter leaves alone is shared, not copied
    targeted = {path[len("unet/"):] for path in ops.paths}
    assert 0 < len(targeted) < len(targets)
    for name, (param, value) in before.items():
        now = dict(bundle.unet.named_parameters())[name]
        assert now is param and torch.equal(now, value)
        if name not in targeted:
            assert ours[name] is param


def test_operands_for_plan_caches_per_content_and_rides_the_strength(tiny):
    bundle, _, targets, _ = tiny
    catalog = treg.AdapterCatalog()
    catalog.register_memory("a", _adapter(targets, 1))
    catalog.register_memory("b", _adapter(targets, 2))
    cache = tcache.AdapterOperandCache(budget_bytes=1 << 30)
    one = catalog.resolve([treg.AdapterSpec("a", 0.5)])
    first = tcache.operands_for_plan(one, targets, catalog=catalog, cache=cache)
    again = tcache.operands_for_plan(catalog.resolve([treg.AdapterSpec("a", 0.9)]), targets,
                                     catalog=catalog, cache=cache)
    assert (first.scale, again.scale) == (0.5, 0.9) and first.downs is again.downs
    assert cache.stats()["hits"] == 1 and cache.stats()["misses"] == 1
    stack = catalog.resolve([treg.AdapterSpec("a", 0.5), treg.AdapterSpec("b", 2.0)])
    both = tcache.operands_for_plan(stack, targets, catalog=catalog, cache=cache)
    assert both.scale == 1.0 and both.rank_bucket == 8
    small = tcache.AdapterOperandCache(budget_bytes=first.nbytes)
    for name in ("a", "b"):
        tcache.operands_for_plan(catalog.resolve([treg.AdapterSpec(name)]), targets,
                                 catalog=catalog, cache=small)
    assert small.stats()["entries"] == 1 and small.stats()["evictions"] == 1


@pytest.mark.parametrize("adapters, text", [
    ([{"name": "missing", "strength": 0.8}], "unknown adapter 'missing'"),
    ([{"name": f"a{i}"} for i in range(5)], "at most 4 entries"),
])
def test_both_queue_routes_refuse_a_bad_adapter_and_create_no_job(apps, adapters, text):
    """The repair: the same body queued on the port's and the JAX
    package's /distributed/queue gets 400 with the same error text, and
    neither store holds a job afterwards."""
    port_server, port_base, jax_server, jax_base, _ = apps
    body = {"prompt": _upscale_prompt(), "client_id": "t", "workers": [],
            "adapters": adapters}
    ours = request_json("POST", f"{port_base}/distributed/queue", body, 10)
    theirs = request_json("POST", f"{jax_base}/distributed/queue", body, 10)
    assert ours[0] == theirs[0] == 400
    assert text in ours[1]["error"] and ours[1] == theirs[1]
    for store in (port_server.job_store, jax_server.job_store):
        assert store.collectors == {} and store.tile_jobs == {}
    assert port_server.job_store._pending_adapters == {}


@pytest.mark.parametrize("name", ["<abs>", "../loras/style", "sub/style", "..", "sub\\style"])
def test_the_queue_route_refuses_a_path_as_an_adapter_name_unopened(apps, tmp_path, monkeypatch,
                                                                    name):
    """A request names registered adapters and CDT_LORA_DIR files only: a
    path, even to a LoRA file that exists, is answered 400 before any
    file is opened or hashed, and no job is created."""
    port_server, port_base, _, _, _ = apps
    lora_dir = tmp_path / "loras"
    (lora_dir / "sub").mkdir(parents=True)
    for path in (tmp_path / "style.safetensors", lora_dir / "sub" / "style.safetensors"):
        save_safetensors({k: torch.from_numpy(np.asarray(v)) for k, v in _lora_sd(1).items()},
                         str(path))
    monkeypatch.setenv("CDT_LORA_DIR", str(lora_dir))
    opened = []
    monkeypatch.setattr(treg, "_hash_file", lambda path: opened.append(path) or "0" * 32)
    monkeypatch.setattr(treg, "resolve_lora_path", lambda n: opened.append(n))
    if name == "<abs>":
        name = str(tmp_path / "style.safetensors")
    body = {"prompt": _upscale_prompt(), "client_id": "t", "workers": [],
            "adapters": [{"name": name, "strength": 0.8}]}
    status, answer = request_json("POST", f"{port_base}/distributed/queue", body, 10)
    assert status == 400 and "not a path" in answer["error"] and opened == []
    assert port_server.job_store.collectors == {} and port_server.job_store.tile_jobs == {}


def test_an_elastic_job_wearing_an_adapter_matches_the_local_lora_run(cluster, tmp_path,
                                                                       monkeypatch):
    """The unmodified tiny upscale workflow queued with adapters: the
    master resolves the name against its catalog (CDT_LORA_DIR), w1
    resolves and verifies it against its own, both patch; the output is
    within one 8-bit level of LoraLoaderModelOnly's bundle's tiles
    composited the elastic way, and apart from the base model's."""
    master, worker, root = cluster
    lora_dir = tmp_path / "loras"
    lora_dir.mkdir()
    monkeypatch.setenv("CDT_LORA_DIR", str(lora_dir))
    monkeypatch.setenv("CDT_DETERMINISTIC_BLEND", "1")
    bundle = master.execution_context.pipelines["tiny-unet"]
    with torch.no_grad():  # a non-zero out_conv, so the UNet's output counts
        weight = bundle.unet.out_conv.weight
        weight.copy_(torch.randn(weight.shape, generator=torch.Generator().manual_seed(0)) * 0.1)
    targets = lora_target_map(get_config("tiny-unet"))
    params = dict(bundle.unet.named_parameters())
    shapes = {n: tuple(params[p].shape) for n, (part, p) in targets.items() if part == "unet"}
    sd = seeded_lora(shapes, shapes, seed=9, rank=4, alpha=4.0)
    save_safetensors({k: torch.from_numpy(v) for k, v in sd.items()},
                     str(lora_dir / "style.safetensors"))
    prompt = _upscale_prompt()
    base = f"http://127.0.0.1:{master.port}"
    status, queued = request_json("POST", f"{base}/distributed/queue", {
        "prompt": prompt, "client_id": "t", "workers": ["w1"],
        "adapters": [{"name": "style", "strength": 0.8}]}, timeout=30)
    assert status == 200, queued
    history = _wait_done(f"{base}/history/{queued['prompt_id']}")
    worker_history = _wait_done(f"http://127.0.0.1:{worker.port}/history/{queued['trace_id']}_w0")
    assert history["error"] is None and worker_history["error"] is None
    record = master.job_store.finished[queued["job_ids"]["5"]]
    assert sorted(t for t, _ in record["completions"]) == [0, 1, 2, 3]
    assert [a["name"] for a in record["adapters"]] == ["style"]
    sampled = {who for _, who in record["completions"]}
    for server, who, role in ((master, "master", "master"), (worker, "w1", "worker")):
        if who in sampled:  # a participant patches once it samples a tile
            extras = server.execution_context.extras["adapters"][role]
            assert extras["plan"] == [("style", 0.8)] and extras["operand_bytes"] > 0
    out = master.get_job(queued["prompt_id"]).outputs["6"][0]["images"]
    (lora_bundle,) = LoraLoaderModelOnly().load_lora_model_only(bundle, "style", 0.8)
    image = torch.from_numpy(timg_load(root / "in" / "input.png"))
    reference, _ = chip_smoke._local_reference(torch, lora_bundle, prompt, image)
    plain, _ = chip_smoke._local_reference(torch, bundle, prompt, image)
    np.testing.assert_allclose(out.float().numpy(), reference.numpy(), atol=1.0 / 255 + 1e-5,
                               rtol=0)
    assert float((reference - plain).abs().max()) > 2.0 / 255


def timg_load(path):
    from comfyui_distributed_tpu_torch.utils import image as timg

    with open(path, "rb") as fh:
        return timg.u8_to_f32(timg.decode_png_u8(fh.read()))[None]


def test_a_request_no_worker_takes_wears_its_adapter_on_the_local_path(cluster, tmp_path,
                                                                      monkeypatch):
    """workers [] : the master's USDU node takes the local path, and wears
    the plan the queue route noted (the JAX package's local path drops
    it): the output is LoraLoaderModelOnly's local run's, within 1e-4
    (the adapter's delta is folded in another order), and no note is
    left behind."""
    master, _, _ = cluster
    lora_dir = tmp_path / "loras"
    lora_dir.mkdir()
    monkeypatch.setenv("CDT_LORA_DIR", str(lora_dir))
    bundle = master.execution_context.pipelines["tiny-unet"]
    with torch.no_grad():
        weight = bundle.unet.out_conv.weight
        weight.copy_(torch.randn(weight.shape, generator=torch.Generator().manual_seed(0)) * 0.1)
    params = dict(bundle.unet.named_parameters())
    shapes = {n: tuple(params[p].shape) for n, (part, p) in
              lora_target_map(get_config("tiny-unet")).items() if part == "unet"}
    save_safetensors({k: torch.from_numpy(v) for k, v in
                      seeded_lora(shapes, shapes, seed=9, rank=4, alpha=4.0).items()},
                     str(lora_dir / "style.safetensors"))
    base = f"http://127.0.0.1:{master.port}"
    outputs = []
    for adapters in ([{"name": "style", "strength": 0.8}], None):
        body = {"prompt": _upscale_prompt(), "client_id": "t", "workers": []}
        if adapters:
            body["adapters"] = adapters
        status, queued = request_json("POST", f"{base}/distributed/queue", body, timeout=30)
        assert status == 200 and queued["workers"] == [], queued
        history = _wait_done(f"{base}/history/{queued['prompt_id']}")
        assert history["error"] is None
        outputs.append(master.get_job(queued["prompt_id"]).outputs["6"][0]["images"])
    assert master.job_store._pending_adapters == {}
    from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor

    prompt = _upscale_prompt()
    del prompt["6"]
    prompt["lora"] = {"class_type": "LoraLoaderModelOnly", "inputs": {
        "model": ["1", 0], "lora_name": "style", "strength_model": 0.8}}
    prompt["5"]["inputs"]["model"] = ["lora", 0]
    context = ExecutionContext(device="cpu", config=master.config)
    context.pipelines["tiny-unet"] = bundle
    executor = GraphExecutor(context)
    executor.execute(prompt)
    local = executor.last_results["5"][0]
    np.testing.assert_allclose(outputs[0].numpy(), local.numpy(), atol=1e-4, rtol=0)
    assert float((outputs[0] - outputs[1]).abs().max()) > 2.0 / 255
