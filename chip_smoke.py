#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each printing lines tagged with its name:

1. device  - the card's name and power limit (nvidia-smi); TF32 is
             turned off for matmuls and convolutions, so f32 checks are
             f32.
2. build   - nvcc builds comfyui_distributed_tpu_torch/csrc/
             flash_attention.cu from this checkout.
3. kernel  - the kernel against its plain PyTorch version at every
             attention shape of the upscale and txt2img paths (bf16);
             at D=40, 80 and 160 also f32, an unaligned, a strided and a
             16-not-128-byte aligned view and the edges of the wgmma
             instance's 64-row blocks and key tiles (N in EDGE_ROWS_WG, M
             in EDGE_KEYS_WG, one head of one batch, fewer timing
             samples; at D=40 also those of the two-consumer blocks,
             EDGE_ROWS_PINGPONG and EDGE_KEYS_PINGPONG); for D=64 and
             512 also: in f32, on the fused strided qkv view, on small ragged inputs, at the edges of
             the wgmma instance's key tiles (one head of one batch), at
             the edges of the D=512 instance's row blocks and key tiles
             (B*H = 2*2), on D=512 strided and 16-byte (not 128-byte)
             aligned views, and at the VAE shape of a 1024-px tile
             (vae@18496, off the workflow's path); CUDA-event device times
             of the kernel, the plain version, one PyTorch SDPA call (a
             yardstick the port never calls) and the bound for the same
             work. Each line names the instance the router took, its key
             tile, query rows per block and key splits, the blocks
             launched, the blocks resident per SM and the waves.
   tiles   - every compiled plan of the wgmma instance (key tile and
             query rows a block) timed at each D=40/64/80/160 shape of
             both paths, and every key split of the D=512 instance at
             vae@5184, beside the router's choice.
   host    - the wrapper's host cost per call: 10 x 100 calls timed on the
             host clock while a spin kernel holds the stream.
4. main    - workflows/distributed-upscale.json through the port's
             GraphExecutor: SDXL at full width with seeded random weights
             (and a seeded non-zero out_conv, so the UNet's output counts),
             bf16, a seeded 512x512 image (8-bit levels, so it survives a
             PNG), 20 euler steps over four 576-px padded tiles →
             1024x1024. Run twice; each run must launch the attention
             kernel exactly as often as the path's shapes say, each
             instance as often as the router sends those shapes to it.
   elastic - the same, unmodified workflow over HTTP: a master and one
             worker (w1) DistributedServer in this process, on one loop
             and two localhost ports, sharing phase 4's model; the
             seeded image is LoadImage's input.png, SaveImage writes the
             output. POST /distributed/queue with workers ["w1"], twice.
             Each run must complete every tile exactly once between
             master and w1 (w1 at least once over the runs), launch the
             attention kernel as phase 4 does, and agree with phase 4's
             tiles composited the way the elastic master composites
             them (in sorted order, CDT_DETERMINISTIC_BLEND=1; phase 4
             itself takes a weighted average at the seams).
   txt2img - seed-parallel generation on SD1.5 at full width (seeded
             random weights, a seeded non-zero out_conv, bf16): phase 4's
             SDXL is freed; workflows/distributed-txt2img.json, unmodified,
             through a local GraphExecutor at seeds 42 and 43 (no workers,
             no SaveImage), then POSTed twice to /distributed/queue with
             workers ["w1"], a master and a w1 server in this process. The
             collector's batch must be [2, 512, 512, 3] in [0, 1], the
             master's image within RERUN_TOLERANCE of seed 42's local run,
             w1's (an 8-bit PNG envelope) of seed 43's plus half a level,
             the two images apart, and each run must launch the attention
             kernel 1282 times (640 wgmma and 1 wgmma512 per
             participant). The master's collector must leave no job
             behind; w1's envelope counts are read from its finished
             record.
   phases  - each phase's seconds.
5. kernels - one JSON line per the port's kernel contract: entry
             flash_attention over the upscale path (`launches`: the elastic
             run, both participants), entry flash_attention_txt2img over
             the txt2img path's D=40/80/160 shapes (`launches`: the last
             txt2img run's wgmma launches, both participants).

The card's nvidia-smi line and then {"ok": true, "device": ...} close
the output. Without a CUDA device, or without the port's package beside
this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import copy
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
IMAGE_PX = 512  # the workflow's LoadImage input, replaced by a seeded image

# H100 SXM published dense peaks at its 700 W limit (NVIDIA data sheet)
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # f32: outside the tensor cores
PEAK_BYTES = 3.35e12
# exp2 results per clock per SM on the special-function unit at compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput): every score of the softmax costs one
EXP2_PER_CLOCK_PER_SM = 16
SPIN_CYCLES = 20_000_000  # ~10 ms at the H100's 1.98 GHz boost clock
# key counts at the edges of the wgmma instance's key tiles (80, 112, 144)
EDGE_KEYS = (1, 77, 79, 80, 81, 143, 144, 145, 324, 1296)
# query and key counts at the edges of the wgmma512 instance's 64-row
# blocks and 32-key tiles
EDGE_ROWS_512 = (1, 63, 65, 200)
EDGE_KEYS_512 = (1, 31, 32, 33)
# key splits timed at vae@5184 on the `[tiles]` line
SPLITS_TIMED = tuple(range(1, 9))
# the VAE mid-block of SDXL's native 1024-px tile with 32-px padding:
# a 136 x 136 latent
VAE_1024_TOKENS = 136 * 136
# two runs of one seed may differ by this much (max |diff| on [0, 1]);
# two seeds' images must differ by more, in max and in mean |diff|
RERUN_TOLERANCE = 0.05
ELASTIC_RUNS = 2
ELASTIC_RUN_TIMEOUT_S = 300.0
USDU_NODE = "5"
# query and key counts at the edges of the wgmma instance's 64-row blocks
# and of its key tiles at D = 40, 80 and 160 (64, 80, 128; M = 77, the
# text tokens)
EDGE_ROWS_WG = (1, 63, 64, 65, 200)
EDGE_KEYS_WG = (1, 63, 64, 65, 77, 79, 80, 81, 127, 128, 129)
# and at D = 40, whose keys past 80 take two consumers a block: the edges
# of their 128-row blocks (consumer 1 on rows 64-127) and 128-key tiles
EDGE_ROWS_PINGPONG = (127, 128, 129)
EDGE_KEYS_PINGPONG = (257,)
# SD1.5's head dims (8 heads at every level of its UNet)
TXT2IMG_HEAD_DIMS = (40, 80, 160)
# workflows/distributed-txt2img.json's nodes
T2I_LATENT_NODE, T2I_SEED_NODE, T2I_SAMPLER_NODE = "4", "5", "6"
T2I_COLLECTOR_NODE, T2I_SAVE_NODE = "8", "9"
TXT2IMG_RUNS = 2
# a worker image travels as an 8-bit PNG: half a level of rounding
PNG_STEP = 0.5 / 255


def _require(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {message}")


def _nvidia_smi(query: str = "name,power.limit") -> str:
    proc = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def _max_sm_clock_mhz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm, "1980 MHz")."""
    return float(_nvidia_smi("clocks.max.sm").split()[0])


def _time_ms(torch, fn, reps: int = 15, inner: int = 10) -> float:
    """Median over `reps` of the device time per call, after warm-up.

    Each sample's `inner` calls queue behind a spin kernel of ~10 ms, so
    they are all on the stream before the first one starts: the CUDA
    events then time the device's work back to back, not the rate at
    which the host launches it (which bounds calls of a few µs)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def _heads(unet_cfg, width: int) -> tuple[int, int]:
    """(heads, head dim) of a transformer of `width` channels: a fixed
    head dim (SDXL's convention), else a fixed head count (SD1.5's)."""
    if unet_cfg.head_dim:
        return width // unet_cfg.head_dim, unet_cfg.head_dim
    return unet_cfg.num_heads, width // unet_cfg.num_heads


def _attention_shapes(unet_cfg, vae_cfg, te_len: int, latent_hw: int, evals: int,
                      vae_calls: int = 2):
    """(label, q shape [B, N, H, D], M, launches per run) of every
    attention call one tile (or image) makes: CFG doubles the UNet batch;
    each level with transformers runs depth x (res blocks down + res
    blocks + 1 up) blocks; the mid block, at the last level's width and
    side, max(depth, 1); each block one self- and one cross-attention;
    the VAE `vae_calls` mid-block attentions (2: encode and decode, as a
    tile; 1: decode only, as txt2img)."""
    shapes = []
    ch = unet_cfg.model_channels
    last = len(unet_cfg.channel_mult) - 1
    levels = {}
    for level, mult in enumerate(unet_cfg.channel_mult):
        depth = unet_cfg.transformer_depth[level]
        side = latent_hw // 2**level
        if depth:
            levels[(side, ch * mult)] = depth * (2 * unet_cfg.num_res_blocks + 1)
        if level == last:
            mid = (side, ch * mult)
            levels[mid] = levels.get(mid, 0) + max(depth, 1)
    for (side, width), blocks in levels.items():
        q = (2, side * side, *_heads(unet_cfg, width))
        shapes.append((f"self@{side * side}", q, side * side, blocks * evals))
        shapes.append((f"cross@{side * side}", q, te_len, blocks * evals))
    n = latent_hw * latent_hw
    width = vae_cfg.base_channels * vae_cfg.channel_mult[-1]
    shapes.append((f"vae@{n}", (1, n, 1, width), n, vae_calls))
    return shapes


def _expected_by_instance(attn, shapes, torch) -> dict:
    """Launches per tile of each kernel instance: every shape's count,
    under the instance the router picks for contiguous bf16 inputs of
    that shape (meta tensors: shapes and strides, no memory)."""
    counts = dict.fromkeys(attn.INSTANCES, 0)
    for _label, (b, n, h, d), m, per_tile in shapes:
        q = torch.empty((b, n, h, d), dtype=torch.bfloat16, device="meta")
        kv = torch.empty((b, m, h, d), dtype=torch.bfloat16, device="meta")
        counts[attn.plan(q, kv, kv).instance] += per_tile
    return counts


def _txt2img_shapes(workflow):
    """`_attention_shapes` of one image of the txt2img workflow: its
    checkpoint's UNet (SD1.5: the SD VAE, CLIP-L's 77 tokens), the
    EmptyLatentImage's size, the KSampler's evaluations, and one VAE
    decode."""
    from comfyui_distributed_tpu_torch.models.registry import get_config
    from comfyui_distributed_tpu_torch.ops.samplers import get_sigmas

    vae_cfg = get_config("vae-sd")
    sampler = workflow[T2I_SAMPLER_NODE]["inputs"]
    evals = get_sigmas(sampler["scheduler"], int(sampler["steps"]),
                       float(sampler["denoise"])).shape[0] - 1
    latent_hw = int(workflow[T2I_LATENT_NODE]["inputs"]["height"]) // vae_cfg.downscale
    return _attention_shapes(get_config(workflow["1"]["inputs"]["ckpt_name"]), vae_cfg,
                             get_config("clip-l").max_length, latent_hw, evals, vae_calls=1)


def _expected_instance(attn, head_dim: int, dtype: str, layout: str) -> str:
    """The instance a check's inputs must reach: the FMA kernel for f32 and
    unaligned views, else the tensor-core instance of the head dim."""
    if dtype == "float32" or layout == "unaligned":
        return "fma"
    return "wgmma512" if head_dim == 512 else "wgmma"


def _seed_out_conv(torch, bundle, gen) -> None:
    """A seeded non-zero out_conv (N(0, 1/fan_in)), so the UNet's output
    counts: random-init bundles start it at zero, as the JAX package
    does."""
    out_w = bundle.unet.out_conv.weight
    with torch.no_grad():
        out_w.copy_(torch.randn(out_w.shape, generator=gen, device=out_w.device)
                    / math.sqrt(out_w[0].numel()))


def _bounds(q_shape, m: int, dtype: str, sms: int, clock_mhz: float) -> dict:
    """The least time in ms the card could take for one call, by what
    bounds it: the tensor-core (or f32) operations 4 B H N M D at the
    published peak, the bytes of q, k, v and o moved once at the memory
    rate, and the B H N M exponentials of the softmax at 16 a clock on
    each of `sms` SMs at the maximum SM clock."""
    b, n, h, d = q_shape
    itemsize = 2 if dtype == "bfloat16" else 4
    ops = 4.0 * b * h * n * m * d
    nbytes = float(2 * b * n * h * d + 2 * b * m * h * d) * itemsize
    exps = float(b * h * n * m)
    return {"operations": ops / PEAK_OPS[dtype] * 1e3, "bytes": nbytes / PEAK_BYTES * 1e3,
            "exponentials": exps / (sms * EXP2_PER_CLOCK_PER_SM * clock_mhz * 1e6) * 1e3}


def _bound_by(terms: dict) -> str:
    return max(terms, key=terms.get)


def _time_plans(torch, attn, label, q, k, v, plans, chosen) -> str:
    """Device ms of each plan (a compiled key tile, query rows per block,
    key split) at one shape, with its masked share and blocks; '*' marks
    the router's."""
    m = k.shape[1]
    parts = []
    for plan in plans:
        ms = _time_ms(torch, lambda: attn.flash_attention(q, k, v, with_plan=plan))
        mark = "*" if plan == chosen else ""
        parts.append(f"{mark}k{plan.keys_per_tile} r{plan.rows_per_cta} s{plan.splits} {ms:.5f} ms "
                     f"{plan.masked_share(m):.3f} masked ctas={plan.ctas(*q.shape[:3])}")
    return f"[tiles] {label}: " + ", ".join(parts)


def _host_us_per_call(torch, attn, q, k, v, batches: int = 10, calls: int = 100) -> str:
    """The wrapper's host time per call: each batch of `calls` launches
    queues behind a spin kernel long enough to cover them, so the host
    never waits for the device and only its own work is timed."""
    samples, plan_samples = [], []
    for _ in range(batches):
        torch.cuda.synchronize()
        torch.cuda._sleep(5 * SPIN_CYCLES)
        started = time.perf_counter()
        for _ in range(calls):
            attn.flash_attention(q, k, v)
        samples.append((time.perf_counter() - started) / calls * 1e6)
        started = time.perf_counter()
        for _ in range(calls):
            attn.plan(q, k, v)
        plan_samples.append((time.perf_counter() - started) / calls * 1e6)
    torch.cuda.synchronize()
    return (f"[host] flash_attention q={tuple(q.shape)} M={k.shape[1]}: "
            f"{statistics.median(samples):.2f} us per call on the host (median of {batches} "
            f"x {calls}, min {min(samples):.2f}), of which plan() "
            f"{statistics.median(plan_samples):.2f} us")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _usdu_options(workflow) -> dict:
    """The USDU node's literal inputs, with its defaults for the rest."""
    from comfyui_distributed_tpu_torch.graph import NODE_REGISTRY
    from comfyui_distributed_tpu_torch.graph.prompt import is_link

    node = workflow[USDU_NODE]
    schema = NODE_REGISTRY[node["class_type"]].INPUT_TYPES()
    opts = {name: spec[1]["default"] for section in ("required", "optional")
            for name, spec in schema.get(section, {}).items()
            if len(spec) > 1 and isinstance(spec[1], dict) and "default" in spec[1]}
    opts.update({k: v for k, v in node["inputs"].items() if not is_link(v)})
    return opts


def _local_reference(torch, bundle, workflow, image):
    """The workflow's tiles processed here with the local path's tile
    processor and noise, composited two ways: (the elastic master's
    feathered lerp in sorted tile order, the local path's weighted
    average)."""
    from comfyui_distributed_tpu_torch.models import pipeline as pl
    from comfyui_distributed_tpu_torch.ops import tiles as tile_ops
    from comfyui_distributed_tpu_torch.ops import upscale as up

    o = _usdu_options(workflow)
    with torch.inference_mode():
        pos, neg = (up.prep_cond_for_tiles(
            pl.encode_text_pooled(bundle, [workflow[workflow[USDU_NODE]["inputs"][side][0]]
                                           ["inputs"]["text"]]), None)
            for side in ("positive", "negative"))
        upscaled, grid, extracted = up.prepare_upscaled_tiles(
            image, float(o["upscale_by"]), int(o["tile_width"]), int(o["tile_padding"]),
            o["upscale_method"], int(o["tile_height"]), mask_blur=int(o["mask_blur"]),
            uniform=bool(o["force_uniform_tiles"]),
        )
        process = up._process_tile_fn(bundle, grid, int(o["steps"]), o["sampler_name"],
                                      o["scheduler"], float(o["cfg"]), float(o["denoise"]))
        noise = up.default_noise(int(o["seed"]), bundle.device)
        tiles = torch.stack([process(t, g, noise, pos, neg, yx)
                             for g, (t, yx) in enumerate(zip(extracted, grid.positions))])
        lerp = tile_ops.DeterministicHostCanvas(upscaled, grid)
        for tile, (y, x) in zip(tiles, grid.positions):
            lerp.blend(tile, y, x)
        return lerp.result().float(), tile_ops.blend_tiles(tiles, grid).float()


def _wait_done(request_json, url: str, deadline: float) -> dict:
    """Poll GET /history/{prompt_id} until the prompt is done."""
    while True:
        status, history = request_json("GET", url, timeout=30)
        if status == 200 and history.get("done"):
            return history
        _require(time.monotonic() < deadline, f"{url} not done before the deadline")
        time.sleep(0.05)


def _elastic_phase(torch, bundle, ckpt: str, workflow, image, local_out, device: str,
                   expected_launches: int | None = None, expected_by_instance: dict | None = None,
                   local_tiles_per_s: float | None = None, runs: int = ELASTIC_RUNS) -> dict:
    """Run the workflow over HTTP on a master and a worker server in this
    process (see the module docstring) and check every run; prints the
    [elastic] lines and returns the last run's attention launches. With
    `expected_launches` None (no card) the launch counts go unchecked."""
    from comfyui_distributed_tpu_torch.api.server import DistributedServer
    from comfyui_distributed_tpu_torch.ops import attention as attn
    from comfyui_distributed_tpu_torch.utils import config as config_mod
    from comfyui_distributed_tpu_torch.utils import image as img_utils
    from comfyui_distributed_tpu_torch.utils.async_helpers import ServerLoopThread
    from comfyui_distributed_tpu_torch.utils.network import request_json

    cuda = device.startswith("cuda")
    reference, reference_avg = _local_reference(torch, bundle, workflow, image)
    avg_diff = float((reference_avg - local_out.float()).abs().max())
    print(f"[elastic] reference: the {ckpt} tiles processed locally, weighted average vs "
          f"phase 4's output max |diff| {avg_diff:.3g}")
    _require(avg_diff <= RERUN_TOLERANCE, "the local reference tiles are not phase 4's")
    tiles_by: dict[str, int] = {}
    result = {}
    with tempfile.TemporaryDirectory(prefix="cdt_elastic_") as tmp:
        in_dir, out_dir = os.path.join(tmp, "input"), os.path.join(tmp, "output")
        os.makedirs(in_dir)
        load_name = workflow["4"]["inputs"]["image"]
        with open(os.path.join(in_dir, load_name), "wb") as fh:
            fh.write(img_utils.encode_png(image[0]))
        master_port, worker_port = _free_port(), _free_port()
        config_path = os.path.join(tmp, "config.json")
        config_mod.save_config({
            "master": {"host": "127.0.0.1"},
            "workers": [{"id": "w1", "name": "w1", "type": "remote", "host": "127.0.0.1",
                         "port": worker_port, "enabled": True}],
            "settings": {"input_dir": in_dir, "output_dir": out_dir},
        }, config_path)
        loop = ServerLoopThread()
        loop.start()
        master = DistributedServer(port=master_port, is_worker=False, config_path=config_path,
                                   device=device)
        worker = DistributedServer(port=worker_port, is_worker=True, config_path=config_path,
                                   device=device)
        for server in (master, worker):
            server.execution_context.pipelines[ckpt] = bundle  # shared weights
        blend_env = os.environ.get("CDT_DETERMINISTIC_BLEND")
        os.environ["CDT_DETERMINISTIC_BLEND"] = "1"
        try:
            async def boot():
                await master.start()
                await worker.start()

            asyncio.run_coroutine_threadsafe(boot(), loop.loop).result(timeout=60)
            base = f"http://127.0.0.1:{master_port}"
            for run in range(1, runs + 1):
                if cuda:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                attn.reset_launch_counts()
                started = time.perf_counter()
                status, queued = request_json("POST", f"{base}/distributed/queue", {
                    "prompt": workflow, "client_id": "chip_smoke", "workers": ["w1"],
                }, timeout=120)
                _require(status == 200, f"/distributed/queue answered {status}: {queued}")
                _require(queued.get("workers") == ["w1"],
                         f"w1 was not dispatched (probe or dispatch failed): {queued}")
                deadline = time.monotonic() + ELASTIC_RUN_TIMEOUT_S
                history = _wait_done(request_json, f"{base}/history/{queued['prompt_id']}",
                                     deadline)
                worker_history = _wait_done(
                    request_json,
                    f"http://127.0.0.1:{worker_port}/history/{queued['trace_id']}_w0", deadline)
                if cuda:
                    torch.cuda.synchronize()
                seconds = time.perf_counter() - started
                _require(history.get("error") is None, f"master prompt failed: {history}")
                _require(worker_history.get("error") is None,
                         f"worker prompt failed: {worker_history}")
                launches = attn.flash_attention.launches
                by_instance = dict(attn.flash_attention.launches_by_instance)
                peak = torch.cuda.max_memory_allocated() if cuda else 0
                record = master.job_store.finished[queued["job_ids"][USDU_NODE]]
                n_tiles = record["total"]
                done = [t for t, _ in record["completions"]]
                by = {}
                for _, who in record["completions"]:
                    by[who] = by.get(who, 0) + 1
                    tiles_by[who] = tiles_by.get(who, 0) + 1
                stages = master.execution_context.extras.get("stage_seconds", {})
                worker_stages = worker.execution_context.extras.get("stage_seconds", {})
                rate = f"{n_tiles / seconds:.4f} tiles/s"
                if local_tiles_per_s is not None:
                    rate += f" (phase 4: {local_tiles_per_s:.4f})"
                print(f"[elastic] run {run}: {seconds:.2f} s, {rate}; tiles completed: master "
                      f"{by.get('master', 0)}, w1 {by.get('w1', 0)} (order {record['completions']},"
                      f" duplicates dropped {record['duplicates']}); flash_attention launches "
                      f"{launches}, by instance {by_instance}; peak {peak / 2**30:.2f} GiB; "
                      f"worker tile bytes received {record['received_bytes']}")
                print(f"[elastic] run {run} stage seconds: master "
                      f"{_rounded(stages.get('master', {}))}; w1 "
                      f"{_rounded(worker_stages.get('worker', {}))}")
                _require(sorted(done) == list(range(n_tiles)),
                         f"tiles completed {sorted(done)}, expected each of {n_tiles} once")
                _require(set(by) <= {"master", "w1"}, f"unexpected participants {sorted(by)}")
                _require("w1" in record["finished_workers"], "w1's final flush never arrived")
                if expected_launches is not None:
                    _require(launches == expected_launches,
                             f"{launches} attention launches, expected {expected_launches}")
                    _require(by_instance == expected_by_instance,
                             f"launches by instance {by_instance}, expected {expected_by_instance}")
                out = master.get_job(queued["prompt_id"]).outputs["6"][0]["images"]
                _require(out.device.type == torch.device(device).type,
                         f"the output was computed on {out.device}, not {device}")
                _require(tuple(out.shape) == tuple(reference.shape),
                         f"output shape {tuple(out.shape)}, expected {tuple(reference.shape)}")
                _require(bool(torch.isfinite(out).all()), "non-finite output")
                _require(float(out.min()) >= 0.0 and float(out.max()) <= 1.0,
                         "output outside [0, 1]")
                saved = os.path.join(out_dir, history["outputs"]["6"]["images"][0])
                with open(saved, "rb") as fh:
                    saved_shape = img_utils.decode_png_u8(fh.read()).shape
                _require(saved_shape == tuple(reference.shape[1:]),
                         f"saved {saved_shape}, expected {tuple(reference.shape[1:])}")
                diff = float((out.float() - reference.to(out.device)).abs().max())
                phase4 = float((out.float() - local_out.float().to(out.device)).abs().max())
                print(f"[elastic] run {run} output {tuple(out.shape)} in [{float(out.min()):.4f}, "
                      f"{float(out.max()):.4f}]; max |diff| vs phase 4's tiles composited alike "
                      f"{diff:.3g} (tolerance {RERUN_TOLERANCE}); vs phase 4's weighted-average "
                      f"output {phase4:.3g}")
                _require(diff <= RERUN_TOLERANCE,
                         "the elastic output disagrees with phase 4's tiles")
                result = {"launches": launches, "launches_by_instance": by_instance}
        finally:
            if blend_env is None:
                os.environ.pop("CDT_DETERMINISTIC_BLEND", None)
            else:
                os.environ["CDT_DETERMINISTIC_BLEND"] = blend_env

            async def teardown():
                await master.stop()
                await worker.stop()

            try:
                asyncio.run_coroutine_threadsafe(teardown(), loop.loop).result(timeout=60)
            finally:
                loop.stop()
    _require(tiles_by.get("w1", 0) >= 1, f"w1 completed no tile in {runs} runs: {tiles_by}")
    return result


def _txt2img_phase(torch, bundle, workflow, device: str, expected_launches: int | None = None,
                   expected_by_instance: dict | None = None, runs: int = TXT2IMG_RUNS) -> dict:
    """Seed-parallel txt2img over HTTP (see the module docstring): local
    references at the master's seed and w1's, then the unmodified
    workflow POSTed `runs` times to a master with worker w1, both servers
    in this process sharing `bundle`. Prints the [txt2img] lines and
    returns the last run's attention launches. With `expected_launches`
    None (no card) the launch counts go unchecked."""
    from comfyui_distributed_tpu_torch.api.server import DistributedServer
    from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
    from comfyui_distributed_tpu_torch.ops import attention as attn
    from comfyui_distributed_tpu_torch.utils import config as config_mod
    from comfyui_distributed_tpu_torch.utils import image as img_utils
    from comfyui_distributed_tpu_torch.utils.async_helpers import ServerLoopThread
    from comfyui_distributed_tpu_torch.utils.network import request_json

    cuda = device.startswith("cuda")
    ckpt = workflow["1"]["inputs"]["ckpt_name"]
    seed = int(workflow[T2I_SEED_NODE]["inputs"]["seed"])
    latent = workflow[T2I_LATENT_NODE]["inputs"]
    size = (int(latent["height"]), int(latent["width"]), 3)

    def counts():
        return attn.flash_attention.launches, dict(attn.flash_attention.launches_by_instance)

    def check_launches(launches, by_instance, participants):
        if expected_launches is None:
            return
        want = {name: n * participants // 2 for name, n in expected_by_instance.items()}
        _require(launches == expected_launches * participants // 2,
                 f"{launches} attention launches, expected {expected_launches * participants // 2}")
        _require(by_instance == want, f"launches by instance {by_instance}, expected {want}")

    # local references: the workflow without workers or SaveImage, at the
    # master's seed and at w1's (seed + worker index 0 + 1)
    context = ExecutionContext(device=device)
    context.pipelines[ckpt] = bundle
    executor = GraphExecutor(context)
    local = {}
    for s in (seed, seed + 1):
        prompt = copy.deepcopy(workflow)
        del prompt[T2I_SAVE_NODE]
        prompt[T2I_SEED_NODE]["inputs"]["seed"] = s
        if cuda:
            torch.cuda.synchronize()
        attn.reset_launch_counts()
        started = time.perf_counter()
        executor.execute(prompt)
        images = executor.last_results[T2I_COLLECTOR_NODE][0]
        if cuda:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - started
        launches, by_instance = counts()
        print(f"[txt2img] local run, seed {s}: {seconds:.2f} s, {images.shape[0] / seconds:.4f} "
              f"images/s; flash_attention launches {launches}, by instance {by_instance}; node "
              f"times {executor.last_timings}")
        _require(tuple(images.shape) == (1, *size), f"local output shape {tuple(images.shape)}")
        _require(bool(torch.isfinite(images).all()), "non-finite local output")
        check_launches(launches, by_instance, 1)
        local[s] = images[0].float()
    result = {}
    with tempfile.TemporaryDirectory(prefix="cdt_txt2img_") as tmp:
        out_dir = os.path.join(tmp, "output")
        master_port, worker_port = _free_port(), _free_port()
        config_path = os.path.join(tmp, "config.json")
        config_mod.save_config({
            "master": {"host": "127.0.0.1"},
            "workers": [{"id": "w1", "name": "w1", "type": "remote", "host": "127.0.0.1",
                         "port": worker_port, "enabled": True}],
            "settings": {"input_dir": tmp, "output_dir": out_dir},
        }, config_path)
        loop = ServerLoopThread()
        loop.start()
        master = DistributedServer(port=master_port, is_worker=False, config_path=config_path,
                                   device=device)
        worker = DistributedServer(port=worker_port, is_worker=True, config_path=config_path,
                                   device=device)
        for server in (master, worker):
            server.execution_context.pipelines[ckpt] = bundle  # shared weights
        try:
            async def boot():
                await master.start()
                await worker.start()

            asyncio.run_coroutine_threadsafe(boot(), loop.loop).result(timeout=60)
            base = f"http://127.0.0.1:{master_port}"
            for run in range(1, runs + 1):
                # every run samples: the servers' node caches would hand a
                # repeated prompt its last images
                for server in (master, worker):
                    server.execution_context.extras.pop("node_cache", None)
                if cuda:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                attn.reset_launch_counts()
                started = time.perf_counter()
                status, queued = request_json("POST", f"{base}/distributed/queue", {
                    "prompt": workflow, "client_id": "chip_smoke", "workers": ["w1"],
                }, timeout=120)
                _require(status == 200, f"/distributed/queue answered {status}: {queued}")
                _require(queued.get("workers") == ["w1"],
                         f"w1 was not dispatched (probe or dispatch failed): {queued}")
                deadline = time.monotonic() + ELASTIC_RUN_TIMEOUT_S
                history = _wait_done(request_json, f"{base}/history/{queued['prompt_id']}",
                                     deadline)
                worker_history = _wait_done(
                    request_json,
                    f"http://127.0.0.1:{worker_port}/history/{queued['trace_id']}_w0", deadline)
                if cuda:
                    torch.cuda.synchronize()
                seconds = time.perf_counter() - started
                _require(history.get("error") is None, f"master prompt failed: {history}")
                _require(worker_history.get("error") is None,
                         f"worker prompt failed: {worker_history}")
                _require(history["timings"].get(T2I_SAMPLER_NODE, 0.0) > 0.0
                         and worker_history["timings"].get(T2I_SAMPLER_NODE, 0.0) > 0.0,
                         "a participant's KSampler did not run")
                launches, by_instance = counts()
                peak = torch.cuda.max_memory_allocated() if cuda else 0
                # the master's collector cleans its job up once drained: its
                # counts are in the store's finished records
                record = master.job_store.finished[queued["job_ids"][T2I_COLLECTOR_NODE]]
                out = master.get_job(queued["prompt_id"]).outputs[T2I_SAVE_NODE][0]["images"]
                master_s = sum(history["timings"].values())
                worker_s = sum(worker_history["timings"].values())
                print(f"[txt2img] run {run}: {seconds:.2f} s, {out.shape[0] / seconds:.4f} "
                      f"images/s; node seconds summed: master {master_s:.2f} (collector "
                      f"{history['timings'].get(T2I_COLLECTOR_NODE, 0.0):.2f}), w1 "
                      f"{worker_s:.2f}; flash_attention launches {launches}, by instance "
                      f"{by_instance}; peak {peak / 2**30:.2f} GiB; w1 envelopes "
                      f"{record['received']}, bytes received {record['received_bytes']}; "
                      f"collector jobs left {len(master.job_store.collectors)}")
                _require(tuple(out.shape) == (2, *size), f"output shape {tuple(out.shape)}")
                _require(out.device.type == torch.device(device).type,
                         f"the output was computed on {out.device}, not {device}")
                _require(bool(torch.isfinite(out).all()), "non-finite output")
                _require(float(out.min()) >= 0.0 and float(out.max()) <= 1.0,
                         "output outside [0, 1]")
                _require(record["received"] == {"w1": 1} and record["finished_workers"] == ["w1"],
                         f"w1's envelopes: {record['received']}, finished "
                         f"{record['finished_workers']}")
                _require(not master.job_store.collectors,
                         f"collector jobs outlive their prompts: {sorted(master.job_store.collectors)}")
                saved = history["outputs"][T2I_SAVE_NODE]["images"]
                _require(len(saved) == 2, f"saved {saved}")
                for name in saved:
                    with open(os.path.join(out_dir, name), "rb") as fh:
                        _require(img_utils.decode_png_u8(fh.read()).shape == size,
                                 f"{name} is not {size}")
                d0 = float((out[0].float() - local[seed].to(out.device)).abs().max())
                d1 = float((out[1].float() - local[seed + 1].to(out.device)).abs().max())
                d01 = (out[0] - out[1]).float().abs()
                d01_max, d01_mean = float(d01.max()), float(d01.mean())
                print(f"[txt2img] run {run} output {tuple(out.shape)} in "
                      f"[{float(out.min()):.4f}, {float(out.max()):.4f}]; max |diff| image 0 vs "
                      f"the local seed {seed} {d0:.3g} (tolerance {RERUN_TOLERANCE}), image 1 vs "
                      f"the local seed {seed + 1} {d1:.3g} (tolerance "
                      f"{RERUN_TOLERANCE + PNG_STEP:.4f}), image 0 vs 1 max {d01_max:.3g} and "
                      f"mean {d01_mean:.3g} (each > {RERUN_TOLERANCE})")
                _require(d0 <= RERUN_TOLERANCE, "the master's image is not the local seed's")
                _require(d1 <= RERUN_TOLERANCE + PNG_STEP, "w1's image is not the local seed's")
                _require(d01_max > RERUN_TOLERANCE and d01_mean > RERUN_TOLERANCE,
                         "the master's and w1's images do not differ")
                check_launches(launches, by_instance, 2)
                result = {"launches": launches, "launches_by_instance": by_instance}
        finally:
            async def teardown():
                await master.stop()
                await worker.stop()

            try:
                asyncio.run_coroutine_threadsafe(teardown(), loop.loop).result(timeout=60)
            finally:
                loop.stop()
    return result


def _rounded(seconds: dict) -> dict:
    return {stage: round(value, 4) for stage, value in sorted(seconds.items())}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU", file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F

    from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
    from comfyui_distributed_tpu_torch.models import pipeline as pl
    from comfyui_distributed_tpu_torch.models.registry import get_config
    from comfyui_distributed_tpu_torch.ops import attention as attn
    from comfyui_distributed_tpu_torch.ops.samplers import get_sigmas
    from comfyui_distributed_tpu_torch.ops.upscale import plan_grid
    from comfyui_distributed_tpu_torch.utils import image as img_utils

    # --- 1. device ---------------------------------------------------------
    smi = _nvidia_smi()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi name, power.limit: {smi}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[device] torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    # --- 2. build ----------------------------------------------------------
    started = time.perf_counter()
    _, build = attn.load_library()
    print(f"[build] {os.path.relpath(build.path, REPO)}: nvcc {build.seconds:.2f} s, "
          f"load {time.perf_counter() - started:.2f} s")
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}")

    # --- 3. kernel vs plain --------------------------------------------------
    phase_started = time.perf_counter()
    workflow_path = os.path.join(REPO, "workflows", "distributed-upscale.json")
    with open(workflow_path, encoding="utf-8") as fh:
        workflow = json.load(fh)
    usdu = workflow["5"]["inputs"]
    sdxl, vae_cfg = get_config("sdxl"), get_config("vae-sd")
    te_len = get_config("clip-g").max_length
    tile_px = int(usdu["tile_width"]) + 2 * int(usdu["tile_padding"])
    evals = get_sigmas(usdu["scheduler"], int(usdu["steps"]), float(usdu["denoise"])).shape[0] - 1
    shapes = _attention_shapes(sdxl, vae_cfg, te_len, tile_px // vae_cfg.downscale, evals)
    per_tile = sum(count for *_, count in shapes)
    n_tiles = plan_grid(IMAGE_PX, IMAGE_PX, float(usdu["upscale_by"]), int(usdu["tile_width"]),
                        int(usdu["tile_padding"]), int(usdu["tile_height"]))[2].num_tiles
    with open(os.path.join(REPO, "workflows", "distributed-txt2img.json"), encoding="utf-8") as fh:
        t2i_workflow = json.load(fh)
    t2i_shapes = _txt2img_shapes(t2i_workflow)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def inputs(q_shape, m, dtype):
        b, n, h, d = q_shape
        return tuple(
            torch.randn(s, generator=gen, device="cuda").to(dtype)
            for s in ((b, n, h, d), (b, m, h, d), (b, m, h, d))
        )

    # tolerances: both sides accumulate in f32 from the same inputs and
    # differ in summation order (~1e-6 relative); in bf16 the final
    # rounding can then land one bf16 step (2^-8 relative) apart
    tolerance = {"bfloat16": (2.0**-7, 1e-3), "float32": (1e-5, 2e-5)}
    # per main-path unit: the SDXL upscale's tile, the txt2img image
    totals = {path: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                     "operations": 0.0, "bytes": 0.0, "exponentials": 0.0}
              for path in ("upscale", "txt2img")}
    # the largest error of the checks of each kernels entry: the txt2img
    # head dims on the tensor cores, and everything else
    max_err = {"upscale": 0.0, "txt2img": 0.0}
    # (label, q shape, M, dtype, (path, launches per unit) or None, layout)
    checks = [(label, q, m, "bfloat16", ("upscale", count), "contiguous")
              for label, q, m, count in shapes]
    self_lo = [s for s in shapes if s[0].startswith("self@")][-1]  # the deepest level
    checks += [
        (f"{self_lo[0]} f32", self_lo[1], self_lo[2], "float32", None, "contiguous"),
        (f"{self_lo[0]} strided", self_lo[1], self_lo[2], "bfloat16", None, "fused"),
        ("ragged 81x77", (1, 81, 2, 64), 77, "bfloat16", None, "contiguous"),
        ("ragged 200x190 D512 f32", (1, 200, 1, 512), 190, "float32", None, "contiguous"),
    ]
    checks += [(f"edge 200x{m} B*H=1", (1, 200, 1, 64), m, "bfloat16", None, "contiguous")
               for m in EDGE_KEYS]
    checks += [(f"edge D512 {n}x{m} B*H=2*2", (2, n, 2, 512), m, "bfloat16", None, "contiguous")
               for n in EDGE_ROWS_512 for m in EDGE_KEYS_512]
    checks += [
        ("D512 strided", (2, 150, 2, 512), 150, "bfloat16", None, "fused"),
        ("D512 rows 16 bytes off 128", (2, 100, 2, 512), 100, "bfloat16", None, "offset"),
        (f"vae@{VAE_1024_TOKENS} (1024-px tile)", (1, VAE_1024_TOKENS, 1, 512), VAE_1024_TOKENS,
         "bfloat16", None, "contiguous"),
    ]
    # txt2img on SD1.5: its shapes, then f32, an unaligned, a strided and
    # a 16-not-128-byte aligned view and the edges of the wgmma instance's
    # 64-row blocks and key tiles at each of its head dims
    checks += [(f"txt2img {label}", q, m, "bfloat16", ("txt2img", count), "contiguous")
               for label, q, m, count in t2i_shapes]
    for d in TXT2IMG_HEAD_DIMS:
        checks += [
            (f"D{d} ragged 1000x777 f32", (1, 1000, 2, d), 777, "float32", None, "contiguous"),
            (f"D{d} unaligned 300x300", (2, 300, 2, d), 300, "bfloat16", None, "unaligned"),
            (f"D{d} strided 150x150", (2, 150, 4, d), 150, "bfloat16", None, "fused"),
            (f"D{d} rows 16 bytes off 128", (2, 100, 2, d), 100, "bfloat16", None, "offset"),
        ]
        rows, keys = EDGE_ROWS_WG, EDGE_KEYS_WG
        if d in attn.WGMMA_PINGPONG_KEYS:
            rows, keys = rows + EDGE_ROWS_PINGPONG, keys + EDGE_KEYS_PINGPONG
        checks += [(f"edge D{d} {n}x{m} B*H=1", (1, n, 1, d), m, "bfloat16", None, "edge")
                   for n in rows for m in keys]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = _max_sm_clock_mhz()
    print(f"[device] {sms} SMs, maximum SM clock {clock_mhz:g} MHz (nvidia-smi clocks.max.sm): "
          f"exp2 bound {EXP2_PER_CLOCK_PER_SM} a clock an SM")
    tile_lines = []
    host_inputs = None
    for label, q_shape, m, dtype, unit, layout in checks:
        tdtype = getattr(torch, dtype)
        b, n, h, d = q_shape
        if layout == "offset":  # rows 16 bytes into a pitch of D + 8 elements
            wide = torch.randn((3, b, n, h, d + 8), generator=gen, device="cuda").to(tdtype)
            q, k, v = (t[..., 8:] for t in wide.unbind(0))
            _require(q.data_ptr() % 128 == 16, "the offset view starts 16 bytes off 128")
        elif layout == "unaligned":  # rows 2 bytes off 16, a pitch of D + 1 elements
            wide = torch.randn((3, b, n, h, d + 1), generator=gen, device="cuda").to(tdtype)
            q, k, v = (t[..., 1:] for t in wide.unbind(0))
            _require(q.data_ptr() % 16 != 0, "the unaligned view starts off 16 bytes")
        elif layout == "fused":  # q, k, v as views into one fused [B, N, 3, H, D] buffer
            fused = torch.randn((b, n, 3, h, d), generator=gen, device="cuda").to(tdtype)
            q, k, v = fused.unbind(2)
        else:
            q, k, v = inputs(q_shape, m, tdtype)
        plan = attn.plan(q, k, v, sms)
        expected = _expected_instance(attn, d, dtype, layout)
        _require(plan.instance == expected,
                 f"{label}: the router chose {plan.instance}, expected {expected}")
        out = attn.flash_attention(q, k, v)
        ref = attn.flash_attention_reference(q, k, v)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        rtol, atol = tolerance[dtype]
        ok = bool(torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol))
        entry = "txt2img" if d in TXT2IMG_HEAD_DIMS and plan.instance == "wgmma" else "upscale"
        max_err[entry] = max(max_err[entry], err)
        # the edges are many and small: fewer samples
        reps = (3, 3) if layout == "edge" else (15, 10)
        kernel_ms = _time_ms(torch, lambda: attn.flash_attention(q, k, v), *reps)
        plain_ms = _time_ms(torch, lambda: attn.flash_attention_reference(q, k, v), *reps)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), *reps)
        terms = _bounds(q.shape, k.shape[1], dtype, sms, clock_mhz)
        bound_ms = max(terms.values())
        per_sm = attn.blocks_per_sm(plan, q.dtype, d)
        ctas = plan.ctas(b, n, h)
        count = unit[1] if unit else 0
        print(f"[kernel] {label} {dtype} q={tuple(q.shape)} M={k.shape[1]} "
              f"launches/{'image' if unit and unit[0] == 'txt2img' else 'tile'}={count} "
              f"max_abs_err={err:.3g} tol=|d|<={atol:g}+{rtol:g}|ref| {'ok' if ok else 'FAIL'} "
              f"kernel_ms={kernel_ms:.5f} plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
              f"bound_ms={bound_ms:.5f} ({_bound_by(terms)}; operations "
              f"{terms['operations']:.5f}, bytes {terms['bytes']:.5f}, exponentials "
              f"{terms['exponentials']:.5f}) "
              f"instance={plan.instance} keys/tile={plan.keys_per_tile} "
              f"masked={plan.masked_share(m):.4f} rows/cta={plan.rows_per_cta} "
              f"splits={plan.splits} ctas={ctas} ctas/sm={per_sm} "
              f"waves={ctas / (per_sm * sms):.3f}")
        if unit and plan.instance == "wgmma":
            plans = attn.wgmma_plans(d)
            tile_lines.append(_time_plans(torch, attn, label, q, k, v, plans, plan))
            if host_inputs is None or q.numel() > host_inputs[0].numel():
                host_inputs = (q, k, v)
        if unit and unit[0] == "upscale" and plan.instance == "wgmma512":
            plans = [attn.Plan("wgmma512", attn.WGMMA512_KEYS, attn.WGMMA_ROWS, splits)
                     for splits in SPLITS_TIMED if splits <= plan.key_tiles(m)]
            tile_lines.append(_time_plans(torch, attn, label, q, k, v, plans, plan))
        _require(ok, f"kernel disagrees with its plain version at {label} ({err:.3g})")
        if unit and (unit[0] == "upscale" or plan.instance == "wgmma"):
            for key, val in (("ms", kernel_ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                             ("bound_ms", bound_ms), *terms.items()):
                totals[unit[0]][key] += count * val

    for line in tile_lines:
        print(line)
    print(_host_us_per_call(torch, attn, *host_inputs))
    phase_seconds = {"kernel": time.perf_counter() - phase_started}

    # --- 4. main path --------------------------------------------------------
    phase_started = time.perf_counter()
    prompt = copy.deepcopy(workflow)
    del prompt["4"], prompt["6"]  # LoadImage → a seeded image; no SaveImage
    rng = np.random.default_rng(SEED)
    # on 8-bit levels, so the elastic phase's input.png holds exactly this
    seeded = img_utils.u8_to_f32(img_utils.f32_to_u8(
        rng.random((1, IMAGE_PX, IMAGE_PX, 3), dtype=np.float32)))
    prompt["5"]["inputs"]["image"] = torch.from_numpy(seeded).to("cuda")
    ckpt = prompt["1"]["inputs"]["ckpt_name"]
    started = time.perf_counter()
    bundle = pl.load_pipeline(ckpt, seed=0, device="cuda")
    _seed_out_conv(torch, bundle, gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (bundle.unet, bundle.vae, bundle.text_encoder,
                                       bundle.text_encoder_2) for p in m.parameters())
    print(f"[main] {ckpt}: {n_params / 1e9:.3f}B parameters, seeded random init on the card "
          f"in {time.perf_counter() - started:.1f} s (compute dtype {sdxl.dtype})")
    context = ExecutionContext(device="cuda")
    context.pipelines[ckpt] = bundle  # CheckpointLoaderSimple resolves it here
    executor = GraphExecutor(context)
    outputs = []
    launches = 0
    expected_by_instance = {
        name: n_tiles * count
        for name, count in _expected_by_instance(attn, shapes, torch).items()
    }
    for run in (1, 2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        attn.reset_launch_counts()
        started = time.perf_counter()
        executor.execute(prompt)
        image = executor.last_results["5"][0]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - started
        launches = attn.flash_attention.launches
        by_instance = dict(attn.flash_attention.launches_by_instance)
        peak = torch.cuda.max_memory_allocated()
        print(f"[main] run {run}: {seconds:.2f} s, {n_tiles / seconds:.4f} tiles/s, "
              f"peak {peak / 2**30:.2f} GiB, flash_attention launches {launches} "
              f"(expected {n_tiles} x {per_tile}), by instance {by_instance} "
              f"(expected {expected_by_instance}), node times {executor.last_timings}")
        out_px = 2 * IMAGE_PX
        _require(tuple(image.shape) == (1, out_px, out_px, 3), f"output shape {tuple(image.shape)}")
        _require(bool(torch.isfinite(image).all()), "non-finite output")
        _require(float(image.min()) >= 0.0 and float(image.max()) <= 1.0, "output outside [0, 1]")
        _require(launches == n_tiles * per_tile,
                 f"{launches} attention launches, expected {n_tiles * per_tile}")
        _require(by_instance == expected_by_instance,
                 f"launches by instance {by_instance}, expected {expected_by_instance}")
        outputs.append(image)
    rerun_diff = float((outputs[0] - outputs[1]).abs().max())
    print(f"[main] output {tuple(outputs[1].shape)} in [{float(outputs[1].min()):.4f}, "
          f"{float(outputs[1].max()):.4f}], mean {float(outputs[1].mean()):.4f}; "
          f"run 1 vs run 2 max |diff| {rerun_diff:.3g}")
    _require(rerun_diff <= RERUN_TOLERANCE, "two runs of one seed disagree")
    phase_seconds["main"] = time.perf_counter() - phase_started

    # --- 4b. elastic -----------------------------------------------------------
    phase_started = time.perf_counter()
    elastic = _elastic_phase(
        torch, bundle, ckpt, workflow, prompt["5"]["inputs"]["image"], outputs[1], "cuda",
        expected_launches=n_tiles * per_tile, expected_by_instance=expected_by_instance,
        local_tiles_per_s=n_tiles / seconds,
    )
    phase_seconds["elastic"] = time.perf_counter() - phase_started

    # --- 4c. txt2img -------------------------------------------------------------
    phase_started = time.perf_counter()
    # SDXL's weights are not needed again
    del bundle, context, executor, outputs, image, prompt
    torch.cuda.empty_cache()
    t2i_ckpt = t2i_workflow["1"]["inputs"]["ckpt_name"]
    started = time.perf_counter()
    t2i_bundle = pl.load_pipeline(t2i_ckpt, seed=0, device="cuda")
    _seed_out_conv(torch, t2i_bundle, gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (t2i_bundle.unet, t2i_bundle.vae, t2i_bundle.text_encoder)
                   for p in m.parameters())
    print(f"[txt2img] {t2i_ckpt}: {n_params / 1e9:.3f}B parameters, seeded random init on the "
          f"card in {time.perf_counter() - started:.1f} s (compute dtype "
          f"{get_config(t2i_ckpt).dtype})")
    per_image = sum(count for *_, count in t2i_shapes)
    t2i_expected = {name: 2 * count for name, count in
                    _expected_by_instance(attn, t2i_shapes, torch).items()}
    txt2img = _txt2img_phase(torch, t2i_bundle, t2i_workflow, "cuda",
                             expected_launches=2 * per_image, expected_by_instance=t2i_expected)
    phase_seconds["txt2img"] = time.perf_counter() - phase_started
    print("[phases] seconds: " + ", ".join(f"{name} {sec:.1f}" for name, sec in
                                           phase_seconds.items()))

    # --- 5. kernels ----------------------------------------------------------
    print("[kernels] flash_attention: ms, plain_ms, library_ms and bound_ms are per SDXL tile "
          "(each upscale shape's time times its launches per tile, summed); launches: the last "
          "elastic run, master and w1 together (launches_main: phase 4's last run). "
          "flash_attention_txt2img: the same per 512-px SD1.5 image over the D=40/80/160 shapes "
          "the wgmma instance takes; launches: its launches in the last txt2img run, master "
          "and w1 together; bound_by: the largest of the summed operations, bytes and "
          "exponentials terms")
    source = "comfyui_distributed_tpu_torch/csrc/flash_attention.cu"
    replaces = "comfyui_distributed_tpu/ops/attention.py:80"

    def numbers(path):
        t = totals[path]
        return {"ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": _bound_by({key: t[key] for key in ("operations", "bytes",
                                                               "exponentials")}),
                "library_ms": t["library_ms"]}

    kernels = {"kernels": [
        {
            "name": "flash_attention",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": elastic["launches"],
            "launches_by_instance": elastic["launches_by_instance"],
            "launches_main": launches,
            "launches_by_instance_main": by_instance,
            "max_abs_err": max_err["upscale"],
            **numbers("upscale"),
            "check": f"ok: {len(checks)} shapes within tolerance of the plain version",
        },
        {
            "name": "flash_attention_txt2img",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": txt2img["launches_by_instance"]["wgmma"],
            "launches_by_instance": txt2img["launches_by_instance"],
            "max_abs_err": max_err["txt2img"],
            **numbers("txt2img"),
            "check": f"ok: {len(checks)} shapes within tolerance of the plain version",
        },
    ]}
    print(json.dumps(kernels))
    print(_nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
