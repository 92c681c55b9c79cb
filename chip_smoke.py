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
             attention shape of the main path (bf16), in f32, on the fused
             strided qkv view, on small ragged inputs, at the edges of
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
   tiles   - every compiled key tile of the wgmma instance timed at each
             D=64 shape of the path, and every key split of the D=512
             instance at vae@5184, beside the router's choice.
   host    - the wrapper's host cost per call: 10 x 100 calls timed on the
             host clock while a spin kernel holds the stream.
4. main    - workflows/distributed-upscale.json through the port's
             GraphExecutor: SDXL at full width with seeded random weights
             (and a seeded non-zero out_conv, so the UNet's output counts),
             bf16, a seeded 512x512 image, 20 euler steps over four
             576-px padded tiles → 1024x1024. Run twice; each run must
             launch the attention kernel exactly as often as the path's
             shapes say, each instance as often as the router sends
             those shapes to it.
5. kernels - one JSON line per the port's kernel contract.

The card's nvidia-smi line and then {"ok": true, "device": ...} close
the output. Without a CUDA device, or without the port's package beside
this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
IMAGE_PX = 512  # the workflow's LoadImage input, replaced by a seeded image

# H100 SXM published dense peaks at its 700 W limit (NVIDIA data sheet)
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # f32: outside the tensor cores
PEAK_BYTES = 3.35e12
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


def _require(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {message}")


def _nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


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


def _attention_shapes(unet_cfg, vae_cfg, te_len: int, latent_hw: int, evals: int):
    """(label, q shape [B, N, H, D], M, launches per tile) of every
    attention call one tile makes: CFG doubles the UNet batch; each
    level with transformers runs depth x (res blocks down + res blocks
    + 1 up) blocks, the mid block max(depth, 1); each block one self-
    and one cross-attention; the VAE one mid-block attention in encode
    and one in decode."""
    shapes = []
    ch = unet_cfg.model_channels
    last = len(unet_cfg.channel_mult) - 1
    for level, mult in enumerate(unet_cfg.channel_mult):
        depth = unet_cfg.transformer_depth[level]
        blocks = depth * (2 * unet_cfg.num_res_blocks + 1)
        if level == last:
            blocks += max(depth, 1)
        if not blocks:
            continue
        side = latent_hw // 2**level
        width = ch * mult
        q = (2, side * side, width // unet_cfg.head_dim, unet_cfg.head_dim)
        shapes.append((f"self@{side * side}", q, side * side, blocks * evals))
        shapes.append((f"cross@{side * side}", q, te_len, blocks * evals))
    n = latent_hw * latent_hw
    width = vae_cfg.base_channels * vae_cfg.channel_mult[-1]
    shapes.append((f"vae@{n}", (1, n, 1, width), n, 2))
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


def _bounds(q_shape, m: int, dtype: str):
    b, n, h, d = q_shape
    itemsize = 2 if dtype == "bfloat16" else 4
    ops = 4.0 * b * h * n * m * d
    nbytes = float(2 * b * n * h * d + 2 * b * m * h * d) * itemsize
    return ops / PEAK_OPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3


def _time_plans(torch, attn, label, q, k, v, plans, chosen) -> str:
    """Device ms of each plan (a compiled key tile and key split) at one
    shape, with its masked share and blocks; '*' marks the router's."""
    m = k.shape[1]
    parts = []
    for plan in plans:
        ms = _time_ms(torch, lambda: attn.flash_attention(q, k, v, with_plan=plan))
        mark = "*" if plan == chosen else ""
        parts.append(f"{mark}k{plan.keys_per_tile} s{plan.splits} {ms:.5f} ms "
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
    max_err = 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
              "ops_ms": 0.0, "bytes_ms": 0.0}
    checks = [(label, q, m, "bfloat16", count, "contiguous") for label, q, m, count in shapes]
    self_lo = [s for s in shapes if s[0].startswith("self@")][-1]  # the deepest level
    checks += [
        (f"{self_lo[0]} f32", self_lo[1], self_lo[2], "float32", 0, "contiguous"),
        (f"{self_lo[0]} strided", self_lo[1], self_lo[2], "bfloat16", 0, "fused"),
        ("ragged 81x77", (1, 81, 2, 64), 77, "bfloat16", 0, "contiguous"),
        ("ragged 200x190 D512 f32", (1, 200, 1, 512), 190, "float32", 0, "contiguous"),
    ]
    checks += [(f"edge 200x{m} B*H=1", (1, 200, 1, 64), m, "bfloat16", 0, "contiguous")
               for m in EDGE_KEYS]
    checks += [(f"edge D512 {n}x{m} B*H=2*2", (2, n, 2, 512), m, "bfloat16", 0, "contiguous")
               for n in EDGE_ROWS_512 for m in EDGE_KEYS_512]
    checks += [
        ("D512 strided", (2, 150, 2, 512), 150, "bfloat16", 0, "fused"),
        ("D512 rows 16 bytes off 128", (2, 100, 2, 512), 100, "bfloat16", 0, "offset"),
        (f"vae@{VAE_1024_TOKENS} (1024-px tile)", (1, VAE_1024_TOKENS, 1, 512), VAE_1024_TOKENS,
         "bfloat16", 0, "contiguous"),
    ]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tile_lines = []
    host_inputs = None
    for label, q_shape, m, dtype, count, layout in checks:
        tdtype = getattr(torch, dtype)
        if layout == "offset":  # rows 16 bytes into a pitch of D + 8 elements
            b, n, h, d = q_shape
            wide = torch.randn((3, b, n, h, d + 8), generator=gen, device="cuda").to(tdtype)
            q, k, v = (t[..., 8:] for t in wide.unbind(0))
            _require(q.data_ptr() % 128 == 16, "the offset view starts 16 bytes off 128")
        elif layout == "fused":  # q, k, v as views into one fused [B, N, 3, H, D] buffer
            b, n, h, d = q_shape
            fused = torch.randn((b, n, 3, h, d), generator=gen, device="cuda").to(tdtype)
            q, k, v = fused.unbind(2)
        else:
            q, k, v = inputs(q_shape, m, tdtype)
        out = attn.flash_attention(q, k, v)
        ref = attn.flash_attention_reference(q, k, v)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        rtol, atol = tolerance[dtype]
        ok = bool(torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol))
        max_err = max(max_err, err)
        kernel_ms = _time_ms(torch, lambda: attn.flash_attention(q, k, v))
        plain_ms = _time_ms(torch, lambda: attn.flash_attention_reference(q, k, v))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
        ops_ms, bytes_ms = _bounds(q.shape, k.shape[1], dtype)
        bound_ms = max(ops_ms, bytes_ms)
        b, n, h, d = q.shape
        plan = attn.plan(q, k, v, sms)
        per_sm = attn.blocks_per_sm(plan, q.dtype, d)
        ctas = plan.ctas(b, n, h)
        print(f"[kernel] {label} {dtype} q={tuple(q.shape)} M={k.shape[1]} launches/tile={count} "
              f"max_abs_err={err:.3g} tol=|d|<={atol:g}+{rtol:g}|ref| {'ok' if ok else 'FAIL'} "
              f"kernel_ms={kernel_ms:.5f} plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
              f"bound_ms={bound_ms:.5f} ({'operations' if ops_ms >= bytes_ms else 'bytes'}) "
              f"instance={plan.instance} keys/tile={plan.keys_per_tile} "
              f"masked={plan.masked_share(m):.4f} rows/cta={plan.rows_per_cta} "
              f"splits={plan.splits} ctas={ctas} ctas/sm={per_sm} "
              f"waves={ctas / (per_sm * sms):.3f}")
        if plan.instance == "wgmma" and count:
            plans = [attn.Plan("wgmma", keys, attn.WGMMA_ROWS) for keys in attn.WGMMA_KEY_TILES]
            tile_lines.append(_time_plans(torch, attn, label, q, k, v, plans, plan))
            if host_inputs is None or q.numel() > host_inputs[0].numel():
                host_inputs = (q, k, v)
        if plan.instance == "wgmma512" and count:
            plans = [attn.Plan("wgmma512", attn.WGMMA512_KEYS, attn.WGMMA_ROWS, splits)
                     for splits in SPLITS_TIMED if splits <= plan.key_tiles(m)]
            tile_lines.append(_time_plans(torch, attn, label, q, k, v, plans, plan))
        _require(ok, f"kernel disagrees with its plain version at {label} ({err:.3g})")
        for key, val in (("ms", kernel_ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                         ("bound_ms", bound_ms), ("ops_ms", ops_ms), ("bytes_ms", bytes_ms)):
            totals[key] += count * val

    for line in tile_lines:
        print(line)
    print(_host_us_per_call(torch, attn, *host_inputs))

    # --- 4. main path --------------------------------------------------------
    prompt = copy.deepcopy(workflow)
    del prompt["4"], prompt["6"]  # LoadImage → a seeded image; no SaveImage
    rng = np.random.default_rng(SEED)
    prompt["5"]["inputs"]["image"] = torch.from_numpy(
        rng.random((1, IMAGE_PX, IMAGE_PX, 3), dtype=np.float32)
    ).to("cuda")
    ckpt = prompt["1"]["inputs"]["ckpt_name"]
    started = time.perf_counter()
    bundle = pl.load_pipeline(ckpt, seed=0, device="cuda")
    out_w = bundle.unet.out_conv.weight
    with torch.no_grad():
        out_w.copy_(torch.randn(out_w.shape, generator=gen, device="cuda") / math.sqrt(out_w[0].numel()))
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
    _require(rerun_diff <= 0.05, "two runs of one seed disagree")

    # --- 5. kernels ----------------------------------------------------------
    print("[kernels] ms, plain_ms, library_ms and bound_ms are per tile: each main-path "
          "shape's time times its launches per tile, summed")
    kernels = {"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "comfyui_distributed_tpu_torch/csrc/flash_attention.cu",
        "replaces": "comfyui_distributed_tpu/ops/attention.py:80",
        "launches": launches,
        "launches_by_instance": by_instance,
        "max_abs_err": max_err,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "operations" if totals["ops_ms"] >= totals["bytes_ms"] else "bytes",
        "library_ms": totals["library_ms"],
        "check": f"ok: {len(checks)} shapes within tolerance of the plain version",
    }]}
    print(json.dumps(kernels))
    print(_nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
