"""Where one tile's time goes on the card: a torch.profiler trace of the
SDXL upscale path.

    python -m comfyui_distributed_tpu_torch.profile_upscale [--out DIR] [--repeat N]

Runs the port's run_upscale on SDXL at full width (seeded random
weights, a seeded non-zero out_conv, bf16) over a seeded 256x256 image,
which upscales to one 512-px tile with 32-px padding: the per-tile work
of workflows/distributed-upscale.json. One warm-up run, then one traced
run. Prints the card (name, power limit), the traced run's wall time,
the device time summed by kernel name and by kind (the flash-attention
kernel, convolutions, GEMMs, everything else), and the device's idle
share of the wall time. With --out, writes the Chrome trace there.
With --repeat N, then times N more warm runs without the profiler
(host clock around work ending in a synchronize) and prints each, the
median and the quartiles, the run-to-run spread a comparison needs.
Needs a CUDA device; it does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .models import pipeline as pl
from .ops import upscale

SEED = 20261016

# kernel-name fragments → the kind a line of the breakdown counts under
_KINDS = (
    ("flash_attention", ("flash_attention_fwd",)),
    ("convolution", ("conv", "implicit_gemm", "cudnn", "xmma_fprop", "fprop")),
    ("gemm", ("gemm", "cutlass", "sm90_xmma", "cublas", "nvjet")),
)


def _kind(name: str) -> str:
    low = name.lower()
    for kind, fragments in _KINDS:
        if any(f in low for f in fragments):
            return kind
    return "other"


def _self_device_us(row) -> float:
    value = getattr(row, "self_device_time_total", None)
    return float(row.self_cuda_time_total if value is None else value)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="directory for the Chrome trace")
    parser.add_argument("--repeat", type=int, default=0,
                        help="warm runs to time without the profiler afterwards")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_upscale: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {smi}")

    bundle = pl.load_pipeline("sdxl", seed=0, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    w = bundle.unet.out_conv.weight
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=gen, device="cuda") / math.sqrt(w[0].numel()))
    pos = pl.encode_text_pooled(bundle, ["masterpiece, highly detailed"])
    neg = pl.encode_text_pooled(bundle, ["blurry"])
    image = torch.from_numpy(
        np.random.default_rng(SEED).random((1, 256, 256, 3), dtype=np.float32)
    ).cuda()
    kwargs = dict(upscale_by=2.0, tile=512, padding=32, steps=20, cfg=7.0, denoise=0.35,
                  seed=7, mask_blur=8)

    upscale.run_upscale(bundle, image, pos, neg, **kwargs)  # warm-up
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        started = time.perf_counter()
        upscale.run_upscale(bundle, image, pos, neg, **kwargs)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - started

    # device-side rows (kernels, copies, memsets), as the profiler's own
    # table sums them (CPU-op rows repeat their kernels' time); the path
    # runs on one stream, so device rows never overlap and their sum is
    # the device's busy time
    rows = [
        r for r in prof.key_averages()
        if r.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(r, "is_user_annotation", False) and _self_device_us(r) > 0
    ]
    if not rows:
        print("profile_upscale: the profiler recorded no device time", file=sys.stderr)
        return 1
    by_kind: dict[str, float] = {}
    for row in rows:
        by_kind[_kind(row.key)] = by_kind.get(_kind(row.key), 0.0) + _self_device_us(row)
    device_us = sum(by_kind.values())
    print(f"[profile] one 576-px tile, 20 steps: wall {wall_s * 1e3:.1f} ms, "
          f"{sum(r.count for r in rows)} device operations, device busy {device_us / 1e3:.1f} ms, "
          f"idle share {1 - device_us / (wall_s * 1e6):.3f}")
    for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"[profile] kind {kind}: {us / 1e3:.1f} ms ({us / device_us:.3f} of device time)")
    for row in sorted(rows, key=lambda r: -_self_device_us(r))[:15]:
        print(f"[profile] {_self_device_us(row) / 1e3:9.2f} ms {row.count:6d} x  "
              f"{_kind(row.key):15s} {row.key[:110]}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, "profile_upscale_trace.json")
        prof.export_chrome_trace(path)
        print(f"[profile] trace: {path}")
    walls = []
    for _ in range(args.repeat):
        started = time.perf_counter()
        upscale.run_upscale(bundle, image, pos, neg, **kwargs)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - started) * 1e3)
    if walls:
        q1, med, q3 = statistics.quantiles(walls, n=4) if len(walls) > 1 else (walls[0],) * 3
        print(f"[repeat] {len(walls)} warm tiles without the profiler, wall ms: "
              f"{' '.join(f'{w:.1f}' for w in walls)}; median {statistics.median(walls):.1f}, "
              f"quartiles {q1:.1f} / {q3:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
