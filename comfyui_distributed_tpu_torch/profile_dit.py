"""Where a WAN DiT evaluation's time goes on the card: CUDA-event times
and a torch.profiler trace of the video DiT at its published width.

    python -m comfyui_distributed_tpu_torch.profile_dit [--model wan-14b] [--blocks 4]
        [--repeat 5] [--out DIR]

Builds the registry DiT with `--blocks` of its blocks at full width
(seeded random weights, bf16 linears and attention, f32 modulation and
norms) and evaluates it as the flow sampler does under CFG: batch 2 over
the latent of the bundled 14B workflows (81 frames of 720x480: a 21 x 60
x 90 latent, 28350 tokens), CLIP-L's 77 text tokens padded to the
context width, and for an i2v model CLIP vision's 257 tokens. TF32 stays
off, as the entry point sets it. One warm-up, then `--repeat` timed
evaluations (CUDA events around each; median and quartiles, and the
median per block), then one traced evaluation: the device time by kind
(the flash-attention kernel, GEMMs, everything else) and the kernels
that take most of it. With --out, writes the Chrome trace there.
Needs a CUDA device; it does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import subprocess
import sys

import torch

from .models.dit import VideoDiT
from .models.io import random_init_
from .models.registry import get_config
from .profile_upscale import _kind, _self_device_us

SEED = 20261016
LATENT = (21, 60, 90)  # 81 frames of 720x480 through the WAN VAE
TEXT_TOKENS = 77
IMAGE_TOKENS = 257


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", default="wan-14b")
    parser.add_argument("--blocks", type=int, default=4)
    parser.add_argument("--repeat", type=int, default=5)
    parser.add_argument("--out", help="directory for the Chrome trace")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_dit: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off")

    cfg = dataclasses.replace(get_config(args.model), depth=args.blocks)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    with torch.device("meta"):
        dit = VideoDiT(cfg)
    dit = random_init_(dit.to_empty(device="cuda"), gen).eval().requires_grad_(False)
    x = torch.randn((2, *LATENT, cfg.in_channels), generator=gen, device="cuda")
    t = torch.full((2,), 1000.0, device="cuda")
    context = torch.randn((2, TEXT_TOKENS, cfg.context_dim), generator=gen, device="cuda")
    image = (torch.randn((2, IMAGE_TOKENS, cfg.img_dim), generator=gen, device="cuda")
             if cfg.i2v else None)
    tokens = LATENT[0] * (LATENT[1] // cfg.patch_size[1]) * (LATENT[2] // cfg.patch_size[2])

    def evaluate():
        with torch.no_grad():
            return dit(x, t, context, image)

    evaluate()  # warm-up: the kernel's build and load, cuBLAS's heuristics
    torch.cuda.synchronize()
    times = []
    for _ in range(args.repeat):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        evaluate()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    med = statistics.median(times)
    q1, _, q3 = statistics.quantiles(times, n=4) if len(times) > 1 else (times[0],) * 3
    print(f"[time] {args.model} at {args.blocks} of {get_config(args.model).depth} blocks, "
          f"batch 2 x {tokens} tokens: {' '.join(f'{v:.2f}' for v in times)} ms an evaluation; "
          f"median {med:.2f}, quartiles {q1:.2f} / {q3:.2f}; {med / args.blocks:.2f} ms a "
          f"block (the ends included) [{smi}]")

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        evaluate()
        torch.cuda.synchronize()
    rows = [
        r for r in prof.key_averages()
        if r.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(r, "is_user_annotation", False) and _self_device_us(r) > 0
    ]
    if not rows:
        print("profile_dit: the profiler recorded no device time", file=sys.stderr)
        return 1
    by_kind: dict[str, float] = {}
    for row in rows:
        by_kind[_kind(row.key)] = by_kind.get(_kind(row.key), 0.0) + _self_device_us(row)
    device_us = sum(by_kind.values())
    print(f"[profile] one evaluation: {sum(r.count for r in rows)} device operations, device "
          f"busy {device_us / 1e3:.2f} ms, "
          + ", ".join(f"{kind} {us / 1e3:.2f} ms ({us / device_us:.3f})"
                      for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1])))
    for row in sorted(rows, key=lambda r: -_self_device_us(r))[:20]:
        print(f"[profile] {_self_device_us(row) / 1e3:9.2f} ms {row.count:5d} x  "
              f"{_kind(row.key):15s} {row.key[:110]}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, f"profile_dit_{args.model}_trace.json")
        prof.export_chrome_trace(path)
        print(f"[profile] trace: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
