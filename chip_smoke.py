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
             attention shape of the upscale path and of each seed-parallel
             workflow (bf16; each shape once, with its launches per tile or
             image on every path that runs it);
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
   2pass, pag, inpaint, sd21
           - the other bundled seed-parallel workflows (SD_WORKFLOWS), each
             as txt2img but POSTed once, its nodes found by class: two-pass
             (CLIPSetLastLayer, KSamplerAdvanced 0-14 with leftover noise,
             14-20 without), PAG and inpaint on the same SD1.5 weights, then
             SD2.1-768-v (sd21, OpenCLIP-H, v-prediction, 768 px) in its own
             seeded bundle, SD1.5 freed first. Inpaint's LoadImage reads a
             seeded 512x512 input.png with a transparent square in the
             middle. Per workflow, on the local run at seed 42: two-pass
             equals one KSampler over the whole schedule (RERUN_TOLERANCE);
             PAG differs from the workflow without it by at least one 8-bit
             level (PAG_MIN_DIFF); inpaint's
             sampled latent equals VAEEncodeForInpaint's exactly where its
             mask is 0, and its images-apart check reads the grown mask's
             pixels. Launches a run by instance from `_txt2img_shapes`: a
             PAG image adds 620 batch-1 calls (no mid-block self-attention),
             an inpaint image a VAE encode, an SD2.1 image runs D=64 on
             wgmma at 9216, 2304, 576 and 144 tokens.
   ckpt    - real single-file checkpoints: SD1.5 (txt2img's sd15) and
             SD2.1-768-v (sd21) bundles seeded at CKPT_SEED (not the
             registry's default 0) with a seeded out_conv, written by the
             port's synthesize_checkpoint and writer as
             <tmp>/<ckpt>.safetensors in f16 (bytes, seconds, GB/s); the
             unmodified txt2img and SD2.1 workflows POSTed once each to a
             fresh master and w1 with CDT_CHECKPOINT_DIR=<tmp>, each server
             loading the file (CheckpointLoaderSimple's seconds and GB/s).
             Every parameter of both loaded bundles must be torch.equal to
             the written weights rounded through f16 into the module's dtype;
             image 0 within RERUN_TOLERANCE of a local run on those rounded
             weights, and apart in max and mean from the same seed on the
             default random init (the file was read); launches as txt2img's
             and sd21's. The files are deleted.
   samplers- on SD1.5 (seeded, a seeded out_conv) the unmodified txt2img
             workflow locally at 20 steps with only sampler_name or
             scheduler changed: the 11 samplers other than euler on karras,
             the 7 schedulers other than karras on euler. Each image finite
             in [0, 1], launching the kernel model_evals_per_scan x its calls
             an evaluation (+ the decode); each stochastic sampler rerun at
             seed 42 within RERUN_TOLERANCE and seed 43 apart. Then
             HTTP_SAMPLER over HTTP: the txt2img workflow master + w1 (w1's
             image within RERUN_TOLERANCE + PNG_STEP of the local seed 43:
             step noise follows the participant's seed), and one elastic run
             of the upscale workflow on a fresh seeded SDXL bundle, within
             RERUN_TOLERANCE of the local tiles composited the elastic way
             (step noise follows the global tile index).
   usdu_full - on the samplers phase's SDXL, the upscale workflow with
             what users wire into it, added in memory (`_usdu_full_workflow`:
             UpscaleModelLoader 4x-generic into the USDU node,
             ControlNetLoader tile + ControlNetApplyAdvanced on both
             conditionings with LoadImage's image as the hint,
             CLIPTextEncodeSDXL at 2048 px with a 1024-px target, tiled
             decode); the upscaler's tail and the ControlNet's conv_out
             seeded non-zero. Once locally (tiles/s, peak memory, the
             upscale model's and the tiled decode's seconds; 5605 launches
             a tile: 5600 wgmma for the batch-1 positive and negative
             passes, 5 wgmma512 for the encode and four 80-latent decode
             pieces), once with the ControlNet's conv_out zeroed (the same
             launches, at least CONTROLNET_MIN_DIFF apart) and once at
             strength 0 (printed: the batched CFG pair's distance from the
             zero-residual run), and as master + w1 over HTTP: every
             tile once, the output within RERUN_TOLERANCE of the local tiles
             composited the elastic way, the two participants' pre-upscaled
             images equal, and tile 0's tiled decode within
             TILED_DECODE_TOLERANCE (mean |diff|) of its whole decode.
   guidance - on SD1.5, the txt2img workflow locally at seed 42 under
             FreeU_V2, FreeU, SelfAttentionGuidance and RescaleCFG (a patch
             node before KSampler) and with an area entry (a second prompt
             over the top half, progress [0, 0.5)), each finite in [0, 1],
             at least GUIDANCE_MIN_DIFF from the unpatched image, launching
             641 (FreeU, RescaleCFG), 1901 (SAG: a batch-1 capture pass with
             a plain middle self-attention and a batch-1 degraded pass an
             evaluation) or 1921 (area: three batch-1 passes) times; then
             SAG as master + w1 through the collector, as txt2img.
   custom  - on the guidance phase's SD1.5, workflows/distributed-flux-
             custom-sampling.json with its Flux-only nodes replaced
             (`_custom_workflow`: CheckpointLoaderSimple sd15, EmptyLatentImage
             512x512) and its BasicGuider made each of CUSTOM_GUIDERS:
             CFGGuider, PerpNegGuider, DualCFGGuider (regular); DistributedSeed
             → RandomNoise, BasicScheduler, KSamplerSelect euler,
             SamplerCustomAdvanced, VAEDecode and the collector stay. Each as
             txt2img over HTTP (one run: each image against a local run at its
             seed, launches from `_custom_shapes`: batch-3 UNet calls under
             PerpNeg and DualCFG); then locally the schedule split by
             SplitSigmas at CUSTOM_SPLIT with DisableNoise into the second
             stage, within RERUN_TOLERANCE of one stage.
   nodes   - one graph of every image, latent, mask and transform node
             (`_nodes_workflow`; a LoadImage/LoadImageMask PNG and literal
             seeded latents) on the card and on the CPU: every output of the
             same shape, dtype and device type, f32 within NODES_TOLERANCE.
   inpaint_model - sd15-inpaint (a 9-channel UNet, seeded) on an outpainting
             graph (`_inpaint_model_workflow`: LoadImage → ImagePadForOutpaint
             → InpaintModelConditioning → KSampler euler/karras 20 →
             VAEDecode → collector) as txt2img over HTTP: 5 concat channels
             on both conditionings, the original region changed less than
             the outpainted one, the images apart over the outpainted pixels.
   dynamic - SDXL again; workflows/distributed-upscale-video.json with its
             image source made 8 seeded 192x384 frames (8 LoadImage files, 7
             ImageBatch nodes): its own dynamic_threshold of 8 takes dynamic
             mode. Master + w1 over HTTP: every frame once, w1 at least one,
             each frame against `_process_whole_image` run here
             (RERUN_TOLERANCE, plus PNG_STEP for w1's), no collector or tile
             job left; the frames by participant printed.
   phases  - each phase's seconds and their total.
5. kernels - one JSON line per the port's kernel contract: entry
             flash_attention over the upscale path (`launches`: the elastic
             run, both participants), entry flash_attention_txt2img over
             the txt2img path's D=40/80/160 shapes (`launches`: the last
             txt2img run's wgmma launches, both participants), and an
             entry flash_attention_<workflow> for each of SD_WORKFLOWS over
             every attention shape of its image (`launches`: its run), one
             flash_attention_ckpt_<model> for each checkpoint file's workflow
             (`launches`: its run) and flash_attention_samplers over one
             SD1.5 image on SAMPLERS_ENTRY_SAMPLER (`launches`: that
             sampler's local run in the samplers phase; the phase's total
             stands on its [samplers] line), flash_attention_usdu_full per
             usdu_full tile (`launches`: its local run) and
             flash_attention_guidance per SAG image (`launches`: its local
             image), flash_attention_custom and _custom_dualcfg per PerpNeg
             and DualCFG image (`launches`: their HTTP runs),
             flash_attention_dynamic per frame (`launches`: the HTTP run of 8
             frames) and flash_attention_inpaint_model per image.

The card's nvidia-smi line and then {"ok": true, "device": ...} close
the output. Without a CUDA device, or without the port's package beside
this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import contextlib
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
TXT2IMG_RUNS = 2
# the seed-parallel workflows after txt2img, each run once over HTTP, by
# phase: two-pass (CLIPSetLastLayer, KSamplerAdvanced), PAG, inpaint
# (LoadImage's input.png with a transparent square) and SD2.1-768-v
SD_WORKFLOWS = {
    "2pass": "distributed-txt2img-2pass.json",
    "pag": "distributed-txt2img-pag.json",
    "inpaint": "distributed-inpaint.json",
    "sd21": "distributed-txt2img-sd21.json",
}
SD_WORKFLOW_RUNS = 1
# the side of the inpaint input's transparent square, as a share of the
# image's side (a quarter of the area)
INPAINT_HOLE = 0.5
# sampler nodes, whose evaluations call the UNet
SAMPLERS = ("KSampler", "KSamplerAdvanced", "SamplerCustomAdvanced")
# a worker image travels as an 8-bit PNG: half a level of rounding
PNG_STEP = 0.5 / 255
# PAG must change the image by at least one 8-bit level somewhere (a
# rerun of one seed on the card changes nothing)
PAG_MIN_DIFF = 1.0 / 255
# the checkpoint phase: SD1.5 and SD2.1-768-v files written in f16 from
# weights seeded at CKPT_SEED (the registry's default init is seed 0), by
# kernels-line path, each loaded by a fresh master and w1 over HTTP
CKPT_WORKFLOWS = {"ckpt_sd15": "distributed-txt2img.json",
                  "ckpt_sd21": "distributed-txt2img-sd21.json"}
CKPT_SEED = 7
# the samplers phase: the stochastic sampler its HTTP runs take (txt2img
# through the collector, the elastic upscale), and the sampler whose
# image its kernels-line entry sums (second order: 39 evaluations)
HTTP_SAMPLER = "euler_ancestral"
SAMPLERS_ENTRY_SAMPLER = "heun"
# the usdu_full phase: the upscale workflow with what users wire into it,
# added in memory (the file is not edited): an upscale model before the
# tiles, ControlNet tile (LoadImage's image as the hint) on both
# conditionings, the positive as CLIPTextEncodeSDXL (2048-px size
# conditioning, a 1024-px target) and tiled decode
USDU_FULL_UPSCALER = "4x-generic"
USDU_FULL_CONTROLNET = "tile"
USDU_FULL_SIZE_COND = (2048, 1024)  # CLIPTextEncodeSDXL's size and target
# the ControlNet must move the output by at least one 8-bit level
CONTROLNET_MIN_DIFF = 1.0 / 255
# mean |diff| of a tile's latents decoded in tiles (GroupNorm statistics
# per piece) against the whole decode, on [0, 1] pixels. Derived on the
# CPU before any chip run and never widened: tests/test_torch_tiled_
# decode_tolerance.py holds it above the right tiled decode (means
# 0.040-0.055 at 18 latents) and below one with its pieces misplaced
# (0.124-0.140); the max bounds nothing (0.70-0.98 for the right decode)
TILED_DECODE_TOLERANCE = 0.08
# the guidance phase: txt2img with one patch node between the checkpoint
# and KSampler, each at these inputs, and a positive combined with an
# area entry over the image's top half, gated to progress [0, 0.5)
GUIDANCE_PATCHES = {
    "FreeU_V2": {"b1": 1.3, "b2": 1.4, "s1": 0.9, "s2": 0.2},
    "FreeU": {"b1": 1.1, "b2": 1.2, "s1": 0.9, "s2": 0.2},
    "SelfAttentionGuidance": {"scale": 0.5, "blur_sigma": 2.0},
    "RescaleCFG": {"multiplier": 0.7},
}
AREA_PROMPT = "a red sailing boat"
AREA_WINDOW = (0.0, 0.5)
# each guidance image must move the unpatched one by an 8-bit level
GUIDANCE_MIN_DIFF = 1.0 / 255
# the custom phase: workflows/distributed-flux-custom-sampling.json on SD1.5
# (its Flux-only loaders, ModelSamplingFlux, FluxGuidance and the SD3 latent
# replaced), with each guider in place of its BasicGuider; the guiders'
# inputs and the extra prompts they take
CUSTOM_WORKFLOW = "distributed-flux-custom-sampling.json"
CUSTOM_GUIDERS = {
    "CFGGuider": {"cfg": 7.0},
    "PerpNegGuider": {"cfg": 7.0, "neg_scale": 1.0},
    "DualCFGGuider": {"cfg_conds": 5.0, "cfg_cond2_negative": 7.0, "style": "regular"},
}
CUSTOM_NEGATIVE = "blurry, low quality, watermark"
CUSTOM_COND2 = "an oil painting of a lighthouse in a storm"
# guider → the batch of its UNet evaluations (CFG's pair; PerpNeg's and
# DualCFG's three conditionings in one call)
GUIDER_BATCH = {"BasicGuider": 1, "CFGGuider": 2, "PerpNegGuider": 3, "DualCFGGuider": 3}
# the two-stage run: SplitSigmas at this step, DisableNoise into stage two
CUSTOM_SPLIT = 10
# the dynamic phase: workflows/distributed-upscale-video.json with its image
# source made DYNAMIC_FRAMES seeded frames of DYNAMIC_FRAME_HW (H, W), each a
# LoadImage file, joined by ImageBatch nodes: at the workflow's own
# dynamic_threshold of 8 it takes dynamic (whole-frame) mode
DYNAMIC_WORKFLOW = "distributed-upscale-video.json"
DYNAMIC_FRAMES = 8
DYNAMIC_FRAME_HW = (192, 384)
# the inpaint_model phase: an sd15-inpaint graph users build for outpainting
INPAINT_MODEL_CKPT = "sd15-inpaint"
INPAINT_MODEL_PAD = {"left": 0, "top": 0, "right": 64, "bottom": 64, "feathering": 24}
INPAINT_MODEL_PROMPTS = ("a castle on a hill, wide landscape", "blurry, low quality")
# the nodes phase: one graph of every image, latent, mask and transform
# node, on the card and on the CPU; f32 outputs within this of each other
NODES_TOLERANCE = 1e-4


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
                      vae_calls: int = 2, perturbed_evals: int = 0):
    """(label, q shape [B, N, H, D], M, launches per run) of every
    attention call one tile (or image) makes: `evals` CFG-batched UNet
    evaluations (see `_unet_shapes`); `perturbed_evals` PAG passes at
    batch 1; the VAE's `vae_calls` mid-block attentions (2: encode and
    decode, as a tile or an inpaint image; 1: decode only, as txt2img)."""
    hw = (latent_hw, latent_hw)
    shapes = _unet_shapes(unet_cfg, te_len, hw, 2, evals)
    if perturbed_evals:
        shapes += _unet_shapes(unet_cfg, te_len, hw, 1, perturbed_evals, pag=True,
                               tag="batch-1 ")
    shapes.append(_vae_shape(vae_cfg, latent_hw, vae_calls))
    return shapes


def _unet_shapes(unet_cfg, te_len: int, hw: tuple, batch: int, evals: int,
                 pag: bool = False, sag_capture: bool = False, tag: str = ""):
    """(label, q shape, M, calls) of `evals` UNet evaluations at `batch` on
    an h x w latent (each level halves it, rounding up): each level with
    transformers runs depth x (res blocks down + res blocks + 1 up)
    blocks, the middle block max(depth, 1) at the last level's width and
    side; every block one self- and one cross-attention. As the UNet's
    flags of the same names: under `pag` the middle block's
    self-attentions make no call (identity), under `sag_capture` its
    first one (taken plain)."""
    ch = unet_cfg.model_channels
    last = len(unet_cfg.channel_mult) - 1
    shapes = []
    h, w = hw
    for level, mult in enumerate(unet_cfg.channel_mult):
        depth = unet_cfg.transformer_depth[level]
        blocks = depth * (2 * unet_cfg.num_res_blocks + 1) if depth else 0
        self_blocks = blocks
        if level == last:
            mid = max(depth, 1)
            blocks += mid
            self_blocks = blocks - (mid if pag else 1 if sag_capture else 0)
        if blocks:
            q = (batch, h * w, *_heads(unet_cfg, ch * mult))
            if self_blocks:
                shapes.append((f"{tag}self@{h * w}", q, h * w, self_blocks * evals))
            shapes.append((f"{tag}cross@{h * w}", q, te_len, blocks * evals))
        h, w = -(-h // 2), -(-w // 2)
    return shapes


def _vae_shape(vae_cfg, latent_side: int, calls: int):
    """The VAE's mid-block attention at a square latent of `latent_side`."""
    n = latent_side * latent_side
    width = vae_cfg.base_channels * vae_cfg.channel_mult[-1]
    return (f"vae@{n}", (1, n, 1, width), n, calls)


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


def _node_ids(workflow, class_type: str) -> list[str]:
    """The ids of the workflow's nodes of one class, in id order."""
    return sorted((k for k, v in workflow.items() if v["class_type"] == class_type), key=int)


def _node_id(workflow, class_type: str) -> str:
    """The id of the workflow's one node of a class."""
    ids = _node_ids(workflow, class_type)
    _require(len(ids) == 1, f"the workflow has {len(ids)} {class_type} nodes, expected one")
    return ids[0]


def _image_px(workflow, image_px: int = IMAGE_PX) -> tuple[int, int]:
    """(height, width) of the workflow's image: its EmptyLatentImage's
    size, or the LoadImage input's (`image_px` square) where it has none,
    grown by an ImagePadForOutpaint's pads."""
    latent = _node_ids(workflow, "EmptyLatentImage")
    if latent:
        inputs = workflow[latent[0]]["inputs"]
        return int(inputs["height"]), int(inputs["width"])
    height = width = image_px
    for pad in _node_ids(workflow, "ImagePadForOutpaint"):
        inputs = workflow[pad]["inputs"]
        height += int(inputs["top"]) + int(inputs["bottom"])
        width += int(inputs["left"]) + int(inputs["right"])
    return height, width


def _sampler_evals(workflow) -> int:
    """UNet evaluations (CFG-batched) of one image: each KSampler's
    schedule, each KSamplerAdvanced's window, by its sampler's
    evaluations a sigma pair (a second-order sampler makes 2n - 1)."""
    from comfyui_distributed_tpu_torch.models.pipeline import advanced_window_sigmas
    from comfyui_distributed_tpu_torch.ops.samplers import get_sigmas, model_evals_per_scan

    evals = 0
    for node_id in _node_ids(workflow, "KSampler"):
        inputs = workflow[node_id]["inputs"]
        pairs = get_sigmas(inputs["scheduler"], int(inputs["steps"]),
                           float(inputs["denoise"])).shape[0] - 1
        evals += model_evals_per_scan(inputs["sampler_name"], pairs)
    for node_id in _node_ids(workflow, "KSamplerAdvanced"):
        inputs = workflow[node_id]["inputs"]
        pairs = advanced_window_sigmas(
            "eps", inputs["scheduler"], int(inputs["steps"]), int(inputs["start_at_step"]),
            int(inputs["end_at_step"]), inputs["return_with_leftover_noise"] == "disable",
        ).shape[0] - 1
        if pairs > 0:
            evals += model_evals_per_scan(inputs["sampler_name"], pairs)
    return evals


def _txt2img_shapes(workflow, image_px: int = IMAGE_PX):
    """`_attention_shapes` of one image of a seed-parallel SD workflow:
    its checkpoint's UNet and text encoder (SD1.5: CLIP-L's 77 tokens;
    SD2.1: OpenCLIP-H's 77), the SD VAE, the image's size, the samplers'
    evaluations (each with a batch-1 pass under PAG), and the VAE's calls
    (one decode, one encode per VAEEncodeForInpaint, two per
    InpaintModelConditioning)."""
    from comfyui_distributed_tpu_torch.models.registry import DEFAULT_TEXT_ENCODERS, get_config

    ckpt = workflow[_node_id(workflow, "CheckpointLoaderSimple")]["inputs"]["ckpt_name"]
    vae_cfg = get_config("vae-sd")
    height, width = _image_px(workflow, image_px)
    _require(height == width, f"a {height}x{width} image: the shapes assume a square")
    evals = _sampler_evals(workflow)
    perturbed = evals if _node_ids(workflow, "PerturbedAttentionGuidance") else 0
    te_len = get_config(DEFAULT_TEXT_ENCODERS.get(ckpt, "clip-l")).max_length
    encodes = (len(_node_ids(workflow, "VAEEncodeForInpaint"))
               + 2 * len(_node_ids(workflow, "InpaintModelConditioning")))
    return _attention_shapes(get_config(ckpt), vae_cfg, te_len, height // vae_cfg.downscale,
                             evals, vae_calls=1 + encodes, perturbed_evals=perturbed)


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
    _seed_weight(torch, bundle.unet.out_conv.weight, gen)


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


@contextlib.contextmanager
def _serving(tmp: str, settings: dict, device: str, pipelines: dict | None = None):
    """A master and a worker (w1) DistributedServer in this process, on one
    loop and two localhost ports, both reading `settings` (input and
    output directories) and sharing `pipelines` (none: each server loads
    its own checkpoint). Yields (master, w1, the master's URL, w1's
    port); both stop on the way out."""
    from comfyui_distributed_tpu_torch.api.server import DistributedServer
    from comfyui_distributed_tpu_torch.utils import config as config_mod
    from comfyui_distributed_tpu_torch.utils.async_helpers import ServerLoopThread

    master_port, worker_port = _free_port(), _free_port()
    config_path = os.path.join(tmp, "config.json")
    config_mod.save_config({
        "master": {"host": "127.0.0.1"},
        "workers": [{"id": "w1", "name": "w1", "type": "remote", "host": "127.0.0.1",
                     "port": worker_port, "enabled": True}],
        "settings": settings,
    }, config_path)
    loop = ServerLoopThread()
    loop.start()
    master = DistributedServer(port=master_port, is_worker=False, config_path=config_path,
                               device=device)
    worker = DistributedServer(port=worker_port, is_worker=True, config_path=config_path,
                               device=device)
    for server in (master, worker):
        server.execution_context.pipelines.update(pipelines or {})
    try:
        async def boot():
            await master.start()
            await worker.start()

        asyncio.run_coroutine_threadsafe(boot(), loop.loop).result(timeout=60)
        yield master, worker, f"http://127.0.0.1:{master_port}", worker_port
    finally:
        async def teardown():
            await master.stop()
            await worker.stop()

        try:
            asyncio.run_coroutine_threadsafe(teardown(), loop.loop).result(timeout=60)
        finally:
            loop.stop()


def _queue(base: str, worker_port: int, workflow) -> tuple[dict, dict, dict]:
    """POST the workflow to the master's /distributed/queue with workers
    ["w1"] and wait until the master's and w1's prompts are done: (the
    queue answer, the master's history, w1's history)."""
    from comfyui_distributed_tpu_torch.utils.network import request_json

    status, queued = request_json("POST", f"{base}/distributed/queue", {
        "prompt": workflow, "client_id": "chip_smoke", "workers": ["w1"],
    }, timeout=120)
    _require(status == 200, f"/distributed/queue answered {status}: {queued}")
    _require(queued.get("workers") == ["w1"],
             f"w1 was not dispatched (probe or dispatch failed): {queued}")
    deadline = time.monotonic() + ELASTIC_RUN_TIMEOUT_S
    history = _wait_done(request_json, f"{base}/history/{queued['prompt_id']}", deadline)
    worker_history = _wait_done(
        request_json, f"http://127.0.0.1:{worker_port}/history/{queued['trace_id']}_w0", deadline)
    _require(history.get("error") is None, f"master prompt failed: {history}")
    _require(worker_history.get("error") is None, f"worker prompt failed: {worker_history}")
    return queued, history, worker_history


def _launch_counts(attn) -> tuple[int, dict]:
    return attn.flash_attention.launches, dict(attn.flash_attention.launches_by_instance)


def _local_run(torch, attn, executor, workflow, label: str, what: str, device: str,
               size: tuple):
    """One local run of a seed-parallel workflow through `executor`,
    SaveImage removed and every node run (a cached node would launch no
    attention), its image of `size` (H, W, 3): (image 0 as f32,
    launches, launches by instance, seconds). Prints the run's line."""
    cuda = device.startswith("cuda")
    prompt = copy.deepcopy(workflow)
    del prompt[_node_id(prompt, "SaveImage")]
    executor.context.extras.pop("node_cache", None)
    if cuda:
        torch.cuda.synchronize()
    attn.reset_launch_counts()
    started = time.perf_counter()
    executor.execute(prompt)
    images = executor.last_results[_node_id(prompt, "DistributedCollector")][0]
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - started
    launches, by_instance = _launch_counts(attn)
    print(f"{label} local run, {what}: {seconds:.2f} s, {images.shape[0] / seconds:.4f} "
          f"images/s; flash_attention launches {launches}, by instance {by_instance}; "
          f"node times {executor.last_timings}")
    _require(tuple(images.shape) == (1, *size), f"local output shape {tuple(images.shape)}")
    _require(bool(torch.isfinite(images).all()), "non-finite local output")
    return images[0].float(), launches, by_instance, seconds


def _elastic_phase(torch, bundle, ckpt: str, workflow, image, local_out, device: str,
                   expected_launches: int | None = None, expected_by_instance: dict | None = None,
                   local_tiles_per_s: float | None = None, runs: int = ELASTIC_RUNS,
                   tag: str = "elastic") -> dict:
    """Run the workflow over HTTP on a master and a worker server in this
    process (see the module docstring) and check every run; prints the
    [tag] lines and returns the last run's attention launches. With
    `expected_launches` None (no card) the launch counts go unchecked;
    with `local_out` None the reference is not held against a local run
    of the workflow (an earlier phase did that)."""
    from comfyui_distributed_tpu_torch.ops import attention as attn
    from comfyui_distributed_tpu_torch.utils import image as img_utils

    cuda = device.startswith("cuda")
    label = f"[{tag}]"
    reference, reference_avg = _local_reference(torch, bundle, workflow, image)
    if local_out is not None:
        avg_diff = float((reference_avg - local_out.float()).abs().max())
        print(f"{label} reference: the {ckpt} tiles processed locally, weighted average vs "
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
        blend_env = os.environ.get("CDT_DETERMINISTIC_BLEND")
        os.environ["CDT_DETERMINISTIC_BLEND"] = "1"
        try:
            with _serving(tmp, {"input_dir": in_dir, "output_dir": out_dir}, device,
                          {ckpt: bundle}) as (master, worker, base, worker_port):
                for run in range(1, runs + 1):
                    if cuda:
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats()
                    attn.reset_launch_counts()
                    started = time.perf_counter()
                    queued, history, _ = _queue(base, worker_port, workflow)
                    if cuda:
                        torch.cuda.synchronize()
                    seconds = time.perf_counter() - started
                    launches, by_instance = _launch_counts(attn)
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
                    print(f"{label} run {run}: {seconds:.2f} s, {rate}; tiles completed: master "
                          f"{by.get('master', 0)}, w1 {by.get('w1', 0)} (order "
                          f"{record['completions']}, duplicates dropped {record['duplicates']});"
                          f" flash_attention launches {launches}, by instance {by_instance}; "
                          f"peak {peak / 2**30:.2f} GiB; worker tile bytes received "
                          f"{record['received_bytes']}")
                    print(f"{label} run {run} stage seconds: master "
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
                                 f"launches by instance {by_instance}, expected "
                                 f"{expected_by_instance}")
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
                    versus = ""
                    if local_out is not None:
                        phase4 = float((out.float() - local_out.float().to(out.device)).abs().max())
                        versus = f"; vs phase 4's weighted-average output {phase4:.3g}"
                    print(f"{label} run {run} output {tuple(out.shape)} in "
                          f"[{float(out.min()):.4f}, {float(out.max()):.4f}]; max |diff| vs the "
                          f"local tiles composited alike {diff:.3g} (tolerance "
                          f"{RERUN_TOLERANCE}){versus}")
                    _require(diff <= RERUN_TOLERANCE,
                             "the elastic output disagrees with the local tiles")
                    result = {"launches": launches, "launches_by_instance": by_instance}
        finally:
            if blend_env is None:
                os.environ.pop("CDT_DETERMINISTIC_BLEND", None)
            else:
                os.environ["CDT_DETERMINISTIC_BLEND"] = blend_env
    _require(tiles_by.get("w1", 0) >= 1, f"w1 completed no tile in {runs} runs: {tiles_by}")
    return result


def _inpaint_input(px: int, seed: int):
    """A seeded px x px RGBA image on 8-bit levels (so a PNG holds it
    exactly), opaque but for a transparent square in the middle,
    INPAINT_HOLE of the side: LoadImage's mask (1 - alpha) is 1 there."""
    import numpy as np

    from comfyui_distributed_tpu_torch.utils import image as img_utils

    rng = np.random.default_rng(seed)
    rgba = img_utils.u8_to_f32(img_utils.f32_to_u8(rng.random((px, px, 4), dtype=np.float32)))
    rgba[..., 3] = 1.0
    lo = round(px * (1.0 - INPAINT_HOLE) / 2)
    rgba[lo:px - lo, lo:px - lo, 3] = 0.0
    return rgba


def _without_pag(workflow):
    """The workflow with its PerturbedAttentionGuidance node taken out:
    its consumers take the node's own model input."""
    prompt = copy.deepcopy(workflow)
    pag = _node_id(prompt, "PerturbedAttentionGuidance")
    source = prompt.pop(pag)["inputs"]["model"]
    for node in prompt.values():
        for name, value in node["inputs"].items():
            if isinstance(value, list) and value[:1] == [pag]:
                node["inputs"][name] = source
    return prompt


def _one_ksampler(workflow):
    """The two-pass workflow with its KSamplerAdvanced chain replaced by
    one KSampler over the whole schedule from the first pass's inputs,
    under the same id as the last pass (its consumers keep their link)."""
    prompt = copy.deepcopy(workflow)
    passes = _node_ids(prompt, "KSamplerAdvanced")
    first = prompt[passes[0]]["inputs"]
    for node_id in passes:
        del prompt[node_id]
    prompt[passes[-1]] = {"class_type": "KSampler", "inputs": {
        "model": first["model"], "seed": first["noise_seed"], "steps": first["steps"],
        "cfg": first["cfg"], "sampler_name": first["sampler_name"],
        "scheduler": first["scheduler"], "positive": first["positive"],
        "negative": first["negative"], "latent_image": first["latent_image"], "denoise": 1.0,
    }}
    return prompt


def _txt2img_phase(torch, bundle, workflow, device: str, expected_launches: int | None = None,
                   expected_by_instance: dict | None = None, runs: int = TXT2IMG_RUNS,
                   tag: str = "txt2img", image_px: int = IMAGE_PX) -> dict:
    """Seed-parallel generation over HTTP (see the module docstring):
    local references at the master's seed and w1's, then the unmodified
    workflow POSTed `runs` times to a master with worker w1, both servers
    in this process sharing `bundle`. Its nodes are found by class. A
    LoadImage reads a seeded `_inpaint_input` of `image_px`, written to
    the input directory both servers share. Per workflow, on the local
    run at the master's seed: two-pass equals one KSampler over the whole
    schedule; PAG differs from the workflow without it; inpaint keeps
    the encoded latent exactly where its mask is 0, and the images-apart
    check reads the grown mask's pixels only; an InpaintModelConditioning
    graph carries 5 concat channels on both sides, changes the outpainted
    region more than the original one, and its images-apart check reads
    the outpainted pixels. Prints the [tag] lines and
    returns the last run's attention launches. With `expected_launches`
    None (no card) the launch counts go unchecked."""
    import numpy as np

    from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
    from comfyui_distributed_tpu_torch.graph.nodes_core import grow_mask
    from comfyui_distributed_tpu_torch.ops import attention as attn
    from comfyui_distributed_tpu_torch.utils import image as img_utils

    cuda = device.startswith("cuda")
    label = f"[{tag}]"
    ckpt = workflow[_node_id(workflow, "CheckpointLoaderSimple")]["inputs"]["ckpt_name"]
    seed_node = _node_id(workflow, "DistributedSeed")
    collector = _node_id(workflow, "DistributedCollector")
    save = _node_id(workflow, "SaveImage")
    samplers = [n for cls in SAMPLERS for n in _node_ids(workflow, cls)]
    seed = int(workflow[seed_node]["inputs"]["seed"])
    size = (*_image_px(workflow, image_px), 3)

    def check_launches(launches, by_instance, participants):
        if expected_launches is None:
            return
        want = {name: n * participants // 2 for name, n in expected_by_instance.items()}
        _require(launches == expected_launches * participants // 2,
                 f"{launches} attention launches, expected {expected_launches * participants // 2}")
        _require(by_instance == want, f"launches by instance {by_instance}, expected {want}")

    result = {}
    with tempfile.TemporaryDirectory(prefix=f"cdt_{tag}_") as tmp:
        in_dir, out_dir = os.path.join(tmp, "input"), os.path.join(tmp, "output")
        os.makedirs(in_dir)
        settings = {"input_dir": in_dir, "output_dir": out_dir}
        # the pixels the images-apart check reads: all, or an inpaint's
        # grown mask (both images keep the rest)
        region, region_name = None, "the grown mask's"
        for load in _node_ids(workflow, "LoadImage"):
            rgba = _inpaint_input(image_px, SEED)
            with open(os.path.join(in_dir, workflow[load]["inputs"]["image"]), "wb") as fh:
                fh.write(img_utils.encode_png(rgba))
            hard = torch.from_numpy((1.0 - rgba[..., 3] > 0.5).astype(np.float32))[None]
            for enc in _node_ids(workflow, "VAEEncodeForInpaint"):
                grow = int(workflow[enc]["inputs"]["grow_mask_by"])
                region = grow_mask(hard, grow)[0].to(device) > 0

        # local references: the workflow without workers or SaveImage
        context = ExecutionContext(device=device, config={"settings": settings})
        context.pipelines[ckpt] = bundle
        executor = GraphExecutor(context)

        def local_run(prompt, what: str):
            return _local_run(torch, attn, executor, prompt, label, what, device, size)[:3]

        local = {}
        for s in (seed, seed + 1):
            prompt = copy.deepcopy(workflow)
            prompt[seed_node]["inputs"]["seed"] = s
            local[s], launches, by_instance = local_run(prompt, f"seed {s}")
            check_launches(launches, by_instance, 1)
            if s != seed:
                continue
            for enc in _node_ids(workflow, "VAEEncodeForInpaint"):
                encoded = executor.last_results[enc][0]
                sampled = executor.last_results[samplers[-1]][0]["samples"]
                keep = encoded["noise_mask"][..., 0] == 0.0
                exact = bool(torch.equal(sampled[keep], encoded["samples"][keep]))
                print(f"{label} seed {s}: the sampled latent equals VAEEncodeForInpaint's at "
                      f"the {int(keep.sum())} of {keep.numel()} latent pixels outside the mask: "
                      f"{exact}; inside, max |diff| "
                      f"{float((sampled[~keep] - encoded['samples'][~keep]).abs().max()):.3g}")
                _require(bool(keep.any()) and bool((~keep).any()),
                         "the latent mask is all one value")
                _require(exact, "sampling changed the latent outside the inpaint mask")
            for imc in _node_ids(workflow, "InpaintModelConditioning"):
                region = _inpaint_model_checks(torch, executor, workflow, imc, local[s], label)
                region_name = "the outpainted"
        if _node_ids(workflow, "KSamplerAdvanced"):
            single, _, _ = local_run(_one_ksampler(workflow), f"seed {seed}, one KSampler")
            diff = float((single - local[seed]).abs().max())
            print(f"{label} seed {seed}: the two passes vs one KSampler over the whole schedule "
                  f"max |diff| {diff:.3g} (tolerance {RERUN_TOLERANCE})")
            _require(diff <= RERUN_TOLERANCE, "the two passes are not one KSampler's trajectory")
        if _node_ids(workflow, "PerturbedAttentionGuidance"):
            plain, _, _ = local_run(_without_pag(workflow), f"seed {seed}, without PAG")
            diff = float((plain - local[seed]).abs().max())
            print(f"{label} seed {seed}: PAG vs without max |diff| {diff:.3g} (at least "
                  f"{PAG_MIN_DIFF:.4f}, one 8-bit level)")
            _require(diff >= PAG_MIN_DIFF, "PAG does not change the image")

        with _serving(tmp, settings, device, {ckpt: bundle}) as (master, worker, base,
                                                                 worker_port):
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
                queued, history, worker_history = _queue(base, worker_port, workflow)
                if cuda:
                    torch.cuda.synchronize()
                seconds = time.perf_counter() - started
                _require(all(history["timings"].get(n, 0.0) > 0.0
                             and worker_history["timings"].get(n, 0.0) > 0.0 for n in samplers),
                         "a participant's sampler did not run")
                launches, by_instance = _launch_counts(attn)
                peak = torch.cuda.max_memory_allocated() if cuda else 0
                # the master's collector cleans its job up once drained: its
                # counts are in the store's finished records
                record = master.job_store.finished[queued["job_ids"][collector]]
                out = master.get_job(queued["prompt_id"]).outputs[save][0]["images"]
                master_s = sum(history["timings"].values())
                worker_s = sum(worker_history["timings"].values())
                print(f"{label} run {run}: {seconds:.2f} s, {out.shape[0] / seconds:.4f} "
                      f"images/s; node seconds summed: master {master_s:.2f} (collector "
                      f"{history['timings'].get(collector, 0.0):.2f}), w1 "
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
                saved = history["outputs"][save]["images"]
                _require(len(saved) == 2, f"saved {saved}")
                for name in saved:
                    with open(os.path.join(out_dir, name), "rb") as fh:
                        _require(img_utils.decode_png_u8(fh.read()).shape == size,
                                 f"{name} is not {size}")
                d0 = float((out[0].float() - local[seed].to(out.device)).abs().max())
                d1 = float((out[1].float() - local[seed + 1].to(out.device)).abs().max())
                d01 = (out[0] - out[1]).float().abs()
                where = "all pixels"
                if region is not None:
                    d01, where = d01[region], f"{region_name} {int(region.sum())} pixels"
                d01_max, d01_mean = float(d01.max()), float(d01.mean())
                print(f"{label} run {run} output {tuple(out.shape)} in "
                      f"[{float(out.min()):.4f}, {float(out.max()):.4f}]; max |diff| image 0 vs "
                      f"the local seed {seed} {d0:.3g} (tolerance {RERUN_TOLERANCE}), image 1 vs "
                      f"the local seed {seed + 1} {d1:.3g} (tolerance "
                      f"{RERUN_TOLERANCE + PNG_STEP:.4f}), image 0 vs 1 over {where} max "
                      f"{d01_max:.3g} and mean {d01_mean:.3g} (each > {RERUN_TOLERANCE})")
                _require(d0 <= RERUN_TOLERANCE, "the master's image is not the local seed's")
                _require(d1 <= RERUN_TOLERANCE + PNG_STEP, "w1's image is not the local seed's")
                _require(d01_max > RERUN_TOLERANCE and d01_mean > RERUN_TOLERANCE,
                         "the master's and w1's images do not differ")
                check_launches(launches, by_instance, 2)
                result = {"launches": launches, "launches_by_instance": by_instance,
                          "images_per_s": out.shape[0] / seconds, "peak_gib": peak / 2**30}
    return result


def _mismatched_parameters(torch, bundle, reference) -> list[str]:
    """The parameters of `bundle` that are not torch.equal to
    `reference`'s."""
    wrong = []
    for part, module in bundle.parts().items():
        want = reference.parts()[part].state_dict()
        wrong += [f"{part}.{name}" for name, value in module.state_dict().items()
                  if not torch.equal(value, want[name])]
    return wrong


def _ckpt_phase(torch, gen, workflows: dict, device: str, expected: dict | None = None) -> dict:
    """Real single-file checkpoints (see the module docstring): for each
    workflow (by kernels-line path), its checkpoint written from weights
    seeded at CKPT_SEED (with a seeded out_conv) as
    `<tmp>/<ckpt>.safetensors` in f16, then the unmodified workflow POSTed
    to a fresh master and w1 with CDT_CHECKPOINT_DIR=<tmp>, each server
    loading the file. Every parameter of both loaded bundles must equal
    the written weights rounded through f16 into the module's dtype;
    image 0 must be the local run's on a bundle of those rounded weights
    (RERUN_TOLERANCE), and apart, in max and mean, from the same seed on
    the registry's default random init. `expected` maps a path to its
    (launches, by instance) a run, unchecked when None (no card).
    Returns each path's launches; the files are deleted."""
    results = {}
    env = os.environ.pop("CDT_CHECKPOINT_DIR", None)
    try:
        with tempfile.TemporaryDirectory(prefix="cdt_ckpt_") as tmp:
            _ckpt_runs(torch, gen, workflows, device, expected, tmp, results)
    finally:
        if env is not None:
            os.environ["CDT_CHECKPOINT_DIR"] = env
    return results


def _ckpt_runs(torch, gen, workflows: dict, device: str, expected: dict | None, tmp: str,
               results: dict) -> None:
    """`_ckpt_phase`'s runs, in `tmp`, CDT_CHECKPOINT_DIR unset around
    them."""
    from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
    from comfyui_distributed_tpu_torch.models import pipeline as pl
    from comfyui_distributed_tpu_torch.models import sd_checkpoint as sdc
    from comfyui_distributed_tpu_torch.ops import attention as attn

    cuda = device.startswith("cuda")
    label = "[ckpt]"
    settings = {"input_dir": os.path.join(tmp, "input"),
                "output_dir": os.path.join(tmp, "output")}
    for path_name, workflow in workflows.items():
        loader = _node_id(workflow, "CheckpointLoaderSimple")
        ckpt = workflow[loader]["inputs"]["ckpt_name"]
        save = _node_id(workflow, "SaveImage")
        size = (*_image_px(workflow), 3)
        seed = int(workflow[_node_id(workflow, "DistributedSeed")]["inputs"]["seed"])

        # the registry's default init, before the file exists
        default_context = ExecutionContext(device=device, config={"settings": settings})
        default, _, _, _ = _local_run(torch, attn, GraphExecutor(default_context), workflow,
                                      label, f"{ckpt} seed {seed}, the default random init",
                                      device, size)
        del default_context

        source = pl.load_pipeline(ckpt, seed=CKPT_SEED, device=device)
        _seed_out_conv(torch, source, gen)
        file = os.path.join(tmp, f"{ckpt}.safetensors")
        if cuda:
            torch.cuda.synchronize()
        started = time.perf_counter()
        nbytes = sdc.save_safetensors(sdc.synthesize_checkpoint(source), file,
                                      dtype=torch.float16)
        write_s = time.perf_counter() - started
        # the weights a load gives: each written value, through f16, in
        # its parameter's dtype
        with torch.no_grad():
            for module in source.parts().values():
                for param in module.parameters():
                    param.copy_(param.half().to(param.dtype))
        direct_context = ExecutionContext(device=device, config={"settings": settings},
                                          pipelines={ckpt: source})
        direct, _, _, _ = _local_run(torch, attn, GraphExecutor(direct_context), workflow,
                                     label, f"{ckpt} seed {seed}, the written weights direct",
                                     device, size)
        print(f"{label} {ckpt}: wrote {file} {nbytes} bytes (f16, seeded at {CKPT_SEED}) in "
              f"{write_s:.2f} s ({nbytes / write_s / 1e9:.3f} GB/s)")

        os.environ["CDT_CHECKPOINT_DIR"] = tmp
        try:
            with _serving(tmp, settings, device) as (master, worker, base, worker_port):
                if cuda:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                attn.reset_launch_counts()
                started = time.perf_counter()
                queued, history, worker_history = _queue(base, worker_port, workflow)
                if cuda:
                    torch.cuda.synchronize()
                seconds = time.perf_counter() - started
                launches, by_instance = _launch_counts(attn)
                peak = torch.cuda.max_memory_allocated() if cuda else 0
                out = master.get_job(queued["prompt_id"]).outputs[save][0]["images"]
                loads = {"master": history["timings"][loader],
                         "w1": worker_history["timings"][loader]}
                wrong = {who: _mismatched_parameters(torch, server.execution_context
                                                     .pipelines[ckpt], source)
                         for who, server in (("master", master), ("w1", worker))}
        finally:
            os.environ.pop("CDT_CHECKPOINT_DIR", None)
        os.remove(file)
        n_params = sum(p.numel() for m in source.parts().values()
                       for p in m.parameters())
        print(f"{label} {ckpt} run: {seconds:.2f} s, {out.shape[0] / seconds:.4f} images/s; "
              f"file loads (CheckpointLoaderSimple node seconds): " + ", ".join(
                  f"{who} {s:.2f} s ({nbytes / s / 1e9:.3f} GB/s)" for who, s in loads.items())
              + f"; {n_params} parameters, not torch.equal to the written weights: master "
              f"{len(wrong['master'])}, w1 {len(wrong['w1'])}; flash_attention launches "
              f"{launches}, by instance {by_instance}; peak {peak / 2**30:.2f} GiB")
        _require(not wrong["master"] and not wrong["w1"],
                 f"loaded weights differ from the written ones: {wrong}")
        _require(tuple(out.shape) == (2, *size), f"output shape {tuple(out.shape)}")
        _require(bool(torch.isfinite(out).all()), "non-finite output")
        _require(float(out.min()) >= 0.0 and float(out.max()) <= 1.0, "output outside [0, 1]")
        d_direct = float((out[0].float() - direct.to(out.device)).abs().max())
        apart = (out[0].float() - default.to(out.device)).abs()
        print(f"{label} {ckpt} image 0 vs the written weights direct max |diff| "
              f"{d_direct:.3g} (tolerance {RERUN_TOLERANCE}); vs the default random init "
              f"max {float(apart.max()):.3g} and mean {float(apart.mean()):.3g} (each > "
              f"{RERUN_TOLERANCE})")
        _require(d_direct <= RERUN_TOLERANCE, "the served image is not the written weights'")
        _require(float(apart.max()) > RERUN_TOLERANCE and float(apart.mean()) > RERUN_TOLERANCE,
                 "the served image is the default random init's: the file was not read")
        if expected is not None:
            want_launches, want_by = expected[path_name]
            _require(launches == want_launches and by_instance == want_by,
                     f"{launches} attention launches by instance {by_instance}, expected "
                     f"{want_launches}, {want_by}")
        results[path_name] = {"launches": launches, "launches_by_instance": by_instance,
                              "file_bytes": nbytes, "load_seconds": loads}
        del source, direct_context


def _samplers_phase(torch, bundle, workflow, device: str, check_launches: bool = False) -> dict:
    """Every sampler and scheduler on the seed-parallel txt2img workflow,
    locally (see the module docstring): each sampler but euler on the
    workflow's scheduler, each scheduler but karras with euler. Each image
    finite in [0, 1] with model_evals_per_scan's evaluations' launches
    (`check_launches`: a card); a stochastic sampler's rerun at the seed
    within RERUN_TOLERANCE and the next seed apart in max and mean.
    Returns the phase's launches summed over its runs, and those of
    SAMPLERS_ENTRY_SAMPLER's run alone (`entry_launches`,
    `entry_by_instance`)."""
    from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
    from comfyui_distributed_tpu_torch.ops import attention as attn
    from comfyui_distributed_tpu_torch.ops import samplers as smp

    label = "[samplers]"
    ckpt = workflow[_node_id(workflow, "CheckpointLoaderSimple")]["inputs"]["ckpt_name"]
    ksampler = _node_id(workflow, "KSampler")
    seed_node = _node_id(workflow, "DistributedSeed")
    seed = int(workflow[seed_node]["inputs"]["seed"])
    size = (*_image_px(workflow), 3)
    base = workflow[ksampler]["inputs"]
    variants = [{"sampler_name": s} for s in smp.SAMPLER_NAMES if s != base["sampler_name"]]
    variants += [{"scheduler": s, "sampler_name": "euler"} for s in smp.SCHEDULER_NAMES
                 if s != base["scheduler"]]
    executor = GraphExecutor(ExecutionContext(device=device, pipelines={ckpt: bundle}))
    total, by_total, seconds_by, entry = 0, {}, {}, None
    for change in variants:
        prompt = copy.deepcopy(workflow)
        prompt[ksampler]["inputs"].update(change)
        what = ", ".join(f"{k} {v}" for k, v in change.items())
        runs = [(seed, "")]
        if change["sampler_name"] in smp.STOCHASTIC_SAMPLERS:
            runs += [(seed, ", rerun"), (seed + 1, "")]
        images = []
        for s, note in runs:
            prompt[seed_node]["inputs"]["seed"] = s
            image, launches, by_instance, seconds = _local_run(
                torch, attn, executor, prompt, label, f"{what}, seed {s}{note}", device, size)
            images.append(image)
            seconds_by[f"{what}, seed {s}{note}"] = seconds
            total += launches
            by_total = {k: by_total.get(k, 0) + v for k, v in by_instance.items()}
            if change == {"sampler_name": SAMPLERS_ENTRY_SAMPLER}:
                entry = (launches, by_instance)
            _require(float(image.min()) >= 0.0 and float(image.max()) <= 1.0,
                     f"{what}: output outside [0, 1]")
            if check_launches:
                shapes = _txt2img_shapes(prompt)
                want = _expected_by_instance(attn, shapes, torch)
                _require(launches == sum(c for *_, c in shapes) and by_instance == want,
                         f"{what}: {launches} attention launches by instance {by_instance}, "
                         f"expected {want} ({_sampler_evals(prompt)} evaluations)")
        if len(images) == 3:
            rerun = float((images[1] - images[0]).abs().max())
            apart = (images[2] - images[0]).abs()
            print(f"{label} {what}: seed {seed} rerun max |diff| {rerun:.3g} (tolerance "
                  f"{RERUN_TOLERANCE}); seed {seed + 1} vs {seed} max {float(apart.max()):.3g} "
                  f"and mean {float(apart.mean()):.3g} (each > {RERUN_TOLERANCE})")
            _require(rerun <= RERUN_TOLERANCE, f"{what}: a rerun of one seed disagrees")
            _require(float(apart.max()) > RERUN_TOLERANCE
                     and float(apart.mean()) > RERUN_TOLERANCE,
                     f"{what}: two seeds give one image")
    _require(entry is not None, f"no run of {SAMPLERS_ENTRY_SAMPLER}")
    return {"launches": total, "launches_by_instance": by_total, "seconds": seconds_by,
            "entry_launches": entry[0], "entry_by_instance": entry[1]}


def _seed_weight(torch, weight, gen) -> None:
    """`weight` drawn N(0, 1/fan_in) from `gen`, in place: the output convs
    (the UNet's out_conv, the ControlNet's conv_out, the upscaler's tail)
    start at zero, as the JAX package's do, and would hide their model."""
    with torch.no_grad():
        weight.copy_(torch.randn(weight.shape, generator=gen, device=weight.device)
                     / math.sqrt(weight[0].numel()))


def _usdu_full_workflow(workflow):
    """The upscale workflow with USDU_FULL's nodes added in memory: an
    UpscaleModelLoader into the USDU node's upscale_model, a
    ControlNetLoader and ControlNetApplyAdvanced (strength 1 over the
    whole schedule, LoadImage's image as the hint) on both
    conditionings, the positive re-encoded by CLIPTextEncodeSDXL with the
    same text, and tiled_decode."""
    prompt = copy.deepcopy(workflow)
    usdu = prompt[USDU_NODE]["inputs"]
    loader = _node_id(prompt, "CheckpointLoaderSimple")
    load_image = _node_id(prompt, "LoadImage")
    positive, negative = usdu["positive"][0], usdu["negative"][0]
    text = prompt[positive]["inputs"]["text"]
    size, target = USDU_FULL_SIZE_COND
    free = max(int(k) for k in prompt) + 1
    upscaler, net, apply = (str(free + i) for i in range(3))
    prompt[positive] = {"class_type": "CLIPTextEncodeSDXL", "inputs": {
        "clip": prompt[positive]["inputs"]["clip"], "width": size, "height": size,
        "crop_w": 0, "crop_h": 0, "target_width": target, "target_height": target,
        "text_g": text, "text_l": text}}
    prompt[upscaler] = {"class_type": "UpscaleModelLoader",
                        "inputs": {"model_name": USDU_FULL_UPSCALER}}
    prompt[net] = {"class_type": "ControlNetLoader", "inputs": {
        "control_net_name": USDU_FULL_CONTROLNET, "model": [loader, 0]}}
    prompt[apply] = {"class_type": "ControlNetApplyAdvanced", "inputs": {
        "positive": [positive, 0], "negative": [negative, 0], "control_net": [net, 0],
        "image": [load_image, 0], "strength": 1.0, "start_percent": 0.0, "end_percent": 1.0}}
    usdu.update(positive=[apply, 0], negative=[apply, 1], upscale_model=[upscaler, 0],
                tiled_decode=True)
    return prompt


def _usdu_full_shapes(workflow, image_px: int = IMAGE_PX):
    """The attention calls of one usdu_full tile: the UNet at batch 1 for
    the positive and again for the negative (a ControlNet keeps the CFG
    pair apart) at each evaluation, the VAE encode of the padded tile,
    and the tiled decode's pieces (ops/tiled_vae.py's 64-latent tiles
    with 8 of overlap, or the whole tile where it fits one)."""
    from comfyui_distributed_tpu_torch.models.registry import DUAL_TEXT_ENCODERS, get_config
    from comfyui_distributed_tpu_torch.ops.samplers import get_sigmas, model_evals_per_scan
    from comfyui_distributed_tpu_torch.ops.tiles import calculate_tiles

    o = _usdu_options(workflow)
    ckpt = workflow[_node_id(workflow, "CheckpointLoaderSimple")]["inputs"]["ckpt_name"]
    unet_cfg, vae_cfg = get_config(ckpt), get_config("vae-sd")
    te_len = get_config(DUAL_TEXT_ENCODERS[ckpt][1]).max_length
    pairs = get_sigmas(o["scheduler"], int(o["steps"]), float(o["denoise"])).shape[0] - 1
    evals = model_evals_per_scan(o["sampler_name"], pairs)
    side = (int(o["tile_width"]) + 2 * int(o["tile_padding"])) // vae_cfg.downscale
    shapes = _unet_shapes(unet_cfg, te_len, (side, side), 1, 2 * evals, tag="batch-1 ")
    shapes.append(_vae_shape(vae_cfg, side, 1))
    if side <= 64:
        shapes.append(_vae_shape(vae_cfg, side, 1))
    else:
        grid = calculate_tiles(side, side, 64, 64, 8)
        shapes.append(_vae_shape(vae_cfg, grid.padded_h, grid.num_tiles))
    return shapes


def _guidance_variants(workflow, image_px: int = IMAGE_PX) -> dict:
    """name → the txt2img workflow with one GUIDANCE_PATCHES node between
    the checkpoint and KSampler; "area": the positive combined with
    AREA_PROMPT over the image's top half (ConditioningSetArea, strength
    1), gated to AREA_WINDOW (ConditioningSetTimestepRange)."""
    ksampler = _node_id(workflow, "KSampler")
    loader = _node_id(workflow, "CheckpointLoaderSimple")
    height, width = _image_px(workflow, image_px)
    free = max(int(k) for k in workflow) + 1
    variants = {}
    for cls, inputs in GUIDANCE_PATCHES.items():
        prompt = copy.deepcopy(workflow)
        prompt[str(free)] = {"class_type": cls, "inputs": {"model": [loader, 0], **inputs}}
        prompt[ksampler]["inputs"]["model"] = [str(free), 0]
        variants[cls] = prompt
    prompt = copy.deepcopy(workflow)
    encode, area, window, combine = (str(free + i) for i in range(4))
    positive = prompt[ksampler]["inputs"]["positive"]
    clip = prompt[positive[0]]["inputs"]["clip"]
    prompt[encode] = {"class_type": "CLIPTextEncode", "inputs": {"text": AREA_PROMPT,
                                                                 "clip": clip}}
    prompt[area] = {"class_type": "ConditioningSetArea", "inputs": {
        "conditioning": [encode, 0], "width": width, "height": height // 2, "x": 0, "y": 0,
        "strength": 1.0}}
    prompt[window] = {"class_type": "ConditioningSetTimestepRange", "inputs": {
        "conditioning": [area, 0], "start": AREA_WINDOW[0], "end": AREA_WINDOW[1]}}
    prompt[combine] = {"class_type": "ConditioningCombine", "inputs": {
        "conditioning_1": positive, "conditioning_2": [window, 0]}}
    prompt[ksampler]["inputs"]["positive"] = [combine, 0]
    variants["area"] = prompt
    return variants


def _guidance_shapes(variant: str, workflow, image_px: int = IMAGE_PX):
    """The attention calls of one image of a guidance variant (see
    `_guidance_variants`): plain CFG at batch 2 (FreeU, RescaleCFG); SAG
    adds a batch-1 capture pass (its middle self-attention plain) and a
    batch-1 degraded pass an evaluation; "area" runs three batch-1
    passes, the whole latent for the positive's plain entry and the
    negative and the area's crop (pixels // 8) for the other. One VAE
    decode."""
    from comfyui_distributed_tpu_torch.models.registry import DEFAULT_TEXT_ENCODERS, get_config

    ckpt = workflow[_node_id(workflow, "CheckpointLoaderSimple")]["inputs"]["ckpt_name"]
    unet_cfg, vae_cfg = get_config(ckpt), get_config("vae-sd")
    te_len = get_config(DEFAULT_TEXT_ENCODERS.get(ckpt, "clip-l")).max_length
    height, width = _image_px(workflow, image_px)
    hw = (height // vae_cfg.downscale, width // vae_cfg.downscale)
    _require(hw[0] == hw[1], f"a {height}x{width} image: the VAE shape assumes a square")
    evals = _sampler_evals(workflow)
    if variant == "area":
        shapes = _unet_shapes(unet_cfg, te_len, hw, 1, 2 * evals, tag="batch-1 ")
        shapes += _unet_shapes(unet_cfg, te_len, (hw[0] // 2, hw[1]), 1, evals,
                               tag="area batch-1 ")
    else:
        shapes = _unet_shapes(unet_cfg, te_len, hw, 2, evals)
        if variant == "SelfAttentionGuidance":
            shapes += _unet_shapes(unet_cfg, te_len, hw, 1, evals, sag_capture=True,
                                   tag="capture batch-1 ")
            shapes += _unet_shapes(unet_cfg, te_len, hw, 1, evals, tag="batch-1 ")
    shapes.append(_vae_shape(vae_cfg, hw[0], 1))
    return shapes


@contextlib.contextmanager
def _recording(torch, module, name: str, device: str):
    """`module.name` replaced, inside the block, by a wrapper that appends
    (seconds, args, result) of each call to the yielded list, the device
    synchronised on both sides of the call."""
    original = getattr(module, name)
    calls = []
    cuda = device.startswith("cuda")

    def wrapper(*args, **kwargs):
        if cuda:
            torch.cuda.synchronize()
        started = time.perf_counter()
        out = original(*args, **kwargs)
        if cuda:
            torch.cuda.synchronize()
        calls.append((time.perf_counter() - started, args, out))
        return out

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, original)


def _usdu_full_models(torch, bundle, gen, device: str) -> dict:
    """The upscale model and the ControlNet of USDU_FULL, seeded by name on
    `device` with their output convs seeded non-zero from `gen`, under
    the keys their loader nodes look up."""
    from comfyui_distributed_tpu_torch.models.controlnet import load_controlnet
    from comfyui_distributed_tpu_torch.models.registry import get_config
    from comfyui_distributed_tpu_torch.models.upscaler import load_upscale_model

    channels = get_config(bundle.model_name).model_channels
    upscaler = load_upscale_model(USDU_FULL_UPSCALER, device=device)
    net = load_controlnet(USDU_FULL_CONTROLNET, channels, bundle.latent_scale, device=device)
    _seed_weight(torch, upscaler.module.tail.weight, gen)
    _seed_weight(torch, net.module.conv_out.weight, gen)
    return {f"upscaler:{USDU_FULL_UPSCALER}": upscaler,
            f"controlnet:{USDU_FULL_CONTROLNET}:{channels}:{bundle.latent_scale}": net}


def _usdu_full_phase(torch, bundle, workflow, image, gen, device: str,
                     expected_launches: int | None = None,
                     expected_by_instance: dict | None = None,
                     tiled_tolerance: float | None = None) -> dict:
    """USDU with everything users wire into it (`_usdu_full_workflow`),
    once locally through the GraphExecutor and once as master + w1 over
    HTTP (see the module docstring). Checks: every tile completed once;
    the HTTP output within RERUN_TOLERANCE of the local tiles composited
    the elastic way; the master's and w1's pre-upscaled images equal; a
    local run with the ControlNet's conv_out zeroed (same passes, same
    launches) at least CONTROLNET_MIN_DIFF from the local output; the local tiles' latents decoded in tiles within
    `tiled_tolerance` (mean |diff|) of their whole decode; the local run's
    launches. With `expected_launches` None (no card) the launch counts go
    unchecked. Returns the local run's launches."""
    import numpy as np

    from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
    from comfyui_distributed_tpu_torch.graph import nodes_upscale
    from comfyui_distributed_tpu_torch.ops import attention as attn
    from comfyui_distributed_tpu_torch.ops import tiles as tile_ops
    from comfyui_distributed_tpu_torch.ops import upscale as up
    from comfyui_distributed_tpu_torch.utils import image as img_utils

    cuda = device.startswith("cuda")
    label = "[usdu_full]"
    full = _usdu_full_workflow(workflow)
    ckpt = full[_node_id(full, "CheckpointLoaderSimple")]["inputs"]["ckpt_name"]
    load_image = _node_id(full, "LoadImage")
    save = _node_id(full, "SaveImage")
    apply = _node_id(full, "ControlNetApplyAdvanced")
    pipelines = {ckpt: bundle, **_usdu_full_models(torch, bundle, gen, device)}
    o = _usdu_options(full)

    def local_prompt(strength: float):
        prompt = copy.deepcopy(full)
        del prompt[load_image], prompt[save]
        prompt[USDU_NODE]["inputs"]["image"] = image
        prompt[apply]["inputs"].update(image=image, strength=strength)
        return prompt

    executor = GraphExecutor(ExecutionContext(device=device, pipelines=dict(pipelines)))
    tiles = {}
    original_process = up._process_tile_fn

    def recording_process(*args, **kwargs):
        process = original_process(*args, **kwargs)

        def run(tile, tile_index, *rest):
            tiles[tile_index] = process(tile, tile_index, *rest)
            return tiles[tile_index]

        return run

    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    up._process_tile_fn = recording_process
    try:
        with _recording(torch, nodes_upscale, "pre_upscale", device) as pre_calls, \
                _recording(torch, up, "decode_tiled", device) as decode_calls:
            attn.reset_launch_counts()
            started = time.perf_counter()
            executor.execute(local_prompt(1.0))
            local = executor.last_results[USDU_NODE][0]
            if cuda:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - started
            launches, by_instance = _launch_counts(attn)
    finally:
        up._process_tile_fn = original_process
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    pre_image = pre_calls[0][2][0]
    upscaled, grid, _ = up.prepare_upscaled_tiles(
        pre_image, 1.0, int(o["tile_width"]), int(o["tile_padding"]), o["upscale_method"],
        int(o["tile_height"]), mask_blur=int(o["mask_blur"]),
        uniform=bool(o["force_uniform_tiles"]))
    n_tiles = grid.num_tiles
    print(f"{label} local run: {seconds:.2f} s, {n_tiles / seconds:.4f} tiles/s; upscale model "
          f"{pre_calls[0][0]:.3f} s ({tuple(image.shape)} → {tuple(pre_image.shape)}); tiled "
          f"decode {sum(c[0] for c in decode_calls):.3f} s over {len(decode_calls)} tiles; "
          f"flash_attention launches {launches}, by instance {by_instance}; peak "
          f"{peak / 2**30:.2f} GiB; node times {executor.last_timings}")
    _require(tuple(local.shape) == tuple(upscaled.shape), f"output shape {tuple(local.shape)}")
    _require(bool(torch.isfinite(local).all()), "non-finite local output")
    _require(float(local.min()) >= 0.0 and float(local.max()) <= 1.0, "output outside [0, 1]")
    _require(sorted(tiles) == list(range(n_tiles)), f"local tiles {sorted(tiles)}")
    if expected_launches is not None:
        _require(launches == expected_launches and by_instance == expected_by_instance,
                 f"{launches} attention launches by instance {by_instance}, expected "
                 f"{expected_launches}, {expected_by_instance}")
    # the tiled decode against the whole decode of the same latents
    latents = decode_calls[0][1][1]
    with torch.no_grad():
        whole = bundle.vae.decode(latents).float()
    tiled_diff = (decode_calls[0][2].float() - whole).abs()
    print(f"{label} tile 0's latents {tuple(latents.shape)} decoded in tiles vs whole: max "
          f"|diff| {float(tiled_diff.max()):.3g}, mean {float(tiled_diff.mean()):.3g} "
          f"(tolerance on the mean {tiled_tolerance})")
    if tiled_tolerance is not None:
        _require(float(tiled_diff.mean()) <= tiled_tolerance,
                 "the tiled decode is not within its tolerance of the whole decode")
    # the ControlNet moves the output: a run whose ControlNet adds a zero
    # residual (conv_out zeroed) keeps the same batch-1 passes and
    # launches, so it differs from the local run in the residual alone; a
    # run at strength 0 batches the CFG pair, and its distance from the
    # zero-residual run is the batching's alone (printed, unchecked)
    conv_out = pipelines[next(k for k in pipelines if k.startswith("controlnet:"))] \
        .module.conv_out
    seeded = [t.detach().clone() for t in conv_out.parameters()]
    with torch.no_grad():
        for t in conv_out.parameters():
            t.zero_()
    try:
        executor.context.extras.pop("node_cache", None)
        attn.reset_launch_counts()
        executor.execute(local_prompt(1.0))
        zero_residual = executor.last_results[USDU_NODE][0]
        zero_launches, zero_by_instance = _launch_counts(attn)
    finally:
        with torch.no_grad():
            for t, saved in zip(conv_out.parameters(), seeded):
                t.copy_(saved)
    executor.context.extras.pop("node_cache", None)
    executor.execute(local_prompt(0.0))
    no_control = executor.last_results[USDU_NODE][0]
    control_diff = float((local.float() - zero_residual.float()).abs().max())
    batching_diff = float((zero_residual.float() - no_control.float()).abs().max())
    print(f"{label} ControlNet residual vs zero residual (conv_out zeroed, strength 1, "
          f"{zero_launches} launches) max |diff| {control_diff:.3g} (at least "
          f"{CONTROLNET_MIN_DIFF:.4f}); zero residual vs strength 0 (the CFG pair batched) "
          f"max |diff| {batching_diff:.3g}; strength 1 vs 0 max |diff| "
          f"{float((local.float() - no_control.float()).abs().max()):.3g}")
    _require((zero_launches, zero_by_instance) == (launches, by_instance),
             f"the zero-residual run launched {zero_launches} by instance {zero_by_instance}, "
             f"the local run {launches} by instance {by_instance}")
    _require(control_diff >= CONTROLNET_MIN_DIFF, "the ControlNet does not change the output")
    reference = tile_ops.DeterministicHostCanvas(upscaled, grid)
    for g in range(n_tiles):
        reference.blend(tiles[g], *grid.positions[g])
    reference = reference.result().float()

    # master + w1 over HTTP
    with tempfile.TemporaryDirectory(prefix="cdt_usdu_full_") as tmp:
        in_dir, out_dir = os.path.join(tmp, "input"), os.path.join(tmp, "output")
        os.makedirs(in_dir)
        with open(os.path.join(in_dir, full[load_image]["inputs"]["image"]), "wb") as fh:
            fh.write(img_utils.encode_png(np.asarray(image[0].float().cpu())))
        blend_env = os.environ.get("CDT_DETERMINISTIC_BLEND")
        os.environ["CDT_DETERMINISTIC_BLEND"] = "1"
        try:
            with _serving(tmp, {"input_dir": in_dir, "output_dir": out_dir}, device,
                          pipelines) as (master, worker, base, worker_port), \
                    _recording(torch, nodes_upscale, "pre_upscale", device) as http_pre:
                if cuda:
                    torch.cuda.synchronize()
                attn.reset_launch_counts()
                started = time.perf_counter()
                queued, history, _ = _queue(base, worker_port, full)
                if cuda:
                    torch.cuda.synchronize()
                http_seconds = time.perf_counter() - started
                http_launches, http_by_instance = _launch_counts(attn)
                record = master.job_store.finished[queued["job_ids"][USDU_NODE]]
                out = master.get_job(queued["prompt_id"]).outputs[save][0]["images"]
        finally:
            if blend_env is None:
                os.environ.pop("CDT_DETERMINISTIC_BLEND", None)
            else:
                os.environ["CDT_DETERMINISTIC_BLEND"] = blend_env
    by = {}
    for _, who in record["completions"]:
        by[who] = by.get(who, 0) + 1
    done = sorted(t for t, _ in record["completions"])
    pre_diff = float((http_pre[0][2][0].float() - http_pre[1][2][0].float()).abs().max()) \
        if len(http_pre) == 2 else float("nan")
    diff = float((out.float() - reference.to(out.device)).abs().max())
    print(f"{label} HTTP run: {http_seconds:.2f} s, {n_tiles / http_seconds:.4f} tiles/s; tiles "
          f"completed: master {by.get('master', 0)}, w1 {by.get('w1', 0)} (order "
          f"{record['completions']}); flash_attention launches {http_launches}, by instance "
          f"{http_by_instance}; the master's and w1's pre-upscaled images max |diff| "
          f"{pre_diff:.3g}; output vs the local tiles composited alike max |diff| {diff:.3g} "
          f"(tolerance {RERUN_TOLERANCE})")
    _require(done == list(range(n_tiles)), f"tiles completed {done}, expected each once")
    _require(set(by) <= {"master", "w1"}, f"unexpected participants {sorted(by)}")
    _require(len(http_pre) == 2, f"{len(http_pre)} pre-upscales, expected master and w1")
    _require(pre_diff == 0.0, "the master's and w1's pre-upscaled images differ")
    _require(tuple(out.shape) == tuple(reference.shape), f"HTTP output shape {tuple(out.shape)}")
    _require(bool(torch.isfinite(out).all()), "non-finite HTTP output")
    _require(diff <= RERUN_TOLERANCE, "the HTTP output disagrees with the local tiles")
    if expected_launches is not None:
        _require(http_launches == expected_launches and http_by_instance == expected_by_instance,
                 f"HTTP run: {http_launches} attention launches by instance "
                 f"{http_by_instance}, expected {expected_launches}, {expected_by_instance}")
    return {"launches": launches, "launches_by_instance": by_instance,
            "tiles_per_s": n_tiles / seconds, "peak_gib": peak / 2**30}


def _guidance_phase(torch, bundle, workflow, device: str, expected: dict | None = None,
                    image_px: int = IMAGE_PX) -> dict:
    """The guidance patches and area conditioning on the txt2img workflow
    (see `_guidance_variants`): a local image at its seed for each
    variant, finite in [0, 1] and at least GUIDANCE_MIN_DIFF from the
    unpatched image; the cached bundle unpatched after them; then SAG as
    master + w1 through the collector (`_txt2img_phase`, one run).
    `expected` maps a variant to its (launches, by instance) an image,
    unchecked when None (no card). Returns each variant's local run."""
    from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
    from comfyui_distributed_tpu_torch.ops import attention as attn

    label = "[guidance]"
    ckpt = workflow[_node_id(workflow, "CheckpointLoaderSimple")]["inputs"]["ckpt_name"]
    seed = int(workflow[_node_id(workflow, "DistributedSeed")]["inputs"]["seed"])
    size = (*_image_px(workflow, image_px), 3)
    executor = GraphExecutor(ExecutionContext(device=device, pipelines={ckpt: bundle}))
    plain, _, _, _ = _local_run(torch, attn, executor, workflow, label,
                                f"seed {seed}, unpatched", device, size)
    results = {}
    for name, prompt in _guidance_variants(workflow, image_px).items():
        image, launches, by_instance, seconds = _local_run(
            torch, attn, executor, prompt, label, f"{name}, seed {seed}", device, size)
        diff = float((image - plain).abs().max())
        print(f"{label} {name} vs unpatched max |diff| {diff:.3g} (at least "
              f"{GUIDANCE_MIN_DIFF:.4f})")
        _require(float(image.min()) >= 0.0 and float(image.max()) <= 1.0,
                 f"{name}: output outside [0, 1]")
        _require(diff >= GUIDANCE_MIN_DIFF, f"{name} does not change the image")
        if expected is not None:
            _require((launches, by_instance) == expected[name],
                     f"{name}: {launches} attention launches by instance {by_instance}, "
                     f"expected {expected[name]}")
        results[name] = {"launches": launches, "launches_by_instance": by_instance,
                         "seconds": seconds}
    _require(bundle.unet.config.freeu is None and bundle.sag is None
             and bundle.cfg_rescale is None, "a patch node changed the cached bundle")
    sag = _guidance_variants(workflow, image_px)["SelfAttentionGuidance"]
    per_run = None if expected is None else expected["SelfAttentionGuidance"]
    results["http"] = _txt2img_phase(
        torch, bundle, sag, device,
        expected_launches=None if per_run is None else 2 * per_run[0],
        expected_by_instance=None if per_run is None else
        {k: 2 * v for k, v in per_run[1].items()}, runs=1, tag="guidance", image_px=image_px)
    return results


def _inpaint_model_checks(torch, executor, workflow, imc: str, image, label: str):
    """An InpaintModelConditioning graph's checks on its local run: both
    conditionings carry the same 5 concat channels (the mask, then the
    masked image's 4 latent channels), and against the decode of its
    starting latents the image changes less where the outpainting mask is
    0 than where it is 1. Returns the mask-1 pixels, which the
    images-apart check reads."""
    positive, negative, latent = executor.last_results[imc]
    concat = positive.concat_latent
    _require(concat is not None and tuple(concat.shape[1:3]) == tuple(latent["samples"].shape[1:3])
             and concat.shape[-1] == 5, f"concat channels {None if concat is None else tuple(concat.shape)}")
    _require(negative.concat_latent is concat, "the negative's concat channels are not the positive's")
    pad = workflow[imc]["inputs"]["mask"][0]
    mask = executor.last_results[pad][1][0].to(image.device)
    vae = executor.context.pipelines[workflow[_node_id(workflow, "CheckpointLoaderSimple")]
                                     ["inputs"]["ckpt_name"]].vae
    with torch.no_grad():
        start = vae.decode(latent["samples"])[0].float()
    change = (image - start).abs().mean(dim=-1)
    kept, new = change[mask == 0.0], change[mask == 1.0]
    print(f"{label} concat channels {tuple(concat.shape)} on both sides; mean |change| against "
          f"the decoded starting latents: {float(kept.mean()):.4f} over the {kept.numel()} "
          f"original pixels (mask 0), {float(new.mean()):.4f} over the {new.numel()} "
          f"outpainted ones (mask 1)")
    _require(bool(kept.numel()) and bool(new.numel()), "the outpainting mask is all one value")
    _require(float(kept.mean()) < float(new.mean()),
             "the original region changed as much as the outpainted one")
    return mask == 1.0


def _relinked(workflow, relink: dict):
    """The workflow with every link (node id, output) in `relink` replaced,
    following chains."""
    from comfyui_distributed_tpu_torch.graph.prompt import is_link

    def target(link):
        key = (str(link[0]), int(link[1]))
        while key in relink:
            key = relink[key]
        return [key[0], key[1]]

    for node in workflow.values():
        node["inputs"] = {k: target(v) if is_link(v) else v for k, v in node["inputs"].items()}
    return workflow


def _custom_workflow(flux_workflow, guider: str, ckpt: str = "sd15", image_px: int = IMAGE_PX):
    """The bundled Flux custom-sampling workflow on an SD checkpoint: its
    UNETLoader becomes CheckpointLoaderSimple `ckpt` (whose CLIP and VAE
    stand in for DualCLIPLoader's and VAELoader's), ModelSamplingFlux and
    FluxGuidance drop out, EmptySD3LatentImage becomes EmptyLatentImage
    at `image_px`, and `guider` (CUSTOM_GUIDERS) takes BasicGuider's place
    with a negative prompt, an empty conditioning (PerpNeg) or a second
    prompt (DualCFG) as it needs. DistributedSeed → RandomNoise,
    BasicScheduler, KSamplerSelect, SamplerCustomAdvanced, VAEDecode,
    DistributedCollector and SaveImage stay."""
    wf = copy.deepcopy(flux_workflow)
    ids = {cls: _node_id(wf, cls) for cls in (
        "UNETLoader", "DualCLIPLoader", "VAELoader", "ModelSamplingFlux", "FluxGuidance",
        "EmptySD3LatentImage", "BasicGuider", "CLIPTextEncode")}
    loader = ids["UNETLoader"]
    relink = {(ids["DualCLIPLoader"], 0): (loader, 1), (ids["VAELoader"], 0): (loader, 2),
              (ids["ModelSamplingFlux"], 0): (loader, 0),
              (ids["FluxGuidance"], 0): tuple(wf[ids["FluxGuidance"]]["inputs"]["conditioning"])}
    for cls in ("DualCLIPLoader", "VAELoader", "ModelSamplingFlux", "FluxGuidance"):
        del wf[ids[cls]]
    wf[loader] = {"class_type": "CheckpointLoaderSimple", "inputs": {"ckpt_name": ckpt}}
    latent = ids["EmptySD3LatentImage"]
    wf[latent] = {"class_type": "EmptyLatentImage",
                  "inputs": {"width": image_px, "height": image_px, "batch_size": 1}}
    _relinked(wf, relink)
    next_id = max(int(k) for k in wf) + 1

    def text(prompt):
        nonlocal next_id
        node_id, next_id = str(next_id), next_id + 1
        wf[node_id] = {"class_type": "CLIPTextEncode",
                       "inputs": {"text": prompt, "clip": [loader, 1]}}
        return [node_id, 0]

    old = wf[ids["BasicGuider"]]["inputs"]
    inputs = {"model": old["model"]}
    if guider == "DualCFGGuider":
        inputs.update(cond1=old["conditioning"], cond2=text(CUSTOM_COND2),
                      negative=text(CUSTOM_NEGATIVE))
    else:
        inputs.update(positive=old["conditioning"], negative=text(CUSTOM_NEGATIVE))
    if guider == "PerpNegGuider":
        inputs["empty_conditioning"] = text("")
    inputs.update(CUSTOM_GUIDERS[guider])
    wf[ids["BasicGuider"]] = {"class_type": guider, "inputs": inputs}
    return wf


def _custom_two_stage(workflow, step: int | None = None):
    """The custom workflow's schedule cut by SplitSigmas at `step`
    (CUSTOM_SPLIT): its SamplerCustomAdvanced runs the high part, a
    second one, fed by DisableNoise, resumes from its output over the low
    part."""
    step = CUSTOM_SPLIT if step is None else step
    wf = copy.deepcopy(workflow)
    first = _node_id(wf, "SamplerCustomAdvanced")
    decode = _node_id(wf, "VAEDecode")
    split, off, second = (str(max(int(k) for k in wf) + i) for i in (1, 2, 3))
    wf[split] = {"class_type": "SplitSigmas",
                 "inputs": {"sigmas": wf[first]["inputs"]["sigmas"], "step": step}}
    wf[off] = {"class_type": "DisableNoise", "inputs": {}}
    wf[second] = {"class_type": "SamplerCustomAdvanced", "inputs": {
        **wf[first]["inputs"], "noise": [off, 0], "sigmas": [split, 1],
        "latent_image": [first, 0]}}
    wf[first]["inputs"]["sigmas"] = [split, 0]
    wf[decode]["inputs"]["samples"] = [second, 0]
    return wf


def _custom_sigmas(workflow, link):
    """The grid of a SIGMAS link: a BasicScheduler's, or a SplitSigmas
    part of one (the shared point in both)."""
    from comfyui_distributed_tpu_torch.ops.samplers import get_sigmas

    node = workflow[str(link[0])]
    inputs = node["inputs"]
    if node["class_type"] == "BasicScheduler":
        return get_sigmas(inputs["scheduler"], int(inputs["steps"]), float(inputs["denoise"]))
    _require(node["class_type"] == "SplitSigmas", f"sigmas from {node['class_type']}")
    sigmas, step = _custom_sigmas(workflow, inputs["sigmas"]), int(inputs["step"])
    return sigmas[:step + 1] if int(link[1]) == 0 else sigmas[step:]


def _custom_shapes(workflow, image_px: int = IMAGE_PX):
    """The attention calls of one image of a custom-sampling workflow: each
    SamplerCustomAdvanced's evaluations at its guider's batch
    (GUIDER_BATCH), one more where its grid stops above sigma 0 (the x0
    prediction of its denoised output), then one VAE decode; calls of
    one shape summed."""
    from comfyui_distributed_tpu_torch.models.registry import DEFAULT_TEXT_ENCODERS, get_config
    from comfyui_distributed_tpu_torch.ops.samplers import model_evals_per_scan

    ckpt = workflow[_node_id(workflow, "CheckpointLoaderSimple")]["inputs"]["ckpt_name"]
    unet_cfg, vae_cfg = get_config(ckpt), get_config("vae-sd")
    te_len = get_config(DEFAULT_TEXT_ENCODERS.get(ckpt, "clip-l")).max_length
    height, width = _image_px(workflow, image_px)
    side = height // vae_cfg.downscale
    _require(height == width, f"a {height}x{width} image: the shapes assume a square")
    merged = {}
    for node_id in _node_ids(workflow, "SamplerCustomAdvanced"):
        inputs = workflow[node_id]["inputs"]
        guider = workflow[inputs["guider"][0]]["class_type"]
        sampler = workflow[inputs["sampler"][0]]["inputs"]["sampler_name"]
        sigmas = _custom_sigmas(workflow, inputs["sigmas"])
        evals = model_evals_per_scan(sampler, sigmas.shape[0] - 1) + int(float(sigmas[-1]) > 0)
        batch = GUIDER_BATCH[guider]
        for label, q, m, count in _unet_shapes(unet_cfg, te_len, (side, side), batch, evals,
                                               tag=f"batch-{batch} " if batch != 2 else ""):
            key = (label, q, m)
            merged[key] = merged.get(key, 0) + count
    shapes = [(label, q, m, count) for (label, q, m), count in merged.items()]
    shapes.append(_vae_shape(vae_cfg, side, 1))
    return shapes


def _custom_phase(torch, bundle, flux_workflow, device: str, expected: dict | None = None,
                  image_px: int = IMAGE_PX) -> dict:
    """The custom-sampling workflow on `bundle` with each guider of
    CUSTOM_GUIDERS, each as master + w1 over HTTP through the collector
    (`_txt2img_phase`, one run: each image against a local run at its
    seed), then locally its schedule split in two stages (SplitSigmas at
    CUSTOM_SPLIT, DisableNoise into the second) against the one-stage run.
    `expected` maps a guider to (launches, by instance) an image,
    unchecked when None (no card). Returns each guider's HTTP run and the
    two-stage comparison; `expected["two_stage"]` holds that run's."""
    from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
    from comfyui_distributed_tpu_torch.ops import attention as attn

    results = {}
    for guider in CUSTOM_GUIDERS:
        workflow = _custom_workflow(flux_workflow, guider, bundle.model_name, image_px)
        per_image = None if expected is None else expected[guider]
        results[guider] = _txt2img_phase(
            torch, bundle, workflow, device,
            expected_launches=None if per_image is None else 2 * per_image[0],
            expected_by_instance=None if per_image is None else
            {k: 2 * v for k, v in per_image[1].items()},
            runs=1, tag=f"custom_{guider}", image_px=image_px)
    label = "[custom]"
    one = _custom_workflow(flux_workflow, "CFGGuider", bundle.model_name, image_px)
    seed = int(one[_node_id(one, "DistributedSeed")]["inputs"]["seed"])
    size = (*_image_px(one, image_px), 3)
    executor = GraphExecutor(ExecutionContext(device=device,
                                              pipelines={bundle.model_name: bundle}))
    single, _, _, _ = _local_run(torch, attn, executor, one, label,
                                 f"seed {seed}, one stage", device, size)
    split, launches, by_instance, _ = _local_run(
        torch, attn, executor, _custom_two_stage(one), label,
        f"seed {seed}, SplitSigmas at {CUSTOM_SPLIT} then DisableNoise", device, size)
    diff = float((split - single).abs().max())
    print(f"{label} seed {seed}: two stages vs one stage max |diff| {diff:.3g} (tolerance "
          f"{RERUN_TOLERANCE})")
    _require(diff <= RERUN_TOLERANCE, "the two stages are not the one-stage trajectory")
    if expected is not None:
        _require((launches, by_instance) == expected["two_stage"],
                 f"two stages: {launches} attention launches by instance {by_instance}, "
                 f"expected {expected['two_stage']}")
    results["two_stage"] = {"max_abs_diff": diff}
    return results


def _dynamic_workflow(video_workflow, frames: int = DYNAMIC_FRAMES):
    """The bundled video-upscale workflow with its image source made
    `frames` LoadImage nodes (frame_0.png, ...) joined by frames - 1
    ImageBatch nodes into the batch the USDU node upscales."""
    wf = copy.deepcopy(video_workflow)
    load = _node_id(wf, "LoadImage")
    usdu = _node_id(wf, "UltimateSDUpscaleDistributed")
    wf[load]["inputs"]["image"] = "frame_0.png"
    next_id, last = max(int(k) for k in wf) + 1, load
    for i in range(1, frames):
        image, batch = str(next_id), str(next_id + 1)
        next_id += 2
        wf[image] = {"class_type": "LoadImage", "inputs": {"image": f"frame_{i}.png"}}
        wf[batch] = {"class_type": "ImageBatch",
                     "inputs": {"image1": [last, 0], "image2": [image, 0]}}
        last = batch
    wf[usdu]["inputs"]["image"] = [last, 0]
    return wf


def _dynamic_frames(frames: int = DYNAMIC_FRAMES, frame_hw: tuple = DYNAMIC_FRAME_HW):
    """Seeded [frames, H, W, 3] frames on 8-bit levels (a PNG holds them
    exactly)."""
    import numpy as np

    from comfyui_distributed_tpu_torch.utils import image as img_utils

    rng = np.random.default_rng(SEED + 1)
    return img_utils.u8_to_f32(img_utils.f32_to_u8(
        rng.random((frames, *frame_hw, 3), dtype=np.float32)))


def _dynamic_shapes(workflow, frame_hw: tuple = DYNAMIC_FRAME_HW):
    """The attention calls of one frame in dynamic mode: each of its tiles
    (square, padded) encodes, samples under CFG and decodes, as a tile of
    the upscale path (`_attention_shapes`), times the frame's tiles."""
    from comfyui_distributed_tpu_torch.models.registry import get_config
    from comfyui_distributed_tpu_torch.ops.samplers import get_sigmas, model_evals_per_scan
    from comfyui_distributed_tpu_torch.ops.upscale import plan_grid

    o = _usdu_options(workflow)
    ckpt = workflow[_node_id(workflow, "CheckpointLoaderSimple")]["inputs"]["ckpt_name"]
    unet_cfg, vae_cfg = get_config(ckpt), get_config("vae-sd")
    te_len = get_config("clip-g").max_length
    grid = plan_grid(*frame_hw, float(o["upscale_by"]), int(o["tile_width"]),
                     int(o["tile_padding"]), int(o["tile_height"]))[2]
    _require(grid.padded_h == grid.padded_w, "the tiles are not square")
    pairs = get_sigmas(o["scheduler"], int(o["steps"]), float(o["denoise"])).shape[0] - 1
    shapes = _attention_shapes(unet_cfg, vae_cfg, te_len, grid.padded_h // vae_cfg.downscale,
                               model_evals_per_scan(o["sampler_name"], pairs))
    return [(label, q, m, count * grid.num_tiles) for label, q, m, count in shapes]


def _dynamic_reference(torch, bundle, workflow, frames):
    """Each frame upscaled here, whole, by `_process_whole_image` with the
    dynamic mode's frame noise: the reference whoever claims a frame."""
    from comfyui_distributed_tpu_torch.graph import usdu_elastic
    from comfyui_distributed_tpu_torch.models import pipeline as pl
    from comfyui_distributed_tpu_torch.ops import upscale as up

    o = _usdu_options(workflow)
    with torch.inference_mode():
        pos, neg = (pl.encode_text_pooled(bundle, [workflow[workflow[USDU_NODE]["inputs"][side][0]]
                                                   ["inputs"]["text"]])
                    for side in ("positive", "negative"))
        upscaled, grid, _, pos, neg = usdu_elastic._prepare(
            bundle, frames, pos, neg, float(o["upscale_by"]), int(o["tile_width"]),
            int(o["tile_padding"]), o["upscale_method"], int(o["tile_height"]),
            int(o["mask_blur"]), bool(o["force_uniform_tiles"]))
        process = usdu_elastic._tile_processor(bundle, grid, int(o["steps"]), o["sampler_name"],
                                               o["scheduler"], float(o["cfg"]), float(o["denoise"]))
        return [usdu_elastic._process_whole_image(
            upscaled[f:f + 1], pos, neg, grid, process,
            up.FrameTileNoise(int(o["seed"]), f, bundle.device))[0].float()
            for f in range(upscaled.shape[0])]


def _dynamic_phase(torch, bundle, video_workflow, device: str,
                   expected: tuple | None = None, frames: int = DYNAMIC_FRAMES,
                   frame_hw: tuple = DYNAMIC_FRAME_HW) -> dict:
    """The video workflow in dynamic mode as master + w1 over HTTP (see
    `_dynamic_workflow`): every frame settled once, w1 at least one of
    them, each frame within RERUN_TOLERANCE of `_dynamic_reference` (plus
    PNG_STEP for w1's, which travel as 8-bit PNG), the master's store
    left with no collector or tile job. `expected` is (launches, by
    instance) a frame, unchecked when None (no card)."""
    from comfyui_distributed_tpu_torch.ops import attention as attn
    from comfyui_distributed_tpu_torch.utils import image as img_utils

    cuda = device.startswith("cuda")
    label = "[dynamic]"
    workflow = _dynamic_workflow(video_workflow, frames)
    ckpt = workflow[_node_id(workflow, "CheckpointLoaderSimple")]["inputs"]["ckpt_name"]
    save = _node_id(workflow, "SaveImage")
    pixels = _dynamic_frames(frames, frame_hw)
    started = time.perf_counter()
    reference = _dynamic_reference(torch, bundle, workflow, torch.from_numpy(pixels).to(device))
    print(f"{label} reference: {frames} frames of {frame_hw[0]}x{frame_hw[1]} upscaled here "
          f"whole in {time.perf_counter() - started:.2f} s")
    with tempfile.TemporaryDirectory(prefix="cdt_dynamic_") as tmp:
        in_dir, out_dir = os.path.join(tmp, "input"), os.path.join(tmp, "output")
        os.makedirs(in_dir)
        for i, frame in enumerate(pixels):
            with open(os.path.join(in_dir, f"frame_{i}.png"), "wb") as fh:
                fh.write(img_utils.encode_png(frame))
        settings = {"input_dir": in_dir, "output_dir": out_dir}
        with _serving(tmp, settings, device, {ckpt: bundle}) as (master, worker, base,
                                                                 worker_port):
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            attn.reset_launch_counts()
            started = time.perf_counter()
            queued, history, _ = _queue(base, worker_port, workflow)
            if cuda:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - started
            launches, by_instance = _launch_counts(attn)
            peak = torch.cuda.max_memory_allocated() if cuda else 0
            record = master.job_store.finished[queued["job_ids"][USDU_NODE]]
            out = master.get_job(queued["prompt_id"]).outputs[save][0]["images"]
            by_frame = dict(record["completions"])
            print(f"{label} run: {seconds:.2f} s, {frames / seconds:.4f} frames/s; frames by "
                  f"participant {[by_frame.get(f) for f in range(frames)]}; flash_attention "
                  f"launches {launches}, by instance {by_instance}; peak {peak / 2**30:.2f} GiB; "
                  f"bytes received {record['received_bytes']}; collector jobs left "
                  f"{len(master.job_store.collectors)}, tile jobs left "
                  f"{len(master.job_store.tile_jobs)}")
            _require(sorted(f for f, _ in record["completions"]) == list(range(frames))
                     and record["duplicates"] == 0,
                     f"frames settled {record['completions']}, duplicates {record['duplicates']}")
            _require("w1" in by_frame.values(), "w1 took no frame")
            _require(not master.job_store.collectors and not master.job_store.tile_jobs,
                     f"jobs outlive the prompt: collectors {sorted(master.job_store.collectors)}, "
                     f"tile jobs {sorted(master.job_store.tile_jobs)}")
            o = _usdu_options(workflow)
            want = (frames, round(frame_hw[0] * float(o["upscale_by"]) / 8) * 8,
                    round(frame_hw[1] * float(o["upscale_by"]) / 8) * 8, 3)
            _require(tuple(out.shape) == want, f"output shape {tuple(out.shape)}, expected {want}")
            _require(bool(torch.isfinite(out).all()), "non-finite output")
            worst = 0.0
            for f in range(frames):
                diff = float((out[f].float() - reference[f].to(out.device)).abs().max())
                bar = RERUN_TOLERANCE + (PNG_STEP if by_frame[f] == "w1" else 0.0)
                print(f"{label} frame {f} ({by_frame[f]}): max |diff| vs the frame run here "
                      f"{diff:.3g} (tolerance {bar:.4f})")
                _require(diff <= bar, f"frame {f} is not the frame run here")
                worst = max(worst, diff)
            if expected is not None:
                want_launches = (frames * expected[0],
                                 {k: frames * v for k, v in expected[1].items()})
                _require((launches, by_instance) == want_launches,
                         f"{launches} attention launches by instance {by_instance}, expected "
                         f"{want_launches}")
    return {"launches": launches, "launches_by_instance": by_instance, "seconds": seconds,
            "frames_per_s": frames / seconds, "peak_gib": peak / 2**30, "max_abs_diff": worst,
            "w1_frames": sum(1 for who in by_frame.values() if who == "w1")}


def _inpaint_model_workflow(ckpt: str = INPAINT_MODEL_CKPT, steps: int = 20):
    """An outpainting graph on an inpainting checkpoint, as users build it:
    LoadImage → ImagePadForOutpaint (INPAINT_MODEL_PAD) →
    InpaintModelConditioning → KSampler (euler, karras, cfg 7, its seed
    from DistributedSeed) → VAEDecode → DistributedCollector → SaveImage."""
    pad = dict(INPAINT_MODEL_PAD)
    return {
        "1": {"class_type": "CheckpointLoaderSimple", "inputs": {"ckpt_name": ckpt}},
        "2": {"class_type": "CLIPTextEncode",
              "inputs": {"text": INPAINT_MODEL_PROMPTS[0], "clip": ["1", 1]}},
        "3": {"class_type": "CLIPTextEncode",
              "inputs": {"text": INPAINT_MODEL_PROMPTS[1], "clip": ["1", 1]}},
        "4": {"class_type": "LoadImage", "inputs": {"image": "input.png"}},
        "5": {"class_type": "ImagePadForOutpaint", "inputs": {"image": ["4", 0], **pad}},
        "6": {"class_type": "InpaintModelConditioning", "inputs": {
            "positive": ["2", 0], "negative": ["3", 0], "vae": ["1", 2], "pixels": ["5", 0],
            "mask": ["5", 1]}},
        "7": {"class_type": "DistributedSeed", "inputs": {"seed": 42}},
        "8": {"class_type": "KSampler", "inputs": {
            "model": ["1", 0], "seed": ["7", 0], "steps": steps, "cfg": 7.0,
            "sampler_name": "euler", "scheduler": "karras", "positive": ["6", 0],
            "negative": ["6", 1], "latent_image": ["6", 2], "denoise": 1.0}},
        "9": {"class_type": "VAEDecode", "inputs": {"samples": ["8", 0], "vae": ["1", 2]}},
        "10": {"class_type": "DistributedCollector", "inputs": {"images": ["9", 0]}},
        "11": {"class_type": "SaveImage",
               "inputs": {"images": ["10", 0], "filename_prefix": "outpaint"}},
    }


def _nodes_workflow(torch, device: str, image_name: str, latent, small_latent):
    """One graph of every image, latent, mask and transform node of the
    port, from a LoadImage file, LoadImageMask of the same file and
    literal seeded latents on `device`; every chain ends in a
    PreviewImage, so every node runs."""
    px = {"width": 48, "height": 40}
    g = {
        "img": ("LoadImage", {"image": image_name}),
        "alpha": ("LoadImageMask", {"image": image_name, "channel": "alpha"}),
        "red": ("LoadImageMask", {"image": image_name, "channel": "red"}),
        "empty": ("EmptyImage", {**px, "batch_size": 1, "color": 0x3366CC}),
        "batch": ("ImageBatch", {"image1": ["img", 0], "image2": ["empty", 0]}),
        "crop": ("ImageCrop", {"image": ["batch", 0], "width": 40, "height": 30, "x": 5, "y": 7}),
        "pad": ("ImagePadForOutpaint", {"image": ["img", 0], "left": 8, "top": 0, "right": 16,
                                        "bottom": 8, "feathering": 12}),
        "scale": ("ImageScale", {"image": ["crop", 0], "upscale_method": "bicubic", **px,
                                 "crop": "center"}),
        "scaleby": ("ImageScaleBy", {"image": ["scale", 0], "upscale_method": "area",
                                     "scale_by": 0.75}),
        "invert": ("ImageInvert", {"image": ["scaleby", 0]}),
        "blur": ("ImageBlur", {"image": ["pad", 0], "blur_radius": 3, "sigma": 1.5}),
        "sharpen": ("ImageSharpen", {"image": ["blur", 0], "sharpen_radius": 2, "sigma": 1.0,
                                     "alpha": 0.8}),
        "flip": ("ImageFlip", {"image": ["sharpen", 0], "flip_method": "y-axis: horizontally"}),
        "rotate": ("ImageRotate", {"image": ["flip", 0], "rotation": "90 degrees"}),
        "blend": ("ImageBlend", {"image1": ["img", 0], "image2": ["rotate", 0],
                                 "blend_factor": 0.4, "blend_mode": "soft_light"}),
        # on the file's 8-bit levels: no level sits on a rounding edge, where
        # the two devices' last bits could part
        "quant": ("ImageQuantize", {"image": ["img", 0], "colors": 16, "dither": "none"}),
        "tomask": ("ImageToMask", {"image": ["quant", 0], "channel": "green"}),
        "solid": ("SolidMask", {"value": 0.7, **px}),
        "invmask": ("InvertMask", {"mask": ["alpha", 0]}),
        "cropmask": ("CropMask", {"mask": ["invmask", 0], "x": 4, "y": 4, "width": 20,
                                  "height": 16}),
        "maskcomp": ("MaskComposite", {"destination": ["tomask", 0], "source": ["cropmask", 0],
                                       "x": 3, "y": 2, "operation": "xor"}),
        "feather": ("FeatherMask", {"mask": ["maskcomp", 0], "left": 4, "top": 2, "right": 6,
                                    "bottom": 0}),
        "grow": ("GrowMask", {"mask": ["red", 0], "expand": 2, "tapered_corners": True}),
        "thresh": ("ThresholdMask", {"mask": ["grow", 0], "value": 0.5}),
        "masktoimg": ("MaskToImage", {"mask": ["feather", 0]}),
        "compimg": ("ImageCompositeMasked", {"destination": ["img", 0],
                                             "source": ["masktoimg", 0], "x": -6, "y": 10,
                                             "resize_source": False, "mask": ["solid", 0]}),
        "join": ("JoinImageWithAlpha", {"image": ["compimg", 0], "alpha": ["thresh", 0]}),
        "split": ("SplitImageWithAlpha", {"image": ["join", 0]}),
        "latent": ("LatentUpscale", {"samples": latent, "upscale_method": "bilinear",
                                     "width": 96, "height": 64, "crop": "disabled"}),
        "noisemask": ("SetLatentNoiseMask", {"samples": ["latent", 0], "mask": ["alpha", 0]}),
        "upby": ("LatentUpscaleBy", {"samples": ["noisemask", 0],
                                     "upscale_method": "nearest-exact", "scale_by": 1.5}),
        "repeat": ("RepeatLatentBatch", {"samples": ["upby", 0], "amount": 3}),
        "frombatch": ("LatentFromBatch", {"samples": ["repeat", 0], "batch_index": 1,
                                          "length": 2}),
        "lbatch": ("LatentBatch", {"samples1": ["frombatch", 0], "samples2": latent}),
        "lcomp": ("LatentComposite", {"samples_to": ["lbatch", 0], "samples_from": small_latent,
                                      "x": 16, "y": 8, "feather": 8}),
        "lcompm": ("LatentCompositeMasked", {"destination": ["lcomp", 0],
                                             "source": small_latent, "x": 24, "y": 0,
                                             "resize_source": False, "mask": ["cropmask", 0]}),
        "lflip": ("LatentFlip", {"samples": ["lcompm", 0], "flip_method": "x-axis: vertically"}),
        "lrot": ("LatentRotate", {"samples": ["lflip", 0], "rotation": "270 degrees"}),
        "lcrop": ("LatentCrop", {"samples": ["lrot", 0], "width": 64, "height": 48, "x": 8,
                                 "y": 0}),
        "lmul": ("LatentMultiply", {"samples": ["lcrop", 0], "multiplier": -0.5}),
        "ladd": ("LatentAdd", {"samples1": ["lmul", 0], "samples2": ["lcrop", 0]}),
        "lsub": ("LatentSubtract", {"samples1": ["ladd", 0], "samples2": ["lmul", 0]}),
        "lblend": ("LatentBlend", {"samples1": ["lsub", 0], "samples2": ["lcrop", 0],
                                   "blend_factor": 0.3}),
        "linterp": ("LatentInterpolate", {"samples1": ["lblend", 0], "samples2": ["lmul", 0],
                                          "ratio": 0.6}),
        "seedb": ("LatentBatchSeedBehavior", {"samples": ["linterp", 0],
                                              "seed_behavior": "fixed"}),
    }
    workflow = {name: {"class_type": cls, "inputs": inputs} for name, (cls, inputs) in g.items()}
    for i, sink in enumerate(("invert", "split", "blend")):
        workflow[f"preview{i}"] = {"class_type": "PreviewImage", "inputs": {"images": [sink, 0]}}
    return workflow


def _nodes_phase(torch, device: str) -> dict:
    """`_nodes_workflow` through a GraphExecutor on `device` and on the
    CPU from the same seeded inputs: every node's every output must
    have the same structure, shape, dtype and device type as the CPU
    run's on its device, f32 values within NODES_TOLERANCE."""
    import numpy as np

    from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
    from comfyui_distributed_tpu_torch.utils import image as img_utils

    label = "[nodes]"
    rng = np.random.default_rng(SEED + 2)
    rgba = img_utils.u8_to_f32(img_utils.f32_to_u8(rng.random((40, 48, 4), dtype=np.float32)))
    latent = rng.standard_normal((1, 5, 6, 4), dtype=np.float32)
    small = rng.standard_normal((1, 3, 3, 4), dtype=np.float32)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="cdt_nodes_") as tmp:
        with open(os.path.join(tmp, "rgba.png"), "wb") as fh:
            fh.write(img_utils.encode_png(rgba))
        for where in (device, "cpu"):
            workflow = _nodes_workflow(
                torch, where, "rgba.png", {"samples": torch.from_numpy(latent).to(where)},
                {"samples": torch.from_numpy(small).to(where)})
            executor = GraphExecutor(ExecutionContext(device=where,
                                                      config={"settings": {"input_dir": tmp}}))
            started = time.perf_counter()
            executor.execute(workflow)
            runs[where] = (workflow, executor.last_results, time.perf_counter() - started)
    workflow, results, seconds = runs[device]
    _, cpu_results, cpu_seconds = runs["cpu"]
    checked, worst = 0, 0.0

    def compare(got, ref, path):
        nonlocal checked, worst
        if isinstance(ref, dict):
            _require(set(got) == set(ref), f"{path}: keys {sorted(got)} vs {sorted(ref)}")
            for key in ref:
                compare(got[key], ref[key], f"{path}[{key!r}]")
        elif isinstance(ref, (list, tuple)):
            _require(len(got) == len(ref), f"{path}: {len(got)} outputs vs {len(ref)}")
            for i, (g, r) in enumerate(zip(got, ref)):
                compare(g, r, f"{path}[{i}]")
        elif isinstance(ref, torch.Tensor):
            _require(isinstance(got, torch.Tensor) and tuple(got.shape) == tuple(ref.shape)
                     and got.dtype == ref.dtype
                     and got.device.type == torch.device(device).type,
                     f"{path}: {type(got).__name__} {getattr(got, 'shape', None)} "
                     f"{getattr(got, 'dtype', None)} on {getattr(got, 'device', None)} vs "
                     f"{tuple(ref.shape)} {ref.dtype} (on {device})")
            if ref.is_floating_point() and ref.numel():
                diff = float((got.cpu().float() - ref.float()).abs().max())
                worst = max(worst, diff)
                _require(diff <= NODES_TOLERANCE, f"{path}: max |diff| {diff:.3g} vs the CPU")
            checked += 1
        else:
            _require(got == ref, f"{path}: {got!r} vs {ref!r}")

    for node_id, node in workflow.items():
        compare(results[node_id], cpu_results[node_id], f"{node['class_type']} ({node_id})")
    classes = sorted({node["class_type"] for node in workflow.values()})
    print(f"{label} {len(workflow)} nodes of {len(classes)} classes on {device} in "
          f"{seconds:.2f} s (the CPU: {cpu_seconds:.2f} s): {checked} tensors of the same "
          f"shape, dtype and device type as the CPU run's, max |diff| {worst:.3g} (tolerance "
          f"{NODES_TOLERANCE}); classes {classes}")
    return {"nodes": len(workflow), "classes": classes, "tensors": checked,
            "max_abs_diff": worst}


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
    from comfyui_distributed_tpu_torch.ops.samplers import get_sigmas, model_evals_per_scan
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
    pairs = get_sigmas(usdu["scheduler"], int(usdu["steps"]), float(usdu["denoise"])).shape[0] - 1
    shapes = _attention_shapes(sdxl, vae_cfg, te_len, tile_px // vae_cfg.downscale,
                               model_evals_per_scan(usdu["sampler_name"], pairs))
    # the samplers phase's elastic run: the same workflow on HTTP_SAMPLER
    http_sampler_shapes = _attention_shapes(sdxl, vae_cfg, te_len, tile_px // vae_cfg.downscale,
                                            model_evals_per_scan(HTTP_SAMPLER, pairs))
    per_tile = sum(count for *_, count in shapes)
    n_tiles = plan_grid(IMAGE_PX, IMAGE_PX, float(usdu["upscale_by"]), int(usdu["tile_width"]),
                        int(usdu["tile_padding"]), int(usdu["tile_height"]))[2].num_tiles
    with open(os.path.join(REPO, "workflows", "distributed-txt2img.json"), encoding="utf-8") as fh:
        t2i_workflow = json.load(fh)
    t2i_shapes = _txt2img_shapes(t2i_workflow)
    sd_workflows = {}
    for tag, name in SD_WORKFLOWS.items():
        with open(os.path.join(REPO, "workflows", name), encoding="utf-8") as fh:
            sd_workflows[tag] = json.load(fh)
    # every main-path unit's shapes: the SDXL upscale's tile, each seed-
    # parallel workflow's image
    ckpt_workflows = {}
    for path, name in CKPT_WORKFLOWS.items():
        with open(os.path.join(REPO, "workflows", name), encoding="utf-8") as fh:
            ckpt_workflows[path] = json.load(fh)
    t2i_sampler = _node_id(t2i_workflow, "KSampler")
    samplers_entry_workflow = copy.deepcopy(t2i_workflow)
    samplers_entry_workflow[t2i_sampler]["inputs"]["sampler_name"] = SAMPLERS_ENTRY_SAMPLER
    # a usdu_full tile, a SAG image and an area image of the
    # guidance phase (its FreeU and RescaleCFG images have txt2img's shapes)
    guidance_shapes = {name: _guidance_shapes(name, t2i_workflow)
                       for name in _guidance_variants(t2i_workflow)}
    # the custom phase's images by guider (PerpNeg and DualCFG at batch 3),
    # a dynamic-mode frame of the video workflow, an outpainted
    # sd15-inpaint image
    with open(os.path.join(REPO, "workflows", CUSTOM_WORKFLOW), encoding="utf-8") as fh:
        flux_custom = json.load(fh)
    custom_shapes = {guider: _custom_shapes(_custom_workflow(flux_custom, guider))
                     for guider in CUSTOM_GUIDERS}
    custom_shapes["two_stage"] = _custom_shapes(_custom_two_stage(
        _custom_workflow(flux_custom, "CFGGuider")))
    with open(os.path.join(REPO, "workflows", DYNAMIC_WORKFLOW), encoding="utf-8") as fh:
        video_workflow = json.load(fh)
    inpaint_model_workflow = _inpaint_model_workflow()
    path_shapes = {"upscale": shapes, "txt2img": t2i_shapes,
                   **{tag: _txt2img_shapes(wf) for tag, wf in sd_workflows.items()},
                   **{path: _txt2img_shapes(wf) for path, wf in ckpt_workflows.items()},
                   "samplers": _txt2img_shapes(samplers_entry_workflow),
                   "usdu_full": _usdu_full_shapes(workflow),
                   "guidance": guidance_shapes["SelfAttentionGuidance"],
                   "guidance_area": guidance_shapes["area"],
                   "custom": custom_shapes["PerpNegGuider"],
                   "custom_dualcfg": custom_shapes["DualCFGGuider"],
                   "dynamic": _dynamic_shapes(_dynamic_workflow(video_workflow)),
                   "inpaint_model": _txt2img_shapes(inpaint_model_workflow)}

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
    # per main-path unit: the SDXL upscale's tile, a workflow's image
    totals = {path: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                     "operations": 0.0, "bytes": 0.0, "exponentials": 0.0}
              for path in path_shapes}
    # the largest error of the checks of each kernels entry: the txt2img
    # head dims on the tensor cores, everything else under upscale, and
    # each later workflow's own shapes
    max_err = dict.fromkeys(path_shapes, 0.0)
    # each main-path shape once, with its launches per unit on every path
    # that runs it: (label, q shape, M) → {path: launches per unit}
    main_shapes = {}
    for path, path_list in path_shapes.items():
        for label, q, m, count in path_list:
            key = (f"{label}" if path == "upscale" else f"{path} {label}", q, m)
            key = next((k for k in main_shapes if k[1:] == (q, m)), key)
            main_shapes.setdefault(key, {})[path] = count
    # (label, q shape, M, dtype, {path: launches per unit} or None, layout)
    checks = [(label, q, m, "bfloat16", units, "contiguous")
              for (label, q, m), units in main_shapes.items() if "upscale" in units]
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
    # the seed-parallel workflows' shapes (SD1.5 at batch 2 and, under
    # PAG, batch 1; SD2.1 at 768 px), then at each txt2img head dim f32,
    # an unaligned, a strided and a 16-not-128-byte aligned view and the
    # edges of the wgmma instance's 64-row blocks and key tiles
    checks += [(label, q, m, "bfloat16", units, "contiguous")
               for (label, q, m), units in main_shapes.items() if "upscale" not in units]
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
    for label, q_shape, m, dtype, units, layout in checks:
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
        for path in {entry} | {p for p in (units or {}) if p not in ("upscale", "txt2img")}:
            max_err[path] = max(max_err[path], err)
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
        print(f"[kernel] {label} {dtype} q={tuple(q.shape)} M={k.shape[1]} "
              f"launches/unit={units or {}} "
              f"max_abs_err={err:.3g} tol=|d|<={atol:g}+{rtol:g}|ref| {'ok' if ok else 'FAIL'} "
              f"kernel_ms={kernel_ms:.5f} plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
              f"bound_ms={bound_ms:.5f} ({_bound_by(terms)}; operations "
              f"{terms['operations']:.5f}, bytes {terms['bytes']:.5f}, exponentials "
              f"{terms['exponentials']:.5f}) "
              f"instance={plan.instance} keys/tile={plan.keys_per_tile} "
              f"masked={plan.masked_share(m):.4f} rows/cta={plan.rows_per_cta} "
              f"splits={plan.splits} ctas={ctas} ctas/sm={per_sm} "
              f"waves={ctas / (per_sm * sms):.3f}")
        if units and plan.instance == "wgmma":
            plans = attn.wgmma_plans(d)
            tile_lines.append(_time_plans(torch, attn, label, q, k, v, plans, plan))
            # the largest call of the upscale or txt2img path: the [host]
            # line keeps its shape
            if {"upscale", "txt2img"} & set(units) and (host_inputs is None
                                                        or q.numel() > host_inputs[0].numel()):
                host_inputs = (q, k, v)
        if units and "upscale" in units and plan.instance == "wgmma512":
            plans = [attn.Plan("wgmma512", attn.WGMMA512_KEYS, attn.WGMMA_ROWS, splits)
                     for splits in SPLITS_TIMED if splits <= plan.key_tiles(m)]
            tile_lines.append(_time_plans(torch, attn, label, q, k, v, plans, plan))
        _require(ok, f"kernel disagrees with its plain version at {label} ({err:.3g})")
        for path, count in (units or {}).items():
            if path == "txt2img" and plan.instance != "wgmma":
                continue  # txt2img's entry: the D=40/80/160 shapes only
            for key, val in (("ms", kernel_ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                             ("bound_ms", bound_ms), *terms.items()):
                totals[path][key] += count * val

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

    # --- 4d. the other seed-parallel SD workflows ----------------------------------
    # two-pass, PAG and inpaint on the same SD1.5 weights; then SD2.1-768-v
    # on its own, seeded like the others, SD1.5 freed first
    sd_results = {}
    bundle = t2i_bundle
    del t2i_bundle
    for tag, wf in sd_workflows.items():
        phase_started = time.perf_counter()
        ckpt = wf[_node_id(wf, "CheckpointLoaderSimple")]["inputs"]["ckpt_name"]
        if ckpt != bundle.model_name:
            del bundle
            torch.cuda.empty_cache()
            started = time.perf_counter()
            bundle = pl.load_pipeline(ckpt, seed=0, device="cuda")
            _seed_out_conv(torch, bundle, gen)
            torch.cuda.synchronize()
            n_params = sum(p.numel() for m in (bundle.unet, bundle.vae, bundle.text_encoder)
                           for p in m.parameters())
            print(f"[{tag}] {ckpt}: {n_params / 1e9:.3f}B parameters, seeded random init on "
                  f"the card in {time.perf_counter() - started:.1f} s (compute dtype "
                  f"{get_config(ckpt).dtype}, text encoder {bundle.te_name})")
        per_image = sum(count for *_, count in path_shapes[tag])
        expected = {name: 2 * count for name, count in
                    _expected_by_instance(attn, path_shapes[tag], torch).items()}
        sd_results[tag] = _txt2img_phase(torch, bundle, wf, "cuda", 2 * per_image, expected,
                                         runs=SD_WORKFLOW_RUNS, tag=tag)
        phase_seconds[tag] = time.perf_counter() - phase_started
    del bundle
    torch.cuda.empty_cache()

    # --- 4e. ckpt: real single-file checkpoints over HTTP ------------------------
    phase_started = time.perf_counter()

    def per_run(path_name):
        """(launches, by instance) of one run of a path: two images."""
        return (2 * sum(count for *_, count in path_shapes[path_name]),
                {name: 2 * count for name, count in
                 _expected_by_instance(attn, path_shapes[path_name], torch).items()})

    ckpt_results = _ckpt_phase(torch, gen, ckpt_workflows, "cuda",
                               {path: per_run(path) for path in ckpt_workflows})
    torch.cuda.empty_cache()
    phase_seconds["ckpt"] = time.perf_counter() - phase_started

    # --- 4f. samplers: every sampler and scheduler on SD1.5; HTTP_SAMPLER over
    # the collector and over the elastic upscale ----------------------------------
    phase_started = time.perf_counter()
    bundle = pl.load_pipeline(t2i_ckpt, seed=0, device="cuda")
    _seed_out_conv(torch, bundle, gen)
    sampler_runs = [_samplers_phase(torch, bundle, t2i_workflow, "cuda", check_launches=True)]
    http_workflow = copy.deepcopy(t2i_workflow)
    http_workflow[t2i_sampler]["inputs"]["sampler_name"] = HTTP_SAMPLER
    http_shapes = _txt2img_shapes(http_workflow)
    sampler_runs.append(_txt2img_phase(
        torch, bundle, http_workflow, "cuda", 2 * sum(count for *_, count in http_shapes),
        {name: 2 * count for name, count in _expected_by_instance(attn, http_shapes, torch).items()},
        runs=1, tag="samplers"))
    del bundle
    torch.cuda.empty_cache()
    upscale_ckpt = workflow["1"]["inputs"]["ckpt_name"]
    bundle = pl.load_pipeline(upscale_ckpt, seed=0, device="cuda")
    _seed_out_conv(torch, bundle, gen)
    http_upscale = copy.deepcopy(workflow)
    http_upscale[USDU_NODE]["inputs"]["sampler_name"] = HTTP_SAMPLER
    sampler_runs.append(_elastic_phase(
        torch, bundle, upscale_ckpt, http_upscale, torch.from_numpy(seeded).to("cuda"), None,
        "cuda", expected_launches=n_tiles * sum(count for *_, count in http_sampler_shapes),
        expected_by_instance={name: n_tiles * count for name, count in _expected_by_instance(
            attn, http_sampler_shapes, torch).items()}, runs=1, tag="samplers"))
    samplers_launches = sum(r["launches"] for r in sampler_runs)
    samplers_by_instance = {name: sum(r["launches_by_instance"].get(name, 0) for r in sampler_runs)
                            for name in attn.INSTANCES}
    print(f"[samplers] seconds by run: {_rounded(sampler_runs[0]['seconds'])}; flash_attention "
          f"launches over the phase {samplers_launches}, by instance {samplers_by_instance}")
    phase_seconds["samplers"] = time.perf_counter() - phase_started

    # --- 4g. usdu_full: the upscale workflow with an upscale model, ControlNet
    # tile, CLIPTextEncodeSDXL and tiled decode, on the samplers phase's SDXL ---
    phase_started = time.perf_counter()
    full_shapes = path_shapes["usdu_full"]
    usdu_full = _usdu_full_phase(
        torch, bundle, workflow, torch.from_numpy(seeded).to("cuda"), gen, "cuda",
        expected_launches=n_tiles * sum(count for *_, count in full_shapes),
        expected_by_instance={name: n_tiles * count for name, count in _expected_by_instance(
            attn, full_shapes, torch).items()},
        tiled_tolerance=TILED_DECODE_TOLERANCE)
    del bundle
    torch.cuda.empty_cache()
    phase_seconds["usdu_full"] = time.perf_counter() - phase_started

    # --- 4h. guidance: FreeU, FreeU_V2, SAG, RescaleCFG and an area entry on SD1.5 ---
    phase_started = time.perf_counter()
    bundle = pl.load_pipeline(t2i_ckpt, seed=0, device="cuda")
    _seed_out_conv(torch, bundle, gen)
    guidance = _guidance_phase(torch, bundle, t2i_workflow, "cuda", expected={
        name: (sum(count for *_, count in shapes_),
               _expected_by_instance(attn, shapes_, torch))
        for name, shapes_ in guidance_shapes.items()})
    # the custom phase runs on this SD1.5 bundle
    phase_seconds["guidance"] = time.perf_counter() - phase_started

    def per_unit(shapes_):
        """(launches, by instance) of one image or frame of `shapes_`."""
        return (sum(count for *_, count in shapes_), _expected_by_instance(attn, shapes_, torch))

    # --- 4i. custom: the custom-sampling workflow on SD1.5 under CFGGuider,
    # PerpNegGuider and DualCFGGuider over HTTP, and split in two stages ---
    phase_started = time.perf_counter()
    custom = _custom_phase(torch, bundle, flux_custom, "cuda",
                           expected={name: per_unit(shapes_)
                                     for name, shapes_ in custom_shapes.items()})
    del bundle
    torch.cuda.empty_cache()
    phase_seconds["custom"] = time.perf_counter() - phase_started

    # --- 4j. nodes: every image, latent, mask and transform node on the card
    # against the same graph on the CPU --------------------------------------
    phase_started = time.perf_counter()
    nodes = _nodes_phase(torch, "cuda")
    phase_seconds["nodes"] = time.perf_counter() - phase_started

    # --- 4k. inpaint_model: outpainting on sd15-inpaint (9-channel UNet) ---
    phase_started = time.perf_counter()
    bundle = pl.load_pipeline(INPAINT_MODEL_CKPT, seed=0, device="cuda")
    _seed_out_conv(torch, bundle, gen)
    print(f"[inpaint_model] {INPAINT_MODEL_CKPT}: UNet input conv "
          f"{tuple(bundle.unet.input_conv.weight.shape)}")
    launches_, by_instance_ = per_unit(path_shapes["inpaint_model"])
    inpaint_model = _txt2img_phase(torch, bundle, inpaint_model_workflow, "cuda", 2 * launches_,
                                   {k: 2 * v for k, v in by_instance_.items()}, runs=1,
                                   tag="inpaint_model")
    del bundle
    torch.cuda.empty_cache()
    phase_seconds["inpaint_model"] = time.perf_counter() - phase_started

    # --- 4l. dynamic: the video workflow's frames, whole, over HTTP on SDXL ---
    phase_started = time.perf_counter()
    dynamic_ckpt = video_workflow[_node_id(video_workflow, "CheckpointLoaderSimple")]["inputs"][
        "ckpt_name"]
    bundle = pl.load_pipeline(dynamic_ckpt, seed=0, device="cuda")
    _seed_out_conv(torch, bundle, gen)
    dynamic = _dynamic_phase(torch, bundle, video_workflow, "cuda",
                             expected=per_unit(path_shapes["dynamic"]))
    del bundle
    torch.cuda.empty_cache()
    phase_seconds["dynamic"] = time.perf_counter() - phase_started
    print("[phases] seconds: " + ", ".join(f"{name} {sec:.1f}" for name, sec in
                                           phase_seconds.items())
          + f"; total {sum(phase_seconds.values()):.1f}")

    # --- 5. kernels ----------------------------------------------------------
    print("[kernels] flash_attention: ms, plain_ms, library_ms and bound_ms are per SDXL tile "
          "(each upscale shape's time times its launches per tile, summed); launches: the last "
          "elastic run, master and w1 together (launches_main: phase 4's last run). "
          "flash_attention_txt2img: the same per 512-px SD1.5 image over the D=40/80/160 shapes "
          "the wgmma instance takes; launches: its launches in the last txt2img run, master "
          "and w1 together; bound_by: the largest of the summed operations, bytes and "
          "exponentials terms. flash_attention_<workflow>: the same per image over every "
          "attention shape of that workflow (VAE included); launches: its run over HTTP, "
          "master and w1 together. flash_attention_ckpt_<model>: the same for the workflow "
          "of that checkpoint file; launches: its run over HTTP. flash_attention_samplers: the "
          f"same per SD1.5 image on {SAMPLERS_ENTRY_SAMPLER}; launches: that sampler's local "
          "run in the samplers phase. flash_attention_usdu_full: the same per usdu_full tile "
          "(batch-1 UNet passes, the tiled decode's pieces); launches: its local run of 4 tiles. "
          "flash_attention_guidance: the same per SD1.5 image under SelfAttentionGuidance; "
          "launches: its local image. flash_attention_custom: the same per SD1.5 image of the "
          "custom-sampling workflow under PerpNegGuider (batch-3 UNet evaluations); launches: "
          "its run over HTTP, master and w1 together; flash_attention_custom_dualcfg: the same "
          "under DualCFGGuider. flash_attention_dynamic: the same per frame of the video "
          "workflow in dynamic mode (two 448-px SDXL tiles); launches: its run over HTTP of "
          f"{DYNAMIC_FRAMES} frames. flash_attention_inpaint_model: the same per outpainted "
          "576-px sd15-inpaint image; launches: its run over HTTP")
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
    ] + [
        {
            "name": f"flash_attention_{tag}",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sd_results[tag]["launches"],
            "launches_by_instance": sd_results[tag]["launches_by_instance"],
            "max_abs_err": max_err[tag],
            **numbers(tag),
            "check": f"ok: {len(checks)} shapes within tolerance of the plain version",
        }
        for tag in sd_workflows
    ] + [
        {
            "name": f"flash_attention_{path}",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": ckpt_results[path]["launches"],
            "launches_by_instance": ckpt_results[path]["launches_by_instance"],
            "max_abs_err": max_err[path],
            **numbers(path),
            "check": f"ok: {len(checks)} shapes within tolerance of the plain version",
        }
        for path in ckpt_workflows
    ] + [
        {
            "name": "flash_attention_samplers",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sampler_runs[0]["entry_launches"],
            "launches_by_instance": sampler_runs[0]["entry_by_instance"],
            "max_abs_err": max_err["samplers"],
            **numbers("samplers"),
            "check": f"ok: {len(checks)} shapes within tolerance of the plain version",
        },
        {
            "name": "flash_attention_usdu_full",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": usdu_full["launches"],
            "launches_by_instance": usdu_full["launches_by_instance"],
            "max_abs_err": max_err["usdu_full"],
            **numbers("usdu_full"),
            "check": f"ok: {len(checks)} shapes within tolerance of the plain version",
        },
        {
            "name": "flash_attention_guidance",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": guidance["SelfAttentionGuidance"]["launches"],
            "launches_by_instance": guidance["SelfAttentionGuidance"]["launches_by_instance"],
            "max_abs_err": max_err["guidance"],
            **numbers("guidance"),
            "check": f"ok: {len(checks)} shapes within tolerance of the plain version",
        },
    ] + [
        {
            "name": f"flash_attention_{path}",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": run["launches"],
            "launches_by_instance": run["launches_by_instance"],
            "max_abs_err": max_err[path],
            **numbers(path),
            "check": f"ok: {len(checks)} shapes within tolerance of the plain version",
        }
        for path, run in (("custom", custom["PerpNegGuider"]),
                          ("custom_dualcfg", custom["DualCFGGuider"]),
                          ("dynamic", dynamic), ("inpaint_model", inpaint_model))
    ]}
    print(f"[summary] custom two stages max |diff| {custom['two_stage']['max_abs_diff']:.3g}; "
          f"nodes {nodes['nodes']} ({len(nodes['classes'])} classes) max |diff| "
          f"{nodes['max_abs_diff']:.3g}; dynamic: w1 took {dynamic['w1_frames']} of "
          f"{DYNAMIC_FRAMES} frames, {dynamic['frames_per_s']:.4f} frames/s")
    print(json.dumps(kernels))
    print(_nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
