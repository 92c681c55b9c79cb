#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # from the root of a checkout: every phase
    python3 chip_smoke.py --phases wan    # some phases (PHASES; comma-separated)

Phases, each printing lines tagged with its name (and, on a [phases]
line, when it starts). `--phases` runs only the named ones, with the
kernel checks of their shapes (`kernel` runs all the checks, the
threshold and host lines); a phase that reads an earlier one's bundle
builds its own, and `elastic` runs `main`. The main path (main, elastic,
txt2img) and the other phases run the published depths; Flux, SD3.5 and
the UNets of CUT_PHASES and the 14B WAN DiTs run at the depths of the
[cuts] line (FLUX_DEPTH_CUT, SD3_DEPTH_CUT, SDXL_DEPTH_CUT,
UNET_RES_BLOCKS_CUT, WAN_DEPTH_CUT; full width), so that every phase fits
the run's time limit.

1. device  - the card's name and power limit (nvidia-smi); TF32 is
             turned off for matmuls and convolutions, so f32 checks are
             f32.
2. build   - nvcc builds comfyui_distributed_tpu_torch/csrc/
             flash_attention.cu from this checkout.
3. kernel  - the kernel against its plain PyTorch version at every
             attention shape of the upscale path and of each seed-parallel
             workflow (bf16; each shape once, with its launches per tile or
             image on every path that runs it);
             SD3's D=64 also at a ragged joint length (1008 px: 63^2 +
             154 tokens);
             WAN's D=128 and CLIP vision's D=80 at their main shapes (self
             at 8100 and 28350 tokens past the one-bf16-P threshold, also
             against its emulation; text and image cross at 77 and 257
             keys; all ragged on their row blocks and key tiles), the plain
             version at them timed with fewer samples (PLAIN_REPS_LARGE,
             at the other paths' shapes PLAIN_REPS);
             Flux's D=128 also at a ragged joint length (1008 px), a
             short key count and both sides of the router's one-bf16-P
             threshold (WGMMA_PINGPONG_ABOVE[128]) at 24 heads;
             at D=40, 80, 128 and 160 also f32, an unaligned, a strided and a
             16-not-128-byte aligned view and the edges of the wgmma
             instance's 64-row blocks and key tiles (N in EDGE_ROWS_WG, M
             in EDGE_KEYS_WG, one head of one batch, fewer timing
             samples; at D=40 also those of the two-consumer blocks,
             EDGE_ROWS_PINGPONG and EDGE_KEYS_PINGPONG; at D=128 those of
             the two-consumer one-bf16-P plan's 128-row blocks,
             EDGE_ROWS_BF16_P, at key counts around its key tiles and the
             threshold, `_bf16_p_edge_keys`); for D=64 and
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
             query rows a block) timed at each D=40/64/80/128/160 shape of
             the paths and at SD3's ragged joint@4123 and Flux's ragged
             joint@4481, and every key
             split of the D=512 instance at vae@5184, beside the router's
             choice.
   threshold - both D=128 plans held to the plain version at 4608 query
             rows and 24 heads over THRESHOLD_KEYS and both sides of the
             router's threshold (where one bf16 P misses and where it
             holds), and the one-bf16-P plan against its emulation
             (`bf16_p_attention_reference`) at joint@4608.
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
             itself takes a weighted average at the seams). Each run's
             telemetry is held to the run on [telemetry] lines
             (`_Telemetry`): the master's /distributed/metrics answers
             the Prometheus content type and every sample parses;
             cdt_tiles_processed_total rises by the run's tiles, split
             by role as the store's completions; pulls that handed out a
             task are completions plus requeues; cdt_tile_stage_seconds
             has one sample a tile of each role for sample, dispatch and
             readback, one a w1 tile for encode and one a flush for
             submit; the execution's /distributed/trace/{trace_id} is one
             tree holding the orchestration, the dispatch to w1, the
             master's rpc spans of w1's pulls and submits and the tile
             spans of every tile, all under the admission wait
             (sched.wait); the transfer ledger's device-execute
             seconds are positive, its D2H bytes every tile's output
             bytes and each role's host-tax ratio in (0, 1] (printed:
             the host share of the bracketed tile time, not the card's
             idle share); the usage meter's conservation identity holds
             exactly in integer ns, and its dispatch nanoseconds and the
             job's chip seconds equal the transfer ledger's dispatch
             nanoseconds this run (two sinks fed by separate calls, so a
             dropped or doubled dispatch shows); cdt_device_memory_bytes
             equals torch.cuda.memory_allocated and max_memory_allocated
             read right after the scrape. Each run's control plane on
             a [sched] line (`_Sched`): the queue answer's scheduler
             block and its queue-wait seconds, one admission and one
             grant with no slot held afterwards, each participant's
             grant sizes (the master's placement policy sizes them, two
             tiles while more than CDT_SCHED_TAIL_TILES remain) adding
             up to its tiles, and no watchdog verdict (straggler, stall,
             speculative requeue) and w1's breaker closed on the
             healthy fleet. Each run's push grants on a [push] line
             (`_Push`): the master's cdt_push_grants_total rises by the
             tiles the job made pending plus every requeued tile; w1's
             GrantSignal (`grant_signal` in its /distributed/system_info)
             connected to /distributed/events for the job, parked after
             its empty pull and was woken by a pushed frame (a stream that
             is down fails the run: the pull loop would hide it); its
             frames and parks, and what ended the last, are printed; the
             master's event bus has its subscribers of before the run.
             Before the last run the scheduler is drained
             (`_drain_check`): the queue answers 503 with Retry-After,
             makes no job and launches nothing; then it resumes.
             The incident plane (`_Incident`): the master runs with
             CDT_INCIDENT_DIR and CDT_PROFILE_DIR in the phase's
             temporary directory; each run prints the flight recorder's
             appended and dropped events and span closes ([flight]). The
             second run is profiled: a torch.profiler capture posted to
             /distributed/profile/start once the run's first attention
             kernel launched, stopped after PROFILE_WINDOW_S while the run
             goes on; its Chrome trace must parse and hold CUDA kernel
             events among which the attention kernel's wgmma instance,
             cdt_profile_captures_total must count it and GET
             /distributed/profile list it ([profile]; the run's rate is
             printed as profiled, compared with nothing). Then a manual
             incident bundle naming the run's trace id must validate, hold
             a span close of every span of the run's trace in its flight
             section and that trace in its trace section, the resolved
             knobs, and store, placement, scheduler, health, fleet, usage
             and SLO sections without an error; cdt_incidents_total
             {trigger="manual"} +1; listed and fetched by id; the scraped
             cdt_flight_dropped_total equal to the recorder's drops; w1
             with the recorder and no incident manager ([incident]). The
             taps' host cost: TAP_PUBLISHES publishes ([flight]). The
             host µs a launch, before and after the capture ([profile]).
   adapters - on SDXL at the cut depth, served as the elastic phase
             serves it (a master and w1 in this process; its base output
             the local tiles' weighted average) (`_adapters_phase`): a
             seeded kohya LoRA (ADAPTER_RANK,
             ADAPTER_ALPHA) over every 2-D backbone target and both text
             towers, written in f16 by the port's writer into a temporary
             CDT_LORA_DIR; the workflow locally with a LoraLoader inserted
             (ADAPTER_STRENGTH on both sides: finite, at least
             ADAPTER_MIN_DIFF from the base output, the cut path's launches,
             the cached bundle's 2-D weights torch.equal to before) and
             with LoraLoaderModelOnly (its output L); the unmodified
             workflow over HTTP with `adapters` (every tile once, w1 at
             least one, within RERUN_TOLERANCE of L's tiles composited the
             elastic way); an unknown adapter answered 400 with no job;
             then a tile cache installed: cold, warm (every tile settled, 0
             launches, the cold run's tensor and PNG bytes), strength 0.7
             and the base model (no hit); a FreeU graph with the cache on
             (a new view of the bundle: its weights fingerprint finds the
             digests the cold run remembered); the weights fingerprint of
             LoraLoaderModelOnly's output for the full LoRA and for an
             attention-only one (ADAPTER_PARTIAL_NAME, the full LoRA's
             attn1/attn2 modules), whose merge copies only the weights it
             covers; then, the cache off, two jobs over HTTP wearing the
             attention-only adapter (at least ADAPTER_MIN_DIFF from the
             base model's output, the second within RERUN_TOLERANCE of
             the first, its operands from the operand cache). Prints the
             merge, operand, patch and weights-fingerprint seconds,
             operand bytes, the operand cache's hits and misses, cold and
             warm tiles/s, peak memory.
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
             record. Then the collector's audio on the same servers, on
             an [audio] line (`_audio_check`, `_audio_workflow`, no
             model): each participant's LoadAudio reads its own seeded
             16-bit WAV (AUDIO_CHANNELS at AUDIO_RATE, AUDIO_SECONDS)
             into DistributedCollector's `audio` beside an EmptyImage; the
             master's combined waveform must equal its own followed by
             w1's exactly, at the sample rate, on the card;
             AudioBatchDivider's AUDIO_PARTS parts concatenate back to it
             and SaveAudio's files hold what each node saved; w1's
             payload bytes and the seconds are printed.
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
             and sd21's. Then SD1.5's state dict as one GGUF file (Q8_0
             where a tensor's size is a multiple of 32, F16 else), loaded
             by CheckpointLoaderSimple in a local run: every parameter
             torch.equal to the plain dequantization in the module's dtype,
             the image within RERUN_TOLERANCE of the direct run's; its load
             GB/s (`_gguf_check`). The files are deleted.
   procs   - the deployment users run: the master a DistributedServer in
             this process, w1 its own process launched through POST
             /distributed/launch_worker (type local, cuda_device 0, its own
             --config and an empty input directory), both loading SD1.5 and
             SDXL files written as the ckpt phase writes them (f16, seeded at
             CKPT_SEED) from CDT_CHECKPOINT_DIR; w1's CLI turns TF32 off as
             phase 1 does here. Checks,
             each on a [procs] line: the launch (w1 answers its probe, is
             listed by /distributed/managed with its own PID and reports the
             card; launch-to-ready seconds); the unmodified txt2img workflow
             fanned out over the websocket (w1's ws_prompts counter must rise:
             the HTTP fallback fails the phase), the batch [2, 512, 512, 3],
             image 0 and 1 against local runs at seeds 42 and 43 on the
             master's loaded weights, the master's launches one image's; the
             same at seed 44 warm (images/s beside the txt2img phase's); load
             balance (mode load_balance on w1, no master prompt and no master
             launch, w1's image as it reached the master's store against
             seed 43); a delegate-only master (no sampler in its prompt, no
             launch, w1's one image); media sync (the unmodified inpaint
             workflow: w1's empty input directory ends holding every file the
             prompt names with the master's md5, and a second run uploads
             nothing); the unmodified upscale workflow twice on SDXL (every
             tile once, w1 at least one, each output within RERUN_TOLERANCE
             of the local tiles composited the elastic way; tiles/s beside
             the elastic phase's and phase 4's; each run's [telemetry]
             lines as the elastic phase's, with w1's own
             /distributed/metrics and /distributed/trace/{trace_id}
             holding its role's series and tile spans, and the usage
             check on the master's role, whose meter is in this
             process; the [sched] and [push] lines as the elastic
             phase's, the stream over a real socket; and on a
             [fleet] line (`_fleet_check`) the master's fleet plane: w1
             (launched with CDT_FLEET_SNAPSHOT_SECONDS =
             PROCS_FLEET_SNAPSHOT_S, a snapshot on every pull and
             heartbeat) listed by /distributed/fleet with devices 1 and
             its card's nonzero memory peak, /distributed/usage
             attributing the job's chip seconds with w1's part equal to
             w1's meter and w1's transfer ledger over the run, and no
             alert firing on /distributed/alerts); one more upscale run
             in which the master's breaker quarantines w1 as soon as it
             holds a grant (`_quarantine_run`, a [quarantine] line and
             its [push] line): w1's tiles back on the queue when the
             quarantine returns, counted under
             cdt_store_requeued_tasks_total{reason="quarantine"} and
             announced by a grant_available, every tile completed once
             with w1's copies dropped as duplicates, the output within
             RERUN_TOLERANCE of the local tiles; w1 pardoned after; a
             running elastic job
             cancelled through /distributed/cancel/{job_id} (every pending
             and in-flight tile refunded, the master's prompt ends
             JobCancelled, an unknown job answers 404); clear_memory on w1
             (its pipelines empty, the next run loads the file again and
             matches); stop_worker (w1's port dead, its processes gone,
             managed_processes empty). w1 is stopped on the way out whatever
             happened.
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
             Then the merges (`_merges_check`) on two SD1.5 bundles seeded
             at 0 and MERGE_SEED: ModelMergeSimple and CLIPMergeSimple at
             ratio 1.0 give model1's weights exactly; at MERGE_RATIO, in the
             txt2img workflow, the image is at least MERGE_MIN_DIFF from
             each parent's.
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
   flux    - the four bundled Flux workflows (FLUX_WORKFLOWS), unmodified,
             at full width: Flux-schnell and Flux-dev (12B, 19 double and
             38 single blocks, D=128), T5-XXL at 512 tokens, CLIP-L, the
             16-channel Flux VAE, 1024 px; seeded random weights drawn on
             the card (`_flux_phase`). flux-schnell's bundle serves
             txt2img-flux and is freed before flux-dev's is built, which
             serves flux-custom-sampling (UNETLoader, DualCLIPLoader,
             VAELoader, ModelSamplingFlux, FluxGuidance), flux-dual-prompt
             (CLIPTextEncodeFlux, BetaSamplingScheduler) and kontext-edit
             (LoadImage of a seeded 1024-px reference.png, VAEEncode,
             ReferenceLatent: 8704 joint tokens). Each as txt2img, one run
             over HTTP, every loader resolving to the one bundle: the batch
             [2, 1024, 1024, 3] in [0, 1], image 0 within RERUN_TOLERANCE
             of the local run at its seed and w1's within RERUN_TOLERANCE +
             PNG_STEP, the two apart, no collector job left, peak memory a
             run, launches from `_flux_shapes` (57 D=128 calls an
             evaluation, the VAE's D=512 decode and encodes), the MMDiT's
             velocity finite at every evaluation; Kontext at least
             FLUX_MIN_DIFF from the same run without ReferenceLatent, the
             dual-prompt image at least FLUX_MIN_DIFF from the
             custom-sampling one.
   sd3     - the two bundled SD3.5 workflows (SD3_WORKFLOWS), unmodified,
             at full width (`_sd3_phase`): SD3.5-large (8.15B, 38 joint
             blocks at 38 heads of D=64, QK norm) for txt2img-sd35, then,
             freed first, SD3.5-medium (MMDiT-X: 24 joint blocks, attn2 in
             the first 13) for txt2img-sd35m-slg (SkipLayerGuidanceSD3 on
             blocks 7-9 over progress [0.01, 0.2]); CLIP-L, CLIP-G and
             T5-XXL at 77 tokens, the 16-channel SD3 VAE, 1024 px, 28 euler
             steps, CFG-batched; seeded random weights drawn on the card.
             Each as txt2img, one run over HTTP: the batch [2, 1024, 1024,
             3] in [0, 1], image 0 within RERUN_TOLERANCE of the local run
             at its seed and w1's within RERUN_TOLERANCE + PNG_STEP, the two
             apart, no collector job left, peak memory a run, launches from
             `_sd3_shapes` (the joint calls over 154 text and 64^2 image
             tokens, attn2's over the image, the SLG window's batch-1 skip
             passes, the VAE's decode), the MMDiT's velocity finite at every
             evaluation. Under SLG: the skip passes equal the steps whose
             sigma lies in the window on the host schedule, 4 images' worth;
             the image at least SD3_MIN_DIFF from the same run muted (scale
             0); the workflow once locally through DualCLIPLoader sd3 (no
             T5: 77 text tokens), finite, its CLIP tokens those of the triple
             conditioning exactly, launches from `_sd3_shapes`.
   wan     - the three bundled WAN workflows (WAN_WORKFLOWS), unmodified, at
             full width, the 14B DiTs at WAN_DEPTH_CUT's depth
             (`_wan_phase`): wan-1.3b (33 frames of
             480x480, 30 steps), wan-14b (81 frames of 720x480, 30 steps),
             wan-14b-i2v (WanImageToVideo, 81 frames, 20 steps; its
             LoadImage reads a seeded 720x480 first_frame.png), CLIP-L, the
             causal WAN VAE, CLIP ViT-H for i2v; seeded random weights on
             the card, one bundle at a time, the last freed first. Each
             one run over HTTP, master + w1 in this process: the batch [2
             F, H, W, 3] in [0, 1], the participants apart, launches from
             `_wan_shapes` (two D=128 calls a block, three with i2v's
             image tokens, CLIP vision's 31 D=80 calls), the DiT's velocity
             finite at every evaluation, w1's F envelopes, no collector job
             left, SaveVideoFrames' 2 F PNGs (the frames' 8-bit values) and
             manifest at 16 fps. wan-1.3b also against local runs at seeds
             0 and 1, its DiT loaded back from a bf16 file in the original
             blocks.N.* layout (every parameter equal to the written one),
             and the chunked VAE decode of a seeded latent against the whole
             clip (WAN_CHUNK_TOLERANCE); the 14B workflows through each
             participant's first evaluation (its noise exactly the draw at
             its seed, w1's velocity within WAN_FIRST_EVAL_TOLERANCE of one
             here, and for i2v the same with the CLIP tokens zeroed at least
             WAN_IMAGE_BRANCH_MIN apart). wan-1.3b's master video also
             through SaveAnimatedWEBP with no sampling, on a [webp] line
             (`_webp_check`): the RIFF size, the VP8X canvas and animation
             flag, loop 0, one ANMF a frame at the workflow's fps and a
             VP8L header of the frame's size in each (the pixels are held
             exact on the CPU by tests/test_torch_webp.py); bytes and
             seconds. Seconds, videos/s, peak memory and parameters by
             part per workflow.
   phases  - each phase's seconds and their total.
5. kernels - one JSON line per the port's kernel contract: entry
             flash_attention over the upscale path (`launches`: the elastic
             run, both participants), flash_attention_adapters over the same
             shapes on the cut SDXL (`launches`: the adapters phase's run
             over HTTP wearing the LoRA), entry flash_attention_txt2img over
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
             frames), flash_attention_inpaint_model per image, and
             flash_attention_<tag> per image of each Flux workflow and of
             each SD3.5 workflow (`launches`: its HTTP run), and
             flash_attention_sd35m_slg_dualclip per image of the SLG
             workflow through DualCLIPLoader sd3 (`launches`: its local
             run), and flash_attention_wan, _wan_14b and _wan_i2v per video
             (`launches`: its HTTP run). With `--phases` only the entries
             of the phases that ran.

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
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types

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
SPIN_CYCLES = 6_000_000  # ~3 ms at the H100's 1.98 GHz boost clock
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
# the elastic phase's profiled run (`_Incident`): a torch.profiler capture
# asked for PROFILE_DURATION_S, stopped after PROFILE_WINDOW_S of the run;
# the bus's tap cost is timed over TAP_PUBLISHES publishes, and the host
# cost of a launch before and after the capture over LAUNCH_PROBES launches
PROFILE_DURATION_S = 2.0
PROFILE_WINDOW_S = 1.0
TAP_PUBLISHES = 10000
LAUNCH_PROBES = 5000
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
# and at D = 128, whose keys past WGMMA_PINGPONG_ABOVE[128] take two
# consumers a block with P rounded once to bf16: the edges of its 128-row
# blocks (consumer 1 on rows 64-127), at the key counts of
# `_bf16_p_edge_keys`
EDGE_ROWS_BF16_P = (1, 63, 64, 65, 127, 128, 129, 200)
# key counts at which the [threshold] line holds both D = 128 plans to the
# plain version at Flux's 4608 query rows and 24 heads, besides the
# threshold and one past it
THRESHOLD_KEYS = (63, 257, 513)
# SD1.5's head dims (8 heads at every level of its UNet)
TXT2IMG_HEAD_DIMS = (40, 80, 160)
TXT2IMG_RUNS = 2
# the txt2img phase's [audio] graph: a seeded 16-bit WAV a participant,
# AUDIO_SECONDS of AUDIO_CHANNELS at AUDIO_RATE, the collector's combined
# audio split AUDIO_PARTS ways
AUDIO_RATE = 44100
AUDIO_CHANNELS = 2
AUDIO_SECONDS = 3
AUDIO_PARTS = 3
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
# the procs phase: w1's launch to its first answered probe (it imports
# torch, makes a CUDA context, finds the kernel library), and one run
PROCS_LAUNCH_TIMEOUT_S = 240.0
PROCS_RUN_TIMEOUT_S = 300.0
# w1's CDT_FLEET_SNAPSHOT_SECONDS in the procs phase: each of its pulls and
# heartbeats piggybacks a fleet snapshot, so the heartbeat after its last
# tile carries the run's final usage to the master
PROCS_FLEET_SNAPSHOT_S = 1e-6
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
# the nodes phase's merges: the second SD1.5 bundle's seed, the ratio the
# images are made at, and how far each must be from both parents'
MERGE_SEED = 1
MERGE_RATIO = 0.5
MERGE_MIN_DIFF = 1.0 / 255


# the flux phase: the four bundled Flux workflows, unmodified, at their
# full width (1024 px), by entry of the kernels line; Kontext's
# reference.png is a seeded FLUX_IMAGE_PX image
FLUX_WORKFLOWS = {
    "flux_schnell": "distributed-txt2img-flux.json",
    "flux_dev": "distributed-flux-custom-sampling.json",
    "flux_dual": "distributed-flux-dual-prompt.json",
    "kontext": "distributed-kontext-edit.json",
}
FLUX_IMAGE_PX = 1024
# Flux's head dim (3072 wide, 24 heads)
FLUX_HEAD_DIMS = (128,)
# the joint length of a 1008-px image (63^2 image tokens and 512 text
# tokens): ragged on D = 128's 64-key tiles
FLUX_RAGGED_TOKENS = 63 * 63 + 512
# Kontext against the same run without ReferenceLatent, and the
# dual-prompt image against the custom-sampling one: one 8-bit level
FLUX_MIN_DIFF = 1.0 / 255
# the adapters phase's LoRA (kohya layout, seeded): rank, alpha, the
# std of up's entries times sqrt(rank), the strength it is worn at, and
# how far its image must be from the base model's
ADAPTER_NAME = "chip_smoke_style"
# the same LoRA's attention modules only (attn1, attn2 of the backbone)
ADAPTER_PARTIAL_NAME = "chip_smoke_style_attn"
ADAPTER_RANK = 32
ADAPTER_ALPHA = 16
ADAPTER_UP_STD = 0.1
ADAPTER_STRENGTH = 0.8
ADAPTER_MIN_DIFF = 1.0 / 255
# the sd3 phase: the two bundled SD3.5 workflows, unmodified, at their full
# width (1024 px), by entry of the kernels line
SD3_WORKFLOWS = {
    "sd35": "distributed-txt2img-sd35.json",
    "sd35m_slg": "distributed-txt2img-sd35m-slg.json",
}
SD3_IMAGE_PX = 1024
# the joint length of a 1008-px image (63^2 image tokens, 77 CLIP and 77 T5
# tokens): ragged on D = 64's 64-row blocks and every key tile
SD3_RAGGED_TOKENS = 63 * 63 + 154
# the SLG image against the same run with the node muted: one 8-bit level
SD3_MIN_DIFF = 1.0 / 255
# the wan phase: the three bundled WAN workflows, unmodified, at full width
# and depth, by entry of the kernels line
WAN_WORKFLOWS = {
    "wan": "distributed-wan.json",
    "wan_14b": "distributed-wan-2.2-14b-t2v.json",
    "wan_i2v": "distributed-wan-i2v.json",
}
# the i2v workflow's LoadImage input (first_frame.png): a seeded frame of the
# t2v-14B size (height, width), so its DiT runs at 21 x 30 x 45 tokens
WAN_I2V_FRAME_HW = (480, 720)
# a participant's first DiT evaluation against one evaluation here on its
# seed's noise: |d| <= WAN_FIRST_EVAL_TOLERANCE * max |ref|
WAN_FIRST_EVAL_TOLERANCE = 1e-2
# the i2v velocity with the CLIP-vision tokens zeroed moves by at least
# 1/255 of its max (the image branch is live)
WAN_IMAGE_BRANCH_MIN = 1.0 / 255
# the chunked VAE decode of one wan-1.3b latent against the whole clip
WAN_CHUNK_TOLERANCE = 1e-3
# a WAN run over HTTP: two 14B videos share the card
WAN_RUN_TIMEOUT_S = 900.0
# samples x calls, and warm-up calls, of the plain version's timing at a
# path's shape (its check's call has run it once); past PLAIN_SCORES_TIMED
# scores (WAN's 28350 tokens, ~2 s a call) PLAIN_REPS_LARGE
PLAIN_REPS = ((2, 3), 1)
PLAIN_SCORES_TIMED = 2**30
PLAIN_REPS_LARGE = ((2, 1), 0)
# samples x calls of each timing of a kernel check: at a path's shape, at a
# check off every path (f32, views, ragged lengths), and of each plan on a
# [tiles] line (a CUDA-event median; few samples, so that the wan phase
# fits the run's time limit)
MAIN_REPS = (3, 10)
OFF_PATH_REPS = (2, 5)
TILES_REPS = (3, 10)
# kernel and SDPA calls bound past this many ms are timed at LARGE_REPS
LARGE_CALL_MS = 5.0
LARGE_REPS = (5, 2)
# earlier paths cut in depth (full width) so that the wan phase fits the
# run's time limit: Flux (double, single blocks; published 19, 38) and the
# SD3.5 joint blocks (published 38 large; 24 medium, attn2 in the first 13,
# SLG on blocks 7-9)
FLUX_DEPTH_CUT = (2, 4)
SD3_DEPTH_CUT = {"sd35-large": (4, 0), "sd35-medium": (10, 5)}
# and the 14B WAN DiTs' blocks (published 40): two of their videos at full
# depth took half the run's time limit, and the whole run took 1068-1216 s
# as the host varied; 10 blocks fewer take ~120 s off; wan-1.3b keeps its 30
WAN_DEPTH_CUT = {"wan-14b": 30, "wan-14b-i2v": 30}
# then the SDXL, SD1.5 and SD2.1 UNets of the phases that repeat a path the
# main path covers (host-bound on their launches): SDXL's transformer blocks
# per level (published (0, 2, 10)) and every UNet's residual blocks per level
# (published 2). The main path (main, elastic, txt2img) and the other phases
# keep the published depths; procs's worker loads published files.
SDXL_DEPTH_CUT = (0, 1, 1)
UNET_RES_BLOCKS_CUT = 1
UNET_CUTS = ("sdxl", "sd15", "sd21")
CUT_PHASES = ("adapters", "ckpt", "samplers", "usdu_full", "guidance", "custom", "dynamic")
# every phase, in run order; `--phases` picks a subset
PHASES = ("kernel", "main", "elastic", "adapters", "txt2img", "sd", "ckpt", "procs", "samplers",
          "usdu_full", "guidance", "custom", "nodes", "inpaint_model", "dynamic", "flux",
          "sd3", "wan")


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


def _time_ms(torch, fn, reps: int = 15, inner: int = 10, warmup: int = 3) -> float:
    """Median over `reps` of the device time per call, after warm-up.

    Each sample's `inner` calls queue behind a spin kernel of ~10 ms, so
    they are all on the stream before the first one starts: the CUDA
    events then time the device's work back to back, not the rate at
    which the host launches it (which bounds calls of a few µs)."""
    for _ in range(warmup):
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
    (or EmptySD3LatentImage's) size, or the LoadImage input's (`image_px` square) where it has none,
    grown by an ImagePadForOutpaint's pads."""
    latent = _node_ids(workflow, "EmptyLatentImage") or _node_ids(workflow, "EmptySD3LatentImage")
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


def _bf16_p_edge_keys(attn, d: int = 128) -> tuple:
    """Key counts around the router's one-bf16-P threshold T at head dim
    D and around each of its key tiles' first multiple past it: T (the
    split-P plan), T + 1, and each such multiple, one less and one more."""
    threshold = attn.WGMMA_PINGPONG_ABOVE[d]
    keys = [threshold, threshold + 1]
    for tile in attn.WGMMA_PINGPONG_KEYS[d]:
        edge = -(-(threshold + 1) // tile) * tile
        keys += [edge - 1, edge, edge + 1]
    return tuple(sorted(set(keys)))


def _flux_extra_checks(attn) -> list:
    """The D = 128 checks beyond the Flux workflows' shapes, as (label,
    q shape, M, dtype, launches per unit, layout): a ragged joint length
    (1008 px), a short key count and both sides of the one-bf16-P
    threshold at 24 heads, and the two-consumer plan's edges (one head of
    one batch)."""
    threshold = attn.WGMMA_PINGPONG_ABOVE[128]
    checks = [(f"joint@{FLUX_RAGGED_TOKENS} (1008 px)", (1, FLUX_RAGGED_TOKENS, 24, 128),
               FLUX_RAGGED_TOKENS, "bfloat16", None, "contiguous")]
    checks += [(f"joint@4608 x {m} keys", (1, 4608, 24, 128), m, "bfloat16", None, "contiguous")
               for m in (63, threshold, threshold + 1)]
    checks += [(f"edge D128 {n}x{m} B*H=1", (1, n, 1, 128), m, "bfloat16", None, "edge")
               for n in EDGE_ROWS_BF16_P for m in _bf16_p_edge_keys(attn)]
    return checks


def _tolerance_ratio(got, ref, rtol: float = 2.0**-7, atol: float = 1e-3) -> float:
    """The largest |got - ref| over the bf16 tolerance atol + rtol |ref|:
    at most 1 passes."""
    got, ref = got.float(), ref.float()
    return float(((got - ref).abs() / (atol + rtol * ref.abs())).max())


def _threshold_line(torch, attn, gen) -> str:
    """Both D = 128 plans against the plain version at Flux's 4608 query
    rows and 24 heads over THRESHOLD_KEYS and both sides of the
    threshold, and the one-bf16-P plan against its emulation at
    joint@4608. Fails if the router's plan misses anywhere or the plan
    misses its emulation."""
    threshold = attn.WGMMA_PINGPONG_ABOVE[128]
    split_p = attn.Plan("wgmma", attn.WGMMA_KEY_TILES[128][0], attn.WGMMA_ROWS)
    parts = []
    for m in THRESHOLD_KEYS + (threshold, threshold + 1, 4608):
        # the one-bf16-P plan with the key tile the router weighs best at M
        bf16_p = attn.Plan("wgmma", attn.pingpong_key_tile(128, m), 2 * attn.WGMMA_ROWS)
        q, k, v = (torch.randn(s, generator=gen, device="cuda").bfloat16()
                   for s in ((1, 4608, 24, 128), (1, m, 24, 128), (1, m, 24, 128)))
        ref = attn.flash_attention_reference(q, k, v)
        ratios = {p: _tolerance_ratio(attn.flash_attention(q, k, v, with_plan=p), ref)
                  for p in (split_p, bf16_p)}
        chosen = attn.plan(q, k, v)
        _require(ratios[chosen] <= 1.0,
                 f"[threshold] the router's {chosen} misses at {m} keys ({ratios[chosen]:.3g})")
        parts.append(f"{m}: " + ", ".join(
            f"{'*' if p == chosen else ''}k{p.keys_per_tile} r{p.rows_per_cta} {r:.3f}"
            for p, r in ratios.items()))
    emulated = attn.bf16_p_attention_reference(q, k, v, bf16_p.keys_per_tile)
    emulation = _tolerance_ratio(attn.flash_attention(q, k, v, with_plan=bf16_p), emulated)
    _require(emulation <= 1.0, f"[threshold] the one-bf16-P plan misses its emulation "
                               f"({emulation:.3g})")
    return (f"[threshold] D=128, 4608 query rows, 24 heads: max |d| / (1e-3 + 2^-7 |ref|) "
            f"against the f32 plain version by key count (* the router's plan; above 1 "
            f"misses): " + "; ".join(parts) + f"; the one-bf16-P plan against its emulation "
            f"at 4608 keys {emulation:.3f}")


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
        ms = _time_ms(torch, lambda: attn.flash_attention(q, k, v, with_plan=plan), *TILES_REPS)
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
            # a stopped server keeps no bundle alive (the next phase's may not fit)
            for server in (master, worker):
                server.execution_context.pipelines.clear()


def _queue(base: str, worker_port: int, workflow, extra: dict | None = None,
           timeout: float = ELASTIC_RUN_TIMEOUT_S) -> tuple[dict, dict, dict]:
    """POST the workflow to the master's /distributed/queue with workers
    ["w1"] (and the body keys of `extra`) and wait, at most `timeout`
    seconds, until the master's and w1's prompts are done: (the queue
    answer, the master's history, w1's history)."""
    from comfyui_distributed_tpu_torch.utils.network import request_json

    status, queued = request_json("POST", f"{base}/distributed/queue", {
        "prompt": workflow, "client_id": "chip_smoke", "workers": ["w1"], **(extra or {}),
    }, timeout=120)
    _require(status == 200, f"/distributed/queue answered {status}: {queued}")
    _require(queued.get("workers") == ["w1"],
             f"w1 was not dispatched (probe or dispatch failed): {queued}")
    deadline = time.monotonic() + timeout
    history = _wait_done(request_json, f"{base}/history/{queued['prompt_id']}", deadline)
    worker_history = _wait_done(
        request_json, f"http://127.0.0.1:{worker_port}/history/{queued['trace_id']}_w0", deadline)
    _require(history.get("error") is None, f"master prompt failed: {history}")
    _require(worker_history.get("error") is None, f"worker prompt failed: {worker_history}")
    return queued, history, worker_history


def _launch_counts(attn) -> tuple[int, dict]:
    return attn.flash_attention.launches, dict(attn.flash_attention.launches_by_instance)


PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
# the stages whose wall time is host work in the transfer ledger's buckets
HOST_STAGES = ("readback", "encode", "decode", "submit")
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def _scrape(base: str) -> tuple[str, list]:
    """GET {base}/distributed/metrics: (content type, [(name, labels,
    value)]). Every sample line must parse as `name{labels} value`."""
    import urllib.request

    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(f"{base}/distributed/metrics", timeout=60) as resp:
        content_type = resp.headers.get("Content-Type")
        body = resp.read().decode("utf-8")
    samples = []
    for line in body.splitlines():
        if not line or line.startswith("#"):
            continue
        name_part, _, value = line.rpartition(" ")
        name, brace, rest = name_part.partition("{")
        _require(bool(name) and (not brace or rest.endswith("}")),
                 f"{base}: unparsable sample line {line!r}")
        try:
            number = float(value)
        except ValueError:
            number = None
        _require(number is not None, f"{base}: sample value of {line!r} is not a number")
        samples.append((name, dict(_LABEL_RE.findall(rest)), number))
    return content_type, samples


def _total(samples: list, name: str, **labels) -> float:
    """The sum of `name`'s samples whose labels include `labels`."""
    return sum(value for sample, got, value in samples
               if sample == name and all(got.get(k) == str(v) for k, v in labels.items()))


def _spans_of(tree: list) -> list:
    """The spans of a /distributed/trace answer's tree, flat."""
    out = []
    for node in tree:
        out.append(node)
        out.extend(_spans_of(node["children"]))
    return out


def _tile_output_bytes(workflow, image) -> int:
    """The bytes of one processed tile read back to the host: [B, padded
    h, padded w, 3] float32."""
    from comfyui_distributed_tpu_torch.ops.upscale import plan_grid

    o = _usdu_options(workflow)
    _, _, grid = plan_grid(int(image.shape[1]), int(image.shape[2]), float(o["upscale_by"]),
                           int(o["tile_width"]), int(o["tile_padding"]), int(o["tile_height"]),
                           mask_blur=int(o["mask_blur"]), uniform=bool(o["force_uniform_tiles"]))
    return int(image.shape[0]) * grid.padded_h * grid.padded_w * 3 * 4


class _Telemetry:
    """One elastic run's telemetry, read before the run (`start`) and held
    to it after (`check`), on [telemetry] lines; any miss fails the run.
    `bases` are the /distributed/metrics of every process with a registry
    of its own: the master alone when w1 shares its process (the elastic
    phase), the master and w1 in procs, where `w1_base` also serves w1's
    own trace. The usage meter and the transfer ledger read here are this
    process's: both roles' in the elastic phase, the master's in procs.
    The process's cdt_host_tax_ratio gauge is one number for every role
    it hosts; the per-role ratio is computed here from the stage and
    device-execute sums."""

    def __init__(self, torch, label: str, master_base: str, w1_base: str | None = None,
                 cuda: bool = True):
        self.torch = torch
        self.label = label
        # on the CPU (a rehearsal) no dispatch is device time: the ledger
        # then reads host-tax 1.0 and there is no card memory to read
        self.cuda = cuda
        self.master_base = master_base
        self.w1_base = w1_base
        self.bases = [master_base] + ([w1_base] if w1_base else [])
        self.usage_roles = ("master",) if w1_base else ("master", "worker")

    def _samples(self) -> tuple[list, int]:
        samples = []
        for base in self.bases:
            content_type, got = _scrape(base)
            _require(content_type == PROMETHEUS_CONTENT_TYPE,
                     f"{base}/distributed/metrics answered {content_type!r}")
            samples.extend(got)
        return samples, len(samples)

    def start(self) -> None:
        from comfyui_distributed_tpu_torch.telemetry import get_transfer_ledger, get_usage_meter

        self.before, _ = self._samples()
        self.usage_before = get_usage_meter().totals()
        self.ledger_before = get_transfer_ledger().snapshot()

    def _trace(self, base: str, trace_id: str) -> tuple[list, list]:
        from comfyui_distributed_tpu_torch.utils.network import request_json

        status, answer = request_json("GET", f"{base}/distributed/trace/{trace_id}", timeout=60)
        _require(status == 200, f"{base}/distributed/trace/{trace_id} answered {status}")
        return answer["tree"], _spans_of(answer["tree"])

    def check(self, run: int, queued: dict, record: dict, tile_bytes: int) -> dict:
        """The [telemetry] checks of one run; returns the stage seconds by
        role and the host-tax ratios."""
        from comfyui_distributed_tpu_torch.telemetry import get_transfer_ledger, get_usage_meter

        torch, label = self.torch, self.label
        after, n_samples = self._samples()

        def delta(name, **labels):
            return _total(after, name, **labels) - _total(self.before, name, **labels)

        completions = record["completions"]
        tiles = {"master": [t for t, who in completions if who == "master"],
                 "worker": [t for t, who in completions if who == "w1"]}
        n = len(completions)
        _require(n + len(record.get("cached", [])) == record["total"],
                 f"completions {completions} and cached {record.get('cached')} are not the job")
        # --- counters ---
        processed = {role: delta("cdt_tiles_processed_total", role=role) for role in tiles}
        _require(processed == {role: len(idx) for role, idx in tiles.items()},
                 f"cdt_tiles_processed_total rose by {processed}; the store's completions are "
                 f"{ {role: len(idx) for role, idx in tiles.items()} }")
        pulled, requeued = delta("cdt_store_pulls_total", outcome="task"), delta(
            "cdt_store_requeued_tasks_total")
        _require(pulled == n + requeued, f"pulls that handed out a task rose by {pulled}, not "
                 f"{n} completions + {requeued} requeues")
        stages = {}
        for role, idx in tiles.items():
            counts = {stage: delta("cdt_tile_stage_seconds_count", stage=stage, role=role)
                      for stage in ("sample", "dispatch", "readback", "encode", "submit")}
            stages[role] = counts
            for stage in ("sample", "dispatch", "readback") + (("encode",) if role == "worker"
                                                                 else ()):
                _require(counts[stage] == len(idx), f"cdt_tile_stage_seconds{{stage={stage}, "
                         f"role={role}}} has {counts[stage]} samples for {len(idx)} tiles")
        # --- the trace ---
        trace_id = queued["trace_id"]
        tree, spans = self._trace(self.master_base, trace_id)
        names = {s["name"] for s in spans}
        _require(len(tree) == 1 and tree[0]["name"] == "sched.wait"
                 and "queue_orchestration" in {c["name"] for c in tree[0]["children"]},
                 f"trace {trace_id} is not one tree under the admission wait sched.wait with "
                 f"the orchestration below it: roots {[root['name'] for root in tree]}")
        from_w1 = lambda name: [s for s in spans if s["name"] == name  # noqa: E731
                                and s["attrs"].get("worker_id") == "w1"]
        dispatches, pulls, submits = (from_w1("dispatch"), from_w1("rpc.request_image"),
                                      from_w1("rpc.submit_tiles"))
        _require(len(dispatches) == 1 and pulls and submits,
                 f"trace {trace_id}: {len(dispatches)} dispatch spans to w1, {len(pulls)} "
                 f"rpc.request_image and {len(submits)} rpc.submit_tiles spans from w1")
        _require(stages["worker"]["submit"] == len(submits),
                 f"w1 observed {stages['worker']['submit']} submits, the master served "
                 f"{len(submits)}")
        worker_spans, worker_tree = spans, tree
        if self.w1_base:
            worker_tree, worker_spans = self._trace(self.w1_base, trace_id)
            _require(len(worker_tree) == 1, f"w1's trace {trace_id} is not one tree: roots "
                     f"{[root['name'] for root in worker_tree]}")
        for role, role_spans in (("master", spans), ("worker", worker_spans)):
            for name in ("tile.sample", "tile.dispatch", "tile.readback"):
                have = sorted(s["attrs"].get("tile_idx") for s in role_spans
                              if s["name"] == name and s["attrs"].get("role") == role)
                _require(have == sorted(tiles[role]), f"trace {trace_id}: {name} spans of "
                         f"role {role} for tiles {have}, completions {sorted(tiles[role])}")
        print(f"{label} run {run}: /distributed/metrics of {len(self.bases)} process(es) "
              f"answered {PROMETHEUS_CONTENT_TYPE!r}, {n_samples} samples parsed; tiles "
              f"processed +{sum(processed.values()):g} ({ {r: int(v) for r, v in processed.items()} }"
              f" = the store's completions); pulls that handed out a task +{pulled:g} = {n} "
              f"completions + {requeued:g} requeues; stage samples "
              f"{ {r: {k: int(v) for k, v in c.items()} for r, c in stages.items()} }")
        print(f"{label} run {run} trace {trace_id}: one tree of {len(spans)} spans on the master "
              f"under sched.wait and queue_orchestration ({len(names)} span names); the dispatch "
              f"to w1, "
              f"{len(pulls)} rpc.request_image and {len(submits)} rpc.submit_tiles spans of w1's; "
              f"tile spans of the master's tiles {sorted(tiles['master'])} and w1's "
              f"{sorted(tiles['worker'])}"
              + (f" (w1's own trace: one tree of {len(worker_spans)} spans)" if self.w1_base
                 else ""))
        # --- the transfer ledger ---
        d2h = delta("cdt_transfer_bytes_total", direction="d2h")
        _require(d2h == n * tile_bytes, f"D2H bytes rose by {d2h:g}, not {n} tiles x "
                 f"{tile_bytes}")
        taxes, device_s = {}, {}
        for role, idx in tiles.items():
            device_s[role] = delta("cdt_device_execute_seconds_sum", role=role, tier="scan")
            dispatched = delta("cdt_device_execute_seconds_count", role=role, tier="scan")
            expected = len(idx) if self.cuda else 0
            _require(dispatched == expected, f"{role}: {dispatched:g} device-execute samples for "
                     f"{len(idx)} tiles (is CDT_PROFILING off?)")
            if not idx or not self.cuda:
                continue
            host = sum(delta("cdt_tile_stage_seconds_sum", stage=stage, role=role)
                       for stage in HOST_STAGES)
            _require(device_s[role] > 0, f"{role}: no device-execute seconds")
            taxes[role] = host / (host + device_s[role])
            _require(0 < taxes[role] <= 1, f"{role}: host-tax ratio {taxes[role]}")
        gauges = {labels.get("role"): value for name, labels, value in after
                  if name == "cdt_host_tax_ratio"}
        print(f"{label} run {run} ledger: device-execute seconds "
              f"{ {r: round(v, 4) for r, v in device_s.items()} }; D2H bytes +{int(d2h)} = {n} "
              f"tiles x {tile_bytes}; host-tax ratio this run, per participant "
              f"{ {r: round(v, 4) for r, v in taxes.items()} } (host = readback + encode + "
              f"decode + submit seconds of the role; the ledger's cumulative gauge "
              f"{ {r: round(v, 4) for r, v in gauges.items()} })")
        _require(gauges and all(0 < v <= 1 if self.cuda else v == 1.0 for v in gauges.values()),
                 f"cdt_host_tax_ratio {gauges}")
        # --- the usage meter ---
        meter = get_usage_meter()
        usage = meter.totals()
        moved = {key: usage[key] - self.usage_before[key] for key in (
            "dispatch_chip_ns", "attributed_ns", "dispatch_waste_ns", "overhead_ns")}
        _require(usage["conserved"] and moved["attributed_ns"] + moved["dispatch_waste_ns"]
                 + moved["overhead_ns"] == moved["dispatch_chip_ns"],
                 f"the usage meter's identity fails: {usage}, this run {moved}")
        # the ledger's dispatch brackets: device time on the card, host
        # time on the CPU (a rehearsal)
        kind = "device_ns" if self.cuda else "eager_ns"
        ledger_ns = get_transfer_ledger().snapshot()[kind] - self.ledger_before[kind]
        job_id = queued["job_ids"][USDU_NODE]
        chip_s = meter.rollup(self.usage_roles)["jobs"].get(job_id, {}).get("chip_s", 0.0)
        _require(moved["dispatch_chip_ns"] == ledger_ns and round(chip_s * 1e9) == ledger_ns,
                 f"the usage meter's dispatch chip ns +{moved['dispatch_chip_ns']} and job "
                 f"{job_id}'s chip seconds {chip_s} against the transfer ledger's {kind} "
                 f"+{ledger_ns}")
        print(f"{label} run {run} usage: dispatch chip ns +{moved['dispatch_chip_ns']} = "
              f"attributed {moved['attributed_ns']} + waste {moved['dispatch_waste_ns']} + "
              f"overhead {moved['overhead_ns']} (exact) = the transfer ledger's {kind} "
              f"+{ledger_ns}; job {job_id} chip seconds of role(s) {list(self.usage_roles)} "
              f"{chip_s:.9f} (exact)")
        # --- the card's memory, when both servers share this process ---
        if self.cuda and not self.w1_base:
            for attempt in range(1, 4):
                _, scraped = _scrape(self.master_base)
                allocated = torch.cuda.memory_allocated(0)
                peak = torch.cuda.max_memory_allocated(0)
                got = {labels.get("stat"): value for name, labels, value in scraped
                       if name == "cdt_device_memory_bytes" and labels.get("device") == "gpu:0"}
                if (got.get("bytes_in_use"), got.get("peak_bytes_in_use")) == (allocated, peak):
                    break
            print(f"{label} run {run} memory: cdt_device_memory_bytes{{device=\"gpu:0\"}} "
                  f"bytes_in_use {got.get('bytes_in_use')} vs torch.cuda.memory_allocated "
                  f"{allocated}, peak_bytes_in_use {got.get('peak_bytes_in_use')} vs "
                  f"max_memory_allocated {peak} (scrape {attempt} of at most 3)")
            _require((got.get("bytes_in_use"), got.get("peak_bytes_in_use")) == (allocated, peak),
                     "cdt_device_memory_bytes disagrees with torch.cuda")
        return {"stage_seconds": {role: {stage: delta("cdt_tile_stage_seconds_sum", stage=stage,
                                                      role=role)
                                         for stage in ("pull", "sample", "dispatch", "readback",
                                                       "encode", "submit", "decode", "blend")}
                                  for role in tiles},
                "host_tax": taxes, "spans": spans}


def _post_answer(url: str, body: dict) -> tuple[int, dict, dict]:
    """POST JSON: (status, response headers in lower case, JSON body), an
    error status included (the Retry-After of a 429 or 503 is a header)."""
    import urllib.error
    import urllib.request

    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    request = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                     headers={"Content-Type": "application/json"})
    try:
        with opener.open(request, timeout=60) as resp:
            return resp.status, {k.lower(): v for k, v in resp.headers.items()}, json.loads(
                resp.read() or b"null")
    except urllib.error.HTTPError as err:
        with err:
            return err.code, {k.lower(): v for k, v in err.headers.items()}, json.loads(
                err.read() or b"null")


class _Sched:
    """One elastic run's control plane on the master, read before the run
    (`start`) and held to it after (`check`), on a [sched] line; any miss
    fails the run: the queue answer's `scheduler` block, one admission
    and one grant (cdt_sched_admissions_total{outcome="admitted"},
    cdt_sched_grants_total) and no slot held afterwards
    (cdt_sched_active), the trace's sched.wait root on this ticket, each
    participant's grants (the master's tile.pull spans, w1's
    rpc.request_image spans: a grant's tiles in `batch`) adding up to its
    completions, and a healthy fleet for the watchdog: no straggler, no
    stall, no speculative requeue (its counters and its verdict lists),
    w1's breaker closed."""

    def __init__(self, label: str, master, base: str):
        self.label = label
        self.master = master
        self.base = base
        self.server = f"master:{master.port}"

    def start(self) -> None:
        self.before = _scrape(self.base)[1]

    def check(self, run: int, queued: dict, record: dict, spans: list) -> dict:
        from comfyui_distributed_tpu_torch.resilience.health import get_health_registry

        after = _scrape(self.base)[1]

        def delta(name, **labels):
            return _total(after, name, **labels) - _total(self.before, name, **labels)

        block = queued.get("scheduler")
        _require(isinstance(block, dict) and block.get("queue_wait_seconds") is not None,
                 f"the queue answer carries no scheduler block: {queued}")
        admitted = delta("cdt_sched_admissions_total", outcome="admitted")
        granted = delta("cdt_sched_grants_total")
        active = _total(after, "cdt_sched_active", server=self.server)
        _require((admitted, granted, active) == (1, 1, 0),
                 f"admissions +{admitted:g}, grants +{granted:g}, active {active:g}: not one "
                 f"admission and one grant with the slot released")
        roots = [s for s in spans if s["name"] == "sched.wait"]
        _require(len(roots) == 1 and roots[0]["attrs"].get("ticket_id") == block["ticket_id"],
                 f"sched.wait spans {[r['attrs'] for r in roots]}, ticket {block['ticket_id']}")
        grants = {
            "master": [len(s["attrs"].get("batch") or [0]) for s in spans
                       if s["name"] == "tile.pull" and s["attrs"].get("role") == "master"
                       and "tile_idx" in s["attrs"]],
            "w1": [len(s["attrs"].get("batch") or [0]) for s in spans
                   if s["name"] == "rpc.request_image" and s["attrs"].get("worker_id") == "w1"
                   and "tile_idx" in s["attrs"]],
        }
        done = {who: sum(1 for _, w in record["completions"] if w == who) for who in grants}
        _require({who: sum(sizes) for who, sizes in grants.items()} == done,
                 f"grants {grants} are not the completions {done}")
        watchdog = {
            "stragglers": delta("cdt_watchdog_stragglers_total"),
            "stalls": delta("cdt_watchdog_stalls_total"),
            "speculative": delta("cdt_store_requeued_tasks_total", reason="speculative"),
        }
        wd = self.master.watchdog
        verdicts = (list(wd.stragglers_flagged), list(wd.stalls_detected), dict(wd.speculated))
        breaker = get_health_registry().state("w1").value
        print(f"{self.label} run {run}: queue wait {block['queue_wait_seconds']:.6f} s (ticket "
              f"{block['ticket_id']}, lane {block['lane']}, tenant {block['tenant']}); "
              f"admissions +{admitted:g}, grants +{granted:g}, cdt_sched_active {active:g} "
              f"after; the trace's root sched.wait on this ticket; grants by participant (tiles "
              f"a grant) master {grants['master']}, w1 {grants['w1']}; watchdog stragglers "
              f"+{watchdog['stragglers']:g}, stalls +{watchdog['stalls']:g}, speculative "
              f"requeues +{watchdog['speculative']:g} (verdicts so far {verdicts}); w1's "
              f"breaker {breaker}")
        _require(not any(watchdog.values()) and verdicts == ([], [], {}),
                 f"the watchdog acted on a healthy fleet: {watchdog}, verdicts {verdicts}")
        _require(breaker == "healthy", f"w1's breaker is {breaker}")
        return {"queue_wait_s": block["queue_wait_seconds"], "grants": grants}


class _Push:
    """One elastic run's push grants, read before the run (`start`) and
    held to it after (`check`) on a [push] line; any miss fails the run.
    The master's cdt_push_grants_total rises by the tiles the job's
    creation made pending plus every tile requeued since (a requeue
    refills the queue, and each refill is announced); w1's GrantSignal
    (its `grant_signal` in w1's /distributed/system_info) connected to
    the master's /distributed/events for this job and received the
    stream's hello frame (a stream that is down, or delivers nothing,
    would leave w1 on the pure pull loop unseen); w1 parked after its
    empty pull (unless the job's job_complete reached it first), at most
    once until the CDT_PUSH_WAIT timeout, which then ended its pulls; and
    the master's event bus holds as many subscribers after the run as
    before it (the stream let go of w1's subscription when w1 closed
    it). Whether a pushed frame woke each park is printed: a park that
    starts more than CDT_PUSH_WAIT before the master finishes its own
    tiles ends on the timeout, as on a JAX worker."""

    def __init__(self, label: str, base: str, w1_base: str):
        self.label = label
        self.base = base
        self.w1_base = w1_base

    def start(self) -> None:
        from comfyui_distributed_tpu_torch.telemetry import get_event_bus

        self.before = _scrape(self.base)[1]
        self.subscribers = get_event_bus().subscriber_count

    def check(self, run, queued: dict, record: dict) -> dict:
        from comfyui_distributed_tpu_torch.telemetry import get_event_bus
        from comfyui_distributed_tpu_torch.utils.network import request_json

        after = _scrape(self.base)[1]

        def delta(name, **labels):
            return _total(after, name, **labels) - _total(self.before, name, **labels)

        job_id = queued["job_ids"][USDU_NODE]
        pushed, requeued = delta("cdt_push_grants_total"), delta("cdt_store_requeued_tasks_total")
        made_pending = record["total"] - len(record.get("cached", []))
        _, info = request_json("GET", f"{self.w1_base}/distributed/system_info", timeout=10)
        signal = info["status"].get("grant_signal") or {}
        parks = signal.get("parks", [])
        bus = get_event_bus()
        deadline = time.monotonic() + 5.0
        while bus.subscriber_count != self.subscribers and time.monotonic() < deadline:
            time.sleep(0.01)
        print(f"{self.label} run {run}: cdt_push_grants_total +{pushed:g} (the {made_pending} "
              f"tiles made pending + {requeued:g} requeued); w1's grant signal for job "
              f"{signal.get('job_id')}: connections {signal.get('connects')}, frames "
              f"{signal.get('frames')}, parks (seconds, ended by) {parks}, the last ended on "
              f"{parks[-1][1] if parks else None}, job_complete seen "
              f"{signal.get('job_complete')}; the master's event-bus subscribers "
              f"{bus.subscriber_count} after the run, {self.subscribers} before")
        _require(pushed == made_pending + requeued,
                 f"cdt_push_grants_total rose by {pushed:g}, not {made_pending} + {requeued:g}")
        from comfyui_distributed_tpu_torch.utils.constants import PUSH_WAIT_SECONDS

        frames = signal.get("frames") or {}
        timeouts = [seconds for seconds, how in parks if how == "timeout"]
        _require(signal.get("job_id") == job_id and signal.get("connects", 0) >= 1
                 and frames.get("hello", 0) >= 1,
                 f"w1's grant signal never connected for job {job_id}, or its stream "
                 f"delivered nothing: {signal}")
        _require(parks or frames.get("job_complete"), f"w1 never parked: {signal}")
        _require(len(timeouts) <= 1 and (not timeouts or parks[-1][1] == "timeout")
                 and all(seconds >= 0.99 * PUSH_WAIT_SECONDS for seconds in timeouts),
                 f"w1's parks {parks}: more than one CDT_PUSH_WAIT, or one cut short unseen")
        _require(bus.subscriber_count == self.subscribers,
                 f"event-bus subscribers {bus.subscriber_count} after the run, "
                 f"{self.subscribers} before: w1's stream was not let go")
        return {"pushed": pushed, "frames": signal.get("frames"), "parks": parks}


class _Incident:
    """The incident plane on the elastic phase (`incident=True`): the
    master runs with CDT_INCIDENT_DIR and CDT_PROFILE_DIR in the phase's
    temporary directory. Every run prints its [flight] line (the
    recorder's appended and dropped events and span closes). One run is
    profiled (`profiled_queue`): once the run is under way (its first
    attention launch on the card, its tile job on the CPU) a POST
    /distributed/profile/start of PROFILE_DURATION_S, then /stop after
    PROFILE_WINDOW_S, both while the run goes on; `check_profile` holds
    the capture on a [profile] line: started and stopped, its Chrome trace
    parses, holds CUDA kernel events among which the attention kernel's
    wgmma instance, at most CDT_PROFILE_MAX_MB, cdt_profile_captures_total
    started and stopped +1 each, the capture listed by GET
    /distributed/profile and none active after the run. Then
    `check_incident` POSTs /distributed/incidents/capture with the run's
    trace id and holds the bundle on an [incident] line: it passes
    `validate_bundle`, its flight spans hold a span_close frame of every
    span of the run's trace, its trace section is that trace, its knobs
    are `resolved_knobs()`, the store, placement, scheduler, health,
    fleet, usage and SLO sections carry no error,
    cdt_incidents_total{trigger="manual"} rose by one, GET
    /distributed/incidents lists it and GET by its id returns it; with the
    recorder's tap lifted, the scraped cdt_flight_dropped_total equals the
    recorder's drops; w1 has the recorder and no incident manager.
    `tap_cost` times TAP_PUBLISHES publishes on the bus with the taps on
    and on a bus with no listener; `launch_us`, read before the profiled
    run and after its capture, the host cost of a launch. Any miss fails the run; the profiled
    run's rate is printed as profiled."""

    def __init__(self, tag: str, master, worker, base: str, worker_base: str, cuda: bool,
                 card: str):
        self.tag = tag
        self.master = master
        self.worker = worker
        self.base = base
        self.worker_base = worker_base
        self.cuda = cuda
        self.card = card
        self.profile: dict = {}
        self.launch_before: float | None = None

    def start_run(self) -> None:
        self.flight_before = self.master.flight.status()

    def end_run(self, run: int) -> dict:
        after = self.master.flight.status()
        moved = {key: {stream: after[key][stream] - self.flight_before[key][stream]
                       for stream in after[key]} for key in ("appended", "dropped")}
        print(f"[flight] {self.tag} run {run}: the recorder appended {moved['appended']} and "
              f"dropped {moved['dropped']} (events, span closes); retained {after['retained']} "
              f"of {after['capacity']} ({self.card})")
        _require(after["installed"] and moved["appended"]["spans"] > 0,
                 f"the flight recorder saw no span close this run: {after}")
        return moved

    def profiled_queue(self, attn, worker_port: int, workflow) -> tuple[dict, dict, dict]:
        """`_queue` on a thread, with a capture inside the run."""
        from comfyui_distributed_tpu_torch.utils.network import request_json

        before = _scrape(self.base)[1]
        done: dict = {}

        def run_queue():
            try:
                done["result"] = _queue(self.base, worker_port, workflow)
            except BaseException as exc:  # noqa: BLE001 - re-raised on the main thread
                done["error"] = exc

        thread = threading.Thread(target=run_queue, name="chip-smoke-queue", daemon=True)
        thread.start()
        deadline = time.monotonic() + ELASTIC_RUN_TIMEOUT_S
        while thread.is_alive() and time.monotonic() < deadline:
            underway = (attn.flash_attention.launches > 0 if self.cuda
                        else self.master.job_store.stats_unlocked()["tile_jobs"] > 0)
            if underway:
                break
            time.sleep(0.005)
        profile = f"{self.base}/distributed/profile"
        status, started = request_json("POST", f"{profile}/start",
                                       {"duration_s": PROFILE_DURATION_S, "tag": self.tag},
                                       timeout=120)
        launches_at_start = attn.flash_attention.launches
        time.sleep(PROFILE_WINDOW_S)
        stop_posted = time.perf_counter()
        stop_status, stopped = request_json("POST", f"{profile}/stop", timeout=900)
        stop_s = time.perf_counter() - stop_posted
        run_went_on = thread.is_alive()
        thread.join(ELASTIC_RUN_TIMEOUT_S)
        if "error" in done:
            raise done["error"]
        _require("result" in done, "the profiled run did not finish")
        self.profile = {"before": before, "status": status, "started": started,
                        "stop_status": stop_status, "stopped": stopped, "stop_s": stop_s,
                        "launches_at_start": launches_at_start, "run_went_on": run_went_on}
        return done["result"]

    def check_profile(self, run: int, tiles_per_s: float) -> dict:
        from comfyui_distributed_tpu_torch.utils import constants
        from comfyui_distributed_tpu_torch.utils.network import request_json

        p = self.profile
        launch_after = self.launch_us()
        _require(p["status"] == 200 and p["started"].get("started") is True,
                 f"the capture did not start: {p['status']} {p['started']}")
        _require(p["stop_status"] == 200 and p["stopped"].get("stopped") is True,
                 f"the capture did not stop cleanly: {p['stop_status']} {p['stopped']}")
        stopped = p["stopped"]
        path = os.path.join(stopped["path"], "trace.json")
        parse_started = time.perf_counter()
        with open(path, "rb") as fh:
            trace = json.load(fh)
        parse_s = time.perf_counter() - parse_started
        events = trace.get("traceEvents")
        _require(isinstance(events, list), f"{path} holds no traceEvents list")
        cats: dict = {}
        for event in events:
            cats[event.get("cat")] = cats.get(event.get("cat"), 0) + 1
        kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
        wgmma = [name for name in kernels if "flash_attention_fwd_wgmma_kernel<" in name]
        after = _scrape(self.base)[1]
        moved = {outcome: _total(after, "cdt_profile_captures_total", outcome=outcome)
                 - _total(p["before"], "cdt_profile_captures_total", outcome=outcome)
                 for outcome in ("started", "stopped", "busy", "errors", "auto_stopped")}
        _, listing = request_json("GET", f"{self.base}/distributed/profile", timeout=60)
        listed = [c["id"] for c in listing.get("captures", [])]
        print(f"[profile] {self.tag} run {run}: capture {stopped['id']} started "
              f"{p['launches_at_start']} attention launches into the run (duration "
              f"{p['started']['duration_s']:g} s), stopped after {stopped['elapsed_s']:.3f} s "
              f"while the run went on: {p['run_went_on']}; the stop answered in "
              f"{p['stop_s']:.3f} s, of which export {stopped['export_s']:.3f} s; trace "
              f"{stopped['bytes']} bytes, parsed in {parse_s:.3f} s: {len(events)} events by "
              f"category {dict(sorted(cats.items(), key=lambda kv: str(kv[0])))}, "
              f"{len(kernels)} CUDA kernels of which {len(wgmma)} the attention kernel's wgmma "
              f"instance (e.g. {wgmma[0][:80] if wgmma else None!r}); "
              f"cdt_profile_captures_total {moved}; listed {stopped['id'] in listed}; the "
              f"profiled run {tiles_per_s:.4f} tiles/s as profiled; host us a launch "
              f"({LAUNCH_PROBES} one-element adds) before the capture {self.launch_before}, "
              f"after it {launch_after} ({self.card})")
        _require(stopped["bytes"] <= constants.PROFILE_MAX_MB * 1024 * 1024,
                 f"the trace's {stopped['bytes']} bytes pass CDT_PROFILE_MAX_MB")
        if self.cuda:
            _require(kernels, "the trace holds no CUDA kernel event")
            _require(wgmma, "the trace holds no launch of the attention kernel's wgmma instance")
        _require(moved["started"] == 1 and moved["stopped"] == 1 and moved["errors"] == 0,
                 f"cdt_profile_captures_total moved {moved}, not started and stopped +1")
        _require(stopped["id"] in listed, f"GET /distributed/profile lists {listed}")
        _require(listing["capture"]["active"] is None, "a capture outlived its run")
        return {"bytes": stopped["bytes"], "export_s": stopped["export_s"],
                "stop_s": p["stop_s"], "parse_s": parse_s, "events": len(events),
                "kernels": len(kernels), "wgmma": len(wgmma),
                "launch_us": (self.launch_before, launch_after)}

    def check_incident(self, run: int, trace_id: str, spans: list) -> dict:
        from comfyui_distributed_tpu_torch.telemetry.incidents import (
            resolved_knobs,
            validate_bundle,
        )
        from comfyui_distributed_tpu_torch.utils.network import request_json

        incidents = f"{self.base}/distributed/incidents"
        before = _scrape(self.base)[1]
        posted = time.perf_counter()
        status, captured = request_json("POST", f"{incidents}/capture", {
            "key": "chip_smoke", "context": {"trace_id": trace_id, "phase": self.tag}},
            timeout=300)
        capture_s = time.perf_counter() - posted
        _require(status == 200 and captured.get("captured") is True,
                 f"the manual capture answered {status}: {captured}")
        after = _scrape(self.base)[1]
        manual = (_total(after, "cdt_incidents_total", trigger="manual")
                  - _total(before, "cdt_incidents_total", trigger="manual"))
        _, listing = request_json("GET", incidents, timeout=60)
        listed = [entry["id"] for entry in listing.get("incidents", [])]
        got_status, bundle = request_json("GET", f"{incidents}/{captured['id']}", timeout=120)
        _require(got_status == 200 and isinstance(bundle, dict) and bundle.get("id")
                 == captured["id"], f"GET {captured['id']} answered {got_status}")
        problems = validate_bundle(bundle)
        run_span_ids = {s["span_id"] for s in spans}
        closed = {e["data"]["span_id"] for e in bundle["flight"]["spans"]
                  if e["data"].get("trace_id") == trace_id}
        trace = bundle.get("trace") or {}
        trace_ids = {s["span_id"] for s in trace.get("spans", [])}
        sections = ("store", "placement", "scheduler", "health", "fleet", "usage", "slo")
        in_error = [name for name in sections
                    if not isinstance(bundle.get(name), dict) or "error" in bundle[name]]
        knobs_equal = bundle["knobs"] == resolved_knobs()
        # the scrape mirrors the recorder's drops by delta: with the tap
        # lifted nothing publishes into the rings while the scrape runs
        recorder = self.master.flight
        recorder.uninstall()
        try:
            drops = recorder.drop_totals()
            scraped = _scrape(self.base)[1]
        finally:
            recorder.install()
        scraped_drops = {stream: _total(scraped, "cdt_flight_dropped_total", stream=stream)
                         for stream in drops}
        _, w1_listing = request_json("GET", f"{self.worker_base}/distributed/incidents",
                                     timeout=60)
        flight = bundle["flight"]
        print(f"[incident] {self.tag} run {run}: bundle {captured['id']}, {captured['bytes']} "
              f"bytes, captured in {capture_s:.3f} s (the POST); schema problems {problems}; "
              f"flight: {len(flight['events'])} events and {len(flight['spans'])} span closes "
              f"retained, appended {flight['appended']}, dropped {flight['dropped']}; span "
              f"closes of the run's trace {trace_id}: {len(closed & run_span_ids)} of its "
              f"{len(run_span_ids)} spans; trace section {trace.get('trace_id')} with "
              f"{len(trace_ids)} spans (truncated {trace.get('truncated_spans')}); "
              f"{len(bundle['knobs'])} knobs, equal to resolved_knobs(): {knobs_equal}; "
              f"sections in error {in_error} of {list(sections)}; "
              f"cdt_incidents_total{{trigger=\"manual\"}} +{manual:g}; listed "
              f"{captured['id'] in listed}; scraped cdt_flight_dropped_total {scraped_drops}, "
              f"the recorder's {drops}; w1: recorder {self.worker.flight is recorder}, incident "
              f"manager {self.worker.incidents}, its route enabled "
              f"{(w1_listing or {}).get('enabled')} ({self.card})")
        _require(not problems, f"the bundle fails validate_bundle: {problems}")
        _require(run_span_ids and run_span_ids <= closed,
                 f"the bundle's flight spans miss {len(run_span_ids - closed)} of the run's "
                 f"{len(run_span_ids)} span closes")
        _require(trace.get("trace_id") == trace_id and trace_ids == run_span_ids
                 and trace.get("truncated_spans") == 0,
                 f"the bundle's trace section is not the run's execution tree: "
                 f"{trace.get('trace_id')}, {len(trace_ids)} spans")
        _require(knobs_equal, "the bundle's knobs are not resolved_knobs()")
        _require(not in_error, f"bundle sections in error: "
                 f"{ {name: bundle.get(name) for name in in_error} }")
        _require(manual == 1, f"cdt_incidents_total{{trigger=\"manual\"}} rose by {manual:g}")
        _require(listed and listed[0] == captured["id"],
                 f"GET /distributed/incidents lists {listed}")
        _require(scraped_drops == {k: float(v) for k, v in drops.items()},
                 f"scraped cdt_flight_dropped_total {scraped_drops}, the recorder {drops}")
        _require(self.worker.flight is recorder and self.worker.incidents is None
                 and (w1_listing or {}).get("enabled") is False,
                 "w1 lacks the flight recorder, or has an incident manager")
        return {"bytes": captured["bytes"], "capture_s": capture_s,
                "run_spans": len(run_span_ids), "dropped": drops}

    def launch_us(self) -> float | None:
        """Host µs a launch of a one-element add on the card, over
        LAUNCH_PROBES launches (None on the CPU)."""
        if not self.cuda:
            return None
        import torch

        x = torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        started = time.perf_counter()
        for _ in range(LAUNCH_PROBES):
            x.add_(1.0)
        torch.cuda.synchronize()
        return round((time.perf_counter() - started) / LAUNCH_PROBES * 1e6, 3)

    def tap_cost(self) -> dict:
        """Host seconds a tapped publish, against one with no listener."""
        from comfyui_distributed_tpu_torch.telemetry.events import EventBus, get_event_bus

        bus = get_event_bus()
        taps = bus.stats()["taps"]
        seconds = {}
        for name, target in (("taps", bus), ("none", EventBus())):
            started = time.perf_counter()
            for i in range(TAP_PUBLISHES):
                target.publish("metric_delta", metric="cdt_tap_cost", kind="counter",
                               labels={"n": "x"}, value=i)
            seconds[name] = time.perf_counter() - started
        per = {name: s / TAP_PUBLISHES for name, s in seconds.items()}
        print(f"[flight] {self.tag} tap cost: {TAP_PUBLISHES} publishes on the bus with the "
              f"taps {taps} took {seconds['taps']:.4f} s, {per['taps'] * 1e6:.3f} us an event; "
              f"on a bus with no listener {per['none'] * 1e6:.3f} us (host clock, {self.card})")
        _require("flight" in taps, f"the bus's taps {taps} lack the flight recorder")
        return per


def _drain_check(label: str, master, base: str, workflow) -> dict:
    """POST /distributed/scheduler/drain, then a queue request: it must
    answer 503 with a Retry-After, create no job and launch no attention
    kernel; then resume. Prints a [sched] line."""
    from comfyui_distributed_tpu_torch.ops import attention as attn

    store = master.job_store

    def jobs():
        return (sorted(store.tile_jobs), sorted(store.finished), sorted(store.collectors),
                len(master._history))

    status, _, drained = _post_answer(f"{base}/distributed/scheduler/drain", {})
    _require(status == 200 and drained == {"state": "draining"}, f"drain answered {status}: "
             f"{drained}")
    before = jobs()
    attn.reset_launch_counts()
    started = time.perf_counter()
    status, headers, answer = _post_answer(f"{base}/distributed/queue", {
        "prompt": workflow, "client_id": "chip_smoke", "workers": ["w1"]})
    seconds = time.perf_counter() - started
    launches, _ = _launch_counts(attn)
    after = jobs()
    resumed = _post_answer(f"{base}/distributed/scheduler/resume", {})
    print(f"{label} drain: the queue answered {status} in {seconds * 1000:.1f} ms with "
          f"Retry-After {headers.get('retry-after')} ({answer}); jobs, records, collectors and "
          f"prompts before {before[3]} prompt(s), unchanged {before == after}; attention "
          f"launches {launches}; resume answered {resumed[0]} {resumed[2]}")
    _require(status == 503 and int(headers.get("retry-after", "0")) >= 1,
             f"a drained scheduler answered {status}, Retry-After {headers.get('retry-after')}")
    _require(before == after and launches == 0, "a drained scheduler's request made a job or "
             "launched a kernel")
    _require(resumed[0] == 200 and resumed[2] == {"state": "running"}, f"resume: {resumed}")
    return {"status": status, "retry_after": headers.get("retry-after")}


def _fleet_readings(base: str, w1_base: str | None, cuda: bool) -> dict:
    """w1's transfer ledger as the master's fleet holds it (its last
    snapshot's dispatch-bracket ns; 0 before its first snapshot) and, when
    w1 is its own process, its own scrape of
    cdt_device_execute_seconds_sum: read before a run, held to the run by
    `_fleet_check`."""
    from comfyui_distributed_tpu_torch.utils.network import request_json

    _, fleet = request_json("GET", f"{base}/distributed/fleet", timeout=60)
    entry = fleet.get("workers", {}).get("w1")
    kind = "device_ns" if cuda else "eager_ns"
    readings = {"ledger_ns": int(entry["snapshot"]["profiling"][kind]) if entry else 0}
    if w1_base:
        readings["scraped_s"] = _total(_scrape(w1_base)[1], "cdt_device_execute_seconds_sum",
                                       role="worker", tier="scan")
    return readings


def _fleet_check(label: str, base: str, w1_base: str | None, queued: dict, run: int,
                 interval: float, cuda: bool, before: dict) -> None:
    """The master's fleet plane after one elastic run, on a [fleet] line;
    any miss fails the run. /distributed/fleet lists w1 with the
    snapshot's schema version, `devices` 1 and, on the card, a nonzero
    `hbm_peak_bytes` (w1's own reading of its card); /distributed/usage
    attributes the job's chip seconds, w1's part adopted from its
    snapshots and equal to w1's meter as it reported it; when w1 is its
    own process (`w1_base`), that equals w1's transfer ledger over the run
    (`before` from `_fleet_readings`): the ledger's dispatch-bracket ns
    in its snapshot within 1 ns, and on the card w1's own scrape of
    cdt_device_execute_seconds_sum within 1e-6 s; /distributed/alerts has
    no alert firing."""
    from comfyui_distributed_tpu_torch.telemetry import get_usage_meter
    from comfyui_distributed_tpu_torch.utils.network import request_json

    status, fleet = request_json("GET", f"{base}/distributed/fleet", timeout=60)
    _require(status == 200 and fleet.get("enabled") is True, f"/distributed/fleet: {status}")
    entry = fleet["workers"].get("w1")
    _require(entry is not None, f"/distributed/fleet does not list w1: {sorted(fleet['workers'])}")
    snap = entry["snapshot"]
    hbm = int(snap.get("mem", {}).get("hbm_peak_bytes") or 0)
    _require(snap.get("v") == fleet["version"] and snap.get("devices") == 1
             and (hbm > 0 or not cuda),
             f"w1's snapshot: version {snap.get('v')}, devices {snap.get('devices')}, "
             f"hbm_peak_bytes {hbm}")
    job_id = queued["job_ids"][USDU_NODE]
    status, usage = request_json("GET", f"{base}/distributed/usage", timeout=60)
    _require(status == 200 and usage.get("enabled") is True, f"/distributed/usage: {status}")
    job = usage["rollup"]["jobs"].get(job_id)
    _require(job is not None and "worker(adopted)" in job["roles"],
             f"/distributed/usage holds no adopted usage of job {job_id}: {job}")
    local = get_usage_meter().rollup(("master",))["jobs"].get(job_id, {}).get("chip_s", 0.0)
    adopted = job["chip_s"] - local
    reported = snap["usage"]["jobs"].get(job_id, {}).get("chip_s", 0.0)
    _require(adopted > 0 and abs(adopted - reported) <= 1e-6,
             f"job {job_id}: w1's adopted chip seconds {adopted} against its meter's {reported}")
    ledger_line = ""
    if w1_base:
        after = _fleet_readings(base, w1_base, cuda)
        ledger_ns = after["ledger_ns"] - before["ledger_ns"]
        scraped_s = after["scraped_s"] - before["scraped_s"]
        kind = "device_ns" if cuda else "eager_ns"
        ledger_line = (f"; w1's transfer ledger over the run {ledger_ns} ns (its snapshot's "
                       f"{kind}) and {scraped_s:.9f} s (w1's own /distributed/metrics)")
        _require(abs(round(reported * 1e9) - ledger_ns) <= 1
                 and (abs(scraped_s - reported) <= 1e-6 or not cuda),
                 f"job {job_id}: w1's meter {reported} s against its ledger {ledger_ns} ns and "
                 f"its scrape {scraped_s} s")
    status, alerts = request_json("GET", f"{base}/distributed/alerts", timeout=60)
    _require(status == 200 and alerts.get("enabled") is True and alerts["active"] == [],
             f"/distributed/alerts: {status}, firing {alerts.get('active')}")
    print(f"{label} run {run}: /distributed/fleet lists w1 (snapshot v{snap['v']}, devices "
          f"{snap['devices']}, hbm_peak_bytes {hbm}, rss_bytes "
          f"{snap.get('mem', {}).get('rss_bytes')}, seen {entry['seen_ago_s']} s ago; the "
          f"monitor's last rollup {fleet['rollup']['workers']} worker(s), "
          f"{fleet['rollup']['devices']} device(s)); w1 "
          f"runs with CDT_FLEET_SNAPSHOT_SECONDS={interval:g}, so each of its pulls and "
          f"heartbeats carries a snapshot, the heartbeat after its last tile the run's last; "
          f"/distributed/usage job {job_id} chip seconds {job['chip_s']:.9f} = master "
          f"{local:.9f} + w1 adopted {adopted:.9f}; w1's meter as it reported it "
          f"{reported:.9f}{ledger_line}; /distributed/alerts: none firing of "
          f"{len(alerts['alerts'])} SLOs")


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
                   tag: str = "elastic", after=None, drain: bool = False,
                   fleet_interval: float | None = None, incident: bool = False) -> dict:
    """Run the workflow over HTTP on a master and a worker server in this
    process (see the module docstring) and check every run; prints the
    [tag] lines and returns the last run's attention launches. With
    `expected_launches` None (no card) the launch counts go unchecked;
    with `local_out` None the reference is not held against a local run
    of the workflow (an earlier phase did that). `after(servers)`, where
    given, runs once the runs are checked, on the same servers: servers
    is {"master", "worker", "base", "worker_port", "input_dir",
    "output_dir", "reference" (the local tiles composited as the elastic
    master composites them), "reference_avg"} (the local tiles' weighted
    average, as phase 4 composites them); its result is the returned dict's "after".
    With `runs` 0 the servers only serve `after`. Every run is held to
    the control plane on a [sched] line (`_Sched`); with `drain` the last
    run follows a drained scheduler's 503 and a resume (`_drain_check`).
    With `fleet_interval` (a CPU rehearsal of the procs phase's [fleet]
    checks) the in-process w1 piggybacks a snapshot at that interval and
    every run is held to `_fleet_check`. With `incident` the master runs
    with CDT_INCIDENT_DIR and CDT_PROFILE_DIR, every run prints its
    [flight] line, the second run (the only one when `runs` is 1) is
    profiled, and after it the incident plane is held on [profile],
    [incident] and [flight] lines (`_Incident`)."""
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
        from comfyui_distributed_tpu_torch.utils import constants

        snapshot_seconds = constants.FLEET_SNAPSHOT_SECONDS
        if fleet_interval is not None:
            constants.FLEET_SNAPSHOT_SECONDS = fleet_interval
        from comfyui_distributed_tpu_torch.telemetry import profiling

        plane_env = {name: os.environ.get(name) for name in ("CDT_INCIDENT_DIR",
                                                             "CDT_PROFILE_DIR")}
        if incident:
            os.environ["CDT_INCIDENT_DIR"] = os.path.join(tmp, "incidents")
            os.environ["CDT_PROFILE_DIR"] = os.path.join(tmp, "profile")
            profiling.set_profiler_capture(None)  # made anew in this phase's directory
        profiled_run = min(2, runs) if incident else 0
        try:
            with _serving(tmp, {"input_dir": in_dir, "output_dir": out_dir}, device,
                          {ckpt: bundle}) as (master, worker, base, worker_port):
                telemetry = _Telemetry(torch, f"[telemetry] {tag}", base, cuda=cuda)
                sched = _Sched(f"[sched] {tag}", master, base)
                push = _Push(f"[push] {tag}", base, f"http://127.0.0.1:{worker_port}")
                plane = (_Incident(tag, master, worker, base, f"http://127.0.0.1:{worker_port}",
                                   cuda, _nvidia_smi() if cuda else "CPU") if incident else None)
                _require(not incident or master.incidents is not None,
                         "the master has no incident manager with CDT_INCIDENT_DIR set")
                tile_bytes = _tile_output_bytes(workflow, image)
                for run in range(1, runs + 1):
                    if drain and run == runs:
                        result["drain"] = _drain_check(f"[sched] {tag}", master, base, workflow)
                    telemetry.start()
                    sched.start()
                    push.start()
                    if plane is not None:
                        plane.start_run()
                    if cuda:
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats()
                    attn.reset_launch_counts()
                    started = time.perf_counter()
                    if run == profiled_run:
                        plane.launch_before = plane.launch_us()
                        queued, history, _ = plane.profiled_queue(attn, worker_port, workflow)
                    else:
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
                    rate = f"{n_tiles / seconds:.4f} tiles/s"
                    if run == profiled_run:
                        rate += " as profiled (not comparable)"
                    elif local_tiles_per_s is not None:
                        rate += f" (phase 4: {local_tiles_per_s:.4f})"
                    print(f"{label} run {run}: {seconds:.2f} s, {rate}; tiles completed: master "
                          f"{by.get('master', 0)}, w1 {by.get('w1', 0)} (order "
                          f"{record['completions']}, duplicates dropped {record['duplicates']});"
                          f" flash_attention launches {launches}, by instance {by_instance}; "
                          f"peak {peak / 2**30:.2f} GiB; worker tile bytes received "
                          f"{record['received_bytes']}")
                    read = telemetry.check(run, queued, record, tile_bytes)
                    print(f"{label} run {run} stage seconds (cdt_tile_stage_seconds): master "
                          f"{_rounded(read['stage_seconds']['master'])}; w1 "
                          f"{_rounded(read['stage_seconds']['worker'])}")
                    control = sched.check(run, queued, record, read["spans"])
                    result["push"] = push.check(run, queued, record)
                    if fleet_interval is not None:
                        _fleet_check(f"[fleet] {tag}", base, None, queued, run, fleet_interval,
                                     cuda, {})
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
                    result.update({"launches": launches, "launches_by_instance": by_instance,
                                   "host_tax": read["host_tax"],
                                   "queue_wait_s": control["queue_wait_s"],
                                   "grants": control["grants"]})
                    if run != profiled_run:
                        result["tiles_per_s"] = n_tiles / seconds
                    if plane is not None:
                        result.setdefault("flight", []).append(plane.end_run(run))
                    if run == profiled_run:
                        result["profile"] = plane.check_profile(run, n_tiles / seconds)
                        result["incident"] = plane.check_incident(run, queued["trace_id"],
                                                                  read["spans"])
                if plane is not None:
                    result["tap_cost"] = plane.tap_cost()
                if after is not None:
                    result["after"] = after({"master": master, "worker": worker, "base": base,
                                             "worker_port": worker_port, "input_dir": in_dir,
                                             "output_dir": out_dir, "reference": reference,
                                             "reference_avg": reference_avg})
        finally:
            constants.FLEET_SNAPSHOT_SECONDS = snapshot_seconds
            if incident:
                profiling.set_profiler_capture(None)
                for name, value in plane_env.items():
                    if value is None:
                        os.environ.pop(name, None)
                    else:
                        os.environ[name] = value
            if blend_env is None:
                os.environ.pop("CDT_DETERMINISTIC_BLEND", None)
            else:
                os.environ["CDT_DETERMINISTIC_BLEND"] = blend_env
    _require(not runs or tiles_by.get("w1", 0) >= 1,
             f"w1 completed no tile in {runs} runs: {tiles_by}")
    return result


def _wear_lora(workflow, node: dict) -> dict:
    """The workflow with `node` (a LoraLoader, LoraLoaderModelOnly or
    another MODEL patch such as FreeU) as node "lora" after its
    CheckpointLoaderSimple: every MODEL link (and for LoraLoader every
    CLIP link) of the loader goes through it."""
    prompt = copy.deepcopy(workflow)
    loader = _node_id(prompt, "CheckpointLoaderSimple")
    outputs = (0, 1) if node["class_type"] == "LoraLoader" else (0,)
    for other in prompt.values():
        for name, value in other["inputs"].items():
            if isinstance(value, list) and value[0] == loader and value[1] in outputs:
                other["inputs"][name] = ["lora", value[1]]
    prompt["lora"] = node
    return prompt


def _seeded_lora(torch, bundle, gen) -> dict:
    """A seeded kohya LoRA (ADAPTER_RANK, alpha ADAPTER_ALPHA) over every
    2-D weight of the bundle's target map: the backbone and both text
    towers (CLIP-L as lora_te1, as SDXL tools name it). down N(0, 1/I),
    up N(0, ADAPTER_UP_STD^2 / rank): a delta a few percent of a random
    weight's size."""
    from comfyui_distributed_tpu_torch.models.lora import lora_target_map
    from comfyui_distributed_tpu_torch.models.registry import get_config

    te2 = get_config(bundle.te2_name) if bundle.te2_name else None
    targets = lora_target_map(get_config(bundle.model_name), get_config(bundle.te_name), te2)
    params = {part: dict(module.named_parameters()) for part, module in bundle.parts().items()}
    state = {}
    for name, (part, pname) in sorted(targets.items()):
        weight = params.get(part, {}).get(pname)
        if weight is None or weight.ndim != 2 or (te2 is not None and name.startswith("lora_te_")):
            continue
        dim_out, dim_in = weight.shape
        state[f"{name}.lora_down.weight"] = torch.randn(
            (ADAPTER_RANK, dim_in), generator=gen, device=gen.device) / math.sqrt(dim_in)
        state[f"{name}.lora_up.weight"] = torch.randn(
            (dim_out, ADAPTER_RANK), generator=gen, device=gen.device) * (
                ADAPTER_UP_STD / math.sqrt(ADAPTER_RANK))
        state[f"{name}.alpha"] = torch.tensor(float(ADAPTER_ALPHA))
    return state


def _adapters_phase(torch, bundle, ckpt: str, workflow, image, main_out, servers: dict,
                    device: str, gen, expected_launches: int | None = None,
                    expected_by_instance: dict | None = None) -> dict:
    """The `adapters` phase (see the module docstring), on `bundle` served
    by a master and w1 (`servers`), `main_out` its base output: a seeded
    LoRA file in a temporary CDT_LORA_DIR; the workflow locally under
    LoraLoader and under LoraLoaderModelOnly; the unmodified workflow over
    HTTP with `adapters`; an unknown adapter refused; then the tile cache
    cold, warm, at another strength and on the base model; the weights
    fingerprint of a FreeU graph and of LoRA merges; an attention-only
    adapter over HTTP twice. With `expected_launches` None (no card) the
    launch counts go unchecked."""
    from comfyui_distributed_tpu_torch.adapters import cache as tcache
    from comfyui_distributed_tpu_torch.cache import bundle_fingerprint
    from comfyui_distributed_tpu_torch.cache import store as tile_store
    from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
    from comfyui_distributed_tpu_torch.graph.nodes_core import LoraLoaderModelOnly
    from comfyui_distributed_tpu_torch.models import sd_checkpoint as sdc
    from comfyui_distributed_tpu_torch.ops import attention as attn
    from comfyui_distributed_tpu_torch.utils.network import request_json

    cuda = device.startswith("cuda")
    label = "[adapters]"
    smi = _nvidia_smi() if cuda else "no card"
    master, worker = servers["master"], servers["worker"]
    base, worker_port = servers["base"], servers["worker_port"]

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    result: dict = {}
    previous_dir = os.environ.get("CDT_LORA_DIR")
    with tempfile.TemporaryDirectory(prefix="cdt_lora_") as lora_dir:
        os.environ["CDT_LORA_DIR"] = lora_dir
        previous_cache = tile_store.set_tile_cache(None)
        try:
            state = _seeded_lora(torch, bundle, gen)
            nbytes = sdc.save_safetensors(
                state, os.path.join(lora_dir, ADAPTER_NAME + ".safetensors"), dtype=torch.float16)
            modules = len(state) // 3
            partial = {k: v for k, v in state.items() if k.startswith("lora_unet_")
                       and ("_attn1_" in k or "_attn2_" in k)}
            partial_bytes = sdc.save_safetensors(
                partial, os.path.join(lora_dir, ADAPTER_PARTIAL_NAME + ".safetensors"),
                dtype=torch.float16)
            partial_modules = len(partial) // 3
            del state, partial
            print(f"{label} {ADAPTER_NAME}.safetensors: {modules} kohya modules (rank "
                  f"{ADAPTER_RANK}, alpha {ADAPTER_ALPHA}; every 2-D backbone target and both "
                  f"text towers), {nbytes} bytes in f16; {ADAPTER_PARTIAL_NAME}.safetensors: "
                  f"its {partial_modules} attention modules, {partial_bytes} bytes [{smi}]")
            _require(0 < partial_modules < modules, "the attention-only LoRA is empty or whole")

            def local(node) -> dict:
                prompt = _wear_lora(workflow, node)
                del prompt["4"], prompt["6"]  # LoadImage → the seeded image; no SaveImage
                prompt[USDU_NODE]["inputs"]["image"] = image
                context = ExecutionContext(device=device)
                context.pipelines[ckpt] = bundle
                executor = GraphExecutor(context)
                sync()
                attn.reset_launch_counts()
                started = time.perf_counter()
                executor.execute(prompt)
                out = executor.last_results[USDU_NODE][0]
                sync()
                seconds = time.perf_counter() - started
                launches, by_instance = _launch_counts(attn)
                return {"out": out.float(), "seconds": seconds, "launches": launches,
                        "by_instance": by_instance, "lora": executor.last_results["lora"],
                        "merge_s": executor.last_timings["lora"]}

            def check_launches(what: str, launches: int, by_instance: dict) -> None:
                if expected_launches is not None:
                    _require(launches == expected_launches and by_instance == expected_by_instance,
                             f"{what}: {launches} attention launches by instance {by_instance}, "
                             f"expected {expected_launches}, {expected_by_instance}")

            # 1. LoraLoader 0.8/0.8 locally; the cached bundle's targeted
            # weights must come out as they went in
            targeted = {}
            for part, module in bundle.parts().items():
                for pname, param in module.named_parameters():
                    if param.ndim == 2 and part in ("unet", "te", "te2"):
                        targeted[(part, pname)] = param.detach().clone()
            run = local({"class_type": "LoraLoader", "inputs": {
                "model": ["1", 0], "clip": ["1", 1], "lora_name": ADAPTER_NAME,
                "strength_model": ADAPTER_STRENGTH, "strength_clip": ADAPTER_STRENGTH}})
            params = {part: dict(m.named_parameters()) for part, m in bundle.parts().items()}
            changed = [f"{part}.{pname}" for (part, pname), value in targeted.items()
                       if not torch.equal(params[part][pname], value)]
            del targeted
            out = run["out"]
            apart = float((out - main_out.float().to(out.device)).abs().max())
            print(f"{label} LoraLoader {ADAPTER_STRENGTH}/{ADAPTER_STRENGTH} local run: "
                  f"{run['seconds']:.2f} s, merge (the node) {run['merge_s']:.2f} s; output "
                  f"{tuple(out.shape)} vs the base output's max |diff| {apart:.3g} (>= "
                  f"{ADAPTER_MIN_DIFF:.4f}); flash_attention launches {run['launches']}, by "
                  f"instance {run['by_instance']}; base bundle weights changed: {len(changed)} "
                  f"[{smi}]")
            _require(bool(torch.isfinite(out).all()), "non-finite LoraLoader output")
            _require(apart >= ADAPTER_MIN_DIFF, "the LoraLoader output is the base output")
            _require(not changed, f"the cached bundle's weights changed: {changed[:5]}")
            check_launches("LoraLoader", run["launches"], run["by_instance"])
            del run, out

            # 2. LoraLoaderModelOnly 0.8: the output L and the bundle it ran
            run = local({"class_type": "LoraLoaderModelOnly", "inputs": {
                "model": ["1", 0], "lora_name": ADAPTER_NAME,
                "strength_model": ADAPTER_STRENGTH}})
            lora_out, (lora_bundle,) = run["out"], run["lora"]
            print(f"{label} LoraLoaderModelOnly {ADAPTER_STRENGTH} local run: "
                  f"{run['seconds']:.2f} s, merge (the node) {run['merge_s']:.2f} s; "
                  f"flash_attention launches {run['launches']} [{smi}]")
            _require(bool(torch.isfinite(lora_out).all()), "non-finite LoraLoaderModelOnly output")
            check_launches("LoraLoaderModelOnly", run["launches"], run["by_instance"])
            reference, reference_avg = _local_reference(torch, lora_bundle, workflow, image)
            del lora_bundle, run
            avg_diff = float((reference_avg - lora_out.to(reference_avg.device)).abs().max())
            _require(avg_diff <= RERUN_TOLERANCE, f"the reference tiles are not L's ({avg_diff})")

            def http(adapters, what: str, prompt=workflow) -> dict:
                sync()
                attn.reset_launch_counts()
                started = time.perf_counter()
                queued, history, _ = _queue(base, worker_port, prompt,
                                            {"adapters": adapters} if adapters else None)
                sync()
                seconds = time.perf_counter() - started
                launches, by_instance = _launch_counts(attn)
                record = master.job_store.finished[queued["job_ids"][USDU_NODE]]
                out = master.get_job(queued["prompt_id"]).outputs["6"][0]["images"]
                saved = os.path.join(servers["output_dir"], history["outputs"]["6"]["images"][0])
                with open(saved, "rb") as fh:
                    png = fh.read()
                by = {}
                for _, who in record["completions"]:
                    by[who] = by.get(who, 0) + 1
                run = {"out": out, "png": png, "seconds": seconds, "launches": launches,
                       "by_instance": by_instance, "record": record, "by": by,
                       "master": dict(master.execution_context.extras.pop("adapters", {})),
                       "worker": dict(worker.execution_context.extras.pop("adapters", {})),
                       "cache": dict(master.execution_context.extras.pop("tile_cache", {}))}
                n_tiles = record["total"]
                print(f"{label} {what}: {seconds:.2f} s, {n_tiles / seconds:.4f} tiles/s; tiles "
                      f"computed: master {by.get('master', 0)}, w1 {by.get('w1', 0)}, settled "
                      f"from the cache {record['cached']}; flash_attention launches {launches}, "
                      f"by instance {by_instance}; adapters master {run['master']}, w1 "
                      f"{run['worker'].get('worker', {})}; tile cache key {run['cache']} [{smi}]")
                _require(sorted([t for t, _ in record["completions"]] + record["cached"])
                         == list(range(n_tiles)), f"{what}: tiles {record}")
                _require(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
                return run

            wear = [{"name": ADAPTER_NAME, "strength": ADAPTER_STRENGTH}]
            # 3. the unmodified workflow over HTTP wearing the adapter
            run = http(wear, f"over HTTP with adapters {wear}")
            diff = float((run["out"].float() - reference.to(run["out"].device)).abs().max())
            print(f"{label} over HTTP vs L's tiles composited the elastic way max |diff| "
                  f"{diff:.3g} (tolerance {RERUN_TOLERANCE}); L's weighted average vs L "
                  f"{avg_diff:.3g}")
            _require(run["by"].get("w1", 0) >= 1, f"w1 completed no tile: {run['by']}")
            _require(run["record"]["adapters"][0]["name"] == ADAPTER_NAME,
                     f"the job carried no adapter: {run['record']}")
            for who, role in (("master", "master"), ("w1", "worker")):
                patched = run["master" if role == "master" else "worker"]
                _require(not run["by"].get(who) or role in patched,
                         f"{who} sampled tiles without patching its backbone")
            _require(diff <= RERUN_TOLERANCE, "the adapter run disagrees with L's tiles")
            check_launches("over HTTP", run["launches"], run["by_instance"])
            patches = {**run["master"], **run["worker"]}
            result.update(launches=run["launches"], launches_by_instance=run["by_instance"],
                          max_abs_diff=diff,
                          patch_s={role: record["patch_s"] for role, record in patches.items()},
                          operand_bytes=next(iter(patches.values()))["operand_bytes"])
            del reference, reference_avg

            # 4. an unknown adapter: 400, no job
            jobs_before = set(master.job_store.finished)
            status, answer = request_json("POST", f"{base}/distributed/queue", {
                "prompt": workflow, "client_id": "chip_smoke", "workers": ["w1"],
                "adapters": [{"name": "no-such-adapter"}]}, timeout=60)
            print(f"{label} unknown adapter: HTTP {status} {answer}")
            _require(status == 400 and "unknown adapter" in answer.get("error", ""),
                     f"an unknown adapter was answered {status}: {answer}")
            _require(not master.job_store.collectors and not master.job_store.tile_jobs
                     and set(master.job_store.finished) == jobs_before,
                     "the refused request created a job")

            # 5. the tile cache (RAM), master-side only
            tile_store.set_tile_cache(tile_store.TileResultCache(disk_dir=None))
            cold = http(wear, "tile cache cold")
            _require(cold["record"]["cached"] == [], "the cold run found cached tiles")
            warm = http(wear, "tile cache warm")
            n_tiles = warm["record"]["total"]
            _require(warm["record"]["cached"] == list(range(n_tiles)),
                     f"the warm run settled {warm['record']['cached']}")
            _require(warm["launches"] == 0, f"the warm run launched {warm['launches']} times")
            _require(torch.equal(warm["out"], cold["out"]) and warm["png"] == cold["png"],
                     "the warm run's output is not the cold run's")
            other = http([{"name": ADAPTER_NAME, "strength": 0.7}], "tile cache strength 0.7")
            plain = http(None, "tile cache base model")
            _require(other["record"]["cached"] == [] and plain["record"]["cached"] == [],
                     "another strength or the base model hit the cache")
            stats = tile_store.get_tile_cache().stats()
            peak = torch.cuda.max_memory_allocated() if cuda else 0
            print(f"{label} tile cache: cold {n_tiles / cold['seconds']:.4f} tiles/s, warm "
                  f"{n_tiles / warm['seconds']:.4f} tiles/s ({cold['seconds']:.2f} s, "
                  f"{warm['seconds']:.2f} s); weights fingerprint cold "
                  f"{cold['cache'].get('weights_fingerprint_s', 0.0):.3f} s, warm "
                  f"{warm['cache'].get('weights_fingerprint_s', 0.0):.4f} s; stats {stats}; "
                  f"peak over the phase {peak / 2**30:.2f} GiB [{smi}]")
            result.update(cold_tiles_per_s=n_tiles / cold["seconds"],
                          warm_tiles_per_s=n_tiles / warm["seconds"],
                          fingerprint_s=cold["cache"].get("weights_fingerprint_s"),
                          warm_launches=warm["launches"], peak_bytes=peak)

            # 6. the weights fingerprint of graphs that make a new bundle
            # from the cached one: a FreeU view (over HTTP, the cache on)
            # and LoraLoaderModelOnly's outputs (timed directly)
            freeu = http(None, "tile cache FreeU graph", prompt=_wear_lora(workflow, {
                "class_type": "FreeU", "inputs": {"model": ["1", 0], "b1": 1.1, "b2": 1.2,
                                                  "s1": 0.9, "s2": 0.2}}))
            _require(freeu["record"]["cached"] == [], "the FreeU graph hit the base model's tiles")
            fingerprints = {"FreeU": freeu["cache"].get("weights_fingerprint_s")}
            base_params = {id(p) for p in bundle.unet.parameters()}
            new_tensors = {}
            for name in (ADAPTER_NAME, ADAPTER_PARTIAL_NAME):
                (merged,) = LoraLoaderModelOnly().load_lora_model_only(
                    bundle, name, ADAPTER_STRENGTH)
                fresh = [p for p in merged.unet.parameters() if id(p) not in base_params]
                new_tensors[name] = (len(fresh), sum(p.numel() * p.element_size() for p in fresh))
                del fresh
                sync()
                started = time.perf_counter()
                bundle_fingerprint(merged)
                fingerprints[name] = time.perf_counter() - started
                del merged
            print(f"{label} weights fingerprint a job: FreeU graph {fingerprints['FreeU']:.4f} s "
                  f"(its view shares every parameter); LoraLoaderModelOnly {ADAPTER_NAME} "
                  f"{fingerprints[ADAPTER_NAME]:.3f} s ({new_tensors[ADAPTER_NAME][0]} new "
                  f"tensors, {new_tensors[ADAPTER_NAME][1]} bytes), {ADAPTER_PARTIAL_NAME} "
                  f"{fingerprints[ADAPTER_PARTIAL_NAME]:.3f} s ({new_tensors[ADAPTER_PARTIAL_NAME][0]}"
                  f" new tensors, {new_tensors[ADAPTER_PARTIAL_NAME][1]} bytes) [{smi}]")
            _require(0 < new_tensors[ADAPTER_PARTIAL_NAME][0] < new_tensors[ADAPTER_NAME][0],
                     f"the attention-only merge copied {new_tensors}")

            # 7. the attention-only adapter over HTTP, the cache off: its
            # operands and its copies are the covered weights' only
            tile_store.set_tile_cache(None)
            attn_wear = [{"name": ADAPTER_PARTIAL_NAME, "strength": ADAPTER_STRENGTH}]
            first = http(attn_wear, "attention-only adapter, first job")
            second = http(attn_wear, "attention-only adapter, second job")
            apart = float((first["out"].float() - plain["out"].float()).abs().max())
            rerun = float((second["out"].float() - first["out"].float()).abs().max())
            patches = {**second["master"], **second["worker"]}
            operand_bytes = next(iter(patches.values()))["operand_bytes"]
            budget = tcache.get_adapter_cache().budget_bytes
            peak = torch.cuda.max_memory_allocated() if cuda else 0
            print(f"{label} attention-only adapter: vs the base model's output max |diff| "
                  f"{apart:.3g} (>= {ADAPTER_MIN_DIFF:.4f}), second job vs first {rerun:.3g} "
                  f"(tolerance {RERUN_TOLERANCE}); operand bytes {operand_bytes} (budget "
                  f"{budget}); patch seconds the second job "
                  f"{_rounded({role: r['patch_s'] for role, r in patches.items()})}; peak over "
                  f"the phase {peak / 2**30:.2f} GiB [{smi}]")
            _require(apart >= ADAPTER_MIN_DIFF, "the attention-only adapter changed nothing")
            _require(rerun <= RERUN_TOLERANCE, "two attention-only jobs disagree")
            _require(operand_bytes < budget
                     and not any(r["operand_misses"] for r in patches.values()),
                     f"the second attention-only job built its operands again: {patches}")
            result.update(fingerprint_by_graph_s=fingerprints, lora_new_tensors=new_tensors,
                          partial_operand_bytes=operand_bytes,
                          partial_patch_s={role: r["patch_s"] for role, r in patches.items()},
                          partial_tiles_per_s=second["record"]["total"] / second["seconds"],
                          peak_bytes=peak)
        finally:
            tile_store.set_tile_cache(previous_cache)
            if previous_dir is None:
                os.environ.pop("CDT_LORA_DIR", None)
            else:
                os.environ["CDT_LORA_DIR"] = previous_dir
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
                   tag: str = "txt2img", image_px: int = IMAGE_PX,
                   pipelines: dict | None = None, audio: bool = False) -> dict:
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
    the outpainted pixels. `pipelines` (context key → bundle) stands in
    for {the CheckpointLoaderSimple's name: bundle} where the workflow
    loads its parts with the component loaders. Prints the [tag] lines
    and returns the last run's attention launches and the local image at
    the master's seed (`local`). With `expected_launches` None (no card)
    the launch counts go unchecked. With `audio`, the same servers then
    run the collector's audio graph (`_audio_check`, an [audio] line)."""
    import numpy as np

    from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
    from comfyui_distributed_tpu_torch.graph.nodes_core import grow_mask
    from comfyui_distributed_tpu_torch.ops import attention as attn
    from comfyui_distributed_tpu_torch.utils import image as img_utils

    cuda = device.startswith("cuda")
    label = f"[{tag}]"
    if pipelines is None:
        ckpt = workflow[_node_id(workflow, "CheckpointLoaderSimple")]["inputs"]["ckpt_name"]
        pipelines = {ckpt: bundle}
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
        context.pipelines.update(pipelines)
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

        with _serving(tmp, settings, device, pipelines) as (master, worker, base, worker_port):
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
                          "images_per_s": out.shape[0] / seconds, "peak_gib": peak / 2**30,
                          "local": local[seed]}
            if audio:
                result["audio"] = _audio_check(master, base, worker_port, in_dir, out_dir, device)
    return result


def _audio_workflow(parts: int = AUDIO_PARTS) -> dict:
    """A model-free graph of the collector's audio path: DistributedValue
    names each participant's WAV (the master's "master.wav", w1's
    "w1.wav"), LoadAudio reads it, DistributedCollector gathers it beside
    an EmptyImage, AudioBatchDivider splits the combined audio `parts`
    ways, and SaveAudio writes the combined audio and each part."""
    workflow = {
        "1": {"class_type": "DistributedValue",
              "inputs": {"value": "master.wav", "overrides": {"_type": "STRING", "1": "w1.wav"}}},
        "2": {"class_type": "LoadAudio", "inputs": {"audio": ["1", 0]}},
        "3": {"class_type": "EmptyImage",
              "inputs": {"width": 64, "height": 64, "batch_size": 1, "color": 0x336699}},
        "4": {"class_type": "DistributedCollector", "inputs": {"images": ["3", 0],
                                                               "audio": ["2", 0]}},
        "5": {"class_type": "AudioBatchDivider", "inputs": {"audio": ["4", 1],
                                                            "divide_by": parts}},
        "6": {"class_type": "SaveAudio", "inputs": {"audio": ["4", 1],
                                                    "filename_prefix": "combined"}},
    }
    for i in range(parts):
        workflow[str(7 + i)] = {"class_type": "SaveAudio",
                                "inputs": {"audio": ["5", i], "filename_prefix": f"part{i}"}}
    return workflow


def _write_wav(path: str, seed: int, seconds: float = AUDIO_SECONDS) -> None:
    """A seeded 16-bit PCM WAV of AUDIO_CHANNELS channels at AUDIO_RATE."""
    import wave

    import numpy as np

    pcm = np.random.default_rng(seed).integers(-32767, 32768, (int(seconds * AUDIO_RATE),
                                                              AUDIO_CHANNELS), dtype=np.int16)
    with wave.open(path, "wb") as wf:
        wf.setnchannels(AUDIO_CHANNELS)
        wf.setsampwidth(2)
        wf.setframerate(AUDIO_RATE)
        wf.writeframes(pcm.tobytes())


def _audio_check(master, base: str, worker_port: int, in_dir: str, out_dir: str,
                 device: str) -> dict:
    """The collector's audio path over HTTP on a master and w1 in this
    process (`_audio_workflow`), on an [audio] line; any miss fails the
    run: the master's combined waveform is exactly its own WAV followed by
    w1's (LoadAudio's reading of each file), at their sample rate;
    AudioBatchDivider's parts concatenate back to it; every SaveAudio
    file holds what its node saved."""
    import numpy as np

    from comfyui_distributed_tpu_torch.graph import ExecutionContext
    from comfyui_distributed_tpu_torch.graph.nodes_audio import LoadAudio
    from comfyui_distributed_tpu_torch.utils import audio_payload
    from comfyui_distributed_tpu_torch.utils import image as img_utils

    workflow = _audio_workflow()
    for name, seed in (("master.wav", SEED), ("w1.wav", SEED + 1)):
        _write_wav(os.path.join(in_dir, name), seed)
    context = ExecutionContext(device=device)
    loaded = {name: LoadAudio().load(os.path.join(in_dir, name), context)[0]
              for name in ("master.wav", "w1.wav")}
    wave = {name: img_utils.ensure_numpy(a["waveform"]) for name, a in loaded.items()}
    started = time.perf_counter()
    queued, history, _ = _queue(base, worker_port, workflow)
    seconds = time.perf_counter() - started
    outputs = master.get_job(queued["prompt_id"]).outputs
    combined = outputs["6"][0]["audio"]
    got = img_utils.ensure_numpy(combined["waveform"])
    want = np.concatenate([wave["master.wav"], wave["w1.wav"]], axis=-1)
    parts = [img_utils.ensure_numpy(outputs[str(7 + i)][0]["audio"]["waveform"])
             for i in range(AUDIO_PARTS)]
    files = {}
    for node in ["6"] + [str(7 + i) for i in range(AUDIO_PARTS)]:
        name = history["outputs"][node]["audio"][0]
        with np.load(os.path.join(out_dir, name)) as saved:
            files[name] = (np.asarray(saved["waveform"]), int(saved["sample_rate"]))
    envelope = len(audio_payload.encode_audio_payload(wave["w1.wav"], AUDIO_RATE)["data"])
    where = getattr(combined["waveform"], "device", None)
    print(f"[audio] the collector's audio over HTTP, master + w1: {seconds:.2f} s; the master's "
          f"waveform {tuple(wave['master.wav'].shape)} and w1's {tuple(wave['w1.wav'].shape)} "
          f"at {AUDIO_RATE} Hz combined to {tuple(got.shape)} at {combined['sample_rate']} Hz on "
          f"{where}, equal to the master's then w1's: {np.array_equal(got, want)}; w1's audio "
          f"payload {envelope} base64 bytes on its last envelope; AudioBatchDivider's "
          f"{AUDIO_PARTS} parts {[p.shape[-1] for p in parts]} samples, concatenated equal: "
          f"{np.array_equal(np.concatenate(parts, axis=-1), got)}; SaveAudio files "
          f"{sorted(files)}")
    _require(np.array_equal(got, want), "the combined audio is not the master's then w1's")
    _require(combined["sample_rate"] == AUDIO_RATE, f"sample rate {combined['sample_rate']}")
    _require(where is not None and where.type == device.split(":")[0],
             f"the combined audio is on {where}, not {device}")
    _require(np.array_equal(np.concatenate(parts, axis=-1), got),
             "AudioBatchDivider's parts do not concatenate back to its input")
    _require(all(len(p.shape) == 3 and p.shape[-1] > 0 for p in parts),
             f"AudioBatchDivider's parts {[p.shape for p in parts]}")
    saved_all = [files[history["outputs"][node]["audio"][0]]
                 for node in ["6"] + [str(7 + i) for i in range(AUDIO_PARTS)]]
    _require(all(np.array_equal(w, expect) and rate == AUDIO_RATE for (w, rate), expect in
                 zip(saved_all, [got] + parts)), "a SaveAudio file does not hold its audio")
    return {"seconds": seconds, "envelope_bytes": envelope, "samples": int(got.shape[-1])}


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
        if path_name == next(iter(workflows)):
            results[path_name]["gguf"] = _gguf_check(torch, source, workflow, device, settings,
                                                     tmp, size)
        del source, direct_context


def _gguf_check(torch, source, workflow, device: str, settings: dict, tmp: str,
                size: tuple) -> dict:
    """GGUF in the ckpt phase: `source`'s single-file state dict written
    as one GGUF file (Q8_0 for every float tensor whose size is a multiple
    of 32, F16 for the rest), loaded by CheckpointLoaderSimple from
    CDT_CHECKPOINT_DIR in a local run of `workflow`. Every loaded
    parameter must be torch.equal to the plain dequantization
    (models/gguf.py::read_gguf) cast to the module's dtype, which is
    written into `source` for the direct run; the image within
    RERUN_TOLERANCE of the direct run's. Prints the write and load
    rates; the file is deleted."""
    from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
    from comfyui_distributed_tpu_torch.models import gguf
    from comfyui_distributed_tpu_torch.models import sd_checkpoint as sdc
    from comfyui_distributed_tpu_torch.models.registry import get_config
    from comfyui_distributed_tpu_torch.ops import attention as attn

    label = "[ckpt]"
    smi = _nvidia_smi() if device.startswith("cuda") else "no card"
    ckpt = source.model_name
    loader = _node_id(workflow, "CheckpointLoaderSimple")
    started = time.perf_counter()
    tensors = {}
    for key, value in sdc.synthesize_checkpoint(source).items():
        arr = value.detach().float().cpu().numpy()
        tensors[key] = (arr, gguf.GGML_Q8_0 if arr.size % 32 == 0 else gguf.GGML_F16)
    q8 = sum(1 for _, t in tensors.values() if t == gguf.GGML_Q8_0)
    gguf_dir = os.path.join(tmp, "gguf")
    os.makedirs(gguf_dir, exist_ok=True)
    file = os.path.join(gguf_dir, f"{ckpt}.gguf")
    nbytes = gguf.write_gguf(file, tensors)
    write_s = time.perf_counter() - started
    del tensors
    plain = {key: torch.from_numpy(arr) for key, arr in gguf.read_gguf(file).items()}
    te2 = get_config(source.te2_name) if source.te2_name else None
    sdc.load_sd_weights(plain, get_config(ckpt), source.vae.config, get_config(source.te_name),
                        source.parts(), te2_cfg=te2)
    del plain
    direct_context = ExecutionContext(device=device, config={"settings": settings},
                                      pipelines={ckpt: source})
    direct, _, _, _ = _local_run(torch, attn, GraphExecutor(direct_context), workflow, label,
                                 f"{ckpt} the GGUF file's plain dequantization direct", device,
                                 size)
    del direct_context
    previous = os.environ.get("CDT_CHECKPOINT_DIR")
    os.environ["CDT_CHECKPOINT_DIR"] = gguf_dir
    try:
        context = ExecutionContext(device=device, config={"settings": settings})
        executor = GraphExecutor(context)
        image, launches, _, _ = _local_run(torch, attn, executor, workflow, label,
                                           f"{ckpt} loaded from {os.path.basename(file)}",
                                           device, size)
    finally:
        if previous is None:
            os.environ.pop("CDT_CHECKPOINT_DIR", None)
        else:
            os.environ["CDT_CHECKPOINT_DIR"] = previous
    load_s = executor.last_timings[loader]
    wrong = _mismatched_parameters(torch, context.pipelines[ckpt], source)
    diff = float((image - direct.to(image.device)).abs().max())
    os.remove(file)
    print(f"{label} {ckpt} GGUF: {nbytes} bytes ({q8} tensors Q8_0, {len(wrong)} parameters "
          f"not torch.equal to the plain dequantization) written in {write_s:.2f} s, loaded by "
          f"CheckpointLoaderSimple in {load_s:.2f} s ({nbytes / load_s / 1e9:.3f} GB/s); image "
          f"vs the direct run max |diff| {diff:.3g} (tolerance {RERUN_TOLERANCE}); "
          f"flash_attention launches {launches} [{smi}]")
    _require(not wrong, f"GGUF-loaded weights differ from the plain dequantization: {wrong[:5]}")
    _require(diff <= RERUN_TOLERANCE, "the GGUF-loaded image is not the direct run's")
    return {"file_bytes": nbytes, "load_seconds": load_s, "write_seconds": write_s,
            "max_abs_diff": diff}


def _answers(request_json, url: str) -> bool:
    """Whether GET `url` answers 200 (False while nothing listens)."""
    try:
        status, _ = request_json("GET", url, timeout=2)
    except OSError:
        return False
    return status == 200


def _dead(port: int) -> bool:
    with socket.socket() as sock:
        sock.settimeout(1.0)
        return sock.connect_ex(("127.0.0.1", port)) != 0


def _log_tail(path: str, lines: int = 40) -> str:
    try:
        with open(path, encoding="utf-8", errors="replace") as fh:
            return "".join(fh.readlines()[-lines:])
    except OSError as exc:
        return f"(no log: {exc})"


def _procs_phase(torch, gen, workflows: dict, image, device: str,
                 expected: tuple | None = None, rates: dict | None = None,
                 image_px: int = IMAGE_PX) -> dict:
    """The deployment users run: the master in this process and w1 its own
    process, launched through POST /distributed/launch_worker (see the
    module docstring). `workflows` holds the txt2img, inpaint and upscale
    workflows, run unmodified; `image` is the upscale input; `expected` is
    (launches, by instance) of one txt2img image, unchecked when None (no
    card); `rates` the in-process rates printed beside this phase's.
    Returns the phase's numbers. w1 is stopped on the way out, whatever
    happened."""
    from comfyui_distributed_tpu_torch.api.orchestration import media_sync
    from comfyui_distributed_tpu_torch.api.server import DistributedServer
    from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
    from comfyui_distributed_tpu_torch.models import pipeline as pl
    from comfyui_distributed_tpu_torch.models import sd_checkpoint as sdc
    from comfyui_distributed_tpu_torch.ops import attention as attn
    from comfyui_distributed_tpu_torch.utils import config as config_mod
    from comfyui_distributed_tpu_torch.utils import image as img_utils
    from comfyui_distributed_tpu_torch.utils.async_helpers import ServerLoopThread
    from comfyui_distributed_tpu_torch.utils.network import request_json
    from comfyui_distributed_tpu_torch.workers import get_worker_manager
    from comfyui_distributed_tpu_torch.workers.process_manager import (
        descendants,
        is_process_alive,
    )

    cuda = device.startswith("cuda")
    label = "[procs]"
    # the rates of the phases that ran (a phase left out by --phases has none)
    rates = {name: rate for name, rate in (rates or {}).items() if rate is not None}
    results: dict = {}
    saved_env = {k: os.environ.get(k) for k in ("CDT_CHECKPOINT_DIR", "CDT_LOG_DIR",
                                                "CDT_DETERMINISTIC_BLEND",
                                                "CDT_FLEET_SNAPSHOT_SECONDS")}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    tmp = tempfile.mkdtemp(prefix="cdt_procs_")
    dirs = {name: os.path.join(tmp, name) for name in ("ckpt", "master_in", "master_out",
                                                       "w1_in", "w1_out", "logs")}
    for path in dirs.values():
        os.makedirs(path)
    manager = get_worker_manager()
    master = loop = None
    master_config = os.path.join(tmp, "master.json")
    real_check, real_upload = media_sync._check_file, media_sync._upload_file
    try:
        # --- the checkpoint files both processes load ---
        os.environ["CDT_CHECKPOINT_DIR"] = dirs["ckpt"]
        os.environ["CDT_LOG_DIR"] = dirs["logs"]
        loaders = {tag: _node_id(wf, "CheckpointLoaderSimple") for tag, wf in workflows.items()}
        ckpts = {tag: wf[loaders[tag]]["inputs"]["ckpt_name"] for tag, wf in workflows.items()}
        for ckpt in sorted(set(ckpts.values())):
            source = pl.load_pipeline(ckpt, seed=CKPT_SEED, device=device)
            _seed_out_conv(torch, source, gen)
            path = os.path.join(dirs["ckpt"], f"{ckpt}.safetensors")
            sync()
            started = time.perf_counter()
            nbytes = sdc.save_safetensors(sdc.synthesize_checkpoint(source), path,
                                          dtype=torch.float16)
            write_s = time.perf_counter() - started
            print(f"{label} {ckpt}: wrote {os.path.basename(path)} {nbytes} bytes (f16, seeded "
                  f"at {CKPT_SEED}, a seeded out_conv) in {write_s:.2f} s "
                  f"({nbytes / write_s / 1e9:.3f} GB/s)")
            del source
            if cuda:
                torch.cuda.empty_cache()

        # --- configs: w1 a local worker on card 0 with its own config and an
        # empty input directory ---
        master_port, worker_port = _free_port(), _free_port()
        w1_config = os.path.join(tmp, "w1.json")
        config_mod.save_config({"settings": {"input_dir": dirs["w1_in"],
                                             "output_dir": dirs["w1_out"]}}, w1_config)
        extra_args = f"--config {w1_config}" + ("" if cuda else " --platform cpu")
        config_mod.save_config({
            "master": {"host": "127.0.0.1", "cuda_device": 0},
            "workers": [{"id": "w1", "name": "w1", "type": "local", "host": "127.0.0.1",
                         "port": worker_port, "cuda_device": 0, "enabled": True,
                         "extra_args": extra_args}],
            "settings": {"input_dir": dirs["master_in"], "output_dir": dirs["master_out"]},
        }, master_config)
        loop = ServerLoopThread(name="procs-master-loop")
        loop.start()
        master = DistributedServer(port=master_port, is_worker=False, config_path=master_config,
                                   device=device)
        asyncio.run_coroutine_threadsafe(master.start(), loop.loop).result(timeout=60)
        base, w1_base = f"http://127.0.0.1:{master_port}", f"http://127.0.0.1:{worker_port}"

        # --- 1. launch (w1 inherits this environment) ---
        os.environ["CDT_FLEET_SNAPSHOT_SECONDS"] = repr(PROCS_FLEET_SNAPSHOT_S)
        started = time.perf_counter()
        status, launched = request_json("POST", f"{base}/distributed/launch_worker",
                                        {"worker_id": "w1"}, timeout=60)
        _require(status == 200 and launched.get("pid"), f"launch_worker answered {status}: "
                                                         f"{launched}")
        pid = launched["pid"]
        deadline = time.monotonic() + PROCS_LAUNCH_TIMEOUT_S
        while not _answers(request_json, f"{w1_base}/prompt"):
            _require(is_process_alive(pid), "w1 exited before it answered its probe:\n"
                     + _log_tail(launched["log"]))
            _require(time.monotonic() < deadline, f"w1 did not answer its probe within "
                     f"{PROCS_LAUNCH_TIMEOUT_S} s:\n" + _log_tail(launched["log"]))
            time.sleep(0.2)
        ready_s = time.perf_counter() - started
        _, managed = request_json("GET", f"{base}/distributed/managed", timeout=10)
        _, info = request_json("GET", f"{w1_base}/distributed/system_info", timeout=10)
        print(f"{label} launch: w1 pid {pid} (this process {os.getpid()}) answered its probe "
              f"{ready_s:.2f} s after POST /distributed/launch_worker; managed "
              f"{ {k: v.get('pid') for k, v in managed['managed'].items()} }; system_info "
              f"device {info['device']}, cuda_devices {info['cuda_devices']}, pid {info['pid']}")
        _require(managed["managed"].get("w1", {}).get("pid") == pid != os.getpid(),
                 f"/distributed/managed does not list w1 as its own process: {managed}")
        _require(info["pid"] == pid and info["is_worker"], f"w1's system_info: {info}")
        _require(info["device"] == torch.device(device).type and (bool(info["cuda_devices"])
                                                                   or not cuda),
                 f"w1 does not run on the card: {info}")
        request_json("POST", f"{base}/distributed/worker/clear_launching", {"worker_id": "w1"},
                     timeout=10)
        results["launch_to_ready_s"] = ready_s

        def ws_prompts() -> int:
            _, data = request_json("GET", f"{w1_base}/distributed/system_info", timeout=10)
            return int(data["status"]["ws_prompts"])

        def run(workflow, what: str, extra: dict | None = None):
            """One POST /distributed/queue with workers ["w1"], waited for on
            both participants; w1 must have taken its prompt over the
            websocket. (queue answer, master history, w1 history, the master
            prompt's output images, seconds, launches, by instance)."""
            save = _node_id(workflow, "SaveImage")
            taken = ws_prompts()
            master.execution_context.extras.pop("node_cache", None)
            sync()
            attn.reset_launch_counts()
            started_ = time.perf_counter()
            status_, queued = request_json("POST", f"{base}/distributed/queue", {
                "prompt": workflow, "client_id": "chip_smoke", "workers": ["w1"],
                **(extra or {})}, timeout=120)
            _require(status_ == 200, f"{what}: /distributed/queue answered {status_}: {queued}")
            _require(queued.get("workers") == ["w1"], f"{what}: w1 was not dispatched: {queued}")
            limit = time.monotonic() + PROCS_RUN_TIMEOUT_S
            history = _wait_done(request_json, f"{base}/history/{queued['prompt_id']}", limit)
            worker_history = _wait_done(
                request_json, f"{w1_base}/history/{queued['trace_id']}_w0", limit)
            sync()
            seconds = time.perf_counter() - started_
            launches_, by_instance_ = _launch_counts(attn)
            _require(history.get("error") is None, f"{what}: the master's prompt failed: "
                     f"{history.get('error')}")
            _require(worker_history.get("error") is None, f"{what}: w1's prompt failed: "
                     f"{worker_history.get('error')}")
            _require(ws_prompts() == taken + 1,
                     f"{what}: w1 did not take its prompt over the websocket (HTTP fallback)")
            out = master.get_job(queued["prompt_id"]).outputs[save][0]["images"]
            return queued, history, worker_history, out, seconds, launches_, by_instance_

        def local_images(workflow, seeds, tag):
            """The workflow at each seed, run here on the master's loaded
            pipelines (the file's weights): image 0 of each."""
            context = ExecutionContext(device=device, config={"settings": {
                "input_dir": dirs["master_in"], "output_dir": dirs["master_out"]}},
                pipelines=master.execution_context.pipelines)
            executor = GraphExecutor(context)
            seed_node = _node_id(workflow, "DistributedSeed")
            out = {}
            for s in seeds:
                prompt = copy.deepcopy(workflow)
                prompt[seed_node]["inputs"]["seed"] = s
                out[s] = _local_run(torch, attn, executor, prompt, label, f"{tag} seed {s}",
                                    device, (*_image_px(workflow, image_px), 3))[0]
            return out

        # --- 2. fan-out over the websocket: the txt2img workflow, SD1.5 file ---
        t2i = workflows["txt2img"]
        seed = int(t2i[_node_id(t2i, "DistributedSeed")]["inputs"]["seed"])
        size = (*_image_px(t2i, image_px), 3)
        warm = copy.deepcopy(t2i)
        warm[_node_id(warm, "DistributedSeed")]["inputs"]["seed"] = seed + 2
        fan = {}
        for tag_, workflow_ in (("cold", t2i), ("warm", warm)):
            fan[tag_] = run(workflow_, f"fan-out ({tag_})")
        local = local_images(t2i, (seed, seed + 1, seed + 2, seed + 3), "txt2img")
        loader = loaders["txt2img"]
        for tag_, s in (("cold", seed), ("warm", seed + 2)):
            queued, history, worker_history, out, seconds, launches, by_instance = fan[tag_]
            d0 = float((out[0].float() - local[s].to(out.device)).abs().max())
            d1 = float((out[1].float() - local[s + 1].to(out.device)).abs().max())
            beside = (f" (in-process txt2img phase: {rates['txt2img']:.4f})"
                      if "txt2img" in rates else "")
            print(f"{label} fan-out {tag_} (seed {s}): {seconds:.2f} s, "
                  f"{out.shape[0] / seconds:.4f} images/s{beside}; file loads "
                  f"(CheckpointLoaderSimple seconds) master "
                  f"{history['timings'].get(loader, 0.0):.2f}, w1 "
                  f"{worker_history['timings'].get(loader, 0.0):.2f}; master launches "
                  f"{launches}, by instance {by_instance}; output {tuple(out.shape)}; max |diff| "
                  f"image 0 vs the local seed {s} {d0:.3g}, image 1 (w1) vs the local seed "
                  f"{s + 1} {d1:.3g}")
            _require(tuple(out.shape) == (2, *size), f"fan-out output {tuple(out.shape)}")
            _require(bool(torch.isfinite(out).all()), "non-finite fan-out output")
            _require(d0 <= RERUN_TOLERANCE, "the master's image is not the local seed's")
            _require(d1 <= RERUN_TOLERANCE + PNG_STEP, "w1's image is not the local seed's")
            if expected is not None:
                _require((launches, by_instance) == expected,
                         f"the master launched {launches} {by_instance}, not one image's "
                         f"{expected}")
        results["fan_out_images_per_s"] = 2 / fan["warm"][4]

        # --- 3. load balance: one worker takes the whole prompt ---
        before = (len(master._history), set(master.job_store.collectors))
        attn.reset_launch_counts()
        started = time.perf_counter()
        status, answer = request_json("POST", f"{base}/distributed/queue", {
            "prompt": t2i, "client_id": "chip_smoke", "workers": ["w1"],
            "load_balance": True}, timeout=120)
        _require(status == 200 and answer.get("mode") == "load_balance"
                 and answer.get("worker") == "w1", f"load balance answered {status}: {answer}")
        worker_history = _wait_done(request_json, f"{w1_base}/history/{answer['trace_id']}_lb",
                                    time.monotonic() + PROCS_RUN_TIMEOUT_S)
        seconds = time.perf_counter() - started
        launches, _ = _launch_counts(attn)
        _require(worker_history.get("error") is None, f"w1's load-balanced prompt failed: "
                 f"{worker_history.get('error')}")
        _require(len(master._history) == before[0] and master.queue_remaining == 0,
                 "the master queued a prompt of its own under load balance")
        new_jobs = sorted(set(master.job_store.collectors) - before[1])
        _require(len(new_jobs) == 1, f"w1's image did not reach the master: jobs {new_jobs}")

        async def take(job_id):
            job = master.job_store.collectors[job_id]
            item = job.queue.get_nowait()
            await master.job_store.cleanup_collector(job_id)
            return item

        item = asyncio.run_coroutine_threadsafe(take(new_jobs[0]), loop.loop).result(timeout=30)
        lb_image = torch.as_tensor(item["tensor"]).float()
        d1 = float((lb_image - local[seed + 1].cpu()).abs().max())
        print(f"{label} load balance: {seconds:.2f} s to w1's last envelope ({answer}); master "
              f"prompts queued 0, launches {launches}; w1's image over HTTP vs the local seed "
              f"{seed + 1} (worker_index 0) max |diff| {d1:.3g}")
        _require(launches == 0, f"the master launched {launches} attention kernels")
        _require(d1 <= RERUN_TOLERANCE + PNG_STEP, "w1's load-balanced image is not its seed's")

        # --- 4. delegate-only master ---
        status, _ = request_json("POST", f"{base}/distributed/config/setting",
                                 {"name": "master_delegate_only", "value": True}, timeout=10)
        _require(status == 200, "the delegate setting was refused")
        queued, history, _, out, seconds, launches, _ = run(t2i, "delegate")
        request_json("POST", f"{base}/distributed/config/setting",
                     {"name": "master_delegate_only", "value": False}, timeout=10)
        classes = sorted({n["class_type"] for n in master.get_job(queued["prompt_id"])
                          .prompt.values()})
        d1 = float((out[0].float() - local[seed + 1].to(out.device)).abs().max())
        print(f"{label} delegate: {seconds:.2f} s; the master's prompt {classes}, launches "
              f"{launches}; output {tuple(out.shape)}, w1's image vs the local seed {seed + 1} "
              f"max |diff| {d1:.3g}")
        _require(not set(classes) & set(SAMPLERS) and launches == 0,
                 "the delegate master sampled")
        _require(tuple(out.shape) == (1, *size), f"delegate output {tuple(out.shape)}")
        _require(d1 <= RERUN_TOLERANCE + PNG_STEP, "the delegated image is not w1's seed's")

        # --- 5. media sync into w1's empty input directory ---
        inp = workflows["inpaint"]
        for load in _node_ids(inp, "LoadImage"):
            with open(os.path.join(dirs["master_in"], inp[load]["inputs"]["image"]), "wb") as fh:
                fh.write(img_utils.encode_png(_inpaint_input(image_px, SEED)))
        names = sorted({name for _, _, name in media_sync.find_media_references(inp)})
        _require(os.listdir(dirs["w1_in"]) == [], "w1's input directory is not empty")
        calls = {"checks": [], "uploads": []}

        async def checking(worker, filename, md5):
            matched = await real_check(worker, filename, md5)
            calls["checks"].append((filename, matched))
            return matched

        async def uploading(worker, path, filename):
            calls["uploads"].append(filename)
            return await real_upload(worker, path, filename)

        media_sync._check_file, media_sync._upload_file = checking, uploading
        inp_seed = int(inp[_node_id(inp, "DistributedSeed")]["inputs"]["seed"])
        inp_local = None
        for attempt in (1, 2):
            calls["checks"].clear()
            calls["uploads"].clear()
            _, _, _, out, seconds, _, _ = run(inp, f"media sync run {attempt}")
            if inp_local is None:
                inp_local = local_images(inp, (inp_seed, inp_seed + 1), "inpaint")
            synced = {name: media_sync.file_md5(os.path.join(dirs["w1_in"], name))
                      if os.path.isfile(os.path.join(dirs["w1_in"], name)) else None
                      for name in names}
            want = {name: media_sync.file_md5(os.path.join(dirs["master_in"], name))
                    for name in names}
            d0 = float((out[0].float() - inp_local[inp_seed].to(out.device)).abs().max())
            d1 = float((out[1].float() - inp_local[inp_seed + 1].to(out.device)).abs().max())
            print(f"{label} media sync run {attempt}: {seconds:.2f} s; check_file "
                  f"{calls['checks']}, uploads {calls['uploads']}; w1's input directory "
                  f"{sorted(os.listdir(dirs['w1_in']))}, md5 equal to the master's "
                  f"{synced == want}; image 0 vs the local seed {inp_seed} {d0:.3g}, image 1 "
                  f"(w1) vs the local seed {inp_seed + 1} {d1:.3g}")
            _require(synced == want, f"w1's files {synced}, the master's {want}")
            _require(d0 <= RERUN_TOLERANCE, "the master's inpaint image is not its seed's")
            _require(d1 <= RERUN_TOLERANCE + PNG_STEP, "w1's inpaint image is not its seed's")
            if attempt == 1:
                _require(sorted(calls["uploads"]) == names, f"uploads {calls['uploads']}")
            else:
                _require(calls["uploads"] == [] and len(calls["checks"]) == len(names)
                         and all(m for _, m in calls["checks"]),
                         f"the second run uploaded again: {calls}")
        media_sync._check_file, media_sync._upload_file = real_check, real_upload

        # --- 6. elastic over the worker process: the upscale workflow, SDXL file ---
        up = workflows["upscale"]
        with open(os.path.join(dirs["master_in"], up["4"]["inputs"]["image"]), "wb") as fh:
            fh.write(img_utils.encode_png(image[0].float().cpu().numpy()))
        os.environ["CDT_DETERMINISTIC_BLEND"] = "1"
        outs, tiles_by = [], {}
        telemetry = _Telemetry(torch, "[telemetry] procs", base, w1_base, cuda=cuda)
        sched = _Sched("[sched] procs", master, base)
        push = _Push("[push] procs", base, w1_base)
        tile_bytes = _tile_output_bytes(up, image)
        for attempt in (1, 2):
            telemetry.start()
            sched.start()
            push.start()
            fleet_before = _fleet_readings(base, w1_base, cuda)
            queued, history, worker_history, out, seconds, launches, by_instance = run(
                up, f"elastic run {attempt}")
            record = master.job_store.finished[queued["job_ids"][USDU_NODE]]
            n_tiles = record["total"]
            by = {}
            for _, who in record["completions"]:
                by[who] = by.get(who, 0) + 1
                tiles_by[who] = tiles_by.get(who, 0) + 1
            beside = ", ".join(f"{name} {rates[name]:.4f}" for name in ("elastic", "main")
                               if name in rates)
            print(f"{label} elastic run {attempt}: {seconds:.2f} s, {n_tiles / seconds:.4f} "
                  f"tiles/s (in-process: {beside or 'not run'}); tiles completed: master "
                  f"{by.get('master', 0)}, w1 {by.get('w1', 0)}; file loads master "
                  f"{history['timings'].get(loaders['upscale'], 0.0):.2f} s, w1 "
                  f"{worker_history['timings'].get(loaders['upscale'], 0.0):.2f} s; master "
                  f"launches {launches}")
            _require(sorted(t for t, _ in record["completions"]) == list(range(n_tiles)),
                     f"tiles completed {record['completions']}, expected each once")
            _require(set(by) <= {"master", "w1"}, f"unexpected participants {sorted(by)}")
            read = telemetry.check(attempt, queued, record, tile_bytes)
            print(f"{label} elastic run {attempt} stage seconds (cdt_tile_stage_seconds): "
                  f"master {_rounded(read['stage_seconds']['master'])}; w1 "
                  f"{_rounded(read['stage_seconds']['worker'])}")
            control = sched.check(attempt, queued, record, read["spans"])
            results["push"] = push.check(attempt, queued, record)
            _fleet_check("[fleet] procs", base, w1_base, queued, attempt,
                         PROCS_FLEET_SNAPSHOT_S, cuda, fleet_before)
            results["grants"] = control["grants"]
            results["queue_wait_s"] = control["queue_wait_s"]
            outs.append(out)
            results["elastic_tiles_per_s"] = n_tiles / seconds
            results["host_tax"] = read["host_tax"]
        _require(tiles_by.get("w1", 0) >= 1, f"w1 completed no tile: {tiles_by}")
        reference, _ = _local_reference(torch, master.execution_context.pipelines[ckpts["upscale"]],
                                        up, image)
        for attempt, out in enumerate(outs, 1):
            diff = float((out.float() - reference.to(out.device)).abs().max())
            print(f"{label} elastic run {attempt} output {tuple(out.shape)}: max |diff| vs the "
                  f"local tiles composited alike {diff:.3g} (tolerance {RERUN_TOLERANCE})")
            _require(tuple(out.shape) == tuple(reference.shape), "elastic output shape")
            _require(diff <= RERUN_TOLERANCE, "the elastic output disagrees with the local tiles")
        def quarantine_run():
            queued_, _, _, out_, seconds_, _, _ = run(up, "quarantine run")
            return queued_, out_, seconds_

        results["quarantine"] = _quarantine_run(master, base, w1_base, quarantine_run, reference,
                                                push)
        os.environ.pop("CDT_DETERMINISTIC_BLEND", None)

        # --- 7. cancel a running elastic job; clear_memory ---
        status, queued = request_json("POST", f"{base}/distributed/queue", {
            "prompt": up, "client_id": "chip_smoke", "workers": ["w1"]}, timeout=120)
        _require(status == 200 and queued.get("workers") == ["w1"], f"queue: {queued}")
        job_id = queued["job_ids"][USDU_NODE]
        limit = time.monotonic() + PROCS_RUN_TIMEOUT_S
        while True:
            _, state = request_json("GET", f"{base}/distributed/queue_status/{job_id}",
                                    timeout=10)
            if state.get("tile_job"):
                break
            _require(time.monotonic() < limit, "the elastic job never started")
            time.sleep(0.02)
        status, accounting = request_json("POST", f"{base}/distributed/cancel/{job_id}",
                                          {"reason": "chip_smoke"}, timeout=30)
        _require(status == 200 and accounting.get("status") == "cancelled",
                 f"cancel answered {status}: {accounting}")
        history = _wait_done(request_json, f"{base}/history/{queued['prompt_id']}", limit)
        worker_history = _wait_done(request_json, f"{w1_base}/history/{queued['trace_id']}_w0",
                                    limit)
        record = master.job_store.finished[job_id]
        refunded = accounting["pending_refunded"] + accounting["in_flight_refunded"]
        unknown = request_json("POST", f"{base}/distributed/cancel/no_such_job", {}, timeout=10)
        print(f"{label} cancel: {accounting}; completed before the cancel "
              f"{len(record['completions'])} of {record['total']}; the master's prompt "
              f"{history.get('error')!r}; w1's prompt done, error {worker_history.get('error')!r}"
              f"; an unknown job answers {unknown[0]}")
        _require(refunded >= 1 and refunded + len(record["completions"]) == record["total"],
                 "the cancel did not account every pending and in-flight tile")
        _require("JobCancelled" in str(history.get("error")), "the master's prompt did not end "
                 "cancelled")
        _require(unknown[0] == 404, f"an unknown job answered {unknown}")
        status, _ = request_json("POST", f"{w1_base}/distributed/clear_memory", {}, timeout=60)
        _, info = request_json("GET", f"{w1_base}/distributed/system_info", timeout=10)
        _require(status == 200 and info["status"]["pipelines"] == [],
                 f"clear_memory left w1 holding {info['status']['pipelines']}")
        _, _, worker_history, out, seconds, _, _ = run(t2i, "after clear_memory")
        _, info = request_json("GET", f"{w1_base}/distributed/system_info", timeout=10)
        d1 = float((out[1].float() - local[seed + 1].to(out.device)).abs().max())
        reload_s = worker_history["timings"].get(loader, 0.0)
        print(f"{label} clear_memory: w1's pipelines emptied; the next run loaded "
              f"{info['status']['pipelines']} again in {reload_s:.2f} s; w1's image vs the "
              f"local seed {seed + 1} max |diff| {d1:.3g}")
        _require(ckpts["txt2img"] in info["status"]["pipelines"] and reload_s > 0.0,
                 "w1 did not load its file again")
        _require(d1 <= RERUN_TOLERANCE + PNG_STEP, "w1's image after clear_memory differs")

        # --- 8. stop ---
        tree = [pid] + descendants(pid)
        status, stopped = request_json("POST", f"{base}/distributed/stop_worker",
                                       {"worker_id": "w1"}, timeout=60)
        _, managed = request_json("GET", f"{base}/distributed/managed", timeout=10)
        # w1 is the master's child and reaped; a child of w1's left as a
        # zombie for init to reap is not running
        alive = [p for p in tree if (p == pid and os.path.exists(f"/proc/{p}"))
                 or is_process_alive(p)]
        print(f"{label} stop: {stopped}; w1's port dead {_dead(worker_port)}; its processes "
              f"{tree} left in /proc {alive}; managed {managed['managed']}")
        _require(status == 200 and stopped.get("stopped") is True, f"stop_worker: {stopped}")
        _require(_dead(worker_port), "w1's port still answers")
        _require(alive == [], f"w1's processes outlived the stop: {alive}")
        _require(managed["managed"] == {}, f"managed_processes not empty: {managed}")
        return results
    finally:
        media_sync._check_file, media_sync._upload_file = real_check, real_upload
        if manager.managed_processes(master_config).get("w1"):
            manager.stop_worker("w1", master_config)
        if master is not None:
            asyncio.run_coroutine_threadsafe(master.stop(), loop.loop).result(timeout=60)
            master.execution_context.pipelines.clear()
        if loop is not None:
            loop.stop()
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        shutil.rmtree(tmp, ignore_errors=True)
        if cuda:
            torch.cuda.empty_cache()


def _quarantine_run(master, base: str, w1_base: str, run, reference, push: _Push) -> dict:
    """One more elastic run (`run()`: queue the upscale workflow with
    workers ["w1"] and wait, → (queue answer, the master's output,
    seconds)) in which the master's breaker
    quarantines w1 (record_failure up to its threshold) as soon as w1
    holds a grant, on a [quarantine] line; any miss fails the run. w1's
    in-flight tiles must be back on the queue when the quarantine returns
    (the breaker's requeue binding, off the loop, waits for it): counted
    in cdt_store_requeued_tasks_total{reason="quarantine"} by then, and
    announced by a grant_available event (w1 may pull again at once: the
    breaker trims a quarantined worker only from the job's tail); every tile is completed once, w1's copies
    of the requeued tiles count as dropped duplicates (first result
    wins), the output is within RERUN_TOLERANCE of `reference` (the local
    tiles composited alike), and the run's [push] checks hold. w1 is
    pardoned afterwards, whatever happened."""
    import threading

    from comfyui_distributed_tpu_torch.resilience.health import get_health_registry
    from comfyui_distributed_tpu_torch.telemetry import get_event_bus

    label = "[quarantine]"
    store = master.job_store
    registry = get_health_registry()
    announced: list = []
    remove_tap = get_event_bus().add_tap(
        lambda event: announced.append(event["data"]) if event["type"] == "grant_available"
        else None, name="chip_smoke")
    done: dict = {}

    def queue_and_wait():
        try:
            done["run"] = run()
        except BaseException as exc:  # noqa: BLE001 - raised on the main thread
            done["error"] = exc

    async def w1_tiles():
        for job in store.tile_jobs.values():
            held = sorted(t for t in job.assigned.get("w1", ()) if t not in job.completed)
            if held:
                return job.job_id, held
        return None

    before = _scrape(base)[1]
    push.start()
    thread = threading.Thread(target=queue_and_wait, name="chip-smoke-quarantine")
    try:
        thread.start()
        held = None
        deadline = time.monotonic() + PROCS_RUN_TIMEOUT_S
        while held is None and thread.is_alive() and time.monotonic() < deadline:
            held = asyncio.run_coroutine_threadsafe(w1_tiles(), master.loop).result(timeout=30)
            if held is None:
                time.sleep(0.005)
        _require(held is not None, "w1 never held a grant in the quarantine run")
        job_id, in_flight = held
        started = time.perf_counter()
        for _ in range(registry.failure_threshold):
            registry.record_failure("w1")
        quarantine_s = time.perf_counter() - started
        state = registry.state("w1").value
        requeued = _total(_scrape(base)[1], "cdt_store_requeued_tasks_total", worker_id="w1",
                          reason="quarantine") - _total(before, "cdt_store_requeued_tasks_total",
                                                        worker_id="w1", reason="quarantine")
        left = asyncio.run_coroutine_threadsafe(w1_tiles(), master.loop).result(timeout=30)
        after_quarantine = [a for a in announced if a.get("job_id") == job_id]
        thread.join(timeout=PROCS_RUN_TIMEOUT_S)
        _require(not thread.is_alive(), "the quarantine run did not finish")
        if "error" in done:
            raise done["error"]
    finally:
        remove_tap()
        registry.pardon("w1")
    queued, out, seconds = done["run"]
    record = store.finished[queued["job_ids"][USDU_NODE]]
    by = {}
    for _, who in record["completions"]:
        by[who] = by.get(who, 0) + 1
    diff = float((out.float() - reference.to(out.device)).abs().max())
    print(f"{label} w1 held tiles {in_flight} of job {job_id} when the breaker quarantined it "
          f"({registry.failure_threshold} failures in {quarantine_s:.4f} s, state {state}); "
          f"cdt_store_requeued_tasks_total{{worker_id=\"w1\",reason=\"quarantine\"}} "
          f"+{requeued:g} when they returned; held by w1 next: {left}; grant_available events for the job "
          f"{after_quarantine}; run {seconds:.2f} s, tiles completed: master "
          f"{by.get('master', 0)}, w1 {by.get('w1', 0)} (order {record['completions']}), "
          f"duplicates dropped {record['duplicates']}; output max |diff| vs the local tiles "
          f"composited alike {diff:.3g} (tolerance {RERUN_TOLERANCE}); w1 pardoned, now "
          f"{registry.state('w1').value}")
    _require(state == "quarantined", f"w1's breaker is {state} after the failures")
    _require(requeued == len(in_flight),
             f"{requeued:g} tiles requeued for the quarantine, w1 held {in_flight}")
    _require(any(a.get("tasks") == len(in_flight) for a in after_quarantine),
             f"no grant_available announced the requeued tiles: {after_quarantine}")
    _require(sorted(t for t, _ in record["completions"]) == list(range(record["total"])),
             f"tiles completed {record['completions']}, expected each once")
    _require(record["duplicates"] == len(in_flight),
             f"{record['duplicates']} duplicates dropped, expected w1's {len(in_flight)} "
             f"late copies")
    _require(tuple(out.shape) == tuple(reference.shape) and diff <= RERUN_TOLERANCE,
             "the quarantine run's output disagrees with the local tiles")
    _require(registry.state("w1").value == "healthy", "w1 was not pardoned")
    result = {"requeued": requeued, "in_flight": in_flight, "seconds": seconds,
              "duplicates": record["duplicates"]}
    result["push"] = push.check("quarantine", queued, record)
    return result


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


def _merges_check(torch, workflow, device: str, gen) -> dict:
    """Merges in the nodes phase, on two SD1.5 bundles of the txt2img
    workflow's checkpoint, seeded at 0 and MERGE_SEED (each with a seeded
    out_conv): ModelMergeSimple and CLIPMergeSimple at ratio 1.0 give
    model1's (clip1's) weights exactly; at 0.5, in the workflow (a second
    CheckpointLoaderSimple, the merge node before every MODEL or CLIP
    link), the image is at least MERGE_MIN_DIFF from each parent's."""
    from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
    from comfyui_distributed_tpu_torch.graph.nodes_loaders import (
        CLIPMergeSimple,
        ModelMergeSimple,
    )
    from comfyui_distributed_tpu_torch.models import pipeline as pl
    from comfyui_distributed_tpu_torch.ops import attention as attn

    label = "[nodes]"
    smi = _nvidia_smi() if device.startswith("cuda") else "no card"
    loader = _node_id(workflow, "CheckpointLoaderSimple")
    ckpt = workflow[loader]["inputs"]["ckpt_name"]
    second = f"{ckpt}-merge-b"
    size = (*_image_px(workflow), 3)
    parents = []
    for seed in (0, MERGE_SEED):
        bundle = pl.load_pipeline(ckpt, seed=seed, device=device)
        _seed_out_conv(torch, bundle, gen)
        parents.append(bundle)
    a, b = parents
    (whole,) = ModelMergeSimple().merge(a, b, 1.0)
    (whole_clip,) = CLIPMergeSimple().merge(a, b, 1.0)
    same = [(m1, m2) for m1, m2 in ((whole.unet, a.unet), (whole_clip.text_encoder,
                                                           a.text_encoder))
            if all(torch.equal(p, q) for p, q in zip(m1.parameters(), m2.parameters()))]
    del whole, whole_clip

    def run(merge: str | None, what: str, ckpt_name: str = ckpt):
        prompt = copy.deepcopy(workflow)
        prompt[loader]["inputs"]["ckpt_name"] = ckpt_name
        if merge is not None:
            output = 0 if merge == "ModelMergeSimple" else 1
            for node in prompt.values():
                for name, value in node["inputs"].items():
                    if value == [loader, output]:
                        node["inputs"][name] = ["merge", 0]
            first, other = ("model1", "model2") if output == 0 else ("clip1", "clip2")
            prompt["b"] = {"class_type": "CheckpointLoaderSimple",
                           "inputs": {"ckpt_name": second}}
            prompt["merge"] = {"class_type": merge, "inputs": {
                first: [loader, output], other: ["b", output], "ratio": MERGE_RATIO}}
        context = ExecutionContext(device=device, pipelines={ckpt: a, second: b})
        executor = GraphExecutor(context)
        image, _, _, seconds = _local_run(torch, attn, executor, prompt, label, what, device, size)
        return image, executor.last_timings.get("merge")

    images = {"model1": run(None, f"{ckpt} seed 0")[0],
              "model2": run(None, f"{ckpt} seed {MERGE_SEED}", second)[0]}
    result = {"ratio_1_exact": len(same) == 2}
    for merge in ("ModelMergeSimple", "CLIPMergeSimple"):
        image, merge_s = run(merge, f"{merge} {MERGE_RATIO}")
        apart = {parent: float((image - ref.to(image.device)).abs().max())
                 for parent, ref in images.items()}
        print(f"{label} {merge}: ratio 1.0 gives model1's weights exactly: "
              f"{result['ratio_1_exact']}; ratio {MERGE_RATIO} merge {merge_s:.2f} s, the image "
              f"vs each parent's max |diff| {apart} (>= {MERGE_MIN_DIFF:.4f}) [{smi}]")
        _require(min(apart.values()) >= MERGE_MIN_DIFF, f"the {merge} image is a parent's")
        result[merge] = {"merge_s": merge_s, "apart": apart}
    _require(result["ratio_1_exact"], "a merge at ratio 1.0 is not model1's weights")
    return result


def _flux_model(workflow) -> str:
    """The registry name of a Flux workflow's backbone: its
    CheckpointLoaderSimple's or UNETLoader's."""
    from comfyui_distributed_tpu_torch.graph.nodes_loaders import _stem

    for cls, key in (("CheckpointLoaderSimple", "ckpt_name"), ("UNETLoader", "unet_name")):
        ids = _node_ids(workflow, cls)
        if ids:
            return _stem(workflow[ids[0]]["inputs"][key])
    raise RuntimeError("chip_smoke check failed: the workflow loads no diffusion model")


def _flux_pipelines(workflow, bundle) -> dict:
    """The execution-context entries a Flux workflow's loaders resolve, all
    one bundle: CheckpointLoaderSimple's name, UNETLoader's "unet:<name>"
    and DualCLIPLoader's "clip:flux:<names>" (the bundle's T5 and CLIP-L;
    VAELoader builds the VAE the bundle's seed gives it)."""
    from comfyui_distributed_tpu_torch.graph.nodes_loaders import _stem

    model = _flux_model(workflow)
    out = {model: bundle, f"unet:{model}": bundle}
    for node_id in _node_ids(workflow, "DualCLIPLoader"):
        inputs = workflow[node_id]["inputs"]
        out["clip:flux:" + ",".join(_stem(inputs[k]) for k in ("clip_name1", "clip_name2"))] = bundle
    return out


def _flux_evals(workflow) -> int:
    """MMDiT evaluations of one image of a Flux workflow, each at batch 1
    (a KSampler at cfg 1, a SamplerCustomAdvanced under BasicGuider over a
    full grid ending at sigma 0)."""
    from comfyui_distributed_tpu_torch.ops.samplers import model_evals_per_scan

    evals = 0
    for node_id in _node_ids(workflow, "KSampler"):
        inputs = workflow[node_id]["inputs"]
        _require(float(inputs["cfg"]) == 1.0 and float(inputs["denoise"]) == 1.0,
                 "the Flux shapes assume a KSampler at cfg 1 (batch 1) and denoise 1")
        evals += model_evals_per_scan(inputs["sampler_name"], int(inputs["steps"]))
    for node_id in _node_ids(workflow, "SamplerCustomAdvanced"):
        inputs = workflow[node_id]["inputs"]
        guider = workflow[str(inputs["guider"][0])]
        schedule = workflow[str(inputs["sigmas"][0])]
        _require(guider["class_type"] == "BasicGuider", "the Flux shapes assume BasicGuider")
        _require(schedule["class_type"] in ("BasicScheduler", "BetaSamplingScheduler")
                 and float(schedule["inputs"].get("denoise", 1.0)) == 1.0,
                 f"the Flux shapes assume a full grid, not {schedule['class_type']}'s")
        sampler = workflow[str(inputs["sampler"][0])]["inputs"]["sampler_name"]
        evals += model_evals_per_scan(sampler, int(schedule["inputs"]["steps"]))
    return evals


def _flux_shapes(workflow, image_px: int = FLUX_IMAGE_PX):
    """(label, q shape, M, calls) of one image of a Flux workflow: the
    joint attention of every double and single block at each evaluation,
    over T5's 512 tokens, the image's 2x2 patches and each ReferenceLatent's
    (its LoadImage input of `image_px`), then the 16-channel VAE's
    mid-block at the decode and at each VAEEncode."""
    from comfyui_distributed_tpu_torch.models.registry import HIDDEN_POOLED_ENCODERS, get_config

    from comfyui_distributed_tpu_torch.models.pipeline import _family_vae_name

    model = _flux_model(workflow)
    cfg, vae_cfg = get_config(model), get_config(_family_vae_name(model))
    t5 = get_config(HIDDEN_POOLED_ENCODERS[model][0])
    height, width = _image_px(workflow, image_px)
    _require(height == width == image_px, f"a {height}x{width} image: the shapes assume "
                                          f"{image_px} square, as the reference")
    per_token = vae_cfg.downscale * cfg.patch_size  # pixels a side of an image token
    refs = len(_node_ids(workflow, "ReferenceLatent"))
    tokens = t5.max_length + (1 + refs) * (height // per_token) ** 2
    calls = (cfg.double_depth + cfg.single_depth) * _flux_evals(workflow)
    vae_calls = 1 + len(_node_ids(workflow, "VAEEncode"))
    return [(f"joint@{tokens}", (1, tokens, cfg.heads, cfg.head_dim), tokens, calls),
            _vae_shape(vae_cfg, height // vae_cfg.downscale, vae_calls)]


def _without_reference(workflow):
    """The Kontext workflow with its ReferenceLatent node taken out: its
    consumer takes the node's own conditioning input."""
    prompt = copy.deepcopy(workflow)
    ref = _node_id(prompt, "ReferenceLatent")
    source = prompt.pop(ref)["inputs"]["conditioning"]
    _relinked(prompt, {(ref, 0): tuple(source)})
    return prompt


def _flux_phase(torch, workflows: dict, device: str, expected: dict | None = None,
                image_px: int = FLUX_IMAGE_PX) -> dict:
    """The bundled Flux workflows (tag → workflow), each as txt2img over
    HTTP (`_txt2img_phase`, one run: master + w1 in this process sharing
    one bundle, each image against a local run at its seed). Each
    backbone's bundle is built (seeded on the device) when a workflow
    first needs it, the last one freed first; the MMDiT's velocity must
    be finite at every evaluation. Kontext's image must differ from the
    same run without ReferenceLatent, and the dual-prompt image from the
    custom-sampling one, by FLUX_MIN_DIFF. `expected` maps a tag to
    (launches, by instance) an image, unchecked when None (no card)."""
    import gc

    from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
    from comfyui_distributed_tpu_torch.models import pipeline as pl
    from comfyui_distributed_tpu_torch.ops import attention as attn
    from comfyui_distributed_tpu_torch.utils import image as img_utils

    cuda = device.startswith("cuda")

    def finite(module, inputs, output):
        _require(bool(torch.isfinite(output).all()), "the MMDiT's velocity is not finite")

    results, bundle = {}, None
    for tag, workflow in workflows.items():
        model = _flux_model(workflow)
        if bundle is None or bundle.model_name != model:
            bundle = None
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
            started = time.perf_counter()
            bundle = pl.load_pipeline(model, seed=0, device=device)
            if cuda:
                torch.cuda.synchronize()
            bundle.unet.register_forward_hook(finite)
            counts = {part: sum(p.numel() for p in module.parameters())
                      for part, module in bundle.parts().items()}
            held = torch.cuda.memory_allocated() if cuda else 0
            print(f"[flux] {model}: parameters by part {counts} ({sum(counts.values()) / 1e9:.3f}B; "
                  f"encoders {bundle.te_name}, {bundle.te2_name}), seeded random init on the "
                  f"device in {time.perf_counter() - started:.1f} s; {held / 2**30:.2f} GiB "
                  "allocated")
        per_image = None if expected is None else expected[tag]
        results[tag] = _txt2img_phase(
            torch, bundle, workflow, device,
            expected_launches=None if per_image is None else 2 * per_image[0],
            expected_by_instance=None if per_image is None else
            {k: 2 * v for k, v in per_image[1].items()},
            runs=1, tag=tag, image_px=image_px, pipelines=_flux_pipelines(workflow, bundle))
        if _node_ids(workflow, "ReferenceLatent"):
            seed = int(workflow[_node_id(workflow, "DistributedSeed")]["inputs"]["seed"])
            with tempfile.TemporaryDirectory(prefix=f"cdt_{tag}_") as in_dir:
                # the input _txt2img_phase gave the workflow's LoadImage
                for load in _node_ids(workflow, "LoadImage"):
                    with open(os.path.join(in_dir, workflow[load]["inputs"]["image"]), "wb") as fh:
                        fh.write(img_utils.encode_png(_inpaint_input(image_px, SEED)))
                executor = GraphExecutor(ExecutionContext(
                    device=device, pipelines=_flux_pipelines(workflow, bundle),
                    config={"settings": {"input_dir": in_dir}}))
                plain, _, _, _ = _local_run(torch, attn, executor, _without_reference(workflow),
                                            f"[{tag}]", f"seed {seed}, without ReferenceLatent",
                                            device, (*_image_px(workflow, image_px), 3))
            diff = float((plain - results[tag]["local"]).abs().max())
            print(f"[{tag}] seed {seed}: with vs without ReferenceLatent max |diff| {diff:.3g} "
                  f"(at least {FLUX_MIN_DIFF:.4f})")
            _require(diff >= FLUX_MIN_DIFF, "the reference latent does not change the image")
    if {"flux_dev", "flux_dual"} <= set(results):
        diff = float((results["flux_dual"]["local"] - results["flux_dev"]["local"]).abs().max())
        print(f"[flux] dual-prompt vs custom-sampling image (seed 7 each) max |diff| {diff:.3g} "
              f"(at least {FLUX_MIN_DIFF:.4f})")
        _require(diff >= FLUX_MIN_DIFF, "the dual-prompt image is the custom-sampling one")
    return results


def _sd3_model(workflow) -> str:
    """The registry name of an SD3 workflow's checkpoint."""
    from comfyui_distributed_tpu_torch.graph.nodes_loaders import _stem

    return _stem(workflow[_node_id(workflow, "CheckpointLoaderSimple")]["inputs"]["ckpt_name"])


def _sd3_slg_window(workflow) -> tuple[tuple, list[int]]:
    """(the skipped joint blocks, the KSampler's steps whose sigma lies in
    the SkipLayerGuidanceSD3 window) of a workflow, from the host-side
    schedule of its model's flow shift (ModelSamplingSD3's where it has
    one): ((), []) without the node, or with it muted."""
    from comfyui_distributed_tpu_torch.models.registry import get_config
    from comfyui_distributed_tpu_torch.ops import samplers as smp

    ids = _node_ids(workflow, "SkipLayerGuidanceSD3")
    if not ids:
        return (), []
    slg = workflow[ids[0]]["inputs"]
    layers = tuple(sorted({int(p) for p in str(slg["layers"]).split(",") if p.strip()}))
    if not layers or float(slg["scale"]) == 0.0:
        return (), []
    shift = get_config(_sd3_model(workflow)).flow_shift
    for node_id in _node_ids(workflow, "ModelSamplingSD3"):
        shift = float(workflow[node_id]["inputs"]["shift"])
    sampler = workflow[_node_id(workflow, "KSampler")]["inputs"]
    sigmas = smp.get_model_sigmas("flow", sampler["scheduler"], int(sampler["steps"]),
                                  float(sampler["denoise"]), flow_shift=shift)
    start = smp.percent_to_sigma(float(slg["start_percent"]), "flow", shift)
    end = smp.percent_to_sigma(float(slg["end_percent"]), "flow", shift)
    return layers, [i for i, sigma in enumerate(sigmas[:-1].tolist())
                    if smp.in_slg_window(sigma, start, end)]


def _sd3_shapes(workflow, image_px: int = SD3_IMAGE_PX):
    """(label, q shape, M, calls) of one image of an SD3 workflow: at each
    CFG-batched evaluation (batch 2) every joint block's attention over the
    text tokens (77 CLIP, and 77 T5 unless a DualCLIPLoader feeds the
    prompts) and the image's 2x2 patches, and MMDiT-X's image-only attn2;
    at each step in the SLG window the batch-1 skip pass without the
    skipped blocks; then the 16-channel VAE's decode."""
    from comfyui_distributed_tpu_torch.models.pipeline import _family_vae_name
    from comfyui_distributed_tpu_torch.models.registry import (TRIPLE_TEXT_ENCODERS,
                                                               get_config)
    from comfyui_distributed_tpu_torch.ops.samplers import model_evals_per_scan

    model = _sd3_model(workflow)
    cfg, vae_cfg = get_config(model), get_config(_family_vae_name(model))
    clip, _, t5 = (get_config(n) for n in TRIPLE_TEXT_ENCODERS[model])
    height, width = _image_px(workflow, image_px)
    _require(height == width == image_px, f"a {height}x{width} image: the shapes assume "
                                          f"{image_px} square, as the reference")
    sampler = workflow[_node_id(workflow, "KSampler")]["inputs"]
    _require(float(sampler["cfg"]) != 1.0 and float(sampler["denoise"]) == 1.0,
             "the SD3 shapes assume a CFG-batched KSampler at denoise 1")
    evals = model_evals_per_scan(sampler["sampler_name"], int(sampler["steps"]))
    text = clip.max_length + (0 if _node_ids(workflow, "DualCLIPLoader") else t5.max_length)
    patches = (height // (vae_cfg.downscale * cfg.patch_size)) ** 2
    joint, x_only = text + patches, patches
    q = (cfg.n_heads, cfg.head_dim)
    shapes = [(f"joint@{joint}", (2, joint, *q), joint, cfg.depth * evals)]
    if cfg.dual_attn_blocks:
        shapes.append((f"x-only@{x_only}", (2, x_only, *q), x_only,
                       cfg.dual_attn_blocks * evals))
    layers, window = _sd3_slg_window(workflow)
    if window:
        kept = [i for i in range(cfg.depth) if i not in layers]
        shapes.append((f"skip joint@{joint}", (1, joint, *q), joint, len(kept) * len(window)))
        dual = [i for i in kept if i < cfg.dual_attn_blocks]
        if dual:
            shapes.append((f"skip x-only@{x_only}", (1, x_only, *q), x_only,
                           len(dual) * len(window)))
    shapes.append(_vae_shape(vae_cfg, height // vae_cfg.downscale, 1))
    return shapes


def _sd3_extra_checks() -> list:
    """The D = 64 checks of the SD3 path beyond its workflows' shapes, as
    (label, q shape, M, dtype, launches per unit, layout): a ragged joint
    length (a 1008-px SD3.5-medium image, batch 1), counted towards both
    SD3.5 entries' errors with no launches."""
    return [(f"joint@{SD3_RAGGED_TOKENS} (1008 px)", (1, SD3_RAGGED_TOKENS, 24, 64),
             SD3_RAGGED_TOKENS, "bfloat16", dict.fromkeys(SD3_WORKFLOWS, 0), "contiguous")]


def _sd3_dualclip_workflow(workflow):
    """The workflow with its prompts encoded by a DualCLIPLoader of type sd3
    (CLIP-L and CLIP-G of the checkpoint's triple, no T5) in place of the
    checkpoint's CLIP."""
    from comfyui_distributed_tpu_torch.models.registry import TRIPLE_TEXT_ENCODERS

    prompt = copy.deepcopy(workflow)
    ckpt = _node_id(prompt, "CheckpointLoaderSimple")
    clip_l, clip_g, _ = TRIPLE_TEXT_ENCODERS[_sd3_model(prompt)]
    node_id = str(max(int(k) for k in prompt) + 1)
    prompt[node_id] = {"class_type": "DualCLIPLoader", "inputs": {
        "clip_name1": clip_l, "clip_name2": clip_g, "type": "sd3"}}
    for encode in _node_ids(prompt, "CLIPTextEncode"):
        _require(prompt[encode]["inputs"]["clip"] == [ckpt, 1], "a prompt not on the checkpoint")
        prompt[encode]["inputs"]["clip"] = [node_id, 0]
    return prompt


def _sd3_muted(workflow):
    """The workflow with its SkipLayerGuidanceSD3 muted (scale 0)."""
    prompt = copy.deepcopy(workflow)
    prompt[_node_id(prompt, "SkipLayerGuidanceSD3")]["inputs"]["scale"] = 0.0
    return prompt


def _sd3_phase(torch, workflows: dict, device: str, expected: dict | None = None,
               image_px: int = SD3_IMAGE_PX) -> dict:
    """The bundled SD3.5 workflows (tag → workflow), each as txt2img over
    HTTP (`_txt2img_phase`, one run: master + w1 in this process sharing
    one bundle seeded on the device, each image against a local run at its
    seed), each checkpoint's bundle built when a workflow first needs it,
    the last one freed first. The MMDiT's velocity must be finite at every
    evaluation. A workflow with SkipLayerGuidanceSD3: its skip passes (the
    forwards given skip_layers) must be the steps the host-side schedule
    puts in the window, per image; its image at the master's seed must
    differ from the same run muted by SD3_MIN_DIFF; and the same workflow
    with a DualCLIPLoader of type sd3 (no T5) runs once locally, finite,
    its CLIP tokens those of the triple conditioning exactly. `expected`
    maps a tag (and "<tag>_dualclip") to (launches, by instance) an image,
    unchecked when None (no card)."""
    import gc

    from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
    from comfyui_distributed_tpu_torch.models import pipeline as pl
    from comfyui_distributed_tpu_torch.ops import attention as attn

    cuda = device.startswith("cuda")
    skip_passes = [0]

    def finite(module, inputs, output):
        _require(bool(torch.isfinite(output).all()), "the MMDiT's velocity is not finite")

    def count_skips(module, args, kwargs):
        if kwargs.get("skip_layers"):
            skip_passes[0] += 1

    results, bundle = {}, None
    for tag, workflow in workflows.items():
        model = _sd3_model(workflow)
        if bundle is None or bundle.model_name != model:
            bundle = None
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
            started = time.perf_counter()
            bundle = pl.load_pipeline(model, seed=0, device=device)
            if cuda:
                torch.cuda.synchronize()
            bundle.unet.register_forward_hook(finite)
            bundle.unet.register_forward_pre_hook(count_skips, with_kwargs=True)
            counts = {part: sum(p.numel() for p in module.parameters())
                      for part, module in bundle.parts().items()}
            nbytes = sum(p.numel() * p.element_size() for module in bundle.parts().values()
                         for p in module.parameters())
            held = torch.cuda.memory_allocated() if cuda else 0
            print(f"[sd3] {model}: parameters by part {counts} ({sum(counts.values()) / 1e9:.3f}B, "
                  f"{nbytes} bytes; encoders {bundle.te_name}, {bundle.te2_name}, "
                  f"{bundle.te3_name}), seeded random init on the device in "
                  f"{time.perf_counter() - started:.1f} s; {held / 2**30:.2f} GiB allocated")
        layers, window = _sd3_slg_window(workflow)
        steps = int(workflow[_node_id(workflow, "KSampler")]["inputs"]["steps"])
        if layers:
            print(f"[{tag}] SLG skips blocks {list(layers)} at the {len(window)} of {steps} "
                  f"steps whose sigma lies in the window (host schedule): {window}")
        per_image = None if expected is None else expected[tag]
        skip_passes[0] = 0
        results[tag] = _txt2img_phase(
            torch, bundle, workflow, device,
            expected_launches=None if per_image is None else 2 * per_image[0],
            expected_by_instance=None if per_image is None else
            {k: 2 * v for k, v in per_image[1].items()},
            runs=1, tag=tag, image_px=image_px, pipelines={model: bundle})
        # the local runs at the master's seed and w1's, then one of each over HTTP
        images = 4
        print(f"[{tag}] skip passes {skip_passes[0]} over {images} images (expected "
              f"{images} x {len(window)})")
        _require(skip_passes[0] == images * len(window),
                 "the skip passes are not the steps in the SLG window")
        if not layers:
            continue
        seed = int(workflow[_node_id(workflow, "DistributedSeed")]["inputs"]["seed"])
        executor = GraphExecutor(ExecutionContext(device=device, pipelines={model: bundle}))
        size = (*_image_px(workflow, image_px), 3)
        muted, _, _, _ = _local_run(torch, attn, executor, _sd3_muted(workflow), f"[{tag}]",
                                    f"seed {seed}, SkipLayerGuidanceSD3 muted", device, size)
        diff = float((muted - results[tag]["local"]).abs().max())
        print(f"[{tag}] seed {seed}: with vs without skip-layer guidance max |diff| {diff:.3g} "
              f"(at least {SD3_MIN_DIFF:.4f})")
        _require(diff >= SD3_MIN_DIFF, "skip-layer guidance does not change the image")
        dual = _sd3_dualclip_workflow(workflow)
        image, launches, by_instance, seconds = _local_run(
            torch, attn, executor, dual, f"[{tag}]",
            f"seed {seed}, DualCLIPLoader sd3 (no T5)", device, size)
        want = None if expected is None else expected[f"{tag}_dualclip"]
        if want is not None:
            _require(launches == want[0] and by_instance == want[1],
                     f"DualCLIPLoader sd3: launches {launches} by instance {by_instance}, "
                     f"expected {want}")
        loader = _node_id(dual, "DualCLIPLoader")
        clip = executor.last_results[loader][0]
        prompt = dual[_node_ids(dual, "CLIPTextEncode")[0]]["inputs"]["text"]
        tokens = clip.tokenizer.max_length
        with torch.inference_mode():
            two = pl.encode_text_pooled(clip, [prompt])
            three = pl.encode_text_pooled(bundle, [prompt])
        same = bool(torch.equal(two.context, three.context[:, :tokens]))
        print(f"[{tag}] DualCLIPLoader sd3: context {tuple(two.context.shape)} (the triple's "
              f"{tuple(three.context.shape)}), its {tokens} CLIP tokens equal to the triple's: "
              f"{same}; image finite in [{float(image.min()):.4f}, {float(image.max()):.4f}]")
        _require(same, "the T5-less conditioning is not the triple's CLIP part")
        results[f"{tag}_dualclip"] = {"launches": launches, "launches_by_instance": by_instance,
                                      "seconds": seconds}
    return results


def _depth_cuts():
    """The registry configs cut in depth to fit the run's time limit, each at
    its published width: name → config. Flux's, SD3.5's and the 14B WAN
    DiTs' (FLUX_DEPTH_CUT, SD3_DEPTH_CUT, WAN_DEPTH_CUT) hold for the whole run, the UNets' (UNET_CUTS:
    SDXL_DEPTH_CUT, UNET_RES_BLOCKS_CUT) in CUT_PHASES only."""
    import dataclasses

    from comfyui_distributed_tpu_torch.models.registry import get_config

    out = {}
    for name in ("flux-dev", "flux-schnell"):
        out[name] = dataclasses.replace(get_config(name), double_depth=FLUX_DEPTH_CUT[0],
                                        single_depth=FLUX_DEPTH_CUT[1])
    for name, (depth, dual) in SD3_DEPTH_CUT.items():
        cfg = get_config(name)
        out[name] = dataclasses.replace(cfg, depth=depth, hidden_dim=cfg.width,
                                        heads=cfg.n_heads, dual_attn_blocks=dual)
    for name, depth in WAN_DEPTH_CUT.items():
        out[name] = dataclasses.replace(get_config(name), depth=depth)
    out["sdxl"] = dataclasses.replace(get_config("sdxl"), transformer_depth=SDXL_DEPTH_CUT,
                                      num_res_blocks=UNET_RES_BLOCKS_CUT)
    for name in ("sd15", "sd21"):
        out[name] = dataclasses.replace(get_config(name), num_res_blocks=UNET_RES_BLOCKS_CUT)
    return out


@contextlib.contextmanager
def _installed(configs: dict):
    """The port's registry holding `configs` (name → config) inside the
    block."""
    from comfyui_distributed_tpu_torch.models.registry import MODEL_REGISTRY

    saved = {name: MODEL_REGISTRY[name] for name in configs}
    try:
        for name, cfg in configs.items():
            MODEL_REGISTRY[name] = {**saved[name], "config": cfg}
        yield
    finally:
        MODEL_REGISTRY.update(saved)


def _wan_model(workflow) -> str:
    """The registry name of a WAN workflow's VideoCheckpointLoader."""
    from comfyui_distributed_tpu_torch.graph.nodes_video import video_model_name

    return video_model_name(
        workflow[_node_id(workflow, "VideoCheckpointLoader")]["inputs"]["ckpt_name"])


def _wan_video(workflow, frame_hw: tuple = WAN_I2V_FRAME_HW) -> dict:
    """A WAN workflow's video: frames, height, width, steps, cfg, seed, its
    sampler node and whether it is WanImageToVideo, whose size is its
    image's, `frame_hw` (the seeded first_frame.png)."""
    ids = _node_ids(workflow, "WanImageToVideo")
    if ids:
        node, (height, width) = ids[0], frame_hw
        inputs = workflow[node]["inputs"]
        frames = inputs["frames"]
    else:
        node = _node_id(workflow, "VideoFlowSampler")
        inputs = workflow[node]["inputs"]
        latent = workflow[_node_id(workflow, "EmptyVideoLatent")]["inputs"]
        height, width, frames = int(latent["height"]), int(latent["width"]), latent["frames"]
    seed = workflow[_node_id(workflow, "DistributedSeed")]["inputs"]["seed"]
    return {"frames": int(frames), "height": height, "width": width,
            "steps": int(inputs["steps"]), "cfg": float(inputs["cfg"]), "seed": int(seed),
            "node": node, "i2v": bool(ids)}


def _wan_shapes(workflow, frame_hw: tuple = WAN_I2V_FRAME_HW):
    """(label, q shape, M, calls) of one video of a WAN workflow: at each
    flow step (one CFG-batched evaluation, batch 2) every block's
    self-attention over the latent's (1, 2, 2) patches and its
    cross-attention over CLIP-L's 77 tokens, in the i2v layout also over
    CLIP vision's 257; then (i2v) the CLIP-vision tower's penultimate
    blocks over its 257 tokens. The WAN VAE's mid attention is plain
    PyTorch: no launch."""
    from comfyui_distributed_tpu_torch.models.registry import get_config
    from comfyui_distributed_tpu_torch.models.video_pipeline import default_parts

    model = _wan_model(workflow)
    cfg = get_config(model)
    vae_name, te_name, cv_name = default_parts(model)
    vae_cfg, te = get_config(vae_name), get_config(te_name)
    video = _wan_video(workflow, frame_hw)
    frames = (video["frames"] - 1) // getattr(vae_cfg, "temporal_downscale", 1) + 1
    side = vae_cfg.downscale * cfg.patch_size[1]
    tokens = frames * (video["height"] // side) * (video["width"] // side)
    batch = 1 if video["cfg"] == 1.0 else 2
    calls = cfg.depth * video["steps"]
    q = (batch, tokens, cfg.heads, cfg.head_dim)
    shapes = [(f"wan_self@{tokens}", q, tokens, calls),
              (f"wan_text@{te.max_length}", q, te.max_length, calls)]
    if cv_name is not None:
        cv = get_config(cv_name)
        shapes += [(f"wan_img@{cv.tokens}", q, cv.tokens, calls),
                   (f"clipvis@{cv.tokens}", (1, cv.tokens, cv.heads, cv.width // cv.heads),
                    cv.tokens, cv.layers - 1)]
    return shapes


def _wan_capture(torch, dit):
    """Hooks on a DiT: every output must be finite; each thread's first
    evaluation (a participant's: the master and w1 each run in a thread of
    their own) keeps its inputs and output. Returns the state the hooks
    fill ({"evals": n, "first": {thread: (args, output)}}) and their
    handles."""
    import threading

    state = {"evals": 0, "first": {}, "pending": {}}

    def before(module, args):
        key = threading.get_ident()
        if key not in state["first"] and key not in state["pending"]:
            state["pending"][key] = tuple(None if a is None else a.detach().clone()
                                          for a in args)

    def after(module, args, output):
        _require(bool(torch.isfinite(output).all()), "the DiT's velocity is not finite")
        state["evals"] += 1
        key = threading.get_ident()
        if key in state["pending"]:
            state["first"][key] = (state["pending"].pop(key), output.detach().clone())

    return state, (dit.register_forward_pre_hook(before), dit.register_forward_hook(after))


def _wan_first_eval_check(torch, vp, bundle, workflow, video, first: dict, label: str) -> dict:
    """Each participant's first evaluation: its noise equals a generator
    draw at the seed or the seed + 1 exactly, one each; w1's velocity is
    within WAN_FIRST_EVAL_TOLERANCE x max |ref| of one evaluation here on
    its seed's draw and the workflow's prompts (the i2v mask and clip
    latent channels and the CLIP tokens taken from w1's input); in the
    i2v layout w1's evaluation with those tokens zeroed moves by
    WAN_IMAGE_BRANCH_MIN of its max."""
    from comfyui_distributed_tpu_torch.ops import samplers as smp

    _require(len(first) == 2, f"{len(first)} participants evaluated the DiT, expected 2")
    seeds = {}
    for (x, t, ctx, *rest), out in first.values():
        noise = x[: x.shape[0] // 2, ..., : bundle.latent_channels]
        for s in (video["seed"], video["seed"] + 1):
            if torch.equal(noise, vp.video_noise(bundle, s, tuple(noise.shape))):
                seeds[s] = (x, t, ctx, rest[0] if rest else None, out)
    print(f"{label} first evaluations: the noise equals the draw at seeds {sorted(seeds)} "
          f"(expected {video['seed']} and {video['seed'] + 1}); DiT input "
          f"{tuple(next(iter(first.values()))[0][0].shape)}")
    _require(sorted(seeds) == [video["seed"], video["seed"] + 1],
             "a participant's noise is not the generator draw at its effective seed")
    x, t, ctx, embeds, out = seeds[video["seed"] + 1]
    inputs = workflow[video["node"]]["inputs"]
    if video["i2v"]:
        texts = (inputs["prompt"], inputs["negative_prompt"])
    else:
        texts = tuple(workflow[str(inputs[side][0])]["inputs"]["text"]
                      for side in ("positive", "negative"))
    pos, neg = (vp.encode_video_text(bundle, [text]) for text in texts)
    noise = vp.video_noise(bundle, video["seed"] + 1,
                           (1,) + tuple(x.shape[1:-1]) + (bundle.latent_channels,))
    here = torch.cat([noise, x[:1, ..., bundle.latent_channels:]], dim=-1)
    t0 = smp.get_flow_timesteps(video["steps"], bundle.flow_shift)[0] * 1000.0
    result = {}
    with torch.no_grad():
        ref = bundle.dit(torch.cat([here, here]), t0.expand(2).to(x.device),
                         torch.cat([pos, neg]), embeds)
        diff, scale = float((out - ref).abs().max()), float(ref.abs().max())
        print(f"{label} w1's first evaluation against one here at seed {video['seed'] + 1}: "
              f"max |diff| {diff:.3g} of max |v| {scale:.3g} (at most "
              f"{WAN_FIRST_EVAL_TOLERANCE:g} x); t x 1000 {float(t[0]):.3f} (here "
              f"{float(t0):.3f})")
        _require(diff <= WAN_FIRST_EVAL_TOLERANCE * scale,
                 "w1's first evaluation is not its seed's and prompts'")
        result["first_eval_max_abs_diff"] = diff
        if embeds is not None:
            moved = float((bundle.dit(x, t, ctx, torch.zeros_like(embeds)) - out).abs().max())
            top = float(out.abs().max())
            print(f"{label} w1's first evaluation with the CLIP-vision tokens zeroed moves the "
                  f"velocity by {moved:.3g} (at least {WAN_IMAGE_BRANCH_MIN:.4f} x {top:.3g})")
            _require(moved >= WAN_IMAGE_BRANCH_MIN * top,
                     "the i2v image branch does not move the velocity")
            result["image_branch_moves"] = moved
    return result


def _wan_file_check(torch, vp, bundle, device: str, tmp: str) -> dict:
    """The bundle's DiT written in the original `blocks.N.*` layout in bf16,
    then loaded by load_video_pipeline(checkpoint=): every parameter
    torch.equal to the written one (the seeded weight through bf16, into
    the parameter's dtype). The file is deleted."""
    from comfyui_distributed_tpu_torch.models import sd_checkpoint as sdc
    from comfyui_distributed_tpu_torch.models.registry import get_config

    path = os.path.join(tmp, f"{bundle.model_name}.safetensors")
    started = time.perf_counter()
    state = sdc.synthesize_state_dict(bundle.dit.state_dict(),
                                      sdc.wan_schedule(get_config(bundle.model_name)))
    nbytes = sdc.save_safetensors(state, path, dtype=torch.bfloat16)
    written = time.perf_counter() - started
    started = time.perf_counter()
    loaded = vp.load_video_pipeline(bundle.model_name, checkpoint=path, device=device)
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    seconds = time.perf_counter() - started
    want = bundle.dit.state_dict()
    got = loaded.dit.state_dict()
    bad = [name for name, p in got.items()
           if not torch.equal(p, want[name].to(torch.bfloat16).to(p.dtype))]
    print(f"[wan] {bundle.model_name} DiT in the original layout: {len(state)} tensors, "
          f"{nbytes} bytes (bf16) written in {written:.2f} s; load_video_pipeline(checkpoint=) "
          f"{seconds:.2f} s ({nbytes / max(seconds, 1e-9) / 1e9:.2f} GB/s); parameters equal "
          f"to the written ones: {len(got) - len(bad)} of {len(got)}")
    _require(not bad, f"{len(bad)} parameters differ from the file's, e.g. {bad[:3]}")
    del loaded, got
    os.remove(path)
    return {"file_bytes": nbytes, "file_load_seconds": seconds}


def _wan_chunk_check(torch, bundle, video: dict, gen) -> dict:
    """The chunked decode of one seeded latent of the video's size against
    the whole-clip decode (f32, TF32 off): within WAN_CHUNK_TOLERANCE."""
    cuda = bundle.device.type == "cuda"
    shape = (1, bundle.latent_frames(video["frames"]), video["height"] // bundle.latent_scale,
             video["width"] // bundle.latent_scale, bundle.latent_channels)
    z = torch.randn(shape, generator=gen, device=bundle.device)
    out, seconds = {}, {}
    with torch.no_grad():
        for chunked in (True, False):
            if cuda:
                torch.cuda.synchronize()
            started = time.perf_counter()
            out[chunked] = bundle.vae.decode(z, chunked=chunked)
            if cuda:
                torch.cuda.synchronize()
            seconds[chunked] = time.perf_counter() - started
    diff = float((out[True] - out[False]).abs().max())
    print(f"[wan] the chunked VAE decode of a seeded {shape} latent against the whole clip: "
          f"max |diff| {diff:.3g} (at most {WAN_CHUNK_TOLERANCE:g}); chunked {seconds[True]:.2f} "
          f"s, whole {seconds[False]:.2f} s")
    _require(diff <= WAN_CHUNK_TOLERANCE, "the chunked VAE decode is not the whole clip's")
    return {"chunk_max_abs_diff": diff}


def _wan_local(torch, attn, executor, workflow, seed: int, label: str, size: tuple):
    """One local run of a WAN workflow at `seed` (no SaveVideoFrames, every
    node run): (its frames as f32, launches, by instance, seconds)."""
    prompt = copy.deepcopy(workflow)
    del prompt[_node_id(prompt, "SaveVideoFrames")]
    prompt[_node_id(prompt, "DistributedSeed")]["inputs"]["seed"] = seed
    cuda = str(executor.context.device).startswith("cuda")
    executor.context.extras.pop("node_cache", None)
    if cuda:
        torch.cuda.synchronize()
    attn.reset_launch_counts()
    started = time.perf_counter()
    executor.execute(prompt)
    frames = executor.last_results[_node_id(prompt, "DistributedCollector")][0]
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - started
    launches, by_instance = _launch_counts(attn)
    print(f"{label} local run, seed {seed}: {seconds:.2f} s; flash_attention launches "
          f"{launches}, by instance {by_instance}; node times {executor.last_timings}")
    _require(tuple(frames.shape) == size, f"local output shape {tuple(frames.shape)}")
    _require(bool(torch.isfinite(frames).all()), "non-finite local output")
    return frames.float(), launches, by_instance, seconds


def _webp_check(frames, fps: int, out_dir: str, label: str = "[webp]") -> dict:
    """SaveAnimatedWEBP on `frames` (an IMAGE batch) at `fps` into
    `out_dir`, its container held to the frames on a [webp] line; any miss
    fails the run: the RIFF size is the file's less 8, the VP8X canvas the
    frames' size with the animation flag, ANIM loops forever, one ANMF a
    frame at offset 0 and round(1000 / fps) ms, each holding a VP8L
    bitstream whose header carries the frame's size. (No decoder here:
    the pixels are held exact by the CPU tests, tests/test_torch_webp.py.)"""
    from comfyui_distributed_tpu_torch.graph import NODE_REGISTRY
    from comfyui_distributed_tpu_torch.utils import webp

    n, height, width = (int(d) for d in frames.shape[:3])
    started = time.perf_counter()
    ui = NODE_REGISTRY["SaveAnimatedWEBP"]().save(
        frames, filename_prefix="chip_smoke", fps=fps,
        context=types.SimpleNamespace(config={"settings": {"output_dir": out_dir}}))[0]["ui"]
    seconds = time.perf_counter() - started
    with open(os.path.join(out_dir, ui["images"][0]), "rb") as fh:
        data = fh.read()
    info = webp.read_container(data)
    duration = int(round(1000.0 / max(int(fps), 1)))
    frames_seen = info["frames"]
    print(f"{label} SaveAnimatedWEBP of {n} frames of {width}x{height} at {fps} fps: "
          f"{ui['images'][0]}, {len(data)} bytes in {seconds:.2f} s; RIFF size "
          f"{info['riff_size']} (file {info['file_size']}), VP8X flags {info.get('flags'):#04x}, "
          f"canvas {info.get('canvas')}, loop {info.get('loop')}, {len(frames_seen)} ANMF "
          f"frames, durations {sorted({f['duration'] for f in frames_seen})} ms, VP8L headers "
          f"{sorted({f['vp8l_header'] for f in frames_seen})}, VP8L bytes a frame "
          f"{min(f['vp8l_size'] for f in frames_seen)}-{max(f['vp8l_size'] for f in frames_seen)}")
    _require(info["riff_size"] == len(data) - 8, "the RIFF size is not the file's less 8")
    _require(info.get("flags", 0) & 0x02 and info.get("canvas") == (width, height)
             and info.get("loop") == 0, f"VP8X/ANIM: flags {info.get('flags')}, canvas "
             f"{info.get('canvas')}, loop {info.get('loop')}")
    _require(len(frames_seen) == n, f"{len(frames_seen)} ANMF frames, not {n}")
    _require(all(f["x"] == f["y"] == 0 and f["size"] == (width, height)
                 and f["duration"] == duration and f["vp8l_header"] == (width, height, 0, 0)
                 for f in frames_seen), "an ANMF frame's placement, duration or VP8L header")
    return {"bytes": len(data), "seconds": seconds, "frames": n}


def _wan_phase(torch, workflows: dict, device: str, expected: dict | None = None,
               frame_hw: tuple = WAN_I2V_FRAME_HW, gen=None,
               local_tags: tuple = ("wan",)) -> dict:
    """The bundled WAN workflows (tag → workflow), unmodified, one run each
    over HTTP: master + w1 DistributedServers in this process sharing one
    bundle, built (seeded on the device) when a workflow first needs it,
    the last one freed first; every DiT output must be finite. Per run:
    the collector's batch [2 F, H, W, 3] in [0, 1], the participants'
    frames apart in max and mean (RERUN_TOLERANCE), launches as `expected`
    (tag → (launches, by instance) a video; unchecked when None), no
    collector job left, w1's F envelopes, SaveVideoFrames' 2 F PNGs and
    manifest at the workflow's fps, the PNGs the frames' 8-bit values.
    The workflows of `local_tags` (distributed-wan, wan-1.3b) are also
    held against local runs at the seed and the seed + 1
    (the master's frames within RERUN_TOLERANCE, w1's within it +
    PNG_STEP), its DiT loaded from a file in the original layout
    (`_wan_file_check`) and, with `gen`, its chunked decode against the
    whole clip (`_wan_chunk_check`); the other workflows through each
    participant's first evaluation (`_wan_first_eval_check`). Prints
    seconds and videos/s, parameters by part, init seconds and peak
    memory."""
    import gc

    import numpy as np

    from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
    from comfyui_distributed_tpu_torch.models import video_pipeline as vp
    from comfyui_distributed_tpu_torch.ops import attention as attn
    from comfyui_distributed_tpu_torch.utils import image as img_utils

    cuda = device.startswith("cuda")
    if cuda:
        print(f"[wan] memory allocated at the phase's start "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    def run_workflow(tag, workflow, video, model, label, init_s, counts):
        """One workflow's checks; its servers, executors and frames go with
        its frame, so the next bundle finds the card free."""
        size = (video["frames"], video["height"], video["width"], 3)
        n = video["frames"]
        per_video = None if expected is None else expected[tag]
        pipelines = {f"video:{model}": bundle}
        result = {"init_seconds": init_s, "parameters": counts}
        with tempfile.TemporaryDirectory(prefix=f"cdt_{tag}_") as tmp:
            in_dir, out_dir = os.path.join(tmp, "input"), os.path.join(tmp, "output")
            os.makedirs(in_dir)
            settings = {"input_dir": in_dir, "output_dir": out_dir}
            for load in _node_ids(workflow, "LoadImage"):
                rgb = np.random.default_rng(SEED).random((1, *frame_hw, 3), dtype=np.float32)
                with open(os.path.join(in_dir, workflow[load]["inputs"]["image"]), "wb") as fh:
                    fh.write(img_utils.encode_png(rgb))
            local = {}
            if tag in local_tags:
                result.update(_wan_file_check(torch, vp, bundle, device, tmp))
                if gen is not None:
                    result.update(_wan_chunk_check(torch, bundle, video, gen))
                executor = GraphExecutor(ExecutionContext(
                    device=device, pipelines=dict(pipelines), config={"settings": settings}))
                for s in (video["seed"], video["seed"] + 1):
                    local[s], launches, by_instance, seconds = _wan_local(
                        torch, attn, executor, workflow, s, label, size)
                    result[f"local_seconds_seed_{s}"] = seconds
                    if per_video is not None:
                        _require(launches == per_video[0] and by_instance == per_video[1],
                                 f"local launches {launches} by instance {by_instance}, "
                                 f"expected {per_video}")
            with _serving(tmp, settings, device, pipelines) as (master, worker, base, worker_port):
                state["first"].clear()
                state["pending"].clear()
                state["evals"] = 0
                if cuda:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                attn.reset_launch_counts()
                started = time.perf_counter()
                queued, history, worker_history = _queue(base, worker_port, workflow,
                                                         timeout=WAN_RUN_TIMEOUT_S)
                if cuda:
                    torch.cuda.synchronize()
                seconds = time.perf_counter() - started
                launches, by_instance = _launch_counts(attn)
                peak = torch.cuda.max_memory_allocated() if cuda else 0
                collector = _node_id(workflow, "DistributedCollector")
                save = _node_id(workflow, "SaveVideoFrames")
                record = master.job_store.finished[queued["job_ids"][collector]]
                out = master.get_job(queued["prompt_id"]).outputs[save][0]["images"]
                print(f"{label} run over HTTP: {seconds:.2f} s, {2 / seconds:.5f} videos/s; node "
                      f"seconds: master {history['timings']}, w1 {worker_history['timings']}; "
                      f"DiT evaluations {state['evals']}; flash_attention launches {launches}, "
                      f"by instance {by_instance}; peak {peak / 2**30:.2f} GiB; w1 envelopes "
                      f"{record['received']}, bytes received {record['received_bytes']}; "
                      f"collector jobs left {len(master.job_store.collectors)}")
                _require(tuple(out.shape) == (2 * n, *size[1:]), f"output shape {tuple(out.shape)}")
                _require(out.device.type == torch.device(device).type,
                         f"the output was computed on {out.device}, not {device}")
                _require(bool(torch.isfinite(out).all()), "non-finite output")
                _require(float(out.min()) >= 0.0 and float(out.max()) <= 1.0,
                         "output outside [0, 1]")
                _require(record["received"] == {"w1": n} and record["finished_workers"] == ["w1"],
                         f"w1's envelopes: {record['received']}, finished "
                         f"{record['finished_workers']}")
                _require(not master.job_store.collectors, "collector jobs outlive their prompts")
                if per_video is not None:
                    want = {k: 2 * v for k, v in per_video[1].items()}
                    _require(launches == 2 * per_video[0] and by_instance == want,
                             f"launches {launches} by instance {by_instance}, expected "
                             f"{2 * per_video[0]}, {want}")
                saved = history["outputs"][save]["images"]
                prefix = workflow[save]["inputs"]["filename_prefix"]
                with open(os.path.join(out_dir, f"{prefix}_manifest.json"),
                          encoding="utf-8") as fh:
                    manifest = json.load(fh)
                _require(len(saved) == 2 * n and manifest["frames"] == saved
                         and manifest["fps"] == int(workflow[save]["inputs"]["fps"]),
                         f"saved {len(saved)} frames, the manifest's fps {manifest.get('fps')}")
                u8 = img_utils.f32_to_u8(img_utils.ensure_numpy(out))
                for i, name in enumerate(saved):
                    with open(os.path.join(out_dir, name), "rb") as fh:
                        _require(np.array_equal(img_utils.decode_png_u8(fh.read()), u8[i]),
                                 f"{name} is not frame {i}")
                d01 = (out[:n] - out[n:]).float().abs()
                print(f"{label} output {tuple(out.shape)} in [{float(out.min()):.4f}, "
                      f"{float(out.max()):.4f}]; the participants' frames apart by max "
                      f"{float(d01.max()):.3g} and mean {float(d01.mean()):.3g} (each > "
                      f"{RERUN_TOLERANCE}); {len(saved)} PNGs equal to the frames and the "
                      f"manifest at {manifest['fps']} fps")
                _require(float(d01.max()) > RERUN_TOLERANCE
                         and float(d01.mean()) > RERUN_TOLERANCE,
                         "the master's and w1's videos do not differ")
                if tag in local_tags:
                    # the master's video through SaveAnimatedWEBP, no sampling
                    result["webp"] = _webp_check(out[:n], int(workflow[save]["inputs"]["fps"]),
                                                 out_dir)
                if local:
                    d0 = float((out[:n].float() - local[video["seed"]].to(out.device)).abs().max())
                    d1 = float((out[n:].float()
                                - local[video["seed"] + 1].to(out.device)).abs().max())
                    print(f"{label} the master's frames vs the local seed {video['seed']} max "
                          f"|diff| {d0:.3g} (tolerance {RERUN_TOLERANCE}), w1's vs the local "
                          f"seed {video['seed'] + 1} {d1:.3g} (tolerance "
                          f"{RERUN_TOLERANCE + PNG_STEP:.4f})")
                    _require(d0 <= RERUN_TOLERANCE, "the master's video is not the local seed's")
                    _require(d1 <= RERUN_TOLERANCE + PNG_STEP,
                             "w1's video is not the local seed's")
                else:
                    result.update(_wan_first_eval_check(torch, vp, bundle, workflow, video,
                                                        state["first"], label))
                result.update({"launches": launches, "launches_by_instance": by_instance,
                               "seconds": seconds, "videos_per_s": 2 / seconds,
                               "peak_gib": peak / 2**30})
        return result

    results, bundle, hooks = {}, None, ()
    for tag, workflow in workflows.items():
        label = f"[{tag}]"
        model = _wan_model(workflow)
        video = _wan_video(workflow, frame_hw)
        if bundle is None or bundle.model_name != model:
            for handle in hooks:
                handle.remove()
            bundle = None
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
                print(f"[wan] memory allocated before {model}'s bundle "
                      f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
            started = time.perf_counter()
            bundle = vp.load_video_pipeline(model, seed=0, device=device)
            if cuda:
                torch.cuda.synchronize()
            init_s = time.perf_counter() - started
            counts = {part: sum(p.numel() for p in module.parameters())
                      for part, module in bundle.parts().items()}
            nbytes = sum(p.numel() * p.element_size() for module in bundle.parts().values()
                         for p in module.parameters())
            held = torch.cuda.memory_allocated() if cuda else 0
            print(f"[wan] {model}: parameters by part {counts} ({sum(counts.values()) / 1e9:.3f}B"
                  f", {nbytes} bytes; text {bundle.te_name}, VAE {bundle.vae_name}), seeded "
                  f"random init on the device in {init_s:.1f} s; {held / 2**30:.2f} GiB "
                  "allocated")
            state, hooks = _wan_capture(torch, bundle.dit)
        results[tag] = run_workflow(tag, workflow, video, model, label, init_s, counts)
    for handle in hooks:
        handle.remove()
    return results


def _rounded(seconds: dict) -> dict:
    return {stage: round(value, 4) for stage, value in sorted(seconds.items())}


def _parse_phases(argv) -> set:
    """`--phases a,b,...` (default every phase of PHASES): the phases to
    run. A phase that reads an earlier one's bundle or output builds its
    own when that one is left out; "elastic" runs "main" too."""
    import argparse

    parser = argparse.ArgumentParser(description="Smoke run of the port on one GPU.")
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma-separated phases to run, of {', '.join(PHASES)}")
    args = parser.parse_args(argv)
    phases = {name.strip() for name in args.phases.split(",") if name.strip()}
    unknown = phases - set(PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}; use {', '.join(PHASES)}")
    if "elastic" in phases:
        phases.add("main")
    return phases


def main(argv=()) -> int:
    import torch

    phases = _parse_phases(list(argv))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU", file=sys.stderr)
        return 1
    from comfyui_distributed_tpu_torch.models.registry import get_config

    cuts = _depth_cuts()
    unet_cuts = {name: cuts.pop(name) for name in UNET_CUTS}
    print("[cuts] depth cut at full width, so the run fits its time limit: "
          + "; ".join(f"{name} {_depth_of(get_config(name))} -> {_depth_of(cfg)}"
                      for name, cfg in cuts.items())
          + f"; in the phases {', '.join(CUT_PHASES)} only: "
          + "; ".join(f"{name} {_depth_of(get_config(name))} -> {_depth_of(cfg)}"
                      for name, cfg in unet_cuts.items()))
    with _installed(cuts):
        return _run(torch, phases, unet_cuts)


def _depth_of(cfg) -> str:
    if hasattr(cfg, "transformer_depth"):
        return (f"transformer blocks per level {tuple(cfg.transformer_depth)}, "
                f"{cfg.num_res_blocks} residual blocks")
    if hasattr(cfg, "double_depth"):
        return f"{cfg.double_depth} double + {cfg.single_depth} single blocks"
    if hasattr(cfg, "ffn_dim"):
        return f"{cfg.depth} DiT blocks"
    return f"{cfg.depth} joint blocks ({cfg.dual_attn_blocks} with attn2)"


def _run(torch, phases: set, unet_cuts: dict) -> int:
    """Every phase of `phases`, in PHASES order (see the module docstring),
    with Flux's and SD3.5's depth cuts installed; `unet_cuts` holds the
    UNets' cut configs, installed for CUT_PHASES."""
    import numpy as np
    import torch.nn.functional as F

    from comfyui_distributed_tpu_torch import sass_report
    from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
    from comfyui_distributed_tpu_torch.models import pipeline as pl
    from comfyui_distributed_tpu_torch.models.registry import get_config
    from comfyui_distributed_tpu_torch.ops import attention as attn
    from comfyui_distributed_tpu_torch.ops.samplers import get_sigmas, model_evals_per_scan
    from comfyui_distributed_tpu_torch.ops.upscale import plan_grid
    from comfyui_distributed_tpu_torch.utils import image as img_utils

    # --- 1. device ---------------------------------------------------------
    run_started = time.perf_counter()
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
    for kernel, line in sass_report.ptxas_kernel_lines(build.log):
        print(f"[build] ptxas: {kernel}: {line}")

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

    def cut():
        """The registry with the UNets of CUT_PHASES at their cut depths."""
        return _installed(unet_cuts)

    with cut():
        # the adapters phase's tile, and the samplers phase's elastic run:
        # the same workflow on HTTP_SAMPLER
        adapters_shapes = _attention_shapes(get_config("sdxl"), vae_cfg, te_len,
                                            tile_px // vae_cfg.downscale,
                                            model_evals_per_scan(usdu["sampler_name"], pairs))
        http_sampler_shapes = _attention_shapes(get_config("sdxl"), vae_cfg, te_len,
                                                tile_px // vae_cfg.downscale,
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
    ckpt_workflows = {}
    for path, name in CKPT_WORKFLOWS.items():
        with open(os.path.join(REPO, "workflows", name), encoding="utf-8") as fh:
            ckpt_workflows[path] = json.load(fh)
    t2i_sampler = _node_id(t2i_workflow, "KSampler")
    samplers_entry_workflow = copy.deepcopy(t2i_workflow)
    samplers_entry_workflow[t2i_sampler]["inputs"]["sampler_name"] = SAMPLERS_ENTRY_SAMPLER
    with open(os.path.join(REPO, "workflows", CUSTOM_WORKFLOW), encoding="utf-8") as fh:
        flux_custom = json.load(fh)
    with open(os.path.join(REPO, "workflows", DYNAMIC_WORKFLOW), encoding="utf-8") as fh:
        video_workflow = json.load(fh)
    inpaint_model_workflow = _inpaint_model_workflow()
    flux_workflows = {}
    for tag, name in FLUX_WORKFLOWS.items():
        with open(os.path.join(REPO, "workflows", name), encoding="utf-8") as fh:
            flux_workflows[tag] = json.load(fh)
    wan_workflows = {}
    for tag, name in WAN_WORKFLOWS.items():
        with open(os.path.join(REPO, "workflows", name), encoding="utf-8") as fh:
            wan_workflows[tag] = json.load(fh)
    sd3_workflows = {}
    for tag, name in SD3_WORKFLOWS.items():
        with open(os.path.join(REPO, "workflows", name), encoding="utf-8") as fh:
            sd3_workflows[tag] = json.load(fh)
    # each SD3 workflow's image, and the SLG one's with DualCLIPLoader sd3
    sd3_shapes = {}
    for tag, wf in sd3_workflows.items():
        sd3_shapes[tag] = _sd3_shapes(wf)
        if _node_ids(wf, "SkipLayerGuidanceSD3"):
            sd3_shapes[f"{tag}_dualclip"] = _sd3_shapes(_sd3_dualclip_workflow(wf))
    sd_shapes = {tag: _txt2img_shapes(wf) for tag, wf in sd_workflows.items()}
    inpaint_model_shapes = _txt2img_shapes(inpaint_model_workflow)
    with cut():
        # a SAG image and an area image of the guidance phase (its FreeU and
        # RescaleCFG images have the samplers' shapes); the custom phase's
        # images by guider (PerpNeg and DualCFG at batch 3)
        guidance_shapes = {name: _guidance_shapes(name, t2i_workflow)
                           for name in _guidance_variants(t2i_workflow)}
        custom_shapes = {guider: _custom_shapes(_custom_workflow(flux_custom, guider))
                         for guider in CUSTOM_GUIDERS}
        custom_shapes["two_stage"] = _custom_shapes(_custom_two_stage(
            _custom_workflow(flux_custom, "CFGGuider")))
        # every path's unit: the SDXL upscale's tile (the main path's and the
        # adapters phase's), each seed-parallel workflow's image, a usdu_full
        # tile, a dynamic-mode frame of the video workflow, an outpainted
        # sd15-inpaint image, a Flux, SD3.5 or WAN workflow's image or video;
        # CUT_PHASES' at their cut depths
        path_shapes = {"upscale": shapes, "txt2img": t2i_shapes, "adapters": adapters_shapes,
                       **sd_shapes,
                       **{path: _txt2img_shapes(wf) for path, wf in ckpt_workflows.items()},
                       "samplers": _txt2img_shapes(samplers_entry_workflow),
                       "usdu_full": _usdu_full_shapes(workflow),
                       "guidance": guidance_shapes["SelfAttentionGuidance"],
                       "guidance_area": guidance_shapes["area"],
                       "custom": custom_shapes["PerpNegGuider"],
                       "custom_dualcfg": custom_shapes["DualCFGGuider"],
                       "dynamic": _dynamic_shapes(_dynamic_workflow(video_workflow)),
                       "inpaint_model": inpaint_model_shapes,
                       **{tag: _flux_shapes(wf) for tag, wf in flux_workflows.items()},
                       **sd3_shapes,
                       **{tag: _wan_shapes(wf) for tag, wf in wan_workflows.items()}}
    # the paths each phase's runs hold launch counts of
    phase_paths = {"main": {"upscale"}, "elastic": {"upscale"}, "adapters": {"adapters"},
                   "txt2img": {"txt2img"},
                   "sd": set(SD_WORKFLOWS), "ckpt": set(CKPT_WORKFLOWS),
                   "samplers": {"samplers"}, "usdu_full": {"usdu_full"},
                   "guidance": {"guidance", "guidance_area"},
                   "custom": {"custom", "custom_dualcfg"}, "inpaint_model": {"inpaint_model"},
                   "dynamic": {"dynamic"}, "flux": set(FLUX_WORKFLOWS), "sd3": set(sd3_shapes),
                   "wan": set(WAN_WORKFLOWS)}
    selected_paths = set().union(*(phase_paths.get(name, set()) for name in phases))
    wan_paths = set(WAN_WORKFLOWS)

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
    # Flux's D=128 beyond its main shapes: a ragged joint length (1008 px),
    # a short key count and both sides of the one-bf16-P threshold at its
    # full 24 heads, the one-bf16-P plan's edges
    checks += _flux_extra_checks(attn)
    # SD3's D=64 beyond its workflows' shapes: a ragged joint length (1008 px)
    checks += _sd3_extra_checks()
    for d in TXT2IMG_HEAD_DIMS + FLUX_HEAD_DIMS:
        checks += [
            (f"D{d} ragged 1000x777 f32", (1, 1000, 2, d), 777, "float32", None, "contiguous"),
            (f"D{d} unaligned 300x300", (2, 300, 2, d), 300, "bfloat16", None, "unaligned"),
            (f"D{d} strided 150x150", (2, 150, 4, d), 150, "bfloat16", None, "fused"),
            (f"D{d} rows 16 bytes off 128", (2, 100, 2, d), 100, "bfloat16", None, "offset"),
        ]
        rows, keys = EDGE_ROWS_WG, EDGE_KEYS_WG
        if d in attn.WGMMA_PINGPONG_KEYS and d not in attn.WGMMA_BF16_P:
            rows, keys = rows + EDGE_ROWS_PINGPONG, keys + EDGE_KEYS_PINGPONG
        checks += [(f"edge D{d} {n}x{m} B*H=1", (1, n, 1, d), m, "bfloat16", None, "edge")
                   for n in rows for m in keys]
    if "kernel" not in phases:
        # only the selected paths' own shapes
        checks = [c for c in checks if c[4] and set(c[4]) & selected_paths]
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
        if units and set(units) <= wan_paths:
            targets = set(units)
        elif d in FLUX_HEAD_DIMS:  # every Flux entry's: one instance carries them all
            targets = set(FLUX_WORKFLOWS)
        else:
            entry = "txt2img" if d in TXT2IMG_HEAD_DIMS and plan.instance == "wgmma" else "upscale"
            targets = {entry} | {p for p in (units or {}) if p not in ("upscale", "txt2img")}
        for path in targets:
            max_err[path] = max(max_err[path], err)
        emulation = None
        if units and set(units) <= wan_paths and m > attn.WGMMA_PINGPONG_ABOVE.get(d, m):
            # the one-bf16-P plan against its emulation, as at joint@4608
            emulation = _tolerance_ratio(
                out, attn.bf16_p_attention_reference(q, k, v, plan.keys_per_tile))
            _require(emulation <= 1.0, f"{label}: the one-bf16-P plan misses its emulation "
                                       f"({emulation:.3g})")
        terms = _bounds(q.shape, k.shape[1], dtype, sms, clock_mhz)
        bound_ms = max(terms.values())
        # the edges are many and small: fewer samples; so are WAN's long calls
        # and the checks off the paths (no launches a unit)
        reps = (OFF_PATH_REPS if layout == "edge" else LARGE_REPS if bound_ms > LARGE_CALL_MS
                else MAIN_REPS if units else OFF_PATH_REPS)
        plain_reps = PLAIN_REPS_LARGE if b * h * n * m > PLAIN_SCORES_TIMED else PLAIN_REPS
        kernel_ms = _time_ms(torch, lambda: attn.flash_attention(q, k, v), *reps)
        # the plain version's and SDPA's times feed the kernels line's
        # entries, which read the paths' shapes only
        plain_ms = library_ms = math.nan
        if units:
            plain_ms = _time_ms(torch, lambda: attn.flash_attention_reference(q, k, v),
                                *plain_reps[0], warmup=plain_reps[1])
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            library_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt),
                                  *reps)
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
              f"waves={ctas / (per_sm * sms):.3f}"
              + ("" if emulation is None else
                 f" bf16P-emulation={emulation:.3f} (max |d| / tolerance)"))
        # the paths' shapes, and Flux's ragged joint length
        joint = d in FLUX_HEAD_DIMS and layout == "contiguous" and n == m
        if plan.instance == "wgmma" and (units or joint) and not set(units or {}) <= wan_paths:
            plans = attn.wgmma_plans(d)
            tile_lines.append(_time_plans(torch, attn, label, q, k, v, plans, plan))
            # the largest call of the upscale or txt2img path: the [host]
            # line keeps its shape
            if {"upscale", "txt2img"} & set(units or {}) and (host_inputs is None
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
    if "kernel" in phases:
        print(_threshold_line(torch, attn, gen))
        print(_host_us_per_call(torch, attn, *host_inputs))
    phase_seconds = {"kernel": time.perf_counter() - phase_started}

    def per_unit(shapes_):
        """(launches, by instance) of one image, frame or video of `shapes_`."""
        return (sum(count for *_, count in shapes_), _expected_by_instance(attn, shapes_, torch))

    def run(name: str) -> bool:
        if name in phases:
            print(f"[phases] {name}: starts {time.perf_counter() - run_started:.1f} s into the run")
            return True
        print(f"[phases] {name}: not selected")
        return False

    results = {}

    # --- 4. main path --------------------------------------------------------
    phase_started = time.perf_counter()
    rng = np.random.default_rng(SEED)
    # on 8-bit levels, so the elastic phase's input.png holds exactly this
    seeded = img_utils.u8_to_f32(img_utils.f32_to_u8(
        rng.random((1, IMAGE_PX, IMAGE_PX, 3), dtype=np.float32)))
    ckpt = workflow["1"]["inputs"]["ckpt_name"]
    t2i_ckpt = t2i_workflow["1"]["inputs"]["ckpt_name"]
    main_tiles_per_s = None
    expected_by_instance = {
        name: n_tiles * count
        for name, count in _expected_by_instance(attn, shapes, torch).items()
    }
    if run("main"):
        prompt = copy.deepcopy(workflow)
        del prompt["4"], prompt["6"]  # LoadImage → a seeded image; no SaveImage
        prompt["5"]["inputs"]["image"] = torch.from_numpy(seeded).to("cuda")
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
        for run_index in (1, 2):
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
            print(f"[main] run {run_index}: {seconds:.2f} s, {n_tiles / seconds:.4f} tiles/s, "
                  f"peak {peak / 2**30:.2f} GiB, flash_attention launches {launches} "
                  f"(expected {n_tiles} x {per_tile}), by instance {by_instance} "
                  f"(expected {expected_by_instance}), node times {executor.last_timings}")
            out_px = 2 * IMAGE_PX
            _require(tuple(image.shape) == (1, out_px, out_px, 3),
                     f"output shape {tuple(image.shape)}")
            _require(bool(torch.isfinite(image).all()), "non-finite output")
            _require(float(image.min()) >= 0.0 and float(image.max()) <= 1.0,
                     "output outside [0, 1]")
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
        main_tiles_per_s = n_tiles / seconds
        results["main"] = {"launches": launches, "launches_by_instance": by_instance}
        phase_seconds["main"] = time.perf_counter() - phase_started

    # --- 4b. elastic -----------------------------------------------------------
    if run("elastic"):
        phase_started = time.perf_counter()
        results["elastic"] = _elastic_phase(
            torch, bundle, ckpt, workflow, prompt["5"]["inputs"]["image"], outputs[1], "cuda",
            expected_launches=n_tiles * per_tile, expected_by_instance=expected_by_instance,
            local_tiles_per_s=main_tiles_per_s, drain=True, incident=True,
        )
        phase_seconds["elastic"] = time.perf_counter() - phase_started
    # phase 4's SDXL is not needed again
    bundle = context = executor = outputs = image = prompt = None
    torch.cuda.empty_cache()

    # --- 4b'. adapters: SDXL at the cut depth on a master and w1, served as
    # the elastic phase serves it; the base output is its local tiles' weighted
    # average ---------------------------------------------------------------------
    if run("adapters"):
        phase_started = time.perf_counter()
        image = torch.from_numpy(seeded).to("cuda")
        with cut():
            bundle = pl.load_pipeline(ckpt, seed=0, device="cuda")
            _seed_out_conv(torch, bundle, gen)
            adapters_expected = {name: n_tiles * count for name, count in
                                 _expected_by_instance(attn, adapters_shapes, torch).items()}
            results["adapters"] = _elastic_phase(
                torch, bundle, ckpt, workflow, image, None, "cuda", runs=0, tag="adapters",
                after=lambda servers: _adapters_phase(
                    torch, bundle, ckpt, workflow, image, servers["reference_avg"], servers,
                    "cuda", gen, expected_launches=sum(adapters_expected.values()),
                    expected_by_instance=adapters_expected))["after"]
        bundle = image = None
        torch.cuda.empty_cache()
        phase_seconds["adapters"] = time.perf_counter() - phase_started

    def sd15_bundle(name):
        started = time.perf_counter()
        out = pl.load_pipeline(name, seed=0, device="cuda")
        _seed_out_conv(torch, out, gen)
        torch.cuda.synchronize()
        return out, time.perf_counter() - started

    # --- 4c. txt2img -------------------------------------------------------------
    t2i_bundle = None
    if run("txt2img"):
        phase_started = time.perf_counter()
        t2i_bundle, init_s = sd15_bundle(t2i_ckpt)
        n_params = sum(p.numel() for m in (t2i_bundle.unet, t2i_bundle.vae,
                                           t2i_bundle.text_encoder) for p in m.parameters())
        print(f"[txt2img] {t2i_ckpt}: {n_params / 1e9:.3f}B parameters, seeded random init on "
              f"the card in {init_s:.1f} s (compute dtype {get_config(t2i_ckpt).dtype})")
        per_image = sum(count for *_, count in t2i_shapes)
        t2i_expected = {name: 2 * count for name, count in
                        _expected_by_instance(attn, t2i_shapes, torch).items()}
        results["txt2img"] = _txt2img_phase(torch, t2i_bundle, t2i_workflow, "cuda",
                                            expected_launches=2 * per_image,
                                            expected_by_instance=t2i_expected, audio=True)
        phase_seconds["txt2img"] = time.perf_counter() - phase_started

    # --- 4d. the other seed-parallel SD workflows ----------------------------------
    # two-pass, PAG and inpaint on the same SD1.5 weights; then SD2.1-768-v
    # on its own, seeded like the others, SD1.5 freed first
    if run("sd"):
        bundle = t2i_bundle
        for tag, wf in sd_workflows.items():
            phase_started = time.perf_counter()
            ckpt_ = wf[_node_id(wf, "CheckpointLoaderSimple")]["inputs"]["ckpt_name"]
            if bundle is None or ckpt_ != bundle.model_name:
                bundle = None
                torch.cuda.empty_cache()
                bundle, init_s = sd15_bundle(ckpt_)
                n_params = sum(p.numel() for m in (bundle.unet, bundle.vae, bundle.text_encoder)
                               for p in m.parameters())
                print(f"[{tag}] {ckpt_}: {n_params / 1e9:.3f}B parameters, seeded random init "
                      f"on the card in {init_s:.1f} s (compute dtype "
                      f"{get_config(ckpt_).dtype}, text encoder {bundle.te_name})")
            per_image = sum(count for *_, count in path_shapes[tag])
            expected = {name: 2 * count for name, count in
                        _expected_by_instance(attn, path_shapes[tag], torch).items()}
            results[tag] = _txt2img_phase(torch, bundle, wf, "cuda", 2 * per_image, expected,
                                          runs=SD_WORKFLOW_RUNS, tag=tag)
            phase_seconds[tag] = time.perf_counter() - phase_started
    bundle = t2i_bundle = None
    torch.cuda.empty_cache()

    # --- 4e. ckpt: real single-file checkpoints over HTTP ------------------------
    if run("ckpt"):
        phase_started = time.perf_counter()
        with cut():
            def per_run(path_name):
                """(launches, by instance) of one run of a path: two images."""
                return (2 * sum(count for *_, count in path_shapes[path_name]),
                        {name: 2 * count for name, count in
                         _expected_by_instance(attn, path_shapes[path_name], torch).items()})

            results["ckpt"] = _ckpt_phase(torch, gen, ckpt_workflows, "cuda",
                                          {path: per_run(path) for path in ckpt_workflows})
            results.update(results["ckpt"])
            torch.cuda.empty_cache()
        phase_seconds["ckpt"] = time.perf_counter() - phase_started

    # --- 4e'. procs: the master here, w1 its own process launched through
    # /distributed/launch_worker, on SD1.5 and SDXL files --------------------------
    if run("procs"):
        phase_started = time.perf_counter()
        procs_shapes = _txt2img_shapes(t2i_workflow)
        results["procs"] = _procs_phase(
            torch, gen, {"txt2img": t2i_workflow, "inpaint": sd_workflows["inpaint"],
                         "upscale": workflow}, torch.from_numpy(seeded).to("cuda"), "cuda",
            expected=(sum(count for *_, count in procs_shapes),
                      _expected_by_instance(attn, procs_shapes, torch)),
            rates={"txt2img": results.get("txt2img", {}).get("images_per_s"),
                   "elastic": results.get("elastic", {}).get("tiles_per_s"),
                   "main": main_tiles_per_s})
        phase_seconds["procs"] = time.perf_counter() - phase_started

    # --- 4f. samplers: every sampler and scheduler on SD1.5; HTTP_SAMPLER over
    # the collector and over the elastic upscale ----------------------------------
    upscale_ckpt = workflow["1"]["inputs"]["ckpt_name"]
    bundle = None
    if run("samplers"):
        phase_started = time.perf_counter()
        with cut():
            bundle, _ = sd15_bundle(t2i_ckpt)
            sampler_runs = [_samplers_phase(torch, bundle, t2i_workflow, "cuda",
                                            check_launches=True)]
            http_workflow = copy.deepcopy(t2i_workflow)
            http_workflow[t2i_sampler]["inputs"]["sampler_name"] = HTTP_SAMPLER
            http_shapes = _txt2img_shapes(http_workflow)
            sampler_runs.append(_txt2img_phase(
                torch, bundle, http_workflow, "cuda", 2 * sum(count for *_, count in http_shapes),
                {name: 2 * count for name, count in
                 _expected_by_instance(attn, http_shapes, torch).items()},
                runs=1, tag="samplers"))
            bundle = None
            torch.cuda.empty_cache()
            bundle, _ = sd15_bundle(upscale_ckpt)
            http_upscale = copy.deepcopy(workflow)
            http_upscale[USDU_NODE]["inputs"]["sampler_name"] = HTTP_SAMPLER
            sampler_runs.append(_elastic_phase(
                torch, bundle, upscale_ckpt, http_upscale, torch.from_numpy(seeded).to("cuda"),
                None, "cuda",
                expected_launches=n_tiles * sum(count for *_, count in http_sampler_shapes),
                expected_by_instance={name: n_tiles * count for name, count in
                                      _expected_by_instance(attn, http_sampler_shapes,
                                                            torch).items()},
                runs=1, tag="samplers"))
            samplers_launches = sum(r["launches"] for r in sampler_runs)
            samplers_by_instance = {name: sum(r["launches_by_instance"].get(name, 0)
                                              for r in sampler_runs) for name in attn.INSTANCES}
            print(f"[samplers] seconds by run: {_rounded(sampler_runs[0]['seconds'])}; "
                  f"flash_attention launches over the phase {samplers_launches}, by instance "
                  f"{samplers_by_instance}")
            results["samplers"] = sampler_runs[0]
        phase_seconds["samplers"] = time.perf_counter() - phase_started

    # --- 4g. usdu_full: the upscale workflow with an upscale model, ControlNet
    # tile, CLIPTextEncodeSDXL and tiled decode, on the samplers phase's SDXL ---
    if run("usdu_full"):
        phase_started = time.perf_counter()
        with cut():
            if bundle is None:
                bundle, _ = sd15_bundle(upscale_ckpt)
            full_shapes = path_shapes["usdu_full"]
            results["usdu_full"] = _usdu_full_phase(
                torch, bundle, workflow, torch.from_numpy(seeded).to("cuda"), gen, "cuda",
                expected_launches=n_tiles * sum(count for *_, count in full_shapes),
                expected_by_instance={name: n_tiles * count for name, count in
                                      _expected_by_instance(attn, full_shapes, torch).items()},
                tiled_tolerance=TILED_DECODE_TOLERANCE)
        phase_seconds["usdu_full"] = time.perf_counter() - phase_started
    bundle = None
    torch.cuda.empty_cache()

    # --- 4h. guidance: FreeU, FreeU_V2, SAG, RescaleCFG and an area entry on SD1.5 ---
    if run("guidance"):
        phase_started = time.perf_counter()
        with cut():
            bundle, _ = sd15_bundle(t2i_ckpt)
            results["guidance"] = _guidance_phase(torch, bundle, t2i_workflow, "cuda", expected={
                name: per_unit(shapes_) for name, shapes_ in guidance_shapes.items()})
            # the custom phase runs on this SD1.5 bundle
        phase_seconds["guidance"] = time.perf_counter() - phase_started

    # --- 4i. custom: the custom-sampling workflow on SD1.5 under CFGGuider,
    # PerpNegGuider and DualCFGGuider over HTTP, and split in two stages ---
    if run("custom"):
        phase_started = time.perf_counter()
        with cut():
            if bundle is None:
                bundle, _ = sd15_bundle(t2i_ckpt)
            results["custom"] = _custom_phase(torch, bundle, flux_custom, "cuda",
                                              expected={name: per_unit(shapes_)
                                                        for name, shapes_ in custom_shapes.items()})
            results["custom_dualcfg"] = results["custom"]["DualCFGGuider"]
        phase_seconds["custom"] = time.perf_counter() - phase_started
    bundle = None
    torch.cuda.empty_cache()

    # --- 4j. nodes: every image, latent, mask and transform node on the card
    # against the same graph on the CPU --------------------------------------
    if run("nodes"):
        phase_started = time.perf_counter()
        results["nodes"] = _nodes_phase(torch, "cuda")
        results["merges"] = _merges_check(torch, t2i_workflow, "cuda", gen)
        torch.cuda.empty_cache()
        phase_seconds["nodes"] = time.perf_counter() - phase_started

    # --- 4k. inpaint_model: outpainting on sd15-inpaint (9-channel UNet) ---
    if run("inpaint_model"):
        phase_started = time.perf_counter()
        bundle, _ = sd15_bundle(INPAINT_MODEL_CKPT)
        print(f"[inpaint_model] {INPAINT_MODEL_CKPT}: UNet input conv "
              f"{tuple(bundle.unet.input_conv.weight.shape)}")
        launches_, by_instance_ = per_unit(path_shapes["inpaint_model"])
        results["inpaint_model"] = _txt2img_phase(
            torch, bundle, inpaint_model_workflow, "cuda", 2 * launches_,
            {k: 2 * v for k, v in by_instance_.items()}, runs=1, tag="inpaint_model")
        bundle = None
        torch.cuda.empty_cache()
        phase_seconds["inpaint_model"] = time.perf_counter() - phase_started

    # --- 4l. dynamic: the video workflow's frames, whole, over HTTP on SDXL ---
    if run("dynamic"):
        phase_started = time.perf_counter()
        with cut():
            dynamic_ckpt = video_workflow[_node_id(video_workflow, "CheckpointLoaderSimple")][
                "inputs"]["ckpt_name"]
            bundle, _ = sd15_bundle(dynamic_ckpt)
            results["dynamic"] = _dynamic_phase(torch, bundle, video_workflow, "cuda",
                                                expected=per_unit(path_shapes["dynamic"]))
            bundle = None
            torch.cuda.empty_cache()
        phase_seconds["dynamic"] = time.perf_counter() - phase_started

    # --- 4m. flux: the four bundled Flux workflows at full width, master + w1 ---
    if run("flux"):
        phase_started = time.perf_counter()
        results.update(_flux_phase(torch, flux_workflows, "cuda", expected={
            tag: per_unit(path_shapes[tag]) for tag in flux_workflows}))
        torch.cuda.empty_cache()
        phase_seconds["flux"] = time.perf_counter() - phase_started

    # --- 4n. sd3: the two bundled SD3.5 workflows at full width, master + w1 ---
    if run("sd3"):
        phase_started = time.perf_counter()
        results.update(_sd3_phase(torch, sd3_workflows, "cuda", expected={
            tag: per_unit(shapes_) for tag, shapes_ in sd3_shapes.items()}))
        torch.cuda.empty_cache()
        phase_seconds["sd3"] = time.perf_counter() - phase_started

    # --- 4o. wan: the three bundled WAN workflows at full width (the 14B DiTs
    # at WAN_DEPTH_CUT's depth), master + w1 --------------------------------------
    if run("wan"):
        phase_started = time.perf_counter()
        results.update(_wan_phase(torch, wan_workflows, "cuda", expected={
            tag: per_unit(path_shapes[tag]) for tag in wan_workflows}, gen=gen))
        torch.cuda.empty_cache()
        phase_seconds["wan"] = time.perf_counter() - phase_started
    print("[phases] seconds: " + ", ".join(f"{name} {sec:.1f}" for name, sec in
                                           phase_seconds.items())
          + f"; total {sum(phase_seconds.values()):.1f}")

    # --- 5. kernels ----------------------------------------------------------
    print("[kernels] flash_attention: ms, plain_ms, library_ms and bound_ms are per SDXL tile "
          "(each upscale shape's time times its launches per tile, summed); launches: the last "
          "elastic run, master and w1 together (launches_main: phase 4's last run). "
          "flash_attention_adapters: the same per tile of the upscale wearing the adapters "
          "phase's LoRA (the same shapes on the cut SDXL); launches: its run over HTTP with "
          "adapters, master and w1 together. "
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
          "576-px sd15-inpaint image; launches: its run over HTTP. flash_attention_flux_schnell, "
          "_flux_dev, _flux_dual and _kontext: the same per 1024-px image of the txt2img-flux "
          "(4 steps), flux-custom-sampling, flux-dual-prompt and kontext-edit workflows (20 "
          "steps; Flux's joint attention at D=128, the VAE at D=512); launches: its run over "
          "HTTP, master and w1 together. flash_attention_sd35 and _sd35m_slg: the same per "
          "1024-px image of the txt2img-sd35 (SD3.5-large) and txt2img-sd35m-slg "
          "(SD3.5-medium under skip-layer guidance) workflows (28 steps, CFG-batched; the "
          "joint attention and MMDiT-X's attn2 at D=64, the SLG window's batch-1 skip passes, "
          "the VAE at D=512); launches: its run over HTTP, master and w1 together; "
          "flash_attention_sd35m_slg_dualclip: the same with its prompts through "
          "DualCLIPLoader sd3 (77 text tokens); launches: its one local image. "
          "flash_attention_wan, _wan_14b and _wan_i2v: the same per video of the "
          "distributed-wan (wan-1.3b, 33 frames of 480x480, 30 steps), -wan-2.2-14b-t2v "
          "(wan-14b, 81 frames of 720x480, 30 steps) and -wan-i2v (wan-14b-i2v, 81 frames of "
          "720x480, 20 steps, CLIP vision's 31 blocks at D=80) workflows, CFG-batched, at D=128; "
          "launches: its run over HTTP, master and w1 together. The Flux, SD3.5, adapters, "
          "ckpt, samplers, usdu_full, guidance, custom, dynamic, wan_14b and wan_i2v entries' "
          "models run at the depths of the [cuts] line")
    source = "comfyui_distributed_tpu_torch/csrc/flash_attention.cu"
    replaces = "comfyui_distributed_tpu/ops/attention.py:80"

    def numbers(path):
        t = totals[path]
        return {"ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": _bound_by({key: t[key] for key in ("operations", "bytes",
                                                               "exponentials")}),
                "library_ms": t["library_ms"]}

    def entry(name: str, path: str, res: dict, launches_key: str = "launches",
              **extra) -> dict:
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": res[launches_key],
                "launches_by_instance": res["launches_by_instance"],
                "max_abs_err": max_err[path], **numbers(path), **extra,
                "check": f"ok: {len(checks)} shapes within tolerance of the plain version"}

    # each entry whose phase ran: (name, path of its numbers, its run's result)
    entries = []
    if "main" in results:
        upscale = results.get("elastic", results["main"])
        entries.append(entry("flash_attention", "upscale", upscale,
                             launches_main=results["main"]["launches"],
                             launches_by_instance_main=results["main"]["launches_by_instance"]))
    if "txt2img" in results:
        t2i = results["txt2img"]
        entries.append(entry("flash_attention_txt2img", "txt2img",
                             {**t2i, "launches": t2i["launches_by_instance"]["wgmma"]}))
    if "adapters" in results:
        entries.append(entry("flash_attention_adapters", "adapters", results["adapters"]))
    for tag in (*sd_workflows, *ckpt_workflows):
        if tag in results:
            entries.append(entry(f"flash_attention_{tag}", tag, results[tag]))
    if "samplers" in results:
        samplers = results["samplers"]
        entries.append(entry("flash_attention_samplers", "samplers",
                             {"launches": samplers["entry_launches"],
                              "launches_by_instance": samplers["entry_by_instance"]}))
    if "usdu_full" in results:
        entries.append(entry("flash_attention_usdu_full", "usdu_full", results["usdu_full"]))
    if "guidance" in results:
        entries.append(entry("flash_attention_guidance", "guidance",
                             results["guidance"]["SelfAttentionGuidance"]))
    if "custom" in results:
        entries.append(entry("flash_attention_custom", "custom",
                             results["custom"]["PerpNegGuider"]))
    for tag in ("custom_dualcfg", "dynamic", "inpaint_model", *flux_workflows, *sd3_shapes,
                *wan_workflows):
        if tag in results:
            entries.append(entry(f"flash_attention_{tag}", tag, results[tag]))
    kernels = {"kernels": entries}
    if "adapters" in results:
        adapters = results["adapters"]
        print(f"[summary] adapters: over HTTP with the LoRA max |diff| "
              f"{adapters['max_abs_diff']:.3g} vs L's tiles; patch seconds a job "
              f"{adapters['patch_s']}; operand bytes {adapters['operand_bytes']}; tile cache cold "
              f"{adapters['cold_tiles_per_s']:.4f} tiles/s, warm "
              f"{adapters['warm_tiles_per_s']:.4f} tiles/s ({adapters['warm_launches']} "
              f"launches), weights fingerprint {adapters['fingerprint_s']:.3f} s (a job's, by "
              f"graph: {_rounded(adapters['fingerprint_by_graph_s'])}); attention-only adapter "
              f"{adapters['partial_operand_bytes']} operand bytes, patch seconds "
              f"{_rounded(adapters['partial_patch_s'])}, "
              f"{adapters['partial_tiles_per_s']:.4f} tiles/s; peak "
              f"{adapters['peak_bytes'] / 2**30:.2f} GiB [{smi}]")
    if "procs" in results:
        procs = results["procs"]
        print(f"[summary] procs: w1 ready {procs['launch_to_ready_s']:.2f} s after its launch; "
              f"fan-out {procs['fan_out_images_per_s']:.4f} images/s, elastic "
              f"{procs['elastic_tiles_per_s']:.4f} tiles/s with w1 its own process")
    if {"custom", "nodes", "ckpt", "dynamic"} <= set(results):
        custom, nodes, merges = results["custom"], results["nodes"], results["merges"]
        dynamic, gguf = results["dynamic"], results["ckpt_sd15"]["gguf"]
        print(f"[summary] custom two stages max |diff| "
              f"{custom['two_stage']['max_abs_diff']:.3g}; nodes {nodes['nodes']} "
              f"({len(nodes['classes'])} classes) max |diff| {nodes['max_abs_diff']:.3g}; "
              f"merges at ratio 1.0 exact {merges['ratio_1_exact']}; GGUF load "
              f"{gguf['load_seconds']:.2f} s for {gguf['file_bytes']} bytes; dynamic: w1 took "
              f"{dynamic['w1_frames']} of {DYNAMIC_FRAMES} frames, "
              f"{dynamic['frames_per_s']:.4f} frames/s")
    for tag in wan_workflows:
        if tag in results:
            wan = results[tag]
            print(f"[summary] {tag}: {wan['seconds']:.2f} s a run of two videos, "
                  f"{wan['videos_per_s']:.5f} videos/s, peak {wan['peak_gib']:.2f} GiB, bundle "
                  f"init {wan['init_seconds']:.1f} s, launches {wan['launches']} "
                  f"{wan['launches_by_instance']} [{smi}]")
    print(json.dumps(kernels))
    print(_nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
