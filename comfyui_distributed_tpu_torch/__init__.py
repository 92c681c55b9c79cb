"""PyTorch/CUDA port of comfyui_distributed_tpu, for NVIDIA Hopper.

The JAX package beside it stays the reference. This package imports
torch and never jax, flax or anything of comfyui_distributed_tpu; the
kernels the JAX package wrote in Pallas are hand-written CUDA here
(csrc/), built with nvcc at first use. Entry points run on the card
unless the caller passes device="cpu", where each kernel's plain
PyTorch version runs instead.

This slice ports the local path of the bundled
workflows/distributed-upscale.json: SDXL, two CLIP towers, the VAE,
euler/karras under CFG, the tile grid and blend, and the graph executor
with the workflow's nodes.
"""
