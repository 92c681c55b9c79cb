"""Model zoo of the PyTorch port (the SDXL upscale slice)."""
