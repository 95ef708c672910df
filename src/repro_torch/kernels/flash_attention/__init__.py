"""Flash-attention forward (prefill / training): CUDA kernel + plain version."""
