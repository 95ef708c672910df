"""Flash decode over the dense KV cache: CUDA kernel + plain version."""
