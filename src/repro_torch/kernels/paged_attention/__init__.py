"""Paged flash decode over the paged KV pool: CUDA kernel + plain version."""
