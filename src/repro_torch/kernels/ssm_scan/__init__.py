"""Chunked mLSTM scan: CUDA kernel + plain versions."""
