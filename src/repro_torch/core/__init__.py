"""Formats, quantization, packing, the paged KV pool and the W4A16 GEMM."""
