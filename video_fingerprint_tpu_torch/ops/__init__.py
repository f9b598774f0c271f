"""Kernels and device ops: the CUDA attention kernel and exact top-k."""
