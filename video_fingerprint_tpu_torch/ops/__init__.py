"""Kernels and device ops: the CUDA attention and conv-block kernels, exact top-k."""
