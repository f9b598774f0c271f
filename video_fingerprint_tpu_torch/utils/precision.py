"""Float32 math without TF32.

On an NVIDIA card, PyTorch runs a float32 matmul in full float32 by default
but lets cuDNN run a float32 convolution in TF32 (about three decimal
digits). The scan's f32 mode and the similarity search hold the JAX
package's f32 results, so they run inside `full_fp32()`.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def full_fp32():
    """TF32 off for cuBLAS matmuls and cuDNN convolutions inside the block;
    the previous settings come back afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
